"""The port's SSD block (``repro_torch/nn/ssm.py``) against the JAX
package's ``repro/nn/ssm.py`` and against a naive recurrence, on the CPU.

Inputs from numpy with fixed seeds; weights from ``repro.nn.ssm.ssd_init``
(with random ``out_norm`` scales, so the norm shows). Tolerances:

- fp32 against the reference: the same fp32 arithmetic in another order
  (cumulative sums, the einsums' contraction order), rtol 1e-4 and an
  atol of 1e-5 of the largest element where elements cancel;
- fp32 against the naive recurrence in fp64: the chunked form's fp32
  rounding, rtol 1e-4 and atol 1e-5 of the largest element;
- bf16 (the compute dtype of x, B, C; the state and the decay stay fp32):
  each side rounds its bf16 inputs' products at other places (XLA's CPU
  fusions keep some in fp32), so outputs are held to 2^-5 relative plus
  2^-5 of the largest element; the fp32 state to the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jS
from repro_torch.nn import ssm as tS

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -5, atol=2 ** -5 * scale,
                                   err_msg=what)


def _chunk_inputs(seed, b, s, h, p, n, dtype):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h) - 1.0)).astype(np.float32)   # softplus
    A = -np.exp(rng.randn(h) * 0.5).astype(np.float32)
    B_ = rng.randn(b, s, n).astype(np.float32)
    C = rng.randn(b, s, n).astype(np.float32)
    h0 = rng.randn(b, h, p, n).astype(np.float32) * 0.5
    jdt, tdt = DTYPES[dtype]
    cast = [jnp.asarray(a).astype(jdt) for a in (x, B_, C)]
    jx, jB, jC = cast
    tx, tB, tC = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in cast)
    return (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(h0)), \
        (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC, torch.from_numpy(h0))


def _naive(x, dt, A, B_, C, h0):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, in fp64."""
    x, dt, A, B_, C = (np.asarray(a, np.float64) for a in (x, dt, A, B_, C))
    h = np.asarray(h0, np.float64).copy()
    ys = []
    for t in range(x.shape[1]):
        decay = np.exp(dt[:, t] * A)                                # (B, H)
        h = h * decay[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], B_[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, C[:, t]))
    return np.stack(ys, axis=1), h


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s, chunk", [
    (32, 8),     # a multiple of the chunk: 4 chunks
    (29, 8),     # not: padded with dt = 0 to 32
    (7, 16),     # one chunk of 7 (Q = min(chunk, S)): nc == 1
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax_and_the_recurrence(s, chunk, with_h0, dtype):
    cfg_kw = dict(d_model=16, d_state=8, head_dim=4, chunk=chunk)
    jin, tin = _chunk_inputs(0, 2, s, 3, 4, 8, dtype)
    h0 = (jin[5], tin[5]) if with_h0 else (None, None)
    jy, jh = jS._ssd_chunked(*jin[:5], jS.SSDConfig(**cfg_kw), h0[0])
    ty, th = tS._ssd_chunked(*tin[:5], tS.SSDConfig(**cfg_kw), h0[1])
    assert ty.dtype == DTYPES[dtype][1] and th.dtype == torch.float32
    assert ty.shape == (2, s, 3, 4) and th.shape == (2, 3, 4, 8)
    _close(ty, np.asarray(jy.astype(jnp.float32)), dtype, "y vs reference")
    _close(th, np.asarray(jh), dtype, "state vs reference")
    ny, nh = _naive(*(np.asarray(a.float()) for a in tin[:5]),
                    tin[5].numpy() if with_h0 else np.zeros((2, 3, 4, 8)))
    _close(th, nh, dtype, "state vs the recurrence")
    if dtype == "float32":
        _close(ty, ny, dtype, "y vs the recurrence")


def _block(seed, dtype, d=32, n=8, head_dim=8, chunk=8):
    cfg_kw = dict(d_model=d, d_state=n, head_dim=head_dim, chunk=chunk)
    jcfg, tcfg = jS.SSDConfig(**cfg_kw), tS.SSDConfig(**cfg_kw)
    jp = jS.ssd_init(jax.random.key(seed), jcfg)
    jp["out_norm"]["norm_scale"] = jnp.asarray(
        0.3 * np.random.RandomState(seed + 7).randn(jcfg.d_inner).astype(np.float32))
    jp = jax.tree.map(np.asarray, jp)
    tp = {k: ({kk: torch.tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.tensor(v)) for k, v in jp.items()}
    jp = jax.tree.map(jnp.asarray, jp)
    return jp, jcfg, tp, tcfg


def _u(seed, b, s, d, dtype):
    jdt, tdt = DTYPES[dtype]
    u = jnp.asarray(np.random.RandomState(seed).randn(b, s, d).astype(np.float32)).astype(jdt)
    return u, torch.from_numpy(np.array(u.astype(jnp.float32))).to(tdt)


def test_ssd_init_has_the_reference_names_and_shapes():
    jp, jcfg, _, tcfg = _block(0, "float32")
    gen = torch.Generator().manual_seed(0)
    port = tS.ssd_init(gen, tcfg)
    want = {k: (v.shape if not isinstance(v, dict) else {kk: vv.shape for kk, vv in v.items()})
            for k, v in jp.items()}
    got = {}
    for name, t in port.named_parameters():
        *path, leaf = name.split(".")
        (got.setdefault(path[0], {}) if path else got)[leaf] = tuple(t.shape)
    assert got == {k: (tuple(v) if not isinstance(v, dict) else
                       {kk: tuple(vv) for kk, vv in v.items()}) for k, v in want.items()}
    assert torch.equal(port.A_log, torch.log(torch.arange(1, tcfg.n_heads + 1).float()))
    dt = torch.nn.functional.softplus(port.dt_bias)
    assert bool(((dt >= tcfg.dt_min * (1 - 1e-5)) & (dt <= tcfg.dt_max * (1 + 1e-5))).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [24, 21])
def test_ssd_apply_then_decode_match_jax(s, dtype):
    """Prefill with ``return_state=True``, then 3 one-token decode steps from
    each side's own state: outputs and states (ssm fp32, conv in the compute
    dtype) against the reference's at every step."""
    jp, jcfg, tp, tcfg = _block(1, dtype)
    ju, tu = _u(2, 2, s, jcfg.d_model, dtype)
    jout, jst = jS.ssd_apply(jp, ju, jcfg, return_state=True)
    tout, tst = tS.ssd_apply(tp, tu, tcfg, return_state=True)
    assert tout.dtype == DTYPES[dtype][1]
    assert tst["ssm"].dtype == torch.float32 and tst["conv"].dtype == DTYPES[dtype][1]
    _close(tout, np.asarray(jout.astype(jnp.float32)), dtype, "prefill out")
    for name in ("ssm", "conv"):
        _close(tst[name], np.asarray(jst[name].astype(jnp.float32)), dtype, name)
    assert tst["conv"]._base is None or tst["conv"]._base.numel() == tst["conv"].numel()
    for step in range(3):
        ju1, tu1 = _u(10 + step, 2, 1, jcfg.d_model, dtype)
        jout, jst = jS.ssd_decode_step(jp, ju1, jst, jcfg)
        tout, tst = tS.ssd_decode_step(tp, tu1, tst, tcfg)
        _close(tout, np.asarray(jout.astype(jnp.float32)), dtype, f"decode {step}")
        for name in ("ssm", "conv"):
            _close(tst[name], np.asarray(jst[name].astype(jnp.float32)), dtype,
                   f"{name} after decode {step}")


def test_decode_steps_continue_the_prefill():
    """fp32: prefill of S tokens then decode of k more gives the outputs a
    prefill of all S + k tokens gives at those positions, and its state."""
    _, _, tp, tcfg = _block(3, "float32")
    _, u = _u(4, 2, 19, tcfg.d_model, "float32")
    full, full_state = tS.ssd_apply(tp, u, tcfg, return_state=True)
    out, state = tS.ssd_apply(tp, u[:, :16], tcfg, return_state=True)
    _close(out, full[:, :16].numpy(), "float32")
    for t in range(16, 19):
        y, state = tS.ssd_decode_step(tp, u[:, t:t + 1], state, tcfg)
        _close(y, full[:, t:t + 1].numpy(), "float32", f"position {t}")
    for name in ("ssm", "conv"):
        _close(state[name], full_state[name].numpy(), "float32", name)


def test_ssd_apply_from_a_state_matches_jax():
    """A prefill that starts from a carried state (``state=``)."""
    jp, jcfg, tp, tcfg = _block(5, "float32")
    ju, tu = _u(6, 2, 12, jcfg.d_model, "float32")
    _, jst = jS.ssd_apply(jp, ju, jcfg, return_state=True)
    _, tst = tS.ssd_apply(tp, tu, tcfg, return_state=True)
    ju, tu = _u(7, 2, 10, jcfg.d_model, "float32")
    jout = jS.ssd_apply(jp, ju, jcfg, state=jst)
    tout = tS.ssd_apply(tp, tu, tcfg, state=tst)
    _close(tout, np.asarray(jout), "float32")


def test_softplus_is_jax_softplus_beyond_torch_threshold():
    """jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus switches to
    x above 20, 2e-9 off there. The port's agrees with JAX to fp32 rounding."""
    x = np.array([-40.0, -5.0, -1e-3, 0.0, 0.7, 19.5, 20.5, 25.0, 60.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = tS._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def test_intra_chunk_mask_keeps_gradients_finite_with_strong_decay():
    """The -60 mask goes before exp: with dt * A large, the upper triangle's
    exponents would overflow to inf, and inf * 0 poisons the gradient."""
    jin, tin = _chunk_inputs(8, 1, 16, 2, 4, 8, "float32")
    x, dt, A, B_, C, _ = tin
    dt = (dt * 200.0).requires_grad_(True)
    x = x.clone().requires_grad_(True)
    y, h = tS._ssd_chunked(x, dt, A, B_, C, tS.SSDConfig(d_model=8, d_state=8, head_dim=4,
                                                          chunk=16))
    (y.sum() + h.sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()

