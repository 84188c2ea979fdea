"""The port's RG-LRU block (``repro_torch/nn/rglru.py``) against the JAX
package's ``repro/nn/rglru.py`` and against a naive recurrence, on the CPU.

Inputs from numpy with fixed seeds; weights from ``repro.nn.rglru.rglru_init``
(with random gate biases, so that they show). Tolerances:

- fp32 against the reference: the same fp32 arithmetic, the scan in
  another association order (the reference's ``lax.associative_scan`` is
  odd-even, the port's two levels of Hillis-Steele), rtol 1e-4 and an atol
  of 1e-5 of the largest element where elements cancel (the JAX package
  holds its own scan to its step at 1e-4, ``tests/test_mixers.py``);
- the fp32 scan against the recurrence in fp64: fp32 rounding only, rtol
  1e-5 and an atol of 1e-6 of the largest element;
- bf16 (the projections, the conv and the output in bf16; the gates, the
  scan and the hidden state fp32): each side rounds its bf16 products at
  other places (XLA's CPU fusions keep some in fp32), up to 2 bf16 steps
  of the output's size here, so 2^-5 relative plus 2^-5 of the largest
  element; the fp32 hidden state to the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import rglru as jR
from repro_torch.models import transformer as tT
from repro_torch.nn import rglru as tR
from test_torch_transformer import pair

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


def _block(seed, d=32):
    jcfg, tcfg = jR.RGLRUConfig(d_model=d), tR.RGLRUConfig(d_model=d)
    jp = jax.tree.map(np.asarray, jR.rglru_init(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 7)
    for name in ("rg_bias", "ig_bias"):
        jp[name] = (0.5 * rng.randn(d)).astype(np.float32)
    tp = {k: ({kk: torch.tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else torch.tensor(v)) for k, v in jp.items()}
    return jax.tree.map(jnp.asarray, jp), jcfg, tp, tcfg


def _u(seed, b, s, d, dtype):
    jdt, tdt = DTYPES[dtype]
    u = jnp.asarray(np.random.RandomState(seed).randn(b, s, d).astype(np.float32)).astype(jdt)
    return u, torch.from_numpy(np.array(u.astype(jnp.float32))).to(tdt)


def _state(seed, b, d, dtype):
    """A carried state: fp32 hidden, conv tail in the compute dtype."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    h = rng.randn(b, d).astype(np.float32)
    conv = jnp.asarray(rng.randn(b, 3, d).astype(np.float32)).astype(jdt)
    return ({"hidden": jnp.asarray(h), "conv": conv},
            {"hidden": torch.from_numpy(h),
             "conv": torch.from_numpy(np.array(conv.astype(jnp.float32))).to(tdt)})


def _naive(a, b, h0):
    """h_t = a_t h_{t-1} + b_t, one position at a time, in fp64."""
    h = np.asarray(h0, np.float64)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, axis=1)


def test_rglru_init_has_the_reference_names_and_shapes():
    jp, _, _, tcfg = _block(0)
    port = tR.rglru_init(torch.Generator().manual_seed(0), tcfg)
    got = {name.replace(".", "/"): tuple(t.shape) for name, t in port.named_parameters()}
    want = {jax.tree_util.keystr(path, simple=True, separator="/"): tuple(v.shape)
            for path, v in jax.tree_util.tree_leaves_with_path(jp)}
    assert got == want
    a = torch.sigmoid(port.lambda_param)
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())
    assert not port.rg_bias.any() and not port.ig_bias.any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [7, 16, 40])       # one short chunk, one whole, 2.5 chunks
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches_jax(s, with_state, dtype):
    """Output and returned state (hidden fp32, conv in the compute dtype),
    from zeros or from a carried state."""
    jp, jcfg, tp, tcfg = _block(1)
    ju, tu = _u(2, 2, s, 32, dtype)
    jst, tst = _state(3, 2, 32, dtype) if with_state else (None, None)
    jy, jnew = jR.rglru_apply(jp, ju, jcfg, state=jst, return_state=True)
    ty, tnew = tR.rglru_apply(tp, tu, tcfg, state=tst, return_state=True)
    assert ty.dtype == DTYPES[dtype][1] and ty.shape == (2, s, 32)
    assert tnew["hidden"].dtype == torch.float32 and tnew["conv"].dtype == DTYPES[dtype][1]
    _close(ty, np.asarray(jy.astype(jnp.float32)), dtype, "out")
    for name in ("hidden", "conv"):
        _close(tnew[name], np.asarray(jnew[name].astype(jnp.float32)), dtype, name)
    # a copy: a view of the padded buffer would keep it alive in the cache
    assert tnew["conv"]._base is None
    # without return_state: the output alone, the same
    only = tR.rglru_apply(tp, tu, tcfg, state=tst)
    assert torch.equal(only, ty)


@pytest.mark.parametrize("s", [1, 16, 37, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_the_recurrence_in_fp64(s, with_h0):
    """The two-level scan against the step-by-step recurrence: decays a in
    (0.5, 1) as the gates give them (products over 300 steps reach 1e-90),
    inputs of either sign."""
    rng = np.random.RandomState(s)
    a = rng.uniform(0.5, 1.0, (2, s, 8)).astype(np.float32)
    b = rng.randn(2, s, 8).astype(np.float32)
    h0 = rng.randn(2, 8).astype(np.float32) if with_h0 else np.zeros((2, 8), np.float32)
    got = tR._scan(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(h0) if with_h0 else None)
    want = _naive(a.astype(np.float64), b.astype(np.float64), h0)
    assert got.dtype == torch.float32 and got.shape == (2, s, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_decode_steps_match_jax(dtype):
    """Prefill with ``return_state=True``, then 3 one-token steps from each
    side's own state: outputs and states against the reference's."""
    jp, jcfg, tp, tcfg = _block(4)
    ju, tu = _u(5, 2, 21, 32, dtype)
    _, jst = jR.rglru_apply(jp, ju, jcfg, return_state=True)
    _, tst = tR.rglru_apply(tp, tu, tcfg, return_state=True)
    for step in range(3):
        ju1, tu1 = _u(10 + step, 2, 1, 32, dtype)
        jy, jst = jR.rglru_decode_step(jp, ju1, jst, jcfg)
        ty, tst = tR.rglru_decode_step(tp, tu1, tst, tcfg)
        assert ty.shape == (2, 1, 32) and tst["hidden"].dtype == torch.float32
        _close(ty, np.asarray(jy.astype(jnp.float32)), dtype, f"decode {step}")
        for name in ("hidden", "conv"):
            _close(tst[name], np.asarray(jst[name].astype(jnp.float32)), dtype,
                   f"{name} after decode {step}")


def test_decode_steps_continue_the_prefill():
    """fp32: a prefill of 33 tokens then 4 decode steps gives what a prefill
    of all 37 gives at those positions, and the same state; a prefill of
    the last 4 from the carried state gives it too."""
    _, _, tp, tcfg = _block(6)
    _, u = _u(7, 2, 37, 32, "float32")
    full, full_state = tR.rglru_apply(tp, u, tcfg, return_state=True)
    out, state = tR.rglru_apply(tp, u[:, :33], tcfg, return_state=True)
    _close(out, full[:, :33].numpy(), "float32")
    seg = tR.rglru_apply(tp, u[:, 33:], tcfg, state=state)
    _close(seg, full[:, 33:].numpy(), "float32", "segment from the carried state")
    for t in range(33, 37):
        y, state = tR.rglru_decode_step(tp, u[:, t:t + 1], state, tcfg)
        _close(y, full[:, t:t + 1].numpy(), "float32", f"position {t}")
    for name in ("hidden", "conv"):
        _close(state[name], full_state[name].numpy(), "float32", name)


def test_init_state_matches_jax():
    jst = jR.rglru_init_state(3, jR.RGLRUConfig(d_model=16), jnp.bfloat16)
    tst = tR.rglru_init_state(3, tR.RGLRUConfig(d_model=16), torch.bfloat16)
    for name in ("hidden", "conv"):
        assert tst[name].shape == jst[name].shape and not tst[name].any()
        assert str(tst[name].dtype).split(".")[-1] == str(jst[name].dtype)


def test_compute_params_keeps_the_rglru_gates_fp32():
    """compute_params casts the leaves named ``kernel`` (the in/out
    projections and the conv); the gate matrices, their biases and
    ``lambda_param`` stay the fp32 masters, as the reference computes the
    gates in fp32 on them."""
    _, _, tp, tcfg = pair("recurrentgemma-9b")
    assert tcfg.kinds()[0] == "rglru"
    mixer = tT.compute_params(tp, torch.bfloat16)["layers"][0]["mixer"]
    for name in ("in_x", "in_gate", "conv", "out"):
        assert mixer[name]["kernel"].dtype == torch.bfloat16
    for name in ("rg_kernel", "ig_kernel", "rg_bias", "ig_bias", "lambda_param"):
        assert mixer[name].dtype == torch.float32
        assert mixer[name] is tp["layers"][0]["mixer"][name]
