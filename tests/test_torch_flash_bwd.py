"""The flash-attention backward's plain version (``kernels/ref.py::
flash_attention_bwd_ref``) against JAX's autodiff of the reference
attention, on the CPU.

The JAX Pallas kernel has no backward, so the oracle is ``jax.vjp`` of
``repro/nn/attention.py::_sdpa`` (what the JAX model trains through) and of
``repro/kernels/ref.py::flash_attention_ref``, not the kernel in interpret
mode (which also attends to its zero key padding when not causal). The
port's plain backward takes the forward's output and row logsumexp, as the
CUDA kernel does, from the plain forward (``return_lse``).

It also holds ``ref.flash_attention_bwd_tol`` to account: the bf16 kernel's
roundings, emulated on the host, stay within it, and each fault that
``launch/check_bwd_faults.py`` plants in the kernel, emulated the same
way, fails it.

Tolerances. fp32: both sides compute in fp32 and sum in other orders:
rtol 1e-5, and atol 1e-5, the worst case of a sum of up to 48 terms of
size up to 3 rounded in another order (48 * 2^-24 * 3 = 9e-6). bf16 against the JAX
reference in bf16: both compute in fp32 and round each gradient once to
bf16, but autodiff's softmax takes D = dO . o from the unrounded output
while the port takes the bf16 output the forward stored (an error of 2^-8
|dO||o| in each dS row): 2^-6 of the gradient's largest entry, plus 2^-7
relative. ``_sdpa`` in bf16 also rounds q * scale, the logits and the
weights to bf16 (the JAX model's casts), so it is held at 2^-4 of the
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.launch import check_bwd_faults
from _torch_flash_data import THREE, tf32_product

# (B, S, Skv, H, Hkv, D, causal, window, softcap)
CASES = {
    "causal": (2, 40, 40, 4, 4, 32, True, None, None),
    "window": (2, 48, 48, 4, 2, 32, True, 16, None),
    "softcap": (1, 33, 33, 4, 2, 64, True, None, 50.0),
    "gqa_window_softcap": (2, 40, 40, 8, 2, 32, True, 12, 30.0),
    "ragged_skv": (2, 40, 37, 4, 2, 32, True, None, None),
    "cross": (2, 24, 19, 4, 2, 32, False, None, None),
}
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _inputs(case, dtype, seed=0):
    b, s, skv, h, hkv, d, *_ = CASES[case]
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, s, h, d))]
    _, jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) for a in arrs]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    return j, t


def _kw(case):
    *_, causal, window, softcap = CASES[case]
    return dict(causal=causal, window=window, softcap=softcap)


def _mask(case):
    b, s, skv, *_ = CASES[case]
    kw = _kw(case)
    qi = np.arange(s)[:, None]
    kj = np.arange(skv)[None, :]
    m = np.ones((s, skv), bool)
    if kw["causal"]:
        m &= kj <= qi
    if kw["window"] is not None:
        m &= kj > qi - kw["window"]
    return jnp.asarray(np.broadcast_to(m, (b, s, skv)))


def _port_grads(t, kw):
    q, k, v, do = t
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    return [x.float().numpy() for x in ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)]


def _close(got, want, dtype, scale_tol):
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f"d{name}")
        else:
            atol = scale_tol * np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autodiff_of_sdpa(case, dtype):
    (q, k, v, do), t = _inputs(case, dtype)
    b, s, skv, h, hkv, d, *_ = CASES[case]
    kw = _kw(case)
    cfg = jattn.AttnConfig(d_model=h * d, n_heads=h, n_kv_heads=hkv, head_dim=d,
                           attn_softcap=kw["softcap"], window=kw["window"])
    mask = _mask(case)
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn._sdpa(q_, k_, v_, mask, cfg), q, k, v)
    want = vjp(do.reshape(b, s, h * d))
    _close(_port_grads(t, kw), want, dtype, 2.0 ** -4)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autodiff_of_the_reference_flash(case, dtype):
    (q, k, v, do), t = _inputs(case, dtype, seed=1)
    kw = _kw(case)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention_ref(q_, k_, v_, **kw), q, k, v)
    _close(_port_grads(t, kw), vjp(do), dtype, 2.0 ** -6)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_lse_is_the_logsumexp_of_the_reference_logits(case):
    (q, k, _, _), t = _inputs(case, "float32", seed=2)
    b, s, skv, h, hkv, d, *_ = CASES[case]
    kw = _kw(case)
    kj = jnp.repeat(k, h // hkv, axis=2)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q * d ** -0.5, kj)
    if kw["softcap"]:
        logits = kw["softcap"] * jnp.tanh(logits / kw["softcap"])
    logits = jnp.where(_mask(case)[:, None], logits, -1e30)
    want = jax.nn.logsumexp(logits, axis=-1)
    _, lse = ref.flash_attention_ref(*t[:3], return_lse=True, **kw)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["gqa_window_softcap", "cross"])
def test_ops_flash_attention_on_the_host_differentiates_the_plain_forward(case):
    """On the CPU ``ops.flash_attention`` is the plain forward under
    autograd; its gradients equal the plain backward's."""
    _, (q, k, v, do) = _inputs(case, "float32", seed=3)
    kw = _kw(case)
    q, k, v = (x.clone().requires_grad_(True) for x in (q, k, v))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, **kw)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert sum(ops.launch_counts().values()) == 0
    with torch.no_grad():
        o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bwd_tolerance_holds_the_plain_version_against_the_exact_answer(dtype):
    """``flash_attention_bwd_tol`` bounds the fp32 plain backward's distance
    from the exact (fp64) answer, elementwise and on each output's norm, and
    lies under the gradients' size: a twentieth of the largest in fp32, a
    tenth in bf16, whose bound adds 2^-8 of the terms' magnitudes for the
    kernel's bf16 P and dS."""
    _, (q, k, v, do) = _inputs("gqa_window_softcap", dtype, seed=4)
    kw = _kw("gqa_window_softcap")
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    lse = lse.float()
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    exact = ref.flash_attention_bwd_ref(*(x.double() for x in (q, k, v, o, lse, do)), **kw)
    want = exact if dtype == "float32" else got
    tol, limits = ref.flash_attention_bwd_tol(q, k, v, o, lse, do, want, **kw)
    for g, e, b, lim in zip(got, exact, tol, limits):
        err = g.double() - e
        assert bool((err.abs() <= b).all())
        assert float(err.norm()) <= lim
        assert float(b.max()) < (0.05 if dtype == "float32" else 0.1) * float(e.abs().max())


# The kernels' arithmetic, and the faults their card check must catch.
# (B, S, Skv, H, Hkv, D, masks, q and k's scale): the training path's causal
# GQA at D 128, a softcap whose logits reach the cap, recurrentgemma's MQA at
# D 256 under a window, and the unmasked cross layer with a ragged Skv
EMU_CASES = {
    "causal": (1, 256, 256, 4, 2, 128, dict(causal=True), 1.0),
    "softcap_x4": (1, 256, 256, 4, 2, 128, dict(causal=True, softcap=50.0), 4.0),
    "window_mqa": (1, 300, 300, 4, 1, 256, dict(causal=True, window=100), 1.0),
    "cross": (1, 256, 201, 4, 2, 64, dict(causal=False), 1.0),
}
# what launch/check_bwd_faults.py plants in csrc/flash_attn_bwd.cu and
# csrc/flash_attn_bwd_f32.cu
FAULTS = tuple(check_bwd_faults.FAULTS)


def _emu_inputs(case, dtype=torch.bfloat16):
    b, s, skv, h, hkv, d, kw, mag = EMU_CASES[case]
    g_ = torch.Generator().manual_seed(7)
    q = (mag * torch.randn(b, s, h, d, generator=g_)).to(dtype)
    k = (mag * torch.randn(b, skv, hkv, d, generator=g_)).to(dtype)
    v = torch.randn(b, skv, hkv, d, generator=g_).to(dtype)
    do = torch.randn(b, s, h, d, generator=g_).to(dtype)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


def _tiles(dtype, d):
    """(keys of dQ's key tile, keys of dK/dV's key block) of the kernels
    that run at ``dtype`` and head dim ``d``: the tiles that
    ``check_bwd_faults``' tile faults leave out. bf16 (wgmma): 128 and 128,
    64 and 64 at D 256; fp32 in 3xTF32 (D 32-128): 32 and 64; fp32 on FMAs
    (D 256): 32 and 32."""
    if dtype == torch.bfloat16:
        return (64, 64) if d == 256 else (128, 128)
    return (32, 32) if d == 256 else (32, 64)


def _kernel(q, k, v, o, lse, do, fault=None, **kw):
    """The backward kernel's arithmetic on the host, for q's dtype: P and dS
    in fp32 from the forward's lse and D_i = dO_i . o_i, fp32 sums, the
    outputs rounded once to q's dtype. bf16 (``csrc/flash_attn_bwd.cu``): P
    and dS rounded to bf16 before their products. fp32
    (``csrc/flash_attn_bwd_f32.cu``): up to D 128 each of the five products
    as three TF32 products of the split operands (hi.hi + hi.lo + lo.hi,
    ``tf32_product``), S and dP among them; at D 256 in fp32 (the FMA
    kernels). ``fault`` makes the mistake that ``check_bwd_faults.FAULTS``
    of that name plants, over the kernels' tiles (``_tiles``)."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep, scale = H // Hkv, D ** -0.5
    bf16 = q.dtype == torch.bfloat16
    if bf16 or D == 256:
        mm = torch.einsum
    else:
        def mm(eq, a, b):
            return tf32_product(eq, a, b, THREE)
    kw = {"causal": True, "window": None, "softcap": None, **kw}
    qf, dof = q.float(), do.float()
    k_r, v_r = (x.float().repeat_interleave(rep, dim=2) for x in (k, v))
    s = mm("bqhd,bkhd->bhqk", qf, k_r) * scale
    th = None
    if kw["softcap"]:
        th = torch.tanh(s / kw["softcap"])
        s = kw["softcap"] * th
    _, _, mask, _ = ref._flash_logits(q, k, scale=scale, **kw)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    if fault == "no_delta":
        delta = torch.zeros_like(delta)
    ds = p * (mm("bqhd,bkhd->bhqk", dof, v_r) - delta[..., None])
    if th is not None and fault != "no_softcap_factor":
        ds = ds * (1 - th * th)
    if bf16:
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
    ds_q = ds.clone()
    dq_tile, kv_block = _tiles(q.dtype, D)
    if fault == "dq_skips_key_tile":
        ds_q[..., dq_tile:2 * dq_tile] = 0
    dq = scale * mm("bhqk,bkhd->bqhd", ds_q, k_r)
    if fault == "dkdv_one_head":   # each kv head sums its first query head only
        first = (torch.arange(H) % rep == 0)[None, :, None, None]
        p, ds = p * first, ds * first
    dk = scale * mm("bhqk,bqhd->bkhd", ds, qf)
    dv = mm("bhqk,bqhd->bkhd", p, dof)
    dk, dv = (x.reshape(B, Skv, Hkv, rep, D).sum(3) for x in (dk, dv))
    if fault == "dkdv_skips_key_tile":
        dk[:, kv_block:2 * kv_block] = 0
        dv[:, kv_block:2 * kv_block] = 0
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _worst(case, fault, dtype=torch.bfloat16):
    """(worst err/tol, worst norm err/limit) of the emulated kernel under
    ``flash_attention_bwd_tol``: bf16 against the plain version in fp32,
    fp32 against the exact answer (the plain version in fp64)."""
    args, kw = _emu_inputs(case, dtype)
    if dtype == torch.float32:
        want = ref.flash_attention_bwd_ref(*(x.double() for x in args), **kw)
    else:
        want = ref.flash_attention_bwd_ref(*args, **kw)
    got = _kernel(*args, fault=fault, **kw)
    errs = ref.flash_attention_bwd_errors(got, want, *args, **kw)
    return (max(e["err_over_tol"] for e in errs), max(e["norm_over_limit"] for e in errs))


def _faults_by_case():
    return [(case, fault) for case in EMU_CASES for fault in FAULTS
            # without a softcap the factor is 1, and leaving it out changes nothing
            if fault != "no_softcap_factor" or EMU_CASES[case][6].get("softcap")]


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_bwd_tolerance_holds_the_bf16_kernels_roundings(case):
    """The bf16 kernel's roundings stay within ``flash_attention_bwd_tol``,
    elementwise and on each output's norm, with room (measured on these
    inputs: err/tol at most ~0.6, norm err/limit at most ~0.2)."""
    tol_ratio, norm_ratio = _worst(case, None)
    assert tol_ratio <= 1 and norm_ratio <= 0.5, (tol_ratio, norm_ratio)


@pytest.mark.parametrize("case,fault", _faults_by_case())
def test_bwd_tolerance_catches_planted_faults(case, fault):
    """Each fault that ``launch/check_bwd_faults.py`` plants in the kernel
    fails the check, elementwise and on the norm, several times over."""
    tol_ratio, norm_ratio = _worst(case, fault)
    assert tol_ratio > 4 and norm_ratio > 4, (tol_ratio, norm_ratio)


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_bwd_tolerance_holds_the_3xtf32_kernels_arithmetic(case):
    """The fp32 kernels' arithmetic (3xTF32 up to D 128, fp32 at D 256)
    stays within the fp32 ``flash_attention_bwd_tol`` against the exact
    answer, elementwise and on each output's norm, with room."""
    tol_ratio, norm_ratio = _worst(case, None, torch.float32)
    assert tol_ratio <= 0.5 and norm_ratio <= 0.5, (tol_ratio, norm_ratio)


@pytest.mark.parametrize("case,fault", _faults_by_case())
def test_f32_bwd_tolerance_catches_planted_faults(case, fault):
    """Each fault that ``launch/check_bwd_faults.py`` plants in the fp32
    kernels fails the fp32 check, elementwise and on the norm, several
    times over."""
    tol_ratio, norm_ratio = _worst(case, fault, torch.float32)
    assert tol_ratio > 4 and norm_ratio > 4, (tol_ratio, norm_ratio)


def test_planted_faults_match_the_kernel_source():
    """Each fault of ``check_bwd_faults`` matches ``csrc/flash_attn_bwd.cu``
    and ``csrc/flash_attn_bwd_f32.cu`` as often as it says (once in each
    kernel pair it plants into: bf16 on wgmma, fp32 in 3xTF32, fp32 on
    FMAs), so the card run plants every fault it names in both files."""
    src = check_bwd_faults.sources()
    for name, (_, subs) in check_bwd_faults.FAULTS.items():
        planted = check_bwd_faults.plant(src, subs)
        assert all(planted[f] != src[f] for f in src), name
