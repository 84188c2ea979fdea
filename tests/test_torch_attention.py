"""The port's attention against the JAX package's, on the CPU.

The port's flash dispatch sends a CPU tensor to its plain version
(``repro_torch/kernels/ref.py::flash_attention_ref``); the JAX side runs
its Pallas kernel as tests/test_kernels.py does, in interpret mode. The
layers (RoPE, norms, MLP, the decode ``_sdpa`` and its rolling cache) are
held to the JAX functions on the same inputs, made by numpy from a seed.
tests/test_torch_cuda.py holds the CUDA kernel to the plain version on a
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import attention as jA
from repro.nn import layers as jL
from repro_torch.kernels import ops, ref
from repro_torch.nn import attention as tA
from repro_torch.nn import layers as tL
from _torch_flash_data import SCALE, THREE, low_bit_qkv, tf32_product

_TDT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# fp32: the same function summed in another order. bf16 inputs: fp32 math
# on both sides, then one bf16 rounding of the output (one bf16 step is
# 2^-7 relative), plus fp32 noise where the output is near 0.
TOL = {jnp.float32: dict(rtol=1e-5, atol=1e-5),
       jnp.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}


def _t(a):
    """A JAX array as an fp32 torch tensor (a copy)."""
    return torch.tensor(np.asarray(a, np.float32))


def _qkv(seed, b, s, skv, h, hkv, d, dtype=jnp.float32, scale=1.0):
    rng = np.random.RandomState(seed)
    arrs = [scale * rng.randn(b, s, h, d), scale * rng.randn(b, skv, hkv, d),
            rng.randn(b, skv, hkv, d)]
    j = [jnp.asarray(a, dtype) for a in arrs]
    return j, [_t(a).to(_TDT[dtype]) for a in j]


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


# ------------------------------------------------------------------- flash --

@pytest.mark.parametrize("s,skv,h,hkv,d", [
    (64, 64, 2, 2, 32), (128, 128, 4, 2, 32), (96, 96, 2, 1, 64),
    (64, 128, 2, 2, 32), (200, 200, 4, 2, 64),
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_dispatch_matches_jax_kernel(s, skv, h, hkv, d, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(s + skv, 2, s, skv, h, hkv, d, dtype)
    want = jops.flash_attention(jq, jk, jv, interpret=True)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert ops.launch_counts()["flash_attn"] == 0      # CPU: the plain version
    _close(got, want, dtype)


@pytest.mark.parametrize("window", [16, 48])
@pytest.mark.parametrize("softcap", [None, 50.0])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_window_softcap_matches_jax_kernel(window, softcap, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(window, 1, 128, 128, 4, 2, 32, dtype, scale=3.0)
    kw = dict(window=window, softcap=softcap, scale=0.125)
    want = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    _close(ops.flash_attention(q, k, v, **kw), want, dtype)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (False, 64)])
def test_flash_ragged_kv_matches_jax_ref(causal, window):
    """Skv = 200 is not a multiple of the JAX kernel's 128-key block. The JAX
    wrapper pads k/v with zeros and its kernel masks the padding only through
    the causal test (repro/kernels/flash_attn.py:117-123, :52-59), so with
    causal=False it attends to the padding and misses its own oracle; the
    port masks keys j >= Skv always and is held to ``flash_attention_ref``."""
    (jq, jk, jv), (q, k, v) = _qkv(3, 2, 200, 200, 4, 2, 64)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(ops.flash_attention(q, k, v, causal=causal, window=window), want,
           jnp.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_rows_without_keys_are_refused(causal):
    """With a window, S = Skv + window - 1 leaves the last query row one key
    and matches the JAX oracle; one row more would have none, where the plain
    version gives the mean of v and the CUDA kernel 0, so both devices raise."""
    window, skv = 16, 40
    (jq, jk, jv), (q, k, v) = _qkv(4, 1, skv + window - 1, skv, 2, 1, 32)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(ops.flash_attention(q, k, v, causal=causal, window=window), want,
           jnp.float32)
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(q, k[:, 1:], v[:, 1:], causal=causal, window=window)


def test_flash_equals_model_sdpa():
    """The kernel's function is the model's masked attention (same masks)."""
    cfg = jA.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
                        window=24, attn_softcap=50.0)
    (jq, jk, jv), (q, k, v) = _qkv(9, 1, 64, 64, 4, 2, 32)
    mask = jA.causal_mask(64, 64, 0, cfg.window)[None]
    want = jA._sdpa(jq, jk, jv, mask, cfg).reshape(1, 64, 4, 32)
    got = ops.flash_attention(q, k, v, window=24, softcap=50.0)
    _close(got, want, jnp.float32)


def _tensor_core_arithmetic(q, k, v, *, causal, window, softcap):
    """The bf16 tensor-core kernel's arithmetic, on the CPU: fp32 logits,
    exp(s - max) rounded to bf16 before P.V, fp32 row sums, bf16 output."""
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, 2)
    vf = v.float().repeat_interleave(group, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * q.shape[-1] ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(q.shape[1])[:, None]
    j = torch.arange(k.shape[1])[None, :]
    keep = torch.ones_like(i == j)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", e.bfloat16().float(), vf)
    return (o / e.sum(-1).transpose(1, 2)[..., None]).bfloat16()


@pytest.mark.parametrize("causal,window,softcap", [(True, None, None), (False, None, None),
                                                   (True, 40, 50.0)])
def test_flash_bf16_tolerance_covers_the_tensor_core_rounding(causal, window, softcap):
    """kernels/ref.py::flash_attention_tol, which chip_smoke.py and the card
    tests hold the bf16 kernel to, admits the rounding of P to bf16 that the
    tensor-core kernel does, against the JAX package's plain attention."""
    (jq, jk, jv), (q, k, v) = _qkv(21, 2, 160, 160, 4, 2, 64, jnp.bfloat16, scale=2.0)
    want = _t(jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                       softcap=softcap))
    got = _tensor_core_arithmetic(q, k, v, causal=causal, window=window, softcap=softcap)
    bound = ref.flash_attention_tol(q, k, v, want, causal=causal, window=window,
                                    softcap=softcap)
    err = (got.float() - want).abs()
    assert bool((err <= bound).all()), (err / bound).max()
    # the plain version itself sits well inside it
    plain = ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    assert bool(((plain.float() - want).abs() <= bound).all())


def _tf32_arithmetic(q, k, v, *, causal, window=None, softcap=None, scale=None,
                     s_terms=THREE, pv_terms=THREE):
    """The fp32 flash kernel's arithmetic, on the CPU: q times the scale,
    S = Q.K^T and O = P.V each through ``tf32_product``, the softmax and
    its row sums in fp32."""
    group = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(group, 2)
    vf = v.repeat_interleave(group, 2)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = tf32_product("bqhd,bkhd->bhqk", q * scale, kf, s_terms)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(q.shape[1])[:, None]
    j = torch.arange(k.shape[1])[None, :]
    keep = torch.ones_like(i == j)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = tf32_product("bhqk,bkhd->bqhd", e, vf, pv_terms)
    return o / e.sum(-1).transpose(1, 2)[..., None]


@pytest.mark.parametrize("s,skv,h,hkv,d,causal,window,softcap", [
    (160, 160, 4, 2, 32, True, None, None), (160, 160, 4, 2, 128, True, None, None),
    (160, 130, 4, 1, 128, False, 64, None), (130, 160, 2, 2, 32, True, 40, 50.0),
    (48, 48, 2, 1, 256, True, None, 30.0)])
def test_flash_f32_tolerance_needs_three_tf32_products(s, skv, h, hkv, d, causal, window,
                                                       softcap):
    """kernels/ref.py::flash_attention_tol's fp32 bound, 1e-5 + 1e-5|ref|,
    which chip_smoke.py and the card tests hold the fp32 kernel to, admits
    its 3xTF32 arithmetic against the JAX package's plain attention, and
    refuses one TF32 product: why the kernel takes three."""
    (jq, jk, jv), (q, k, v) = _qkv(s + d, 2, s, skv, h, hkv, d, scale=2.0)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _t(jref.flash_attention_ref(jq, jk, jv, **kw))
    bound = ref.flash_attention_tol(q, k, v, want, **kw)
    got = _tf32_arithmetic(q, k, v, **kw)
    err = (got - want).abs()
    assert bool((err <= bound).all()), (err / bound).max()
    one = _tf32_arithmetic(q, k, v, **kw, s_terms=("one",), pv_terms=("one",))
    assert (((one - want).abs() / bound).max()) > 10


@pytest.mark.parametrize("dropped", [None, ("S", "hi.lo"), ("S", "lo.hi"), ("PV", "hi.lo"),
                                     ("PV", "lo.hi")])
@pytest.mark.parametrize("d", [32, 128])
def test_flash_f32_low_bit_inputs_need_every_cross_product(d, dropped):
    """On ``low_bit_qkv``'s inputs, whose answer lives in the bits one TF32
    product drops, the kernel's three products hold the fp32 bound against
    the exact answer (the plain version in fp64), and a kernel that drops
    the hi.lo or the lo.hi product of either matmul misses it: the card
    test on the same inputs (tests/test_torch_cuda.py) catches such a
    fault."""
    q, k, v = low_bit_qkv(d, d=d)
    want = ref.flash_attention_ref(q.double(), k.double(), v.double(), scale=SCALE)
    bound = ref.flash_attention_tol(q, k, v, want)
    terms = {"S": THREE, "PV": THREE}
    if dropped is not None:
        terms[dropped[0]] = tuple(t for t in THREE if t != dropped[1])
    got = _tf32_arithmetic(q, k, v, causal=True, scale=SCALE, s_terms=terms["S"],
                           pv_terms=terms["PV"])
    worst = ((got.double() - want).abs() / bound).max().item()
    if dropped is None:
        assert worst <= 0.5
    else:   # 9x (P.V's hi.lo) to 1000x (S's cross terms) the bound
        assert worst > 4


# ------------------------------------------------------------------ layers --

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_matches_jax(dtype, theta):
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(2, 40, 3, 32), dtype)
    pos = np.stack([np.arange(40), np.arange(40) + 1000]).astype(np.int32)
    want = jA.rope(x, jnp.asarray(pos), theta)
    got = tA.rope(_t(x).to(_TDT[dtype]),
                  torch.from_numpy(pos), theta)
    # fp32: sin/cos of angles up to 1040 rad differ by an ulp between the
    # libraries (~1e-4 absolute at that size); bf16: then one rounding
    tol = dict(rtol=1e-5, atol=3e-4) if dtype == jnp.float32 else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_norms_match_jax(dtype):
    rng = np.random.RandomState(2)
    x = jnp.asarray(3 * rng.randn(4, 7, 64), dtype)
    w, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    tx = _t(x).to(_TDT[dtype])
    got = tL.rmsnorm(tx, torch.from_numpy(w))
    want = jL.rmsnorm({"norm_scale": jnp.asarray(w)}, x)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jref.rmsnorm_ref(x, jnp.asarray(w)), np.float32),
        **TOL[dtype])
    got = tL.layernorm(tx, torch.from_numpy(w), torch.from_numpy(b))
    want = jL.layernorm({"norm_scale": jnp.asarray(w), "norm_bias": jnp.asarray(b)}, x)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("act", ["gelu", "silu", "relu", "gelu_tanh"])
@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(act, gated):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 32).astype(np.float32)
    p = {"up": {"kernel": rng.randn(32, 48).astype(np.float32) / 6},
         "down": {"kernel": rng.randn(48, 32).astype(np.float32) / 7}}
    if gated:
        p["gate"] = {"kernel": rng.randn(32, 48).astype(np.float32) / 6}
    want = jL.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), act=act)
    got = tL.mlp(jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_embed_unembed_match_jax():
    rng = np.random.RandomState(4)
    table = rng.randn(50, 16).astype(np.float32)
    ids = rng.randint(0, 50, (3, 7)).astype(np.int32)
    want = jL.embed({"embedding": jnp.asarray(table)}, jnp.asarray(ids))
    got = tL.embed(torch.from_numpy(table), torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    x = rng.randn(3, 16).astype(np.float32)
    np.testing.assert_allclose(
        tL.unembed(torch.from_numpy(table), torch.from_numpy(x)).numpy(),
        np.asarray(jL.unembed({"embedding": jnp.asarray(table)}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ decode --

def _attn_params(seed, cfg):
    rng = np.random.RandomState(seed)
    hd = cfg.head_dim
    p = {"q": {"kernel": rng.randn(cfg.d_model, cfg.n_heads * hd)},
         "k": {"kernel": rng.randn(cfg.d_model, cfg.n_kv_heads * hd)},
         "v": {"kernel": rng.randn(cfg.d_model, cfg.n_kv_heads * hd)},
         "o": {"kernel": rng.randn(cfg.n_heads * hd, cfg.d_model)}}
    p = jax.tree.map(lambda a: (a / np.sqrt(a.shape[0])).astype(np.float32), p)
    if cfg.qk_norm:
        p["q_norm"] = {"norm_scale": (0.1 * rng.randn(hd)).astype(np.float32)}
        p["k_norm"] = {"norm_scale": (0.1 * rng.randn(hd)).astype(np.float32)}
    return jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)


def _cfgs(window, softcap):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
              window=window, attn_softcap=softcap, query_scale=0.25)
    return jA.AttnConfig(**kw), tA.AttnConfig(**kw)


@pytest.mark.parametrize("window,softcap", [(None, None), (16, 50.0), (8, None)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_prefill_cache_and_decode_match_jax(window, softcap, dtype):
    """Prefill a 40-token prompt (longer than the window: the rolled cache),
    then decode 6 tokens through the rolling buffer."""
    jcfg, tcfg = _cfgs(window, softcap)
    jp, tp = _attn_params(5, jcfg)
    rng = np.random.RandomState(6)
    S, steps = 40, 6
    xs = rng.randn(2, S + steps, 64).astype(np.float32)
    clen = S + steps if window is None else window
    tdt = _TDT[dtype]

    jc = jA.prefill_kv_cache(jp, jnp.asarray(xs[:, :S], dtype), jcfg, clen)
    tc = tA.prefill_kv_cache(tp, torch.from_numpy(xs[:, :S]).to(tdt), tcfg, clen)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16 and tc[name].shape == jc[name].shape
        # fp32 projections round to the bf16 cache; values on a rounding
        # boundary may go either way (one bf16 step)
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32),
                                   rtol=2 ** -7, atol=2 ** -7 if dtype == jnp.bfloat16 else 1e-6)
    for t in range(steps):
        x = xs[:, S + t:S + t + 1]
        jout, jc = jA.decode_self_attention(jp, jnp.asarray(x, dtype), jc, S + t, jcfg)
        tout, tc = tA.decode_self_attention(tp, torch.from_numpy(x).to(tdt), tc,
                                            S + t, tcfg)
        # the decode _sdpa repeats the JAX casts, so bf16 differs only where
        # a rounding falls the other way (one bf16 step)
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == jnp.float32
               else dict(rtol=2 ** -7, atol=2 ** -8))
        np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32), **tol)


@pytest.mark.parametrize("sq,skv,offset,window", [(8, 8, 0, None), (5, 12, 7, 4),
                                                  (16, 16, 0, 3)])
def test_causal_mask_matches_jax(sq, skv, offset, window):
    np.testing.assert_array_equal(tA.causal_mask(sq, skv, offset, window).numpy(),
                                  np.asarray(jA.causal_mask(sq, skv, offset, window)))


def test_self_attention_matches_jax_sdpa_path():
    """The port's full-sequence attention (plain flash on the host) against
    the JAX model's ``_sdpa`` path, fp32, with a window and a softcap."""
    jcfg, tcfg = _cfgs(16, 50.0)
    jp, tp = _attn_params(7, jcfg)
    x = np.random.RandomState(8).randn(2, 48, 64).astype(np.float32)
    want = jA.self_attention(jp, jnp.asarray(x), jcfg)
    got = tA.self_attention(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
