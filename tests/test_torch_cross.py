"""The port's cross-attention (``repro_torch/nn/attention.py``) against the
JAX package's, on the CPU: ``cross_attention`` (prefill, through the flash
kernel's plain version with ``causal=False``) against
``repro/nn/attention.py:cross_attention`` (its ``_sdpa`` under an all-true
mask), the cross layer's prefill cache, and one-token decode over it
against ``repro/models/transformer.py:_decode_cross``.

The reference's ``_sdpa`` is the oracle here, not its Pallas kernel in
interpret mode: with ``causal=False`` that kernel attends to the zero keys
it pads Skv with (ROADMAP.md, queue 3), and 37 or 16 vision tokens are no
multiple of its 128-key tile. Weights from ``repro.nn.attention.attn_init``,
inputs from numpy seeds. Tolerances: fp32, the same math in another order,
rtol 1e-4 and 1e-5 of the largest element; bf16, the reference rounds its
attention logits to bf16 and the port's flash path keeps them fp32, so
2^-5 relative plus 2^-5 of the largest element (about two bf16 steps of
the output's size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jT
from repro.nn import attention as jA
from repro_torch.kernels import ops
from repro_torch.models import transformer as tT
from repro_torch.nn import attention as tA
from test_torch_transformer import pair, tokens, vision

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype, what=""):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    tol = (dict(rtol=1e-4, atol=1e-5 * scale) if dtype == "float32"
           else dict(rtol=2 ** -5, atol=2 ** -5 * scale))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _layer(seed, qk_norm):
    """(JAX params, port params, config): a cross layer of d 64 over a
    vision source of 48, 4 heads on 2 kv heads of 16."""
    cfg_kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=qk_norm,
                  cross_kv_dim=48, query_scale=16 ** -0.5)
    jcfg, tcfg = jA.AttnConfig(**cfg_kw), tA.AttnConfig(**cfg_kw)
    jp = jax.tree.map(np.asarray, jA.attn_init(jax.random.key(seed), jcfg))
    if qk_norm:
        rng = np.random.RandomState(seed + 1)
        for name in ("q_norm", "k_norm"):
            jp[name]["norm_scale"] = (0.3 * rng.randn(16)).astype(np.float32)
    tp = {k: {kk: torch.tensor(vv) for kk, vv in v.items()} for k, v in jp.items()}
    return jax.tree.map(jnp.asarray, jp), tp, jcfg, tcfg


def _inputs(seed, b, s, skv, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(b, s, 64).astype(np.float32)).astype(jdt)
    kv = rng.randn(b, skv, 48).astype(np.float32)     # fp32: each side casts it
    return (x, jnp.asarray(kv)), (torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt),
                                  torch.from_numpy(kv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("s, skv", [(24, 37), (40, 16)])
def test_cross_attention_matches_jax(s, skv, qk_norm, dtype):
    jp, tp, jcfg, tcfg = _layer(0, qk_norm)
    (jx, jkv), (tx, tkv) = _inputs(1, 2, s, skv, dtype)
    want = jA.cross_attention(jp, jx, jkv, jcfg)
    ops.reset_launch_counts()
    got = tA.cross_attention(tp, tx, tkv, tcfg)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (2, s, 64)
    assert sum(ops.launch_counts().values()) == 0         # the plain version on the host
    _close(got, want, dtype)


def test_cross_queries_take_no_rope_and_no_causal_mask():
    """Every query row sees every vision token, whatever its position: the
    output at each position depends on that position's query alone, so
    reversing the text reverses the output."""
    _, tp, _, tcfg = _layer(2, False)
    _, (tx, tkv) = _inputs(3, 1, 12, 9, "float32")
    out = tA.cross_attention(tp, tx, tkv, tcfg)
    rev = tA.cross_attention(tp, tx.flip(1), tkv, tcfg)
    torch.testing.assert_close(rev.flip(1), out, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("qk_norm", [False, True])
def test_decode_cross_matches_jax(qk_norm, dtype):
    """One query over a vision cache of 37 tokens, the cache in the compute
    dtype, left as it was."""
    jp, tp, jcfg, tcfg = _layer(4, qk_norm)
    jdt, tdt = DTYPES[dtype]
    (jx, _), (tx, _) = _inputs(5, 2, 1, 1, dtype)
    rng = np.random.RandomState(6)
    kv = [jnp.asarray(rng.randn(2, 37, 2, 16).astype(np.float32)).astype(jdt)
          for _ in range(2)]
    jcache = dict(zip(("k", "v"), kv))
    tcache = {n: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
              for n, a in jcache.items()}
    before = {n: t.clone() for n, t in tcache.items()}
    want, _ = jT._decode_cross(jp, jx, jcache, jcfg)
    got = tA.decode_cross_attention(tp, tx, tcache, tcfg)
    assert got.shape == (2, 1, 64)
    assert all(torch.equal(tcache[n], before[n]) for n in before)
    _close(got, want, dtype)


@pytest.mark.parametrize("compute, cache", [("float32", "float32"), ("float32", "bfloat16"),
                                            ("bfloat16", "bfloat16")])
def test_prefill_caches_the_vision_kv_as_jax(compute, cache):
    """The VLM smoke config's prefill: its cross layer caches the vision
    tokens' k and v (B, vision_tokens, Hkv, D) in the cache dtype, whatever
    the prompt's length, as the reference does; the cache's bf16 rounding
    of fp32 k/v agrees but for values the two sides computed a hair apart
    on either side of a rounding boundary (fp32 compute, bf16 cache: one
    bf16 step)."""
    jp, jcfg, tp, tcfg = pair("llama-3.2-vision-90b", compute)
    jdt, tdt = DTYPES[cache]
    ids = tokens(7)
    jv, tv = vision(tcfg)
    _, jc = jT.prefill(jp, jnp.asarray(ids), jcfg, vision=jv, cache_len=44,
                       cache_dtype=jdt)
    _, tc = tT.prefill(tp, torch.from_numpy(ids), tcfg, vision=tv, cache_len=44,
                       cache_dtype=tdt)
    assert tcfg.kinds() == ("attn", "cross")
    jcross = jax.tree.map(np.asarray, jc["blocks"][1])
    for name in ("k", "v"):
        got = tc[1][name]
        assert got.dtype == tdt
        assert got.shape == (2, tcfg.vision_tokens, tcfg.n_kv_heads, tcfg.head_dim)
        want = np.asarray(jcross[name][0], np.float32)
        step = np.abs(want) * 2.0 ** -7 if cache == "bfloat16" else 0.0
        tol = 1e-5 * np.abs(want).max() + 1e-4 * np.abs(want)
        assert (np.abs(got.detach().float().numpy() - want) <= tol + step).all(), name
    assert tc[0]["k"].shape[1] == 44                       # the self layer: cache_len
    # init_cache gives a cross layer cache_len slots, as the reference's
    init = tT.init_cache(tcfg, 2, 44, device="cpu")
    assert init[1]["k"].shape == (2, 44, tcfg.n_kv_heads, tcfg.head_dim)
