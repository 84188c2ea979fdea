"""The port's transformer against the JAX package's, on the CPU.

Weights are made by ``repro.models.transformer.init`` (norm scales given
random values so that every norm shows) and carried across with
``repro_torch.convert.transformer_from_jax``; tokens come from numpy with a
fixed seed. The port's prefill attention runs the flash kernel's plain
version here, the JAX model its ``_sdpa``: the same function, with the
logits in fp32 on one side and in the compute dtype on the other.

The MoE archs are held to the JAX model in fp32 only. Top-k routing is
discontinuous: in bf16 the two models' router inputs differ by a rounding
here and there, which can flip a near-tie between a token's k-th and
(k+1)-th expert and move that token's output by far more than any bf16
tolerance (``tests/test_torch_moe.py`` holds ``moe_apply`` itself in bf16 on
identical inputs, where the routing agrees exactly).

The VLM's cross layers read the same fp32 ``vision`` input (numpy seed) on
both sides; each side casts it to its compute dtype.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops
from repro_torch.models import transformer as tT

ARCHS = ("qwen3-1.7b", "gemma2-27b", "gemma-7b", "llama3-405b", "musicgen-medium",
         "granite-moe-3b-a800m", "kimi-k2-1t-a32b", "mamba2-2.7b", "recurrentgemma-9b",
         "llama-3.2-vision-90b")
MOE_ARCHS = ("granite-moe-3b-a800m", "kimi-k2-1t-a32b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (dtype, arch): every arch in fp32, the archs without a router in bf16 too
CASES = [(d, a) for d in DTYPES for a in ARCHS if d == "float32" or a not in MOE_ARCHS]
# fp32: the same math in another order. bf16: the JAX model rounds its
# attention logits (and, by XLA's CPU fusion, some intermediates) at other
# places than the port, whose flash path keeps the logits in fp32; through
# two layers that moves the fp32 logits (|logit| < 1.1 here) by up to 0.013,
# about three bf16 steps of their size.
LOGIT_TOL = {"float32": dict(rtol=1e-4, atol=2e-5),
             "bfloat16": dict(rtol=0.02, atol=0.02)}


def pair(arch, dtype="float32", seed=0):
    """(JAX params, JAX cfg, port tree, port cfg) from the same weights."""
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(jregistry.get_smoke(arch), compute_dtype=jdt)
    tcfg = dataclasses.replace(tregistry.get_smoke(arch), compute_dtype=tdt)
    rng = np.random.RandomState(seed + 100)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(0.3 * rng.randn(*p.shape).astype(np.float32))
        if "norm_scale" in jax.tree_util.keystr(path) else p,
        jT.init(jax.random.key(seed), jcfg))
    model = tT.init(tcfg, seed=seed, device="cpu")
    model.load_state_dict(convert.transformer_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return jp, jcfg, model.tree(), tcfg


def tokens(seed, b=2, s=40, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def vision(cfg, seed=11, b=2):
    """(JAX, port) copies of one fp32 vision input (b, vision_tokens,
    cross_kv_dim), or (None, None) for a model without cross layers."""
    if not cfg.vision_tokens:
        return None, None
    v = np.random.RandomState(seed).randn(b, cfg.vision_tokens, cfg.cross_kv_dim)
    v = v.astype(np.float32)
    return jnp.asarray(v), torch.from_numpy(v)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype, arch", CASES)
def test_forward_logits_match_jax(arch, dtype):
    """Logits, and the MoE layers' aux loss summed in fp32 (0 without them:
    the same fp32 values in another order, 1e-5 relative)."""
    jp, jcfg, tp, tcfg = pair(arch, dtype)
    ids = tokens(1)
    jv, tv = vision(tcfg)
    want, want_aux = jT.forward(jp, jnp.asarray(ids), jcfg, vision=jv)
    got, aux = tT.forward(tp, torch.from_numpy(ids), tcfg, vision=tv)
    assert got.dtype == torch.float32 and got.shape == (2, 40, tcfg.vocab)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if tcfg.mlp == "moe":
        assert aux.item() > 0.0
        np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    else:
        assert aux.item() == 0.0 == float(want_aux)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL[dtype])


@pytest.mark.parametrize("dtype, arch", CASES)
def test_prefill_then_decode_match_jax(arch, dtype):
    """A 40-token prompt (gemma2's and recurrentgemma's window is 16, so
    their local layers' caches are rolled; mamba2's chunk of 256 holds it
    whole, recurrentgemma's scan takes it in 3 chunks of 16, the last
    padded), then 4 decode steps from the same caches (the VLM's cross
    layer reads its vision cache).

    The caches are in the compute dtype. In fp32 a bf16 cache would round
    k and v that the two models computed apart by fp32 noise, now and then
    to neighbouring bf16 values, and move the decode logits by more than
    fp32 noise (gemma-7b: 3x the fp32 tolerance; with fp32 caches every
    arch stays within 0.06 of it). The bf16 cache under fp32 compute is
    held by the ``generate`` tests of tests/test_torch_serve.py."""
    jp, jcfg, tp, tcfg = pair(arch, dtype)
    jdt, tdt = DTYPES[dtype]
    ids = tokens(2)
    S, steps = ids.shape[1], 4
    jv, tv = vision(tcfg)
    jlog, jcache = jT.prefill(jp, jnp.asarray(ids), jcfg, vision=jv, cache_len=S + steps,
                              cache_dtype=jdt)
    tlog, tcache = tT.prefill(tp, torch.from_numpy(ids), tcfg, vision=tv,
                              cache_len=S + steps, cache_dtype=tdt)
    assert tlog.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGIT_TOL[dtype])
    jlayers = convert.layers_from_jax(jax.tree.map(np.asarray, jcache), jcfg)
    for kind, jc, tc in zip(tcfg.kinds(), jlayers, tcache):
        if kind == "ssd":
            _assert_ssd_state_matches(tc, jc, tcfg, dtype)
            continue
        if kind == "rglru":
            _assert_rglru_state_matches(tc, jc, tcfg, dtype)
            continue
        want_len = {"attn": S + steps, "local": tcfg.window,
                    "cross": tcfg.vision_tokens}[kind]
        for name in ("k", "v"):
            assert tc[name].dtype == tdt
            assert tc[name].shape == (2, want_len, tcfg.n_kv_heads, tcfg.head_dim)
            # fp32: k/v that the two models computed apart by fp32 noise
            # (sums of d_model products in another order: up to 2.6e-6 on
            # elements near 0 where others reach 2.3); bf16: apart by up to
            # 0.08 where |k|, |v| reach 4.3 (about three bf16 steps at that
            # size), on small elements too
            tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else \
                dict(rtol=2 ** -5, atol=2 ** -3)
            np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name], np.float32),
                                       **tol)
    rng = np.random.RandomState(3)
    for t in range(steps):
        tok = rng.randint(0, tcfg.vocab, (2, 1)).astype(np.int32)
        jlog, jcache = jT.decode_step(jp, jnp.asarray(tok), jcache, S + t, jcfg)
        tlog, tcache = tT.decode_step(tp, torch.from_numpy(tok), tcache, S + t, tcfg)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **LOGIT_TOL[dtype])


def _assert_ssd_state_matches(tc, jc, tcfg, dtype):
    """An SSD layer's prefill state: ``ssm`` fp32 (B, H, P, N), ``conv`` in
    the compute dtype (B, W-1, d_inner + 2N), as the reference returns them.
    fp32: the same sums in another order (1e-4 relative, 1e-6 absolute
    where elements cancel); bf16: the conv state is the bf16 projection of
    the same prompt, a rounding or three apart (as the attention caches),
    and the fp32 state sums dt-weighted bf16 inputs that differ so."""
    sc = tcfg.ssd_cfg()
    _, tdt = DTYPES[dtype]
    assert tc["ssm"].dtype == torch.float32
    assert tc["ssm"].shape == (2, sc.n_heads, sc.head_dim, sc.d_state)
    assert tc["conv"].dtype == tdt
    assert tc["conv"].shape == (2, sc.conv_width - 1, sc.d_inner + 2 * sc.d_state)
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -5, atol=2 ** -5)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name], np.float32),
                                   err_msg=name, **tol)


def _assert_rglru_state_matches(tc, jc, tcfg, dtype):
    """An RG-LRU layer's prefill state: ``hidden`` fp32 (B, w), ``conv`` in
    the compute dtype (B, W-1, w). fp32: the scan in another association
    order (1e-4 relative, 1e-6 absolute); bf16: the conv state is the bf16
    projection of the same prompt, and the fp32 hidden state sums inputs
    that differ so, a rounding or three apart."""
    rc = tcfg.rglru_cfg()
    _, tdt = DTYPES[dtype]
    assert tc["hidden"].dtype == torch.float32 and tc["hidden"].shape == (2, rc.width)
    assert tc["conv"].dtype == tdt and tc["conv"].shape == (2, rc.conv_width - 1, rc.width)
    tol = dict(rtol=1e-4, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -5, atol=2 ** -5)
    for name in ("hidden", "conv"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name], np.float32),
                                   err_msg=name, **tol)


def test_prefill_launches_no_kernel_on_the_host():
    _, _, tp, tcfg = pair("qwen3-1.7b")
    ops.reset_launch_counts()
    tT.prefill(tp, torch.from_numpy(tokens(4)), tcfg)
    assert ops.launch_counts()["flash_attn"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_gradients_on_the_host_match_jax(arch):
    """On the host the attention is the plain version and differentiable
    (on the card the flash kernel has no backward and refuses autograd):
    every weight's gradient of a fixed projection of the fp32 logits
    matches jax.grad through the JAX model, to fp32 summation-order noise
    (1e-5 of the gradient's largest element, as elements cancel)."""
    jp, jcfg, _, tcfg = pair(arch)
    ids = tokens(5)
    jv, tv = vision(tcfg)
    w = np.random.RandomState(6).randn(2, 40, tcfg.vocab).astype(np.float32)
    jg = jax.grad(lambda p: (jT.forward(p, jnp.asarray(ids), jcfg, vision=jv)[0]
                             * w).sum())(jp)
    want = convert.transformer_from_jax(jax.tree.map(np.asarray, jg), tcfg, device="cpu")
    model = tT.init(tcfg, seed=0, device="cpu")
    model.load_state_dict(convert.transformer_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    logits, _ = tT.forward(model, torch.from_numpy(ids), tcfg, vision=tv)
    (logits * torch.from_numpy(w)).sum().backward()
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_and_state_dict_match_jax(arch):
    for getter in ("get", "get_smoke"):
        jcfg = getattr(jregistry, getter)(arch)
        tcfg = getattr(tregistry, getter)(arch)
        assert tcfg.num_params() == jcfg.num_params()
        assert tcfg.active_params() == jcfg.active_params()
        assert tcfg.kinds() == jcfg.kinds()
        assert (tcfg.n_prefix, tcfg.n_blocks) == (jcfg.n_prefix, jcfg.n_blocks)
    jp, jcfg, tp, tcfg = pair(arch)
    model = tT.init(tcfg, seed=0, device="cpu")
    # num_params leaves out the norm scales in both packages; the trees hold them
    assert (sum(p.numel() for p in model.parameters())
            == sum(np.size(a) for a in jax.tree.leaves(jp)))
    sd = convert.transformer_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())


def test_scan_blocks_off_keeps_the_layer_order():
    """With scan_blocks=False every layer is in ``prefix``; conversion gives
    the same port weights as the scanned tree, layer by layer."""
    jcfg = jregistry.get_smoke("gemma2-27b")
    tcfg = tregistry.get_smoke("gemma2-27b")
    flat = dataclasses.replace(jcfg, scan_blocks=False)
    scanned = jT.init(jax.random.key(0), jcfg)
    layers = convert.layers_from_jax(jax.tree.map(np.asarray, scanned), jcfg)
    unscanned = {"embed": scanned["embed"], "final_norm": scanned["final_norm"],
                 "prefix": layers}
    a = convert.transformer_from_jax(jax.tree.map(np.asarray, scanned), tcfg, device="cpu")
    b = convert.transformer_from_jax(
        jax.tree.map(np.asarray, unscanned),
        dataclasses.replace(tcfg, scan_blocks=False), device="cpu")
    assert flat.n_prefix == 2 and jcfg.n_prefix == 0
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_qwen3_source_names_the_1_7b_model():
    cfg = tregistry.get("qwen3-1.7b")
    assert cfg.source == "hf:Qwen/Qwen3-1.7B"
    assert cfg.num_params() == 1_720_451_072


@pytest.mark.parametrize("arch, source, n_params, n_active", [
    # the JAX copy names the 1b-a400m model, whose widths are not these
    ("granite-moe-3b-a800m", "hf:ibm-granite/granite-3.0-3b-a800m-base",
     3_298_693_632, 882_774_528),
    # the JAX copy gives "arXiv:2501.kimi2", which is not an identifier
    ("kimi-k2-1t-a32b", "hf:moonshotai/Kimi-K2-Base",
     1_025_611_661_312, 32_064_929_792),
    ("mamba2-2.7b", "arXiv:2405.21060", 2_700_349_440, 2_700_349_440),
])
def test_moe_and_ssd_sources_and_sizes(arch, source, n_params, n_active):
    cfg = tregistry.get(arch)
    assert cfg.source == source
    assert (cfg.num_params(), cfg.active_params()) == (n_params, n_active)
    assert dataclasses.replace(cfg, source="") == dataclasses.replace(
        tregistry.get(arch), source="")


@pytest.mark.parametrize("arch, source, n_params", [
    ("recurrentgemma-9b", "arXiv:2402.19427", 9_395_240_960),
    # the JAX copy names the 11B model, whose widths are not these
    ("llama-3.2-vision-90b", "hf:meta-llama/Llama-3.2-90B-Vision", 87_644_176_384),
])
def test_rglru_and_vlm_sources_and_sizes(arch, source, n_params):
    cfg = tregistry.get(arch)
    assert cfg.source == source
    assert cfg.num_params() == cfg.active_params() == n_params


def test_vlm_needs_its_vision_input():
    _, _, tp, tcfg = pair("llama-3.2-vision-90b")
    ids = torch.from_numpy(tokens(4))
    for entry in (tT.forward, tT.prefill):
        with pytest.raises(ValueError, match="cross layers: pass vision"):
            entry(tp, ids, tcfg)


def test_registry_ports_all_ten_archs_with_the_reference_kinds():
    assert tregistry.ARCH_IDS == jregistry.ARCH_IDS and sorted(ARCHS) == sorted(tregistry.ARCH_IDS)
    for arch in tregistry.ARCH_IDS:
        for getter in (tregistry.get, tregistry.get_smoke):
            assert getter(arch).kinds() == getattr(jregistry, getter.__name__)(arch).kinds()


def test_compute_params_keeps_the_router_and_ssd_vectors_fp32():
    """The expert stacks are cast (they are not named ``kernel``); the
    router's kernel stays fp32, as the reference routes with it; the SSD's
    dt_bias, A_log and D stay fp32 (the reference casts D at use)."""
    _, _, tp, _ = pair("granite-moe-3b-a800m")
    mlp = tT.compute_params(tp, torch.bfloat16)["layers"][1]["mlp"]
    assert mlp["router"]["kernel"].dtype == torch.float32
    assert mlp["router"]["kernel"] is tp["layers"][1]["mlp"]["router"]["kernel"]
    for name in ("up", "gate", "down"):
        assert mlp["experts"][name].dtype == torch.bfloat16
    _, _, tp, _ = pair("mamba2-2.7b")
    mixer = tT.compute_params(tp, torch.bfloat16)["layers"][0]["mixer"]
    for name in ("in_proj", "conv", "out_proj"):
        assert mixer[name]["kernel"].dtype == torch.bfloat16
    for name in ("dt_bias", "A_log", "D"):
        assert mixer[name].dtype == torch.float32
    assert mixer["out_norm"]["norm_scale"].dtype == torch.float32


def test_compute_params_casts_matrices_only():
    _, _, tp, tcfg = pair("gemma2-27b")
    cp = tT.compute_params(tp, torch.bfloat16)
    assert cp["embed"]["embedding"].dtype == torch.bfloat16
    assert cp["layers"][0]["mixer"]["q"]["kernel"].dtype == torch.bfloat16
    assert cp["layers"][0]["mlp"]["gate"]["kernel"].dtype == torch.bfloat16
    assert cp["layers"][0]["pre_norm"]["norm_scale"].dtype == torch.float32
    assert cp["final_norm"]["norm_scale"].dtype == torch.float32


def test_entry_points_without_a_device_refuse_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tregistry.get_smoke("qwen3-1.7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tT.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tT.init_cache(cfg, 2, 8)
