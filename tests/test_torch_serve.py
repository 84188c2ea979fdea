"""The port's serving path against the JAX package's, on the CPU.

``generate`` runs prefill (the flash kernel's plain version here) and then
decode steps over the KV cache. In fp32 compute both packages pick the same
greedy tokens; in bf16 an argmax tie could go either way, so tokens are
compared in fp32 and logits within a tolerance in
tests/test_torch_transformer.py. Prompts are longer than gemma2's window of
16, so its local layer decodes from the rolled cache. The MoE archs decode
at T = B tokens a step, so their capacity is small (2 for B = 2, k = 2,
E = 4) and pairs drop as in the reference; mamba2 decodes from its SSD
state, recurrentgemma from its RG-LRU states and the rolled cache of its
local layer, and the VLM from its cross layer's vision cache (both
packages take the same fp32 ``vision``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import decode as jdecode
from repro_torch.serve import decode as tdecode
from test_torch_transformer import ARCHS, pair, tokens, vision


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_equal_jax_in_fp32(arch):
    jp, jcfg, tp, tcfg = pair(arch, "float32")
    ids = tokens(5)
    jv, tv = vision(tcfg)
    want = jdecode.generate(jp, jnp.asarray(ids), jcfg, max_new_tokens=6, vision=jv)
    got = tdecode.generate(tp, torch.from_numpy(ids), tcfg, max_new_tokens=6, vision=tv)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_step_matches_decode_argmax():
    _, _, tp, tcfg = pair("gemma2-27b", "float32")
    from repro_torch.models import transformer as tT
    ids = torch.from_numpy(tokens(6))
    logits, cache = tT.prefill(tp, ids, tcfg, cache_len=42)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    nxt, lg, cache = tdecode.make_serve_step(tcfg)(tp, tok, cache, 40)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    torch.testing.assert_close(nxt[:, 0], torch.argmax(lg[:, -1], -1).to(torch.int32))


def test_generate_bf16_is_finite_and_in_vocab():
    _, _, tp, tcfg = pair("qwen3-1.7b", "bfloat16")
    out = tdecode.generate(tp, torch.from_numpy(tokens(7)), tcfg, max_new_tokens=5)
    assert out.shape == (2, 5)
    assert int(out.min()) >= 0 and int(out.max()) < tcfg.vocab


def test_temperature_sampling_follows_the_generator():
    _, _, tp, tcfg = pair("qwen3-1.7b", "float32")
    ids = torch.from_numpy(tokens(8))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return tdecode.generate(tp, ids, tcfg, max_new_tokens=8, temperature=1.0,
                                generator=g)
    a, b, c = draw(1), draw(1), draw(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab


@pytest.mark.parametrize("prompts", [
    [[1, 2, 3], [4, 5, 6, 7, 8, 9]],
    [[3] * 12, [], [7]],
    [],
])
def test_request_batcher_packs_and_unpacks_as_jax(prompts):
    jb = jdecode.RequestBatcher(batch_size=3, seq_len=8, pad_id=9)
    tb = tdecode.RequestBatcher(batch_size=3, seq_len=8, pad_id=9)
    jbuf, jlens, jn = jb.pack(prompts)
    tbuf, tlens, tn = tb.pack(prompts, device="cpu")
    assert tn == jn and tbuf.dtype == torch.int32
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    gen = np.arange(3 * 4, dtype=np.int32).reshape(3, 4)
    assert tb.unpack(torch.from_numpy(gen), tn) == [
        [int(x) for x in row] for row in jb.unpack(jnp.asarray(gen), jn)]


def test_request_batcher_refuses_too_many_prompts_and_no_card(monkeypatch):
    tb = tdecode.RequestBatcher(batch_size=1, seq_len=4)
    with pytest.raises(ValueError):
        tb.pack([[1], [2]], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.pack([[1]])


def test_batched_generate_serves_left_padded_requests():
    """The batcher's left-padded batch through generate, sliced back out: the
    JAX package does the same with no padding mask, so pad tokens are
    attended by both and the tokens agree in fp32."""
    jp, jcfg, tp, tcfg = pair("gemma2-27b", "float32")
    rng = np.random.RandomState(9)
    prompts = [list(rng.randint(1, 128, n)) for n in (30, 20, 5)]
    jb = jdecode.RequestBatcher(batch_size=4, seq_len=32)
    tb = tdecode.RequestBatcher(batch_size=4, seq_len=32)
    jbuf, _, n = jb.pack(prompts)
    tbuf, _, _ = tb.pack(prompts, device="cpu")
    want = jb.unpack(jdecode.generate(jp, jbuf, jcfg, max_new_tokens=4), n)
    got = tb.unpack(tdecode.generate(tp, tbuf, tcfg, max_new_tokens=4), n)
    assert got == [[int(x) for x in row] for row in want]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-2.7b"])
def test_batched_generate_left_padded_moe_and_ssd(arch):
    """As above for the MoE and SSD archs: the left pad tokens compete for
    expert capacity in the prefill, and run through the SSD scan, in both
    packages alike."""
    jp, jcfg, tp, tcfg = pair(arch, "float32")
    rng = np.random.RandomState(10)
    prompts = [list(rng.randint(1, 128, n)) for n in (30, 20, 5)]
    jb = jdecode.RequestBatcher(batch_size=4, seq_len=32)
    tb = tdecode.RequestBatcher(batch_size=4, seq_len=32)
    jbuf, _, n = jb.pack(prompts)
    tbuf, _, _ = tb.pack(prompts, device="cpu")
    want = jb.unpack(jdecode.generate(jp, jbuf, jcfg, max_new_tokens=4), n)
    got = tb.unpack(tdecode.generate(tp, tbuf, tcfg, max_new_tokens=4), n)
    assert got == [[int(x) for x in row] for row in want]


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "llama-3.2-vision-90b"])
def test_batched_generate_left_padded_rglru_and_vlm(arch):
    """As above for the RG-LRU hybrid (the pad tokens run through the scan
    and the local window) and the VLM (a vision input a request, the
    batch's fourth row, which has no prompt, included)."""
    jp, jcfg, tp, tcfg = pair(arch, "float32")
    rng = np.random.RandomState(12)
    prompts = [list(rng.randint(1, 128, n)) for n in (30, 20, 5)]
    jv, tv = vision(tcfg, b=4)
    jb = jdecode.RequestBatcher(batch_size=4, seq_len=32)
    tb = tdecode.RequestBatcher(batch_size=4, seq_len=32)
    jbuf, _, n = jb.pack(prompts)
    tbuf, _, _ = tb.pack(prompts, device="cpu")
    want = jb.unpack(jdecode.generate(jp, jbuf, jcfg, max_new_tokens=4, vision=jv), n)
    got = tb.unpack(tdecode.generate(tp, tbuf, tcfg, max_new_tokens=4, vision=tv), n)
    assert got == [[int(x) for x in row] for row in want]


def test_generate_bf16_vlm_reads_its_vision():
    """bf16 compute, bf16 cache: another vision input gives other tokens,
    so the cross layer's prefilled cache reaches decode."""
    _, _, tp, tcfg = pair("llama-3.2-vision-90b", "bfloat16")
    ids = torch.from_numpy(tokens(13))
    a = tdecode.generate(tp, ids, tcfg, max_new_tokens=6, vision=vision(tcfg, seed=1)[1])
    b = tdecode.generate(tp, ids, tcfg, max_new_tokens=6, vision=vision(tcfg, seed=1)[1])
    c = tdecode.generate(tp, ids, tcfg, max_new_tokens=6, vision=vision(tcfg, seed=2)[1])
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab


@pytest.mark.parametrize("kernel, cls", [
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>", "sort / scan"),
    ("void at::native::bitonicSortKVInPlace<...>", "sort / scan"),
    ("void at::native::tensor_kernel_scan_innermost_dim<float, ...>", "sort / scan"),
    ("void flash_tc_kernel<64, true>(...)", "port: flash_attn"),
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNN", "convolution / matmul"),
])
def test_profile_classes_split_the_moe_and_ssd_kernels(kernel, cls):
    """``profile_serve --arch`` splits the MoE routing's sorts and the SSD
    scan's cumulative sums into their own class."""
    from repro_torch.launch.profile_step import classify
    assert classify(kernel) == cls


def test_serve_config_cuts_the_vlm_to_one_pattern_cycle():
    """The served VLM: 5 of its 100 layers (4 self-attention, 1 cross),
    6,378,487,808 params; its vision input seeded, bf16, (B, 1601, 7680);
    every other arch served whole and given no vision input."""
    from repro_torch.configs import registry as tregistry
    from repro_torch.launch import profile_serve as ps
    cfg = ps.serve_config("llama-3.2-vision-90b")
    assert cfg.kinds() == ("attn",) * 4 + ("cross",)
    assert cfg.num_params() == 6_378_487_808
    assert ps.serve_config("recurrentgemma-9b") == tregistry.get("recurrentgemma-9b")
    v = ps.vision_input(cfg, 2, device="cpu")
    assert v.shape == (2, 1601, 7680) and v.dtype == torch.bfloat16
    assert torch.equal(v, ps.vision_input(cfg, 2, device="cpu"))
    assert not torch.equal(v, ps.vision_input(cfg, 2, device="cpu", seed=1))
    assert ps.vision_input(ps.serve_config("recurrentgemma-9b"), 2, device="cpu") is None


@pytest.mark.parametrize("shape, masks, flops", [
    ((8, 2048, 2048, 16, 8, 128), {"causal": True}, 137_506_062_336),
    ((8, 2048, 2048, 16, 1, 256), {"causal": True, "window": 2048}, 275_012_124_672),
    ((8, 2048, 2048, 64, 8, 128), {"causal": True}, 550_024_249_344),
    ((8, 2048, 1601, 64, 8, 128), {"causal": False}, 859_530_330_112),
    ((1, 6, 6, 1, 1, 1), {"causal": True, "window": 2}, 4 * 11),
])
def test_flash_bound_counts_the_pairs_the_masks_keep(shape, masks, flops):
    """``profile_flash``'s operation count, which the flash bounds rest on:
    4 D FLOP a (query, key) pair the masks keep, against a brute-force
    count of the mask."""
    from repro_torch.launch.profile_flash import kept_pairs
    b, s, skv, h, _, d = shape
    assert 4 * d * b * h * kept_pairs(s, skv, **masks) == flops
    qi, kj = torch.arange(s)[:, None], torch.arange(skv)[None, :]
    keep = (kj <= qi) if masks["causal"] else torch.ones(s, skv, dtype=torch.bool)
    if "window" in masks:
        keep &= kj > qi - masks["window"]
    assert kept_pairs(s, skv, **masks) == int(keep.sum())
