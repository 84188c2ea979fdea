#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` into ``build/``;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, and fails on any tolerance miss: the multi-tensor
   LARS step over all 161 ResNet-50 leaves (LARS and skip, nesterov off
   and on), ``ls_xent`` forward and backward in fp32 and bf16 at the
   ResNet-50 head's shapes, at Qwen3-1.7B's (4096, 151936) logits and at
   rows that start off a 16-byte boundary, and flash attention at nine
   shapes, bf16 through the bf16 tensor-core kernel and fp32 through the
   3xTF32 one (the wrapper picks by dtype), each under
   ``kernels/ref.py::flash_attention_tol``;
4. times each kernel beside its bound (the larger of bytes over the HBM
   rate and operations over the peak for the inputs' type; fp32 flash:
   three TF32 products, with the fp32 FMA bound beside it), its plain
   version and, where one exists, the single PyTorch call computing the
   same function; LARS as the whole ``core/lars.update`` of one step;
   ``ls_xent`` through ``repro_torch.launch.profile_xent`` at
   (32 | 64, 1000) fp32 and (4096, 151936) fp32 and bf16; flash through
   ``repro_torch.launch.profile_flash``, the fp32 kernel at the smoke
   config's shape and at the Qwen3-1.7B prefill shape;
5. initialises an NCCL process group of one rank (a ``dist.FileStore`` in a
   temporary directory), builds the 1 x 1 torus grid on it, and checks that
   ``reduce_scatter_tensor``, ``all_reduce`` and ``all_gather_into_tensor``
   on the card, in fp32 and bf16, return their input (the strategies skip
   groups of one, so this is where NCCL itself runs);
6. trains full-width ResNet-50 at 224 px through ``Trainer.run`` on that
   grid over a two-stage batch-size plan (32 then 64 images a step), with
   the gradient sync of ``repro_torch.launch.profile_step.SYNC`` (torus2d,
   bf16 buckets of 4 MiB: 11 exchanges, whose layout it prints and checks),
   and fails on a non-finite loss, a skipped step, a kernel the run did not
   launch, or LARS launched other than twice a step; then prints the ms and
   kernel launches that ``sync_tree`` takes a step, and the launches of a
   whole step with and without them;
7. serves full-width Qwen3-1.7B (random weights from seed 0) through
   ``RequestBatcher`` and ``generate`` at the serve shape of
   ``repro_torch.launch.profile_serve``: 8 prompts of 512-2048 tokens,
   left-padded to 2048, 32 new tokens each, greedy; fails on a non-finite
   logit, on a prefill that does not launch the tensor-core flash kernel
   once a layer (28) or on a decode step that launches it at all;
8. runs a tiny ResNet two steps (fp32 comm), and the Qwen3 and Gemma2
   smoke configs (fp32, so the fp32 flash kernel) through ``generate``, on
   the card and on the CPU from the same weights and inputs, and fails if
   they disagree; the tiny card run must also equal, bit for bit, the same
   run with ``sync_tree`` taken out (at one rank the fp32 sync multiplies by
   1.0 and exchanges nothing);
9. destroys the process group, and prints one ``{"kernels": [...]}``
   line, the card line again, and as the last line ``{"ok": true,
   "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent or the port is not
beside this file. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SMOOTHING = 0.1
LARS_KW = dict(lr=2.0, mom=0.9, eta=0.01, weight_decay=5e-5, eps=1e-6)
# kernel vs plain version on the same inputs; both compute in fp32, so the
# differences are summation order and fused multiply-adds
LARS_ATOL = 1e-6
XENT_FWD_TOL = (1e-4, 1e-5)        # (atol, rtol) on the per-row loss and lse
# kernels/ref.py::ls_xent_bwd_tol, elementwise on dlogits: rtol fp32 1e-5,
# bf16 2^-7 (one bf16 rounding step), atol 1e-6 cut in each row to 2^-10 of
# |gout| a/V, the size of most of a long row's gradients
XENT_BWD_TOL = "min(1e-6, 2^-10 |gout| a/V) + fp32 1e-5|ref|, bf16 2^-7|ref|"
# tiny ResNet, fp32, card vs host: cuDNN and the CPU sum convolutions in
# different orders, and two LARS steps carry that difference forward
TINY_TOL = 1e-3
# flash kernels vs their plain version on the same inputs, elementwise:
# kernels/ref.py::flash_attention_tol. fp32: 1e-5 + 1e-5|ref| of the exact
# answer (the plain version in fp64); bf16: 1e-5 + 2^-7|ref| + 2^-8 (P.|v|),
# the output's rounding plus one bf16 rounding of each probability before
# P.V on the tensor cores
FLASH_TOL = "fp32 1e-5 + 1e-5|exact|; bf16 1e-5 + 2^-7|ref| + 2^-8 P.|v|"
# smoke transformers, fp32 compute, card vs host: matmuls and the attention
# sum in different orders; two layers keep that near fp32 noise
SMOKE_LOGIT_TOL = 1e-4           # abs and relative, on prefill logits


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check_flash(torch, dev, gen) -> dict:
    """Both flash kernels against their plain version at the serve path's
    shapes and the kernels' other features (fp32: the plain version in
    fp64, the exact answer); returns the max abs error and
    the worst err/tol by dtype (bf16: the bf16 kernel, fp32: the 3xTF32
    kernel)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attn import flash_attention_f32, flash_attention_tc

    cases = [  # (B, S, Skv, H, Hkv, D, dtype, causal, window, softcap)
        (8, 2048, 2048, 16, 8, 128, torch.bfloat16, True, None, None),  # Qwen3 prefill
        (2, 1024, 1024, 8, 4, 64, torch.bfloat16, True, None, None),
        (2, 1024, 1024, 8, 4, 256, torch.bfloat16, True, None, None),
        (2, 1024, 1024, 16, 8, 128, torch.bfloat16, True, 256, 50.0),
        (2, 1000, 1000, 16, 8, 128, torch.bfloat16, True, None, None),
        (2, 1000, 1000, 16, 8, 128, torch.bfloat16, False, None, None),
        (2, 1024, 1024, 16, 8, 128, torch.float32, True, None, None),
        (2, 1000, 1000, 16, 8, 128, torch.float32, False, 300, 30.0),
        (4, 48, 48, 4, 2, 32, torch.float32, True, 16, 50.0),            # smoke configs
    ]
    wrapper = {torch.bfloat16: flash_attention_tc, torch.float32: flash_attention_f32}
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_ratio = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for b, sq, skv, h, hkv, d, dtype, causal, window, softcap in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, skv, hkv, d, generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, softcap=softcap)
        before = wrapper[dtype].launches
        got = ops.flash_attention(q, k, v, **kw).double()
        if dtype == torch.float32:   # the exact answer; see flash_attention_tol
            want = ref.flash_attention_ref(q.double(), k.double(), v.double(), **kw)
            plain = ref.flash_attention_ref(q, k, v, **kw).double()
        else:
            want, plain = ref.flash_attention_ref(q, k, v, **kw).double(), None
        torch.cuda.synchronize()
        if wrapper[dtype].launches != before + 1:
            fail(f"ops.flash_attention did not launch {wrapper[dtype].__name__} on the card")
        err = (got - want).abs()
        bound = ref.flash_attention_tol(q, k, v, want, **kw)
        e, ratio = err.max().item(), (err / bound).max().item()
        worst[dtype] = max(worst[dtype], e)
        worst_ratio[dtype] = max(worst_ratio[dtype], ratio)
        also = (f"; the fp32 plain version's own {((plain - want).abs() / bound).max().item():.3f}"
                if dtype == torch.float32 else "")
        print(f"check flash_attn B{b} S{sq} Skv{skv} H{h}/{hkv} D{d} {str(dtype)[6:]} "
              f"causal={causal} window={window} softcap={softcap}: max_abs_err {e:.3e}, "
              f"worst err/tol {ratio:.3f} ({wrapper[dtype].__name__}){also}")
        if not bool((err <= bound).all()):
            fail(f"flash_attn disagrees with flash_attention_ref at B{b} S{sq} D{d} {dtype}")
        del q, k, v, got, want, plain, err, bound
    print(f"check flash_attn: max_abs_err bf16 {worst[torch.bfloat16]:.3e}, fp32 "
          f"{worst[torch.float32]:.3e}; worst err/tol bf16 {worst_ratio[torch.bfloat16]:.3f}, "
          f"fp32 {worst_ratio[torch.float32]:.3f} (tol {FLASH_TOL})")
    return {"bf16": (worst[torch.bfloat16], worst_ratio[torch.bfloat16]),
            "fp32": (worst[torch.float32], worst_ratio[torch.float32])}


def time_flash(torch, gen) -> dict:
    """Both flash kernels through ``repro_torch.launch.profile_flash``: the
    bf16 kernel at the Qwen3-1.7B prefill shape, the fp32 kernel at the
    Qwen3 smoke config's shape (its main path) and, under "prefill", at the
    Qwen3-1.7B prefill shape in fp32; each beside its plain version, SDPA
    and its bound (fp32: 3xTF32, with the fp32 FMA bound beside it)."""
    from repro_torch.launch import profile_flash

    out, prefill = {}, None
    for name, shape, dtype, what in profile_flash.SHAPES:
        t = profile_flash.time_flash(name, shape, dtype, what, gen)
        print(f"time {name} ({t['at']}): {t}")
        if dtype == torch.float32 and shape == profile_flash.QWEN:
            prefill = t
        else:
            out[name] = t
    out["flash_attn_f32"]["prefill"] = {k: prefill[k] for k in (
        "ms", "eager_ms", "bound_ms", "fma_bound_ms", "plain_ms", "library_ms",
        "tflops_per_s", "worst_err_over_tol", "at")}
    return out


def serve_qwen3(torch, dev) -> dict:
    """The serve path at full width: RequestBatcher + generate, then the
    same work split into prefill and decode steps to time each."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import NEW, PROMPT_LENS, SEQ
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode

    cfg = registry.get("qwen3-1.7b")
    t0 = time.perf_counter()
    model = T.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"qwen3-1.7b: {n_params} parameters ({cfg.num_params()} without norms), "
          f"init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    batcher = decode.RequestBatcher(batch_size=len(prompts), seq_len=SEQ)
    toks, lens, n_real = batcher.pack(prompts, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = decode.generate(model, toks, cfg, max_new_tokens=NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    results = batcher.unpack(out, n_real)
    print(f"serve: generate {n_real} x {NEW} tokens in {1e3 * gen_s:.2f} ms "
          f"({n_real * NEW / gen_s:.1f} generated tokens/s), launches {counts}, "
          f"peak device memory {peak / 2**30:.2f} GiB")
    want = {"lars_update": 0, "ls_xent_fwd": 0, "ls_xent_bwd": 0,
            "flash_attn": cfg.n_layers, "flash_attn_f32": 0}
    if counts != want:
        fail(f"generate launched {counts}, want {want}")
    if len(results) != len(prompts) or any(len(r) != NEW for r in results):
        fail("generate returned the wrong shape")
    if not all(0 <= x < cfg.vocab for r in results for x in r):
        fail("generate returned a token outside the vocab")

    # the same work, phase by phase, as generate runs it
    with torch.inference_mode():
        params = T.compute_params(model, cfg.compute_dtype)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, toks, cfg, cache_len=SEQ + NEW)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        prefill_counts = ops.launch_counts()
        finite = torch.isfinite(logits).all()
        step = decode.make_serve_step(cfg)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks_out = [tok]
        ops.reset_launch_counts()
        step_ms = []
        for t in range(1, NEW):
            t0 = time.perf_counter()
            tok, logits, cache = step(params, tok, cache, SEQ + t - 1)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            finite &= torch.isfinite(logits).all()
            toks_out.append(tok)
        decode_counts = ops.launch_counts()
    print(f"serve: prefill {len(prompts)} x {SEQ} tokens {prefill_ms:.2f} ms, "
          f"flash launches {prefill_counts['flash_attn']}; decode step ms median "
          f"{statistics.median(step_ms):.3f} (first {step_ms[0]:.3f}, max "
          f"{max(step_ms):.3f}) over {len(step_ms)} steps, flash launches "
          f"{decode_counts['flash_attn']}")
    if prefill_counts["flash_attn"] != cfg.n_layers:
        fail(f"prefill launched flash_attn {prefill_counts['flash_attn']} times, "
             f"want {cfg.n_layers}")
    if any(decode_counts.values()):
        fail(f"decode launched {decode_counts}, want no kernel")
    if not bool(finite):
        fail("non-finite logits in prefill or decode")
    if not torch.equal(torch.cat(toks_out, dim=1), out):
        fail("prefill + serve steps and generate picked different tokens")
    return {"counts": counts, "generate_ms": 1e3 * gen_s, "prefill_ms": prefill_ms,
            "decode_ms": statistics.median(step_ms),
            "tokens_per_s": n_real * NEW / gen_s, "peak_gib": peak / 2**30}


def smoke_card_vs_host(torch) -> int:
    """Qwen3 and Gemma2 smoke configs, fp32 compute, the same weights and
    prompts on the card and on the host: tokens equal, logits close.
    Returns the fp32 flash kernel's launches in the card's prefills."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode

    card_launches = 0
    for arch in ("qwen3-1.7b", "gemma2-27b"):
        cfg = dataclasses.replace(registry.get_smoke(arch), compute_dtype=torch.float32)
        host = T.init(cfg, seed=1, device="cpu")
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():      # non-zero norm scales, so every norm shows
            for name, p in host.named_parameters():
                if "norm_scale" in name:
                    p.normal_(0.0, 0.3, generator=g)
        card = T.init(cfg, seed=1, device="cuda")
        card.load_state_dict(host.state_dict())
        rng = np.random.RandomState(3)
        prompts = [rng.randint(1, cfg.vocab, n).tolist() for n in (48, 40, 29, 17)]
        batcher = decode.RequestBatcher(batch_size=4, seq_len=48)
        got = {}
        for dev, model in (("cpu", host), ("cuda", card)):
            toks, _, n = batcher.pack(prompts, device=dev)
            ops.reset_launch_counts()
            with torch.inference_mode():
                logits, _ = T.prefill(model, toks, cfg, cache_len=56)
            launches = ops.launch_counts()["flash_attn_f32"]   # fp32 compute
            out = decode.generate(model, toks, cfg, max_new_tokens=8)
            got[dev] = (logits.cpu(), batcher.unpack(out.cpu(), n), launches)
        err = (got["cuda"][0] - got["cpu"][0]).abs()
        ok = bool((err <= SMOKE_LOGIT_TOL * (1 + got["cpu"][0].abs())).all())
        print(f"{arch} smoke fp32, card vs host: prefill logits max_abs_err "
              f"{err.max().item():.3e} (tol {SMOKE_LOGIT_TOL:g} (1 + |host|)), tokens "
              f"{'equal' if got['cuda'][1] == got['cpu'][1] else 'DIFFER'}, flash "
              f"launches card {got['cuda'][2]} host {got['cpu'][2]}")
        if not ok or got["cuda"][1] != got["cpu"][1]:
            fail(f"{arch} smoke: the card disagrees with the host")
        if got["cuda"][2] != cfg.n_layers or got["cpu"][2] != 0:
            fail(f"{arch} smoke: flash launches card {got['cuda'][2]}, host {got['cpu'][2]}")
        card_launches += got["cuda"][2]
    return card_launches


def nccl_one_rank(torch, dev, store_dir: str):
    """An NCCL process group of one rank and the 1 x 1 grid on it; the three
    collectives of the strategies' xla lowering, on the card, must each
    return their input."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import topology

    store = dist.FileStore(str(Path(store_dir) / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    grid = topology.select_grid((1,)).build()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1 << 20, device=dev).to(dtype)
        rs, ag, ar = torch.empty_like(x), torch.empty_like(x), x.clone()
        dist.reduce_scatter_tensor(rs, x.clone())
        dist.all_reduce(ar)
        dist.all_gather_into_tensor(ag, x)
        torch.cuda.synchronize()
        if not (torch.equal(rs, x) and torch.equal(ar, x) and torch.equal(ag, x)):
            fail(f"NCCL at one rank changed a {dtype} tensor")
    print(f"nccl: world {dist.get_world_size()}, backend {dist.get_backend()}, grid "
          f"{grid.y}x{grid.x} on {grid.device}: reduce_scatter_tensor, all_reduce, "
          f"all_gather_into_tensor return their input in fp32 and bf16")
    return grid


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as store_dir:
        try:
            return run(torch, store_dir)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


def run(torch, store_dir: str) -> int:
    from repro_torch.core import grad_sync, lars, losses
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    from repro_torch.core.topology import TorusGrid
    from repro_torch.data import augment
    from repro_torch.data.synthetic import SyntheticImageNet, generator
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.lars_update import lars_update_cuda
    from repro_torch.kernels.ls_xent import ls_xent_bwd_cuda, ls_xent_fwd_cuda
    from repro_torch.launch import profile_step, profile_xent
    from repro_torch.launch.timing import FP32_FLOPS_PER_S, bound, eager_ms, graph_ms
    from repro_torch.models import resnet
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig, make_train_step

    card = gpu_line()
    print(f"gpu: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul off, cudnn off (fp32 comparisons run in full fp32)")
    dev = torch.device("cuda")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = not build.library_path().exists()
    build.library()
    print(f"build: {'built' if built else 'loaded'} {build.library_path().name} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(shape, scale, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    # -- the main path's shapes ---------------------------------------------
    cfg = resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224)
    model = resnet.init(cfg, seed=0)
    n_params = resnet.num_params(model)
    lcfg = lars.LARSConfig()
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    is_lars = [not lars.is_skip(n, lcfg) for n, _ in named]
    print(f"resnet50: {n_params} params, {len(named)} leaves, {sum(is_lars)} of them LARS")
    if sum(is_lars) != 54 or len(named) != 161:
        fail(f"expected 161 leaves, 54 of them LARS; found {len(named)}, {sum(is_lars)}")

    # -- kernels vs plain versions -------------------------------------------
    leaves = [(randn(s, 0.05), randn(s, 0.01), randn(s, 1e-3)) for _, s in named]
    ps, gs, vs = (list(t) for t in zip(*leaves))
    lars_err = 0.0
    for nesterov in (False, True):
        before = lars_update_cuda.launches
        got = ops.lars_update_leaves(ps, gs, vs, is_lars, **LARS_KW, nesterov=nesterov)
        if lars_update_cuda.launches != before + 2:
            fail("the multi-tensor LARS step did not take two launches")
        want = ref.lars_update_leaves_ref(ps, gs, vs, is_lars, **LARS_KW, nesterov=nesterov)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            lars_err = max(lars_err, (a - b).abs().max().item())
    print(f"check lars_update: all 161 leaves (54 LARS, 107 skip) in one call x "
          f"nesterov off/on, max_abs_err {lars_err:.3e} (tol {LARS_ATOL:g})")
    if not lars_err <= LARS_ATOL:
        fail("lars_update disagrees with lars_update_leaves_ref")

    # the ResNet-50 head at both batch stages, Qwen3-1.7B's logits for 2 x 2048
    # tokens, and rows that start off a 16-byte boundary (V odd in bf16)
    xent_cases = [(32, 1000), (64, 1000), (256, 32768), (4096, 151936), (16, 32003)]
    fwd_err = bwd_err = bwd_ratio = 0.0
    for rows, vocab in xent_cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn((rows, vocab), 4.0, dtype)
            y = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
            y[0], y[-1] = 0, vocab - 1     # the first column and the scalar tail's last
            gout = torch.rand(rows, generator=gen, device=dev) / rows
            loss_k, lse_k = ls_xent_fwd_cuda(x, y, SMOOTHING)
            loss_r, lse_r = ref.ls_xent_fwd_ref(x, y, SMOOTHING)
            atol, rtol = XENT_FWD_TOL
            for got, want in ((loss_k, loss_r), (lse_k, lse_r)):
                err = (got - want).abs()
                fwd_err = max(fwd_err, err.max().item())
                if not bool((err <= atol + rtol * want.abs()).all()):
                    fail(f"ls_xent_fwd {rows}x{vocab} {dtype}: max_abs_err "
                         f"{err.max().item():.3e}")
            d_k = ls_xent_bwd_cuda(x, y, lse_r, gout, SMOOTHING).float()
            d_r = ref.ls_xent_bwd_ref(x, y, lse_r, gout, SMOOTHING)
            tol = ref.ls_xent_bwd_tol(d_r, gout, SMOOTHING)
            err = (d_k - d_r.float()).abs()
            ratio = torch.where(err > 0, err / tol, 0.0).max().item()
            bwd_err, bwd_ratio = max(bwd_err, err.max().item()), max(bwd_ratio, ratio)
            if not bool((err <= tol).all()):
                fail(f"ls_xent_bwd {rows}x{vocab} {dtype}: {int((err > tol).sum())} "
                     f"gradients off, max_abs_err {err.max().item():.3e}, worst "
                     f"err/tol {ratio:.3g}")
            print(f"check ls_xent {rows}x{vocab} {str(dtype)[6:]}: fwd err "
                  f"{(loss_k - loss_r).abs().max().item():.3e}, bwd err "
                  f"{err.max().item():.3e} (worst err/tol {ratio:.3g}; row 0's median "
                  f"|ref| {d_r[0].float().abs().median().item():.3e})")
            del x, y, gout, loss_k, lse_k, loss_r, lse_r, d_k, d_r, tol, err
    print(f"check ls_xent: fwd max_abs_err {fwd_err:.3e} (tol {XENT_FWD_TOL[0]:g} "
          f"+ {XENT_FWD_TOL[1]:g}|ref|), bwd max_abs_err {bwd_err:.3e}, worst "
          f"err/tol {bwd_ratio:.3g} (tol {XENT_BWD_TOL})")

    flash_err = check_flash(torch, dev, gen)

    # -- timing at the main path's shapes ------------------------------------
    lars_elems = sum(p.numel() for p in ps)
    opt_state = {"momentum": {n: v for (n, _), v in zip(named, vs)}}
    lars_params = {n: p for (n, _), p in zip(named, ps)}
    lars_grads = {n: g for (n, _), g in zip(named, gs)}

    def lars_step():
        lars.update(lars_params, lars_grads, opt_state, lr=LARS_KW["lr"],
                    momentum=LARS_KW["mom"], cfg=lcfg)

    def lars_plain():
        ref.lars_update_leaves_ref(ps, gs, vs, is_lars, **LARS_KW)

    timing = {"lars_update": {
        "ms": graph_ms(lars_step, iters=4),
        "eager_ms": eager_ms(lars_step, iters=10),
        "plain_ms": graph_ms(lars_plain, iters=4),
        "library_ms": None,
        "bytes": 20 * lars_elems,     # p, g, v in; p', v' out
        "flops": 6 * lars_elems,      # v' = mom*v + tl*(g + wd*p); p - v'
        "at": f"one core/lars.update of ResNet-50: all 161 leaves (54 LARS, 107 skip), "
              f"{lars_elems} fp32 elements",
    }}
    print(f"time lars_update ({timing['lars_update']['at']}): {timing['lars_update']}")

    # ls_xent at the ResNet-50 head's shapes and at Qwen3-1.7B's logits
    xent_times = {}
    for rows, vocab, dtype, what in profile_xent.SHAPES:
        xent_times[rows, vocab, dtype] = profile_xent.time_xent(rows, vocab, dtype, gen)
        for name, t in xent_times[rows, vocab, dtype].items():
            print(f"time {name} ({what}): {t}")

    flash_time = time_flash(torch, gen)

    # -- NCCL at one rank, and the grid the main path syncs over -------------
    grid = nccl_one_rank(torch, dev, store_dir)

    # -- the main path: full-width ResNet-50 over two batch stages ------------
    data = SyntheticImageNet(num_classes=1000, image_size=224, seed=0, device=dev)

    def data_fn(i, gb):
        images, labels = data.batch(i, gb)
        return augment.augment(generator(dev, 1, i), images, (224, 224)), labels

    def loss_fn(params, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=params, grid=grid)
        return (losses.label_smoothing_xent(logits, labels, SMOOTHING),
                torch.zeros((), device=dev))

    sync = profile_step.SYNC
    layout = grad_sync.bucket_layout(dict(model.named_parameters()), sync)
    sizes = {g: [b["nbytes"] for b in layout if b["group"] == g] for g in ("comm", "fp32")}
    print(f"grad sync: {sync.strategy} ({sync.lowering}), {len(layout)} exchanges, "
          f"bf16 {len(sizes['comm'])} buckets {sum(sizes['comm'])} B, fp32 "
          f"{len(sizes['fp32'])} {sum(sizes['fp32'])} B; first bucket "
          f"{layout[0]['paths'][:3]}")
    if (len(layout), sum(sizes["comm"]), sum(sizes["fp32"])) != (11, 51_005_824, 216_480):
        fail("the ResNet-50 bucket layout is not 11 exchanges of 51,005,824 + 216,480 B")

    sched = BatchSchedule((BatchStage(0, 1, 32), BatchStage(1, 2, 64)))
    plan = build_plan(sched, dataset_size=256, n_workers=1, max_steps=12)
    print("plan: " + ", ".join(f"{s.num_steps} steps at {s.global_batch}"
                               for s in plan.stages))
    tcfg = TrainerConfig(schedule="B", log_every=1, grad_sync=sync)
    trainer = Trainer(loss_fn=loss_fn, cfg=tcfg, plan=plan, data_fn=data_fn, grid=grid)
    state = TrainState.create(dict(model.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, history = trainer.run(state)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    steps = len(history)
    for r in history:
        print(f"  step {r['step']:3d} gb {r['global_batch']:3d} loss {r['loss']:.5f} "
              f"lr {r['lr']:.5f} momentum {r['momentum']:.4f} skipped {r['skipped']} "
              f"grad_norm {r['grad_norm']:.4f} step_ms {1e3 * r['wall_s']:.2f}")
    print(f"launches on the main path: {counts} over {steps} steps")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if steps != plan.total_steps or state.step != plan.total_steps:
        fail(f"ran {steps} steps, plan has {plan.total_steps}")
    for row in history:
        if not (row["loss"] == row["loss"] and abs(row["loss"]) < float("inf")):
            fail(f"non-finite loss at step {row['step']}")
        if row["skipped"]:
            fail(f"step {row['step']} was skipped by the guard")
    want = {"lars_update": 2 * steps, "ls_xent_fwd": steps, "ls_xent_bwd": steps,
            "flash_attn": 0, "flash_attn_f32": 0}
    if counts != want:
        fail(f"launch counts {counts}, want {want}")
    for s in plan.stages:
        walls = [r["wall_s"] for r in history
                 if s.first_step < r["step"] <= s.first_step + s.num_steps]
        print(f"stage gb {s.global_batch}: step ms {[round(1e3 * w, 2) for w in walls]}, "
              f"steady median (first step excluded) "
              f"{1e3 * statistics.median(walls[1:]):.2f} ms")

    # the sync's share of a step at 64 images, and the step's launches
    gb = plan.stages[-1].global_batch
    batch = data_fn(0, gb)
    step = make_train_step(loss_fn, tcfg, grid)
    holder = {"state": state}

    def one_step():
        holder["state"], m = step(holder["state"], batch, 1.0, gb)

    grads = {k: 1e-3 * torch.randn_like(p) for k, p in state.params.items()}
    sync_t = profile_step.sync_split(grads, grid, sync)
    step_launches = profile_step.kernel_launches(one_step)
    print(f"sync_tree a step (host clock between synchronises, median of "
          f"{len(sync_t['wall_ms_runs'])}): {sync_t['wall_ms']:.3f} ms, "
          f"{sync_t['launches']} kernel launches; launches a step at {gb} images: "
          f"{step_launches} with the sync, {step_launches - sync_t['launches']} without it")
    ops.reset_launch_counts()

    # -- the serve path: full-width Qwen3-1.7B --------------------------------
    serve = serve_qwen3(torch, dev)

    # -- small input: the card's path against the host's ----------------------
    tiny = resnet.ResNetConfig.tiny(compute_dtype=torch.float32)
    tmodel = {d: resnet.init(tiny, seed=3, device=d) for d in ("cpu", "cuda")}
    tmodel["cuda"].load_state_dict(tmodel["cpu"].state_dict())
    tdata = SyntheticImageNet(num_classes=10, image_size=32, seed=2, device="cpu")
    tplan = build_plan(BatchSchedule((BatchStage(0, 1, 8),)), dataset_size=16,
                       n_workers=1)
    tcfg = TrainerConfig(log_every=1,
                         grad_sync=grad_sync.GradSyncConfig(comm_dtype=torch.float32))

    def tiny_run(d):
        m = tmodel[d]

        def tloss(params, batch, grid):
            return (losses.label_smoothing_xent(
                resnet.apply(m, batch[0], params=params, grid=grid), batch[1], SMOOTHING),
                torch.zeros((), device=batch[0].device))
        tr = Trainer(loss_fn=tloss, cfg=tcfg, plan=tplan,
                     data_fn=lambda i, gb: tuple(t.to(d) for t in tdata.batch(i, gb)),
                     grid=grid if d == "cuda" else TorusGrid())
        st, hist = tr.run(TrainState.create(dict(m.named_parameters())), log=lambda s: None)
        return st.params, [h["loss"] for h in hist]

    finals, tlosses = {}, {}
    for d in ("cpu", "cuda"):
        finals[d], tlosses[d] = tiny_run(d)
    p_err = max((finals["cuda"][k].cpu() - v).abs().max().item()
                for k, v in finals["cpu"].items())
    l_err = max(abs(a - b) / max(abs(b), 1.0)
                for a, b in zip(tlosses["cuda"], tlosses["cpu"]))
    print(f"tiny resnet fp32, 2 steps, card vs host: loss rel err {l_err:.3e}, "
          f"params max_abs_err {p_err:.3e} (tol {TINY_TOL:g})")
    if not (l_err <= TINY_TOL and p_err <= TINY_TOL):
        fail("tiny ResNet on the card disagrees with the host")
    # at one rank the fp32 sync is the identity: the run equals, bit for
    # bit, the same run with sync_tree taken out
    with unittest.mock.patch.object(grad_sync, "sync_tree", lambda g, grid, cfg: g):
        unsynced, unsynced_losses = tiny_run("cuda")
    same = (unsynced_losses == tlosses["cuda"]
            and all(torch.equal(unsynced[k], v) for k, v in finals["cuda"].items()))
    print(f"tiny resnet on the card through sync_tree (fp32 comm, 1 rank) vs without it: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the fp32 sync at one rank changed the tiny ResNet's run")
    f32_launches = smoke_card_vs_host(torch)

    # -- report ---------------------------------------------------------------
    sources = {
        "lars_update": ("cuda", "src/repro_torch/csrc/lars_update.cu",
                        "src/repro/kernels/lars_update.py:22", lars_err),
        "ls_xent_fwd": ("cuda", "src/repro_torch/csrc/ls_xent.cu",
                        "src/repro/kernels/ls_xent.py:27", fwd_err),
        "ls_xent_bwd": ("cuda", "src/repro_torch/csrc/ls_xent.cu",
                        "src/repro/kernels/ls_xent.py:27", bwd_err),
        "flash_attn": ("cuda", "src/repro_torch/csrc/flash_attn_tc.cu",
                       "src/repro/kernels/flash_attn.py:34", flash_err["bf16"][0]),
        "flash_attn_f32": ("cuda", "src/repro_torch/csrc/flash_attn.cu",
                           "src/repro/kernels/flash_attn.py:34", flash_err["fp32"][0]),
    }
    main_rows = plan.stages[-1].global_batch
    measured = {"lars_update": timing["lars_update"],
                **xent_times[main_rows, 1000, torch.float32], **flash_time}
    # ls_xent also at Qwen3-1.7B's logits, beside its main-path entry
    xent_lm = {}
    for (rows, vocab, dtype), pair in xent_times.items():
        if vocab != 1000:
            for name, t in pair.items():
                xent_lm.setdefault(name, {})[str(dtype)[6:]] = {
                    k: t[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                      "library_fwd_bwd_ms", "at") if k in t}
    # each kernel's launches on its own main path: ResNet training, serving
    # Qwen3-1.7B in bf16, or the fp32 smoke configs' prefills
    launches = {**counts, "flash_attn": serve["counts"]["flash_attn"],
                "flash_attn_f32": f32_launches}
    # the flash checks' worst err/tol over their shapes, by kernel
    check_ratio = {"flash_attn": flash_err["bf16"][1], "flash_attn_f32": flash_err["fp32"][1]}
    kernels = []
    for name, (route, src, replaces, err) in sources.items():
        t = measured[name]
        # flash: profile_flash's bound for the inputs' type (fp32: 3xTF32)
        bound_ms, bound_by = ((t["bound_ms"], t["bound_by"]) if "bound_ms" in t
                              else bound(t["bytes"], t["flops"], FP32_FLOPS_PER_S))
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            **{k: t[k] for k in ("fma_bound_ms", "tflops_per_s", "library_fwd_bwd_ms",
                                 "prefill") if k in t},
            **({"lm": xent_lm[name]} if name in xent_lm else {}),
            **({"worst_err_over_tol": check_ratio[name]} if name in check_ratio else {}),
            "rate": t.get("rate", "fp32 67 TFLOP/s, HBM 3.35 TB/s"),
            "at": t["at"],
        })
    print(json.dumps({"serve": {k: v for k, v in serve.items() if k != "counts"}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
