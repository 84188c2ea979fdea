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
   rows that start off a 16-byte boundary, and flash attention at twelve
   shapes (the Qwen3-1.7B and granite-moe-3b-a800m prefills among them, and
   the shapes of recurrentgemma-9b's and llama-3.2-vision-90b's prefills:
   D 256 with 16 query heads on one kv head under a band that skips, and
   unmasked over 1601 keys, a multiple of no tile), bf16 through the bf16
   tensor-core kernel and fp32 through the 3xTF32 one (the wrapper picks by
   dtype), each under ``kernels/ref.py::flash_attention_tol``; the BN
   kernels (``csrc/batchnorm.cu``) at every distinct BN of ResNet-50 at 256
   images in bf16 and of the tiny config in fp32
   (``repro_torch.launch.profile_bn.check``: the two sums within 2^-14 of
   their terms' magnitudes, every other output bit for bit, a second call
   the same bytes); the guard's kernels (``csrc/guard.cu``) at ResNet-50's
   161 leaves and Qwen3-1.7B's 310, the unscale and the commit on a clean
   step and with a NaN planted, bit for bit
   (``repro_torch.launch.profile_guard.check``); and the flash backward (``csrc/flash_attn_bwd.cu``, bf16;
   ``csrc/flash_attn_bwd_f32.cu``, fp32) in both dtypes against its plain
   version from the forward kernel's o and lse, under
   ``ref.flash_attention_bwd_tol``, at Qwen3-1.7B's training shape (4 x
   2048 tokens), Qwen3's and granite's prefill shapes (D 128, 64),
   recurrentgemma's local shape (D 256, one kv head, window 2048, bands
   skipped), the VLM's cross shape (Skv 1601, unmasked), a softcap of 50
   with q and k scaled x4, so that the logits reach the cap, and D 32 under
   a window of 128 (fp32 at batch 2, against the plain version in fp64),
   elementwise and on each output's norm; and calls the backward twice on
   the same inputs at the training shape, granite's and recurrentgemma's,
   in both dtypes, which must give the same bytes;
4. times each kernel beside its bound (the larger of bytes over the HBM
   rate and operations over the peak for the inputs' type; fp32 flash:
   three TF32 products, with the fp32 FMA bound beside it), its plain
   version and, where one exists, the single PyTorch call computing the
   same function; LARS as the whole ``core/lars.update`` of one step;
   ``ls_xent`` through ``repro_torch.launch.profile_xent`` at
   (32 | 64, 1000) fp32 and (4096, 151936) fp32 and bf16; the BN kernels
   over the 53 BNs of a ResNet-50 step at 256 images beside their two-pass
   bytes' bound, their plain versions, the earlier autograd chain and
   ``F.batch_norm`` (``profile_bn.time_call``); the guard's kernels at
   ResNet-50's and Qwen3-1.7B's leaves beside the unscale's byte bound, the
   plain version and ``torch._amp_foreach_non_finite_check_and_unscale_``
   (``profile_guard.time_tree``); flash through
   ``repro_torch.launch.profile_flash``, the fp32 kernel at the smoke
   config's shape and at the Qwen3-1.7B prefill shape, the bf16 kernel also
   at the other served archs' prefill shapes (``profile_flash.SERVE_SHAPES``),
   and the backward at the training shape (both dtypes), gemma-7b's (bf16,
   D 256) and the smoke config's (fp32), and in bf16 at the served shapes,
   beside SDPA's backward;
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
   kernel launches that ``sync_tree`` takes a step, the launches of a whole
   step with and without them, and the host time of the telemetry that
   ``Trainer.run`` records a step (its spans and metrics: the loop is the
   supervised one, with telemetry on, no checkpoint directory, no faults);
   then, on the same model, plan and sync, with cuDNN deterministic and
   not autotuning, drives the supervised trainer: a clean run with
   checkpoints every 4 steps and its metrics JSONL and Chrome trace; a
   chaos run (a transient data failure at step 2, the first checkpoint
   write crashed once, NaN batches at steps 5-7 under
   ``ElasticConfig(max_consecutive_nonfinite=3)``) that must recover once
   and end bit-identical to the clean run; a run stopped at step 6 and
   resumed, also bit-identical; a ``torch_profile`` window of 2 steps whose
   trace must name the LARS and ``ls_xent`` kernels; and times the
   checkpoint layer (snapshot to host, CRC32, sync save, the async writer's
   save, validate, restore on the card and on the host), failing unless a
   checkpoint written on the card restores on the host as it was;
7. serves five archs at full width (random weights from seed 0, bf16
   compute over fp32 masters, bf16 KV cache) through ``RequestBatcher``
   and ``generate`` at the serve shape of
   ``repro_torch.launch.profile_serve``: 8 prompts of 512-2048 tokens,
   left-padded to 2048, 32 new tokens each, greedy. Qwen3-1.7B (dense
   attention), granite-moe-3b-a800m (the MoE MLP in every layer),
   mamba2-2.7b (the SSD mixer, no attention), recurrentgemma-9b (26 RG-LRU
   layers and 12 local ones of window 2048, whose cache wraps on the first
   decode step) and llama-3.2-vision-90b at its served depth of 5 layers (4
   self-attention, 1 cross over a seeded (8, 1601, 7680) vision input); each
   fails on a non-finite logit, on a prefill that does not launch the
   tensor-core flash kernel once an attention or cross layer (28, 32, 0, 12,
   5) or on a decode step that launches it at all, and frees its model
   before the next;
8. trains full-width Qwen3-1.7B through ``repro_torch.launch.train.build``
   on the world-1 NCCL grid: 3 steps of 2 x 2048 tokens, then 3 of 4 x
   2048, schedule B, smoothing 0.1, torus2d ``fuse=False`` bf16 comm, LARS
   over the reference's 13 stacked leaves (310 port leaves); fails on a
   non-finite loss, a skipped step, or launches other than 28 flash
   forwards and 28 flash backwards, one ``ls_xent`` forward and backward
   and two LARS a step; prints each stage's step ms, tokens/s, the peak
   device memory and the sync's layout; then trains it again with
   ``remat`` (each layer recomputed in backward), 3 steps of 4 x 2048
   tokens and then 3 of ``LM_REMAT_MAX_BATCH`` x 2048, the largest batch
   up to which ``python -m repro_torch.launch.remat_batch`` found every
   batch to fit, each a
   plain stage of its own run (running out of memory fails the script),
   which must launch the flash forward twice an attention layer (once more
   in backward) and the rest as before, and prints step ms, tokens/s and
   peak device memory beside the run without ``remat``;
9. runs a tiny ResNet two steps (fp32 comm), and the smoke configs of all
   ten archs (fp32, so the fp32 flash kernel) through ``generate``, on the
   card and on the CPU from the same weights and inputs (the VLM's from one
   fp32 vision input), and fails if they disagree or if the card's prefill
   does not launch the flash kernel once an attention or cross layer; the
   tiny card run must
   also equal, bit for bit, the same run with ``sync_tree`` taken out (at
   one rank the fp32 sync multiplies by 1.0 and exchanges nothing); then
   one fp32 training step of each smoke config (``make_train_step`` with
   the launcher's loss and the stacked-leaf groups) on the card and the
   host from the same weights and batch, which must agree within
   ``SMOKE_STEP_TOL`` and launch the fp32 flash backward once an attention
   or cross layer on the card; then saves each smoke config's train state
   on the card in the reference's stacked format (``groups=``) and
   restores it, which must give params and momentum back bit for bit;
10. runs the dry run (``python -m repro_torch.launch.dryrun``, in
   subprocesses without the card, all at once: torch's ``fake`` process
   group, meta tensors) for Qwen3-1.7B's ``train_4k`` on the 16 x 16 mesh
   (256 ranks, remat, the manual torus sync), llama3-405b's ``decode_32k``
   on the 2 x 16 x 16 mesh (512 ranks, FSDP), gemma2-27b's ``train_4k``
   (FSDP) and recurrentgemma-9b's ``prefill_32k`` (both 16 x 16, which
   torch 2.11's DTensor rules refused before the embedding and the RG-LRU
   gates ran shard by shard), fails if one exits non-zero, and prints
   each one's exchanges, collective bytes, FLOPs,
   bytes accessed and wall seconds; runs ``python -m
   repro_torch.launch.cost_extrapolate`` on the Qwen3-1.7B artifact and
   fails if its fit from 1 and 2 blocks misses the full count's FLOPs by
   more than ``LINEAR_RTOL``; and holds ``perf.card_step``'s count of the
   remat training step (``ROOFLINE_BATCH`` x 2048 tokens, one rank, meta
   tensors, in one more subprocess beside the dry runs) against the
   median of the same stage in step 8: it prints FLOPs, bytes accessed,
   compute_s and memory_s at the H100's peaks, each over the measured
   step, the flash kernels' share of the bytes, and the count's temp and
   argument bytes beside ``max_memory_allocated``, and fails if a count
   is 0 or ``max(compute_s, memory_s)`` exceeds the measured step;
11. destroys the process group, and prints one ``{"kernels": [...]}``
   line, the card line again, and as the last line ``{"ok": true,
   "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent or the port is not
beside this file. Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import os
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
# the flash backward vs its plain version on the same inputs:
# kernels/ref.py::flash_attention_bwd_tol, derived from the roundings the
# kernel makes: fp32 (FMAs, P and dS in fp32) against the exact answer (the
# plain version in fp64); bf16 (tensor cores, P and dS rounded to bf16)
# against the fp32 plain version. Elementwise, with M_d the sums' magnitudes
# (|dS|.|k| and the like) and M_w their error weights; and on each output's
# norm, with the bf16 roundings at sqrt(3) times their rms
FLASH_BWD_TOL = ("fp32 1e-9 + 2^-24|exact| + (D + 8) 2^-24 M_w + (n + 2) 2^-24 M_d; "
                 "bf16 1e-9 + 2^-7|ref| + 2^-8 M_d + 4 (D + 8) 2^-24 M_w + 4 (n + 2) 2^-24 "
                 "M_d; norm: bf16 2^-8 (sqrt(R) + 2|ref|) + |the sums' terms|")
# smoke transformers, fp32 compute, card vs host: matmuls and the attention
# sum in different orders; two or three layers keep that near fp32 noise
SMOKE_LOGIT_TOL = 1e-4           # abs and relative, on prefill logits
# one fp32 training step of each smoke config, card vs host: the same sums in
# other orders, then LARS at the step's learning rate; the 8-rank fp32 gate's
# limits (tests/test_torch_trainer_dist.py): loss rtol 1e-5, params 1e-5 +
# 1e-4 |host|
SMOKE_STEP_TOL = (1e-5, 1e-5, 1e-4)   # (loss rtol, params atol, params rtol)
# the full-width LM training phase: Qwen3-1.7B, two batch stages of
# LM_STAGE_STEPS steps, per-step sequences of LM_SEQ tokens
LM_ARCH, LM_SEQ, LM_STAGES, LM_STAGE_STEPS = "qwen3-1.7b", 2048, (2, 4), 3
# the same with remat: 4 x 2048, then the largest batch up to which every
# batch fits the card under the default allocator (python -m
# repro_torch.launch.remat_batch --batches 9,10,11,12 on an H100 80GB HBM3,
# each size in a fresh process: 9 and 11 run, 10 and 12 run out of memory
# where the ls_xent backward asks for its fp32 logit gradient with 22-28
# GiB reserved but unallocated: fragmentation, not capacity; PERF.md)
LM_REMAT_MAX_BATCH = 9
# the dry run's combinations: the manual torus sync at world 256 with remat,
# an FSDP arch at world 512, and two that torch 2.11's DTensor rules
# refused until the model took their ops shard by shard: an FSDP arch's
# train step (the embedding's gradient) and recurrentgemma's prefill (the
# RG-LRU gates)
DRYRUN_COMBOS = (("qwen3-1.7b", "train_4k", ()),
                 ("llama3-405b", "decode_32k", ("--multi-pod",)),
                 ("gemma2-27b", "train_4k", ()),
                 ("recurrentgemma-9b", "prefill_32k", ()))
# the roofline's step: the remat training of LM_ARCH at ROOFLINE_BATCH x
# LM_SEQ tokens, counted on meta tensors (repro_torch.launch.perf.card_step)
# and timed on the card (its first remat stage)
ROOFLINE_BATCH = 4
# the fit of cost_extrapolate against the dry run's full count, relative
LINEAR_RTOL = 1e-3
# the full-width serve phases: dense attention, the MoE MLP, the SSD mixer,
# the RG-LRU hybrid, the VLM's cross-attention
SERVE_ARCHS = ("qwen3-1.7b", "granite-moe-3b-a800m", "mamba2-2.7b", "recurrentgemma-9b",
               "llama-3.2-vision-90b")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()[0]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


BN_KERNELS = ("bn_fwd_stats", "bn_fwd_apply", "bn_bwd_sums", "bn_bwd_dx")


def bn_launches(n: int) -> dict:
    """Each BN kernel's count, ``n``: one launch a BN a pass."""
    return {name: n for name in BN_KERNELS}


GUARD_KERNELS = ("guard_unscale_count", "guard_commit")


def guard_launches(steps: int) -> dict:
    """The guard's kernels' counts over ``steps`` steps of fewer than 513
    leaves: one unscale and one commit a step."""
    return {name: steps for name in GUARD_KERNELS}


def check_bn(torch, gen) -> dict:
    """The BN kernels against their plain versions at every distinct BN of
    ResNet-50 at 256 images (bf16) and of the tiny config (fp32), through
    ``profile_bn.check``: the two sums within their tolerance, every other
    output bit for bit, a second call the same bytes. Returns the worst
    err/tol of the sums and their max abs error."""
    from repro_torch.launch import profile_bn
    from repro_torch.models import resnet

    worst = {"stats": 0.0, "bwd_sums": 0.0, "max_abs_err": 0.0}
    n = 0
    for cfg, batch, dtype in ((resnet.ResNetConfig.resnet50(), 256, torch.bfloat16),
                              (resnet.ResNetConfig.tiny(), 8, torch.float32)):
        for c, _ in profile_bn.distinct(profile_bn.calls(cfg, batch)):
            r = profile_bn.check(c, dtype, gen)
            worst["stats"] = max(worst["stats"], r["stats_err_over_tol"])
            worst["bwd_sums"] = max(worst["bwd_sums"], r["bwd_sums_err_over_tol"])
            worst["max_abs_err"] = max(worst["max_abs_err"], r["sums_max_abs_err"])
            n += 1
            if not r["ok"]:
                fail(f"batchnorm kernels disagree with their plain versions: {r}")
    print(f"check batchnorm: {n} shapes (ResNet-50's 16 at 256 images in bf16, the tiny "
          f"config's in fp32), worst err/tol stats {worst['stats']:.3g}, backward sums "
          f"{worst['bwd_sums']:.3g} (tol {profile_bn.SUM_TOL:g} of the terms' magnitudes), "
          f"max abs err {worst['max_abs_err']:.3e}; every other output bit for bit, a second "
          f"call the same bytes")
    return worst


def time_bn(torch, gen) -> dict:
    """The BN kernels at each distinct BN of ResNet-50 at 256 images, bf16
    (``profile_bn.time_call``), and their sum over the step's 53 BNs beside
    the two-pass bytes' bound, the plain versions, the earlier autograd
    chain and ``F.batch_norm``."""
    from repro_torch.launch import profile_bn
    from repro_torch.models import resnet

    cs = profile_bn.distinct(profile_bn.calls(resnet.ResNetConfig.resnet50(), 256))
    rows = []
    for c, n in cs:
        rows.append({**profile_bn.time_call(c, torch.bfloat16, gen), "count": n})
        print(f"time batchnorm {c.name} x{n}: {json.dumps(rows[-1])}")
    t = profile_bn.totals(rows, [n for _, n in cs])
    print(f"time batchnorm, the 53 BNs of a ResNet-50 step at 256 images: kernels "
          f"{t['kernels_ms']:.3f} ms (forward {t['fwd_ms']:.3f}, backward {t['bwd_ms']:.3f}), "
          f"bound {t['bound_ms']:.3f} ms ({t['fwd_bytes'] + t['bwd_bytes']} B at 3.35 TB/s: "
          f"{100 * t['of_bound']:.1f}% of it), plain {t['plain_fwd_ms'] + t['plain_bwd_ms']:.3f}, "
          f"earlier chain {t['chain_fwd_bwd_ms']:.3f}, F.batch_norm and its epilogue "
          f"{t['library_fwd_bwd_ms']:.3f}")
    return {"ms": t["kernels_ms"], "eager_ms": None,
            "plain_ms": t["plain_fwd_ms"] + t["plain_bwd_ms"],
            "library_ms": t["library_fwd_bwd_ms"], "chain_ms": t["chain_fwd_bwd_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "at": "the 53 BNs of one ResNet-50 step at 256 images, bf16, forward and backward",
            "shapes": rows}


def check_guard(torch, gen) -> dict:
    """The guard's kernels against their plain versions at ResNet-50's 161
    leaves and Qwen3-1.7B's 310, laid out as the step lays them out
    (``profile_guard.check``): the unscale and the commit, on a clean step
    and with a NaN planted, bit for bit. Returns the max abs error."""
    from repro_torch.launch import profile_guard

    err = 0.0
    for tree in profile_guard.TREES:
        r = profile_guard.check(profile_guard.leaf_sizes(tree), gen)
        print(f"check guard {tree}: {json.dumps(r)}")
        if not all(v for k, v in r.items() if k.endswith("_same")) or r["max_abs_err"] != 0:
            fail(f"the guard's kernels differ from their plain versions at {tree}'s leaves: {r}")
        err = max(err, r["max_abs_err"])
        torch.cuda.empty_cache()
    print(f"check guard: unscale and commit at {' and '.join(profile_guard.TREES)}'s leaves, "
          f"clean and with a NaN planted, bit for bit (max abs err {err:g})")
    return {"max_abs_err": err}


def time_guard(torch, gen) -> dict:
    """The guard's kernels at ResNet-50's and Qwen3-1.7B's leaves
    (``profile_guard.time_tree``): the unscale and the commit of a finite
    step beside the unscale's byte bound (the commit moves no parameter
    byte on a finite step), the plain version and
    ``torch._amp_foreach_non_finite_check_and_unscale_``. The row is
    ResNet-50's, with Qwen3-1.7B's under ``lm``."""
    from repro_torch.launch import profile_guard

    rows = {}
    for tree in profile_guard.TREES:
        rows[tree] = profile_guard.time_tree(tree, profile_guard.leaf_sizes(tree), gen)
        print(f"time guard {tree}: {json.dumps(rows[tree])}")
        torch.cuda.empty_cache()

    def entry(r):
        return {"ms": r["unscale_ms"] + r["commit_finite_ms"], "unscale_ms": r["unscale_ms"],
                "commit_finite_ms": r["commit_finite_ms"],
                "commit_skipped_ms": r["commit_skipped_ms"], "bound_ms": r["unscale_bound_ms"],
                "eager_ms": r["guard_eager_ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["library_ms"], "host_us": r["host_us"],
                "plain_host_us": r["plain_host_us"],
                "at": f"the guard of one step over {r['tree']}'s {r['leaves']} leaves, "
                      f"{r['elements']} fp32 elements"}

    res, lm = (entry(rows[t]) for t in profile_guard.TREES)
    return {**res, "bound_by": "bytes", "lm": lm}


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
        (8, 2048, 2048, 24, 8, 64, torch.bfloat16, True, None, None),   # granite prefill
        (2, 1024, 1024, 8, 4, 64, torch.bfloat16, True, None, None),
        (2, 1024, 1024, 8, 4, 256, torch.bfloat16, True, None, None),
        (2, 1024, 1024, 16, 8, 128, torch.bfloat16, True, 256, 50.0),
        (2, 1000, 1000, 16, 8, 128, torch.bfloat16, True, None, None),
        (2, 1000, 1000, 16, 8, 128, torch.bfloat16, False, None, None),
        (2, 1024, 1024, 16, 8, 128, torch.float32, True, None, None),
        (2, 1000, 1000, 16, 8, 128, torch.float32, False, 300, 30.0),
        (4, 48, 48, 4, 2, 32, torch.float32, True, 16, 50.0),            # smoke configs
        # recurrentgemma's local layers at twice the serve length, so that
        # the band of window 2048 skips; the VLM's cross layer, unmasked
        (2, 4096, 4096, 16, 1, 256, torch.bfloat16, True, 2048, None),
        (8, 2048, 1601, 64, 8, 128, torch.bfloat16, False, None, None),
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
    bf16 kernel at the Qwen3-1.7B prefill shape and, under "serve", at the
    other served archs' prefill shapes; the fp32 kernel at the Qwen3 smoke
    config's shape (its main path) and, under "prefill", at the Qwen3-1.7B
    prefill shape in fp32; each beside its plain version, SDPA and its
    bound (fp32: 3xTF32, with the fp32 FMA bound beside it)."""
    from repro_torch.launch import profile_flash

    out, prefill = {}, None
    for name, shape, dtype, masks, what in profile_flash.SHAPES:
        t = profile_flash.time_flash(name, shape, dtype, masks, what, gen)
        print(f"time {name} ({t['at']}): {t}")
        if dtype == torch.float32 and shape == profile_flash.QWEN:
            prefill = t
        else:
            out[name] = t
    keys = ("ms", "eager_ms", "bound_ms", "plain_ms", "library_ms", "tflops_per_s",
            "max_abs_err", "worst_err_over_tol", "at")
    out["flash_attn_f32"]["prefill"] = {k: prefill[k] for k in keys + ("fma_bound_ms",)}
    out["flash_attn"]["serve"] = []
    for shape, masks, what in profile_flash.SERVE_SHAPES:
        t = profile_flash.time_flash("flash_attn", shape, torch.bfloat16, masks, what, gen)
        print(f"time flash_attn ({t['at']}): {t}")
        out["flash_attn"]["serve"].append({k: t[k] for k in keys})
    # the backward: each dtype's main-path row (bf16: the LM's training
    # shape; fp32: the smoke config's), its other training rows under "train"
    # (fp32 at Qwen3-1.7B's training shape, bf16 at gemma-7b's), bf16 also at
    # the served shapes
    bkeys = ("ms", "eager_ms", "bound_ms", "fma_bound_ms", "plain_ms", "library_ms",
             "tflops_per_s", "max_abs_err", "worst_err_over_tol", "worst_norm_over_limit",
             "at")
    train = {}
    for name, shape, dtype, masks, what in profile_flash.BWD_SHAPES:
        t = profile_flash.time_flash_bwd(name, shape, dtype, masks, what, gen)
        print(f"time {name} ({t['at']}): {t}")
        main = profile_flash.TRAIN if dtype == torch.bfloat16 else profile_flash.SMOKE
        if shape == main:
            out[name] = t
        else:
            train.setdefault(name, []).append({k: t.get(k) for k in bkeys})
    for name, rows in train.items():
        out[name]["train"] = rows
    out["flash_attn_bwd"]["serve"] = []
    for shape, masks, what in profile_flash.SERVE_SHAPES:
        t = profile_flash.time_flash_bwd("flash_attn_bwd", shape, torch.bfloat16, masks,
                                         what, gen)
        print(f"time flash_attn_bwd ({t['at']}): {t}")
        out["flash_attn_bwd"]["serve"].append({k: t.get(k) for k in bkeys})
    return out


def check_flash_bwd(torch, gen) -> dict:
    """The backward kernel in both dtypes against its plain version at the
    training and serve paths' shapes and a softcap case whose logits reach
    the cap (``profile_flash.BWD_CHECKS``; bf16: the plain version in fp32;
    fp32: in fp64, the exact answer, at batch 2), from the forward kernel's
    o and lse; fails over ``ref.flash_attention_bwd_tol``, elementwise or
    normwise. Returns the max abs error and worst err/tol by dtype."""
    from repro_torch.launch import profile_flash

    worst = {torch.bfloat16: [0.0, 0.0, 0.0], torch.float32: [0.0, 0.0, 0.0]}
    for shape, masks, mag, what in profile_flash.BWD_CHECKS:
        for dtype in (torch.bfloat16, torch.float32):
            r = profile_flash.check_flash_bwd(shape, masks, mag, dtype, gen)
            if r["launches"] != 1:
                fail(f"{r['kernel']} did not count its launch")
            def each(key, fmt):
                return "/".join(format(e[key], fmt) for e in r["errors"])
            print(f"check flash_attn_bwd {r['at']} ({what}): max_abs_err dq/dk/dv "
                  f"{each('max_abs_err', '.3e')}, err/tol {each('err_over_tol', '.3f')}, "
                  f"norm err/limit {each('norm_over_limit', '.3f')} ({r['kernel']})")
            if r["worst_err_over_tol"] > 1 or r["worst_norm_over_limit"] > 1:
                fail(f"flash_attn_bwd off at {r['at']} ({what}): worst err/tol "
                     f"{r['worst_err_over_tol']:.3g}, norm err/limit "
                     f"{r['worst_norm_over_limit']:.3g}")
            w = worst[dtype]
            worst[dtype] = [max(w[0], r["max_abs_err"]), max(w[1], r["worst_err_over_tol"]),
                            max(w[2], r["worst_norm_over_limit"])]
    print(f"check flash_attn_bwd: max_abs_err bf16 {worst[torch.bfloat16][0]:.3e}, fp32 "
          f"{worst[torch.float32][0]:.3e}; worst err/tol bf16 {worst[torch.bfloat16][1]:.3f}, "
          f"fp32 {worst[torch.float32][1]:.3f}; worst norm err/limit bf16 "
          f"{worst[torch.bfloat16][2]:.3f}, fp32 {worst[torch.float32][2]:.3f} "
          f"(tol {FLASH_BWD_TOL})")
    return {"bf16": tuple(worst[torch.bfloat16]), "fp32": tuple(worst[torch.float32])}


def train_lm(torch, dev, grid, card: str, stages=LM_STAGES, remat: bool = False) -> dict:
    """Qwen3-1.7B at full width through ``repro_torch.launch.train.build`` on
    the world-1 NCCL grid: batch stages of ``stages`` sequences of
    ``LM_SEQ`` tokens, ``LM_STAGE_STEPS`` steps each, schedule B,
    smoothing 0.1, torus2d ``fuse=False`` bf16, LARS over the reference's
    13 stacked leaves, ``remat`` as given. Fails on a non-finite loss, a
    skipped step, or a step that does not launch the flash forward once an
    attention layer (twice with ``remat``: again in backward) and the
    backward once, ``ls_xent`` forward and backward once and LARS twice."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core import grad_sync
    from repro_torch.kernels import ops
    from repro_torch.launch import profile_trainer
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get(LM_ARCH), remat=remat)
    run = launch_train.build(LM_ARCH, cfg=cfg, seq=LM_SEQ, batch_stages=stages, steps=None,
                             stage_steps=LM_STAGE_STEPS, device=dev, grid=grid, log_every=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = run.state.params
    n_params = sum(p.numel() for p in params.values())
    layout = grad_sync.bucket_layout(params, run.trainer.cfg.grad_sync, run.groups)
    per_leaf = sum(1 for b in layout if b["mode"] == "per_leaf")
    sync_bytes = sum(b["nbytes"] for b in layout)
    tag = f"{LM_ARCH}{' remat' if remat else ''}"
    print(f"train {tag}: {n_params} parameters, {len(params)} port leaves in "
          f"{len(run.groups)} reference leaves (LARS groups); sync torus2d fuse=False bf16: "
          f"{len(layout)} exchanges ({per_leaf} per-leaf, {len(layout) - per_leaf} grouped), "
          f"{sync_bytes} B; init {init_s:.1f} s")
    if (len(params), len(run.groups)) != (310, 13):
        fail(f"{LM_ARCH}: {len(params)} port leaves in {len(run.groups)} groups, want 310 in 13")
    n_attn = attention_layers(run.cfg)
    plan = run.trainer.plan
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = run.trainer.run(run.state, log=lambda s: None)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rows = [h for h in history if h["kind"] == "metric"]
    for r in rows:
        print(f"  step {r['step']:2d} gb {r['global_batch']} loss {r['loss']:.5f} lr "
              f"{r['lr']:.5f} skipped {r['skipped']} grad_norm {r['grad_norm']:.4f} step_ms "
              f"{1e3 * r['wall_s']:.2f}")
    steps = len(rows)
    if steps != plan.total_steps or state.step != plan.total_steps or \
            [s.num_steps for s in plan.stages] != [LM_STAGE_STEPS] * len(stages):
        fail(f"{tag}: ran {steps} steps, plan {[s.num_steps for s in plan.stages]}")
    for r in rows:
        if not (r["loss"] == r["loss"] and abs(r["loss"]) < float("inf")) or r["skipped"]:
            fail(f"{tag} step {r['step']}: loss {r['loss']}, skipped {r['skipped']}")
    want = {"lars_update": 2 * steps, "ls_xent_fwd": steps, "ls_xent_bwd": steps,
            "flash_attn": (2 if remat else 1) * n_attn * steps, "flash_attn_f32": 0,
            "flash_attn_bwd": n_attn * steps, "flash_attn_bwd_f32": 0, **bn_launches(0),
            **guard_launches(steps)}
    if counts != want:
        fail(f"{tag} training launched {counts}, want {want}")
    medians = profile_trainer.stage_medians(plan, rows)
    for st in medians:
        st["tokens_per_s"] = st["global_batch"] * LM_SEQ / (st["steady_median_ms"] / 1e3)
        print(f"train {tag} stage {st['global_batch']} x {LM_SEQ} tokens: step ms "
              f"{[round(w, 2) for w in st['step_ms']]}, steady median (first step excluded) "
              f"{st['steady_median_ms']:.2f} ms, {st['tokens_per_s']:.0f} tokens/s ({card})")
    print(f"train {tag}: {steps} steps in {run_s:.1f} s, launches {counts}, peak device "
          f"memory {peak / 2**30:.2f} GiB ({card})")
    del run, state, params, history
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "stages": medians, "peak_gib": peak / 2**30, "remat": remat,
            "exchanges": len(layout), "per_leaf_exchanges": per_leaf,
            "sync_bytes": sync_bytes, "port_leaves": 310, "groups": 13,
            "seq": LM_SEQ, "init_s": init_s, "run_s": run_s}


def repeat_flash_bwd(torch, gen) -> None:
    """The backward in both dtypes, called twice on the same inputs at the
    training shape, granite's GQA prefill and recurrentgemma's MQA at D 256
    (``profile_flash.BWD_REPEATS``; fp32 at batch 2): the outputs must be
    equal, byte for byte."""
    from repro_torch.launch import profile_flash

    for shape, masks, _, what in profile_flash.BWD_REPEATS:
        for dtype in (torch.bfloat16, torch.float32):
            same = profile_flash.repeat_flash_bwd(shape, masks, dtype, gen)
            print(f"repeat flash_attn_bwd {shape} {str(dtype)[6:]} ({what}): two calls "
                  f"{'equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"flash_attn_bwd at {shape} {dtype}: two calls on the same inputs differ")


def checkpoint_round_trip(torch) -> None:
    """Each of the ten smoke configs' train states on the card (params from
    seed 0, momentum seeded at random) saved with the reference's stacked
    leaves (``groups=convert.leaf_groups``) and restored into a state of
    zeros: params and momentum must come back bit for bit, on the card."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint
    from repro_torch.train.state import TrainState

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    for arch in registry.ARCH_IDS:
        cfg = registry.get_smoke(arch)
        params = {k: p.detach() for k, p in T.init(cfg, seed=0, device=dev).named_parameters()}
        groups = convert.leaf_groups(params, cfg)
        state = TrainState.create(params)
        state.opt_state["momentum"] = {k: torch.randn(p.shape, generator=g, device=dev)
                                       for k, p in params.items()}
        state.step = 7
        like = TrainState.create({k: torch.zeros_like(p) for k, p in params.items()})
        with tempfile.TemporaryDirectory() as d:
            path = checkpoint.save(d, state, groups=groups)
            n_stored = len(checkpoint.load_manifest(path)["leaves"])
            nbytes = os.path.getsize(path)
            got = checkpoint.restore(path, like, groups=groups)
        same = got.step == 7 and all(
            got.params[k].device == p.device and torch.equal(got.params[k], p)
            and torch.equal(got.opt_state["momentum"][k], state.opt_state["momentum"][k])
            for k, p in params.items())
        print(f"checkpoint {arch} smoke on the card: {len(params)} port params in "
              f"{len(groups)} groups, {n_stored} leaves stored (params, momentum, 3 scalars), "
              f"{nbytes} B, restored {'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            fail(f"{arch}: the stacked checkpoint did not restore bit for bit")


def smoke_train_card_vs_host(torch, grid) -> int:
    """One fp32 training step of each of the ten smoke configs through
    ``make_train_step`` at world 1, with the launcher's loss and the
    reference's stacked leaves, from the same weights and batch on the card
    and the host: the loss and every parameter after LARS within
    ``SMOKE_STEP_TOL``, and the card's step launching the fp32 flash
    backward once an attention or cross layer. Returns those launches."""
    import dataclasses

    import numpy as np

    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.core.grad_sync import GradSyncConfig
    from repro_torch.core.topology import TorusGrid
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import TrainerConfig, make_train_step

    loss_rtol, p_atol, p_rtol = SMOKE_STEP_TOL
    tcfg = TrainerConfig(schedule="B", grad_sync=GradSyncConfig(
        strategy="torus2d", fuse=False, comm_dtype=torch.float32))
    card_launches = 0
    for arch in registry.ARCH_IDS:
        cfg = dataclasses.replace(registry.get_smoke(arch), compute_dtype=torch.float32)
        host = T.init(cfg, seed=4, device="cpu")
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for name, p in host.named_parameters():
                if "norm_scale" in name:
                    p.normal_(0.0, 0.3, generator=g)
        groups = convert.leaf_groups(dict(host.named_parameters()), cfg)
        rng = np.random.RandomState(6)
        batch = [torch.from_numpy(rng.randint(0, cfg.vocab, (4, 48))) for _ in range(2)]
        if cfg.vision_tokens:
            batch.append(torch.from_numpy(
                rng.randn(4, cfg.vision_tokens, cfg.cross_kv_dim).astype(np.float32)))
        got = {}
        for d in ("cpu", "cuda"):
            params = {k: p.detach().to(d) for k, p in host.named_parameters()}
            step = make_train_step(launch_train.loss_fn_for(cfg, SMOOTHING), tcfg,
                                   grid if d == "cuda" else TorusGrid(), groups)
            ops.reset_launch_counts()
            st, m = step(TrainState.create(params), tuple(t.to(d) for t in batch), 0.05, 4)
            got[d] = ({k: v.cpu() for k, v in st.params.items()}, float(m["loss"]),
                      ops.launch_counts()["flash_attn_bwd_f32"], int(m["skipped"]))
        (pc, lc, nc, sc), (ph, lh, nh, sh) = got["cuda"], got["cpu"]
        l_err = abs(lc - lh) / abs(lh)
        p_err = max((pc[k] - v).abs().max().item() for k, v in ph.items())
        ok = l_err <= loss_rtol and all(bool(((pc[k] - v).abs() <= p_atol + p_rtol * v.abs())
                                             .all()) for k, v in ph.items())
        print(f"{arch} smoke fp32 train step, card vs host: loss rel err {l_err:.3e}, params "
              f"max_abs_err {p_err:.3e} (tol loss {loss_rtol:g}, params {p_atol:g} + "
              f"{p_rtol:g}|host|), flash_attn_bwd_f32 launches card {nc} host {nh}")
        if not ok or sc or sh:
            fail(f"{arch} smoke train step: the card disagrees with the host")
        if nc != attention_layers(cfg) or nh != 0:
            fail(f"{arch} smoke train step: flash backward launches card {nc}, host {nh}")
        card_launches += nc
    return card_launches


def attention_layers(cfg) -> int:
    """Layers whose prefill launches the flash kernel."""
    return sum(kind in ("attn", "local", "cross") for kind in cfg.kinds())


def serve(torch, dev, arch: str) -> dict:
    """The serve path of ``arch`` at full width (its depth cut where
    ``profile_serve.DEPTH_CUTS`` says): RequestBatcher + generate, then the
    same work split into prefill and decode steps to time each."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_serve import (DEPTH_CUTS, NEW, PROMPT_LENS, SEQ,
                                                  serve_config, vision_input)
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode

    cfg = serve_config(arch)
    cut = (f" (depth cut to {cfg.n_layers} of {registry.get(arch).n_layers} layers: "
           f"{'/'.join(cfg.kinds())})" if arch in DEPTH_CUTS else "")
    n_attn = attention_layers(cfg)
    t0 = time.perf_counter()
    model = T.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{arch}{cut}: {n_params} parameters ({cfg.num_params()} without norms, "
          f"{cfg.active_params()} active a token), init {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    batcher = decode.RequestBatcher(batch_size=len(prompts), seq_len=SEQ)
    toks, lens, n_real = batcher.pack(prompts, device=dev)
    vision = vision_input(cfg, len(prompts), dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = decode.generate(model, toks, cfg, max_new_tokens=NEW, vision=vision)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    results = batcher.unpack(out, n_real)
    print(f"serve {arch}{cut}: generate {n_real} x {NEW} tokens in {1e3 * gen_s:.2f} ms "
          f"({n_real * NEW / gen_s:.1f} generated tokens/s), launches {counts}, "
          f"peak device memory {peak / 2**30:.2f} GiB")
    want = {"lars_update": 0, "ls_xent_fwd": 0, "ls_xent_bwd": 0,
            "flash_attn": n_attn, "flash_attn_f32": 0, "flash_attn_bwd": 0,
            "flash_attn_bwd_f32": 0, **bn_launches(0), **guard_launches(0)}
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
        logits, cache = T.prefill(params, toks, cfg, vision=vision, cache_len=SEQ + NEW)
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
    phase_peak = torch.cuda.max_memory_allocated()
    print(f"serve {arch}{cut}: prefill {len(prompts)} x {SEQ} tokens {prefill_ms:.2f} ms, "
          f"flash launches {prefill_counts['flash_attn']}; decode step ms median "
          f"{statistics.median(step_ms):.3f} (first {step_ms[0]:.3f}, max "
          f"{max(step_ms):.3f}) over {len(step_ms)} steps, flash launches "
          f"{decode_counts['flash_attn']}; the phase's peak device memory "
          f"{phase_peak / 2**30:.2f} GiB")
    if prefill_counts["flash_attn"] != n_attn:
        fail(f"{arch} prefill launched flash_attn {prefill_counts['flash_attn']} times, "
             f"want {n_attn}")
    if any(decode_counts.values()):
        fail(f"decode launched {decode_counts}, want no kernel")
    if not bool(finite):
        fail("non-finite logits in prefill or decode")
    if not torch.equal(torch.cat(toks_out, dim=1), out):
        fail(f"{arch}: prefill + serve steps and generate picked different tokens")
    return {"counts": counts, "generate_ms": 1e3 * gen_s, "prefill_ms": prefill_ms,
            "decode_ms": statistics.median(step_ms),
            "tokens_per_s": n_real * NEW / gen_s, "peak_gib": peak / 2**30,
            "phase_peak_gib": phase_peak / 2**30, "layers": cfg.n_layers}


def smoke_card_vs_host(torch) -> int:
    """The smoke configs of all ten archs, fp32 compute, the same weights,
    prompts and (for the VLM) vision input on the card and on the host:
    tokens equal, logits close, one fp32 flash launch an attention or cross
    layer in the card's prefill (none for mamba2). Returns the fp32 flash
    kernel's launches in the card's prefills."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import decode

    card_launches = 0
    if len(registry.ARCH_IDS) != 10:
        fail(f"the registry lists {registry.ARCH_IDS}, want ten archs")
    for arch in registry.ARCH_IDS:
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
        vision = (torch.from_numpy(rng.randn(4, cfg.vision_tokens, cfg.cross_kv_dim)
                                   .astype(np.float32)) if cfg.vision_tokens else None)
        batcher = decode.RequestBatcher(batch_size=4, seq_len=48)
        got = {}
        for dev, model in (("cpu", host), ("cuda", card)):
            toks, _, n = batcher.pack(prompts, device=dev)
            v = None if vision is None else vision.to(dev)
            ops.reset_launch_counts()
            with torch.inference_mode():
                logits, _ = T.prefill(model, toks, cfg, vision=v, cache_len=56)
            launches = ops.launch_counts()["flash_attn_f32"]   # fp32 compute
            out = decode.generate(model, toks, cfg, max_new_tokens=8, vision=v)
            got[dev] = (logits.cpu(), batcher.unpack(out.cpu(), n), launches)
        err = (got["cuda"][0] - got["cpu"][0]).abs()
        ok = bool((err <= SMOKE_LOGIT_TOL * (1 + got["cpu"][0].abs())).all())
        print(f"{arch} smoke fp32, card vs host: prefill logits max_abs_err "
              f"{err.max().item():.3e} (tol {SMOKE_LOGIT_TOL:g} (1 + |host|)), tokens "
              f"{'equal' if got['cuda'][1] == got['cpu'][1] else 'DIFFER'}, flash "
              f"launches card {got['cuda'][2]} host {got['cpu'][2]}")
        if not ok or got["cuda"][1] != got["cpu"][1]:
            fail(f"{arch} smoke: the card disagrees with the host")
        if got["cuda"][2] != attention_layers(cfg) or got["cpu"][2] != 0:
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


def telemetry_cost_us(n_iters: int = 2000) -> float:
    """Host microseconds of the telemetry a step of ``Trainer.run`` records
    (its six spans, three histograms, a counter, a gauge), with no sink:
    the main phase's setting."""
    from repro_torch.obs import ObsConfig, Telemetry

    tel = Telemetry(ObsConfig())
    reg = tel.registry
    t0 = time.perf_counter()
    for k in range(n_iters):
        with tel.span("step", step=k) as sp:
            for name in ("data", "dispatch", "sync_wait", "log", "checkpoint"):
                with tel.span(name, step=k):
                    pass
        reg.histogram("step/wall_s").observe(sp.duration)
        reg.histogram("step/data_s").observe(0.0)
        reg.histogram("step/sync_wait_s").observe(0.0)
        reg.counter("train/steps").inc()
        reg.gauge("train/loss_scale").set(1.0)
    return 1e6 * (time.perf_counter() - t0) / n_iters


def supervised(torch, grid, model, data_fn, loss_fn, plan, sync, card: str) -> dict:
    """The supervised trainer at full width, deterministic (cuDNN
    deterministic, no autotuning; the port's kernels repeat bit for bit):
    a clean run with telemetry and checkpoints, a chaos run that recovers
    once, a run stopped at step 6 and resumed, the checkpoint layer timed,
    a checkpoint restored on the host, and a ``torch_profile`` window.
    Fails unless the chaos and resumed runs end bit-identical to the clean
    one. Returns the kernels' launches over the phase and its numbers."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.obs import ObsConfig, read_run
    from repro_torch.testing.chaos import FaultPlan
    from repro_torch.train import checkpoint
    from repro_torch.train.elastic import ElasticConfig
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    def trainer(ckpt_dir=None, faults=None, elastic=ElasticConfig(), obs=ObsConfig()):
        cfg = TrainerConfig(schedule="B", log_every=1, grad_sync=sync, ckpt_every_steps=4,
                            ckpt_keep_last=2, elastic=elastic, obs=obs)
        return Trainer(loss_fn=loss_fn, cfg=cfg, plan=plan, data_fn=data_fn, grid=grid,
                       checkpoint_dir=ckpt_dir, fault_plan=faults)

    def fresh():
        return TrainState.create(dict(model.named_parameters()))

    def same(a, b) -> bool:
        return all(torch.equal(a.params[k], b.params[k]) and torch.equal(
            a.opt_state["momentum"][k], b.opt_state["momentum"][k]) for k in a.params)

    def recoveries(metrics_path) -> float:
        summary = [r for r in read_run(metrics_path) if r["kind"] == "summary"][-1]
        return summary["metrics"].get("elastic/recoveries", {"value": 0.0})["value"]

    quiet = lambda s: None  # noqa: E731
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            obs = ObsConfig(metrics_path=str(tmp / "clean.jsonl"),
                            trace_path=str(tmp / "clean_trace.json"))
            clean, clean_hist = trainer(str(tmp / "clean"), obs=obs).run(fresh(), log=quiet)
            clean_s = time.perf_counter() - t0
            faults = FaultPlan(data_fail_steps=(2,), ckpt_crash_writes=(0,),
                               nan_grad_steps=(5, 6, 7), grad_fault_once=True)
            t0 = time.perf_counter()
            chaos, chaos_hist = trainer(
                str(tmp / "chaos"), faults, ElasticConfig(max_consecutive_nonfinite=3),
                ObsConfig(metrics_path=str(tmp / "chaos.jsonl"))).run(fresh(), log=quiet)
            chaos_s = time.perf_counter() - t0
            trainer(str(tmp / "resume")).run(fresh(), max_steps=6, log=quiet)
            resumed, resumed_hist = trainer(str(tmp / "resume")).run(fresh(), resume=True,
                                                                     log=quiet)
            profiled, _ = trainer(obs=ObsConfig(torch_profile_dir=str(tmp / "prof"))).run(
                fresh(), max_steps=2, log=quiet)
            torch.cuda.synchronize()
            counts = ops.launch_counts()

            events = [h for h in chaos_hist if "event" in h]
            for h in events:
                print(f"supervised chaos event: {json.dumps(h)}")
            rows = {name: [h for h in hist if h["kind"] == "metric"]
                    for name, hist in (("clean", clean_hist), ("chaos", chaos_hist),
                                       ("resumed", resumed_hist))}
            steps_run = {"clean": 12, "chaos": len(rows["chaos"]), "part": 6,
                         "resumed": len(rows["resumed"]), "profiled": 2}
            total = sum(steps_run.values())
            rec = {"clean": recoveries(obs.metrics_path),
                   "chaos": recoveries(str(tmp / "chaos.jsonl"))}
            verdict = {"chaos": same(chaos, clean), "resumed": same(resumed, clean)}
            resume_at = [h["step"] for h in resumed_hist if h.get("event") == "resume"]
            skipped = [h["step"] for h in rows["chaos"] if h["skipped"]]
            print(f"supervised ({card}): clean run {clean_s:.2f} s, chaos run {chaos_s:.2f} s; "
                  f"steps run {steps_run}; chaos skipped steps {skipped}; "
                  f"elastic/recoveries clean {rec['clean']:g}, chaos {rec['chaos']:g}; "
                  f"resumed from step {resume_at}; chaos == clean "
                  f"{verdict['chaos']}, resumed == clean {verdict['resumed']}; "
                  f"launches {counts}")
            if (clean.step, chaos.step, resumed.step, profiled.step) != (12, 12, 12, 2):
                fail("a supervised run did not end at its last step")
            if rec != {"clean": 0.0, "chaos": 1.0}:
                fail(f"elastic/recoveries {rec}, want clean 0 and chaos 1")
            if skipped != [6, 7, 8] or resume_at != [4] or steps_run["chaos"] != 16:
                fail(f"chaos skipped {skipped}, {steps_run['chaos']} steps; resumed at "
                     f"{resume_at}")
            if not all(verdict.values()):
                fail(f"the chaos or resumed run differs from the clean run: {verdict}")
            want = {"lars_update": 2 * total, "ls_xent_fwd": total, "ls_xent_bwd": total,
                    "flash_attn": 0, "flash_attn_f32": 0, "flash_attn_bwd": 0,
                    "flash_attn_bwd_f32": 0, **bn_launches(53 * total),
                    **guard_launches(total)}
            if counts != want:
                fail(f"supervised launches {counts}, want {want}")

            # telemetry: the JSONL and the Chrome trace, read back
            recs = read_run(obs.metrics_path)
            phases = [r for r in recs if r.get("metric") == "step_phases"]
            cover = [sum(r["phases"].values()) / r["wall_s"] for r in phases]
            trace = json.load(open(obs.trace_path))["traceEvents"]
            span_ms = {name: 1e3 * statistics.median(r["phases"][name] for r in phases)
                       for name in phases[0]["phases"]}
            span_ms["step"] = 1e3 * statistics.median(r["wall_s"] for r in phases)
            print(f"supervised telemetry ({card}): {len(recs)} JSONL rows, {len(phases)} "
                  f"step_phases rows, phases / wall_s {min(cover):.4f}-{max(cover):.4f}, "
                  f"{len(trace)} trace events; span medians ms "
                  + json.dumps({k: round(v, 4) for k, v in span_ms.items()})
                  + "; each step's wall / dispatch / checkpoint ms "
                  + json.dumps([[r["step"], round(1e3 * r["wall_s"], 2),
                                 round(1e3 * r["phases"]["dispatch"], 2),
                                 round(1e3 * r["phases"]["checkpoint"], 2)] for r in phases]))
            if len(phases) != 12 or not all(0.9 <= c <= 1.02 for c in cover):
                fail("the clean run's step phases do not cover its steps' wall time")
            if sum(e["name"] == "step" for e in trace) != 12:
                fail("the Chrome trace does not hold the clean run's 12 steps")

            # the profiler window: the kernels on the device's timeline
            prof = json.load(open(tmp / "prof" / "torch_trace_rank0.json"))["traceEvents"]
            kernels = [e["name"] for e in prof if e.get("cat") == "kernel"]
            named = {k: sum(k in n for n in kernels) for k in (
                "lars_norms_kernel", "lars_apply_kernel", "ls_xent_fwd_kernel",
                "ls_xent_bwd_kernel")}
            print(f"supervised torch_profile ({card}): 2 steps, {len(kernels)} kernel "
                  f"events, the port's kernels named {named}")
            if any(v != 2 for v in named.values()):
                fail(f"the profiler trace names the port's kernels {named}, want 2 each")

            # the checkpoint layer at full width
            ck = tmp / "timing"
            t0 = time.perf_counter()
            payload = checkpoint._payload_of(clean)
            snap_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            checkpoint._manifest_of(payload, clean.step, "probe", None)
            crc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            path = checkpoint.save(str(ck), clean)
            save_s = time.perf_counter() - t0
            writer = checkpoint.AsyncCheckpointWriter()
            t0 = time.perf_counter()
            writer.save(str(ck / "async"), clean)
            async_s = time.perf_counter() - t0
            if not writer.flush(300):
                fail("the async writer did not commit within 300 s")
            writer.close()
            t0 = time.perf_counter()
            manifest = checkpoint.validate(path, like=clean)
            validate_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = checkpoint.restore(path, clean)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            host_like = TrainState.create({k: torch.empty(v.shape)
                                           for k, v in clean.params.items()})
            t0 = time.perf_counter()
            host = checkpoint.restore(path, host_like)
            host_restore_s = time.perf_counter() - t0
            nbytes = sum(leaf["nbytes"] for leaf in manifest["leaves"].values())
            host_same = all(torch.equal(host.params[k], clean.params[k].cpu()) and torch.equal(
                host.opt_state["momentum"][k], clean.opt_state["momentum"][k].cpu())
                for k in clean.params)
            print(f"supervised checkpoint ({card}): {nbytes} B in {len(manifest['leaves'])} "
                  f"leaves ({os.path.getsize(path)} B npz); snapshot to host "
                  f"{1e3 * snap_s:.2f} ms, CRC32 {1e3 * crc_s:.2f} ms, sync save "
                  f"{1e3 * save_s:.2f} ms, async writer's save (what a step pays) "
                  f"{1e3 * async_s:.2f} ms, validate {1e3 * validate_s:.2f} ms, restore "
                  f"on the card {1e3 * restore_s:.2f} ms, on the host "
                  f"{1e3 * host_restore_s:.2f} ms; host restore equals the card's state: "
                  f"{host_same}; restore on the card equals: {same(back, clean)}")
            if not (host_same and same(back, clean) and host.step == clean.step == 12):
                fail("a checkpoint written on the card does not restore as it was")
            if nbytes != 2 * 102_228_128 + 12:
                fail(f"checkpoint payload {nbytes} B, want 2 x 102,228,128 + 12")
            out.update(counts=counts, steps=steps_run, recoveries=rec,
                       span_ms=span_ms, checkpoint_bytes=nbytes,
                       snapshot_ms=1e3 * snap_s, crc_ms=1e3 * crc_s, save_ms=1e3 * save_s,
                       async_save_ms=1e3 * async_s, validate_ms=1e3 * validate_s,
                       restore_ms=1e3 * restore_s, host_restore_ms=1e3 * host_restore_s)
            del payload, back, host, host_like
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    return out


def dryrun_phase() -> dict:
    """``DRYRUN_COMBOS`` through ``python -m repro_torch.launch.dryrun``, one
    subprocess each (the fake process group cannot share a process with the
    NCCL one), the card hidden from them: meta tensors, no kernel; beside
    them, in one more, ``perf.card_step``'s count of the remat training
    step. All run at once. Then ``python -m
    repro_torch.launch.cost_extrapolate`` on Qwen3-1.7B's ``train_4k``
    artifact, whose fitted FLOPs must equal the full count within
    ``LINEAR_RTOL``. Fails on a non-zero exit; returns and prints each
    one's numbers, and the card step's record under "roofline"."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = {(arch, shape, flags): subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
             "--shape", shape, "--out", d, *flags],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for arch, shape, flags in DRYRUN_COMBOS}
        procs["roofline"] = subprocess.Popen(
            [sys.executable, "-c", "import json; from repro_torch.launch import perf; "
             f"print(json.dumps(perf.card_step({LM_ARCH!r}, {ROOFLINE_BATCH}, {LM_SEQ})))"],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        done = {}
        try:
            for key, proc in procs.items():
                done[key] = proc.communicate(timeout=600)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        wall = time.perf_counter() - t0
        for key, proc in procs.items():
            if proc.returncode != 0:
                fail(f"dry run {key} exited {proc.returncode}:\n{done[key][1][-3000:]}")
        for arch, shape, flags in DRYRUN_COMBOS:
            mesh = "pod2x16x16" if "--multi-pod" in flags else "pod16x16"
            r = json.loads((Path(d) / f"{arch}__{shape}__{mesh}.json").read_text())
            audit = r["bucket_audit"] or {}
            out[f"{arch} {shape} {mesh}"] = {
                "chips": r["chips"], "exchanges": audit.get("num_exchanges"),
                "expected_exchanges": r["expected_exchanges"],
                "collective_bytes": r["collectives"]["total_bytes"],
                "collective_count": r["collectives"]["total_count"],
                "flops": r["cost"]["flops"], "bytes_accessed": r["cost"]["bytes_accessed"],
                "gathered": r["gathered"], "build_s": r["lower_s"], "run_s": r["run_s"]}
            print(f"dry run {arch} {shape} on {mesh} ({r['chips']} ranks, fake group, meta "
                  f"tensors): exchanges {audit.get('num_exchanges')} (schedule "
                  f"{r['expected_exchanges']}), {r['collectives']['total_count']} collectives, "
                  f"{r['collectives']['total_bytes']} B a rank, {r['cost']['flops']:.4e} FLOPs "
                  f"and {r['cost']['bytes_accessed']:.4e} bytes accessed a rank, held whole "
                  f"{r['gathered']}, build {r['lower_s']} s, step {r['run_s']} s (host clock)")
        print(f"dry run: {len(DRYRUN_COMBOS)} combinations and the card step's count at "
              f"once in {wall:.1f} s (host clock)")
        out["roofline"] = json.loads(done["roofline"][0].strip().splitlines()[-1])

        t0 = time.perf_counter()
        arch, shape, _ = DRYRUN_COMBOS[0]
        ce = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.cost_extrapolate", "--dir", d,
             "--only", arch], env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        if ce.returncode != 0:
            fail(f"cost_extrapolate exited {ce.returncode}:\n{ce.stderr[-3000:]}")
        r = json.loads((Path(d) / f"{arch}__{shape}__pod16x16.json").read_text())
        ct = r["cost_true"]
        rel = ct["flops"] / r["cost"]["flops"] - 1
        out["linearity"] = {"combination": f"{arch} {shape} pod16x16", "n_blocks": ct["n_blocks"],
                            "flops": r["cost"]["flops"], "fit_flops": ct["flops"],
                            "rel_diff": ct["linear"]["rel_diff"],
                            "wall_s": time.perf_counter() - t0}
        print(f"cost_extrapolate {arch} {shape}: fit from 1 and 2 blocks to {ct['n_blocks']}: "
              f"{ct['flops']:.6e} FLOPs against the full count's {r['cost']['flops']:.6e} "
              f"({rel:+.2e}; tol {LINEAR_RTOL:g}); collective bytes "
              f"{ct['linear']['rel_diff']['coll_total']:+.2e}, bytes accessed "
              f"{ct['linear']['rel_diff']['bytes_accessed']:+.2e} (reported)")
        if not abs(rel) <= LINEAR_RTOL:
            fail(f"cost_extrapolate: the fit's FLOPs are {rel:+.2e} off the full count")
    return out


def roofline(rec: dict, remat: dict, card: str) -> dict:
    """``perf.card_step``'s record of the remat step beside its measured
    median on the card: fails if either count is 0 or if its roofline,
    the larger of compute_s and memory_s, exceeds the measured step (no
    card beats its own roofline: the count would be wrong)."""
    st = remat["stages"][0]
    if st["global_batch"] != ROOFLINE_BATCH:
        fail(f"the remat run's first stage is {st['global_batch']} x {LM_SEQ}, the roofline's "
             f"{ROOFLINE_BATCH} x {LM_SEQ}")
    measured = st["steady_median_ms"] / 1e3
    row = {k: rec[k] for k in ("flops", "bytes_accessed", "compute_s", "memory_s",
                               "attention_bytes_share", "temp_gib", "argument_gib",
                               "kernel_bytes", "dominant")}
    row.update(measured_s=measured, compute_share=rec["compute_s"] / measured,
               memory_share=rec["memory_s"] / measured,
               meta_gib=rec["temp_gib"] + rec["argument_gib"], peak_gib=remat["peak_gib"],
               card=card)
    print(f"roofline {LM_ARCH} remat {ROOFLINE_BATCH} x {LM_SEQ}, one rank: "
          f"{rec['flops']:.6e} FLOPs, {rec['bytes_accessed']:.6e} bytes accessed (eager, op by "
          f"op; the flash kernels' share {rec['attention_bytes_share']:.4f}); compute_s "
          f"{rec['compute_s'] * 1e3:.2f} ms, memory_s {rec['memory_s'] * 1e3:.2f} ms at the "
          f"H100 SXM's 989.4 TFLOP/s and 3.35 TB/s; measured median {measured * 1e3:.2f} ms: "
          f"compute_s/measured {row['compute_share']:.4f}, memory_s/measured "
          f"{row['memory_share']:.4f}; meta temp + arguments {row['meta_gib']:.2f} GiB, "
          f"max_memory_allocated {remat['peak_gib']:.2f} GiB ({card})")
    if not (rec["flops"] > 0 and rec["bytes_accessed"] > 0):
        fail(f"roofline: {rec['flops']} FLOPs, {rec['bytes_accessed']} bytes counted")
    if max(rec["compute_s"], rec["memory_s"]) > measured:
        fail(f"roofline: max(compute_s, memory_s) = "
             f"{max(rec['compute_s'], rec['memory_s']) * 1e3:.2f} ms exceeds the measured "
             f"{measured * 1e3:.2f} ms: the count is wrong")
    return row


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
    from repro_torch.data.synthetic import SyntheticImageNet
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.lars_update import lars_update_cuda
    from repro_torch.kernels.ls_xent import ls_xent_bwd_cuda, ls_xent_fwd_cuda
    from repro_torch.launch import profile_step, profile_trainer, profile_xent
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
    model, data_fn, loss_fn, plan = profile_trainer.resnet50_path(dev)
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

    bn_err = check_bn(torch, gen)
    guard_err = check_guard(torch, gen)
    flash_err = check_flash(torch, dev, gen)
    t0 = time.perf_counter()
    flash_bwd_err = check_flash_bwd(torch, gen)
    repeat_flash_bwd(torch, gen)
    print(f"phase check flash_attn_bwd: {time.perf_counter() - t0:.1f} s")

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

    bn_time = time_bn(torch, gen)
    guard_time = time_guard(torch, gen)
    t0 = time.perf_counter()
    flash_time = time_flash(torch, gen)
    print(f"phase time flash (forward and backward): {time.perf_counter() - t0:.1f} s")

    # -- NCCL at one rank, and the grid the main path syncs over -------------
    grid = nccl_one_rank(torch, dev, store_dir)

    # -- the main path: full-width ResNet-50 over two batch stages ------------
    sync = profile_step.SYNC
    layout = grad_sync.bucket_layout(dict(model.named_parameters()), sync)
    sizes = {g: [b["nbytes"] for b in layout if b["group"] == g] for g in ("comm", "fp32")}
    print(f"grad sync: {sync.strategy} ({sync.lowering}), {len(layout)} exchanges, "
          f"bf16 {len(sizes['comm'])} buckets {sum(sizes['comm'])} B, fp32 "
          f"{len(sizes['fp32'])} {sum(sizes['fp32'])} B; first bucket "
          f"{layout[0]['paths'][:3]}")
    if (len(layout), sum(sizes["comm"]), sum(sizes["fp32"])) != (11, 51_005_824, 216_480):
        fail("the ResNet-50 bucket layout is not 11 exchanges of 51,005,824 + 216,480 B")

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
    history = [h for h in history if h["kind"] == "metric"]
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
            "flash_attn": 0, "flash_attn_f32": 0, "flash_attn_bwd": 0,
            "flash_attn_bwd_f32": 0, **bn_launches(53 * steps),
            **guard_launches(steps)}
    if counts != want:
        fail(f"launch counts {counts}, want {want}")
    for st in profile_trainer.stage_medians(plan, history):
        print(f"stage gb {st['global_batch']}: step ms "
              f"{[round(w, 2) for w in st['step_ms']]}, steady median (first step "
              f"excluded) {st['steady_median_ms']:.2f} ms ({card})")

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
    print(f"telemetry a step of Trainer.run (six spans, five instruments, no sink; host "
          f"clock, mean of 2000): {telemetry_cost_us():.2f} us ({card})")
    del holder, batch, grads
    ops.reset_launch_counts()

    # -- the supervised trainer: chaos, resume, checkpoints, telemetry -------
    sup = supervised(torch, grid, model, data_fn, loss_fn, plan, sync, card)
    del state

    # -- the serve paths: five archs at full width, one at a time -------------
    served = {}
    for arch in SERVE_ARCHS:
        served[arch] = serve(torch, dev, arch)
        gc.collect()                       # the phase's model goes before the next
        torch.cuda.empty_cache()

    # -- the LM training path: full-width Qwen3-1.7B ---------------------------
    t0 = time.perf_counter()
    lm = train_lm(torch, dev, grid, card)
    print(f"phase train {LM_ARCH}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_remat = [train_lm(torch, dev, grid, card, stages=(b,), remat=True)
                for b in (ROOFLINE_BATCH, LM_REMAT_MAX_BATCH)]
    at4 = next(st for st in lm["stages"] if st["global_batch"] == 4)
    for r in lm_remat:
        st = r["stages"][0]
        print(f"train {LM_ARCH} remat at {st['global_batch']} x {LM_SEQ}: "
              f"{st['steady_median_ms']:.2f} ms a step, {st['tokens_per_s']:.0f} tokens/s, "
              f"peak {r['peak_gib']:.2f} GiB; without remat at 4 x {LM_SEQ}: "
              f"{at4['steady_median_ms']:.2f} ms, {at4['tokens_per_s']:.0f} tokens/s, peak "
              f"{lm['peak_gib']:.2f} GiB (the run's, both stages) ({card})")
    print(f"phase train {LM_ARCH} remat: {time.perf_counter() - t0:.1f} s")

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
    with unittest.mock.patch.object(grad_sync, "sync_tree",
                                    lambda g, grid, cfg, groups=None: g):
        unsynced, unsynced_losses = tiny_run("cuda")
    same = (unsynced_losses == tlosses["cuda"]
            and all(torch.equal(unsynced[k], v) for k, v in finals["cuda"].items()))
    print(f"tiny resnet on the card through sync_tree (fp32 comm, 1 rank) vs without it: "
          f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("the fp32 sync at one rank changed the tiny ResNet's run")
    f32_launches = smoke_card_vs_host(torch)
    t0 = time.perf_counter()
    bwd_f32_launches = smoke_train_card_vs_host(torch, grid)
    print(f"phase smoke train steps, card vs host: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    checkpoint_round_trip(torch)
    print(f"phase smoke checkpoints, stacked, on the card: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dry = dryrun_phase()
    roof = roofline(dry.pop("roofline"), lm_remat[0], card)
    print(f"phase dry run, cost_extrapolate and the roofline: {time.perf_counter() - t0:.1f} s")

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
        # the backward has no TPU kernel: the forward's gradient, which the
        # reference takes by autodiff of its plain attention
        "flash_attn_bwd": ("cuda", "src/repro_torch/csrc/flash_attn_bwd.cu",
                           "src/repro/kernels/flash_attn.py:34", flash_bwd_err["bf16"][0]),
        "flash_attn_bwd_f32": ("cuda", "src/repro_torch/csrc/flash_attn_bwd_f32.cu",
                               "src/repro/kernels/flash_attn.py:34", flash_bwd_err["fp32"][0]),
        # the four BN kernels as one row: no TPU kernel, XLA fuses the JAX
        # package's BN (src/repro/nn/layers.py:batchnorm)
        "batchnorm": ("cuda", "src/repro_torch/csrc/batchnorm.cu", "none",
                      bn_err["max_abs_err"]),
        # the guard's two kernels as one row: no TPU kernel, XLA fuses the
        # JAX package's guard (src/repro/train/trainer.py:make_train_step)
        "guard": ("cuda", "src/repro_torch/csrc/guard.cu", "none", guard_err["max_abs_err"]),
    }
    main_rows = plan.stages[-1].global_batch
    measured = {"lars_update": timing["lars_update"],
                **xent_times[main_rows, 1000, torch.float32], **flash_time,
                "batchnorm": bn_time, "guard": guard_time}
    # ls_xent also at Qwen3-1.7B's logits, beside its main-path entry
    xent_lm = {}
    for (rows, vocab, dtype), pair in xent_times.items():
        if vocab != 1000:
            for name, t in pair.items():
                xent_lm.setdefault(name, {})[str(dtype)[6:]] = {
                    k: t[k] for k in ("ms", "bound_ms", "plain_ms", "library_ms",
                                      "library_fwd_bwd_ms", "at") if k in t}
    # each kernel's launches on its own main paths: ResNet training (the main
    # phase and the supervised phase, replayed steps included), serving the
    # five full-width archs in bf16, or the fp32 smoke configs' prefills
    by_path = {name: {"resnet50": counts[name], "supervised": sup["counts"][name]}
               for name in ("lars_update", "ls_xent_fwd", "ls_xent_bwd")}
    by_path["batchnorm"] = {"resnet50": sum(counts[k] for k in BN_KERNELS),
                            "supervised": sum(sup["counts"][k] for k in BN_KERNELS)}
    remat_runs = {f"{LM_ARCH} training remat {r['stages'][0]['global_batch']} x {LM_SEQ}": r
                  for r in lm_remat}
    by_path["guard"] = {"resnet50": sum(counts[k] for k in GUARD_KERNELS),
                        "supervised": sum(sup["counts"][k] for k in GUARD_KERNELS),
                        f"{LM_ARCH} training": sum(lm["counts"][k] for k in GUARD_KERNELS),
                        **{k: sum(r["counts"][g] for g in GUARD_KERNELS)
                           for k, r in remat_runs.items()}}
    for name in ("lars_update", "ls_xent_fwd", "ls_xent_bwd"):
        by_path[name][f"{LM_ARCH} training"] = lm["counts"][name]
        by_path[name].update((k, r["counts"][name]) for k, r in remat_runs.items())
    by_path["flash_attn"] = {arch: r["counts"]["flash_attn"] for arch, r in served.items()}
    by_path["flash_attn"][f"{LM_ARCH} training"] = lm["counts"]["flash_attn"]
    by_path["flash_attn_bwd"] = {f"{LM_ARCH} training": lm["counts"]["flash_attn_bwd"]}
    for name in ("flash_attn", "flash_attn_bwd"):
        by_path[name].update((k, r["counts"][name]) for k, r in remat_runs.items())
    launches = {**{name: sum(v.values()) for name, v in by_path.items()},
                "flash_attn_f32": f32_launches, "flash_attn_bwd_f32": bwd_f32_launches}
    # the flash checks' worst err/tol over their shapes, by kernel
    check_ratio = {"flash_attn": flash_err["bf16"][1], "flash_attn_f32": flash_err["fp32"][1],
                   "batchnorm": max(bn_err["stats"], bn_err["bwd_sums"]),
                   "flash_attn_bwd": flash_bwd_err["bf16"][1],
                   "flash_attn_bwd_f32": flash_bwd_err["fp32"][1]}
    norm_ratio = {"flash_attn_bwd": flash_bwd_err["bf16"][2],
                  "flash_attn_bwd_f32": flash_bwd_err["fp32"][2]}
    kernels = []
    for name, (route, src, replaces, err) in sources.items():
        t = measured[name]
        # flash: profile_flash's bound for the inputs' type (fp32: 3xTF32)
        bound_ms, bound_by = ((t["bound_ms"], t["bound_by"]) if "bound_ms" in t
                              else bound(t["bytes"], t["flops"], FP32_FLOPS_PER_S))
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": replaces,
            "launches": launches[name],
            **({"launches_by_path": by_path[name]} if name in by_path else {}),
            "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            **{k: t[k] for k in ("fma_bound_ms", "tflops_per_s", "library_fwd_bwd_ms",
                                 "chain_ms", "prefill", "train", "serve", "unscale_ms",
                                 "commit_finite_ms", "commit_skipped_ms", "host_us",
                                 "plain_host_us", "lm") if k in t},
            **({"lm": xent_lm[name]} if name in xent_lm else {}),
            **({"worst_err_over_tol": check_ratio[name]} if name in check_ratio else {}),
            **({"worst_norm_over_limit": norm_ratio[name]} if name in norm_ratio else {}),
            "rate": t.get("rate", "fp32 67 TFLOP/s, HBM 3.35 TB/s"),
            "at": t["at"],
        })
    print(json.dumps({"serve": {arch: {k: v for k, v in r.items() if k != "counts"}
                                for arch, r in served.items()}, "card": card}))
    print(json.dumps({"supervised": {k: v for k, v in sup.items() if k != "counts"},
                      "card": card}))
    print(json.dumps({"train_lm": {LM_ARCH: {k: v for k, v in lm.items() if k != "counts"},
                                   **{k: {x: v for x, v in r.items() if x != "counts"}
                                      for k, r in remat_runs.items()}},
                      "card": card}))
    print(json.dumps({"dryrun": dry, "roofline": roof, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
