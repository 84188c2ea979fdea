"""Where the serve path of the PyTorch port spends its time on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_serve \
        [--arch qwen3-1.7b] [--out serve_profile.json]

Serves an arch of the registry at full width (random weights, seed 0;
qwen3-1.7b unless ``--arch`` names another: granite-moe-3b-a800m,
mamba2-2.7b and recurrentgemma-9b fit one H100 whole, llama-3.2-vision-90b
with its depth cut to ``DEPTH_CUTS``, llama3-405b and kimi-k2-1t-a32b not
at all) on the serve shape defined here and driven by ``chip_smoke.py``'s
serve phases: 8 prompts of ``PROMPT_LENS`` tokens left-padded to 2048 (and,
for the VLM, a vision input from ``vision_input``), then one-token decode
steps over the 2048 + 32-slot cache (an SSD or RG-LRU layer's is its state,
a cross layer's the vision tokens' k/v). For the prefill and for a decode
step it reports:

- wall time (host clock around work that ends in a synchronise), median of
  ``STEPS`` runs after ``WARMUP``;
- from ``torch.profiler`` over the same work: the device busy share
  (summed kernel time over wall time; one stream, so kernels do not
  overlap), kernel launches, and device time by kernel class.

Prints the result and, with ``--out``, writes it as JSON. Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.launch.profile_step import device_time, gpu_line
from repro_torch.models import transformer as T
from repro_torch.serve import decode

# the serve shape: 8 requests of 512-2048 random tokens, left-padded to SEQ,
# NEW tokens generated each; chip_smoke.py serves the same
PROMPT_LENS = (512, 731, 950, 1170, 1389, 1609, 1828, 2048)
SEQ, NEW = 2048, 32
BATCH = len(PROMPT_LENS)
# runs timed (then as many profiled) after WARMUP; the decode steps of both
# phases, WARMUP + 2 * STEPS, fit in the NEW cache slots past the prompt
STEPS, WARMUP = 8, 2
# arch -> layers served: llama-3.2-vision-90b's 100 layers (87.6 B params)
# do not fit one card; 5 layers, one pattern cycle (4 self-attention, 1
# cross), hold 6.38 B params, ~38 GB with their bf16 copies
DEPTH_CUTS = {"llama-3.2-vision-90b": 5}


def serve_config(arch: str) -> T.ArchConfig:
    """The full-width config of ``arch`` as served on one card: its depth
    cut to ``DEPTH_CUTS`` where the whole model does not fit."""
    cfg = registry.get(arch)
    if arch in DEPTH_CUTS:
        cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUTS[arch])
    return cfg


def vision_input(cfg: T.ArchConfig, batch: int, device=None, seed: int = 0):
    """The stub vision tower's output that the cross layers read, (batch,
    vision_tokens, cross_kv_dim) bf16, from a generator seeded ``seed`` on
    ``device``; None for a model without cross layers."""
    if not cfg.vision_tokens:
        return None
    gen = torch.Generator(device=device_lib.resolve(device)).manual_seed(seed)
    return torch.randn(batch, cfg.vision_tokens, cfg.cross_kv_dim, generator=gen,
                       device=gen.device).to(torch.bfloat16)


def _measure(fn, n: int) -> dict:
    """Wall ms of ``fn`` n times, then the same n under the profiler."""
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    by_class, launches, top = device_time(prof)
    busy = sum(by_class.values())
    return {
        "wall_ms_median": statistics.median(walls), "wall_ms_runs": walls,
        "profiled_window_ms_per_run": window_ms / n,
        "device_busy_ms_per_run": busy / n,
        "device_busy_share": busy / window_ms,
        "kernel_launches_per_run": launches / n,
        "device_ms_per_run_by_class": {k: v / n for k, v in
                                       sorted(by_class.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_run": [(round(ms / n, 4), c // n, k) for ms, c, k in top[:10]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=registry.ARCH_IDS)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    cfg = serve_config(args.arch)
    model = T.init(cfg, seed=0)
    vision = vision_input(cfg, BATCH)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, n).tolist() for n in PROMPT_LENS]
    tokens, _, _ = decode.RequestBatcher(batch_size=BATCH, seq_len=SEQ).pack(prompts)
    cut = f", {cfg.n_layers} layers" if args.arch in DEPTH_CUTS else ""
    result = {"gpu": card, "torch": torch.__version__,
              "at": f"{cfg.name}{cut}, {BATCH} x {SEQ} prompt tokens"}
    with torch.inference_mode():
        params = T.compute_params(model, cfg.compute_dtype)

        def prefill():
            return T.prefill(params, tokens, cfg, vision=vision, cache_len=SEQ + NEW)

        for _ in range(WARMUP):
            prefill()
        result["prefill"] = _measure(prefill, STEPS)
        logits, cache = prefill()
        step = decode.make_serve_step(cfg)
        state = {"tok": torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None],
                 "index": SEQ}

        def one_step():
            state["tok"], _, _ = step(params, state["tok"], cache, state["index"])
            state["index"] += 1

        for _ in range(WARMUP):
            one_step()
        result["decode_step"] = _measure(one_step, STEPS)
    result["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(result, indent=1))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
