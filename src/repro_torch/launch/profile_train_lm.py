"""Where the LM training step of the PyTorch port spends its time on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_train_lm \
        [--arch qwen3-1.7b] [--seq 2048] [--out train_lm_profile.json]

Builds the training run of ``repro_torch.launch.train.build`` at full width
(random weights, seed 0; bf16 compute over fp32 masters, torus2d
``fuse=False`` bf16 comm, LARS over the reference's stacked leaves, label
smoothing 0.1, schedule B) on an NCCL process group of one rank, and for
each batch size of ``STAGES`` (sequences of ``--seq`` tokens) times its
``make_train_step``: wall ms (host clock around a step that ends in a
synchronise; the median of ``STEPS`` after one warm-up step, with their
min and max) and, from ``torch.profiler`` over as many steps, the device
busy share (summed kernel time over the window's wall time), kernel
launches, and device ms by kernel class: matmul, flash forward, flash
backward, ls_xent, LARS, sync (NCCL) and elementwise (every other kernel:
norms, RoPE, casts, the SwiGLU, the embedding's gather and scatter), and
the 15 kernels that take the most time. Also the step's peak device
memory and tokens/s. Prints the result and, with ``--out``, writes it as
JSON beside the card's name and power limit. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import topology
from repro_torch.launch import train as launch_train
from repro_torch.launch.profile_step import gpu_line
from repro_torch.train.trainer import make_train_step

STAGES = (2, 4)    # sequences a step: chip_smoke.py's two batch stages
STEPS = 5   # timed steps a stage, and as many under the profiler
# kernel-name fragments -> class, first match wins; the rest is elementwise
CLASSES = (
    ("flash forward", ("flash_tc_kernel", "flash_f32_kernel")),
    ("flash backward", ("dkdv_kernel", "dkdv_tc_kernel", "dkdv_wg_kernel", "dq_kernel",
                        "dq_tc_kernel", "dq_wg_kernel", "dot_kernel", "bwd_prep_kernel")),
    ("ls_xent", ("ls_xent_",)),
    ("lars", ("lars_norms_kernel", "lars_apply_kernel")),
    ("sync", ("nccl",)),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "nvjet", "matmul")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASSES:
        if any(f in low for f in frags):
            return cls
    return "elementwise"


def device_split(prof) -> tuple[dict, dict, int, list]:
    """(device ms by class, launches by class, all launches, [(ms, launches,
    kernel)] by time) over a window."""
    ms, count, top = {}, {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = classify(ev.key)
        ms[cls] = ms.get(cls, 0.0) + dev_us / 1e3
        count[cls] = count.get(cls, 0) + ev.count
        top.append((dev_us / 1e3, ev.count, ev.key[:90]))
    return ms, count, sum(count.values()), sorted(top, reverse=True)


def profile_steps(step_fn, n: int = STEPS) -> dict:
    """Wall ms of ``step_fn`` n times (after one warm-up), then n more under
    the profiler: the split of one step by kernel class."""
    step_fn()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    ms, count, launches, top = device_split(prof)
    busy = sum(ms.values())
    return {"wall_ms_median": statistics.median(walls), "wall_ms_runs": walls,
            "wall_ms_min": min(walls), "wall_ms_max": max(walls),
            "profiled_window_ms_per_step": window_ms / n,
            "device_busy_share": busy / window_ms,
            "kernel_launches_per_step": launches / n,
            "device_ms_per_step_by_class": {k: v / n for k, v in
                                            sorted(ms.items(), key=lambda kv: -kv[1])},
            "launches_per_step_by_class": {k: v / n for k, v in count.items()},
            "top_kernels_ms_per_step": [(round(t / n, 3), c // n, k) for t, c, k in top[:15]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_lm: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    dev = torch.device("cuda")
    result = {"gpu": card, "torch": torch.__version__, "arch": args.arch, "seq": args.seq,
              "stages": []}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1, timeout=datetime.timedelta(minutes=5))
        try:
            grid = topology.select_grid((1,)).build()
            run = launch_train.build(args.arch, seq=args.seq, batch_stages=STAGES,
                                     device=dev, grid=grid)
            step = make_train_step(run.trainer.loss_fn, run.trainer.cfg, grid, run.groups)
            holder = {"state": run.state}
            for gb in STAGES:
                batch = run.trainer.data_fn(0, gb)

                def one_step(batch=batch, gb=gb):
                    holder["state"], _ = step(holder["state"], batch, 0.05, gb)

                torch.cuda.reset_peak_memory_stats()
                t = {"global_batch": gb, "tokens": gb * args.seq, **profile_steps(one_step),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                t["tokens_per_s"] = 1e3 * t["tokens"] / t["wall_ms_median"]
                result["stages"].append(t)
                print(json.dumps(t))
        finally:
            dist.destroy_process_group()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
