"""Where a training step of the PyTorch port spends its time on one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_step \
        [--steps 3] [--warmup 3] [--out step_profile.json]

Trains full-width ResNet-50 at 224 px through the port's ``make_train_step``
at each per-step batch of the two-stage plan that ``chip_smoke.py`` runs (32
and 64 images), on one rank (the 1 x 1 grid, so the gradient sync casts the
bf16 buckets and exchanges nothing), and reports for each batch:

- step wall time (host clock around a step that ends in a synchronise),
  and the same split into forward, forward+backward, the gradient sync
  (``core/grad_sync.py:sync_tree`` with ``SYNC``) and the LARS update, each
  timed alone between synchronises;
- from ``torch.profiler`` over ``--steps`` steady steps: the device busy
  share (summed kernel time over wall time; one stream, so kernels do not
  overlap), kernel launches per step, and device time by kernel class.

Prints the result per batch and, with ``--out``, writes it all as JSON.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import grad_sync, lars, losses
from repro_torch.core.topology import TorusGrid
from repro_torch.data import augment
from repro_torch.data.synthetic import SyntheticImageNet, generator
from repro_torch.models import resnet
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import TrainerConfig, make_train_step

# the main path's gradient sync: the paper's 2D torus, bf16 buckets of 4 MiB
SYNC = grad_sync.GradSyncConfig(strategy="torus2d", comm_dtype=torch.bfloat16,
                                bucket_bytes=4 << 20)

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("port: lars_update", ("lars_norms_kernel", "lars_apply_kernel")),
    ("port: ls_xent", ("ls_xent_",)),
    ("port: flash_attn", ("flash_tc_kernel", "flash_fwd_kernel")),
    ("convolution / matmul", ("conv", "gemm", "xmma", "cutlass", "wgrad", "dgrad",
                              "implicit", "sm90_", "cudnn", "nhwc", "nchw", "nvjet")),
    ("sort / scan", ("radix", "sort", "scan")),
    ("reduction", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy",
                     "fill", "cat", "index", "gather", "scatter", "pool",
                     "max_pool")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


def device_time(prof) -> tuple[dict[str, float], int, list]:
    """(device ms by kernel class, kernel launches, [(ms, count, name)]
    sorted by time) over a ``torch.profiler`` window."""
    by_class: dict[str, float] = {}
    launches = 0
    top = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += ev.count
        cls = classify(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, ev.count, ev.key[:90]))
    top.sort(reverse=True)
    return by_class, launches, top


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def timed(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def kernel_launches(fn) -> int:
    """CUDA kernels that one ``fn()`` launches, counted by torch.profiler."""
    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_time(prof)[1]


def sync_split(grads: dict, grid: TorusGrid, cfg=SYNC, reps: int = 5) -> dict:
    """``sync_tree`` of ``grads`` alone: wall ms (host clock between
    synchronises, median of ``reps``) and kernel launches."""
    def fn():
        grad_sync.sync_tree(grads, grid, cfg)
    walls = timed(fn, reps)
    return {"wall_ms": statistics.median(walls), "wall_ms_runs": walls,
            "launches": kernel_launches(fn)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    card = gpu_line()
    dev = torch.device("cuda")
    cfg = resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224)
    model = resnet.init(cfg, seed=0)
    data = SyntheticImageNet(num_classes=1000, image_size=224, seed=0, device=dev)
    tcfg = TrainerConfig(schedule="B", grad_sync=SYNC)
    grid = TorusGrid()

    def loss_fn(params, batch, grid=grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=params, grid=grid)
        return losses.label_smoothing_xent(logits, labels, 0.1), torch.zeros((), device=dev)

    step = make_train_step(loss_fn, tcfg, grid)
    result = {"gpu": card, "torch": torch.__version__, "batches": {}}
    for gb in (32, 64):
        images, labels = data.batch(0, gb)
        batch = (augment.augment(generator(dev, 1, 0), images, (224, 224)), labels)
        state = TrainState.create(dict(model.named_parameters()))
        holder = {"state": state}

        def one_step():
            holder["state"], m = step(holder["state"], batch, 0.5, gb)
            int(m["skipped"])

        def fwd():
            with torch.no_grad():
                loss_fn(holder["state"].params, batch)

        def fwd_bwd():
            params = {k: p.detach().requires_grad_(True)
                      for k, p in holder["state"].params.items()}
            loss, _ = loss_fn(params, batch)
            torch.autograd.grad(loss, list(params.values()))

        grads = {k: torch.randn_like(p) * 1e-3 for k, p in state.params.items()}

        def lars_only():
            lars.update(holder["state"].params, grads, holder["state"].opt_state,
                        lr=1.0, momentum=0.9, cfg=tcfg.lars)

        timed(one_step, args.warmup)
        def sync_only():
            grad_sync.sync_tree(grads, grid, SYNC)

        walls = {name: timed(fn, 5) for name, fn in
                 (("step", one_step), ("forward", fwd), ("forward_backward", fwd_bwd),
                  ("grad_sync", sync_only), ("lars_update", lars_only))}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                one_step()
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
        by_class, launches, top = device_time(prof)
        busy_ms = sum(by_class.values())
        result["batches"][gb] = {
            "wall_ms_median": {k: statistics.median(v) for k, v in walls.items()},
            "wall_ms_runs": walls,
            "profiled_steps": args.steps,
            "profiled_window_ms": window_ms,
            "device_busy_ms_per_step": busy_ms / args.steps,
            "device_busy_share": busy_ms / window_ms if window_ms else None,
            "kernel_launches_per_step": launches / args.steps,
            "grad_sync_launches": kernel_launches(sync_only),
            "device_ms_per_step_by_class": {k: v / args.steps for k, v in
                                            sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [(round(ms / args.steps, 4), n // args.steps, k)
                                        for ms, n, k in top[:12]],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        print(json.dumps({gb: result["batches"][gb]}, indent=1))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
