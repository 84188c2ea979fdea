"""End-to-end run of the PyTorch port: train a ~100M-param qwen3-family
LM with the paper's distributed recipe (2D-torus grad sync with
``fuse=False`` bf16 comm, LARS, label smoothing, batch-size control)
(``examples/train_lm_100m.py``).

    PYTHONPATH=src torchrun --nproc_per_node 8 examples/pt_train_lm_100m.py --device cpu
    PYTHONPATH=src torchrun --nproc_per_node <cards> examples/pt_train_lm_100m.py

One process a rank: gloo on the CPU, NCCL on cards (rank r on card
``LOCAL_RANK``). The ranks form the paper's grid over the world; each
holds a replica and trains on its rows of the global batch (1 sequence a
rank, then 2, over 2.0 epochs of 2048 sequences a rank). On 8 CPU ranks
this takes a while: ``--steps 4 --seq 64`` for a quick pass. Checkpoints
land in ``--checkpoint-dir`` when one is given.
"""

import argparse
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.core import topology
from repro_torch.core.batch_control import build_plan
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.launch import train as launch_train


def lm_100m():
    """qwen3 family scaled to ~100M params (8L, d=512, vocab 32k)."""
    base = registry.get("qwen3-1.7b")
    return dataclasses.replace(
        base, name="qwen3-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=4, head_dim=64, d_ff=1536, vocab=32_000)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: the card")
    args = ap.parse_args()

    if args.device is None and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = device_lib.resolve(args.device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(minutes=5))
    try:
        grid = topology.world_grid()
        cfg = lm_100m()
        run = launch_train.build(cfg.name, cfg=cfg, seq=args.seq, batch_stages=(1, 2),
                                 steps=args.steps, device=dev, grid=grid,
                                 checkpoint_dir=args.checkpoint_dir)
        # the reference's stages: 0.5 epoch at 1 a rank, then 1.5 at 2, of
        # 2048 sequences a rank
        run.trainer.plan = build_plan(
            BatchSchedule((BatchStage(0, 0.5, 1), BatchStage(0.5, 2.0, 2))),
            dataset_size=grid.size * 2048, n_workers=grid.size, max_steps=args.steps)
        log = print if grid.world.index == 0 else (lambda s: None)
        log(f"arch {cfg.name}: {cfg.num_params() / 1e6:.1f}M params, {grid.size} ranks on a "
            f"{grid.y}x{grid.x} grid ({dev.type}), plan {run.trainer.plan.total_steps} steps")
        state, history = run.trainer.run(run.state, log=log)
        rows = [h for h in history if h["kind"] == "metric"]
        log(f"loss {rows[0]['loss']:.3f} -> {rows[-1]['loss']:.3f} over {state.step} steps")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
