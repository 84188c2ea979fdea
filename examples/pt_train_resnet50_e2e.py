"""End-to-end run of the PyTorch port: the paper's exact model (ResNet-50,
25.6M params) trained data-parallel with the complete recipe -- 2D-torus
grad sync in bf16 buckets, synced BN, LARS, label smoothing, batch-size
control, bf16 compute (``examples/train_resnet50_e2e.py``).

    torchrun --nproc_per_node 8 examples/pt_train_resnet50_e2e.py --device cpu
    torchrun --nproc_per_node <cards> examples/pt_train_resnet50_e2e.py

with ``PYTHONPATH=src``. One process a rank: gloo on the CPU, NCCL on
cards (rank r on card r of its node). The ranks form the grid ``--grid``
(Y x X, default the paper's factorization of the world size); each rank
draws the same global batch and trains on its rows. Rank 0 prints the
history and writes it to ``experiments/pt_e2e_resnet50_history.json``.
"""

import argparse
import datetime
import json
import os

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.core import losses, topology
from repro_torch.core.batch_control import build_plan
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data import augment
from repro_torch.data.synthetic import SyntheticImageNet, generator
from repro_torch.models import resnet
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--grid", default=None, help="Y x X, e.g. 2x4")
    ap.add_argument("--device", default=None, help="cpu for gloo; default: the card")
    args = ap.parse_args()

    if args.device is None and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = device_lib.resolve(args.device)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            timeout=datetime.timedelta(minutes=5))
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        sizes = (tuple(int(s) for s in args.grid.split("x")) if args.grid
                 else topology.factorize(world))
        grid = topology.select_grid(sizes).build()
        train(args, dev, grid, rank, world)
    finally:
        dist.destroy_process_group()


def train(args, dev, grid, rank, world):
    cfg = resnet.ResNetConfig.resnet50(num_classes=args.classes, image_size=args.image_size)
    model = resnet.init(cfg, seed=0, device=dev)
    data = SyntheticImageNet(num_classes=args.classes, image_size=args.image_size,
                             noise=1.0, device=dev)

    def data_fn(i, gb):
        """Paper §3.2 augmentation pipeline applied on the device."""
        images, labels = data.batch(i, gb)
        out = (args.image_size, args.image_size)
        return augment.augment(generator(dev, 1, i), images, out), labels

    def loss_fn(params, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=params, grid=grid)
        return (losses.label_smoothing_xent(logits, labels, 0.1),
                torch.zeros((), device=dev))

    # Exp.1-style batch-size control: 2/worker -> 4/worker at 1/3 of run
    sched = BatchSchedule((BatchStage(0, 1.0, 2), BatchStage(1.0, 4.0, 4)))
    plan = build_plan(sched, dataset_size=4096, n_workers=world, max_steps=args.steps)
    trainer = Trainer(
        loss_fn=loss_fn,
        cfg=TrainerConfig(schedule="B", log_every=10,
                          grad_sync=GradSyncConfig(strategy="torus2d",
                                                   comm_dtype=torch.bfloat16)),
        plan=plan, data_fn=data_fn, grid=grid)
    log = print if rank == 0 else (lambda s: None)
    log(f"ResNet-50: {resnet.num_params(model) / 1e6:.1f}M params, {args.image_size}px, "
        f"{world} ranks on a {grid.y}x{grid.x} grid ({dev.type}), "
        f"plan {plan.total_steps} steps")
    state, history = trainer.run(TrainState.create(dict(model.named_parameters())), log=log)
    if rank == 0:
        os.makedirs("experiments", exist_ok=True)
        with open("experiments/pt_e2e_resnet50_history.json", "w") as f:
            json.dump(history, f, indent=1)
        rows = [h for h in history if h["kind"] == "metric"]
        print(f"loss {rows[0]['loss']:.3f} -> {rows[-1]['loss']:.3f} ({state.step} steps)")


if __name__ == "__main__":
    main()
