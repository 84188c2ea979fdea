"""Step times of the port's main training path through ``Trainer.run`` on
one GPU.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_trainer \
        [--repeat 2] [--out trainer.json]

Trains full-width ResNet-50 at 224 px (random weights from seed 0, bf16
compute over fp32 masters, ``SyntheticImageNet`` plus ``augment`` on the
card) over ``chip_smoke.py``'s two-stage plan (8 steps at 32 images, then
4 at 64) through ``Trainer.run``, on an NCCL process group of one rank with
``profile_step.SYNC``, ``--repeat`` times in one process, and prints each
stage's step times (host clock, data fetch to the ``skipped`` read) and
their median with the stage's first step excluded, beside the card's name
and power limit. ``chip_smoke.py``'s main phase is ``resnet50_path`` and
``stage_medians``. To compare two trees of the port on one card, copy this
file into the other tree's ``src/repro_torch/launch/`` and run the two in
turns from their own roots. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.core import losses, topology
from repro_torch.core.batch_control import build_plan
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data import augment
from repro_torch.data.synthetic import SyntheticImageNet, generator
from repro_torch.launch.profile_step import SYNC
from repro_torch.models import resnet
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig

SMOOTHING = 0.1


def resnet50_path(dev: torch.device):
    """The main path's model, data, loss and plan: ``(model, data_fn,
    loss_fn, plan)``."""
    model = resnet.init(resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224),
                        seed=0, device=dev)
    data = SyntheticImageNet(num_classes=1000, image_size=224, seed=0, device=dev)

    def data_fn(i, gb):
        images, labels = data.batch(i, gb)
        return augment.augment(generator(dev, 1, i), images, (224, 224)), labels

    def loss_fn(params, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=params, grid=grid)
        return (losses.label_smoothing_xent(logits, labels, SMOOTHING),
                torch.zeros((), device=dev))

    sched = BatchSchedule((BatchStage(0, 1, 32), BatchStage(1, 2, 64)))
    plan = build_plan(sched, dataset_size=256, n_workers=1, max_steps=12)
    return model, data_fn, loss_fn, plan


def stage_medians(plan, rows) -> list[dict]:
    """Each stage's step ms (metric rows' ``wall_s``) and their median with
    the stage's first step excluded."""
    out = []
    for s in plan.stages:
        walls = [1e3 * r["wall_s"] for r in rows
                 if s.first_step < r["step"] <= s.first_step + s.num_steps]
        out.append({"global_batch": s.global_batch, "step_ms": walls,
                    "steady_median_ms": statistics.median(walls[1:])})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_trainer: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                rank=0, world_size=1, timeout=datetime.timedelta(minutes=5))
        try:
            grid = topology.select_grid((1,)).build()
            model, data_fn, loss_fn, plan = resnet50_path(dev)
            for _ in range(args.repeat):
                trainer = Trainer(loss_fn=loss_fn, plan=plan, data_fn=data_fn, grid=grid,
                                  cfg=TrainerConfig(schedule="B", log_every=1, grad_sync=SYNC))
                state, history = trainer.run(TrainState.create(dict(model.named_parameters())),
                                             log=lambda s: None)
                torch.cuda.synchronize()
                stages = stage_medians(plan, [h for h in history if h["kind"] == "metric"])
                runs.append(stages)
                print(f"trainer ({card}): " + "; ".join(
                    f"gb {s['global_batch']} steady median {s['steady_median_ms']:.2f} ms "
                    f"(steps {[round(w, 2) for w in s['step_ms']]})" for s in stages))
        finally:
            dist.destroy_process_group()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
