"""Quickstart of the PyTorch port: the paper's full recipe on a tiny ResNet
on a 2 x 4 grid of ranks, under the supervised trainer
(``examples/quickstart.py``).

    PYTHONPATH=src python examples/pt_quickstart.py --device cpu
    PYTHONPATH=src python examples/pt_quickstart.py             # one card a rank

Demonstrates: 2D-torus gradient sync in bf16 buckets, LARS, label
smoothing, batch-size control, synced BN, bf16 compute over fp32 masters
-- the complete recipe at toy scale -- and the supervised loop around it:
crash-consistent checkpoints (written asynchronously into a temporary
directory), the non-finite guard, the elastic supervisor, and the run's
metrics JSONL. The script starts one process a rank itself (gloo on the
CPU; NCCL on cards, rank r on card r, so the default grid needs 8 cards
and ``--grid 1x1`` runs on one); each joins the group through a file store
in the temporary directory.
"""

import argparse
import datetime
import multiprocessing as mp
import os
import tempfile
import warnings

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch.core import losses, topology
from repro_torch.core.batch_control import build_plan
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data.synthetic import SyntheticImageNet
from repro_torch.models import resnet
from repro_torch.obs import ObsConfig, read_run
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig


def run(rank: int, world: int, sizes, device: str | None, steps: int | None,
        workdir: str) -> dict:
    """One rank of the quickstart, in an initialised process group. Returns
    the run's final step and its history; rank 0 prints the history and
    the summary of the metrics JSONL it wrote into ``workdir``."""
    dev = device_lib.resolve(device)
    grid = topology.select_grid(sizes).build()
    cfg = resnet.ResNetConfig.tiny(num_classes=8)
    model = resnet.init(cfg, seed=0, device=dev)
    data = SyntheticImageNet(num_classes=8, image_size=32, noise=0.4, device=dev)

    def loss_fn(params, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=params, grid=grid)
        return losses.label_smoothing_xent(logits, labels, 0.1), torch.zeros((), device=dev)

    # batch-size control: 2/worker then 4/worker (paper §2.1, Table 3)
    sched = BatchSchedule((BatchStage(0, 0.1, 2), BatchStage(0.1, 0.25, 4)))
    plan = build_plan(sched, dataset_size=4096, n_workers=world, max_steps=steps)
    metrics_path = os.path.join(workdir, "metrics.jsonl")
    trainer = Trainer(
        loss_fn=loss_fn,
        cfg=TrainerConfig(schedule="B", log_every=5, ckpt_every_steps=10,
                          grad_sync=GradSyncConfig(strategy="torus2d",
                                                   comm_dtype=torch.bfloat16),
                          obs=ObsConfig(metrics_path=metrics_path)),
        plan=plan, data_fn=lambda i, gb: data.batch(i, gb), grid=grid,
        checkpoint_dir=os.path.join(workdir, "ckpt"))
    log = print if rank == 0 else (lambda s: None)
    log(f"plan: {plan.total_steps} steps over {len(plan.stages)} stages, "
        f"{world} ranks on a {grid.y}x{grid.x} grid ({dev.type})")
    state, history = trainer.run(TrainState.create(dict(model.named_parameters())), log=log)
    if rank == 0:
        rows = [h for h in history if h["kind"] == "metric"]
        summary = read_run(metrics_path)[-1]["metrics"]
        recoveries = summary.get("elastic/recoveries", {"value": 0})["value"]
        print(f"final loss {rows[-1]['loss']:.4f} after {state.step} steps; "
              f"{summary['checkpoint/commits']['value']:g} checkpoints committed, "
              f"{recoveries:g} recoveries")
    return {"step": state.step, "history": history}


def _rank_main(rank: int, world: int, store_path: str, sizes, device, steps, workdir):
    if device is None:
        torch.cuda.set_device(rank)
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # torch 2.13 renames the *_tensor collectives; the port keeps the names
    # that every torch it runs on has
    warnings.filterwarnings("ignore", category=FutureWarning,
                            message=".*_tensor` is deprecated")
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo" if device == "cpu" else "nccl", store=store, rank=rank,
                            world_size=world, timeout=datetime.timedelta(minutes=5))
    try:
        run(rank, world, sizes, device, steps, workdir)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu for gloo; default: the cards")
    ap.add_argument("--grid", default="2x4", help="Y x X ranks")
    ap.add_argument("--steps", type=int, default=None, help="stop after this many steps")
    args = ap.parse_args()
    sizes = tuple(int(s) for s in args.grid.split("x"))
    world = sizes[0] * sizes[1]
    if args.device is None and torch.cuda.device_count() < world:
        raise SystemExit(f"{world} ranks need {world} cards; found "
                         f"{torch.cuda.device_count()} (pass --device cpu or --grid)")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, os.path.join(workdir, "store"), sizes,
                                   args.device, args.steps, workdir))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise SystemExit(f"ranks exited with {bad}")


if __name__ == "__main__":
    main()
