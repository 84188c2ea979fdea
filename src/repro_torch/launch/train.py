"""Training launcher: ``--arch <id>`` and the paper's recipe
(``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \
        --device cpu --steps 3
    PYTHONPATH=src torchrun --nproc_per_node <ranks> -m repro_torch.launch.train \
        --arch qwen3-1.7b [--smoke] [--steps 20] [--sync torus2d] [--schedule B] \
        [--batch-stages 2,4] [--remat] [--device cpu]

The recipe is the reference's: 2D-torus gradient sync with ``fuse=False``
and bf16 comm, LARS, label smoothing, schedule B, batch-size control over
``--batch-stages`` (per-rank batch sizes, one epoch of ``512`` sequences a
rank each, as the reference's; ``--stage-steps N`` instead gives each
stage N steps), on ``SyntheticTokens``. ``--smoke`` takes the arch's
reduced config; without it the full config, at its published widths.
``--remat`` sets the config's ``remat``: each prefix layer and pattern
block is recomputed in backward (``models/transformer.py:forward``). The
reference's launcher has no such flag; its dry run sets ``remat`` for
every train shape (``launch/dryrun.py:arch_for``).

World and grid: under ``torchrun`` (``WORLD_SIZE`` set) every rank joins
one process group (NCCL on cards, rank r on card ``LOCAL_RANK``; gloo with
``--device cpu``), and the grid is a ``TorusGrid`` over the world
(``core/topology.py``: the paper's factorization); without ``torchrun``
one rank trains on the 1 x 1 grid. Each rank holds a whole replica of the
model and trains on its rows of the global batch. The reference's full
config instead builds a sharded production mesh (``repro/launch/mesh.py``);
the port's meshes and placements (``launch/mesh.py``) serve its dry run,
and no run has yet sharded a model across cards, so this launcher
replicates.

The LARS groups and the sync's plan follow the reference's stacked leaves
(``convert.leaf_groups``, learned once from the model's names and config).
It runs on the card unless ``--device cpu`` is given. ``build`` returns the
run's parts (config, model, trainer, state); ``chip_smoke.py`` and the
tests train through it.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import convert
from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.core import losses, topology
from repro_torch.core.batch_control import build_plan
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data.synthetic import SyntheticTokens, generator
from repro_torch.models import transformer as T
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig

EPOCH_PER_RANK = 512   # sequences a rank in one epoch (the reference's dataset size)


@dataclasses.dataclass
class Run:
    cfg: T.ArchConfig
    model: T.Transformer
    trainer: Trainer
    state: TrainState
    groups: tuple        # convert.leaf_groups of the model


def loss_fn_for(cfg: T.ArchConfig, smoothing: float):
    """The reference launcher's loss: smoothed cross-entropy of the
    transformer's logits, and the MoE aux loss (the trainer weighs it by
    ``aux_weight``). ``batch`` is (tokens, labels) or, for a model with
    cross layers, (tokens, labels, vision). ``params`` is the trainer's flat
    dict; the matrices are cast to the compute dtype once a step, under
    autograd, so the gradients land on the fp32 masters."""
    def loss_fn(params, batch, grid):
        tokens, labels, *vision = batch
        tree = T.compute_params(T.params_tree(params), cfg.compute_dtype)
        logits, aux = T.forward(tree, tokens, cfg, vision=vision[0] if vision else None)
        return losses.label_smoothing_xent(logits, labels, smoothing), aux
    return loss_fn


def data_fn_for(cfg: T.ArchConfig, seq: int, device):
    """Batch ``i`` of ``gb`` sequences of ``SyntheticTokens`` (seed 0); a
    model with cross layers also gets a seeded (gb, vision_tokens,
    cross_kv_dim) vision input, drawn on the device like the tokens."""
    data = SyntheticTokens(vocab=cfg.vocab, device=device)

    def data_fn(i, gb):
        tokens, labels = data.batch(i, gb, seq)
        if not cfg.vision_tokens:
            return tokens, labels
        vision = torch.randn((gb, cfg.vision_tokens, cfg.cross_kv_dim),
                             generator=generator(tokens.device, 3, i),
                             device=tokens.device)
        return tokens, labels, vision
    return data_fn


def plan_for(batch_stages: list[int], world: int, steps: int | None,
             stage_steps: int | None = None):
    """The batch-size plan: one stage a per-rank size, an epoch of
    ``EPOCH_PER_RANK`` sequences a rank each (the reference's), or with
    ``stage_steps`` each stage's span cut to that many steps."""
    dataset = world * EPOCH_PER_RANK
    stages, start = [], 0.0
    for s in batch_stages:
        span = 1.0 if stage_steps is None else stage_steps * s * world / dataset
        stages.append(BatchStage(start, start + span, s))
        start += span
    return build_plan(BatchSchedule(tuple(stages)), dataset_size=dataset,
                      n_workers=world, max_steps=steps)


def build(arch: str, *, smoke: bool = False, seq: int = 64, sync: str = "torus2d",
          schedule: str = "B", label_smoothing: float = 0.1,
          batch_stages: tuple[int, ...] = (2, 4), steps: int | None = 20,
          stage_steps: int | None = None, device=None, grid=None,
          checkpoint_dir: str | None = None, cfg: T.ArchConfig | None = None,
          **trainer_kw: Any) -> Run:
    """The run's config, model (random weights from seed 0), trainer and
    state, as ``main`` trains them. ``grid``: a built ``TorusGrid``
    (default ``topology.world_grid()``); ``cfg`` replaces the registry's
    config of ``arch``; ``trainer_kw`` go to ``TrainerConfig``."""
    if cfg is None:
        cfg = registry.get_smoke(arch) if smoke else registry.get(arch)
    dev = device_lib.resolve(device)
    grid = grid if grid is not None else topology.world_grid()
    model = T.init(cfg, seed=0, device=dev)
    params = dict(model.named_parameters())
    groups = convert.leaf_groups(params, cfg)
    tcfg = TrainerConfig(
        schedule=schedule,
        grad_sync=GradSyncConfig(strategy=sync, fuse=False, comm_dtype=torch.bfloat16),
        **{"log_every": 5, **trainer_kw})
    trainer = Trainer(loss_fn=loss_fn_for(cfg, label_smoothing), cfg=tcfg,
                      plan=plan_for(list(batch_stages), grid.size, steps, stage_steps),
                      data_fn=data_fn_for(cfg, seq, dev), grid=grid,
                      checkpoint_dir=checkpoint_dir, leaf_groups=groups)
    return Run(cfg, model, trainer, TrainState.create(params), groups)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sync", default="torus2d",
                    choices=["psum", "ring", "hierarchical", "torus2d"])
    ap.add_argument("--schedule", default="B", choices=["A", "B"])
    ap.add_argument("--label-smoothing", type=float, default=0.1)
    ap.add_argument("--batch-stages", default="2,4",
                    help="comma per-rank batch sizes, staged equally")
    ap.add_argument("--stage-steps", type=int, default=None,
                    help="steps a stage (default: one epoch of 512 sequences a rank)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each prefix layer and pattern block in backward")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default=None, help="cpu for gloo; default: the card")
    args = ap.parse_args(argv)

    distributed = "WORLD_SIZE" in os.environ
    if distributed and args.device is None and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = device_lib.resolve(args.device)
    if distributed:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(minutes=5))
    try:
        grid = topology.world_grid()
        cfg = registry.get_smoke(args.arch) if args.smoke else registry.get(args.arch)
        run = build(args.arch, cfg=dataclasses.replace(cfg, remat=args.remat), seq=args.seq,
                    sync=args.sync, schedule=args.schedule, label_smoothing=args.label_smoothing,
                    batch_stages=tuple(int(s) for s in args.batch_stages.split(",")),
                    steps=args.steps, stage_steps=args.stage_steps, device=dev, grid=grid,
                    checkpoint_dir=args.checkpoint_dir)
        rank0 = grid.world.index == 0
        log = print if rank0 else (lambda s: None)
        log(f"training {run.cfg.name} ({run.cfg.num_params() / 1e6:.1f}M params, "
            f"{len(run.state.params)} leaves in {len(run.groups)} LARS groups) with "
            f"sync={args.sync} schedule={args.schedule} on {grid.size} rank(s), {dev.type}")
        state, history = run.trainer.run(run.state, log=log)
        rows = [h for h in history if h["kind"] == "metric"]
        log(f"done: loss {rows[0]['loss']:.3f} -> {rows[-1]['loss']:.3f} "
            f"over {state.step} steps")
    finally:
        if distributed:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
