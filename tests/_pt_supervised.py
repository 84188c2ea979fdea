"""Rank bodies for the supervised trainer's 8-rank gloo tests: the port's
``Trainer.run`` with checkpoints, a ``FaultPlan``, elastic recovery and
telemetry, on ResNet-tiny (fp32 compute) fed ``_pt_parity.synthetic_batch``.

Like ``_pt_parity``, this module imports torch and ``repro_torch`` only,
never JAX, so a spawned rank can import it; ``_pt_parity.launch`` runs the
bodies.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from _pt_parity import _tiny_model, synthetic_batch

# ResNet-tiny at 2 images a rank on one stage, as tests/test_robustness.py
# and tests/test_elastic.py build their plans
STAGES = ((0, 1.0, 2),)
DATASET = 256


def _strip(row: dict) -> dict:
    """A history row without its wall-clock time."""
    return {k: v for k, v in row.items() if k != "wall_s"}


class _LateClock:
    """``time`` for the trainer module of one rank: ``monotonic`` runs
    ``late_s`` ahead after each step in ``steps`` (a wall-clock stall that
    only this rank sees, after the step's last collective)."""

    def __init__(self, steps, late_s: float):
        self.steps, self.late_s, self.offset = set(steps), late_s, 0.0

    def monotonic(self) -> float:
        return time.monotonic() + self.offset


@contextlib.contextmanager
def _stall(rank: int, spec):
    """On rank ``spec["rank"]``, make the steps ``spec["steps"]`` (their
    first visit) read ``spec["late_s"]`` longer on the trainer's clock."""
    from repro_torch.train import trainer as trainer_mod

    if spec is None or rank != spec["rank"]:
        yield
        return
    clock = _LateClock(spec["steps"], spec["late_s"])
    real_make = trainer_mod.make_train_step

    def make(loss_fn, cfg, grid=None, groups=None):
        fn = real_make(loss_fn, cfg, grid, groups)

        def step(state, batch, epoch, gb):
            out = fn(state, batch, epoch, gb)
            if state.step in clock.steps:
                clock.steps.discard(state.step)
                clock.offset += clock.late_s
            return out
        return step

    trainer_mod.make_train_step, trainer_mod.time = make, clock
    try:
        yield
    finally:
        trainer_mod.make_train_step, trainer_mod.time = real_make, time


def supervised_body(rank: int, world: int, sizes, params, num_classes: int, runs,
                    ckpt_root: str) -> dict:
    """The port's ``Trainer.run`` for each run of ``runs`` ({key: spec}), in
    order, each from ``params``. A spec holds ``sync`` (GradSyncConfig
    kwargs, comm dtype by name), ``plan_steps``, and optionally
    ``max_steps``, ``ckpt`` (a directory under ``ckpt_root``),
    ``ckpt_every``, ``faults`` (FaultPlan kwargs), ``elastic``
    (ElasticConfig kwargs), ``resume``, ``stall`` (see ``_stall``),
    ``fail_data`` ({"rank", "step"}: that rank's data_fn raises OSError
    there, every attempt) and ``obs`` (ObsConfig kwargs, paths under
    ``ckpt_root``). Returns {key: {"history", "params", "momentum",
    "step", "loss_scale"}} with params and momentum in the JAX layout, or
    {key: {"error": message}} when the run raised RuntimeError."""
    from repro_torch.convert import params_to_jax
    from repro_torch.core import losses, topology
    from repro_torch.core.batch_control import build_plan
    from repro_torch.core.grad_sync import GradSyncConfig
    from repro_torch.core.schedules import BatchSchedule, BatchStage
    from repro_torch.models import resnet
    from repro_torch.obs import ObsConfig
    from repro_torch.testing.chaos import FaultPlan
    from repro_torch.train.elastic import ElasticConfig
    from repro_torch.train.state import TrainState
    from repro_torch.train.trainer import Trainer, TrainerConfig

    grid = topology.select_grid(sizes).build()
    model = _tiny_model(params, num_classes)

    def loss_fn(p, batch, grid):
        images, labels = batch
        logits = resnet.apply(model, images, params=p, grid=grid)
        return losses.label_smoothing_xent(logits, labels, 0.1), torch.zeros(())

    out = {}
    for key, spec in runs.items():
        def data_fn(i, gb, fail=spec.get("fail_data")):
            if fail is not None and rank == fail["rank"] and i == fail["step"]:
                raise OSError(f"rank {rank} lost its data shard at step {i}")
            return tuple(torch.from_numpy(a) for a in synthetic_batch(i, gb, num_classes))

        sync = dict(spec["sync"])
        sync["comm_dtype"] = getattr(torch, sync.get("comm_dtype", "float32"))
        obs = {k: os.path.join(ckpt_root, v) if k.endswith(("_path", "_dir")) else v
               for k, v in spec.get("obs", {}).items()}
        cfg = TrainerConfig(schedule="B", log_every=1000,
                            grad_sync=GradSyncConfig(**sync),
                            ckpt_every_steps=spec.get("ckpt_every", 0),
                            ckpt_keep_last=10, retry_backoff_s=1e-4,
                            elastic=ElasticConfig(**spec.get("elastic", {})),
                            obs=ObsConfig(**obs))
        plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in STAGES)),
                          dataset_size=DATASET, n_workers=world,
                          max_steps=spec["plan_steps"])
        trainer = Trainer(
            loss_fn, cfg, plan, data_fn, grid=grid,
            checkpoint_dir=(os.path.join(ckpt_root, spec["ckpt"]) if spec.get("ckpt")
                            else None),
            fault_plan=FaultPlan(**spec["faults"]) if "faults" in spec else None)
        try:
            with _stall(rank, spec.get("stall")):
                state, history = trainer.run(
                    TrainState.create(dict(model.named_parameters())),
                    max_steps=spec.get("max_steps"), log=lambda s: None,
                    resume=spec.get("resume", False))
        except RuntimeError as e:
            out[key] = {"error": str(e)}
            continue
        out[key] = {"history": [_strip(h) for h in history],
                    "params": params_to_jax(state.params),
                    "momentum": params_to_jax(state.opt_state["momentum"]),
                    "step": state.step, "loss_scale": float(state.loss_scale)}
    return out
