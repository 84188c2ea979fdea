"""The trainer: the paper's recipe on one device (``repro/train/trainer.py``).

One ``train_step``:
  1. forward/backward in compute dtype (bf16), loss multiplied by the
     dynamic loss scale
  2. (gradient exchange: not ported yet -- one rank, so it is the identity)
  3. unscale; non-finite guard: an all-finite flag over the loss and every
     gradient leaf gates the update -- params and momentum pass through
     unchanged on a non-finite step and the loss scale backs off
     (recovering after ``GuardConfig.growth_interval`` clean steps)
  4. LR + momentum from the schedule at the *fractional epoch*
  5. LARS update in fp32 (the CUDA kernel on the card)

Every decision stays on the device: the finite flag selects with
``torch.where``, so the step needs no host synchronisation; ``Trainer.run``
reads the ``skipped`` flag once a step, as the JAX trainer does.

Checkpoints, elastic recovery, fault injection, retry and telemetry are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.core import lars as lars_lib
from repro_torch.core import schedules as sched_lib
from repro_torch.core.batch_control import TrainPlan, epoch_of
from repro_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Non-finite-gradient guard + dynamic loss scale.

    The scale starts at ``TrainState.create(loss_scale=...)``: 1.0 suits
    bf16 (fp32's exponent range), and then with no faults the guarded step
    equals an unguarded one (multiply by exactly 1.0, select-on-True).
    """

    enabled: bool = True
    growth_interval: int = 200    # clean steps before the scale regrows
    growth_factor: float = 2.0
    backoff_factor: float = 0.5   # applied on every skipped step
    max_scale: float = 2.0 ** 15
    min_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    schedule: str = "B"                 # LR config A or B (paper Table 3)
    lars: lars_lib.LARSConfig = lars_lib.LARSConfig()
    guard: GuardConfig = GuardConfig()
    aux_weight: float = 0.01            # weight of the loss_fn's aux term
    log_every: int = 10


def _norm_all(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def make_train_step(loss_fn: Callable, cfg: TrainerConfig):
    """Build the step ``(state, batch, epoch, global_batch) -> (state, metrics)``.

    ``loss_fn(params, batch) -> (loss, aux)`` computes the mean loss of the
    batch from ``params`` ({name: tensor}), label smoothing included;
    ``aux`` is an extra scalar loss term. Raises if ``torch.distributed``
    runs more than one rank: the gradient exchange is not ported, and ranks
    would train apart.
    """
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise RuntimeError(
            f"make_train_step: {dist.get_world_size()} ranks, but the gradient "
            "sync is not ported yet; each rank would train on its own")
    schedule = sched_lib.make(cfg.schedule)
    guard = cfg.guard

    def step(state: TrainState, batch, epoch: float, global_batch: int):
        scale = state.loss_scale
        names = list(state.params)
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        with torch.enable_grad():
            loss, aux = loss_fn(params, batch)
            tot = loss + cfg.aux_weight * aux
            if guard.enabled:
                tot = tot * scale.to(tot.dtype)
            grads = torch.autograd.grad(tot, [params[k] for k in names])
        grads = dict(zip(names, grads))
        if guard.enabled:
            inv = 1.0 / scale   # exact for the power-of-two scales we use
            grads = {k: g * inv.to(g.dtype) for k, g in grads.items()}

        loss_m = loss.detach()
        nonfinite = torch.stack([(~torch.isfinite(g)).sum()
                                 for g in grads.values()]).sum()
        finite = torch.isfinite(loss_m) & (nonfinite == 0)

        lr = schedule.lr(epoch)
        mom = schedule.mom(epoch, global_batch)
        new_params, new_opt = lars_lib.update(
            state.params, grads, state.opt_state, lr=lr, momentum=mom,
            cfg=cfg.lars)

        if guard.enabled:
            # skip the update on non-finite steps: params/momentum pass
            # through unchanged (torch.where selects bit-exactly on True)
            new_params = {k: torch.where(finite, p, state.params[k])
                          for k, p in new_params.items()}
            old_m = state.opt_state["momentum"]
            new_opt = {"momentum": {k: torch.where(finite, v, old_m[k])
                                    for k, v in new_opt["momentum"].items()}}
            good = torch.where(finite, state.good_steps + 1,
                               torch.zeros_like(state.good_steps))
            grow = finite & (good >= guard.growth_interval)
            new_scale = torch.where(
                finite,
                torch.where(grow, (scale * guard.growth_factor).clamp(
                    max=guard.max_scale), scale),
                (scale * guard.backoff_factor).clamp(min=guard.min_scale))
            good = torch.where(grow, torch.zeros_like(good), good).to(torch.int32)
        else:
            new_scale, good = state.loss_scale, state.good_steps

        metrics = {
            "loss": loss_m,
            "aux": torch.as_tensor(aux).detach(),
            "lr": lr, "momentum": mom,
            "grad_norm": _norm_all(grads.values()),
            "skipped": (~finite).to(torch.int32),
            "nonfinite_count": nonfinite.to(torch.int32),
            "loss_scale": new_scale,
        }
        new_state = TrainState(new_params, new_opt, state.step + 1,
                               new_scale, good)
        return new_state, metrics

    return step


@dataclasses.dataclass
class Trainer:
    loss_fn: Callable
    cfg: TrainerConfig
    plan: TrainPlan
    data_fn: Callable                  # (step_index, global_batch) -> batch

    def run(self, state: TrainState, max_steps: int | None = None,
            log: Callable = print):
        """Run the plan's stages with one step function. Returns
        ``(state, history)``; ``history`` holds a metric row (``"kind":
        "metric"``) every ``log_every`` steps, at stage ends and on every
        skipped step, with the step's wall time in ``wall_s``."""
        cfg = self.cfg
        fn = make_train_step(self.loss_fn, cfg)
        history: list[dict] = []
        for stage in self.plan.stages:
            gb = stage.global_batch
            for i in range(stage.num_steps):
                gstep = stage.first_step + i
                if max_steps is not None and gstep >= max_steps:
                    return state, history
                epoch = epoch_of(self.plan, stage, i)
                t0 = time.perf_counter()
                batch = self.data_fn(gstep, gb)
                state, metrics = fn(state, batch, epoch, gb)
                # reading the flag waits for the step; without the guard
                # there is nothing to read and wall_s covers dispatch only
                skipped = int(metrics["skipped"]) if cfg.guard.enabled else 0
                wall = time.perf_counter() - t0
                done = gstep + 1
                if done % cfg.log_every == 0 or i == stage.num_steps - 1 or skipped:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=done, epoch=epoch, global_batch=gb,
                             skipped=skipped,
                             nonfinite_count=int(metrics["nonfinite_count"]),
                             wall_s=wall, kind="metric")
                    history.append(m)
                    log(f"step {done:5d} epoch {epoch:6.2f} "
                        f"gb {gb:6d} loss {m['loss']:.4f} "
                        f"lr {m['lr']:.3f} mom {m['momentum']:.3f} "
                        f"{1e3 * wall:.1f} ms"
                        + (f" SKIPPED (nonfinite={m['nonfinite_count']}, "
                           f"scale->{m['loss_scale']:g})" if skipped else ""))
        return state, history
