"""The trainer: the paper's recipe, data-parallel over the ranks of a
``core.topology.TorusGrid`` (``repro/train/trainer.py``).

One ``train_step``, in the reference's order:
  1. local forward/backward in compute dtype (bf16), loss multiplied by the
     dynamic loss scale; BN moments are averaged over the grid's ranks
  2. gradient exchange (``core/grad_sync.py:sync_tree``) with the configured
     strategy (2D-torus / ring / hierarchical / psum), bf16 buckets, fp32
     for BN, scales and biases; on the 1 x 1 grid the exchange is the
     identity but the bf16 cast still rounds, as on the reference's (1, 1)
     mesh
  3. unscale; the loss (and aux) averaged over ranks; non-finite guard: an
     all-finite flag over that loss and every synced gradient leaf gates
     the update -- params and momentum pass through unchanged on a
     non-finite step and the loss scale backs off (recovering after
     ``GuardConfig.growth_interval`` clean steps)
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

from repro_torch.core import grad_sync as grad_sync_lib
from repro_torch.core import lars as lars_lib
from repro_torch.core import schedules as sched_lib
from repro_torch.core import topology
from repro_torch.core.batch_control import TrainPlan, epoch_of
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.topology import TorusGrid
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
    grad_sync: GradSyncConfig = GradSyncConfig()
    lars: lars_lib.LARSConfig = lars_lib.LARSConfig()
    guard: GuardConfig = GuardConfig()
    aux_weight: float = 0.01            # weight of the loss_fn's aux term
    log_every: int = 10


def _norm_all(tensors) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


def _rank_mean(grid: TorusGrid, *values: torch.Tensor) -> list[torch.Tensor]:
    """Each scalar averaged over the grid's ranks (``lax.pmean``), in one
    all-reduce."""
    dev = values[0].device
    stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev).detach()
                           for v in values])
    if grid.size > 1:
        dist.all_reduce(stacked, group=grid.world.group)
        stacked = stacked / grid.size
    return list(stacked.unbind(0))


def make_train_step(loss_fn: Callable, cfg: TrainerConfig, grid: TorusGrid | None = None):
    """Build the step ``(state, batch, epoch, global_batch) -> (state, metrics)``.

    ``loss_fn(params, batch, grid) -> (loss, aux)`` computes the LOCAL mean
    loss of this rank's ``batch`` from ``params`` ({name: tensor}), label
    smoothing included, syncing BN over ``grid`` (the reference's
    ``dp_axes``); ``aux`` is an extra scalar loss term. ``grid`` is a built
    ``TorusGrid`` (default ``topology.world_grid()``: every rank, or the
    1 x 1 grid without a process group). ``cfg.grad_sync`` must be resolved
    (``grad_sync.resolve_sync_config``; ``Trainer.run`` does it).
    """
    grid = grid if grid is not None else topology.world_grid()
    schedule = sched_lib.make(cfg.schedule)
    guard = cfg.guard

    def step(state: TrainState, batch, epoch: float, global_batch: int):
        scale = state.loss_scale
        names = list(state.params)
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        with torch.enable_grad():
            loss, aux = loss_fn(params, batch, grid)
            tot = loss + cfg.aux_weight * aux
            if guard.enabled:
                tot = tot * scale.to(tot.dtype)
            grads = torch.autograd.grad(tot, [params[k] for k in names])
        grads = grad_sync_lib.sync_tree(dict(zip(names, grads)), grid, cfg.grad_sync)
        if guard.enabled:
            inv = 1.0 / scale   # exact for the power-of-two scales we use
            grads = {k: g * inv.to(g.dtype) for k, g in grads.items()}

        # all-finite flag over the rank-mean loss and the synced grads: the
        # all-reduce carried any rank's NaN/Inf to every rank, so the flag
        # (and the skip) is the same on all of them
        loss_m, aux_m = _rank_mean(grid, loss, aux)
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
            "aux": aux_m,
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


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s rows [r * n, (r + 1) * n) of every tensor in the
    global ``batch``, n = rows / world: the reference's batch sharding
    ``P(("dy", "dx"))`` in the grid's row-major rank order."""
    if world == 1:
        return batch
    rows = batch[0].shape[0]
    if rows % world:
        raise ValueError(f"global batch {rows} does not split over {world} ranks")
    n = rows // world
    return type(batch)(t[rank * n:(rank + 1) * n] for t in batch)


@dataclasses.dataclass
class Trainer:
    loss_fn: Callable                  # (params, batch, grid) -> (loss, aux)
    cfg: TrainerConfig
    plan: TrainPlan
    data_fn: Callable                  # (step_index, global_batch) -> batch
    grid: TorusGrid | None = None      # None: topology.world_grid()

    def run(self, state: TrainState, max_steps: int | None = None,
            log: Callable = print):
        """Run the plan's stages with one step function. Returns
        ``(state, history)``; ``history`` holds a metric row (``"kind":
        "metric"``) every ``log_every`` steps, at stage ends and on every
        skipped step, with the step's wall time in ``wall_s``, after the
        event rows (``"kind": "event"``) of resolving the gradient sync
        (a strategy rejected or downgraded).

        Every rank calls it; ``data_fn`` gives the global batch and each
        rank trains on its rows (``shard_batch``).
        """
        cfg = self.cfg
        grid = self.grid if self.grid is not None else topology.world_grid()
        history: list[dict] = []
        sync_cfg, events = grad_sync_lib.resolve_sync_config(
            cfg.grad_sync, grid, params_like=state.params)
        for ev in events:
            ev = dict(ev)
            name = ev.pop("event")
            history.append({"kind": "event", "event": name, **ev})
            log(f"[{name}] " + " ".join(f"{k}={v}" for k, v in ev.items()))
        cfg = dataclasses.replace(cfg, grad_sync=sync_cfg)
        fn = make_train_step(self.loss_fn, cfg, grid)
        for stage in self.plan.stages:
            gb = stage.global_batch
            for i in range(stage.num_steps):
                gstep = stage.first_step + i
                if max_steps is not None and gstep >= max_steps:
                    return state, history
                epoch = epoch_of(self.plan, stage, i)
                t0 = time.perf_counter()
                batch = shard_batch(self.data_fn(gstep, gb), grid.world.index,
                                    grid.size)
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
