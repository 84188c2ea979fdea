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

``Trainer.run`` is the reference's **supervised recovery loop**
(``repro/train/trainer.py``): it loops over the batch-size-control stages
with one step function, retries transient data failures with jittered
exponential backoff (``repro_torch.utils.retry``), writes crash-consistent
checkpoints in the reference's format (``train/checkpoint.py``) -- by
default asynchronously, off the training thread -- periodically and at
stage boundaries, resumes mid-stage from the newest *valid* checkpoint,
takes injected faults from a ``testing.chaos.FaultPlan``, and wraps every
step in telemetry spans and metrics (``repro_torch.obs``). When the
supervisor (``train/elastic.py``) flags a *permanent* failure -- a torus
axis newly down, an unbroken streak of guard-skipped steps, repeated step
timeouts -- it re-resolves the sync strategy against the enlarged
down-axis set, rebuilds the step for the degraded grid, restores the
newest valid checkpoint and re-enters the step loop in the same process.

On more than one rank every rank runs the loop on the same replicated
state: rank 0 alone writes checkpoints and the telemetry artifacts, and
decides which checkpoint to resume from or roll back to (after flushing
its writer), then broadcasts the path. The JAX trainer is one controller
and reaches one verdict; here every rank must reach the same verdict at
the same step, or the healthy ranks wait in the next collective until the
process group times out. The injected signals are the same on every rank
and ``skipped`` comes from all-reduced values; the two local signals -- a
rank's data retries running out, and a step's wall clock passing
``ElasticConfig.step_timeout_s`` -- are agreed by a MAX all-reduce of one
flag each (after the fetch, and after the ``skipped`` read; none at world
1). A CUDA or kernel error is no fault class: it propagates, and the run
never moves to the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core import grad_sync as grad_sync_lib
from repro_torch.core import lars as lars_lib
from repro_torch.core import schedules as sched_lib
from repro_torch.core import topology
from repro_torch.core.batch_control import TrainPlan, epoch_of
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.topology import TorusGrid
from repro_torch.obs import ObsConfig, Telemetry
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.tracing import Tracer, torch_profile
from repro_torch.testing.chaos import RETRYABLE
from repro_torch.train import checkpoint
from repro_torch.train.elastic import ElasticConfig, PermanentFailure, Supervisor
from repro_torch.train.state import TrainState
from repro_torch.utils.retry import retry_call


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
    # fault tolerance
    ckpt_every_steps: int = 0           # 0: stage boundaries only
    ckpt_keep_last: int = 3
    ckpt_retries: int = 3
    ckpt_async: bool = True             # commit off the training thread
    ckpt_max_pending: int = 2           # async writer queue bound
    data_retries: int = 3
    retry_backoff_s: float = 0.05       # base of the exponential backoff
    elastic: ElasticConfig = ElasticConfig()  # mid-run recovery supervisor
    # observability: metrics JSONL / Chrome trace / torch.profiler paths;
    # registry + tracer always run (near-zero cost)
    obs: ObsConfig = ObsConfig()


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


def make_train_step(loss_fn: Callable, cfg: TrainerConfig, grid: TorusGrid | None = None,
                    groups=None, tracer: Tracer | None = None):
    """Build the step ``(state, batch, epoch, global_batch) -> (state, metrics)``.

    ``loss_fn(params, batch, grid) -> (loss, aux)`` computes the LOCAL mean
    loss of this rank's ``batch`` from ``params`` ({name: tensor}), label
    smoothing included, syncing BN over ``grid`` (the reference's
    ``dp_axes``); ``aux`` is an extra scalar loss term. ``grid`` is a built
    ``TorusGrid`` (default ``topology.world_grid()``: every rank, or the
    1 x 1 grid without a process group). ``cfg.grad_sync`` must be resolved
    (``grad_sync.resolve_sync_config``; ``Trainer.run`` does it).
    ``groups``: the reference's stacked leaves (``convert.leaf_groups``), for
    the sync's plan and LARS's trust ratios; None: one a leaf (the ResNet).

    The step's layers run in spans of ``tracer`` (``Trainer.run`` passes its
    telemetry's; None: a disabled one) that tile the step: ``forward``,
    ``backward``, ``grad_sync``, ``guard`` (the unscale, the rank mean and
    the finite flag), ``optimizer`` (LARS), ``guard`` again (the selects and
    the loss scale's update) and ``step_metrics``. Under ``torch.profiler``
    each is a ``repro_torch/<span>`` range around the kernels it launched,
    whatever the tracer records.
    """
    grid = grid if grid is not None else topology.world_grid()
    schedule = sched_lib.make(cfg.schedule)
    guard = cfg.guard
    span = (tracer if tracer is not None else Tracer(enabled=False)).span

    def step(state: TrainState, batch, epoch: float, global_batch: int):
        scale = state.loss_scale
        names = list(state.params)
        params = {k: p.detach().requires_grad_(True)
                  for k, p in state.params.items()}
        with torch.enable_grad():
            with span("forward"):
                loss, aux = loss_fn(params, batch, grid)
                tot = loss + cfg.aux_weight * aux
                if guard.enabled:
                    tot = tot * scale.to(tot.dtype)
            with span("backward"):
                grads = torch.autograd.grad(tot, [params[k] for k in names])
        with span("grad_sync"):
            grads = grad_sync_lib.sync_tree(dict(zip(names, grads)), grid, cfg.grad_sync,
                                            groups)
        with span("guard"):
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
        with span("optimizer"):
            new_params, new_opt = lars_lib.update(
                state.params, grads, state.opt_state, lr=lr, momentum=mom,
                cfg=cfg.lars, groups=groups)

        if guard.enabled:
            with span("guard"):
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

        with span("step_metrics"):
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


def _agree(grid: TorusGrid, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any: one MAX all-reduce
    of one int, none at world 1."""
    if grid.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=grid.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=grid.world.group)
    return bool(t.item())


@dataclasses.dataclass
class Trainer:
    loss_fn: Callable                  # (params, batch, grid) -> (loss, aux)
    cfg: TrainerConfig
    plan: TrainPlan
    data_fn: Callable                  # (step_index, global_batch) -> batch
    grid: TorusGrid | None = None      # None: topology.world_grid()
    checkpoint_dir: str | None = None  # every rank reads it, rank 0 writes
    fault_plan: Any | None = None      # repro_torch.testing.chaos.FaultPlan
    telemetry: Any | None = None       # repro_torch.obs.Telemetry; None:
                                       # built from cfg.obs, closed by run()
    # convert.leaf_groups: LARS's trust ratios, the sync's plan and the
    # checkpoints' stacked leaves follow the reference's tree; None: one a leaf
    leaf_groups: Any | None = None

    def run(self, state: TrainState, max_steps: int | None = None,
            log: Callable = print, resume: bool = False):
        """Run the plan under elastic supervision. Returns
        ``(state, history)``.

        ``history`` holds per-step metric rows (every ``log_every`` steps,
        at stage ends, and on every skipped step; each with the step's wall
        time, data fetch to ``skipped`` read, in ``wall_s``) interleaved
        with event rows (grad-sync downgrades, data retries, checkpoint
        saves/recoveries, resume, ``elastic_failure`` /
        ``elastic_recovery``). Every row carries a ``"kind"`` marker --
        ``"metric"`` or ``"event"``, but for ``elastic_failure``, whose
        ``kind`` is the failure's, as in the reference; rows are mirrored to the run's
        telemetry sink (``cfg.obs.metrics_path``) with per-step phase
        breakdowns and a final metrics summary. ``resume=True`` restores
        the newest *valid* checkpoint from ``checkpoint_dir`` and
        fast-forwards the plan to the exact mid-stage step.

        On a :class:`~repro_torch.train.elastic.PermanentFailure` the loop
        re-resolves the sync strategy against the accumulated down axes,
        rebuilds the step fn, rolls back to the newest valid checkpoint,
        and continues in-process; after a recovery, step rows for the
        replayed span appear twice in ``history``.

        Every rank calls it; ``data_fn`` gives the global batch and each
        rank trains on its rows (``shard_batch``). Rank 0's history also
        holds the checkpoint events, since it alone writes.
        """
        history: list[dict] = []
        cfg = self.cfg
        grid = self.grid if self.grid is not None else topology.world_grid()
        rank = grid.world.index
        tel = self.telemetry
        own_tel = tel is None
        if own_tel:
            # one telemetry bundle per run; closed (summary row + trace
            # export) in the finally below. A caller-supplied telemetry is
            # left open -- the caller owns its lifecycle and run_id.
            tel = Telemetry(cfg.obs, rank=rank, meta={
                "source": "trainer", "schedule": cfg.schedule,
                "strategy": cfg.grad_sync.strategy,
                "bucket_bytes": cfg.grad_sync.bucket_bytes})

        def event(etype: str, **kw):
            history.append(tel.event(etype, **kw))
            log(f"[{etype}] " + " ".join(f"{k}={v}" for k, v in kw.items()))

        if self.fault_plan is None:
            initial_down: tuple[str, ...] = ()
        elif hasattr(self.fault_plan, "down_axes_at"):
            initial_down = tuple(self.fault_plan.down_axes_at(0))
        else:
            initial_down = tuple(getattr(self.fault_plan, "down_axes", ())
                                 or ())
        supervisor = Supervisor(cfg.elastic, initial_down_axes=initial_down,
                                metrics=tel.registry)

        # the state is replicated: rank 0 writes every checkpoint
        saves = bool(self.checkpoint_dir) and rank == 0
        writer = None
        if saves and cfg.ckpt_async:
            writer = checkpoint.AsyncCheckpointWriter(
                max_pending=cfg.ckpt_max_pending, retries=cfg.ckpt_retries,
                backoff_s=cfg.retry_backoff_s, metrics=tel.registry)

        data_fn = (self.fault_plan.wrap_data_fn(self.data_fn)
                   if self.fault_plan is not None else self.data_fn)
        device = next(iter(state.params.values())).device

        try:
            start_step = 0
            if resume and self.checkpoint_dir:
                path = self._latest_valid(grid, state, event)
                if path is not None:
                    state = checkpoint.restore(path, state, groups=self.leaf_groups)
                    start_step = int(state.step)
                    event("resume", path=os.path.basename(path),
                          step=start_step)

            # elastic recovery line: a permanent failure heals by rolling
            # back to a checkpoint, so commit one before the first step
            if (cfg.elastic.enabled and saves
                    and checkpoint.latest(self.checkpoint_dir) is None):
                self._save_checkpoint(state, None, event, writer,
                                      metrics=tel.registry)

            # -- supervised recovery loop; optionally under torch.profiler
            # so the device timeline is captured alongside the host spans
            with torch_profile(cfg.obs.torch_profile_dir if cfg.obs.enabled
                               else None, device, rank):
                while True:
                    context = ("startup" if supervisor.recoveries == 0
                               else "elastic")
                    sync_cfg, sync_events = \
                        grad_sync_lib.resolve_sync_config(
                            cfg.grad_sync, grid,
                            down_axes=supervisor.down_axes, context=context,
                            params_like=state.params)
                    for ev in sync_events:
                        ev = dict(ev)
                        event(ev.pop("event"), **ev)
                    run_cfg = dataclasses.replace(cfg, grad_sync=sync_cfg)
                    # the bucket schedule is a host-side function of the
                    # param structure + resolved config: publish it as
                    # per-bucket gauges (re-published after a downgrade)
                    grad_sync_lib.record_bucket_metrics(
                        state.params, run_cfg.grad_sync, tel.registry, self.leaf_groups)
                    # ONE step fn for every stage of this attempt
                    fn = make_train_step(self.loss_fn, run_cfg, grid, self.leaf_groups,
                                         tracer=tel.tracer)
                    try:
                        state = self._run_steps(
                            fn, state, run_cfg, grid, data_fn, start_step,
                            max_steps, supervisor, writer, history, event,
                            log, tel)
                        return state, history
                    except PermanentFailure as failure:
                        state, start_step = self._recover(
                            state, failure, supervisor, grid, writer, event)
        finally:
            if writer is not None:
                writer.close()
                self._drain(writer, event)
            if own_tel:
                tel.close()

    # -- the per-attempt step loop ----------------------------------------

    def _run_steps(self, fn, state: TrainState, cfg: TrainerConfig,
                   grid: TorusGrid, data_fn, start_step: int,
                   max_steps: int | None, supervisor: Supervisor, writer,
                   history: list, event, log, tel) -> TrainState:
        """One supervised attempt over the plan; raises
        :class:`PermanentFailure` when the supervisor flags one.

        Each step runs inside a ``step`` span with ``data`` / ``dispatch`` /
        ``sync_wait`` / ``log`` / ``checkpoint`` children covering its full
        body, so the phase durations account for (nearly all of) the step's
        wall time; ``dispatch`` holds the step function's layer spans
        (``make_train_step``). Under ``torch.profiler`` (``ObsConfig.
        torch_profile_dir``, or a caller's) every span is a
        ``repro_torch/<span>`` range in the trace, so the kernels and the
        device's idle gaps can be put down to the layer or phase that the
        training thread was in.
        """
        reg = tel.registry
        saves = bool(self.checkpoint_dir) and grid.world.index == 0
        for stage in self.plan.stages:
            gb = stage.global_batch
            if start_step >= stage.first_step + stage.num_steps:
                continue       # fast-forward: stage fully covered by ckpt
            for i in range(stage.num_steps):
                gstep = stage.first_step + i
                if gstep < start_step:
                    continue   # fast-forward to the exact mid-stage step
                if max_steps is not None and gstep >= max_steps:
                    return state
                # pre-step health probe: a collective launched over a dead
                # axis wedges every rank, so detection must win that race
                failure = supervisor.check_health(gstep, self.fault_plan)
                if failure is not None:
                    raise failure
                epoch = epoch_of(self.plan, stage, i)
                with tel.span("step", step=gstep) as sp_step:
                    t_step = time.monotonic()
                    with tel.span("data", step=gstep) as sp_data:
                        batch = self._fetch_batch(data_fn, gstep, gb, event,
                                                  grid)
                        if self.fault_plan is not None:
                            batch = self.fault_plan.corrupt_batch(gstep,
                                                                  batch)
                        batch = shard_batch(batch, grid.world.index,
                                            grid.size)
                    t0 = time.monotonic()
                    with tel.span("dispatch", step=gstep) as sp_disp:
                        state, metrics = fn(state, batch, epoch, gb)
                    done = gstep + 1
                    # reading the flag waits for the step; without the guard
                    # there is nothing to read and elapsed covers dispatch
                    # only (then timeout detection needs injected signals)
                    with tel.span("sync_wait", step=gstep) as sp_sync:
                        skipped = (int(metrics["skipped"])
                                   if cfg.guard.enabled else 0)
                        now = time.monotonic()
                        elapsed, wall = now - t0, now - t_step
                        injected = (
                            self.fault_plan is not None
                            and hasattr(self.fault_plan, "step_timed_out")
                            and self.fault_plan.step_timed_out(gstep))
                        timed_out = _agree(grid, supervisor.timed_out(
                            injected, elapsed))
                    with tel.span("log", step=gstep) as sp_log:
                        if (done % cfg.log_every == 0
                                or i == stage.num_steps - 1 or skipped):
                            m = {k: float(v) for k, v in metrics.items()}
                            m.update(
                                step=done, epoch=epoch, global_batch=gb,
                                skipped=skipped,
                                nonfinite_count=int(
                                    metrics["nonfinite_count"]),
                                wall_s=wall, kind="metric")
                            history.append(m)
                            tel.emit(m)
                            log(f"step {done:5d} epoch {epoch:6.2f} "
                                f"gb {gb:6d} loss {m['loss']:.4f} "
                                f"lr {m['lr']:.3f} mom {m['momentum']:.3f} "
                                f"{1e3 * wall:.1f} ms"
                                + (f" SKIPPED "
                                   f"(nonfinite={m['nonfinite_count']}, "
                                   f"scale->{m['loss_scale']:g})"
                                   if skipped else ""))
                    # detection strictly precedes the periodic save: a
                    # failure here must not first persist a checkpoint whose
                    # step counter has advanced past the streak's skipped
                    # updates
                    failure = supervisor.observe_step(
                        gstep, skipped=bool(skipped), timed_out=timed_out)
                    if failure is not None:
                        raise failure
                    with tel.span("checkpoint", step=gstep) as sp_ckpt:
                        if (saves and cfg.ckpt_every_steps
                                and done % cfg.ckpt_every_steps == 0
                                and supervisor.healthy):
                            self._save_checkpoint(state, stage, event,
                                                  writer,
                                                  metrics=tel.registry)
                        if writer is not None:
                            self._drain(writer, event)
                # host-side step accounting (outside the step span so the
                # recording cost is not inside what it measures)
                reg.histogram("step/wall_s").observe(sp_step.duration)
                reg.histogram("step/data_s").observe(sp_data.duration)
                reg.histogram("step/sync_wait_s").observe(sp_sync.duration)
                reg.counter("train/steps").inc()
                if cfg.guard.enabled:
                    if skipped:
                        reg.counter("train/skipped_steps").inc()
                        reg.counter("train/nonfinite_total").inc(
                            int(metrics["nonfinite_count"]))
                    reg.gauge("train/loss_scale").set(
                        float(metrics["loss_scale"]))
                if (tel.sink is not None
                        and done % max(1, cfg.obs.step_metrics_every) == 0):
                    tel.emit({
                        "kind": "metric", "metric": "step_phases",
                        "step": done, "wall_s": sp_step.duration,
                        "phases": {"data": sp_data.duration,
                                   "dispatch": sp_disp.duration,
                                   "sync_wait": sp_sync.duration,
                                   "log": sp_log.duration,
                                   "checkpoint": sp_ckpt.duration}})
            # stage-boundary save, unless the periodic save just covered it
            if saves and not (cfg.ckpt_every_steps
                              and int(state.step) % cfg.ckpt_every_steps == 0):
                with tel.span("checkpoint", step=int(state.step)):
                    self._save_checkpoint(state, stage, event, writer,
                                          metrics=tel.registry)
        return state

    # -- recovery paths ---------------------------------------------------

    def _latest_valid(self, grid: TorusGrid, like: TrainState, event
                      ) -> str | None:
        """The newest valid checkpoint, as rank 0 finds it (after its
        writer's flush), on every rank; each rank records rank 0's
        rejections as ``checkpoint_rejected`` events."""
        path, rejected = None, []
        if grid.world.index == 0:
            path = checkpoint.latest_valid(
                self.checkpoint_dir, like=like,
                on_skip=lambda p, reason: rejected.append(
                    (os.path.basename(p), reason)), groups=self.leaf_groups)
        if grid.size > 1:
            box = [(path, rejected)]
            dist.broadcast_object_list(box, src=grid.world.ranks[0],
                                       group=grid.world.group)
            path, rejected = box[0]
        for name, reason in rejected:
            event("checkpoint_rejected", path=name, reason=reason)
        return path

    def _recover(self, state: TrainState, failure: PermanentFailure,
                 supervisor: Supervisor, grid: TorusGrid, writer, event
                 ) -> tuple[TrainState, int]:
        """Roll back past a permanent failure: flush in-flight saves, fold
        the failure into supervisor state, restore the newest valid
        checkpoint. Returns ``(state, start_step)`` for the next attempt;
        raises ``RuntimeError`` when recovery is impossible. Every rank
        takes the same path: the failure is the same on all of them."""
        event("elastic_failure", kind=failure.kind, step=failure.step,
              down_axes=list(failure.down_axes), detail=failure.detail)
        if supervisor.exhausted:
            raise RuntimeError(
                f"elastic recovery budget exhausted "
                f"({supervisor.cfg.max_recoveries} recoveries) at step "
                f"{failure.step}: {failure.kind}") from failure
        if writer is not None:
            # durability barrier: every enqueued save must be committed (or
            # failed) before latest_valid decides where to roll back to
            writer.flush()
            self._drain(writer, event)
        attempt = supervisor.start_recovery(failure)
        path = (self._latest_valid(grid, state, event)
                if self.checkpoint_dir else None)
        if path is None:
            raise RuntimeError(
                f"permanent failure at step {failure.step} "
                f"({failure.kind}) but no valid checkpoint to roll back "
                "to -- set checkpoint_dir to enable elastic recovery"
            ) from failure
        state = retry_call(
            lambda: checkpoint.restore(path, state, groups=self.leaf_groups),
            retries=self.cfg.ckpt_retries,
            backoff_s=self.cfg.retry_backoff_s, retry_on=(OSError,),
            seed=failure.step)
        start_step = int(state.step)
        event("elastic_recovery", attempt=attempt, step=start_step,
              path=os.path.basename(path),
              down_axes=list(supervisor.down_axes))
        return state, start_step

    def _fetch_batch(self, data_fn, gstep: int, gb: int, event,
                     grid: TorusGrid):
        """Fetch with the shared jittered-backoff retry helper. A rank whose
        retries ran out tells the others before any of them dispatches the
        step, so every rank raises at the same step."""
        failure = batch = None
        try:
            batch = retry_call(
                lambda: data_fn(gstep, gb),
                retries=self.cfg.data_retries,
                backoff_s=self.cfg.retry_backoff_s, retry_on=RETRYABLE,
                on_retry=lambda attempt, e: event(
                    "data_retry", step=gstep, attempt=attempt,
                    error=f"{type(e).__name__}: {e}"),
                seed=gstep)
        except RETRYABLE as e:
            failure = e
        if _agree(grid, failure is not None):
            raise RuntimeError(
                f"data_fn failed at step {gstep} after "
                f"{self.cfg.data_retries + 1} attempts"
                + ("" if failure is not None else " on another rank")
            ) from failure
        return batch

    def _save_checkpoint(self, state: TrainState, stage, event,
                         writer=None, metrics=NULL_REGISTRY) -> None:
        """Crash-consistent save; a checkpoint failure is an event, not a
        training abort (the run continues from the previous checkpoint).
        With ``writer`` the commit runs off-thread (its own ``metrics``
        registry, given at construction) and its outcome events arrive via
        :meth:`_drain`."""
        hook = (self.fault_plan.checkpoint_io_hook
                if self.fault_plan is not None else None)
        meta = ({"stage_end_epoch": stage.stage.end_epoch,
                 "global_batch": stage.global_batch}
                if stage is not None else {"initial": True})
        if writer is not None:
            try:
                writer.save(self.checkpoint_dir, state,
                            keep_last=self.cfg.ckpt_keep_last, meta=meta,
                            io_hook=hook, groups=self.leaf_groups)
            except checkpoint.CheckpointError as e:
                event("checkpoint_failed", step=int(state.step),
                      error=str(e))
            return
        try:
            path = checkpoint.save(
                self.checkpoint_dir, state,
                retries=self.cfg.ckpt_retries,
                backoff_s=self.cfg.retry_backoff_s,
                keep_last=self.cfg.ckpt_keep_last,
                meta=meta, io_hook=hook, metrics=metrics, groups=self.leaf_groups,
                on_retry=lambda attempt, e: event(
                    "checkpoint_retry", step=int(state.step),
                    attempt=attempt, error=str(e)))
            event("checkpoint", step=int(state.step),
                  path=os.path.basename(path))
        except checkpoint.CheckpointError as e:
            event("checkpoint_failed", step=int(state.step), error=str(e))

    @staticmethod
    def _drain(writer, event) -> None:
        """Re-emit completed async-save outcomes as history events (on the
        training thread, keeping history single-writer)."""
        for ev in writer.drain_events():
            ev = dict(ev)
            event(ev.pop("event"), **ev)
