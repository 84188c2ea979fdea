"""Elastic self-healing: permanent-failure detection + recovery supervision
(``repro/train/elastic.py``).

The transient fault layer handles *transient* faults (a NaN step, a flaky
data read, a crashed checkpoint write) and *startup-time* degradation (a
torus axis already down when the job launches). This module handles the
remaining class: the hardware degrades **mid-run** -- a torus link dies at
step k, a node starts emitting garbage gradients, steps begin timing out --
and the job must finish anyway, on the degraded grid, without a process
restart.

The split of responsibilities:

* :class:`Supervisor` (this module) is pure bookkeeping: it accumulates
  health signals per step, decides when a fault pattern is *permanent*
  (vs. the transient blips the in-step guard already absorbs), and tracks
  the accumulated set of down axes plus the recovery budget. It raises
  nothing and touches no tensor -- fully unit-testable.
* ``Trainer.run`` owns the actual recovery loop: on a
  :class:`PermanentFailure` it flushes the async checkpoint writer,
  re-resolves the grad-sync strategy via ``resolve_sync_config`` with the
  enlarged down-axis set (emitting a mid-run ``grad_sync_downgrade``
  event), rebuilds the train step for the degraded grid, restores from the
  newest valid checkpoint, and re-enters the step loop. On more than one
  rank the trainer first makes every rank's signals agree (one MAX
  all-reduce), so every rank reaches the same verdict at the same step.

Permanence heuristics (all thresholds in :class:`ElasticConfig`):

* **axis down** -- a grid axis newly reported dead by the health source
  (``FaultPlan.down_axes_at`` in tests; a real deployment plugs its
  heartbeat monitor into the same trainer hook). One report is permanent:
  links do not resurrect mid-run.
* **non-finite streak** -- the in-step guard skipping
  ``max_consecutive_nonfinite`` steps in a row. Isolated overflows are the
  guard's job (backoff + skip); an unbroken streak means the loss scale
  cannot save us (sick node, corrupted weights) and only a rollback can.
* **timeout streak** -- ``max_consecutive_timeouts`` consecutive steps
  over ``step_timeout_s`` wall-clock (or injected timeout signals): a
  straggler that never recovers is a dead worker with extra steps.
"""

from __future__ import annotations

import dataclasses

from repro_torch.obs.metrics import NULL_REGISTRY


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Thresholds separating transient faults from permanent failures."""

    enabled: bool = True
    #: consecutive guard-skipped steps before the numeric fault is treated
    #: as permanent (rollback instead of more loss-scale backoff)
    max_consecutive_nonfinite: int = 8
    #: consecutive timed-out steps before the straggler is treated as dead
    max_consecutive_timeouts: int = 3
    #: wall-clock budget per step; None disables clock-based detection
    #: (injected FaultPlan timeout signals still count)
    step_timeout_s: float | None = None
    #: recovery attempts before the supervisor gives up and aborts
    max_recoveries: int = 3


class PermanentFailure(RuntimeError):
    """A fault pattern the in-step/transient machinery cannot absorb.

    Raised by ``Trainer`` when the :class:`Supervisor` reports one; carries
    everything the recovery path needs (and everything the
    ``elastic_failure`` history event records).
    """

    def __init__(self, kind: str, step: int,
                 down_axes: tuple[str, ...] = (), detail: str = ""):
        super().__init__(
            f"permanent failure at step {step}: {kind}"
            + (f" (axes {list(down_axes)})" if down_axes else "")
            + (f" -- {detail}" if detail else ""))
        self.kind = kind
        self.step = step
        self.down_axes = tuple(down_axes)
        self.detail = detail


class Supervisor:
    """Accumulates per-step health signals and the recovery budget.

    One instance supervises one ``Trainer.run`` call across all of its
    recovery attempts; streak counters reset on recovery (the rollback
    changed the world), the down-axis set and recovery count only grow.

    ``metrics`` (repro_torch.obs.metrics registry) mirrors the bookkeeping as
    ``elastic/*`` counters and gauges so a run's health history survives in
    the metrics JSONL summary -- ``chip_smoke.py``'s chaos run gates on
    ``elastic/recoveries`` being one under injected faults and zero
    fault-free.
    """

    def __init__(self, cfg: ElasticConfig,
                 initial_down_axes: tuple[str, ...] = (),
                 metrics=NULL_REGISTRY):
        self.cfg = cfg
        self._down: set[str] = set(initial_down_axes)
        self.recoveries = 0
        self._nonfinite_streak = 0
        self._timeout_streak = 0
        self._metrics = metrics
        metrics.gauge("elastic/down_axes").set(len(self._down))

    @property
    def down_axes(self) -> tuple[str, ...]:
        return tuple(sorted(self._down))

    @property
    def exhausted(self) -> bool:
        return self.recoveries >= self.cfg.max_recoveries

    @property
    def healthy(self) -> bool:
        """No fault streak in progress. The trainer only takes *periodic*
        checkpoints of healthy states: a checkpoint stamped mid-streak
        carries a step counter past updates that were skipped, so rolling
        back to it would silently drop them."""
        return self._nonfinite_streak == 0 and self._timeout_streak == 0

    # -- detection ---------------------------------------------------------

    def check_health(self, step: int, fault_plan) -> PermanentFailure | None:
        """Pre-step health probe: any grid axis newly reported down?

        Runs *before* the step is dispatched -- launching a collective over
        a dead axis wedges every rank, so the probe must win the race.
        """
        if not self.cfg.enabled or fault_plan is None:
            return None
        probe = getattr(fault_plan, "down_axes_at", None)
        if probe is None:
            return None
        new = set(probe(step)) - self._down
        if new:
            self._metrics.counter("elastic/permanent_failures").inc()
            return PermanentFailure(
                "axis_down", step, down_axes=tuple(sorted(new)),
                detail="health probe reports torus axis(es) dead")
        return None

    def timed_out(self, timed_out: bool, elapsed_s: float | None) -> bool:
        """A step's timeout signal: injected, or more than ``step_timeout_s``
        of wall clock. Local to a rank; the trainer makes the ranks agree
        on it before ``observe_step``."""
        return timed_out or (self.cfg.step_timeout_s is not None
                             and elapsed_s is not None
                             and elapsed_s > self.cfg.step_timeout_s)

    def observe_step(self, step: int, *, skipped: bool,
                     timed_out: bool = False,
                     elapsed_s: float | None = None
                     ) -> PermanentFailure | None:
        """Post-step signal intake; returns a failure once a streak crosses
        its permanence threshold."""
        if not self.cfg.enabled:
            return None
        self._nonfinite_streak = self._nonfinite_streak + 1 if skipped else 0
        if skipped:
            self._metrics.counter("elastic/skipped_steps").inc()
        timed_out = self.timed_out(timed_out, elapsed_s)
        self._timeout_streak = self._timeout_streak + 1 if timed_out else 0
        if timed_out:
            self._metrics.counter("elastic/timeout_steps").inc()
        if self._nonfinite_streak >= self.cfg.max_consecutive_nonfinite:
            self._metrics.counter("elastic/permanent_failures").inc()
            return PermanentFailure(
                "nonfinite_streak", step,
                detail=f"{self._nonfinite_streak} consecutive guard-skipped "
                       "steps; loss-scale backoff cannot recover this")
        if self._timeout_streak >= self.cfg.max_consecutive_timeouts:
            self._metrics.counter("elastic/permanent_failures").inc()
            return PermanentFailure(
                "timeout", step,
                detail=f"{self._timeout_streak} consecutive step timeouts")
        return None

    # -- recovery bookkeeping ---------------------------------------------

    def start_recovery(self, failure: PermanentFailure) -> int:
        """Fold the failure into supervisor state; returns the attempt
        number (1-based). Caller must have checked ``exhausted`` first."""
        self._down |= set(failure.down_axes)
        self._nonfinite_streak = 0
        self._timeout_streak = 0
        self.recoveries += 1
        self._metrics.counter("elastic/recoveries").inc()
        self._metrics.gauge("elastic/down_axes").set(len(self._down))
        return self.recoveries
