"""Deterministic fault injection for the fault-tolerant training loop
(``repro/testing/chaos.py``; the same plans, the same poisoned elements).

At the paper's scale (2,176 GPUs, 122-second runs) transient faults are the
norm: a half-precision gradient overflows, a data worker hiccups, a node
dies mid-checkpoint, a torus link drops. None of those may abort the job.
This module *simulates* each fault class deterministically so every
recovery path in ``Trainer`` / ``checkpoint`` / ``grad_sync`` is
exercisable on the CPU's gloo ranks and on the card.

A :class:`FaultPlan` is pure configuration plus a little bookkeeping for
"fail the first N attempts" semantics. The trainer consults it at three
points:

* ``corrupt_batch(step, batch)``  -- poisons float leaves of the batch with
  NaN/Inf at the chosen steps, which drives non-finite losses/gradients
  through the *real* forward/backward/sync pipeline (exactly how an fp16
  overflow presents), exercising the in-step guard. The trainer poisons
  the *global* batch before each rank takes its rows, so the element lands
  on the rank that the reference's batch sharding puts it on.
* ``wrap_data_fn(data_fn)``       -- raises :class:`TransientDataError`
  from the data function for the first ``data_failures_per_step`` attempts
  at the chosen steps, exercising the retry-with-backoff path.
* ``checkpoint_io_hook``          -- passed to ``checkpoint.save``; raises
  ``OSError`` mid-write (after the payload bytes, before the atomic
  rename) for the chosen save indices, exercising crash-consistency and
  the save retry loop.

``down_axes`` marks mesh axes of the logical torus as "down"; the
strategy-fallback chain in ``grad_sync.resolve_sync_config`` then refuses
strategies whose phase decomposition depends on those axes and degrades
(torus2d -> ring -> psum) instead of aborting.

Beyond the transient classes above, a plan can schedule **permanent**
failures for the elastic recovery layer (``repro_torch.train.elastic``):

* ``axis_down_events``       -- (axis, step) pairs: the axis is healthy
  until ``step`` and dead from then on. ``down_axes_at(step)`` is the
  health probe the trainer's supervisor polls each step; detection must
  trigger a mid-run strategy re-resolution + checkpoint rollback.
* ``timeout_steps``          -- steps reported as timed out (a straggler);
  consumed per *invocation* so a rolled-back replay of the same step is
  clean, mirroring "the dead worker got replaced".
* ``grad_fault_once=True``   -- NaN/Inf poisoning fires only on the first
  visit to each step, so a rollback past a poisoned streak replays clean.
* ``ckpt_dir_fail_from``     -- every checkpoint write from that save
  index onward fails *persistently* (dead filesystem, not a blip): the
  run must keep training and ``latest_valid`` must keep resolving to the
  last pre-failure checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class TransientDataError(RuntimeError):
    """A data-pipeline failure that is expected to succeed on retry."""


#: Exception classes the trainer treats as retryable when fetching a batch.
RETRYABLE = (TransientDataError, OSError, TimeoutError)


@dataclasses.dataclass
class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Steps are *global* step indices (``StagePlan.first_step + i``), so a
    plan replays identically across resumes. Instances carry attempt
    counters, so use a fresh plan per training run.
    """

    seed: int = 0
    nan_grad_steps: tuple[int, ...] = ()     # batch poisoned with NaN
    inf_grad_steps: tuple[int, ...] = ()     # batch poisoned with +Inf
    grad_fault_once: bool = False            # poison each step only once
    data_fail_steps: tuple[int, ...] = ()    # data_fn raises (transient)
    data_failures_per_step: int = 1          # consecutive failures per step
    ckpt_crash_writes: tuple[int, ...] = ()  # save indices crashed mid-file
    ckpt_crashes_per_write: int = 1          # consecutive crashes per save
    ckpt_dir_fail_from: int = -1             # all saves >= idx fail (perm.)
    down_axes: tuple[str, ...] = ()          # torus axes down from step 0
    axis_down_events: tuple[tuple[str, int], ...] = ()  # (axis, down_step)
    timeout_steps: tuple[int, ...] = ()      # steps reported timed out
    timeouts_per_step: int = 1               # consecutive timeouts per step

    def __post_init__(self):
        self._data_attempts: dict[int, int] = {}
        self._timeout_attempts: dict[int, int] = {}
        self._poisoned: set[int] = set()
        self._ckpt_save_idx = -1

    # -- gradient corruption ------------------------------------------------

    def corrupt_batch(self, step: int, batch):
        """Poison one element of every float leaf at a faulted step.

        A single non-finite input element is enough: it propagates through
        the forward pass to the loss and from there into every gradient
        leaf, which is how a real reduced-precision overflow presents after
        the all-reduce.
        """
        if step in self.nan_grad_steps:
            val = float("nan")
        elif step in self.inf_grad_steps:
            val = float("inf")
        else:
            return batch
        if self.grad_fault_once:
            # once-per-step semantics: a rollback past a poisoned streak
            # replays clean (the faulty node was replaced)
            if step in self._poisoned:
                return batch
            self._poisoned.add(step)

        def poison(leaf):
            if isinstance(leaf, (tuple, list)):
                return type(leaf)(poison(x) for x in leaf)
            if isinstance(leaf, dict):
                return {k: poison(v) for k, v in leaf.items()}
            if (not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point()
                    or leaf.numel() == 0):
                return leaf
            flat = leaf.reshape(-1).clone()   # the caller's batch stays as it was
            flat[(self.seed + step) % flat.numel()] = val
            return flat.view(leaf.shape)

        return poison(batch)

    # -- transient data failures --------------------------------------------

    def wrap_data_fn(self, data_fn):
        """Wrap ``data_fn(step, global_batch)`` with injected transient
        failures: the first ``data_failures_per_step`` calls at each step in
        ``data_fail_steps`` raise, subsequent calls pass through."""

        def wrapped(step, global_batch):
            if step in self.data_fail_steps:
                n = self._data_attempts.get(step, 0)
                if n < self.data_failures_per_step:
                    self._data_attempts[step] = n + 1
                    raise TransientDataError(
                        f"injected data failure at step {step} "
                        f"(attempt {n + 1}/{self.data_failures_per_step})")
            return data_fn(step, global_batch)

        return wrapped

    # -- permanent failures (elastic recovery layer) ------------------------

    def down_axes_at(self, step: int) -> tuple[str, ...]:
        """Health probe: every torus axis dead at global ``step``.

        ``down_axes`` are dead from launch; ``axis_down_events`` axes die
        permanently at their scheduled step. The trainer's elastic
        supervisor polls this before each step and treats any *new* axis as
        a permanent failure.
        """
        dead = set(self.down_axes)
        dead.update(a for a, s in self.axis_down_events if step >= s)
        return tuple(sorted(dead))

    def step_timed_out(self, step: int) -> bool:
        """Straggler signal: True for the first ``timeouts_per_step``
        invocations at each step in ``timeout_steps`` (invocation-counted,
        like data failures, so a rolled-back replay runs clean)."""
        if step not in self.timeout_steps:
            return False
        n = self._timeout_attempts.get(step, 0)
        if n >= self.timeouts_per_step:
            return False
        self._timeout_attempts[step] = n + 1
        return True

    # -- checkpoint-write crashes -------------------------------------------

    def checkpoint_io_hook(self, phase: str, attempt: int) -> None:
        """IO hook for ``checkpoint.save`` (phases: begin/payload/manifest).

        Crashes the ``payload`` phase -- bytes written to the tmp file but
        not yet durable/renamed -- of save number ``i`` for every ``i`` in
        ``ckpt_crash_writes``, for the first ``ckpt_crashes_per_write``
        attempts. The atomic-write protocol must leave either the previous
        complete checkpoint or nothing.
        """
        if phase == "begin":
            if attempt == 0:
                self._ckpt_save_idx += 1
            return
        if phase != "payload":
            return
        if 0 <= self.ckpt_dir_fail_from <= self._ckpt_save_idx:
            # persistent: every attempt of every save from here on fails
            # (dead checkpoint filesystem) -- retries must NOT absorb it
            raise OSError(
                f"injected persistent checkpoint-dir failure (save "
                f"#{self._ckpt_save_idx} >= {self.ckpt_dir_fail_from})")
        if (self._ckpt_save_idx in self.ckpt_crash_writes
                and attempt < self.ckpt_crashes_per_write):
            raise OSError(
                f"injected checkpoint-write crash (save "
                f"#{self._ckpt_save_idx}, attempt {attempt})")

    # -- convenience --------------------------------------------------------

    @staticmethod
    def random(seed: int, total_steps: int, *, p_nan: float = 0.05,
               p_data: float = 0.05, n_ckpt_crashes: int = 1) -> "FaultPlan":
        """A random-but-reproducible plan (seeded numpy RNG)."""
        rng = np.random.default_rng(seed)
        steps = np.arange(total_steps)
        nan_steps = tuple(int(s) for s in steps[rng.random(total_steps) < p_nan])
        data_steps = tuple(int(s) for s in steps[rng.random(total_steps) < p_data])
        return FaultPlan(seed=seed, nan_grad_steps=nan_steps,
                         data_fail_steps=data_steps,
                         ckpt_crash_writes=tuple(range(n_ckpt_crashes)))
