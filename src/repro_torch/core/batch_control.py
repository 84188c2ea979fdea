"""Batch-size control: turning a BatchSchedule into an executable training
plan (paper §2.1 -- "a predetermined batch-size adjustment scheduling is
employed during the training").

The plan enumerates stages; the trainer runs one step function for all of
them. LR/momentum schedules are evaluated per-step from the *fractional
epoch*, which advances by global_batch/dataset_size each step -- exactly the
paper's `epoch = ProcessedSamples / DataSize`.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.schedules import BatchSchedule, BatchStage


@dataclasses.dataclass(frozen=True)
class StagePlan:
    stage: BatchStage
    global_batch: int
    num_steps: int
    first_step: int
    start_epoch: float


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    stages: tuple[StagePlan, ...]
    dataset_size: int
    n_workers: int

    @property
    def total_steps(self) -> int:
        return sum(s.num_steps for s in self.stages)


def build_plan(schedule: BatchSchedule, *, dataset_size: int,
               n_workers: int, max_steps: int | None = None) -> TrainPlan:
    plans = []
    step = 0
    for st in schedule.stages:
        gb = st.global_batch(n_workers)
        span = st.end_epoch - st.start_epoch
        n = math.ceil(span * dataset_size / gb)
        if max_steps is not None:
            n = min(n, max(0, max_steps - step))
        plans.append(StagePlan(stage=st, global_batch=gb, num_steps=n,
                               first_step=step, start_epoch=st.start_epoch))
        step += n
        if max_steps is not None and step >= max_steps:
            break
    return TrainPlan(stages=tuple(plans), dataset_size=dataset_size,
                     n_workers=n_workers)


def epoch_of(plan: TrainPlan, stage: StagePlan, step_in_stage: int) -> float:
    """Fractional epoch at a given step (paper's ProcessedSamples/DataSize)."""
    return stage.start_epoch + step_in_stage * stage.global_batch / plan.dataset_size
