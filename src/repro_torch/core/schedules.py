"""Learning-rate / momentum / batch-size schedules from the paper (§3.2).

Configuration A (from the TensorFlow TPU ResNet repo the paper cites):
  34-epoch linear LR warmup from 1e-5 to base LR 34.0, then polynomial
  (power-2) decay to 0 at epoch 90.

Configuration B (based on You et al. [10] + Smith & Le [16]):
  5-epoch linear warmup 0.2 -> 29, then
      lr(e) = 29 * (1 - e/90)^2          for e < 30
      lr(e) = 50 * (1 - e/90)^2          otherwise
  with momentum recomputed from the SGD noise scale, anchored at the
  reference run (B_ref = 32*1024, m_ref = 0.9):
      m(B) = 1 - (1 - m_ref) * B_ref / B     (clipped to [0, 0.999])

Batch-size control (§2.1, Table 3): a predetermined schedule of per-worker
batch sizes over epoch ranges (``BatchStage``).

The epoch and batch size are host values, so the schedules run on the host
and touch no device. They compute in fp32 (numpy), in the JAX package's
order of operations, so both packages feed LARS the same learning rate; a
Python-float version differs by up to 5e-6 relative near epoch 90, where
1 - e/90 cancels.
"""

from __future__ import annotations

import dataclasses

import numpy as np

REF_BATCH = 32 * 1024     # paper's reference configuration (Table 3)
REF_MOMENTUM = 0.9
TOTAL_EPOCHS = 90.0


f32 = np.float32


def _clip(x, lo: float, hi: float):
    return min(max(x, f32(lo)), f32(hi))


@dataclasses.dataclass(frozen=True)
class ConfigA:
    base_lr: float = 34.0
    init_lr: float = 1e-5
    warmup_epochs: float = 34.0
    total_epochs: float = TOTAL_EPOCHS
    momentum: float = 0.9
    power: float = 2.0

    def lr(self, epoch: float) -> float:
        e = f32(epoch)
        if e < self.warmup_epochs:
            return float(f32(self.base_lr - self.init_lr) * e
                         / f32(self.warmup_epochs) + f32(self.init_lr))
        frac = _clip((f32(self.total_epochs) - e)
                     / f32(self.total_epochs - self.warmup_epochs), 0.0, 1.0)
        return float(f32(self.base_lr) * np.power(frac, f32(self.power)))

    def mom(self, epoch: float, batch_size: float | None = None) -> float:
        del epoch, batch_size
        return float(f32(self.momentum))


@dataclasses.dataclass(frozen=True)
class ConfigB:
    warmup_epochs: float = 5.0
    warmup_init: float = 0.2
    base_lr_1: float = 29.0    # exact value from [10]
    base_lr_2: float = 50.0    # max suggested by [3]
    switch_epoch: float = 30.0
    total_epochs: float = TOTAL_EPOCHS
    ref_batch: int = REF_BATCH
    ref_momentum: float = REF_MOMENTUM

    def lr(self, epoch: float) -> float:
        e = f32(epoch)
        if e < self.warmup_epochs:
            return float(f32(self.base_lr_1 - self.warmup_init) * e
                         / f32(self.warmup_epochs) + f32(self.warmup_init))
        d = f32(1.0) - e / f32(self.total_epochs)
        base = self.base_lr_1 if e < self.switch_epoch else self.base_lr_2
        return float(f32(base) * (d * d))

    def mom(self, epoch: float, batch_size: float) -> float:
        """Momentum from constant SGD noise scale (Smith & Le [16])."""
        del epoch  # m depends only on B under the constant-noise anchor
        c = f32((1.0 - self.ref_momentum) * self.ref_batch)
        return float(_clip(f32(1.0) - c / f32(batch_size), 0.0, 0.999))


SCHEDULES = {"A": ConfigA, "B": ConfigB}


def make(name: str, **kw):
    return SCHEDULES[name](**kw)


# ---------------------------------------------------------------------------
# Batch-size control (paper Table 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchStage:
    start_epoch: float
    end_epoch: float
    per_worker_batch: int

    def global_batch(self, n_workers: int) -> int:
        return self.per_worker_batch * n_workers


@dataclasses.dataclass(frozen=True)
class BatchSchedule:
    stages: tuple[BatchStage, ...]

    def __post_init__(self):
        es = list(self.stages)
        for a, b in zip(es, es[1:]):
            if a.end_epoch != b.start_epoch:
                raise ValueError(f"non-contiguous stages: {a} -> {b}")

    @property
    def total_epochs(self) -> float:
        return self.stages[-1].end_epoch

    def stage_at(self, epoch: float) -> BatchStage:
        for s in self.stages:
            if s.start_epoch <= epoch < s.end_epoch:
                return s
        return self.stages[-1]


def paper_schedule(exp: str) -> BatchSchedule:
    """The per-worker batch-size schedules of Table 3."""
    S = BatchStage
    table = {
        # Reference: flat 32/worker for 90 epochs
        "reference": (S(0, 90, 32),),
        # Exp. 1: 16/worker -> 32/worker at epoch 30 (34K -> 68K at 2176 GPUs)
        "exp1": (S(0, 30, 16), S(30, 90, 32)),
        # Exp. 2: 54K flat, modelled as two global-size-preserving stages
        "exp2": (S(0, 30, 16), S(30, 90, 16)),
        # Exp. 3: 54K -> 64K
        "exp3": (S(0, 30, 16), S(30, 90, 19)),
        # Exp. 4: 34K -> 68K -> 85K -> 119K (4096 GPUs)
        "exp4": (S(0, 30, 16), S(30, 45, 16), S(45, 75, 32), S(75, 90, 32)),
    }
    return BatchSchedule(stages=table[exp])
