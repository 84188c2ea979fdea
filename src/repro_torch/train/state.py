"""Train state: fp32 master params + LARS momentum + step counter, plus the
dynamic loss-scale guard state (scale + clean-step counter) used by the
non-finite-gradient guard in ``trainer.make_train_step``."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lars


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: dict
    step: int
    # the loss is multiplied by ``loss_scale`` before backward and the grads
    # are unscaled; the scale backs off on non-finite steps and regrows after
    # GuardConfig.growth_interval consecutive clean steps (``good_steps``).
    # Both stay on the params' device: reading them would stall the stream.
    loss_scale: torch.Tensor
    good_steps: torch.Tensor

    @staticmethod
    def create(params: dict[str, torch.Tensor],
               loss_scale: float = 1.0) -> "TrainState":
        params = {k: p.detach() for k, p in params.items()}
        dev = next(iter(params.values())).device
        return TrainState(params=params, opt_state=lars.init(params), step=0,
                          loss_scale=torch.tensor(loss_scale, dtype=torch.float32,
                                                  device=dev),
                          good_steps=torch.zeros((), dtype=torch.int32, device=dev))
