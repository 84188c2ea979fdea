"""Parameter initializers (paper §3.2: 'All layers in the model are
initialized by the values described in [10]' -- He-style fan-in normal for
convs, zeros for the last BN gamma of each residual block).

Random values come from the caller's ``torch.Generator``, which also fixes
the device. They differ from ``jax.random``'s for the same seed; tests carry
weights across with ``repro_torch.convert`` instead.
"""

from __future__ import annotations

import math

import torch


def _fan_in(shape, fan_in):
    return math.prod(shape[:-1]) if fan_in is None else fan_in


def he_normal(generator: torch.Generator, shape, fan_in=None,
              dtype=torch.float32) -> torch.Tensor:
    std = math.sqrt(2.0 / max(_fan_in(shape, fan_in), 1))
    return std * torch.randn(shape, generator=generator, dtype=dtype,
                             device=generator.device)


def lecun_normal(generator: torch.Generator, shape, fan_in=None,
                 dtype=torch.float32) -> torch.Tensor:
    std = math.sqrt(1.0 / max(_fan_in(shape, fan_in), 1))
    return std * torch.randn(shape, generator=generator, dtype=dtype,
                             device=generator.device)


def normal(generator: torch.Generator, shape, std=0.02,
           dtype=torch.float32) -> torch.Tensor:
    return std * torch.randn(shape, generator=generator, dtype=dtype,
                             device=generator.device)
