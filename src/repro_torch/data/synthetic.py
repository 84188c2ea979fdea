"""Deterministic synthetic ImageNet (there is no ImageNet here).

``SyntheticImageNet`` makes class-conditional Gaussian-blob images: each of
the K classes has a fixed random low-resolution template; a sample is the
upsampled template plus noise. Batch ``i`` is a function of (seed, i) alone,
drawn with a ``torch.Generator`` on the target device, so any worker can
make its shard without coordination and the data never crosses the host.
The values differ from ``jax.random``'s; the structure is the same.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import device as device_lib


def generator(device: torch.device, seed: int, index: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from the pair (seed, index)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (index & 0xFFFFFFFF))
    return gen


@dataclasses.dataclass(frozen=True)
class SyntheticImageNet:
    num_classes: int = 1000
    image_size: int = 224
    seed: int = 0
    noise: float = 0.8
    device: str | torch.device | None = None

    @functools.cached_property
    def _device(self) -> torch.device:
        return device_lib.resolve(self.device)

    @functools.cached_property
    def _templates(self) -> torch.Tensor:
        return self.templates()

    def templates(self, downsample: int = 8) -> torch.Tensor:
        """Fixed per-class low-res templates (deterministic in seed)."""
        hw = self.image_size // downsample
        return torch.randn((self.num_classes, hw, hw, 3),
                           generator=generator(self._device, self.seed),
                           device=self._device)

    def batch(self, index: int, batch_size: int):
        """Batch ``index`` -> (images (B,H,W,3) fp32, labels (B,) int64)."""
        gen = generator(self._device, self.seed + 1, index)
        labels = torch.randint(0, self.num_classes, (batch_size,),
                               generator=gen, device=self._device)
        tmpl = self._templates[labels]                      # (B, hw, hw, 3)
        rep = self.image_size // tmpl.shape[1]
        up = tmpl.repeat_interleave(rep, 1).repeat_interleave(rep, 2)
        imgs = up + self.noise * torch.randn(
            (batch_size, self.image_size, self.image_size, 3), generator=gen,
            device=self._device)
        return imgs, labels
