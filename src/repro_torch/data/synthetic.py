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


@functools.lru_cache(maxsize=8)
def _rule_powers(vocab: int, n: int, device: torch.device):
    """(7^m mod V, 11 (7^m - 1) / 6 mod V) for m = 0 .. n - 1, int64, on
    ``device``: f^m(x) = (a[m] x + c[m]) mod V, as f^(m+1) = f(f^m)."""
    a, c = [1], [0]
    for _ in range(n - 1):
        a.append(a[-1] * 7 % vocab)
        c.append((c[-1] * 7 + 11) % vocab)
    return (torch.tensor(a, dtype=torch.int64, device=device),
            torch.tensor(c, dtype=torch.int64, device=device))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """A token stream a language model can learn (``repro/data/synthetic.py``):
    with probability 0.5 the next token is f(prev) = (prev * 7 + 11) mod V,
    else a fresh uniform draw; labels are the next token.

    Batch ``i`` is a function of (seed, i) alone, drawn on the target device
    from a ``torch.Generator``. No loop over positions: the token at t is
    f^n(r) for r the last fresh token, n steps back, and
    f^n(x) = (7^n x + 11 (7^n - 1) / 6) mod V comes from two int64 tables
    over n (built once a length) and a ``cummax`` of the fresh positions.
    """
    vocab: int = 32000
    seed: int = 0
    device: str | torch.device | None = None

    @functools.cached_property
    def _device(self) -> torch.device:
        return device_lib.resolve(self.device)

    def draws(self, index: int, batch_size: int, seq_len: int):
        """Batch ``index``'s random draws: fresh tokens (B, S + 1) int64 and
        the rule's coin (B, S) bool, True where token t + 1 follows f."""
        gen = generator(self._device, self.seed + 2, index)
        rnd = torch.randint(0, self.vocab, (batch_size, seq_len + 1), generator=gen,
                            device=self._device)
        use = torch.rand((batch_size, seq_len), generator=gen, device=self._device) < 0.5
        return rnd, use

    def batch(self, index: int, batch_size: int, seq_len: int):
        """Batch ``index`` -> (tokens (B, S) int64, labels (B, S) int64), the
        labels the tokens shifted by one."""
        rnd, use = self.draws(index, batch_size, seq_len)
        n = seq_len + 1
        pos = torch.arange(n, device=self._device).expand(batch_size, n)
        fresh = torch.ones((batch_size, n), dtype=torch.bool, device=self._device)
        fresh[:, 1:] = ~use
        last = torch.where(fresh, pos, torch.zeros_like(pos)).cummax(dim=1).values
        a, c = _rule_powers(self.vocab, n, self._device)
        steps = pos - last
        tokens = (a[steps] * torch.gather(rnd, 1, last) + c[steps]) % self.vocab
        return tokens[:, :-1], tokens[:, 1:]
