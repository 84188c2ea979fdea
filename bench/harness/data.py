"""Weights and the generators of inputs from ``--seed``, made on the device
in a few large calls. The same seed gives the same weights and batches on
every rank and in every run; the program and the reference are handed the
same. Each kind of traffic makes its batches in ``bench/traffic/<kind>.py``
from ``generator(device, seed, 1)``.
"""

from __future__ import annotations

import torch

MASK = (1 << 63) - 1


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    whole number)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & MASK)
    return gen


def weights(shapes: dict, rule, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 leaves of ``shapes``: ``rule(name, shape)`` gives
    ("normal", std) or ("const", value). One normal draw for all the random
    leaves together, then each leaf scaled from its slice."""
    plan = {n: rule(n, s) for n, s in shapes.items()}
    total = sum(_numel(shapes[n]) for n, (kind, _) in plan.items() if kind == "normal")
    flat = torch.randn(total, generator=generator(device, seed, 0), device=device)
    out, off = {}, 0
    for n, (kind, value) in plan.items():
        shape = tuple(shapes[n])
        if kind == "normal":
            k = _numel(shape)
            out[n] = flat[off:off + k].view(shape) * value
            off += k
        else:
            out[n] = torch.full(shape, float(value), device=device)
    return out


def _numel(shape) -> int:
    k = 1
    for s in shape:
        k *= s
    return k
