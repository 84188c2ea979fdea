"""The control's precision: the reference with every matrix operand rounded
to 8-bit floats, the step below the configurations' bfloat16 compute that
would tempt a later change. As fp8 training does it (per-tensor scaling):
forward operands to e4m3 with the tensor's largest magnitude at e4m3's
largest value (448), and the gradient that flows back into each operand to
e5m2 (largest 57344); the arithmetic stays float32."""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def q(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 on the way in, its gradient to e5m2 on the way
    back."""
    return _FP8.apply(x)


class _BF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` and its gradient rounded to bfloat16: the configurations' own
    compute precision on the reference's matrix operands, the witness of
    what rounding alone reads."""
    return _BF16.apply(x)
