"""Layers: plain functions on tensors, and the small modules that hold the
ResNet's parameters under the JAX package's names (``kernel``, ``bias``,
``bn_scale``, ``bn_bias``). The transformer's layers (norms, embedding,
MLP) take their parameters as tensors from the model's tree
(``models/transformer.py``).

Layout: the functions take NCHW activations (the permuted NHWC input keeps
channels-last strides, which cuDNN prefers) and OIHW conv kernels;
``repro_torch.convert`` maps the JAX package's HWIO kernels.

Mixed precision follows ``repro/nn/layers.py``: parameters are fp32
masters, cast to the activations' dtype at apply time -- the BN scale and
bias included, so BN computes in fp32 with bf16-rounded affine values, as
the JAX model does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import init as winit
from repro_torch.utils import dtensor


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Compute-dtype view of an fp32 master tensor (others pass through)."""
    return t.to(dtype) if t.dtype == torch.float32 else t


def same_pads(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding (lo, hi) of one spatial dim.

    At stride 2 the total is odd for even sizes and the extra pad goes
    last (bottom/right); torch's symmetric ``padding=`` cannot express it.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kh: int, kw: int, stride: int, value=0.0):
    """(x padded where asymmetric, symmetric padding left for the op)."""
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with OIHW ``kernel`` and XLA "SAME" padding."""
    x, pad = _pad_same(x, kernel.shape[2], kernel.shape[3], stride)
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, padding=pad)


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ kernel (+ bias); ``kernel`` is (in, out) as in the JAX package."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group, forward and backward: the cotangent of
    each rank's input is the sum of every rank's output cotangent, as
    ``jax.grad`` of ``lax.psum`` inside ``shard_map`` gives it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              stats=None, grid=None, eps: float = 1e-5, return_stats: bool = False):
    """BN "without moving average" (paper §3.2 / Akiba et al. [5]), channel
    dim 1.

    Train: batch mean and variance in fp32, the variance as E[x^2] - mean^2.
    With ``grid`` (a built ``core.topology.TorusGrid``) of more than one
    rank, the mean and squared mean are averaged over all its ranks in fp32
    ("communication to synchronize batch mean and batch squared mean was
    conducted in FP32"), one all-reduce for both, gradients included, as
    the JAX package's ``dp_axes``. Eval: ``stats`` = (mean, var) from a
    calibration pass.
    """
    axes = [d for d in range(x.dim()) if d != 1]
    xf = x.float()
    if stats is not None:
        mean, var = stats
    else:
        mean = xf.mean(axes)
        sq = (xf * xf).mean(axes)
        if grid is not None and grid.size > 1:
            moments = _AllReduceSum.apply(torch.stack([mean, sq]), grid.world.group)
            mean, sq = moments.unbind(0)
            mean, sq = mean / grid.size, sq / grid.size
        var = sq - mean * mean
    shape = [1] * x.dim()
    shape[1] = -1
    inv = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean.view(shape)) * inv.view(shape) + bias.float().view(shape)
    y = y.to(x.dtype)
    return (y, (mean, var)) if return_stats else y


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2) -> torch.Tensor:
    """NCHW max pool with XLA "SAME" padding (pads with -inf)."""
    x, pad = _pad_same(x, window, window, stride, value=float("-inf"))
    return F.max_pool2d(x, window, stride, padding=pad)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int) -> nn.ParameterDict:
    """A bias-free ``kernel`` (in, out), LeCun fan-in normal: the
    transformer's projections and MLP matrices."""
    return nn.ParameterDict({"kernel": winit.lecun_normal(gen, (in_dim, out_dim))})


def layernorm_init(dim: int, device) -> nn.ParameterDict:
    return nn.ParameterDict({"norm_scale": torch.ones(dim, device=device),
                             "norm_bias": torch.zeros(dim, device=device)})


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, output in x's dtype."""
    xf = dtensor.unshard(x, -1).float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return dtensor.grad_unsharded(((xf - mu) * torch.rsqrt(var + eps) * scale
                                   + bias).to(x.dtype))


def rmsnorm_init(dim: int, device) -> nn.ParameterDict:
    """``norm_scale``, zero-init: applied as ``1 + w``."""
    return nn.ParameterDict({"norm_scale": torch.zeros(dim, device=device)})


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm for every arch: the scale is stored as ``w`` and
    applied as ``1 + w`` (zero init), fp32 inside, output in x's dtype.

    A DTensor (the dry run) is made whole along the normalised dim, its
    pending sums reduced, and so is its gradient's on the way back:
    DTensor would otherwise keep a sum pending through the scaling, or the
    output sharded along d, and every matmul after (or, for the gradient,
    before) the norm would gather its weight."""
    xf = dtensor.unshard(x, -1).float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return dtensor.grad_unsharded((y * (1.0 + scale)).to(x.dtype))


def embed(embedding: torch.Tensor, ids: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The rows of ``ids``; a DTensor table (the dry run) over its vocab
    shards (``dtensor.vocab_lookup``)."""
    return dtensor.vocab_lookup(cast(embedding, dtype), ids)


def unembed(embedding: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied output projection: x @ embedding.T in x's dtype."""
    return x @ cast(embedding, x.dtype).T


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# jax.nn.gelu is the tanh approximation unless told otherwise, so "gelu"
# and "gelu_tanh" are the same function.
ACTS = {"gelu": _gelu_tanh, "silu": F.silu, "relu": F.relu, "gelu_tanh": _gelu_tanh}


def causal_conv(x: torch.Tensor, kernel: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv of width W over x (B, S, C) with ``kernel``
    (W, C), after ``state`` (B, W-1, C), the previous inputs, when decoding
    (zeros otherwise). The reference's W-tap sum in x's dtype (``F.conv1d``
    would accumulate otherwise in bf16). Returns (y, new_state): the last
    W-1 inputs, copied, since a view would keep the whole padded buffer
    alive in a cache."""
    w = cast(kernel, x.dtype)
    W, S = w.shape[0], x.shape[1]
    pad = x.new_zeros(x.shape[0], W - 1, x.shape[-1]) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                                 # (B, S+W-1, C)
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, -(W - 1):].clone()


def mlp(p: dict, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    """(Gated) MLP over ``{"up", "down"[, "gate"]}: {"kernel": (in, out)}``."""
    h = dense(x, p["up"]["kernel"])
    if "gate" in p:
        h = h * ACTS[act](dense(x, p["gate"]["kernel"]))
    else:
        h = ACTS[act](h)
    return dense(h, p["down"]["kernel"])


# ----------------------------------------------------------------- modules --

class Conv(nn.Module):
    """Holds ``kernel`` (cout, cin, kh, kw), He fan-in init."""

    def __init__(self, generator: torch.Generator, kh: int, kw: int,
                 cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(
            winit.he_normal(generator, (cout, cin, kh, kw), fan_in=kh * kw * cin))

    def forward(self, x):
        return conv(x, self.kernel, self.stride)


class BatchNorm(nn.Module):
    """Holds ``bn_scale`` (zero-init where ``zero_gamma``) and ``bn_bias``."""

    def __init__(self, dim: int, *, device, zero_gamma: bool = False):
        super().__init__()
        fill = torch.zeros if zero_gamma else torch.ones
        self.bn_scale = nn.Parameter(fill(dim, dtype=torch.float32, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                                device=device))

    def forward(self, x, stats=None, return_stats=False, grid=None):
        return batchnorm(x, cast(self.bn_scale, x.dtype),
                         cast(self.bn_bias, x.dtype), stats=stats, grid=grid,
                         return_stats=return_stats)


class Dense(nn.Module):
    """Holds ``kernel`` (in, out), He fan-in init, and a zero ``bias``."""

    def __init__(self, generator: torch.Generator, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(
            winit.he_normal(generator, (in_dim, out_dim), fan_in=in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim, dtype=torch.float32,
                                             device=generator.device))

    def forward(self, x):
        return dense(x, self.kernel, self.bias)
