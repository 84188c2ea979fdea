"""Batch norm with its ReLU and residual add: kernel wrappers and the
autograd.Function.

Four kernels (``csrc/batchnorm.cu``): forward stats, forward apply (the
ReLU and the residual add as its epilogue), backward sums, backward dx.
``BatchNorm`` runs them on CUDA tensors and their plain versions
(``kernels/ref.py``) on CPU tensors, so the CPU tests exercise the same
hand-written backward formula that the kernels compute. Across the ranks
of a grid, one all-reduce of the stacked fp32 (Σx, Σx²) sits between the
two forward kernels and one of (Σg, Σg·x̂) between the two backward ones.

The scale and bias are the fp32 masters: the kernels round them to x's
dtype as they load them, as the model's cast did, and give their gradients
as fp32 values of sums rounded to x's dtype, as the cast's backward did,
so no cast runs on either side. On the card x is (N, C, H, W) with
channels-last strides (what every conv of the model writes), bf16 or fp32,
C a multiple of 8, and a residual lies as x does. Anything else raises:
there is no fallback.

Host cost: the step that runs these is short enough for the host's
dispatch to matter, so ``BatchNorm`` checks its inputs and finds the
stream once a pass and calls the launches (``_stats`` ... ``_dx``)
directly; the public ``bn_*_cuda`` wrappers check and launch one kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256      # a CTA (kThreads)
VEC = 8            # channels a thread (kVec)
MAX_LANES = 8      # threads across a channel tile: 64 channels
CTAS = 132 * 8     # about 8 CTAs on each of the H100's 132 SMs
MAX_TILES = 4096   # channel tiles a launch: the tickets a device holds


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch's grid over M rows of C channels (``Shape`` of the source):
    ``tiles`` channel tiles of ``lanes`` threads x 8 channels by ``chunks``
    chunks of ``chunk_rows`` rows, ``rpp`` rows of threads a CTA."""
    rows: int
    channels: int
    lanes: int
    rpp: int
    tiles: int
    chunks: int
    chunk_rows: int

    def shape(self):
        return (ctypes.c_longlong * 7)(self.rows, self.channels, self.lanes, self.rpp,
                                       self.tiles, self.chunks, self.chunk_rows)


def plan(rows: int, channels: int) -> Plan:
    """About ``CTAS`` CTAs over every shape, each thread at least 4 rows
    (one unrolled step of the forward loops), chunks of whole rows of
    threads. Plain Python, so the CPU tests check that it covers every row
    and channel once."""
    if rows <= 0 or channels <= 0 or channels % VEC:
        raise ValueError(f"batchnorm: {rows} rows of {channels} channels; the kernels "
                         f"take C a multiple of {VEC}")
    lanes = min(channels // VEC, MAX_LANES)
    rpp = THREADS // lanes
    tiles = -(-channels // (VEC * lanes))
    if tiles > MAX_TILES:
        raise ValueError(f"batchnorm: {channels} channels is over {MAX_TILES} tiles")
    chunks = max(1, min(-(-CTAS // tiles), -(-rows // (4 * rpp))))
    chunk_rows = -(-(-(-rows // chunks)) // rpp) * rpp
    return Plan(rows, channels, lanes, rpp, tiles, -(-rows // chunk_rows), chunk_rows)


_plans: dict = {}
_tickets: dict = {}


def _plan(rows: int, channels: int):
    """(plan, its shape as the kernels read it), made once a shape."""
    got = _plans.get((rows, channels))
    if got is None:
        p = plan(rows, channels)
        got = _plans[rows, channels] = (p, p.shape())
    return got


def _tickets_of(dev: torch.device) -> int:
    """The device's tile counters: zeroed once, and every launch leaves them
    at zero (the last CTA's atomicInc wraps), so launches in stream order
    share them."""
    t = _tickets.get(dev)
    if t is None:
        t = _tickets[dev] = torch.zeros(MAX_TILES, dtype=torch.int32, device=dev)
    return t.data_ptr()


def check_input(x: torch.Tensor, what: str) -> tuple[int, int]:
    """(rows, channels) of an input the kernels take; raises otherwise."""
    if not x.is_cuda:
        raise ValueError(f"{what}: x must be on a CUDA device, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what}: x must be (N, C, H, W) with channels-last strides, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    if c % VEC:
        raise ValueError(f"{what}: C must be a multiple of {VEC}, got {c}")
    return n * h * w, c


def _like(t: torch.Tensor | None, x: torch.Tensor, name: str, what: str):
    """``t`` checked to lie as x lies (same shape, dtype, channels-last), or None."""
    if t is not None and (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                          or not t.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{what}: {name} must be {x.dtype} {tuple(x.shape)} channels-last "
                         f"on {x.device}, got {t.dtype} {tuple(t.shape)} {t.stride()}")


def _params(scale, bias, x, what: str):
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must be contiguous, 16-byte aligned "
                             f"float32 ({c},) on {x.device}, got {t.dtype} {tuple(t.shape)}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# -- the launches: inputs checked by the caller ------------------------------------

def _stats(x, p: Plan, shape, stream):
    c = p.channels
    scratch = torch.empty(2 * (p.chunks + 1) * c, dtype=torch.float32, device=x.device)
    mv = torch.empty(2, c, dtype=torch.float32, device=x.device)
    sums = scratch[2 * p.chunks * c:]        # after the partials
    build.check(build.library().bn_fwd_stats(
        x.data_ptr(), _DTYPES[x.dtype], ctypes.byref(shape), scratch.data_ptr(),
        _tickets_of(x.device), sums.data_ptr(), mv.data_ptr(), ref.inv_count(p.rows),
        stream), "bn_fwd_stats")
    bn_fwd_stats_cuda.launches += 1
    return sums.view(2, c), mv


def _apply(x, mv, scale, bias, residual, eps: float, relu: bool, shape, stream):
    y = torch.empty_like(x)
    build.check(build.library().bn_fwd_apply(
        x.data_ptr(), _DTYPES[x.dtype], ctypes.byref(shape), mv.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), _ptr(residual), y.data_ptr(), eps, int(relu), stream),
        "bn_fwd_apply")
    bn_fwd_apply_cuda.launches += 1
    return y


def _sums(x, dy, y, mv, scale, bias, eps: float, mask: int, p: Plan, shape, stream):
    c = p.channels
    scratch = torch.empty(2 * (p.chunks + 1) * c, dtype=torch.float32, device=x.device)
    dparams = torch.empty(2, c, dtype=torch.float32, device=x.device)
    sums = scratch[2 * p.chunks * c:]
    build.check(build.library().bn_bwd_sums(
        x.data_ptr(), _DTYPES[x.dtype], ctypes.byref(shape), dy.data_ptr(), _ptr(y),
        mv.data_ptr(), scale.data_ptr(), bias.data_ptr(), eps, mask, scratch.data_ptr(),
        _tickets_of(x.device), sums.data_ptr(), dparams.data_ptr(), stream), "bn_bwd_sums")
    bn_bwd_sums_cuda.launches += 1
    return sums.view(2, c), dparams


def _dx(x, dy, y, mv, scale, bias, sums, eps: float, count: int, mask: int,
        want_dres: bool, shape, stream):
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if want_dres else None
    build.check(build.library().bn_bwd_dx(
        x.data_ptr(), _DTYPES[x.dtype], ctypes.byref(shape), dy.data_ptr(), _ptr(y),
        mv.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(sums), eps,
        ref.inv_count(count), mask, dx.data_ptr(), _ptr(dres), stream), "bn_bwd_dx")
    bn_bwd_dx_cuda.launches += 1
    return dx, dres


# -- the wrappers: each checks its inputs and launches one kernel --------------------

def bn_fwd_stats_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sums, mv): (Σx, Σx²) and (mean, var) over x's rows, each (2, C) fp32."""
    p, shape = _plan(*check_input(x, "bn_fwd_stats_cuda"))
    return _stats(x, p, shape, _stream(x))


def bn_fwd_apply_cuda(x, mv, scale, bias, *, eps: float, residual=None,
                      relu: bool = False) -> torch.Tensor:
    """y = BN(x) [+ residual] [ReLU], rounded as ``ref.bn_apply_ref``;
    scale and bias fp32."""
    what = "bn_fwd_apply_cuda"
    rows, c = check_input(x, what)
    _params(scale, bias, x, what)
    _like(residual, x, "residual", what)
    return _apply(x, mv, scale, bias, residual, eps, relu, _plan(rows, c)[1], _stream(x))


def bn_bwd_sums_cuda(x, dy, y, mv, scale, bias, *, eps: float, mask: int):
    """(sums, dparams): (Σg, Σg·x̂) over x's rows, (2, C) fp32, and the
    (bias, scale) gradients, the same rounded to x's dtype, as fp32. ``y``
    is read only where ``mask`` is 2."""
    what = "bn_bwd_sums_cuda"
    rows, c = check_input(x, what)
    _params(scale, bias, x, what)
    _like(dy, x, "dy", what)
    _like(y, x, "y", what)
    p, shape = _plan(rows, c)
    return _sums(x, dy, y, mv, scale, bias, eps, mask, p, shape, _stream(x))


def bn_bwd_dx_cuda(x, dy, y, mv, scale, bias, sums, *, eps: float, count: int,
                   mask: int, want_dres: bool = False):
    """(dx, g or None) as ``ref.bn_bwd_dx_ref``."""
    what = "bn_bwd_dx_cuda"
    rows, c = check_input(x, what)
    _params(scale, bias, x, what)
    _like(dy, x, "dy", what)
    _like(y, x, "y", what)
    return _dx(x, dy, y, mv, scale, bias, sums, eps, count, mask, want_dres,
               _plan(rows, c)[1], _stream(x))


for _fn in (bn_fwd_stats_cuda, bn_fwd_apply_cuda, bn_bwd_sums_cuda, bn_bwd_dx_cuda):
    _fn.launches = 0


class BatchNorm(torch.autograd.Function):
    """y = BN(x) [+ residual] [ReLU] and the statistics (2, C) fp32 (mean,
    var), differentiable in x, scale, bias and the residual. The scale and
    bias are rounded to x's dtype and their gradients come back in their
    own dtype.

    Train (``mean`` None): batch statistics, over the ``ranks`` of ``group``
    when ranks > 1. Eval: the given ``mean`` and ``var``, which are
    constants; the backward is then the direct term s a g alone.
    """

    @staticmethod
    def forward(ctx, x, scale, bias, residual, mean, var, eps: float, relu: bool,
                group, ranks: int):
        cuda = x.is_cuda
        train = mean is None
        count = x.numel() // x.shape[1] * ranks
        s32, b32 = scale.float(), bias.float()
        if cuda:
            what = "batchnorm"
            p, shape = _plan(*check_input(x, what))
            _params(s32, b32, x, what)
            _like(residual, x, "residual", what)
            stream = _stream(x)
        if not train:
            mv = torch.stack([mean.float(), var.float()])
        elif cuda:
            sums, mv = _stats(x, p, shape, stream)
        else:
            sums = ref.bn_stats_ref(x)
        if train and (ranks > 1 or not cuda):
            if ranks > 1:
                dist.all_reduce(sums, group=group)
            mv = ref.bn_moments_ref(sums, count)
        if cuda:
            y = _apply(x, mv, s32, b32, residual, eps, relu, shape, stream)
        else:
            y = ref.bn_apply_ref(x, mv, s32, b32, eps=eps, residual=residual, relu=relu)
        ctx.mask = 0 if not relu else (2 if residual is not None else 1)
        ctx.save_for_backward(x, s32, b32, mv, y if ctx.mask == 2 else None)
        ctx.eps, ctx.train, ctx.count, ctx.group, ctx.ranks = eps, train, count, group, ranks
        ctx.param_dtypes = scale.dtype, bias.dtype
        ctx.mark_non_differentiable(mv)
        return y, mv

    @staticmethod
    def backward(ctx, dy, _dmv):
        x, scale, bias, mv, y = ctx.saved_tensors
        need_x, need_s, need_b, need_r = ctx.needs_input_grad[:4]
        cuda = x.is_cuda
        eps, mask = ctx.eps, ctx.mask
        if cuda:
            dy = dy.contiguous(memory_format=torch.channels_last)
            _like(dy, x, "dy", "batchnorm")
            p, shape = _plan(x.numel() // x.shape[1], x.shape[1])
            stream = _stream(x)
        sums = dscale = dbias = None
        if ctx.train or need_s or need_b:
            if cuda:
                sums, dparams = _sums(x, dy, y, mv, scale, bias, eps, mask, p, shape, stream)
            else:
                sums = ref.bn_bwd_sums_ref(x, dy, y, mv, scale, bias, eps=eps, mask=mask)
                dparams = sums.to(x.dtype, copy=True).float()   # sums is reduced below
            dbias, dscale = (d.to(t) for d, t in zip(dparams.unbind(0), ctx.param_dtypes))
            if ctx.train and ctx.ranks > 1:
                dist.all_reduce(sums, group=ctx.group)
        dx = dres = None
        want_dres = need_r and mask == 2
        if need_x or want_dres:
            train_sums = sums if ctx.train else None
            if cuda:
                dx, dres = _dx(x, dy, y, mv, scale, bias, train_sums, eps, ctx.count, mask,
                               want_dres, shape, stream)
            else:
                dx, dres = ref.bn_bwd_dx_ref(x, dy, y, mv, scale, bias, train_sums, eps=eps,
                                             count=ctx.count, mask=mask, want_dres=want_dres)
        if need_r and mask != 2:
            dres = dy   # no ReLU after the add: the residual's gradient is dy
        return (dx if need_x else None, dscale if need_s else None,
                dbias if need_b else None, dres, None, None, None, None, None, None)
