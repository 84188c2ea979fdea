"""Wrapper of the non-finite guard's kernels (``csrc/guard.cu``).

Two multi-tensor launches take the place of the guard's per-leaf ops in
``train/trainer.py:make_train_step``: ``guard_unscale_count_cuda`` before
LARS (each gradient times 1 / scale in place, and the count of its
non-finite elements), ``guard_commit_cuda`` after it (the old params and
momenta copied over LARS's output only when the step's finite flag, read on
the card, is false). The flag and the loss scale's rules stay in
``make_train_step``, as ops on 0-d tensors. Both write in place: the gradients are
``sync_tree``'s outputs and the new leaves LARS's, the step's own tensors,
so the guard allocates no leaf. The tables (``tables``) are cut by
``lars_update.leaf_plan`` and cached by the leaves' sizes; only the
pointers are filled in at each call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lars_update import CHUNK, MAX_LEAVES, Launch, leaf_plan

CTAS_PER_SM = 4      # the commit's grid: CTAs an SM, striding over the chunks


class _UnscaleTable(ctypes.Structure):
    """``UnscaleTable`` of csrc/guard.cu, field for field."""
    _fields_ = [("g", ctypes.c_void_p * MAX_LEAVES),
                ("n", ctypes.c_int * MAX_LEAVES),
                ("chunk0", ctypes.c_int * (MAX_LEAVES + 1)),
                ("n_leaves", ctypes.c_int),
                ("chunk", ctypes.c_int)]


class _CommitTable(ctypes.Structure):
    """``CommitTable`` of csrc/guard.cu, field for field."""
    _fields_ = [("p_old", ctypes.c_void_p * MAX_LEAVES),
                ("p_new", ctypes.c_void_p * MAX_LEAVES),
                ("v_old", ctypes.c_void_p * MAX_LEAVES),
                ("v_new", ctypes.c_void_p * MAX_LEAVES),
                ("n", ctypes.c_int * MAX_LEAVES),
                ("chunk0", ctypes.c_int * (MAX_LEAVES + 1)),
                ("n_leaves", ctypes.c_int),
                ("chunk", ctypes.c_int)]


def _dense(t: torch.Tensor) -> bool:
    """Every element once, in a block of memory: the unscale is elementwise
    and in place, so a channels-last gradient (cuDNN's) goes as it is."""
    return t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last)


def _check(what: str, ts: list[torch.Tensor], dev, dense=torch.Tensor.is_contiguous):
    for i, t in enumerate(ts):
        if t.device != dev:
            raise ValueError(f"{what}: leaf {i} is on {t.device}, not {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: leaf {i} must be float32, got {t.dtype}")
        if not dense(t):
            raise ValueError(f"{what}: leaf {i} must be contiguous")


def _device(what: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on a CUDA device, got {t.device}")
    return t.device


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The kernel library, once checked to lay the tables out as we do."""
    lib = build.library()
    build.check(lib.guard_table_check(ctypes.sizeof(_UnscaleTable),
                                      ctypes.sizeof(_CommitTable)), "guard_table_check")
    return lib


@functools.lru_cache(maxsize=16)
def tables(kind: type, numels: tuple[int, ...]) -> list[tuple[Launch, ctypes.Structure]]:
    """Each launch's table over leaves of ``numels``, its static fields
    filled in (``kind``: ``_UnscaleTable`` or ``_CommitTable``); the
    pointers are the caller's to fill at each call."""
    out = []
    for launch in leaf_plan(list(numels)):
        t = kind()
        k = len(launch.offsets)
        t.n[:k] = numels[launch.first:launch.first + k]
        t.chunk0[:k + 1] = list(launch.chunk0)
        t.n_leaves = k
        t.chunk = CHUNK
        out.append((launch, t))
    return out


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def guard_unscale_count_cuda(grads: list[torch.Tensor],
                             scale: torch.Tensor | None) -> tuple[list[torch.Tensor],
                                                                  torch.Tensor]:
    """Each gradient times 1 / ``scale`` in place (``scale`` None: left as
    it is) and the count of non-finite elements of the result, an int64 on
    the card; returns ``(grads, count)``. The leaves are fp32 and dense
    (contiguous or channels-last) on one CUDA device, and none shares memory
    with another; ``scale`` is the fp32 loss scale on that device."""
    dev = _device("guard_unscale_count_cuda", grads[0])
    _check("guard_unscale_count_cuda", grads, dev, _dense)
    if scale is not None:
        _check("guard_unscale_count_cuda: scale", [scale], dev)
    lib = _library()
    count = torch.zeros((), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scale_ptr = None if scale is None else scale.data_ptr()
    for launch, table in tables(_UnscaleTable, tuple(g.numel() for g in grads)):
        k = len(launch.offsets)
        table.g[:k] = [g.data_ptr() for g in grads[launch.first:launch.first + k]]
        build.check(lib.guard_unscale_count(ctypes.byref(table), scale_ptr,
                                            count.data_ptr(), launch.blocks, stream),
                    "guard_unscale_count")
        guard_unscale_count_cuda.launches += 1
    return grads, count


def guard_commit_cuda(finite: torch.Tensor, old_p: list[torch.Tensor],
                      new_p: list[torch.Tensor], old_v: list[torch.Tensor],
                      new_v: list[torch.Tensor]) -> tuple[list[torch.Tensor],
                                                         list[torch.Tensor]]:
    """Keep LARS's ``new_p`` and ``new_v`` where ``finite`` (a 0-d bool on
    the card, read there), else copy ``old_p`` and ``old_v`` over them in
    place; returns ``(new_p, new_v)``. A finite step moves none of their
    bytes. The leaves are fp32 and contiguous, new and old of each leaf the
    same size."""
    what = "guard_commit_cuda"
    dev = _device(what, finite)
    if finite.dtype != torch.bool or finite.numel() != 1:
        raise TypeError(f"{what}: finite must be one bool, got {finite.dtype} "
                        f"of {finite.numel()} elements")
    _check(what, [*old_p, *new_p, *old_v, *new_v], dev)
    numels = tuple(p.numel() for p in old_p)
    if not (len(new_p) == len(old_v) == len(new_v) == len(numels)) or any(
            t.numel() != n for ts in (new_p, old_v, new_v) for t, n in zip(ts, numels)):
        raise ValueError(f"{what}: old and new params and momenta differ in leaves or sizes")
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ctas = CTAS_PER_SM * _sms(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    for launch, table in tables(_CommitTable, numels):
        k = len(launch.offsets)
        sl = slice(launch.first, launch.first + k)
        for field, ts in (("p_old", old_p), ("p_new", new_p), ("v_old", old_v),
                          ("v_new", new_v)):
            getattr(table, field)[:k] = [t.data_ptr() for t in ts[sl]]
        build.check(lib.guard_commit(ctypes.byref(table), finite.data_ptr(), launch.blocks,
                                     min(launch.blocks, ctas), stream), "guard_commit")
        guard_commit_cuda.launches += 1
    return new_p, new_v


guard_unscale_count_cuda.launches = 0
guard_commit_cuda.launches = 0
