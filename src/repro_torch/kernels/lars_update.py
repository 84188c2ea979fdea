"""Wrapper of the multi-tensor LARS kernels (``csrc/lars_update.cu``).

Replaces ``repro/kernels/lars_update.py`` (Pallas, one leaf a call) and the
per-leaf loop around it: one call updates every leaf of a step, LARS and
skip leaves alike, in two launches (the norms, then the update). The table
of leaves goes by value in the launch's parameters; p' and v' land in one
flat buffer each, and the leaves come back as views of them. A trust ratio
is taken over a group of consecutive leaves (``groups``: their counts), the
reference's stacked leaf; a group of one is a leaf.

``leaf_plan`` cuts the leaves into launches and chunks; it is plain Python,
so the CPU tests check that it covers every element once.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

MAX_LEAVES = 512     # leaves a launch: kMaxLeaves of csrc/lars_update.cu
CHUNK = 32768        # elements a block


class _Table(ctypes.Structure):
    """``LarsTable`` of csrc/lars_update.cu, field for field."""
    _fields_ = [("p", ctypes.c_void_p * MAX_LEAVES),
                ("g", ctypes.c_void_p * MAX_LEAVES),
                ("v", ctypes.c_void_p * MAX_LEAVES),
                ("off", ctypes.c_longlong * MAX_LEAVES),
                ("n", ctypes.c_int * MAX_LEAVES),
                ("chunk0", ctypes.c_int * (MAX_LEAVES + 1)),
                ("lars", ctypes.c_int * MAX_LEAVES),
                ("grp", ctypes.c_int * MAX_LEAVES),
                ("gb0", ctypes.c_int * MAX_LEAVES),
                ("gb1", ctypes.c_int * MAX_LEAVES),
                ("base", ctypes.c_int),
                ("n_leaves", ctypes.c_int),
                ("chunk", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class Launch:
    """One pair of launches: leaves ``first`` .. ``first + len(chunk0) - 2``."""
    first: int
    chunk0: tuple[int, ...]    # each leaf's first block; the last entry = blocks
    offsets: tuple[int, ...]   # each leaf's offset in the flat outputs, a multiple of 4
    base: int = 0              # the launch's first block, over all launches

    @property
    def blocks(self) -> int:
        return self.chunk0[-1]


def leaf_plan(numels: list[int], *, max_leaves: int = MAX_LEAVES,
              chunk: int = CHUNK) -> list[Launch]:
    """Cut leaves of ``numels`` elements into launches of at most
    ``max_leaves`` leaves, each leaf into blocks of ``chunk`` elements, and
    place the leaves one after another in the flat outputs, each on a
    16-byte boundary (fp32), as a leaf of its own allocation would start:
    the BN kernels take the scale and bias with 16-byte loads."""
    launches, off, base = [], 0, 0
    for first in range(0, len(numels), max_leaves):
        chunk0, offsets = [0], []
        for n in numels[first:first + max_leaves]:
            if not 0 < n < 2**31:
                raise ValueError(f"lars_update: a leaf of {n} elements")
            offsets.append(off)
            off += -(-n // 4) * 4
            chunk0.append(chunk0[-1] + -(-n // chunk))
        launches.append(Launch(first, tuple(chunk0), tuple(offsets), base))
        base += chunk0[-1]
    return launches


def group_blocks(launches: list[Launch], groups: list[int]):
    """Each leaf's (group, the group's first block, one past its last),
    blocks counted over all launches; ``groups`` counts the consecutive
    leaves of each group."""
    first = [launch.base + c for launch in launches for c in launch.chunk0[:-1]]
    end = first[1:] + [launches[-1].base + launches[-1].blocks]
    out, leaf = [], 0
    for g, size in enumerate(groups):
        span = (first[leaf], end[leaf + size - 1])
        out += [(g, *span)] * size
        leaf += size
    return out


def block_ranges(launch: Launch, numels: list[int], chunk: int = CHUNK):
    """(leaf, start, end) of each block of a launch, as the kernels find
    them (``find_leaf``: the last leaf whose first block is <= b)."""
    out, leaf = [], 0
    for b in range(launch.blocks):
        while launch.chunk0[leaf + 1] <= b:
            leaf += 1
        start = (b - launch.chunk0[leaf]) * chunk
        n = numels[launch.first + leaf]
        out.append((launch.first + leaf, start, min(start + chunk, n)))
    return out


def _check(ps, gs, vs) -> torch.device:
    """The leaves' one CUDA device; raises on anything the kernels do not take."""
    dev = ps[0].device if ps else None
    if dev is None or dev.type != "cuda":
        raise ValueError(f"lars_update_cuda: leaves must be on a CUDA device, got {dev}")
    f32 = torch.float32
    for i, (p, g, v) in enumerate(zip(ps, gs, vs)):
        for name, t in (("p", p), ("g", g), ("v", v)):
            if t.device != dev:
                raise ValueError(f"lars_update_cuda: {name}[{i}] is on {t.device}, "
                                 f"not {dev}")
            if t.dtype != f32:
                raise TypeError(f"lars_update_cuda: {name}[{i}] must be float32, "
                                f"got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"lars_update_cuda: {name}[{i}] must be contiguous")
        if g.shape != p.shape or v.shape != p.shape:
            raise ValueError(f"lars_update_cuda: leaf {i}: p {tuple(p.shape)}, "
                             f"g {tuple(g.shape)}, v {tuple(v.shape)}")
    return dev


_plans: dict = {}


def check_groups(groups: list[int] | None, lars: list[bool]) -> list[int]:
    """``groups`` (counts of consecutive leaves, default one a leaf),
    checked to cover the leaves, each group all LARS or all skip."""
    if groups is None:
        return [1] * len(lars)
    if sum(groups) != len(lars) or min(groups, default=1) < 1:
        raise ValueError(f"lars_update: groups {groups} do not cover {len(lars)} leaves")
    leaf = 0
    for size in groups:
        if len({bool(x) for x in lars[leaf:leaf + size]}) != 1:
            raise ValueError(f"lars_update: leaves {leaf}..{leaf + size - 1} mix LARS "
                             "and skip leaves in one group")
        leaf += size
    return list(groups)


def lars_update_cuda(ps: list[torch.Tensor], gs: list[torch.Tensor],
                     vs: list[torch.Tensor], lars: list[bool], *, lr: float,
                     mom: float, eta: float, weight_decay: float, eps: float,
                     nesterov: bool = False, groups: list[int] | None = None):
    """One LARS step over all leaves on the card; returns ``(ps', vs')``.

    ``lars[i]`` False makes leaf i a skip leaf (trust 1, no weight decay).
    ``groups`` counts the consecutive leaves that share a trust ratio (the
    norms over all of them); None: one a leaf. Leaves are fp32, contiguous,
    on one CUDA device; the outputs are views of two flat buffers, each on
    a 16-byte boundary, and the inputs are left as they were.
    """
    if not (len(ps) == len(gs) == len(vs) == len(lars)):
        raise ValueError("lars_update_cuda: ps, gs, vs and lars differ in length")
    dev = _check(ps, gs, vs)
    numels = [p.numel() for p in ps]
    key = (tuple(numels), tuple(bool(x) for x in lars),
           None if groups is None else tuple(groups))
    plan = _plans.get(key)
    if plan is None:
        sizes = check_groups(groups, lars)
        launches = leaf_plan(numels)
        spans = group_blocks(launches, sizes)
        plan = _plans[key] = ([(launch, _static_table(launch, numels, lars, spans))
                               for launch in launches], len(sizes))
    tables, n_groups = plan
    lib = build.library()
    total = tables[-1][0].offsets[-1] + numels[-1]
    p_flat = torch.empty(total, dtype=torch.float32, device=dev)
    v_flat = torch.empty(total, dtype=torch.float32, device=dev)
    partial = torch.empty(2 * sum(launch.blocks for launch, _ in tables),
                          dtype=torch.float32, device=dev)
    count = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    sums = torch.empty(2 * n_groups, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for launch, table in tables:
        k = len(launch.offsets)
        sl = slice(launch.first, launch.first + k)
        table.p[:k] = [t.data_ptr() for t in ps[sl]]
        table.g[:k] = [t.data_ptr() for t in gs[sl]]
        table.v[:k] = [t.data_ptr() for t in vs[sl]]
    # every group's norms before any update: a group may span two tables
    for launch, table in tables:
        build.check(lib.lars_norms_f32(ctypes.byref(table), partial.data_ptr(),
                                       count.data_ptr(), sums.data_ptr(),
                                       launch.blocks, stream), "lars_norms_f32")
        lars_update_cuda.launches += 1
    for launch, table in tables:
        build.check(lib.lars_apply_f32(
            ctypes.byref(table), sums.data_ptr(), p_flat.data_ptr(), v_flat.data_ptr(),
            launch.blocks, lr, mom, eta, weight_decay, eps, int(nesterov), stream),
            "lars_apply_f32")
        lars_update_cuda.launches += 1
    offsets = [o for launch, _ in tables for o in launch.offsets]
    return ([p_flat.as_strided(p.shape, p.stride(), o) for p, o in zip(ps, offsets)],
            [v_flat.as_strided(p.shape, p.stride(), o) for p, o in zip(ps, offsets)])


def _static_table(launch: Launch, numels: list[int], lars: list[bool],
                  spans: list[tuple[int, int, int]]) -> _Table:
    """The table's fields that depend on the shapes only; the pointers are
    filled in at each call. ``spans``: each leaf's (group, the group's first
    block, one past its last), over all launches."""
    lib = build.library()
    build.check(lib.lars_table_check(ctypes.sizeof(_Table)), "lars_table_check")
    t = _Table()
    k = len(launch.offsets)
    sl = slice(launch.first, launch.first + k)
    t.n[:k] = numels[sl]
    t.off[:k] = list(launch.offsets)
    t.chunk0[:k + 1] = list(launch.chunk0)
    t.lars[:k] = [int(bool(x)) for x in lars[sl]]
    t.grp[:k], t.gb0[:k], t.gb1[:k] = (list(col) for col in zip(*spans[sl]))
    t.base = launch.base
    t.n_leaves = k
    t.chunk = CHUNK
    return t


lars_update_cuda.launches = 0
