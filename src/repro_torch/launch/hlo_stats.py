"""Collective traffic and op stats of a step (``repro/launch/hlo_stats.py``).

The reference parses them out of the compiled, partitioned HLO. Torch has
no HLO, so the port records them while the step runs: ``Recorder`` is a
``TorchDispatchMode`` that sees every op of this rank's program, the
collectives included, whether a ``torch.distributed`` call issued them
(``c10d`` ops: the gradient sync) or DTensor did (functional collectives:
the model's tensor-parallel and FSDP traffic). It lets a DTensor op
desugar first (returns ``NotImplemented``, as ``CommDebugMode`` does), so
what it sees is the per-rank program over local shards, the counterpart
of the post-SPMD HLO. The ops that DTensor runs on fake tensors to learn
an output's global shape are no part of that program; they run with the
modes below the recorder switched off, so that a ``FlopCounterMode``
entered before the recorder counts this rank's work alone.

Each collective becomes the reference's schedule entry ``{kind, dtype,
nbytes, group_size}``: kind one of ``_COLLECTIVES`` (a send is a
collective-permute; a receive is its other half and is not counted
again), dtype by the HLO's name (``f32``, ``bf16``), nbytes the output
bytes (what a rank receives), group size from the op's process group.
``collective_stats``, ``collective_schedule``, ``bucket_audit`` and
``op_histogram`` are the reference's, over such a list (or a
``Recorder``) in place of HLO text; ``_wire_bytes`` is copied formula for
formula.

The recorder also counts the bytes the program moves (``bytes_accessed``):
for each local op, the bytes of its tensor inputs, each read once, and of
its outputs, each written once, as an eager program without fusion moves
them. Views and other ops that move no data (``_MOVES_NOTHING``) and the
collectives, which ``collectives`` counts, are left out, and so are the
ops of DTensor's shape propagation, as above. A kernel whose plain
version runs in its place on the host (``kernels/traffic.py``) is counted
as the kernel moves it: inside ``kernel(name)`` the ops count nothing,
and the span counts the inputs and outputs it is given, by kernel name
in ``kernel_bytes``.

With ``track_memory`` the recorder also follows the bytes held by the
storages of the tensors the program makes (meta ones too: a meta storage
has its size), each released when its last tensor dies, and keeps the
largest total (``peak_bytes``). Tensors made before it was entered (the
step's arguments) are not in it.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import Counter, defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves

_DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int64: "s64", torch.uint64: "u64", torch.int32: "s32", torch.uint32: "u32",
    torch.int16: "s16", torch.uint16: "u16", torch.int8: "s8", torch.uint8: "u8",
    torch.bool: "pred",
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d ops write their result into their first argument (a tensor or a
# list of them); functional ones return it
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute",
}
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# ops that move no data: allocations whose contents nothing reads, and
# views that the dispatcher does not mark as such
_MOVES_NOTHING = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                  "_unsafe_view", "set_", "resize_"}


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def nbytes(t) -> int:
    """The bytes a kernel reads or writes of ``t``: its distinct elements (a
    broadcast dim, of stride 0, counts once), this rank's shard of a
    DTensor; an int is a count of bytes as it is."""
    if isinstance(t, int):
        return t
    if isinstance(t, DTensor):
        t = t.to_local()
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def _traffic(args, out) -> int:
    """Bytes in and out of one op: each distinct input once, each output once."""
    ins = {id(t): t for t in _tensors(args)}
    return sum(map(nbytes, ins.values())) + sum(map(nbytes, _tensors(out)))


def _group_size(func, args) -> int:
    """The size of the process group an op runs on: its ``ProcessGroup``
    argument (c10d) or the group its name resolves to (functional)."""
    if func.namespace == "c10d":
        pg = next(a for a in args if isinstance(a, torch.ScriptObject))
        return dist.ProcessGroup.unbox(pg).size()
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = next(a for a in reversed(args) if isinstance(a, str))
    return _resolve_process_group(name).size()


def _collective(func, args, out) -> dict | None:
    name = func._schema.name.split("::")[-1]
    if func.namespace == "c10d" and name in _C10D:
        kind, result = _C10D[name], args[0]
    elif func.namespace == "_c10d_functional" and name in _FUNCTIONAL:
        kind, result = _FUNCTIONAL[name], out
    else:
        return None
    ts = _tensors(result)
    return {"kind": kind, "dtype": _DTYPE_NAMES.get(ts[0].dtype, str(ts[0].dtype)),
            "nbytes": sum(t.numel() * t.element_size() for t in ts),
            "group_size": _group_size(func, args)}


class Recorder(TorchDispatchMode):
    """Records this rank's collectives (``collectives``, in issue order),
    its local ops by name (``ops``), the bytes they move
    (``bytes_accessed``; the kernels' share in ``kernel_bytes``) and, with
    ``track_memory``, the peak bytes of the storages its tensors hold
    (``peak_bytes``)."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.collectives: list[dict] = []
        self.ops: Counter = Counter()
        self.bytes_accessed = 0
        self.kernel_bytes: Counter = Counter()
        self._in_kernel = 0
        self.track_memory = track_memory
        self.live_bytes = self.peak_bytes = 0
        self._refs: dict[int, int] = {}
        self._sizes: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar into local ops
        if any(isinstance(a, FakeTensor) for a in tree_leaves((args, kwargs))):
            with _disable_current_modes():     # DTensor's shape propagation
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors(out)):
            return out
        self.ops[str(func.overloadpacket)] += 1
        op = _collective(func, args, out)
        if op is not None:
            self.collectives.append(op)
        elif not (self._in_kernel or func.is_view or func.namespace in ("c10d", "_c10d_functional")
                  or func.overloadpacket.__name__ in _MOVES_NOTHING):
            self.bytes_accessed += _traffic((args, kwargs), out)
        if self.track_memory:
            for t in _tensors(out):
                self._hold(t)
        return out

    @contextlib.contextmanager
    def kernel(self, name: str):
        """Count what runs inside as the kernel ``name``: its ops count no
        bytes; the tensors (or byte counts) given to the yielded function
        count once each, in ``bytes_accessed`` and ``kernel_bytes[name]``."""
        moved: list = []
        self._in_kernel += 1
        try:
            yield lambda *ts: moved.extend(ts)
        finally:
            self._in_kernel -= 1
        n = sum(map(nbytes, moved))
        self.bytes_accessed += n
        self.kernel_bytes[name] += n

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = storage.nbytes()
            self.live_bytes += self._sizes[key]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live_bytes -= self._sizes.pop(key)


def _schedule(recorded) -> list[dict]:
    return recorded.collectives if isinstance(recorded, Recorder) else list(recorded)


def _wire_bytes(kind: str, out_bytes: int, n: int) -> float:
    """Bytes per device on the wire for a ring realization of the op.

    all-reduce: 2*(n-1)/n * size; all-gather: (n-1)/n * output;
    reduce-scatter: (n-1) * output (input is n*output);
    all-to-all: (n-1)/n * size; collective-permute: full size.
    """
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * out_bytes
    if kind == "all-gather":
        return (n - 1) / n * out_bytes
    if kind == "reduce-scatter":
        return float((n - 1) * out_bytes)
    if kind == "all-to-all":
        return (n - 1) / n * out_bytes
    return float(out_bytes)    # collective-permute


def collective_stats(recorded) -> dict:
    """-> {op_kind: {"count", "bytes", "wire_bytes"}, "by_dtype": {dt: bytes},
    "wire_by_dtype", "total_bytes", "total_wire_bytes", "total_count"}."""
    out: dict = {k: {"count": 0, "bytes": 0, "wire_bytes": 0.0} for k in _COLLECTIVES}
    by_dtype: dict[str, int] = defaultdict(int)
    wire_by_dtype: dict[str, float] = defaultdict(float)
    for op in _schedule(recorded):
        wb = _wire_bytes(op["kind"], op["nbytes"], op["group_size"])
        out[op["kind"]]["count"] += 1
        out[op["kind"]]["bytes"] += op["nbytes"]
        out[op["kind"]]["wire_bytes"] += wb
        by_dtype[op["dtype"]] += op["nbytes"]
        wire_by_dtype[op["dtype"]] += wb
    out["by_dtype"] = dict(by_dtype)
    out["wire_by_dtype"] = dict(wire_by_dtype)
    out["total_bytes"] = sum(out[k]["bytes"] for k in _COLLECTIVES)
    out["total_wire_bytes"] = sum(out[k]["wire_bytes"] for k in _COLLECTIVES)
    out["total_count"] = sum(out[k]["count"] for k in _COLLECTIVES)
    return out


def collective_schedule(recorded) -> list[dict]:
    """Every collective in issue order: {kind, dtype, nbytes, group_size}."""
    return [dict(op) for op in _schedule(recorded)]


def bucket_audit(recorded, min_bytes: int = 0) -> dict:
    """Audit a bucketed gradient exchange, as the reference audits its HLO:
    ``num_exchanges = max(#reduce-scatter, #all-reduce)`` over ops of at
    least ``min_bytes`` (torus2d/ring/hierarchical buckets each open with a
    reduce-scatter or an all-reduce, psum buckets are one all-reduce; the
    floor drops scalar loss and metric reductions). Ops under the floor are
    reported in ``dropped``, not hidden."""
    all_ops = collective_schedule(recorded)
    sched = [op for op in all_ops if op["nbytes"] >= min_bytes]
    dropped_ops = [op for op in all_ops if op["nbytes"] < min_bytes]
    by_kind: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for op in sched:
        by_kind[op["kind"]]["count"] += 1
        by_kind[op["kind"]]["bytes"] += op["nbytes"]
    dropped_by_kind: dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for op in dropped_ops:
        dropped_by_kind[op["kind"]]["count"] += 1
        dropped_by_kind[op["kind"]]["bytes"] += op["nbytes"]
    n_rs = by_kind["reduce-scatter"]["count"]
    n_ar = by_kind["all-reduce"]["count"]
    return {
        "num_exchanges": max(n_rs, n_ar),
        "by_kind": dict(by_kind),
        "ops": sched,
        "dropped": {
            "min_bytes": min_bytes,
            "count": len(dropped_ops),
            "bytes": sum(op["nbytes"] for op in dropped_ops),
            "by_kind": dict(dropped_by_kind),
        },
    }


def op_histogram(recorder: Recorder, top: int = 15) -> list[tuple[str, int]]:
    """The local ops this rank ran, by name (``aten.mm``), most frequent first."""
    return sorted(recorder.ops.items(), key=lambda kv: -kv[1])[:top]
