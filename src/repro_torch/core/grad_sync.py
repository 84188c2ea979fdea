"""Gradient synchronization over ``{name: tensor}`` gradients
(``repro/core/grad_sync.py``): the paper's technique as a framework feature.

Two modes, chosen by ``fuse``:

* ``fuse=True`` (paper-faithful, pure data-parallel): leaves are flattened
  into fused comm buffers (mixed precision: a comm-dtype group and an fp32
  group, since §3.2 of the paper keeps BN statistics and LARS in fp32),
  pre-scaled by 1/world, padded to X * Y, exchanged with the selected
  strategy and unpacked to each leaf's shape and dtype.
  ``bucket_bytes=0`` makes one buffer a precision group; ``> 0`` partitions
  each group greedily into size-targeted buckets, in reverse flatten order.
  The result is the mean over the ranks.
* ``fuse=False``: each leaf of at least ``small_leaf_threshold`` elements is
  exchanged on its own along its leading dimension (padded to X * Y); the
  small ones are raveled into shared buffers, one all-reduce a bucket.

**Leaf order.** The reference walks the JAX tree with
``jax.tree_util.tree_flatten_with_path``: dict keys sorted, list indices in
numeric order, and matches tags against paths such as
``stages/0/1/conv1/kernel``. The port's names are module paths
(``stages.0.1.conv1.kernel``) in ``named_parameters`` order, so every
function here first puts the leaves in the reference's order (an all-digit
component is a list index) and builds the same path strings. The buckets,
their leaves and their bytes are then the reference's. Conv kernels are
OIHW here and HWIO there; that reorders elements inside a leaf, and the
exchange is an elementwise sum. The order and the exchange plan depend only
on the leaves' names, shapes and dtypes and on the config, so they are
built once for each of those (``_schedule``), not on every step.

**Issue order.** ``sync_tree`` runs after backward: it issues every
exchange in issue order, each phase with ``async_op=True`` and every bucket
in flight before the first wait (``collectives.run``), and returns once all
are done. Hooks that start a bucket while backward still runs are not
built: the reference's reverse flatten order puts the stem's kernel, whose
gradient lands last, in the first bucket of ResNet-50, so such a bucket
could start only after backward ends.

``bucket_bytes`` may also be ``"auto"``: ``resolve_sync_config`` replaces it
with a value from ``core/autotune.py``, given an explicit hardware model.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import convert
from repro_torch.core import collectives
from repro_torch.core.topology import TorusGrid

#: Path tags of the leaves exchanged in fp32 (§3.2 of the paper keeps BN
#: statistics and LARS in fp32): BN statistics, scales and biases.
FP32_PATHS = ("batch_stats", "bn", "scale", "bias")

#: ``bucket_bytes`` sentinel: resolve the value via ``core/autotune.py`` at
#: ``resolve_sync_config`` time instead of hand-setting a constant.
AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class GradSyncConfig:
    strategy: str = "torus2d"           # psum | ring | hierarchical | torus2d
    lowering: str = "xla"               # xla | ring (neighbour exchanges)
    comm_dtype: torch.dtype = torch.bfloat16   # paper: fp16
    fuse: bool = True
    small_leaf_threshold: int = 2048    # below: grouped all-reduce
    bucket_bytes: int | str = 0         # 0: one fused buffer a group;
                                        # >0: size-targeted comm buckets;
                                        # "auto": tuned at resolve time


def _require_resolved(bucket_bytes) -> int:
    """``bucket_bytes`` as an int; rejects the unresolved ``"auto"``."""
    if isinstance(bucket_bytes, bool) or not isinstance(bucket_bytes, int):
        raise ValueError(
            f"bucket_bytes={bucket_bytes!r} is not resolved -- pass the "
            "config through resolve_sync_config (which replaces "
            f"bucket_bytes={AUTO!r} with an autotuned value) before "
            "sync_tree/bucket_layout")
    return bucket_bytes


class _Leaf(NamedTuple):
    name: str                # the port's name (``stages.0.1.conv1.kernel``)
    path: str                # the reference's (``stages/0/1/conv1/kernel``)
    numel: int
    shape: tuple[int, ...]
    dtype: torch.dtype


class _Exchange(NamedTuple):
    group: str               # "comm" | "fp32"
    dtype: torch.dtype       # what goes over the wire
    strategy: str
    mode: str                # "fused" | "per_leaf" | "grouped"
    leaves: tuple[int, ...]  # indices into ``_Schedule.leaves``
    sizes: tuple[int, ...]   # their numels, to split the result
    out_dtype: torch.dtype | None   # the leaves' one dtype, if they share it


class _Schedule(NamedTuple):
    leaves: tuple[_Leaf, ...]          # in the reference's flatten order
    exchanges: tuple[_Exchange, ...]   # in issue order


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, rem))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Bucket partitioning (pure python)
# ---------------------------------------------------------------------------

def partition_buckets(leaf_bytes: Sequence[int], bucket_bytes: int) -> list[list[int]]:
    """Greedy partition of leaf indices into size-targeted buckets.

    Walks the leaves in the given order and closes a bucket as soon as its
    cumulative size reaches ``bucket_bytes`` (so each bucket is at least the
    target size except the last, and a single oversized leaf forms its own
    bucket). A trailing bucket smaller than *half* the target is merged
    into its predecessor. ``bucket_bytes <= 0`` returns one bucket with
    everything -- the fully-fused layout.
    """
    idx = list(range(len(leaf_bytes)))
    if bucket_bytes <= 0:
        return [idx] if idx else []
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in idx:
        cur.append(i)
        cur_bytes += leaf_bytes[i]
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    if len(buckets) >= 2 and 2 * sum(
            leaf_bytes[i] for i in buckets[-1]) < bucket_bytes:
        buckets[-2].extend(buckets.pop())
    return buckets


def _precision_groups(leaves: Sequence[_Leaf], cfg: GradSyncConfig):
    """Split leaf indices into (comm-dtype, fp32) groups, preserving order:
    BN statistics, scales, biases and every fp32 vector leaf go in fp32."""
    comm_idx, fp32_idx = [], []
    for k, leaf in enumerate(leaves):
        if any(tag in leaf.path for tag in FP32_PATHS) or \
                leaf.dtype == torch.float32 and len(leaf.shape) <= 1:
            fp32_idx.append(k)
        else:
            comm_idx.append(k)
    return [("comm", comm_idx, cfg.comm_dtype), ("fp32", fp32_idx, torch.float32)]


def _buckets(leaves: Sequence[_Leaf], ks: Sequence[int], dtype, bucket_bytes: int,
             group: str, strategy: str, mode: str) -> list[_Exchange]:
    """``ks`` in reverse order, partitioned into buckets of ``dtype``."""
    order = list(reversed(ks))
    sizes = [leaves[k].numel * dtype.itemsize for k in order]
    out = []
    for bucket in partition_buckets(sizes, bucket_bytes):
        idx = tuple(order[i] for i in bucket)
        dtypes = {leaves[k].dtype for k in idx}
        out.append(_Exchange(group, dtype, strategy, mode, idx,
                             tuple(leaves[k].numel for k in idx),
                             dtypes.pop() if len(dtypes) == 1 else None))
    return out


@functools.lru_cache(maxsize=32)
def _schedule(signature: tuple[tuple[str, tuple[int, ...], torch.dtype], ...],
              cfg: GradSyncConfig) -> _Schedule:
    """The leaves of ``signature`` ((name, shape, dtype) a leaf) in the
    reference's flatten order, and the exchanges that sync them.

    ``fuse=True``: each precision group partitioned into ``"fused"``
    buckets. ``fuse=False``: one ``"per_leaf"`` strategy exchange for each
    leaf of at least ``small_leaf_threshold`` elements (its comm dtype by
    tag match only, as the reference's, which unlike ``_precision_groups``
    does not single out fp32 vectors), then the small leaves and scalars of
    each dtype in shared ``"grouped"`` buckets, one all-reduce a bucket.
    """
    bucket_bytes = _require_resolved(cfg.bucket_bytes)
    by_name = {name: (tuple(shape), dtype) for name, shape, dtype in signature}
    leaves = tuple(
        _Leaf(name, convert.jax_path(name), math.prod(by_name[name][0]), *by_name[name])
        for name in convert.jax_order(by_name))
    if cfg.fuse:
        return _Schedule(leaves, tuple(
            ex for group, ks, dtype in _precision_groups(leaves, cfg)
            for ex in _buckets(leaves, ks, dtype, bucket_bytes, group, cfg.strategy,
                               "fused")))
    large: list[_Exchange] = []
    small: dict[tuple[str, Any], list[int]] = {}
    for k, leaf in enumerate(leaves):
        group, dtype = (("fp32", torch.float32)
                        if any(tag in leaf.path for tag in FP32_PATHS)
                        else ("comm", cfg.comm_dtype))
        if leaf.numel < cfg.small_leaf_threshold or not leaf.shape:
            small.setdefault((group, dtype), []).append(k)
        else:
            large.append(_Exchange(group, dtype, cfg.strategy, "per_leaf", (k,),
                                   (leaf.numel,), leaf.dtype))
    grouped = [ex for (group, dtype), ks in small.items()
               for ex in _buckets(leaves, ks, dtype, bucket_bytes, group, "psum", "grouped")]
    return _Schedule(leaves, tuple(large[::-1] + grouped))


def _signature(grads: dict[str, torch.Tensor]):
    return tuple((name, tuple(t.shape), t.dtype) for name, t in grads.items())


def bucket_layout(grads: dict[str, torch.Tensor],
                  cfg: GradSyncConfig = GradSyncConfig()) -> list[dict]:
    """The exchange schedule ``sync_tree`` will issue, as metadata: the
    reference's ``bucket_layout``, dict for dict.

    One dict per exchange in **issue order** with keys ``group``
    ("comm"|"fp32"), ``dtype``, ``nbytes``, ``num_leaves``, ``paths``, and
    ``mode``: ``"fused"`` buckets for ``fuse=True``; for ``fuse=False`` one
    ``"per_leaf"`` entry per large leaf plus ``"grouped"`` entries for the
    shared small-leaf buckets. Reads shapes and dtypes only (meta tensors
    do).
    """
    sched = _schedule(_signature(grads), cfg)
    return [{"group": ex.group, "dtype": _dtype_name(ex.dtype),
             "nbytes": sum(ex.sizes) * ex.dtype.itemsize, "num_leaves": len(ex.leaves),
             "paths": [sched.leaves[k].path for k in ex.leaves], "mode": ex.mode}
            for ex in sched.exchanges]


@functools.lru_cache(maxsize=16)
def _scale_in(dtype: torch.dtype, world: int) -> float:
    """1 / world rounded to ``dtype`` (the reference multiplies by
    ``jnp.asarray(scale, dtype)``)."""
    return torch.tensor(1.0 / world, dtype=dtype).item()


def sync_tree(grads: dict[str, torch.Tensor], grid: TorusGrid,
              cfg: GradSyncConfig = GradSyncConfig()) -> dict[str, torch.Tensor]:
    """The mean of the gradients over the grid's ranks; every rank calls it
    with the same names and shapes. Returns a new dict in the input's key
    order, each leaf in its own shape and dtype."""
    sched = _schedule(_signature(grads), cfg)
    mult = grid.size
    exchanges = []
    for ex in sched.exchanges:
        if ex.mode == "per_leaf":
            # a copy: the input leaf may be in the comm dtype already
            buf = grads[sched.leaves[ex.leaves[0]].name].to(ex.dtype, copy=True)
        else:
            buf = torch.cat([grads[sched.leaves[k].name].reshape(-1)
                             for k in ex.leaves]).to(ex.dtype)
        # in the comm dtype, times the scale rounded to it: keeps the
        # half-precision partial sums in range. A scale of 1 is left out.
        scale = _scale_in(ex.dtype, grid.size)
        if scale != 1.0:
            buf.mul_(scale)
        exchanges.append(collectives.exchange(_pad_to(buf, mult), grid, ex.strategy,
                                              cfg.lowering))

    out = {}
    for ex, red in zip(sched.exchanges, collectives.run(exchanges)):
        if ex.mode == "per_leaf":
            leaf = sched.leaves[ex.leaves[0]]
            out[leaf.name] = red[:leaf.shape[0]].to(leaf.dtype)
            continue
        red = red.reshape(-1)[:sum(ex.sizes)]
        if ex.out_dtype is not None:   # one cast a bucket, not one a leaf
            red = red.to(ex.out_dtype)
        for k, part in zip(ex.leaves, torch.split(red, ex.sizes)):
            leaf = sched.leaves[k]
            part = part.view(leaf.shape)
            out[leaf.name] = part if ex.out_dtype is not None else part.to(leaf.dtype)
    return {name: out[name] for name in grads}


# ---------------------------------------------------------------------------
# Graceful degradation: strategy fallback chain
# ---------------------------------------------------------------------------

#: Ordered degradation chain per strategy (2d_torus -> ... -> ring -> psum).
#: hierarchical is all-reduce-only, the flat ring is one in-group exchange
#: the library may route around a dead link, and psum always runs.
FALLBACK_CHAINS: dict[str, tuple[str, ...]] = {
    "torus2d": ("torus2d", "hierarchical", "ring", "psum"),
    "hierarchical": ("hierarchical", "ring", "psum"),
    "ring": ("ring", "psum"),
    "psum": ("psum",),
}


#: The events' ``context`` tag, as the reference's at start-up (the port
#: resolves the sync only there).
_CONTEXT = "startup"


def fallback_chain(strategy: str) -> tuple[str, ...]:
    return FALLBACK_CHAINS.get(strategy, (strategy, "psum"))


def _strategy_viable(strategy: str, lowering: str, grid: TorusGrid,
                     down_axes=()) -> tuple[bool, str]:
    """(viable, reason). ``reason`` explains the rejection when not viable.

    1. *Down axes* (``"dx"``, ``"dy"``): torus2d / hierarchical decompose
       the reduction into per-axis phases that map onto link dimensions, so
       a down axis kills them; the flat strategies survive with the
       ``xla`` lowering, while the ring lowering pins neighbour links.
    2. The reference's partial-manual check is JAX's own; nothing here.
    3. *Probe*: one tiny all-reduce of ones over the real groups, which
       must sum to the world size. Every rank runs the same probes, and the
       verdict is the world's: a rank that read a wrong sum rejects the
       strategy on every rank, so all of them pick the same one. A probe
       that raises (a broken group, a timeout) ends the run: a process
       group is not to be trusted after a failed collective.
    """
    down = set(down_axes) & set(grid.axes)
    if down:
        if strategy in ("torus2d", "hierarchical"):
            return False, (f"torus axis(es) {sorted(down)} down: per-axis "
                           "phase decomposition unavailable")
        if lowering == "ring":
            return False, (f"axis(es) {sorted(down)} down: explicit ppermute "
                           "ring pins dead neighbor links")
    ones = torch.ones(grid.size, device=grid.device)
    got = collectives.all_reduce(ones.clone(), grid, strategy, lowering)
    wrong = torch.tensor([0.0 if torch.equal(got, ones * grid.size) else 1.0],
                         device=grid.device)
    if grid.size > 1:
        dist.all_reduce(wrong, group=grid.world.group)
    if wrong.item():
        return False, (f"probe: the all-reduce of ones missed {grid.size} on "
                       f"{int(wrong.item())} of {grid.size} ranks")
    return True, ""


def _resolve_bucket_bytes(cfg: GradSyncConfig, grid: TorusGrid, params_like,
                          hw) -> tuple[GradSyncConfig, list[dict]]:
    """Replace ``bucket_bytes="auto"`` with an autotuned value (after the
    fallback chain, so the tuned size matches the strategy that runs)."""
    if cfg.bucket_bytes != AUTO:
        return cfg, []
    if hw is None:
        raise ValueError(
            "bucket_bytes='auto' needs an autotune.HardwareModel: the port has no "
            "measured fabric constants to default to")
    from repro_torch.core import autotune
    x, y = grid.sizes()
    total_bytes = None
    if params_like is not None:
        layout = bucket_layout(params_like, dataclasses.replace(cfg, bucket_bytes=0))
        total_bytes = sum(b["nbytes"] for b in layout)
    rec = autotune.recommend_bucket_bytes(cfg.strategy, x, y, hw, total_bytes=total_bytes)
    event = {"event": "bucket_autotune", "context": _CONTEXT,
             "strategy": cfg.strategy, "mode": rec["mode"],
             "bucket_bytes": rec["bucket_bytes"],
             "analytic_knee_bytes": rec["analytic_knee_bytes"],
             "total_bytes": total_bytes, "hw": rec["hw"]["name"]}
    if rec["mode"] == "cost_model":
        event["exposed_seconds"] = rec["exposed_seconds"]
        event["num_buckets"] = rec["num_buckets"]
    return dataclasses.replace(cfg, bucket_bytes=rec["bucket_bytes"]), [event]


def resolve_sync_config(cfg: GradSyncConfig, grid: TorusGrid, down_axes=(),
                        params_like=None, hw=None) -> tuple[GradSyncConfig, list[dict]]:
    """Walk ``cfg.strategy``'s fallback chain; return the first viable
    config plus the rejection/downgrade events.

    psum ends every chain, so a downgrade is an event, not an error.
    ``bucket_bytes="auto"`` is resolved too, against ``params_like`` (the gradients' names and shapes;
    optional) and ``hw`` (an ``autotune.HardwareModel``, required for
    ``"auto"``).
    """
    events: list[dict] = []
    for strategy in fallback_chain(cfg.strategy):
        ok, reason = _strategy_viable(strategy, cfg.lowering, grid, down_axes)
        if ok:
            if strategy != cfg.strategy:
                events.append({"event": "grad_sync_downgrade", "from": cfg.strategy,
                               "to": strategy, "context": _CONTEXT})
            resolved = dataclasses.replace(cfg, strategy=strategy)
            resolved, tune_events = _resolve_bucket_bytes(resolved, grid, params_like, hw)
            return resolved, events + tune_events
        events.append({"event": "grad_sync_strategy_rejected", "strategy": strategy,
                       "reason": reason, "context": _CONTEXT})
    # reached when the ring lowering loses an axis: the rule rejects every
    # strategy on it, and psum runs the library's all-reduce whatever the
    # lowering
    events.append({"event": "grad_sync_downgrade", "from": cfg.strategy, "to": "psum",
                   "context": _CONTEXT})
    resolved = dataclasses.replace(cfg, strategy="psum")
    resolved, tune_events = _resolve_bucket_bytes(resolved, grid, params_like, hw)
    return resolved, events + tune_events
