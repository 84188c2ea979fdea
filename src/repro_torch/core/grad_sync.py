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

**Stacked leaves.** A JAX transformer stacks each repeated layer's leaf
over its layers (``blocks/0/mixer/q/kernel``); the port keeps a leaf a
layer. Every function here takes the reference's leaves as ``groups``
(``convert.leaf_groups``: a JAX path and the port names stacked into it)
and plans with a group as the one leaf the reference sees: its size, its
shape (the members' with a leading layer dim), its place in the JAX order.
A large group is exchanged as the stacked tensor (``torch.stack``, then
unstacked), so its flat layout, ring chunks and bf16 sums are the
reference's; a group in a shared bucket is its members raveled in layer
order, which is the stacked tensor's ravel. Without ``groups`` every leaf
is its own group (the ResNet).

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
from torch.distributed.tensor import DTensor

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
    """One leaf of the reference: a group of the port's leaves."""
    names: tuple[str, ...]   # the port's names stacked into it, in layer order
    path: str                # the reference's (``stages/0/1/conv1/kernel``)
    numel: int
    shape: tuple[int, ...]   # the reference's: a stacked leaf leads with its layers
    dtype: torch.dtype
    stacked: bool


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


def _leaves(signature, groups) -> tuple[_Leaf, ...]:
    """The reference's leaves, in its flatten order, from the port's
    ``signature`` ((name, shape, dtype) a leaf) and ``groups``."""
    by_name = {name: (tuple(shape), dtype) for name, shape, dtype in signature}
    if groups is None:
        groups = convert.leaf_groups(by_name)
    if sorted(n for _, names in groups for n in names) != sorted(by_name):
        raise ValueError("grad_sync: the groups do not cover the gradients' names")
    out = []
    for path, names in groups:
        shape, dtype = by_name[names[0]]
        if any(by_name[n] != (shape, dtype) for n in names):
            raise ValueError(f"grad_sync: the leaves stacked into {path} differ in "
                             "shape or dtype")
        stacked = convert.is_stacked(path)
        if stacked:
            shape = (len(names),) + shape
        elif len(names) != 1:
            raise ValueError(f"grad_sync: {path} is no stacked leaf but holds {names}")
        out.append(_Leaf(tuple(names), path, math.prod(shape), shape, dtype, stacked))
    return tuple(out)


@functools.lru_cache(maxsize=32)
def _schedule(signature: tuple[tuple[str, tuple[int, ...], torch.dtype], ...],
              cfg: GradSyncConfig, groups=None) -> _Schedule:
    """The reference's leaves (``groups`` of the names of ``signature``,
    (name, shape, dtype) a leaf) in its flatten order, and the exchanges
    that sync them.

    ``fuse=True``: each precision group partitioned into ``"fused"``
    buckets. ``fuse=False``: one ``"per_leaf"`` strategy exchange for each
    leaf of at least ``small_leaf_threshold`` elements (its comm dtype by
    tag match only, as the reference's, which unlike ``_precision_groups``
    does not single out fp32 vectors), then the small leaves and scalars of
    each dtype in shared ``"grouped"`` buckets, one all-reduce a bucket.
    """
    bucket_bytes = _require_resolved(cfg.bucket_bytes)
    leaves = _leaves(signature, groups)
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
                  cfg: GradSyncConfig = GradSyncConfig(), groups=None) -> list[dict]:
    """The exchange schedule ``sync_tree`` will issue, as metadata: the
    reference's ``bucket_layout``, dict for dict.

    One dict per exchange in **issue order** with keys ``group``
    ("comm"|"fp32"), ``dtype``, ``nbytes``, ``num_leaves``, ``paths``, and
    ``mode``: ``"fused"`` buckets for ``fuse=True``; for ``fuse=False`` one
    ``"per_leaf"`` entry per large leaf plus ``"grouped"`` entries for the
    shared small-leaf buckets. Reads shapes and dtypes only (meta tensors
    do). ``groups``: the reference's stacked leaves (module docstring).
    """
    sched = _schedule(_signature(grads), cfg, groups)
    return [{"group": ex.group, "dtype": _dtype_name(ex.dtype),
             "nbytes": sum(ex.sizes) * ex.dtype.itemsize, "num_leaves": len(ex.leaves),
             "paths": [sched.leaves[k].path for k in ex.leaves], "mode": ex.mode}
            for ex in sched.exchanges]


def record_bucket_metrics(grads_like: dict[str, torch.Tensor], cfg: GradSyncConfig,
                          registry, groups=None) -> list[dict]:
    """Publish the exchange schedule as gauges on a metrics registry
    (``repro_torch.obs.metrics``), under the reference's names.

    The schedule is a host-side function of the gradients' names, shapes
    and dtypes (``bucket_layout``), known once the sync config is resolved.
    Called with the params (the gradients' structure) and the resolved
    config, this sets, for the fused path:

    * ``grad_sync/num_buckets``            -- buckets in issue order
    * ``grad_sync/total_nbytes``           -- bytes over all buckets
    * ``grad_sync/bucketNN/nbytes``        -- per-bucket comm payload
    * ``grad_sync/bucketNN/num_leaves``    -- leaves packed into bucket NN

    and for the per-leaf ``fuse=False`` path:

    * ``grad_sync/num_exchanges``          -- total exchanges (both paths)
    * ``grad_sync/total_nbytes``           -- bytes over all exchanges
    * ``grad_sync/per_leaf_exchanges``     -- large-leaf strategy exchanges
    * ``grad_sync/grouped_buckets``        -- shared small-leaf buckets
    * ``grad_sync/bucketNN/...``           -- the grouped buckets only

    Every call first drops **all** ``grad_sync/`` metrics from the registry
    (``MetricsRegistry.remove_prefix``): an elastic re-resolve can change
    the bucket count or switch sync paths, and gauges from the previous
    schedule must not linger and get exported as current. Returns the
    layout (issue order); [] only when ``registry`` is None.
    """
    if registry is None:
        return []
    remove_prefix = getattr(registry, "remove_prefix", None)
    if remove_prefix is not None:
        remove_prefix("grad_sync/")
    layout = bucket_layout(grads_like, cfg, groups)
    registry.gauge("grad_sync/num_exchanges").set(len(layout))
    registry.gauge("grad_sync/total_nbytes").set(sum(b["nbytes"] for b in layout))
    if cfg.fuse:
        registry.gauge("grad_sync/num_buckets").set(len(layout))
        buckets = layout
    else:
        buckets = [b for b in layout if b["mode"] == "grouped"]
        registry.gauge("grad_sync/per_leaf_exchanges").set(
            sum(1 for b in layout if b["mode"] == "per_leaf"))
        registry.gauge("grad_sync/grouped_buckets").set(len(buckets))
    for i, b in enumerate(buckets):
        registry.gauge(f"grad_sync/bucket{i:02d}/nbytes").set(b["nbytes"])
        registry.gauge(f"grad_sync/bucket{i:02d}/num_leaves").set(b["num_leaves"])
    return layout


@functools.lru_cache(maxsize=16)
def _scale_in(dtype: torch.dtype, world: int) -> float:
    """1 / world rounded to ``dtype`` (the reference multiplies by
    ``jnp.asarray(scale, dtype)``)."""
    return torch.tensor(1.0 / world, dtype=dtype).item()


def sync_tree(grads: dict[str, torch.Tensor], grid: TorusGrid,
              cfg: GradSyncConfig = GradSyncConfig(), groups=None) -> dict[str, torch.Tensor]:
    """The mean of the gradients over the grid's ranks; every rank calls it
    with the same names and shapes. ``groups``: the reference's stacked
    leaves (module docstring). Returns a new dict in the input's key
    order, each leaf in its own shape and dtype.

    A gradient may be a DTensor sharded over other mesh dims than the
    grid's (the dry run's tensor-parallel gradients): the plan follows its
    global shape, as the reference's inside a ``shard_map`` whose model
    axis is automatic, and its local shard goes over the wire and comes
    back as a DTensor placed as it was."""
    sched = _schedule(_signature(grads), cfg, groups)
    local = {n: t.to_local() if isinstance(t, DTensor) else t for n, t in grads.items()}
    mult = grid.size
    exchanges = []
    for ex in sched.exchanges:
        if ex.mode == "per_leaf":
            leaf = sched.leaves[ex.leaves[0]]
            if leaf.stacked:   # the reference's stacked leaf: a new tensor
                buf = torch.stack([local[n] for n in leaf.names]).to(ex.dtype)
            else:              # a copy: the input leaf may be in the comm dtype
                buf = local[leaf.names[0]].to(ex.dtype, copy=True)
        else:
            buf = torch.cat([local[n].reshape(-1) for k in ex.leaves
                             for n in sched.leaves[k].names]).to(ex.dtype)
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
            rows = len(leaf.names) if leaf.stacked else local[leaf.names[0]].shape[0]
            red = red[:rows].to(leaf.dtype)
            out.update(zip(leaf.names, red.unbind(0) if leaf.stacked else (red,)))
            continue
        sizes = tuple(sum(local[n].numel() for n in sched.leaves[k].names)
                      for k in ex.leaves)
        red = red.reshape(-1)[:sum(sizes)]
        if ex.out_dtype is not None:   # one cast a bucket, not one a leaf
            red = red.to(ex.out_dtype)
        for k, part in zip(ex.leaves, torch.split(red, sizes)):
            leaf = sched.leaves[k]
            shape = local[leaf.names[0]].shape
            part = part.view((len(leaf.names), *shape) if leaf.stacked else shape)
            if ex.out_dtype is None:
                part = part.to(leaf.dtype)
            out.update(zip(leaf.names, part.unbind(0) if leaf.stacked else (part,)))
    return {name: DTensor.from_local(out[name], g.device_mesh, g.placements, run_check=False,
                                     shape=g.shape, stride=g.stride())
            if isinstance(g, DTensor) else out[name] for name, g in grads.items()}


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


def fallback_chain(strategy: str) -> tuple[str, ...]:
    return FALLBACK_CHAINS.get(strategy, (strategy, "psum"))


def _strategy_viable(strategy: str, lowering: str, grid: TorusGrid,
                     down_axes=(), probe: bool = True) -> tuple[bool, str]:
    """(viable, reason). ``reason`` explains the rejection when not viable.

    1. *Down axes* (``"dx"``, ``"dy"``): torus2d / hierarchical decompose
       the reduction into per-axis phases that map onto link dimensions, so
       a down axis kills them; the flat strategies survive with the
       ``xla`` lowering, while the ring lowering pins neighbour links.
    2. The reference's partial-manual check is JAX's own; nothing here.
    3. *Probe* (``probe=True``): one tiny all-reduce of ones over the real
       groups, which must sum to the world size. Every rank runs the same
       probes, and the verdict is the world's: a rank that read a wrong sum
       rejects the strategy on every rank, so all of them pick the same
       one. A probe that raises (a broken group, a timeout) ends the run: a
       process group is not to be trusted after a failed collective. The
       dry run passes ``probe=False``, as the reference's does: its fake
       process group moves no data, so no sum comes back.
    """
    down = set(down_axes) & set(grid.axes)
    if down:
        if strategy in ("torus2d", "hierarchical"):
            return False, (f"torus axis(es) {sorted(down)} down: per-axis "
                           "phase decomposition unavailable")
        if lowering == "ring":
            return False, (f"axis(es) {sorted(down)} down: explicit ppermute "
                           "ring pins dead neighbor links")
    if not probe:
        return True, ""
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
                          hw, context: str) -> tuple[GradSyncConfig, list[dict]]:
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
    event = {"event": "bucket_autotune", "context": context,
             "strategy": cfg.strategy, "mode": rec["mode"],
             "bucket_bytes": rec["bucket_bytes"],
             "analytic_knee_bytes": rec["analytic_knee_bytes"],
             "total_bytes": total_bytes, "hw": rec["hw"]["name"]}
    if rec["mode"] == "cost_model":
        event["exposed_seconds"] = rec["exposed_seconds"]
        event["num_buckets"] = rec["num_buckets"]
    return dataclasses.replace(cfg, bucket_bytes=rec["bucket_bytes"]), [event]


def resolve_sync_config(cfg: GradSyncConfig, grid: TorusGrid, down_axes=(),
                        params_like=None, hw=None, context: str = "startup",
                        probe: bool = True) -> tuple[GradSyncConfig, list[dict]]:
    """Walk ``cfg.strategy``'s fallback chain; return the first viable
    config plus the rejection/downgrade events.

    psum ends every chain, so a downgrade is an event, not an error. Every
    event carries ``context``: ``"startup"``, or ``"elastic"`` for the
    trainer's re-resolve after a permanent failure mid-run.
    ``bucket_bytes="auto"`` is resolved too, against ``params_like`` (the gradients' names and shapes;
    optional) and ``hw`` (an ``autotune.HardwareModel``, required for
    ``"auto"``). ``probe=False`` skips the probe all-reduce
    (``_strategy_viable``).
    """
    events: list[dict] = []
    for strategy in fallback_chain(cfg.strategy):
        ok, reason = _strategy_viable(strategy, cfg.lowering, grid, down_axes, probe)
        if ok:
            if strategy != cfg.strategy:
                events.append({"event": "grad_sync_downgrade", "from": cfg.strategy,
                               "to": strategy, "context": context})
            resolved = dataclasses.replace(cfg, strategy=strategy)
            resolved, tune_events = _resolve_bucket_bytes(resolved, grid, params_like, hw,
                                                          context)
            return resolved, events + tune_events
        events.append({"event": "grad_sync_strategy_rejected", "strategy": strategy,
                       "reason": reason, "context": context})
    # reached when the ring lowering loses an axis: the rule rejects every
    # strategy on it, and psum runs the library's all-reduce whatever the
    # lowering
    events.append({"event": "grad_sync_downgrade", "from": cfg.strategy, "to": "psum",
                   "context": context})
    resolved = dataclasses.replace(cfg, strategy="psum")
    resolved, tune_events = _resolve_bucket_bytes(resolved, grid, params_like, hw, context)
    return resolved, events + tune_events
