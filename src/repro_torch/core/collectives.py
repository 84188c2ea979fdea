"""All-reduce algorithms from the paper (§2.2), over the process groups of a
``topology.TorusGrid`` (``repro/core/collectives.py``).

Four strategies, each an all-reduce (sum) over every rank of the grid:

  psum          -- one all-reduce over all ranks (the library's own).
  ring          -- flat ring over all ranks (Baidu ring [14]).
  hierarchical  -- AR inside the horizontal groups, then AR across vertical
                   groups on the FULL volume (Jia et al. [6]).
  torus2d       -- the paper's scheme: reduce-scatter along horizontal rings,
                   all-reduce along vertical rings on 1/X of the volume,
                   all-gather along horizontal rings.

Each strategy has two *lowerings*:

  xla   -- one ``reduce_scatter_tensor`` / ``all_reduce`` /
           ``all_gather_into_tensor`` per phase (NCCL or gloo picks the
           in-group algorithm). The name is the JAX package's.
  ring  -- the paper's literal ring algorithm from neighbour exchanges
           (``batch_isend_irecv``), 2(n-1) of them, in the reference's chunk
           convention: rank i ends its reduce-scatter holding chunk (i+1) % n.

Every exchange is written as a generator: it issues its next operations
with ``async_op=True`` and yields their work handles, and resumes once they
are done. ``run`` drives many exchanges side by side, so each
phase of every bucket is in flight before the first wait, and every rank
issues the same sequence. A group of one returns its input untouched, as
the reference does. The input's storage may be reused for the result, and
its leading dimension must divide by the group sizes a phase splits over
(``grad_sync`` pads).
"""

from __future__ import annotations

from typing import Generator, Iterable

import torch
import torch.distributed as dist

from repro_torch.core.topology import Ring, TorusGrid

Exchange = Generator[list, None, torch.Tensor]


def run(exchanges: Iterable[Exchange]) -> list[torch.Tensor]:
    """Drive exchanges side by side: each issues its next operations and
    yields their handles; when all have issued, every handle is waited on
    and each exchange resumes. Returns their results in order."""
    live = list(enumerate(exchanges))
    results: list = [None] * len(live)
    while live:
        works, still = [], []
        for i, ex in live:
            try:
                works.extend(next(ex))
            except StopIteration as done:
                results[i] = done.value
                continue
            still.append((i, ex))
        for w in works:
            w.wait()
        live = still
    return results


def _shift(x: torch.Tensor, ring: Ring, by: int) -> Exchange:
    """Send ``x`` to the member ``by`` places on; receive from ``by`` back."""
    n, i = ring.size, ring.index
    out = torch.empty_like(x)
    yield dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), ring.ranks[(i + by) % n], ring.group),
        dist.P2POp(dist.irecv, out, ring.ranks[(i - by) % n], ring.group)])
    return out


# ---------------------------------------------------------------------------
# Explicit ring primitives (paper's literal algorithm)
# ---------------------------------------------------------------------------

def ring_reduce_scatter(x: torch.Tensor, ring: Ring) -> Exchange:
    """Ring reduce-scatter: rank i ends holding the reduced chunk
    ``(i + 1) % n`` (the standard ring convention)."""
    n, i = ring.size, ring.index
    if n == 1:
        return x
    c = x.shape[0] // n

    def chunk(k):
        k %= n
        return x[k * c:(k + 1) * c]

    acc = chunk(i)
    for s in range(n - 1):
        recv = yield from _shift(acc, ring, 1)
        acc = recv + chunk(i - 1 - s)
    return acc


def ring_all_gather(acc: torch.Tensor, ring: Ring) -> Exchange:
    """Ring all-gather of chunks from ``ring_reduce_scatter``: rank i holds
    global chunk ``(i + 1) % n``; after n - 1 exchanges every rank holds the
    concatenation in global order."""
    n, i = ring.size, ring.index
    if n == 1:
        return acc
    c = acc.shape[0]
    out = acc.new_zeros((n * c,) + tuple(acc.shape[1:]))
    k = (i + 1) % n
    out[k * c:(k + 1) * c] = acc
    cur = acc
    for s in range(n - 1):
        cur = yield from _shift(cur, ring, 1)
        # received from rank i-1-s, which held global chunk (i - s) % n
        k = (i - s) % n
        out[k * c:(k + 1) * c] = cur
    return out


def ring_all_reduce(x: torch.Tensor, ring: Ring) -> Exchange:
    """Flat ring all-reduce: RS then AG, 2(n-1) neighbour exchanges."""
    return (yield from ring_all_gather((yield from ring_reduce_scatter(x, ring)), ring))


# ---------------------------------------------------------------------------
# Phase implementations with selectable lowering
# ---------------------------------------------------------------------------

def _rs(x: torch.Tensor, ring: Ring, lowering: str) -> Exchange:
    n = ring.size
    if n == 1:
        return x
    if lowering == "xla":
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        yield [dist.reduce_scatter_tensor(out, x.contiguous(), group=ring.group,
                                          async_op=True)]
        return out
    rs = yield from ring_reduce_scatter(x, ring)
    # re-align to the library's convention (rank i holds chunk i): one hop
    return (yield from _shift(rs, ring, 1))


def _ag(x: torch.Tensor, ring: Ring, lowering: str) -> Exchange:
    n = ring.size
    if n == 1:
        return x
    if lowering == "xla":
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        yield [dist.all_gather_into_tensor(out, x.contiguous(), group=ring.group,
                                           async_op=True)]
        return out
    # rank i holds chunk i; one hop back gives the ring convention
    back = yield from _shift(x, ring, -1)
    return (yield from ring_all_gather(back, ring))


def _ar(x: torch.Tensor, ring: Ring, lowering: str) -> Exchange:
    if ring.size == 1:
        return x
    if lowering == "xla":
        x = x.contiguous()
        yield [dist.all_reduce(x, group=ring.group, async_op=True)]
        return x
    return (yield from ring_all_reduce(x, ring))


# ---------------------------------------------------------------------------
# The four strategies
# ---------------------------------------------------------------------------

def _psum(x, grid: TorusGrid, lowering: str) -> Exchange:
    return (yield from _ar(x, grid.world, "xla"))


def _flat_ring(x, grid: TorusGrid, lowering: str) -> Exchange:
    """One flat ring over all ranks: 2(N-1) steps (paper's Ring baseline)."""
    if lowering == "xla":
        x = yield from _rs(x, grid.world, "xla")
        return (yield from _ag(x, grid.world, "xla"))
    return (yield from ring_all_reduce(x, grid.world))


def _hierarchical(x, grid: TorusGrid, lowering: str) -> Exchange:
    """Jia et al. [6]: AR inside horizontal groups, then AR across vertical
    groups carrying the FULL gradient volume."""
    x = yield from _ar(x, grid.h, lowering)
    return (yield from _ar(x, grid.v, lowering))


def _torus2d(x, grid: TorusGrid, lowering: str) -> Exchange:
    """The paper's 2D-Torus all-reduce: RS along rows, AR along columns on
    1/X of the bytes, AG along rows. ``x.shape[0]`` must divide by X (by
    X * Y for the ring lowering)."""
    x = yield from _rs(x, grid.h, lowering)
    x = yield from _ar(x, grid.v, lowering)
    return (yield from _ag(x, grid.h, lowering))


STRATEGIES = {
    "psum": _psum,
    "ring": _flat_ring,
    "hierarchical": _hierarchical,
    "torus2d": _torus2d,
}
LOWERINGS = ("xla", "ring")


def exchange(x: torch.Tensor, grid: TorusGrid, strategy: str = "torus2d",
             lowering: str = "xla") -> Exchange:
    """The all-reduce (sum) of ``x`` over the grid as an exchange for ``run``."""
    try:
        fn = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(f"unknown strategy {strategy!r}; options {sorted(STRATEGIES)}") from None
    if lowering not in LOWERINGS:
        raise ValueError(f"unknown lowering {lowering!r}; options {LOWERINGS}")
    return fn(x, grid, lowering)


def all_reduce(x: torch.Tensor, grid: TorusGrid, strategy: str = "torus2d",
               lowering: str = "xla") -> torch.Tensor:
    """All-reduce (sum) of ``x`` over the grid's ranks; every rank calls it."""
    return run([exchange(x, grid, strategy, lowering)])[0]


# ---------------------------------------------------------------------------
# Analytic cost model (paper §2.2 step counts)
# ---------------------------------------------------------------------------

def comm_cost_model(strategy: str, nbytes: int, x: int, y: int,
                    link_bw: float, latency: float) -> dict:
    """Alpha-beta cost of one all-reduce of ``nbytes`` on an X x Y torus.

    Returns steps, bytes-on-wire per device, and estimated seconds. This is
    the model behind the paper's 2(X-1)-vs-2(N-1) argument and the
    hierarchical comparison (Table 2/6 analogue).
    """
    n = x * y
    if strategy == "ring":
        steps = 2 * (n - 1)
        wire = 2.0 * nbytes * (n - 1) / n
    elif strategy == "hierarchical":
        steps = 2 * (x - 1) + 2 * (y - 1)
        wire = 2.0 * nbytes * (x - 1) / x + 2.0 * nbytes * (y - 1) / y
    elif strategy == "torus2d":
        steps = 2 * (x - 1) + 2 * (y - 1)
        wire = 2.0 * nbytes * (x - 1) / x + 2.0 * (nbytes / x) * (y - 1) / y
    elif strategy == "psum":  # model as a good tree/ring hybrid == torus
        steps = 2 * (x - 1) + 2 * (y - 1)
        wire = 2.0 * nbytes * (x - 1) / x + 2.0 * (nbytes / x) * (y - 1) / y
    else:
        raise ValueError(strategy)
    seconds = steps * latency + wire / link_bw
    return {"strategy": strategy, "steps": steps, "wire_bytes": wire, "seconds": seconds}


def bucketed_comm_cost_model(strategy: str, nbytes: int, bucket_bytes: int,
                             x: int, y: int, link_bw: float, latency: float,
                             backward_seconds: float = 0.0) -> dict:
    """Alpha-beta cost of a *bucketed* gradient exchange overlapped with
    backprop.

    The gradient is split into ``k = ceil(nbytes / bucket_bytes)`` buckets.
    Every bucket pays the full per-step latency (steps x alpha -- the cost
    of more buckets) but bucket ``i`` becomes ready at
    ``backward_seconds * (i + 1) / k`` (gradients stream out of backprop in
    reverse-layer order at roughly uniform rate) and its exchange runs as
    soon as both the gradients and the link are free -- the overlap win.

    Returns ``num_buckets``, ``per_bucket`` (``comm_cost_model`` dicts),
    ``serial_seconds`` (sum of bucket costs, no overlap),
    ``exposed_seconds`` (finish of the last bucket - ``backward_seconds``),
    ``fused_exposed_seconds`` (one buffer, all after backward) and
    ``overlap_win_seconds`` (fused - exposed). With
    ``backward_seconds=0`` more buckets are strictly worse.
    """
    if bucket_bytes <= 0 or bucket_bytes >= nbytes:
        k = 1
        sizes = [nbytes]
    else:
        k = -(-int(nbytes) // int(bucket_bytes))
        sizes = [bucket_bytes] * (k - 1) + [nbytes - bucket_bytes * (k - 1)]

    per_bucket = [comm_cost_model(strategy, s, x, y, link_bw, latency)
                  for s in sizes]
    serial = sum(c["seconds"] for c in per_bucket)

    # pipeline simulation: one link, buckets issued in ready order
    t = 0.0
    for i, c in enumerate(per_bucket):
        ready = backward_seconds * (i + 1) / k
        t = max(t, ready) + c["seconds"]
    exposed = t - backward_seconds

    fused = comm_cost_model(strategy, nbytes, x, y, link_bw, latency)
    return {
        "strategy": strategy,
        "num_buckets": k,
        "bucket_bytes": bucket_bytes,
        "per_bucket": per_bucket,
        "serial_seconds": serial,
        "exposed_seconds": exposed,
        "fused_exposed_seconds": fused["seconds"],
        "overlap_win_seconds": fused["seconds"] - exposed,
    }
