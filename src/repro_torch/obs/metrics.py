"""Thread-safe in-process metrics: counters, gauges, fixed-bucket histograms.

Recording must be cheap enough to sit on the training hot path (a lock
acquire + a float add / bisect), so instruments carry no labels, no
timestamps, and no per-observation allocation: a metric is one named slot
in a :class:`MetricsRegistry`, identified by a slash-separated path
(``"step/wall_s"``, ``"grad_sync/bucket03/nbytes"``,
``"events/elastic_recovery"``). The registry is the unit of sharing --
the trainer owns one per run and hands it to the checkpoint writer
(worker thread), the elastic supervisor, and the grad-sync layout
recorder, so a single lock-protected table accumulates the whole run.

``snapshot()`` renders everything to plain JSON-ready dicts; the trainer's
telemetry facade emits that as the final ``"kind": "summary"`` row of the
metrics JSONL (repro_torch.obs.sink), which is what CI gates parse
(docs/observability.md has the metric-name table).

Call sites that must work without telemetry take a registry argument and
default it to :data:`NULL_REGISTRY`, whose instruments accept every call
and record nothing.
"""

from __future__ import annotations

import bisect
import math
import threading

#: Default histogram edges for durations in seconds: exponential from
#: 0.1 ms to ~420 s (2x steps). Upper-bound ("le") semantics; observations
#: above the last edge land in the +inf overflow bucket.
DEFAULT_TIME_EDGES_S = tuple(1e-4 * 2.0 ** i for i in range(22))

#: Default edges for byte sizes: 256 B to ~8 GiB (4x steps).
DEFAULT_BYTES_EDGES = tuple(256.0 * 4.0 ** i for i in range(13))


class Counter:
    """Monotonically increasing value."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (queue depth, loss scale, bucket bytes)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.RLock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram with upper-bound ("le") edge semantics.

    ``observe(v)`` increments the count of the first bucket whose edge is
    >= v (ties land in the bucket whose edge equals v); values above the
    last edge go to the +inf overflow bucket. Also tracks count/sum/min/max
    so means survive the snapshot.
    """

    __slots__ = ("name", "edges", "counts", "count", "sum", "min", "max",
                 "_lock")

    def __init__(self, name: str, edges, lock: threading.RLock):
        if not edges:
            raise ValueError(f"histogram {name}: needs at least one "
                             "bucket edge")
        self.name = name
        self.edges = tuple(sorted(float(e) for e in edges))
        self.counts = [0] * (len(self.edges) + 1)  # last = +inf overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "buckets": [{"le": e, "count": c}
                        for e, c in zip(self.edges, self.counts)]
                       + [{"le": "inf", "count": self.counts[-1]}],
        }


class MetricsRegistry:
    """Create-or-get table of named instruments behind one RLock.

    The lock is shared with every instrument (recording and snapshotting
    never interleave mid-update), and re-entrant so an instrument method
    can be called while holding it.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, self._lock)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  edges=DEFAULT_TIME_EDGES_S) -> Histogram:
        """Create-or-get; ``edges`` only applies on first creation."""
        return self._get(name, Histogram, edges)

    def names(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._metrics if n.startswith(prefix))

    def remove_prefix(self, prefix: str) -> int:
        """Drop every instrument whose name starts with ``prefix``; returns
        how many were removed.

        For metric families that describe a *current configuration* rather
        than an accumulating series -- e.g. the ``grad_sync/bucketNN/*``
        schedule gauges -- a re-configuration (elastic downgrade, sync-path
        switch) can shrink the family, and the survivors of a plain
        re-publish would be stale. Publishers clear the family first so the
        exported set always matches the live schedule. An empty ``prefix``
        is rejected (clearing the whole registry is never what a publisher
        means).
        """
        if not prefix:
            raise ValueError("remove_prefix requires a non-empty prefix")
        with self._lock:
            doomed = [n for n in self._metrics if n.startswith(prefix)]
            for n in doomed:
                del self._metrics[n]
            return len(doomed)

    def snapshot(self) -> dict[str, dict]:
        """All instruments rendered to JSON-ready dicts, name-sorted."""
        with self._lock:
            return {n: self._metrics[n].snapshot()
                    for n in sorted(self._metrics)}


class _NullInstrument:
    """Accepts every recording call, stores nothing."""

    __slots__ = ()
    value = 0.0
    count = 0
    sum = 0.0
    mean = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


class NullRegistry(MetricsRegistry):
    """No-op registry for call sites running without telemetry."""

    _NULL = _NullInstrument()

    def __init__(self):
        super().__init__()

    def counter(self, name: str):
        return self._NULL

    def gauge(self, name: str):
        return self._NULL

    def histogram(self, name: str, edges=DEFAULT_TIME_EDGES_S):
        return self._NULL

    def names(self, prefix: str = "") -> list[str]:
        return []

    def snapshot(self) -> dict[str, dict]:
        return {}


#: Shared no-op registry: the default for every ``metrics=`` parameter.
NULL_REGISTRY = NullRegistry()
