"""Observability: structured metrics, JSONL sinks, span tracing
(``repro/obs/__init__.py``).

The three building blocks (each usable standalone):

* :mod:`repro_torch.obs.metrics` -- thread-safe counters / gauges /
  fixed-bucket histograms in a :class:`~repro_torch.obs.metrics.MetricsRegistry`.
* :mod:`repro_torch.obs.sink`    -- crash-tolerant JSONL artifacts (append +
  fsync-on-flush, size rotation, run-id + monotonic stamping).
* :mod:`repro_torch.obs.tracing` -- nested host-side spans with Chrome
  ``trace_event`` export and an optional ``torch.profiler`` window; under
  an active profiler each span is also a ``repro_torch/<span>`` range.

The metric names and the JSONL schema are the reference's, so a reader of
either package's artifacts reads both.

:class:`Telemetry` bundles them for the trainer: one registry + tracer per
rank and run, an optional sink when ``ObsConfig.metrics_path`` is set, and a
``close()`` that emits the final metrics snapshot as a ``"summary"`` row
and writes the Chrome trace; its tracer keeps the closed spans only for
that export (``trace_path`` set), and otherwise drops each on exit, so a
long run's memory stays flat. On more than one rank only rank 0 opens the
sink and writes the trace (the reference writes one artifact a run from its
single controller); every rank keeps its own registry. Everything degrades
to near-zero overhead when disabled (null registry, null spans, no sink),
so the trainer never branches on "is observability on" in the hot path.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.obs.metrics import (DEFAULT_BYTES_EDGES, DEFAULT_TIME_EDGES_S,
                                     MetricsRegistry, NULL_REGISTRY, NullRegistry)
from repro_torch.obs.sink import JsonlSink, new_run_id, read_jsonl, read_run
from repro_torch.obs.tracing import Span, Tracer, torch_profile

__all__ = [
    "DEFAULT_BYTES_EDGES", "DEFAULT_TIME_EDGES_S", "JsonlSink",
    "MetricsRegistry", "NULL_REGISTRY", "NullRegistry", "ObsConfig", "Span",
    "Telemetry", "Tracer", "fingerprint", "new_run_id", "read_jsonl",
    "read_run", "torch_profile",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Trainer-facing observability knobs (``TrainerConfig.obs``)."""

    enabled: bool = True
    #: metrics/event JSONL path; None = in-memory registry only, no artifact
    metrics_path: str | None = None
    #: Chrome trace_event JSON of the host spans, written on close; None = none
    trace_path: str | None = None
    #: torch.profiler window around the run, its trace written here; None = off
    torch_profile_dir: str | None = None
    #: rotate the metrics JSONL when it exceeds this many bytes (0 = never)
    rotate_bytes: int = 0
    #: emit a per-step ``step_phases`` row every N steps (sink only)
    step_metrics_every: int = 1


def fingerprint(obj) -> str:
    """12-hex content hash of a JSON-serializable config summary.

    Deterministic across processes (canonical key order, ``default=str``
    for dtypes and other non-JSON leaves); joins metrics artifacts to the
    resolved config that produced them."""
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


class Telemetry:
    """One rank's registry + tracer + (rank 0: optional) sink, under one
    run_id."""

    def __init__(self, cfg: ObsConfig | None = None, *,
                 run_id: str | None = None, meta: dict | None = None,
                 rank: int = 0):
        self.cfg = cfg = cfg or ObsConfig()
        on = cfg.enabled
        self.rank = rank
        self.registry: MetricsRegistry = MetricsRegistry() if on \
            else NULL_REGISTRY
        self.tracer = Tracer(enabled=on,
                             keep=bool(on and cfg.trace_path and rank == 0))
        self.sink: JsonlSink | None = None
        if on and cfg.metrics_path and rank == 0:
            self.sink = JsonlSink(cfg.metrics_path, run_id=run_id,
                                  rotate_bytes=cfg.rotate_bytes, meta=meta)
        self.run_id = self.sink.run_id if self.sink else \
            (run_id or new_run_id())
        self._closed = False

    def span(self, name: str, step: int | None = None, **args):
        return self.tracer.span(name, step=step, **args)

    def emit(self, record: dict) -> None:
        """Mirror a record to the sink (no-op without one)."""
        if self.sink is not None:
            self.sink.emit(record)

    def event(self, etype: str, **kw) -> dict:
        """Count + emit an event row; returns the (unstamped) record."""
        self.registry.counter(f"events/{etype}").inc()
        rec = {"kind": "event", "event": etype, **kw}
        self.emit(rec)
        return rec

    def flush(self) -> None:
        if self.sink is not None:
            self.sink.flush()

    def summary(self) -> dict:
        """The final snapshot row (also what ``close`` emits)."""
        return {"kind": "summary", "run_id": self.run_id,
                "metrics": self.registry.snapshot()}

    def close(self) -> None:
        """Emit the summary row, export the Chrome trace (rank 0), close the
        sink. Idempotent; safe to call on a run that crashed mid-step."""
        if self._closed:
            return
        self._closed = True
        if self.sink is not None:
            self.sink.emit(self.summary())
            self.sink.close()
        if self.cfg.enabled and self.cfg.trace_path and self.rank == 0:
            self.tracer.export_chrome_trace(self.cfg.trace_path)

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
