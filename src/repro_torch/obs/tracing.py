"""Nested span tracing with Chrome ``trace_event`` export
(``repro/obs/tracing.py``).

The trainer wraps each step's phases (``data`` / ``dispatch`` /
``sync_wait`` / ``log`` / ``checkpoint``) in ``with tracer.span(...)``,
giving a per-step wall-time breakdown that the metrics JSONL records and
:meth:`Tracer.export_chrome_trace` renders as a Chrome/Perfetto-loadable
``trace_event`` file. The device timeline comes from :func:`torch_profile`,
which wraps the run in ``torch.profiler.profile`` (the reference wraps it in
``jax.profiler.trace``) and writes the kernels' trace beside the spans.

Spans are exception-safe (the record is closed and flagged ``error`` when
the body raises) and nest per-thread: depth/parent come from a
thread-local stack, timestamps from the monotonic clock relative to the
tracer's epoch -- wall-clock-free, like the sink stamps
(``repro_torch.obs.sink``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch


class Span:
    """One closed (or in-flight) span. ``duration`` is None until exit."""

    __slots__ = ("name", "t0", "duration", "depth", "parent", "tid", "step",
                 "args", "error")

    def __init__(self, name: str, t0: float, depth: int, parent: str | None,
                 tid: int, step: int | None, args: dict):
        self.name = name
        self.t0 = t0
        self.duration: float | None = None
        self.depth = depth
        self.parent = parent
        self.tid = tid
        self.step = step
        self.args = args
        self.error = False

    @property
    def t1(self) -> float:
        return self.t0 + (self.duration or 0.0)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, t0={self.t0:.6f}, "
                f"dur={self.duration}, depth={self.depth})")


_NULL_SPAN = Span("null", 0.0, 0, None, 0, None, {})
_NULL_SPAN.duration = 0.0


class Tracer:
    """Collects closed spans; thread-safe, nesting tracked per thread."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._closed: list[Span] = []
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, step: int | None = None, **args):
        """``with tracer.span("sync/bucket3", step=7) as sp:`` -- on exit
        ``sp.duration`` holds the elapsed seconds. Yields a shared null
        span when the tracer is disabled (duration stays 0.0)."""
        if not self.enabled:
            yield _NULL_SPAN
            return
        stack = self._stack()
        sp = Span(name, time.monotonic() - self._t0, depth=len(stack),
                  parent=stack[-1].name if stack else None,
                  tid=threading.get_ident(), step=step, args=args)
        stack.append(sp)
        try:
            yield sp
        except BaseException:
            sp.error = True
            raise
        finally:
            sp.duration = time.monotonic() - self._t0 - sp.t0
            stack.pop()
            with self._lock:
                self._closed.append(sp)

    def spans(self, name: str | None = None,
              step: int | None = None) -> list[Span]:
        """Closed spans, optionally filtered, ordered by start time."""
        with self._lock:
            out = list(self._closed)
        if name is not None:
            out = [s for s in out if s.name == name]
        if step is not None:
            out = [s for s in out if s.step == step]
        out.sort(key=lambda s: s.t0)
        return out

    def phase_breakdown(self, step: int) -> dict[str, float]:
        """Total seconds per span name for one step (nested spans of the
        same step each contribute under their own name)."""
        out: dict[str, float] = {}
        for sp in self.spans(step=step):
            out[sp.name] = out.get(sp.name, 0.0) + (sp.duration or 0.0)
        return out

    def export_chrome_trace(self, path: str) -> int:
        """Write closed spans as Chrome ``trace_event`` JSON (complete
        "X" events, microsecond timestamps); load via chrome://tracing or
        https://ui.perfetto.dev. Returns the number of events written."""
        with self._lock:
            closed = sorted(self._closed, key=lambda s: (s.t0, s.depth))
        tids: dict[int, int] = {}
        events = []
        for sp in closed:
            tid = tids.setdefault(sp.tid, len(tids))
            args = {k: v for k, v in sp.args.items()}
            if sp.step is not None:
                args["step"] = sp.step
            if sp.error:
                args["error"] = True
            events.append({
                "name": sp.name, "cat": "host", "ph": "X",
                "ts": round(sp.t0 * 1e6, 3),
                "dur": round((sp.duration or 0.0) * 1e6, 3),
                "pid": 0, "tid": tid,
                "args": args,
            })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(events)


@contextlib.contextmanager
def torch_profile(log_dir: str | None, device=None, rank: int = 0):
    """Optionally wrap a block in ``torch.profiler.profile``.

    ``log_dir=None`` (the default everywhere) is a no-op. Otherwise the
    profiler records CPU activity, plus CUDA activity when ``device`` (where
    the run's tensors live) is a CUDA device, and on exit writes its Chrome
    trace to ``<log_dir>/torch_trace_rank<rank>.json``: the kernels each
    step launched, on the device's timeline."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"torch_trace_rank{rank}.json"))
