"""The reduction of one ``torch.profiler`` window to what the per-layer
metrics read: the device operations in the window with their classes, the
time in which any of them ran (the union of their intervals, so that NCCL's
stream and the compute stream are not counted twice), the idle gaps
between them, and what the host was doing in each gap.

It reads the profiler's Chrome trace (``export_chrome_trace``): device
operations are the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the window is the benchmark's own ``record_function`` range
around the profiled steps where the host's operators were recorded, and
otherwise spans the runtime's calls and the device's operations. A gap is
labelled by the outermost host operation (``cpu_op`` or ``user_annotation``)
that was open, on the launching thread, when the operation that ends the gap
was launched (the runtime call with the same ``correlation``).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

from bench.harness.classes import classify

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")       # the host's launch calls
WINDOW = "bench.window"
US = 1e-6


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that the disjoint sorted ``busy`` leaves free."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    ops: list          # (name, class, start_s, dur_s) of each device op in the window
    gaps: list         # (label, seconds) of each idle gap

    def ms_per_step(self, include=None, exclude=()) -> float:
        """Device ms a step of the ops whose class is in ``include`` (None:
        every class) and not in ``exclude``."""
        return 1e3 * sum(d for _, c, _, d in self.ops
                         if (include is None or c in include) and c not in exclude) / self.steps

    def launches_per_step(self) -> float:
        return len(self.ops) / self.steps

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, _, _, d in self.ops:
            by[name] += d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_label(self, n: int = 10) -> list:
        by = defaultdict(float)
        for label, s in self.gaps:
            by[label] += s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _outermost(host) -> dict:
    """tid -> (sorted starts, [(start, end, name)]) of the outermost host ops."""
    by_tid = defaultdict(list)
    for e in sorted(host, key=lambda e: (e["ts"], -e["dur"])):
        tops = by_tid[e["tid"]]
        if not tops or e["ts"] >= tops[-1][1]:
            tops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    return {tid: ([t[0] for t in tops], tops) for tid, tops in by_tid.items()}


def _label(launch, tops) -> str:
    if launch is None:
        return "no launch found"
    starts, ops = tops.get(launch["tid"], ([], []))
    i = bisect.bisect_right(starts, launch["ts"]) - 1
    if i >= 0 and ops[i][1] >= launch["ts"]:
        return ops[i][2]
    return launch["name"]


def _window(xs) -> tuple[float, float]:
    """The benchmark's range where the host's operators were recorded;
    without them, from the first runtime call to the end of the last device
    operation (the run's start-up before its first launch left out)."""
    for e in xs:
        if e.get("name") == WINDOW and e.get("cat") in HOST_CATS:
            return e["ts"], e["ts"] + e["dur"]
    starts = [e["ts"] for e in xs if e.get("cat") in LAUNCH_CATS]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    return (min(starts + [e["ts"] for e in dev]), max(e["ts"] + e["dur"] for e in dev))


def reduce(events: list, steps: int) -> Trace:
    """The ``Trace`` of the profiled window in ``events``."""
    xs = [e for e in events if e.get("ph") == "X"]
    lo, hi = _window(xs)
    dev, host, launches = [], [], {}
    for e in xs:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                dev.append((a, b, e))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append(e)
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
    busy = union((a, b) for a, b, _ in dev)
    tops = _outermost(host)
    starts = sorted(((a, e) for a, _, e in dev), key=lambda ae: ae[0])
    keys = [a for a, _ in starts]
    labelled = []
    for a, b in gaps(busy, lo, hi):
        i = bisect.bisect_left(keys, b)
        if i == len(keys):
            labelled.append(("after the last device op", (b - a) * US))
            continue
        nxt = starts[i][1]
        launch = launches.get(nxt.get("args", {}).get("correlation"))
        labelled.append((_label(launch, tops), (b - a) * US))
    ops = [(e["name"], classify(e["name"]), a * US, (b - a) * US) for a, b, e in dev]
    return Trace(steps=steps, window_s=(hi - lo) * US,
                 busy_s=sum(b - a for a, b in busy) * US, ops=ops, gaps=labelled)


def load(path) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]
