"""The program's layers in one ``torch.profiler`` window: each device
operation and each idle gap put down to the program's own range
(``repro_torch/<span>``, ``obs/tracing.py``) that the training thread was
in, read from the same Chrome trace as ``trace.py``.

- The training thread is the one that holds the ``repro_torch/step``
  ranges.
- A device operation goes to the innermost program range on the training
  thread whose interval holds its launch call (the runtime call with the
  operation's ``correlation``), whatever thread launched it: the autograd
  engine launches the backward from a thread of its own while the training
  thread waits inside ``backward``.
- An idle gap of the device is cut by the training thread's innermost
  program range over time: what the host was doing while the card waited.

Labels are the span names without the prefix; ``OUTSIDE`` is time outside
every program range (before the first step, after the last), ``NO_LAUNCH``
an operation whose launch call the trace lacks. ``DISPATCH`` names the step
function's spans and ``LOOP`` the trainer loop's others.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import Counter, defaultdict

from bench.harness.trace import DEVICE_CATS, LAUNCH_CATS, US, _window, gaps, union

PREFIX = "repro_torch/"
STEP = "step"
DISPATCH = ("dispatch", "forward", "backward", "grad_sync", "guard", "optimizer",
            "step_metrics")
LOOP = ("step", "data", "sync_wait", "log", "checkpoint")
OUTSIDE = "outside any range"
NO_LAUNCH = "no launch found"


@dataclasses.dataclass
class Ranges:
    steps: int
    device_s: dict     # label -> summed device seconds of the ops launched in it
    launches: dict     # label -> number of those ops
    idle_s: dict       # label -> idle seconds of the device while the thread was in it

    def ms_per_step(self, *labels) -> float:
        return 1e3 * sum(self.device_s.get(k, 0.0) for k in labels) / self.steps

    def idle_ms_per_step(self, *labels) -> float:
        return 1e3 * sum(self.idle_s.get(k, 0.0) for k in labels) / self.steps


def segments(ranges) -> list[tuple[float, float, str]]:
    """Nested (start, end, label) ranges of one thread flattened into
    disjoint sorted pieces, each labelled by the innermost range open over
    it; time outside every range is left out."""
    out, stack, t = [], [], 0.0
    for a, b, label in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            out.append((t, end, top))
            t = end
        if stack:
            out.append((t, a, stack[-1][1]))
        stack.append((b, label))
        t = a
    while stack:
        end, top = stack.pop()
        out.append((t, end, top))
        t = end
    return [s for s in out if s[1] > s[0]]


def _training_thread(xs):
    tids = Counter(e["tid"] for e in xs
                   if e.get("cat") == "user_annotation" and e.get("name") == PREFIX + STEP)
    return tids.most_common(1)[0][0] if tids else None


def attribute(events: list, steps: int) -> Ranges | None:
    """The ``Ranges`` of the profiled window in ``events``; None when the
    window holds no program range."""
    xs = [e for e in events if e.get("ph") == "X"]
    tid = _training_thread(xs)
    if tid is None:
        return None
    lo, hi = _window(xs)
    segs = segments((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in xs
                    if e.get("cat") == "user_annotation" and e["tid"] == tid
                    and e["name"].startswith(PREFIX))
    starts = [s[0] for s in segs]

    def label_at(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t <= segs[i][1] else OUTSIDE

    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device_s, count, dev = defaultdict(float), Counter(), []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        dev.append((a, b))
        launch = launches.get(e.get("args", {}).get("correlation"))
        label = NO_LAUNCH if launch is None else label_at(launch["ts"])
        device_s[label] += (b - a) * US
        count[label] += 1
    idle_s = defaultdict(float)
    for a, b in gaps(union(dev), lo, hi):
        inside = 0.0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(segs) and segs[i][0] < b:
            cut = min(b, segs[i][1]) - max(a, segs[i][0])
            if cut > 0:
                idle_s[segs[i][2]] += cut * US
                inside += cut
            i += 1
        if b - a > inside:
            idle_s[OUTSIDE] += (b - a - inside) * US
    return Ranges(steps=steps, device_s=dict(device_s), launches=dict(count),
                  idle_s=dict(idle_s))

