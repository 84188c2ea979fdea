"""Crash-tolerant JSONL metric/event sinks.

Every train / dry-run / benchmark run should leave a machine-readable
artifact (the ROADMAP's overlap item needs real per-step timings, not
``print`` output that dies with the terminal). The contract:

* **One JSON object per line, one ``write`` call per record.** A crash can
  tear at most the final line; :func:`read_jsonl` drops a torn tail and
  returns every complete record -- the same "either the previous complete
  state or the new one" discipline the checkpoint layer uses
  (``repro_torch.train.checkpoint``).
* **Append + fsync-on-flush.** Records are buffered-appended (cheap on the
  hot path); ``flush()`` is the durability barrier (fsync), which the
  trainer invokes at checkpoints and on close.
* **Size-based rotation.** When the current file exceeds ``rotate_bytes``
  it is renamed to ``<path>.1``, ``<path>.2``, ... (ascending = oldest
  first) and a fresh file opened; :func:`read_run` reads the whole chain
  in order.
* **Wall-clock-free stamping.** Each record carries the sink's ``run_id``,
  a monotonically increasing ``seq``, and ``t_s`` -- seconds on the
  monotonic clock since the sink was opened. No wall-clock timestamps:
  they lie across hosts and break replay/diff of otherwise deterministic
  runs. Join to real time (and to dry-run JSON artifacts) via ``run_id``.

Schema of a stamped record (docs/observability.md):

    {"run_id": "1f2e3d4c5b6a", "seq": 17, "t_s": 0.84213,
     "kind": "metric" | "event" | "summary" | "run_header", ...payload}
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time
import uuid


def new_run_id() -> str:
    """12-hex random run identifier (joins artifacts of one run)."""
    return uuid.uuid4().hex[:12]


class JsonlSink:
    """Append-only JSONL writer with rotation and explicit durability.

    Thread-safe: ``emit`` may be called from the training thread and the
    async checkpoint worker concurrently. Payload keys never override the
    stamp keys (``run_id``/``seq``/``t_s``).
    """

    def __init__(self, path: str, *, run_id: str | None = None,
                 rotate_bytes: int = 0, meta: dict | None = None,
                 fsync_on_flush: bool = True):
        self.path = path
        self.run_id = run_id or new_run_id()
        self.rotate_bytes = int(rotate_bytes)
        self._fsync = fsync_on_flush
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._seq = 0
        self._rotations = self._existing_rotations(path)
        self._closed = False
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self._size = self._f.tell()
        self.emit({"kind": "run_header", "meta": meta or {}})

    @staticmethod
    def _existing_rotations(path: str) -> int:
        ns = [int(m.group(1)) for p in glob.glob(glob.escape(path) + ".*")
              if (m := re.fullmatch(re.escape(path) + r"\.(\d+)", p))]
        return max(ns, default=0)

    def emit(self, record: dict) -> None:
        """Stamp and append one record (one write call, no fsync)."""
        with self._lock:
            if self._closed:
                raise ValueError(f"sink {self.path} is closed")
            rec = {"run_id": self.run_id, "seq": self._seq,
                   "t_s": round(time.monotonic() - self._t0, 6)}
            rec.update((k, v) for k, v in record.items() if k not in rec)
            line = (json.dumps(rec, default=str) + "\n").encode()
            self._f.write(line)
            self._seq += 1
            self._size += len(line)
            if self.rotate_bytes and self._size >= self.rotate_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        self._f.close()
        self._rotations += 1
        os.replace(self.path, f"{self.path}.{self._rotations}")
        self._f = open(self.path, "ab")
        self._size = 0

    def flush(self) -> None:
        """Durability barrier: flush buffers and (by default) fsync."""
        with self._lock:
            if self._closed:
                return
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())

    def close(self) -> None:
        """Flush + close. Idempotent; ``emit`` afterwards raises."""
        with self._lock:
            if self._closed:
                return
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            self._closed = True

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str, strict: bool = False) -> list[dict]:
    """Parse one JSONL file, tolerating a crash-torn tail.

    A trailing line that fails to parse is silently dropped (the crash
    window of a torn final ``write``); a *non*-final bad line means real
    corruption and raises unless ``strict=False`` skips it.
    """
    records: list[dict] = []
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            last = all(not more.strip() for more in lines[i + 1:])
            if last:
                break          # torn tail: drop, keep the complete prefix
            if strict:
                raise
    return records


def run_paths(path: str) -> list[str]:
    """The rotation chain for ``path``, oldest first, current file last."""
    ns = sorted(int(m.group(1))
                for p in glob.glob(glob.escape(path) + ".*")
                if (m := re.fullmatch(re.escape(path) + r"\.(\d+)", p)))
    chain = [f"{path}.{n}" for n in ns]
    if os.path.exists(path):
        chain.append(path)
    return chain


def read_run(path: str, strict: bool = False) -> list[dict]:
    """All records of a (possibly rotated) run, in emission order."""
    out: list[dict] = []
    for p in run_paths(path):
        out.extend(read_jsonl(p, strict=strict))
    return out
