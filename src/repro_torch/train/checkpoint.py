"""Crash-consistent checkpointing: atomic npz + CRC manifest sidecar, in the
JAX package's on-disk format (``repro/train/checkpoint.py``).

Format:

* ``<name>.npz``           -- flat path-keyed leaves (params, LARS momentum,
  step, guard state): ``params::stages::0::1::conv1::kernel``,
  ``opt::momentum::...``, ``step``, ``loss_scale``, ``good_steps``, in the
  order the reference's ``tree_flatten_with_path`` gives them. Every leaf
  is stored in the reference's layout -- conv kernels HWIO
  (``convert.to_jax_layout``) -- so the same weights give the same bytes
  and CRCs in both packages, and a checkpoint written by either restores
  in the other. The ResNet's leaves are the port's one for one. A
  transformer's reference tree stacks its layers (``blocks::<j>::...``
  leads with the layer dim): every entry point here takes ``groups``
  (``convert.leaf_groups(names, cfg)``), and with it writes each group of
  the port's per-layer leaves as one stacked leaf, in the group's order,
  and reads it back unstacked into the per-layer tensors. ``groups=None``
  is one leaf a leaf, the ResNet's format; a transformer's checkpoint
  written without its groups holds per-layer keys that the reference
  does not read.
* ``<name>.manifest.json`` -- sidecar carrying format version, step,
  optional trainer metadata (stage info), and per-leaf CRC32/shape/dtype.

Commit protocol: payload is written to a tmp file, fsync'd, and
``os.replace``'d into place; the manifest follows the same tmp+fsync+rename
dance *after* the payload rename. The manifest is therefore the commit
record -- an npz without a manifest is an uncommitted torso (a crash
between the two renames) and is ignored by ``latest``/``latest_valid``.
A crash at any point leaves either the previous complete checkpoint or a
new complete one, never a half-written file under a committed name.

``save`` retries transient IO errors with jittered exponential backoff
(``repro_torch.utils.retry``) and prunes to ``keep_last`` checkpoints
(step-ordered). ``latest`` orders by *step* parsed from the manifest
(filename fallback) -- never by mtime, which lies for copied/restored
files. ``restore`` verifies CRCs and shapes and raises
:class:`CheckpointCorruptError` with the offending leaf; ``latest_valid``
walks candidates newest-first and returns the first that passes
validation, so a corrupt newest checkpoint falls back to the previous
valid one instead of killing the job. ``restore(path, like)`` gives the
port's layout (conv kernels OIHW) on ``like``'s device and memory layout.

:class:`AsyncCheckpointWriter` moves the commit off the training thread:
``save`` copies the state into host buffers that it owns (the only part
the caller pays for: a device-to-host copy on the card, a copy on the CPU,
so a later in-place write to the state's tensors cannot reach the file)
and enqueues the write; a single worker thread runs the identical
tmp+fsync+rename protocol, so everything above holds unchanged for async
checkpoints. The queue is bounded (backpressure, not unbounded host
memory), commits land in enqueue order, failures surface as drained events
plus ``errors``, and ``flush``/``close`` give the trainer a durability
barrier (it flushes before any restore decision).
"""

from __future__ import annotations

import collections
import json
import os
import queue as queue_lib
import re
import threading
import time
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch import convert
from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.train.state import TrainState
from repro_torch.utils.retry import retry_call

_SEP = "::"
MANIFEST_SUFFIX = ".manifest.json"
FORMAT_VERSION = 1
_STEP_RE = re.compile(r"step_(\d+)")

#: Guard-state scalars added after the first checkpoint format; restored
#: with these defaults when absent so old checkpoints keep loading.
_OPTIONAL_SCALARS = {"loss_scale": (1.0, np.float32),
                     "good_steps": (0, np.int32)}


class CheckpointError(RuntimeError):
    """Checkpoint IO failed (after retries)."""


class CheckpointCorruptError(CheckpointError):
    """The checkpoint on disk is truncated, tampered, or incomplete."""


def _key_parts(path: str, name: str) -> list[str]:
    """The npz key's components of the reference's leaf ``path`` (a JAX
    path of ``convert.leaf_groups``) holding the port's leaf ``name``: the
    port name's own components, case kept (``jax_path`` lowercases, the
    reference's checkpoint does not: mamba2's ``A_log``), with a stacked or
    prefix layer's ``layers.<i>`` as ``blocks.<j>`` or ``prefix.<i>``."""
    parts = name.split(".")
    if path.startswith(("blocks/", "prefix/")):
        return path.split("/")[:2] + parts[2:]
    return parts


def _entries(tree: dict, prefix: str, groups
             ) -> list[tuple[str, dict, tuple[str, ...], bool]]:
    """``(key, leaves, names, stacked)`` of each leaf of the reference's
    tree that a ``{name: tensor}`` dict, or a dict of such dicts
    (``opt_state``), forms, in the order ``jax.tree_util`` flattens it
    (dict keys sorted, list indices by number): ``leaves[n]`` for ``n`` in
    ``names`` are its port leaves, stacked along a new leading dim when
    ``stacked``. ``groups=None``: one leaf a port leaf."""
    if not all(isinstance(v, torch.Tensor) for v in tree.values()):
        return [e for k in sorted(tree) for e in _entries(tree[k], prefix + _SEP + k, groups)]
    if groups is None:   # the ResNet's format: one group a leaf, none stacked
        groups = convert.leaf_groups(tree)
    if sorted(n for _, names in groups for n in names) != sorted(tree):
        raise ValueError(f"{prefix}: the groups do not cover the state's leaves one for one")
    return [(prefix + _SEP + _SEP.join(_key_parts(path, names[0])), tree, names,
             convert.is_stacked(path)) for path, names in groups]


def _state_entries(state: TrainState, groups):
    return _entries(state.params, "params", groups) + _entries(state.opt_state, "opt", groups)


def _shape(leaves: dict, names: tuple[str, ...], stacked: bool) -> tuple[int, ...]:
    """The stored leaf's shape, in the reference's layout."""
    shape = tuple(convert.to_jax_layout(leaves[names[0]]).shape)
    return (len(names), *shape) if stacked else shape


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` in the reference's layout, copied into a new contiguous host
    buffer: one copy, device-to-host on the card."""
    t = convert.to_jax_layout(t.detach())
    out = torch.empty(t.shape, dtype=t.dtype)
    out.copy_(t)
    return out.numpy()


def _payload_of(state: TrainState, groups=None) -> dict[str, np.ndarray]:
    payload = {}
    for key, leaves, names, stacked in _state_entries(state, groups):
        arrs = [_to_host(leaves[n]) for n in names]
        payload[key] = np.stack(arrs) if stacked else arrs[0]
    payload["step"] = np.asarray(int(state.step), np.int32)
    payload["loss_scale"] = _to_host(state.loss_scale)
    payload["good_steps"] = _to_host(state.good_steps)
    return payload


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def manifest_path(path: str) -> str:
    return path[: -len(".npz")] + MANIFEST_SUFFIX if path.endswith(".npz") \
        else path + MANIFEST_SUFFIX


def _atomic_write(path: str, write_fn: Callable, io_hook=None,
                  hook_phase: str = "", attempt: int = 0) -> None:
    """tmp + (hook) + fsync + rename. The hook fires after the bytes are
    written but before they are durable -- the crash window fault injection
    targets (``repro_torch.testing.chaos``)."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            if io_hook is not None:
                io_hook(hook_phase, attempt)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _manifest_of(payload: dict[str, np.ndarray], step: int, name: str,
                 meta: dict | None) -> dict:
    return {
        "format_version": FORMAT_VERSION,
        "step": step,
        "name": name,
        "meta": meta or {},
        "leaves": {k: {"crc32": _crc(v), "shape": list(v.shape),
                       "dtype": str(v.dtype), "nbytes": int(v.nbytes)}
                   for k, v in payload.items()},
    }


def _commit(directory: str, path: str, payload: dict[str, np.ndarray],
            manifest: dict, *, retries: int, backoff_s: float,
            keep_last: int, io_hook, on_retry,
            metrics=NULL_REGISTRY) -> str:
    """The durable half of a save: atomic payload + manifest writes under
    the shared retry helper, then retention pruning. Runs on the caller
    thread for :func:`save`, on the worker thread for
    :class:`AsyncCheckpointWriter`. ``metrics`` (repro_torch.obs.metrics)
    receives the commit-latency histogram and commit/failure counters."""
    os.makedirs(directory, exist_ok=True)
    attempt_box = [0]

    def once():
        a = attempt_box[0]
        attempt_box[0] += 1
        if io_hook is not None:
            io_hook("begin", a)
        _atomic_write(path, lambda f: np.savez(f, **payload),
                      io_hook, "payload", a)
        _atomic_write(manifest_path(path),
                      lambda f: f.write(json.dumps(manifest).encode()),
                      io_hook, "manifest", a)

    t0 = time.monotonic()
    try:
        retry_call(once, retries=retries, backoff_s=backoff_s,
                   retry_on=(OSError,), on_retry=on_retry,
                   seed=manifest["step"])
    except OSError as e:
        metrics.counter("checkpoint/failures").inc()
        raise CheckpointError(
            f"checkpoint write failed after {retries + 1} attempts: "
            f"{e}") from e
    metrics.histogram("checkpoint/commit_s").observe(time.monotonic() - t0)
    metrics.counter("checkpoint/commits").inc()
    if keep_last > 0:
        _prune(directory, keep_last)
    return path


def _prepare(directory: str, state: TrainState, name: str | None,
             meta: dict | None, groups=None):
    """Host snapshot + manifest: the synchronous part of every save."""
    step = int(state.step)
    name = name or f"step_{step:08d}"
    path = os.path.join(directory, f"{name}.npz")
    payload = _payload_of(state, groups)
    return path, payload, _manifest_of(payload, step, name, meta)


def save(directory: str, state: TrainState, name: str | None = None, *,
         retries: int = 3, backoff_s: float = 0.05, keep_last: int = 0,
         meta: dict | None = None, io_hook=None, on_retry=None,
         metrics=NULL_REGISTRY, groups=None) -> str:
    """Atomically write ``state`` and its manifest; returns the npz path.

    ``io_hook(phase, attempt)`` (phases ``begin``/``payload``/``manifest``)
    may raise to simulate a crash; OSErrors are retried ``retries`` times
    with jittered exponential backoff starting at ``backoff_s``, reporting
    each retried attempt to ``on_retry(attempt, exc)``. ``keep_last > 0``
    prunes to the newest K checkpoints by step after a successful write.
    ``metrics`` records commit latency/outcome (repro_torch.obs.metrics).
    ``groups`` (``convert.leaf_groups``): the reference's stacked leaves,
    which a transformer's state is written as; None for the ResNet.
    """
    path, payload, manifest = _prepare(directory, state, name, meta, groups)
    return _commit(directory, path, payload, manifest, retries=retries,
                   backoff_s=backoff_s, keep_last=keep_last,
                   io_hook=io_hook, on_retry=on_retry, metrics=metrics)


class AsyncCheckpointWriter:
    """Commit checkpoints off the training thread.

    ``save`` costs the caller exactly one host snapshot (a copy of every
    leaf into a host buffer the writer owns -- device-to-host on the card,
    host-to-host on the CPU -- so a later in-place write to the state's
    tensors cannot reach the file) and one bounded-queue put; the tmp+fsync+rename commit
    protocol, retries, and retention pruning run on a single daemon worker
    thread, in enqueue order. At most ``max_pending`` saves wait in the
    queue (plus one in flight); a full queue blocks ``save`` -- bounded
    host memory, never a dropped checkpoint.

    Outcomes surface two ways: as history-event dicts via
    :meth:`drain_events` (``checkpoint`` / ``checkpoint_retry`` /
    ``checkpoint_failed``, same schema the synchronous trainer path emits)
    and as :class:`CheckpointError` instances in :attr:`errors`. A commit
    failure never kills the worker -- the run continues on the previous
    checkpoint, exactly like the synchronous path.

    ``flush`` blocks until every enqueued save is durable (the trainer's
    barrier before restore decisions and at run end); ``close`` flushes,
    stops the worker, and leaves the instance unusable.

    ``metrics`` (repro_torch.obs.metrics registry, shared with the trainer)
    observes the writer from both threads: a ``checkpoint/queue_depth``
    gauge tracks saves enqueued or in flight, and every commit lands in
    the ``checkpoint/commit_s`` latency histogram plus commit/failure
    counters -- the registry is lock-protected, so cross-thread recording
    is safe.
    """

    def __init__(self, *, max_pending: int = 2, retries: int = 3,
                 backoff_s: float = 0.05, metrics=NULL_REGISTRY):
        self._retries = retries
        self._backoff_s = backoff_s
        self._metrics = metrics
        self._queue: queue_lib.Queue = queue_lib.Queue(max(1, max_pending))
        self._events: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self._closed = False
        self.errors: list[CheckpointError] = []
        self._worker = threading.Thread(
            target=self._loop, name="ckpt-writer", daemon=True)
        self._worker.start()

    def save(self, directory: str, state: TrainState,
             name: str | None = None, *, keep_last: int = 0,
             meta: dict | None = None, io_hook=None, groups=None) -> str:
        """Snapshot ``state`` to host and enqueue the commit; returns the
        npz path the worker will write. Blocks only on the snapshot and on
        queue backpressure, never on payload IO. ``groups`` as for
        :func:`save`."""
        if self._closed:
            raise CheckpointError("writer is closed")
        path, payload, manifest = _prepare(directory, state, name, meta, groups)
        with self._lock:
            self._pending += 1
            self._metrics.gauge("checkpoint/queue_depth").set(self._pending)
        self._queue.put((directory, path, payload, manifest, keep_last,
                         io_hook))
        return path

    def pending(self) -> int:
        """Saves enqueued or in flight (0 == everything durable)."""
        with self._lock:
            return self._pending

    def drain_events(self, sink: Callable[[dict], None] | None = None
                     ) -> list[dict]:
        """Pop all completed-save events (oldest first); optionally feed
        each to ``sink``. Called from the training thread, so history stays
        single-writer."""
        out = []
        while True:
            try:
                ev = self._events.popleft()
            except IndexError:
                break
            if sink is not None:
                sink(ev)
            out.append(ev)
        return out

    def flush(self, timeout: float | None = None) -> bool:
        """Block until all enqueued saves are committed (or failed).
        Returns False on timeout."""
        with self._idle:
            return self._idle.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: float | None = None) -> None:
        """Flush, stop the worker, release the thread. Idempotent."""
        if self._closed:
            return
        self.flush(timeout)
        self._closed = True
        self._queue.put(None)
        self._worker.join(timeout)

    def _loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            directory, path, payload, manifest, keep_last, io_hook = job
            step = manifest["step"]
            try:
                _commit(directory, path, payload, manifest,
                        retries=self._retries, backoff_s=self._backoff_s,
                        keep_last=keep_last, io_hook=io_hook,
                        on_retry=lambda a, e: self._events.append(
                            {"event": "checkpoint_retry", "step": step,
                             "attempt": a, "error": str(e)}),
                        metrics=self._metrics)
                self._events.append({"event": "checkpoint", "step": step,
                                     "path": os.path.basename(path)})
            except CheckpointError as e:
                self.errors.append(e)
                self._events.append({"event": "checkpoint_failed",
                                     "step": step, "error": str(e)})
            except Exception as e:  # noqa: BLE001 -- worker must survive
                err = CheckpointError(f"async save of step {step} failed: "
                                      f"{type(e).__name__}: {e}")
                self.errors.append(err)
                self._events.append({"event": "checkpoint_failed",
                                     "step": step, "error": str(err)})
            finally:
                with self._idle:
                    self._pending -= 1
                    self._metrics.gauge("checkpoint/queue_depth").set(
                        self._pending)
                    self._idle.notify_all()


def load_manifest(path: str) -> dict | None:
    mp = manifest_path(path)
    if not os.path.exists(mp):
        return None
    try:
        with open(mp) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def validate(path: str, like: TrainState | None = None, groups=None) -> dict:
    """Full integrity check; returns the manifest or raises
    :class:`CheckpointCorruptError` naming what is wrong. With ``like``,
    also that every leaf ``like`` needs (stacked by ``groups``) is there
    in its shape."""
    if not os.path.exists(path):
        raise CheckpointCorruptError(f"{path}: missing")
    manifest = load_manifest(path)
    if manifest is None:
        raise CheckpointCorruptError(
            f"{path}: missing/unreadable manifest sidecar "
            f"({manifest_path(path)}) -- uncommitted or pre-manifest write")
    try:
        with np.load(path) as data:
            for key, info in manifest["leaves"].items():
                if key not in data:
                    raise CheckpointCorruptError(
                        f"{path}: leaf {key!r} listed in manifest but "
                        "missing from payload")
                arr = data[key]
                if list(arr.shape) != info["shape"]:
                    raise CheckpointCorruptError(
                        f"{path}: leaf {key!r} shape {list(arr.shape)} != "
                        f"manifest {info['shape']}")
                if _crc(arr) != info["crc32"]:
                    raise CheckpointCorruptError(
                        f"{path}: leaf {key!r} CRC mismatch (bit rot or "
                        "torn write)")
    except CheckpointCorruptError:
        raise
    except Exception as e:  # zipfile/np errors on truncated archives
        raise CheckpointCorruptError(
            f"{path}: unreadable payload ({type(e).__name__}: {e})") from e
    if like is not None:
        _check_structure(path, manifest, like, groups)
    return manifest


def _check_structure(path: str, manifest: dict, like: TrainState, groups) -> None:
    for key, leaves, names, stacked in _state_entries(like, groups):
        shape = _shape(leaves, names, stacked)
        info = manifest["leaves"].get(key)
        if info is None:
            raise CheckpointCorruptError(
                f"{path}: leaf {key!r} required by the target state is "
                "absent")
        if tuple(info["shape"]) != shape:
            raise CheckpointCorruptError(
                f"{path}: leaf {key!r} shape {tuple(info['shape'])} != "
                f"target {shape}")


def _fill(tree: dict, prefix: str, data, path: str, groups) -> dict:
    """A copy of ``tree`` (a ``{name: tensor}`` dict or a dict of such)
    with every leaf read from ``data`` (a stacked leaf unbound into its
    group's leaves), in the port's layout, on the leaf's device and in its
    dtype and memory layout."""
    if not all(isinstance(v, torch.Tensor) for v in tree.values()):
        return {k: _fill(v, prefix + _SEP + k, data, path, groups) for k, v in tree.items()}
    out = {}
    for key, leaves, names, stacked in _entries(tree, prefix, groups):
        if key not in data:
            raise CheckpointCorruptError(f"{path}: missing leaf {key!r}")
        arr = data[key]
        shape = _shape(leaves, names, stacked)
        if arr.shape != shape:
            raise CheckpointCorruptError(
                f"{path}: {key}: shape {arr.shape} != {shape}")
        for name, a in zip(names, arr if stacked else [arr]):
            out[name] = torch.empty_like(leaves[name]).copy_(
                torch.from_numpy(convert.from_jax_layout(a)))
    return {name: out[name] for name in tree}


def restore(path: str, like: TrainState, check: bool = True, groups=None) -> TrainState:
    """Restore into the structure of ``like`` (shapes/dtypes validated).

    ``check=True`` (default) verifies the manifest + CRC32 of every leaf
    first and raises :class:`CheckpointCorruptError` on any mismatch.
    Returns the port's layout on ``like``'s device: ``step`` an ``int``,
    ``loss_scale`` and ``good_steps`` tensors beside the params. ``groups``
    as for :func:`save`: each stacked leaf is unbound into ``like``'s
    per-layer tensors.
    """
    if check:
        validate(path, like, groups)
    try:
        npz = np.load(path)
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable payload ({type(e).__name__}: {e})") from e
    with npz as data:
        def scalar(key, like_t):
            if key in data:
                arr = data[key]
            else:
                default, dtype = _OPTIONAL_SCALARS[key]
                arr = np.asarray(default, dtype)
            return torch.as_tensor(arr).to(like_t.device, like_t.dtype)

        return TrainState(params=_fill(like.params, "params", data, path, groups),
                          opt_state=_fill(like.opt_state, "opt", data, path, groups),
                          step=int(data["step"]),
                          loss_scale=scalar("loss_scale", like.loss_scale),
                          good_steps=scalar("good_steps", like.good_steps))


def _candidates(directory: str) -> list[tuple[int, str]]:
    """(step, path) for every committed-looking npz, step-ordered ascending.

    Step comes from the manifest; for manifest-less files (legacy format)
    fall back to the ``step_NNN`` filename convention, then to mtime order
    as a last resort (legacy behavior, kept so old dirs still resolve).
    """
    if not os.path.isdir(directory):
        return []
    out = []
    for f in sorted(os.listdir(directory)):
        if not f.endswith(".npz"):
            continue
        path = os.path.join(directory, f)
        manifest = load_manifest(path)
        if manifest is not None:
            step = int(manifest.get("step", -1))
        else:
            m = _STEP_RE.search(f)
            # mtime as a sub-second ordinal only breaks ties among
            # legacy files that encode no step at all
            step = int(m.group(1)) if m else -1
        out.append((step, path))
    out.sort(key=lambda t: (t[0], os.path.getmtime(t[1]), t[1]))
    return out


def latest(directory: str) -> str | None:
    """Newest checkpoint by *step* (manifest-ordered, never mtime)."""
    cands = _candidates(directory)
    return cands[-1][1] if cands else None


def latest_valid(directory: str, like: TrainState | None = None,
                 on_skip: Callable[[str, str], None] | None = None,
                 groups=None) -> str | None:
    """Newest checkpoint that passes full validation, walking backwards
    over corrupt/incomplete ones. ``on_skip(path, reason)`` observes each
    rejected candidate (the trainer logs these as recovery events);
    ``groups`` as for :func:`save`."""
    for step, path in reversed(_candidates(directory)):
        try:
            validate(path, like, groups)
            return path
        except CheckpointCorruptError as e:
            if on_skip is not None:
                on_skip(path, str(e))
    return None


def _prune(directory: str, keep_last: int) -> None:
    """Delete all but the newest ``keep_last`` checkpoints (by step)."""
    for _, path in _candidates(directory)[:-keep_last]:
        for p in (path, manifest_path(path)):
            try:
                os.unlink(p)
            except OSError:
                pass
