"""One shared retry loop: jittered exponential backoff with a deadline cap
(a copy of ``repro/utils/retry.py``: the same sleeps for the same seed).

The loop behind ``checkpoint.save``, ``Trainer._fetch_batch`` and the
elastic rollback's restore; callers keep their own error types by catching
the re-raised final exception.

Semantics:

* attempt 0 runs immediately; up to ``retries`` further attempts follow,
  sleeping ``backoff_s * 2**k`` (capped at ``max_backoff_s``) plus a
  deterministic jitter of up to ``jitter`` of the delay (seeded ``Random``,
  so tests and distributed replays are reproducible);
* only exceptions in ``retry_on`` are retried -- anything else propagates
  immediately;
* ``deadline_s`` caps the *total* elapsed time including the upcoming
  sleep: if the next sleep would cross the deadline, the last exception is
  re-raised now instead of burning wall-clock on a retry that cannot help
  (a trainer stuck retrying is indistinguishable from a hung trainer to
  the supervisor above it);
* ``on_retry(attempt, exc)`` observes every failed attempt that will be
  retried (the trainer turns these into history events).
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterable


def retry_call(fn: Callable, *, retries: int = 3, backoff_s: float = 0.05,
               max_backoff_s: float = 2.0, jitter: float = 0.25,
               deadline_s: float | None = None,
               retry_on: tuple | Iterable = (OSError,),
               on_retry: Callable[[int, BaseException], None] | None = None,
               seed: int = 0, sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic):
    """Call ``fn()`` with retries; returns its result or re-raises the last
    exception after the attempt budget or the deadline is exhausted."""
    retry_on = tuple(retry_on)
    rng = random.Random(seed)
    start = clock()
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            last = e
            if attempt >= retries:
                break
            delay = min(backoff_s * (2.0 ** attempt), max_backoff_s)
            delay *= 1.0 + jitter * rng.random()
            if deadline_s is not None and \
                    clock() - start + delay > deadline_s:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delay)
    assert last is not None
    raise last
