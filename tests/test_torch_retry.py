"""The port's retry helper (``repro_torch/utils/retry.py``) against the JAX
package's: every case of ``tests/test_retry.py`` runs on both modules, and
the sleeps of the two are equal for the same seed."""

import pytest

from repro.utils import retry as jretry
from repro_torch.utils import retry as tretry

MODULES = {"jax": jretry, "torch": tretry}


@pytest.fixture(params=list(MODULES))
def retry_call(request):
    return MODULES[request.param].retry_call


class Flaky:
    """Fails the first ``n_failures`` calls with ``exc_type``."""

    def __init__(self, n_failures, exc_type=OSError):
        self.n_failures = n_failures
        self.exc_type = exc_type
        self.calls = 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.n_failures:
            raise self.exc_type(f"fail #{self.calls}")
        return "ok"


def test_succeeds_after_transient_failures(retry_call):
    fn = Flaky(2)
    slept = []
    assert retry_call(fn, retries=3, backoff_s=0.01, sleep=slept.append) == "ok"
    assert fn.calls == 3
    assert len(slept) == 2


def test_exhaustion_reraises_last_exception(retry_call):
    fn = Flaky(99)
    with pytest.raises(OSError, match="fail #4"):
        retry_call(fn, retries=3, backoff_s=0.01, sleep=lambda d: None)
    assert fn.calls == 4                     # attempt 0 + 3 retries


def test_non_retryable_propagates_immediately(retry_call):
    fn = Flaky(99, exc_type=ValueError)
    with pytest.raises(ValueError, match="fail #1"):
        retry_call(fn, retries=3, retry_on=(OSError,), sleep=lambda d: None)
    assert fn.calls == 1


def test_backoff_is_exponential_with_bounded_jitter(retry_call):
    slept = []
    with pytest.raises(OSError):
        retry_call(Flaky(99), retries=4, backoff_s=0.1, jitter=0.25,
                   max_backoff_s=100.0, sleep=slept.append)
    assert len(slept) == 4
    for k, d in enumerate(slept):
        base = 0.1 * 2 ** k
        assert base <= d <= base * 1.25      # jitter adds at most 25%


def test_max_backoff_caps_delay(retry_call):
    slept = []
    with pytest.raises(OSError):
        retry_call(Flaky(99), retries=5, backoff_s=1.0, jitter=0.0,
                   max_backoff_s=2.0, sleep=slept.append)
    assert slept == [1.0, 2.0, 2.0, 2.0, 2.0]


def test_jitter_is_deterministic_in_seed(retry_call):
    def delays(seed):
        slept = []
        with pytest.raises(OSError):
            retry_call(Flaky(99), retries=3, backoff_s=0.1, seed=seed,
                       sleep=slept.append)
        return slept

    assert delays(7) == delays(7)
    assert delays(7) != delays(8)


def test_deadline_cap_stops_retrying_early(retry_call):
    """A sleep that would cross the deadline is never taken: the last
    exception surfaces instead of burning wall-clock on doomed retries."""
    now = [0.0]
    slept = []

    def sleep(d):
        slept.append(d)
        now[0] += d

    fn = Flaky(99)
    with pytest.raises(OSError):
        retry_call(fn, retries=10, backoff_s=1.0, jitter=0.0,
                   max_backoff_s=100.0, deadline_s=5.0,
                   sleep=sleep, clock=lambda: now[0])
    assert slept == [1.0, 2.0]
    assert fn.calls == 3


def test_on_retry_observes_each_retried_attempt(retry_call):
    seen = []
    fn = Flaky(2)
    retry_call(fn, retries=3, backoff_s=0.01, sleep=lambda d: None,
               on_retry=lambda a, e: seen.append((a, str(e))))
    assert [a for a, _ in seen] == [0, 1]
    assert all("fail" in msg for _, msg in seen)


def test_zero_retries_single_attempt(retry_call):
    fn = Flaky(1)
    with pytest.raises(OSError):
        retry_call(fn, retries=0, sleep=lambda d: None)
    assert fn.calls == 1


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("deadline_s", [None, 3.0])
def test_sleeps_equal_the_reference_for_the_same_seed(seed, deadline_s):
    """The jitter comes from a seeded ``random.Random``: the same seed gives
    the reference's sleeps exactly, retried attempts and deadline alike."""
    def run(module):
        now, slept, seen = [0.0], [], []

        def sleep(d):
            slept.append(d)
            now[0] += d

        fn = Flaky(99)
        with pytest.raises(OSError):
            module.retry_call(fn, retries=8, backoff_s=0.05, max_backoff_s=1.0,
                              deadline_s=deadline_s, seed=seed, sleep=sleep,
                              clock=lambda: now[0],
                              on_retry=lambda a, e: seen.append(a))
        return slept, seen, fn.calls

    assert run(tretry) == run(jretry)
