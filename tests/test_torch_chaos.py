"""The port's fault injection (``repro_torch/testing/chaos.py``) against the
JAX package's (``repro/testing/chaos.py``): the same plans from the same
seed, the same poisoned element of the global batch, the same permanent
signals and checkpoint-write crashes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.testing import chaos as jchaos
from repro_torch.testing import chaos as tchaos
from repro_torch.train.trainer import shard_batch

MODULES = {"jax": jchaos, "torch": tchaos}
PLAN_FIELDS = ("seed", "nan_grad_steps", "inf_grad_steps", "grad_fault_once",
               "data_fail_steps", "data_failures_per_step", "ckpt_crash_writes",
               "ckpt_crashes_per_write", "ckpt_dir_fail_from", "down_axes",
               "axis_down_events", "timeout_steps", "timeouts_per_step")


@pytest.fixture(params=list(MODULES))
def chaos(request):
    return MODULES[request.param]


@pytest.mark.parametrize("seed,steps,kw", [(7, 100, {}), (0, 50, {}),
                                           (3, 200, dict(p_nan=0.2, p_data=0.1,
                                                         n_ckpt_crashes=3))])
def test_random_plan_equals_the_reference(seed, steps, kw):
    want = jchaos.FaultPlan.random(seed, steps, **kw)
    got = tchaos.FaultPlan.random(seed, steps, **kw)
    assert {f: getattr(got, f) for f in PLAN_FIELDS} == \
        {f: getattr(want, f) for f in PLAN_FIELDS}
    assert got.nan_grad_steps and got.data_fail_steps


def test_retryable_classes_are_the_reference_s():
    assert [c.__name__ for c in tchaos.RETRYABLE] == \
        [c.__name__ for c in jchaos.RETRYABLE]
    assert tchaos.RETRYABLE[1:] == (OSError, TimeoutError)
    # a CUDA or kernel error is a RuntimeError: never retried
    assert not issubclass(RuntimeError, tchaos.RETRYABLE)


def test_fault_plan_determinism(chaos):
    plan_a = chaos.FaultPlan.random(7, 100)
    plan_b = chaos.FaultPlan.random(7, 100)
    assert plan_a.nan_grad_steps == plan_b.nan_grad_steps
    assert plan_a.data_fail_steps == plan_b.data_fail_steps
    wrapped = plan_a.wrap_data_fn(lambda i, gb: "ok")
    step = plan_a.data_fail_steps[0]
    with pytest.raises(chaos.TransientDataError):
        wrapped(step, 16)
    assert wrapped(step, 16) == "ok"             # transient: retry succeeds


def test_fault_plan_permanent_signals(chaos):
    plan = chaos.FaultPlan(axis_down_events=(("dy", 3), ("dx", 7)),
                           timeout_steps=(4,), timeouts_per_step=2)
    assert plan.down_axes_at(2) == ()
    assert plan.down_axes_at(3) == ("dy",)
    assert plan.down_axes_at(7) == ("dx", "dy")
    assert not plan.step_timed_out(3)
    assert plan.step_timed_out(4) and plan.step_timed_out(4)
    assert not plan.step_timed_out(4)       # consumed: replay runs clean


def _global_batch(rng, rows=16):
    return (rng.randn(rows, 8, 8, 3).astype(np.float32),
            rng.randint(0, 10, (rows,)).astype(np.int32))


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("seed,step", [(0, 1), (5, 3), (123, 7)])
def test_corrupt_batch_poisons_the_reference_s_element(kind, seed, step):
    images, labels = _global_batch(np.random.RandomState(seed))
    kw = {f"{kind}_grad_steps": (step,), "seed": seed}
    want = jchaos.FaultPlan(**kw).corrupt_batch(step, (jnp.asarray(images),
                                                       jnp.asarray(labels)))
    batch = (torch.from_numpy(images.copy()), torch.from_numpy(labels.copy()))
    got = tchaos.FaultPlan(**kw).corrupt_batch(step, batch)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), labels)       # ints untouched
    assert (~np.isfinite(got[0].numpy())).sum() == 1
    # the caller's batch is left as it was
    np.testing.assert_array_equal(batch[0].numpy(), images)
    # a step outside the plan passes the batch through
    assert tchaos.FaultPlan(**kw).corrupt_batch(step + 1, batch) is batch


def test_grad_fault_once_replays_clean(chaos):
    once = chaos.FaultPlan(nan_grad_steps=(1,), grad_fault_once=True)
    if chaos is jchaos:
        batch = (jnp.ones((4, 2)), jnp.zeros((4,), jnp.int32))
    else:
        batch = (torch.ones(4, 2), torch.zeros(4, dtype=torch.int32))
    poisoned = once.corrupt_batch(1, batch)
    assert not bool(np.isfinite(np.asarray(poisoned[0])).all())
    replay = once.corrupt_batch(1, batch)
    assert bool(np.isfinite(np.asarray(replay[0])).all())


@pytest.mark.multidevice
@pytest.mark.parametrize("step", [0, 3, 9, 13])
def test_the_poisoned_element_lands_on_the_reference_s_rank(step):
    """The trainer poisons the global batch, then each rank takes its rows:
    the rank that holds the NaN is the device that the reference's batch
    sharding ``P(("dy", "dx"))`` gives it to."""
    mesh = jax.make_mesh((2, 4), ("dy", "dx"))
    images, labels = _global_batch(np.random.RandomState(step), rows=32)
    plan_kw = dict(nan_grad_steps=(step,), seed=11)
    want = jchaos.FaultPlan(**plan_kw).corrupt_batch(step, (jnp.asarray(images),
                                                           jnp.asarray(labels)))
    sharded = jax.device_put(want[0], NamedSharding(mesh, P(("dy", "dx"))))
    got = tchaos.FaultPlan(**plan_kw).corrupt_batch(
        step, (torch.from_numpy(images), torch.from_numpy(labels)))
    for r in range(8):
        dev = mesh.devices[divmod(r, 4)]
        shard = next(np.asarray(s.data) for s in sharded.addressable_shards
                     if s.device == dev)
        mine = shard_batch(got, r, 8)[0].numpy()
        np.testing.assert_array_equal(mine, shard)


def test_checkpoint_io_hook_crashes_like_the_reference():
    """The same calls raise at the same save and attempt in both packages:
    transient crashes of the first saves, then a dead directory."""
    def trace(module):
        plan = module.FaultPlan(ckpt_crash_writes=(0, 2), ckpt_crashes_per_write=2,
                                ckpt_dir_fail_from=4)
        out = []
        for save in range(6):
            for attempt in range(3):
                row = []
                for phase in ("begin", "payload", "manifest"):
                    try:
                        plan.checkpoint_io_hook(phase, attempt)
                        row.append("ok")
                    except OSError as e:
                        row.append(str(e))
                out.append((save, attempt, row))
        return out

    got, want = trace(tchaos), trace(jchaos)
    assert got == want
    assert any("persistent" in r for _, _, row in got for r in row)
