"""The port's supervised ``Trainer.run`` on 8 gloo ranks against the JAX
``Trainer`` on the (2, 4) mesh: the chaos run of
``tests/test_robustness.py::test_chaos_run_bit_identical_to_fault_free``
under the same ``FaultPlan`` on both sides, and the verdicts that the ranks
must agree on (a wall-clock timeout on one rank, a data shard lost on one
rank).

The port trains on 8 ranks (``tests/_pt_supervised.py``, one launch for
every run below), the reference on its 8 CPU devices, from the same fp32
weights on the same global batches (``_pt_parity.synthetic_batch``), with
fp32 buckets: the gate's fp32 tolerance holds (rtol 1e-4, atol 1e-5;
``tests/test_torch_trainer_dist.py``). Checkpoint-writer events
(``checkpoint``, ``checkpoint_retry``, ``checkpoint_failed``) arrive when
the async writer's thread commits, so they are compared as their own
sequence, the other events as theirs; rank 0 alone writes checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _pt_parity import launch, synthetic_batch
from _pt_supervised import DATASET, STAGES, supervised_body
from repro.core import losses as jlosses
from repro.core.batch_control import build_plan
from repro.core.grad_sync import GradSyncConfig
from repro.core.schedules import BatchSchedule, BatchStage
from repro.models import resnet as jresnet
from repro.testing.chaos import FaultPlan
from repro.train.state import TrainState
from repro.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.multidevice

NUM_CLASSES = 4
WRITER_EVENTS = ("checkpoint", "checkpoint_retry", "checkpoint_failed")
CHAOS = dict(nan_grad_steps=(8,), inf_grad_steps=(9,), data_fail_steps=(2, 5),
             ckpt_crash_writes=(0,), down_axes=("dy",))
RUNS = {
    "chaos": dict(sync=dict(strategy="torus2d"), plan_steps=10, ckpt="chaos",
                  ckpt_every=4, faults=CHAOS),
    "clean_ring": dict(sync=dict(strategy="ring"), plan_steps=10, max_steps=8),
    # rank 3 alone sees steps 3 and 4 take 100 s more than the 30 s budget
    "stall": dict(sync=dict(strategy="torus2d"), plan_steps=6, ckpt="stall",
                  ckpt_every=2, stall=dict(rank=3, steps=(3, 4), late_s=100.0),
                  elastic=dict(max_consecutive_timeouts=2, step_timeout_s=30.0)),
    "straight": dict(sync=dict(strategy="torus2d"), plan_steps=6),
    # rank 5 alone loses its data at step 2, every attempt
    "lost_data": dict(sync=dict(strategy="torus2d"), plan_steps=4,
                      fail_data=dict(rank=5, step=2)),
}


def _params():
    cfg = jresnet.ResNetConfig.tiny(compute_dtype=jnp.float32, num_classes=NUM_CLASSES)
    return cfg, jax.tree.map(np.asarray, jresnet.init(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, params = _params()
    root = tmp_path_factory.mktemp("supervised")
    return launch(supervised_body, root, (2, 4), params, NUM_CLASSES, RUNS,
                  str(root / "ckpt"), deadline_s=150)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's chaos run of test_robustness.py on its (2, 4) mesh."""
    cfg, params = _params()
    mesh = jax.make_mesh((2, 4), ("dy", "dx"))

    def loss_fn(p, batch, dp_axes):
        images, labels = batch
        logits = jresnet.apply(p, images, cfg, dp_axes=dp_axes)
        return jlosses.label_smoothing_xent(logits, labels, 0.1), jnp.zeros((), jnp.float32)

    plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in STAGES)),
                      dataset_size=DATASET, n_workers=8, max_steps=10)
    trainer = Trainer(
        mesh=mesh, dp_axes=("dy", "dx"), loss_fn=loss_fn,
        cfg=TrainerConfig(schedule="B", label_smoothing=0.1, log_every=1000,
                          grad_sync=GradSyncConfig(strategy="torus2d",
                                                   comm_dtype=jnp.float32),
                          ckpt_every_steps=4, ckpt_keep_last=10, retry_backoff_s=1e-4),
        plan=plan,
        data_fn=lambda i, gb: tuple(jnp.asarray(a)
                                    for a in synthetic_batch(i, gb, NUM_CLASSES)),
        checkpoint_dir=str(tmp_path_factory.mktemp("jax_chaos")),
        fault_plan=FaultPlan(**CHAOS))
    state, history = trainer.run(TrainState.create(params), log=lambda *a: None)
    return state, history


def _events(history, writer: bool) -> list[dict]:
    """Event rows without their paths: the writer's, or all others."""
    return [{k: v for k, v in h.items() if k != "path"} for h in history
            if "event" in h and (h["event"] in WRITER_EVENTS) == writer]


def _skipped(history) -> list[int]:
    return [h["step"] for h in history if h.get("skipped")]


def _assert_close(got, want):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
                 got, jax.tree.map(np.asarray, want))


def _assert_equal(a, b):
    jax.tree.map(np.testing.assert_array_equal, a, b)


def test_chaos_run_matches_the_reference(port, reference):
    """Transient data failures, a checkpoint write crashed mid-file, a down
    torus axis and non-finite gradients: the same events and skipped steps
    as the reference, and params within the gate's fp32 tolerance."""
    ref_state, ref_history = reference
    assert int(ref_state.step) == 10
    want_events = _events(ref_history, writer=False)
    assert [e["event"] for e in want_events] == [
        "grad_sync_strategy_rejected", "grad_sync_strategy_rejected",
        "grad_sync_downgrade", "data_retry", "data_retry"]
    for r in range(8):
        run = port[r]["chaos"]
        assert run["step"] == 10
        assert _events(run["history"], writer=False) == want_events, r
        assert _skipped(run["history"]) == _skipped(ref_history) == [9, 10]
        _assert_close(run["params"], ref_state.params)
        _assert_close(run["momentum"], ref_state.opt_state["momentum"])
        if r:
            assert _events(run["history"], writer=True) == []
    got_writer = _events(port[0]["chaos"]["history"], writer=True)
    assert got_writer == _events(ref_history, writer=True)
    assert [e["event"] for e in got_writer][:2] == ["checkpoint_retry", "checkpoint"]


def test_chaos_run_is_bit_identical_to_the_port_s_clean_ring_run(port):
    """Skipped steps are true no-ops: the 10-step faulted run (the last 2
    skipped, torus2d downgraded to ring) equals the clean 8-step ring run
    bit for bit, on every rank."""
    for r in range(8):
        _assert_equal(port[r]["chaos"]["params"], port[r]["clean_ring"]["params"])
        _assert_equal(port[r]["chaos"]["momentum"], port[r]["clean_ring"]["momentum"])
        _assert_equal(port[r]["chaos"]["params"], port[0]["chaos"]["params"])


def test_a_timeout_on_one_rank_recovers_every_rank_together(port):
    """Rank 3 alone reads steps 3 and 4 over ``step_timeout_s``. The ranks
    agree on the verdict, so all 8 fail at step 4, roll back to the step-2
    checkpoint together and finish (no rank waits in a collective the
    others left), bit-identical to the straight run."""
    for r in range(8):
        run = port[r]["stall"]
        assert run["step"] == 6
        failure = [e for e in run["history"] if e.get("event") == "elastic_failure"]
        recovery = [e for e in run["history"] if e.get("event") == "elastic_recovery"]
        assert [(e["kind"], e["step"]) for e in failure] == [("timeout", 4)], r
        assert [(e["step"], e["attempt"]) for e in recovery] == [(2, 1)], r
        _assert_equal(run["params"], port[r]["straight"]["params"])
        _assert_equal(run["momentum"], port[r]["straight"]["momentum"])


def test_data_lost_on_one_rank_stops_every_rank_at_that_step(port):
    """Rank 5's data_fn fails every attempt at step 2: every rank raises the
    data error at step 2, before any of them dispatches it."""
    for r in range(8):
        err = port[r]["lost_data"]["error"]
        assert err.startswith("data_fn failed at step 2 after 4 attempts"), (r, err)
        assert err.endswith("on another rank") == (r != 5), (r, err)
