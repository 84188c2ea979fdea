"""The port's elastic layer (``repro_torch/train/elastic.py``) and its
supervised ``Trainer.run`` on one CPU rank.

The supervisor's unit cases of ``tests/test_elastic.py`` run on both
packages. The trainer cases mirror ``tests/test_elastic.py`` and
``tests/test_robustness.py`` on the port (ResNet-tiny in fp32 on the 1 x 1
grid): a rollback past a non-finite streak or a lost axis ends bit-identical
to a clean run, the recovery budget and a missing checkpoint abort, a dead
checkpoint directory does not, and a kernel's error is never caught. The
8-rank cases against the JAX trainer are in ``test_torch_supervised_dist.py``
and ``test_torch_elastic_dist.py``.
"""

import os
import shutil

import pytest
import torch

from repro.testing import chaos as jchaos
from repro.train import elastic as jelastic
from repro_torch.core import losses
from repro_torch.core.batch_control import build_plan
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data.synthetic import SyntheticImageNet
from repro_torch.models import resnet
from repro_torch.testing import chaos as tchaos
from repro_torch.train import checkpoint
from repro_torch.train import elastic as telastic
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import GuardConfig, Trainer, TrainerConfig

PACKAGES = {"jax": (jelastic, jchaos), "torch": (telastic, tchaos)}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ---------------------------------------------------------------------------
# Supervisor unit semantics, both packages
# ---------------------------------------------------------------------------

def test_supervisor_axis_down_detection(pkg):
    elastic, chaos = pkg
    sup = elastic.Supervisor(elastic.ElasticConfig(), initial_down_axes=("dz",))
    plan = chaos.FaultPlan(down_axes=("dz",), axis_down_events=(("dy", 5),))
    assert sup.check_health(4, plan) is None
    failure = sup.check_health(5, plan)
    assert isinstance(failure, elastic.PermanentFailure)
    assert failure.kind == "axis_down"
    assert failure.down_axes == ("dy",) and failure.step == 5
    sup.start_recovery(failure)
    assert sup.down_axes == ("dy", "dz")
    assert sup.check_health(6, plan) is None


def test_supervisor_streak_thresholds_and_reset(pkg):
    elastic, _ = pkg
    sup = elastic.Supervisor(elastic.ElasticConfig(max_consecutive_nonfinite=3,
                                                   max_consecutive_timeouts=2))
    assert sup.observe_step(0, skipped=True) is None
    assert sup.observe_step(1, skipped=True) is None
    assert not sup.healthy
    assert sup.observe_step(2, skipped=False) is None
    assert sup.healthy
    assert sup.observe_step(3, skipped=True) is None
    assert sup.observe_step(4, skipped=True) is None
    failure = sup.observe_step(5, skipped=True)
    assert failure is not None and failure.kind == "nonfinite_streak"
    sup.start_recovery(failure)
    assert sup.healthy
    assert sup.observe_step(6, skipped=False, timed_out=True) is None
    timeout = sup.observe_step(7, skipped=False, timed_out=True)
    assert timeout is not None and timeout.kind == "timeout"


def test_supervisor_wall_clock_timeout_and_budget(pkg):
    elastic, chaos = pkg
    sup = elastic.Supervisor(elastic.ElasticConfig(
        max_consecutive_timeouts=1, step_timeout_s=0.5, max_recoveries=1))
    assert sup.observe_step(0, skipped=False, elapsed_s=0.4) is None
    failure = sup.observe_step(1, skipped=False, elapsed_s=0.9)
    assert failure is not None and failure.kind == "timeout"
    assert not sup.exhausted
    assert sup.start_recovery(failure) == 1
    assert sup.exhausted
    disabled = elastic.Supervisor(elastic.ElasticConfig(enabled=False))
    assert disabled.observe_step(0, skipped=True, timed_out=True) is None
    assert disabled.check_health(0, chaos.FaultPlan(down_axes=("dy",))) is None


def test_the_port_s_supervisor_keeps_the_reference_s_metrics():
    """Same signals, same ``elastic/*`` counters and gauges."""
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro_torch.obs.metrics import MetricsRegistry as TReg

    snaps = []
    for (elastic, chaos), reg in ((PACKAGES["jax"], JReg()), (PACKAGES["torch"], TReg())):
        sup = elastic.Supervisor(elastic.ElasticConfig(max_consecutive_nonfinite=2),
                                 metrics=reg)
        plan = chaos.FaultPlan(axis_down_events=(("dx", 3),))
        for step in range(6):
            failure = sup.check_health(step, plan) or sup.observe_step(
                step, skipped=step in (1, 2), timed_out=step == 4)
            if failure is not None:
                sup.start_recovery(failure)
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["elastic/recoveries"]["value"] == 2


def test_timed_out_reads_the_wall_clock_budget():
    sup = telastic.Supervisor(telastic.ElasticConfig(step_timeout_s=0.5))
    assert sup.timed_out(False, 0.6) and sup.timed_out(True, 0.1)
    assert not sup.timed_out(False, 0.4) and not sup.timed_out(False, None)
    assert not telastic.Supervisor(telastic.ElasticConfig()).timed_out(False, 99.0)


# ---------------------------------------------------------------------------
# The supervised trainer on one rank
# ---------------------------------------------------------------------------

CFG = resnet.ResNetConfig.tiny(num_classes=4, compute_dtype=torch.float32)
DATA = SyntheticImageNet(num_classes=4, image_size=32, noise=0.3, device="cpu")
MODEL = resnet.init(CFG, seed=0, device="cpu")


def resnet_loss(params, batch, grid):
    images, labels = batch
    logits = resnet.apply(MODEL, images, params=params, grid=grid)
    return losses.label_smoothing_xent(logits, labels, 0.1), torch.zeros(())


def make_trainer(*, max_steps, ckpt_dir=None, fault_plan=None, strategy="torus2d",
                 ckpt_every=0, elastic=telastic.ElasticConfig(), loss_fn=resnet_loss):
    plan = build_plan(BatchSchedule((BatchStage(0, 1.0, 2),)), dataset_size=256,
                      n_workers=8, max_steps=max_steps)
    tcfg = TrainerConfig(grad_sync=GradSyncConfig(strategy=strategy), guard=GuardConfig(),
                         log_every=1000, ckpt_every_steps=ckpt_every, ckpt_keep_last=10,
                         retry_backoff_s=1e-4, elastic=elastic)
    return Trainer(loss_fn, tcfg, plan, lambda i, gb: DATA.batch(i, gb),
                   checkpoint_dir=ckpt_dir, fault_plan=fault_plan)


def fresh_state():
    return TrainState.create(dict(MODEL.named_parameters()))


def assert_states_equal(a, b):
    for x, y in ((a.params, b.params), (a.opt_state["momentum"], b.opt_state["momentum"])):
        assert all(torch.equal(x[k], y[k]) for k in x)


def events_of(history, kind):
    return [h for h in history if h.get("event") == kind]


@pytest.fixture(scope="module")
def clean10():
    return make_trainer(max_steps=10).run(fresh_state(), log=lambda *a: None)[0]


def test_nonfinite_streak_rollback_bit_exact(tmp_path, clean10):
    faults = tchaos.FaultPlan(nan_grad_steps=(5, 6, 7), grad_fault_once=True)
    trainer = make_trainer(max_steps=10, ckpt_dir=str(tmp_path), fault_plan=faults,
                           ckpt_every=4,
                           elastic=telastic.ElasticConfig(max_consecutive_nonfinite=3))
    state, history = trainer.run(fresh_state(), log=lambda *a: None)
    assert state.step == 10
    failure = events_of(history, "elastic_failure")[0]
    assert failure["kind"] == "nonfinite_streak" and failure["step"] == 7
    assert events_of(history, "elastic_recovery")[0]["step"] == 4
    assert events_of(history, "grad_sync_downgrade") == []
    assert [h["step"] for h in history if h.get("skipped")] == [6, 7, 8]
    assert_states_equal(state, clean10)


def test_permanent_axis_loss_recovers_bit_exact(tmp_path):
    """Axis "dy" dies at step 6: a mid-run torus2d -> ring downgrade
    (context "elastic"), a rollback to step 4, and the end equals a ring run
    resumed from that checkpoint."""
    run_dir = str(tmp_path / "run")
    trainer = make_trainer(max_steps=10, ckpt_dir=run_dir, ckpt_every=4,
                           fault_plan=tchaos.FaultPlan(axis_down_events=(("dy", 6),)))
    state, history = trainer.run(fresh_state(), log=lambda *a: None)
    assert state.step == 10
    failure = events_of(history, "elastic_failure")
    assert [(f["kind"], f["step"], f["down_axes"]) for f in failure] == \
        [("axis_down", 6, ["dy"])]
    recovery = events_of(history, "elastic_recovery")
    assert [(r["step"], r["attempt"]) for r in recovery] == [(4, 1)]
    downgrade = events_of(history, "grad_sync_downgrade")
    assert [(d["from"], d["to"], d["context"]) for d in downgrade] == \
        [("torus2d", "ring", "elastic")]
    assert history.index(downgrade[0]) > history.index(failure[0])

    ref_dir = str(tmp_path / "ref")
    os.makedirs(ref_dir)
    ckpt4 = os.path.join(run_dir, "step_00000004.npz")
    for src in (ckpt4, checkpoint.manifest_path(ckpt4)):
        shutil.copy(src, ref_dir)
    ref_state, ref_history = make_trainer(max_steps=10, ckpt_dir=ref_dir, strategy="ring",
                                          ckpt_every=4).run(fresh_state(), resume=True,
                                                            log=lambda *a: None)
    assert events_of(ref_history, "resume")[0]["step"] == 4
    assert_states_equal(state, ref_state)


def test_timeout_streak_triggers_rollback(tmp_path):
    faults = tchaos.FaultPlan(timeout_steps=(3, 4, 5))
    trainer = make_trainer(max_steps=8, ckpt_dir=str(tmp_path), fault_plan=faults,
                           ckpt_every=2,
                           elastic=telastic.ElasticConfig(max_consecutive_timeouts=3))
    state, history = trainer.run(fresh_state(), log=lambda *a: None)
    assert state.step == 8
    failure = events_of(history, "elastic_failure")[0]
    assert failure["kind"] == "timeout" and failure["step"] == 5
    assert events_of(history, "elastic_recovery")[0]["step"] == 2


def test_recovery_budget_exhaustion_aborts(tmp_path):
    faults = tchaos.FaultPlan(nan_grad_steps=(5, 6, 7))
    trainer = make_trainer(max_steps=10, ckpt_dir=str(tmp_path), fault_plan=faults,
                           ckpt_every=4,
                           elastic=telastic.ElasticConfig(max_consecutive_nonfinite=3,
                                                          max_recoveries=2))
    with pytest.raises(RuntimeError, match="recovery budget exhausted"):
        trainer.run(fresh_state(), log=lambda *a: None)


def test_recovery_without_checkpoint_dir_aborts():
    trainer = make_trainer(max_steps=4,
                           fault_plan=tchaos.FaultPlan(axis_down_events=(("dy", 2),)))
    with pytest.raises(RuntimeError, match="no valid checkpoint"):
        trainer.run(fresh_state(), log=lambda *a: None)


def test_persistent_ckpt_dir_failure_run_still_completes(tmp_path):
    trainer = make_trainer(max_steps=8, ckpt_dir=str(tmp_path), ckpt_every=2,
                           fault_plan=tchaos.FaultPlan(ckpt_dir_fail_from=2))
    state, history = trainer.run(fresh_state(), log=lambda *a: None)
    assert state.step == 8
    assert events_of(history, "checkpoint_failed")
    assert sorted(ev["step"] for ev in events_of(history, "checkpoint")) == [0, 2]
    best = checkpoint.latest_valid(str(tmp_path), like=state)
    assert best is not None and best.endswith("step_00000002.npz")


def test_data_failures_exhaust_retries():
    faults = tchaos.FaultPlan(data_fail_steps=(1,), data_failures_per_step=99)
    with pytest.raises(RuntimeError, match="data_fn failed at step 1 after 4 attempts"):
        make_trainer(max_steps=3, fault_plan=faults).run(fresh_state(), log=lambda *a: None)


def test_resume_skips_corrupt_newest(tmp_path):
    make_trainer(max_steps=6, ckpt_dir=str(tmp_path), ckpt_every=2).run(
        fresh_state(), log=lambda *a: None)
    with open(checkpoint.latest(str(tmp_path)), "r+b") as f:
        f.truncate(100)
    _, history = make_trainer(max_steps=6, ckpt_dir=str(tmp_path)).run(
        fresh_state(), resume=True, log=lambda *a: None)
    assert events_of(history, "checkpoint_rejected")
    assert events_of(history, "resume")[0]["step"] == 4


def test_a_kernel_error_propagates_and_is_never_recovered(tmp_path):
    """A CUDA or kernel error is a RuntimeError, no fault class: the loop
    neither retries nor rolls back, and the run does not move devices."""
    calls = []

    def failing_loss(params, batch, grid):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return resnet_loss(params, batch, grid)

    trainer = make_trainer(max_steps=6, ckpt_dir=str(tmp_path), ckpt_every=1,
                           loss_fn=failing_loss)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        trainer.run(fresh_state(), log=lambda *a: None)
    assert len(calls) == 3
    assert checkpoint.latest(str(tmp_path)).endswith("step_00000002.npz")
