"""Elastic recovery and resume of the port's supervised ``Trainer.run`` on 8
gloo ranks, against the JAX ``Trainer`` on the (2, 4) mesh.

- Axis loss (``tests/test_elastic.py::test_permanent_axis_loss_recovers_bit_exact``):
  "dy" dies at step 6. The port emits the reference's failure, downgrade
  (context ``"elastic"``) and recovery events, rolls back to the step-4
  checkpoint on every rank, re-resolves to ring (or psum, when the ring
  lowering pins the dead links) on the grid's own subgroups, and ends
  within the gate's fp32 tolerance of the reference (rtol 1e-4, atol 1e-5).
- Resume, port against port: stopped at step 7, resumed from the step-4
  checkpoint, bit-identical to the straight run.
- Resume across packages: the reference's step-4 checkpoint, resumed by
  the port, ends within tolerance of the reference's own continuation.

Same weights, batches and fp32 buckets as ``tests/test_torch_supervised_dist.py``.
"""

import shutil

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
from repro.train import checkpoint as jcheckpoint
from repro.train.state import TrainState
from repro.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.multidevice

NUM_CLASSES = 4
STEPS = 8
AXIS_LOSS = dict(axis_down_events=(("dy", 6),))
TORUS = dict(strategy="torus2d")
RUNS = {
    "axis_loss": dict(sync=TORUS, plan_steps=STEPS, ckpt="axis", ckpt_every=4,
                      faults=AXIS_LOSS),
    "axis_loss_ring_lowering": dict(sync=dict(TORUS, lowering="ring"), plan_steps=STEPS,
                                    ckpt="axis_ring", ckpt_every=4, faults=AXIS_LOSS),
    "straight": dict(sync=TORUS, plan_steps=STEPS),
    "part": dict(sync=TORUS, plan_steps=STEPS, ckpt="resume", ckpt_every=4, max_steps=7),
    "resumed": dict(sync=TORUS, plan_steps=STEPS, ckpt="resume", ckpt_every=4,
                    resume=True),
    "from_jax": dict(sync=TORUS, plan_steps=STEPS, ckpt="from_jax", ckpt_every=4,
                     resume=True),
}


def _params():
    cfg = jresnet.ResNetConfig.tiny(compute_dtype=jnp.float32, num_classes=NUM_CLASSES)
    return cfg, jax.tree.map(np.asarray, jresnet.init(jax.random.key(0), cfg))


def _reference(ckpt_dir, fault_plan=None):
    cfg, params = _params()
    mesh = jax.make_mesh((2, 4), ("dy", "dx"))

    def loss_fn(p, batch, dp_axes):
        images, labels = batch
        logits = jresnet.apply(p, images, cfg, dp_axes=dp_axes)
        return jlosses.label_smoothing_xent(logits, labels, 0.1), jnp.zeros((), jnp.float32)

    plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in STAGES)),
                      dataset_size=DATASET, n_workers=8, max_steps=STEPS)
    trainer = Trainer(
        mesh=mesh, dp_axes=("dy", "dx"), loss_fn=loss_fn,
        cfg=TrainerConfig(schedule="B", label_smoothing=0.1, log_every=1000,
                          grad_sync=GradSyncConfig(strategy="torus2d",
                                                   comm_dtype=jnp.float32),
                          ckpt_every_steps=4, ckpt_keep_last=10, retry_backoff_s=1e-4),
        plan=plan,
        data_fn=lambda i, gb: tuple(jnp.asarray(a)
                                    for a in synthetic_batch(i, gb, NUM_CLASSES)),
        checkpoint_dir=str(ckpt_dir), fault_plan=fault_plan)
    return trainer.run(TrainState.create(params), log=lambda *a: None)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's axis-loss run, and its clean run with checkpoints
    (whose step-4 checkpoint the port resumes)."""
    clean_dir = tmp_path_factory.mktemp("jax_clean")
    return {"axis_loss": _reference(tmp_path_factory.mktemp("jax_axis"),
                                    FaultPlan(**AXIS_LOSS)),
            "clean": _reference(clean_dir), "clean_dir": clean_dir}


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    _, params = _params()
    root = tmp_path_factory.mktemp("elastic")
    step4 = reference["clean_dir"] / "step_00000004.npz"
    (root / "ckpt" / "from_jax").mkdir(parents=True)
    for src in (step4, jcheckpoint.manifest_path(str(step4))):
        shutil.copy(src, root / "ckpt" / "from_jax")
    return launch(supervised_body, root, (2, 4), params, NUM_CLASSES, RUNS,
                  str(root / "ckpt"), deadline_s=150)


def _events(history) -> list[dict]:
    """Event rows without paths, the checkpoint writer's left out (they
    arrive when its thread commits). An ``elastic_failure`` row's ``kind``
    is the failure's, in both packages, so rows are told by ``event``."""
    return [{k: v for k, v in h.items() if k != "path"} for h in history
            if "event" in h and not h["event"].startswith("checkpoint")]


def _assert_close(got, want):
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
                 got, jax.tree.map(np.asarray, want))


def _assert_equal(a, b):
    jax.tree.map(np.testing.assert_array_equal, a, b)


def test_axis_loss_recovers_like_the_reference(port, reference):
    ref_state, ref_history = reference["axis_loss"]
    want = _events(ref_history)
    assert [e["event"] for e in want] == [
        "elastic_failure", "elastic_recovery", "grad_sync_strategy_rejected",
        "grad_sync_strategy_rejected", "grad_sync_downgrade"]
    assert want[-1] == {"kind": "event", "event": "grad_sync_downgrade",
                        "from": "torus2d", "to": "ring", "context": "elastic"}
    for r in range(8):
        run = port[r]["axis_loss"]
        assert run["step"] == STEPS
        assert _events(run["history"]) == want, r
        _assert_close(run["params"], ref_state.params)
        _assert_close(run["momentum"], ref_state.opt_state["momentum"])
        _assert_equal(run["params"], port[0]["axis_loss"]["params"])


def test_axis_loss_with_the_ring_lowering_falls_back_to_psum(port, reference):
    """The ring lowering pins neighbour links, so the elastic re-resolve
    rejects every strategy on it and runs psum on the world group."""
    ref_state, _ = reference["axis_loss"]
    for r in range(8):
        run = port[r]["axis_loss_ring_lowering"]
        down = [e for e in run["history"] if e.get("event") == "grad_sync_downgrade"]
        assert [(e["from"], e["to"], e["context"]) for e in down] == \
            [("torus2d", "psum", "elastic")]
        rejected = [e["strategy"] for e in run["history"]
                    if e.get("event") == "grad_sync_strategy_rejected"]
        assert rejected == ["torus2d", "hierarchical", "ring", "psum"]
        _assert_close(run["params"], ref_state.params)


def test_resume_midstage_is_bit_exact(port):
    for r in range(8):
        run = port[r]["resumed"]
        resume = [e for e in run["history"] if e.get("event") == "resume"]
        assert [e["step"] for e in resume] == [4]      # newest valid: 4, not 7
        assert run["step"] == STEPS and port[r]["part"]["step"] == 7
        _assert_equal(run["params"], port[r]["straight"]["params"])
        _assert_equal(run["momentum"], port[r]["straight"]["momentum"])


def test_the_port_resumes_the_reference_s_checkpoint(port, reference):
    """The reference's step-4 checkpoint (HWIO kernels, its CRCs) restores
    in the port, which continues to within tolerance of the reference's own
    continuation."""
    ref_state, ref_history = reference["clean"]
    assert [h["event"] for h in ref_history if h["kind"] == "event"].count("checkpoint") >= 3
    for r in range(8):
        run = port[r]["from_jax"]
        resume = [e for e in run["history"] if e.get("event") == "resume"]
        assert [(e["step"], e["path"]) for e in resume] == [(4, "step_00000004.npz")]
        assert run["step"] == STEPS
        _assert_close(run["params"], ref_state.params)
        _assert_close(run["momentum"], ref_state.opt_state["momentum"])
