"""The 8-rank main-path gate: the port's ``Trainer`` against the JAX
package's on ResNet-tiny.

The port trains on 8 gloo ranks (``tests/_pt_parity.py``, one launch for
every run below), the reference on a (2, 4) ("dy", "dx") mesh of its 8 CPU
devices, from the same fp32 weights (``repro.models.resnet.init``, seed 0,
carried over by ``repro_torch.convert.params_from_jax``) on the same global
batches (``_pt_parity.synthetic_batch``): the paper's recipe, torus2d with
bucketed comm, LARS, label smoothing 0.1 and schedule B, over two batch
stages (6 steps of 16 images, then 4 of 32), inside schedule B's warmup.

Tolerances:
- fp32 comm (the gate's run with fp32 buckets, and one step of each
  strategy): the reference's own rtol 1e-4, atol 1e-5
  (``tests/test_train_integration.py:69``). The port's fp32 gate lands
  within 3e-7 of the reference's params after 10 steps.
- bf16 comm (the gate): final params atol 1.2e-3 and per-step loss rtol
  1e-4. gloo and XLA add the eight bf16 partials of each gradient element
  in different orders, so an element can differ by a unit of bf16 (2^-8
  relative) after each sync, and LARS carries that into the params at the
  step's learning rate. On this run the two packages' params end 8.9e-4
  apart at most, the reference's own bf16-comm params 1.45e-3 from its
  fp32-comm ones (and the port's fp32-comm params 1.45e-3 from the
  reference's bf16 ones), and the losses 1.6e-5 apart (relative). The
  limit lies between the two readings, so a sync that left out the bf16
  cast fails it; the gate also holds the port's bf16 params nearer the
  reference's bf16 run than its fp32 run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _pt_parity import launch, synthetic_batch, trainer_body
from repro.core import losses as jlosses
from repro.core.batch_control import build_plan
from repro.core.grad_sync import GradSyncConfig
from repro.core.schedules import BatchSchedule, BatchStage
from repro.models import resnet as jresnet
from repro.train.state import TrainState
from repro.train.trainer import Trainer, TrainerConfig
from repro_torch.core.topology import select_grid
from repro_torch.train.trainer import shard_batch

pytestmark = pytest.mark.multidevice

NUM_CLASSES = 10
GATE = ((0, 0.02, 2), (0.02, 0.06, 4)), 4096, 10   # stages, dataset size, steps
STRATEGIES = ["psum", "ring", "hierarchical", "torus2d"]
RUNS = {"gate": (dict(strategy="torus2d", bucket_bytes=16 << 10), *GATE),
        "gate_fp32": (dict(strategy="torus2d", bucket_bytes=16 << 10,
                           comm_dtype="float32"), *GATE)}
RUNS.update({s: (dict(strategy=s, comm_dtype="float32"), ((0, 1, 2),), 256, 1)
             for s in STRATEGIES})


def _params():
    cfg = jresnet.ResNetConfig.tiny(compute_dtype=jnp.float32, num_classes=NUM_CLASSES)
    return cfg, jax.tree.map(np.asarray, jresnet.init(jax.random.key(0), cfg))


def _torch_runs():
    import torch
    return {k: (dict(kw, comm_dtype=getattr(torch, kw.get("comm_dtype", "bfloat16"))),
                stages, size, steps) for k, (kw, stages, size, steps) in RUNS.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, params = _params()
    return launch(trainer_body, tmp_path_factory.mktemp("trainer"), (2, 4), params,
                  NUM_CLASSES, _torch_runs())


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((2, 4), ("dy", "dx"))


@pytest.fixture(scope="module")
def reference(mesh):
    """``_reference`` on the mesh, each run computed once."""
    return functools.lru_cache(maxsize=None)(functools.partial(_reference, mesh))


def _max_gap(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(jax.tree.leaves(a),
                                                          jax.tree.leaves(b)))


def _reference(mesh, key):
    kw, stages, dataset_size, steps = RUNS[key]
    kw = dict(kw, comm_dtype=getattr(jnp, kw.get("comm_dtype", "bfloat16")))
    cfg, params = _params()

    def loss_fn(p, batch, dp_axes):
        images, labels = batch
        logits = jresnet.apply(p, images, cfg, dp_axes=dp_axes)
        return jlosses.label_smoothing_xent(logits, labels, 0.1), jnp.zeros((), jnp.float32)

    plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in stages)),
                      dataset_size=dataset_size, n_workers=8, max_steps=steps)
    trainer = Trainer(mesh=mesh, dp_axes=("dy", "dx"), loss_fn=loss_fn,
                      cfg=TrainerConfig(schedule="B", label_smoothing=0.1, log_every=1,
                                        grad_sync=GradSyncConfig(**kw)),
                      plan=plan,
                      data_fn=lambda i, gb: tuple(
                          jnp.asarray(a) for a in synthetic_batch(i, gb, NUM_CLASSES)))
    state, history = trainer.run(TrainState.create(params), log=lambda *a: None)
    rows = [h for h in history if h["kind"] == "metric"]
    return rows, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("run,params_tol,loss_rtol", [("gate", dict(rtol=0, atol=1.2e-3), 1e-4),
                                                    ("gate_fp32", dict(rtol=1e-4, atol=1e-5),
                                                     1e-5)])
def test_gate_trains_like_the_reference_over_two_batch_stages(port, reference, run,
                                                              params_tol, loss_rtol):
    want_rows, want_params = reference(run)
    assert [r["global_batch"] for r in want_rows] == [16] * 6 + [32] * 4
    for r in range(8):
        rows, params = port[r][run]
        assert [h["step"] for h in rows] == [h["step"] for h in want_rows]
        assert [h["global_batch"] for h in rows] == [h["global_batch"] for h in want_rows]
        assert all(h["skipped"] == 0 for h in rows)
        np.testing.assert_allclose([h["lr"] for h in rows], [h["lr"] for h in want_rows],
                                   rtol=1e-6)
        np.testing.assert_allclose([h["loss"] for h in rows],
                                   [h["loss"] for h in want_rows], rtol=loss_rtol)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **params_tol),
                     params, want_params)
        if run == "gate":   # the comm precision shows: nearer bf16 than fp32 comm
            assert _max_gap(params, want_params) < _max_gap(params, reference("gate_fp32")[1])
    # every rank holds the same params
    for r in range(1, 8):
        jax.tree.map(np.testing.assert_array_equal, port[r][run][1], port[0][run][1])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_one_fp32_step_of_each_strategy_matches_the_reference(port, reference, strategy):
    want_rows, want_params = reference(strategy)
    rows, params = port[0][strategy]
    assert len(rows) == len(want_rows) == 1
    np.testing.assert_allclose(rows[0]["loss"], want_rows[0]["loss"], rtol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
                 params, want_params)


def test_each_rank_gets_the_rows_its_device_gets_on_the_reference_mesh(mesh):
    """Rank r = dy * X + dx trains on the rows that the batch sharding
    ``P(("dy", "dx"))`` puts on device (dy, dx) of the reference's mesh."""
    x = np.arange(32 * 3).reshape(32, 3)
    y = np.arange(32)
    sharded = jax.device_put(x, jax.sharding.NamedSharding(mesh, P(("dy", "dx"))))
    grid = select_grid((2, 4))
    for r in range(8):
        dev = mesh.devices[grid.coords(r)]
        want = next(np.asarray(s.data) for s in sharded.addressable_shards if s.device == dev)
        got_x, got_y = shard_batch((torch.from_numpy(x), torch.from_numpy(y)), r, 8)
        np.testing.assert_array_equal(got_x.numpy(), want)
        np.testing.assert_array_equal(got_y.numpy(), want[:, 0] // 3)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch((torch.zeros(12),), 0, 8)
