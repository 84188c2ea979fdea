"""The port's train step and trainer against the JAX package's, plus the
port's isolation from JAX.

The JAX ``make_train_step`` runs on a 1x1 ("dy", "dx") mesh, where its
gradient sync is the identity, so both steps train one ResNet-tiny in fp32
from the same weights on the same numpy batches.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import losses as jlosses
from repro.models import resnet as jresnet
from repro.train import trainer as jtrainer
from repro.train.state import TrainState as JState
from repro_torch import convert
from repro_torch.core import losses as tlosses
from repro_torch.core.batch_control import build_plan
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.data.synthetic import SyntheticImageNet
from repro_torch.models import resnet as tresnet
from repro_torch.train import trainer as ttrainer
from repro_torch.train.state import TrainState as TState

REPO = Path(__file__).resolve().parents[1]


def _tiny_torch(seed=0):
    cfg = tresnet.ResNetConfig.tiny(compute_dtype=torch.float32)
    return tresnet.init(cfg, seed=seed, device="cpu")


def _torch_loss(model):
    def loss_fn(params, batch, grid):
        images, labels = batch
        logits = tresnet.apply(model, images, params=params, grid=grid)
        return tlosses.label_smoothing_xent(logits, labels, 0.1), torch.zeros(())
    return loss_fn


def test_train_step_matches_jax_on_a_1x1_mesh():
    jcfg = jresnet.ResNetConfig.tiny(compute_dtype=jnp.float32)
    jparams = jresnet.init(jax.random.key(0), jcfg)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dy", "dx"))

    def jloss(params, batch, dp_axes):
        images, labels = batch
        logits = jresnet.apply(params, images, jcfg, dp_axes=dp_axes)
        return jlosses.label_smoothing_xent(logits, labels, 0.1), jnp.zeros((), jnp.float32)

    cfg = jtrainer.TrainerConfig(schedule="B", label_smoothing=0.1)
    jstep = jtrainer.make_train_step(jloss, mesh, ("dy", "dx"), cfg, donate=False)
    jstate = JState.create(jparams)

    model = _tiny_torch()
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tstep = ttrainer.make_train_step(_torch_loss(model),
                                     ttrainer.TrainerConfig(schedule="B"))
    tstate = TState.create(tparams)

    rng = np.random.RandomState(0)
    for i in range(3):
        images = rng.randn(8, 32, 32, 3).astype(np.float32)
        labels = rng.randint(0, 10, (8,))
        # early epochs keep schedule B's lr under 1: at lr 3 the plain-SGD
        # step of the BN leaves carries the convolutions' sum-order noise
        # past 1e-4 by step 3 (one conv element at 1.9e-4)
        epoch, gb = 0.05 * i, 8
        jstate, jm = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels, jnp.int32)),
                           jnp.asarray(epoch, jnp.float32), jnp.asarray(gb, jnp.float32))
        tstate, tm = tstep(tstate, (torch.from_numpy(images), torch.from_numpy(labels)),
                           epoch, gb)
        assert set(tm) == set(jm)
        # fp32 both sides; convolutions sum in different orders
        for key in ("loss", "grad_norm", "lr", "momentum"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
        for key in ("skipped", "nonfinite_count", "loss_scale"):
            assert float(tm[key]) == float(jm[key]), key
    assert tstate.step == int(jstate.step) == 3
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                         rtol=1e-4, atol=1e-4),
                 convert.params_to_jax(tstate.params), jstate.params)


def test_guard_skips_a_nonfinite_step_and_backs_off():
    model = _tiny_torch(1)
    step = ttrainer.make_train_step(_torch_loss(model), ttrainer.TrainerConfig())
    state = TState.create(dict(model.named_parameters()), loss_scale=4.0)
    images = torch.randn(4, 32, 32, 3)
    images[0, 0, 0, 0] = float("nan")
    new, m = step(state, (images, torch.tensor([1, 2, 3, 4])), 0.0, 4)
    assert int(m["skipped"]) == 1 and int(m["nonfinite_count"]) > 0
    assert float(m["loss_scale"]) == 2.0 and int(new.good_steps) == 0
    for k, p in state.params.items():
        assert torch.equal(new.params[k], p), k
        assert torch.equal(new.opt_state["momentum"][k], state.opt_state["momentum"][k])
    # a clean step after it trains and counts
    new2, m2 = step(new, (torch.randn(4, 32, 32, 3), torch.tensor([1, 2, 3, 4])), 0.0, 4)
    assert int(m2["skipped"]) == 0 and int(new2.good_steps) == 1
    assert not torch.equal(new2.params["head.kernel"], new.params["head.kernel"])


def test_guard_regrows_the_scale_after_clean_steps():
    model = _tiny_torch(1)
    cfg = ttrainer.TrainerConfig(guard=ttrainer.GuardConfig(growth_interval=2))
    step = ttrainer.make_train_step(_torch_loss(model), cfg)
    state = TState.create(dict(model.named_parameters()), loss_scale=1.0)
    batch = (torch.randn(4, 32, 32, 3), torch.tensor([1, 2, 3, 4]))
    scales, goods = [], []
    for _ in range(3):
        state, m = step(state, batch, 0.0, 4)
        scales.append(float(m["loss_scale"]))
        goods.append(int(state.good_steps))
    assert scales == [1.0, 2.0, 2.0] and goods == [1, 0, 1]


def test_trainer_runs_both_batch_stages():
    model = _tiny_torch(2)
    data = SyntheticImageNet(num_classes=10, image_size=32, noise=0.3, device="cpu")
    sched = BatchSchedule((BatchStage(0, 1, 4), BatchStage(1, 2, 8)))
    plan = build_plan(sched, dataset_size=16, n_workers=1)
    trainer = ttrainer.Trainer(_torch_loss(model), ttrainer.TrainerConfig(log_every=1),
                               plan, lambda i, gb: data.batch(i, gb))
    lines = []
    state, history = trainer.run(TState.create(dict(model.named_parameters())),
                                 log=lines.append)
    assert state.step == plan.total_steps == 6 == len(history) == len(lines)
    assert [h["global_batch"] for h in history] == [4] * 4 + [8] * 2
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in history)
    assert all(h["kind"] == "metric" and h["wall_s"] > 0 for h in history)
    _, short = trainer.run(TState.create(dict(model.named_parameters())),
                           max_steps=3, log=lambda s: None)
    assert [h["step"] for h in short] == [1, 2, 3]


def test_entry_points_without_a_device_refuse_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tresnet.init(tresnet.ResNetConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticImageNet(num_classes=10, image_size=32).batch(0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax({"w": np.ones(3, np.float32)})


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch, and chip_smoke.py, import without JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "want = {'repro_torch.core.' + m for m in\n"
        "        ('topology', 'collectives', 'grad_sync', 'autotune')}\n"
        "assert want <= set(sys.modules), want - set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Run as it is on a machine without CUDA, chip_smoke.py exits non-zero
    with no JSON result line, here and alone in an empty directory."""
    for where in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if where == tmp_path:
            script = tmp_path / "chip_smoke.py"
            script.write_text((REPO / "chip_smoke.py").read_text())
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, str(script)], cwd=where, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
