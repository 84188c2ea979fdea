"""A transformer's checkpoint in the reference's stacked format: the port's
``train/checkpoint.py`` with ``groups=`` (``convert.leaf_groups``) against
the JAX package's ``repro/train/checkpoint.py``, for the smoke configs of
the ten archs.

The reference's tree stacks its layers (``blocks::<j>::...`` leads with
the layer dim); the port keeps one tensor a layer. With the groups the
port writes each group stacked, in the group's order, and reads it back
unbound, so the same weights give the same npz keys, bytes, CRCs and
manifest in both packages, and each restores the other's checkpoint bit
for bit (mamba2's ``A_log`` and ``D`` keep their case). The trainer,
given the groups, resumes an LM run from a checkpoint the JAX trainer
wrote and ends where the JAX run ends, within ``test_torch_train_step_lm``'s
tolerances (the same fp32 math summed in other orders: loss rtol 1e-5,
params rtol 1e-4 and atol 1e-6). The 8-rank case is in
``tests/test_torch_train_lm_dist.py``.
"""

import dataclasses
import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _pt_parity import lm_batch
from repro.configs import registry as jregistry
from repro.core import losses as jlosses
from repro.core.batch_control import build_plan as jbuild_plan
from repro.core.grad_sync import GradSyncConfig as JSync
from repro.core.schedules import BatchSchedule as JSchedule
from repro.core.schedules import BatchStage as JStage
from repro.models import resnet as jresnet
from repro.models import transformer as jT
from repro.train import checkpoint as jck
from repro.train import trainer as jtrainer
from repro.train.state import TrainState as JState
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.core.batch_control import build_plan
from repro_torch.core.grad_sync import GradSyncConfig
from repro_torch.core.schedules import BatchSchedule, BatchStage
from repro_torch.launch.train import loss_fn_for
from repro_torch.train import checkpoint
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = ("qwen3-1.7b", "gemma2-27b", "gemma-7b", "llama3-405b", "musicgen-medium",
         "granite-moe-3b-a800m", "kimi-k2-1t-a32b", "mamba2-2.7b", "recurrentgemma-9b",
         "llama-3.2-vision-90b")


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, seed: int):
    cfg = jregistry.get_smoke(arch)
    return jax.tree.map(np.asarray, jT.init(jax.random.key(seed), cfg))


def _pair(arch: str, seed: int = 0, step: int = 5):
    """The same train state in both packages, the port's leaf groups, and
    the port's config: smoke params, momentum params / 3 (every leaf
    non-zero), and the guard scalars."""
    tcfg = tregistry.get_smoke(arch)
    tree = _jax_params(arch, seed)
    mom = jax.tree.map(lambda a: a / 3, tree)
    js = JState(jax.tree.map(jnp.asarray, tree), {"momentum": jax.tree.map(jnp.asarray, mom)},
                jnp.asarray(step, jnp.int32), jnp.asarray(8.0, jnp.float32),
                jnp.asarray(3, jnp.int32))
    params = convert.transformer_from_jax(tree, tcfg, device="cpu")
    ts = TrainState(params, {"momentum": convert.transformer_from_jax(mom, tcfg, device="cpu")},
                    step, torch.tensor(8.0), torch.tensor(3, dtype=torch.int32))
    return js, ts, convert.leaf_groups(params, tcfg)


def _assert_states_equal(a: TrainState, b: TrainState):
    assert list(a.params) == list(b.params)
    for x, y in ((a.params, b.params), (a.opt_state["momentum"], b.opt_state["momentum"])):
        assert list(x) == list(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]), k
    assert a.step == b.step
    assert torch.equal(a.loss_scale, b.loss_scale) and torch.equal(a.good_steps, b.good_steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_both_packages_write_the_same_stacked_checkpoint(arch, tmp_path):
    js, ts, groups = _pair(arch)
    pj = jck.save(str(tmp_path / "jax"), js, meta={"global_batch": 16})
    pt = checkpoint.save(str(tmp_path / "torch"), ts, meta={"global_batch": 16}, groups=groups)
    mj, mt = jck.load_manifest(pj), checkpoint.load_manifest(pt)
    assert list(mt["leaves"]) == list(mj["leaves"])       # keys, in flatten order
    assert mt == mj                                        # shapes, dtypes, CRCs
    assert len(mt["leaves"]) == 2 * len(groups) + 3   # params and momentum a group
    assert any(k.startswith("params::blocks::0::") for k in mt["leaves"])
    if arch == "mamba2-2.7b":   # the reference keeps the case of a leaf's name
        assert {"params::blocks::0::mixer::A_log", "params::blocks::0::mixer::D",
                "opt::momentum::blocks::0::mixer::A_log"} <= set(mt["leaves"])
    assert open(pt, "rb").read() == open(pj, "rb").read()


@pytest.mark.parametrize("arch", ARCHS)
def test_a_jax_transformer_checkpoint_restores_in_the_port(arch, tmp_path):
    js, ts, groups = _pair(arch)
    path = jck.save(str(tmp_path), js)
    like = _pair(arch, seed=1, step=0)[1]
    _assert_states_equal(checkpoint.restore(path, like, groups=groups), ts)
    assert checkpoint.latest_valid(str(tmp_path), like=like, groups=groups) == path
    # without its groups the port looks for per-layer leaves the file lacks
    with pytest.raises(checkpoint.CheckpointCorruptError, match="absent"):
        checkpoint.restore(path, like)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_port_transformer_checkpoint_restores_in_jax(arch, tmp_path):
    js, ts, groups = _pair(arch)
    path = checkpoint.save(str(tmp_path), ts, groups=groups)
    like = _pair(arch, seed=1, step=0)[0]
    got = jck.restore(path, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got.step) == 5 and float(got.loss_scale) == 8.0 and int(got.good_steps) == 3


def test_the_async_writer_writes_the_stacked_format(tmp_path):
    _, ts, groups = _pair("recurrentgemma-9b")
    sync = checkpoint.save(str(tmp_path / "sync"), ts, groups=groups)
    writer = checkpoint.AsyncCheckpointWriter()
    path = writer.save(str(tmp_path / "async"), ts, groups=groups)
    writer.close()
    assert not writer.errors
    assert open(path, "rb").read() == open(sync, "rb").read()


def test_a_stacked_leaf_of_the_wrong_depth_is_rejected(tmp_path):
    _, ts, groups = _pair("qwen3-1.7b")
    path = checkpoint.save(str(tmp_path), ts, groups=groups)
    shallow = dict(ts.params)
    last = max(int(n.split(".")[1]) for n in shallow if n.startswith("layers."))
    shallow = {n: t for n, t in shallow.items() if not n.startswith(f"layers.{last}.")}
    like = TrainState(shallow, {"momentum": dict(shallow)}, 0, ts.loss_scale, ts.good_steps)
    groups = convert.leaf_groups(shallow, tregistry.get_smoke("qwen3-1.7b"))
    with pytest.raises(checkpoint.CheckpointCorruptError, match="shape"):
        checkpoint.restore(path, like, groups=groups)


def test_the_resnet_format_is_unchanged_by_groups_of_one(tmp_path):
    """The ResNet's groups (``leaf_groups`` without a config: one leaf each,
    none stacked) write the bytes that ``groups=None`` writes, which the
    JAX package writes too (``test_torch_checkpoint.py``)."""
    tree = jax.tree.map(np.asarray, jresnet.init(jax.random.key(0),
                                                 jresnet.ResNetConfig.tiny(num_classes=4)))
    params = convert.params_from_jax(tree, device="cpu")
    ts = TrainState.create(params)
    ts.opt_state["momentum"] = {k: v / 3 for k, v in params.items()}
    groups = convert.leaf_groups(params)
    assert all(len(names) == 1 and not convert.is_stacked(path) for path, names in groups)
    a = checkpoint.save(str(tmp_path / "none"), ts)
    b = checkpoint.save(str(tmp_path / "ones"), ts, groups=groups)
    assert open(a, "rb").read() == open(b, "rb").read()
    _assert_states_equal(checkpoint.restore(b, ts, groups=groups), checkpoint.restore(a, ts))


# ------------------------------------- the trainer resumes a JAX-written run --

ARCH, B_STAGE, SEQ = "qwen3-1.7b", (1, 2), 16
# two stages of 4 steps over 64 sequences, batches of 1 then 2 at one rank
STAGES, DATASET = ((0.0, 4 / 64, B_STAGE[0]), (4 / 64, 4 / 64 + 8 / 64, B_STAGE[1])), 64


def _jax_run(ckpt_dir: str):
    """The JAX trainer over both stages on one device, fp32 compute and
    comm, checkpoints at the stage boundaries: (metric rows, final params
    in the port's names)."""
    cfg = dataclasses.replace(jregistry.get_smoke(ARCH), compute_dtype=jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dy", "dx"))

    def loss_fn(p, batch, dp_axes):
        tokens, labels = batch
        logits, aux = jT.forward(p, tokens, cfg)
        return jlosses.label_smoothing_xent(logits, labels, 0.1), aux

    plan = jbuild_plan(JSchedule(tuple(JStage(*s) for s in STAGES)), dataset_size=DATASET,
                       n_workers=1)
    trainer = jtrainer.Trainer(
        mesh=mesh, dp_axes=("dy", "dx"), loss_fn=loss_fn,
        cfg=jtrainer.TrainerConfig(schedule="B", label_smoothing=0.1, log_every=1,
                                   grad_sync=JSync(strategy="torus2d", fuse=False,
                                                   comm_dtype=jnp.float32)),
        plan=plan, checkpoint_dir=ckpt_dir,
        data_fn=lambda i, gb: tuple(jnp.asarray(a) for a in lm_batch(i, gb, SEQ, cfg.vocab)))
    state, history = trainer.run(JState.create(_jax_params(ARCH, 0)), log=lambda *a: None)
    tcfg = tregistry.get_smoke(ARCH)
    final = convert.transformer_from_jax(jax.tree.map(np.asarray, state.params), tcfg,
                                         device="cpu")
    return [h for h in history if h["kind"] == "metric"], final


def test_the_trainer_resumes_an_lm_run_from_a_jax_checkpoint(tmp_path):
    want_rows, want = _jax_run(str(tmp_path / "jax"))
    assert [r["global_batch"] for r in want_rows] == [1, 1, 1, 1, 2, 2, 2, 2]
    first = os.path.join(str(tmp_path / "jax"), "step_00000004")
    assert os.path.exists(first + ".npz")
    resume_dir = tmp_path / "port"
    resume_dir.mkdir()
    for suffix in (".npz", checkpoint.MANIFEST_SUFFIX):
        shutil.copy(first + suffix, resume_dir)

    cfg = dataclasses.replace(tregistry.get_smoke(ARCH), compute_dtype=torch.float32)
    # the port starts from other weights: everything it ends with comes
    # from the JAX checkpoint and the last stage's steps
    start = convert.transformer_from_jax(_jax_params(ARCH, 1), cfg, device="cpu")
    groups = convert.leaf_groups(start, cfg)
    plan = build_plan(BatchSchedule(tuple(BatchStage(*s) for s in STAGES)),
                      dataset_size=DATASET, n_workers=1)
    trainer = Trainer(loss_fn_for(cfg, 0.1),
                      TrainerConfig(schedule="B", log_every=1,
                                    grad_sync=GradSyncConfig(strategy="torus2d", fuse=False,
                                                             comm_dtype=torch.float32)),
                      plan, lambda i, gb: tuple(torch.from_numpy(a).long()
                                                for a in lm_batch(i, gb, SEQ, cfg.vocab)),
                      checkpoint_dir=str(resume_dir), leaf_groups=groups)
    state, history = trainer.run(TrainState.create(start), log=lambda s: None, resume=True)
    resumed = [h for h in history if h.get("event") == "resume"]
    assert resumed and resumed[0]["step"] == 4
    rows = [h for h in history if h["kind"] == "metric"]
    assert [h["step"] for h in rows] == [h["step"] for h in want_rows[4:]]
    assert all(h["skipped"] == 0 for h in rows)
    np.testing.assert_allclose([h["loss"] for h in rows], [h["loss"] for h in want_rows[4:]],
                               rtol=1e-5)
    assert state.step == 8
    for name, w in want.items():
        np.testing.assert_allclose(state.params[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    # its own checkpoint at the end is in the same format: the JAX package reads it
    last = checkpoint.latest(str(resume_dir))
    assert last.endswith("step_00000008.npz")
    got = jck.restore(last, JState.create(_jax_params(ARCH, 1)))
    got_params = convert.transformer_from_jax(jax.tree.map(np.asarray, got.params),
                                              tregistry.get_smoke(ARCH), device="cpu")
    for name, t in state.params.items():
        assert torch.equal(got_params[name], t), name
