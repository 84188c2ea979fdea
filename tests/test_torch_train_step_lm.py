"""One training step of each of the ten smoke archs: the port's
``make_train_step`` at world 1 against the JAX package's train step on a
(1, 1) ("dy", "dx") mesh.

Both start from the same weights (``repro.models.transformer.init``, norm
scales given random values so that every norm shows, carried across by
``convert.transformer_from_jax``) and take the same numpy batch (tokens,
labels and, for the VLM, an fp32 vision input), in fp32 compute with fp32
comm (at one rank the sync is then the identity on both sides), LARS,
label smoothing 0.1, schedule B and the MoE aux weight, with ``remat`` off
and on (on both sides: ``jax.checkpoint`` there, ``torch.utils.checkpoint``
here, around each prefix layer and pattern block). The port's loss is
the launcher's (``repro_torch.launch.train.loss_fn_for``) and its LARS and
sync take the reference's stacked leaves (``convert.leaf_groups``); this
holds the groups on every layout of the zoo (the MoE archs' ``first_dense``
prefix, recurrentgemma's 3-kind pattern, the VLM's cross layers).

Tolerances: the loss rtol 1e-5 (the same fp32 math summed in other
orders); every parameter rtol 1e-4, atol 1e-6 (LARS multiplies the
gradients' fp32 noise by lr * trust, and a weight near 0 keeps the
absolute part).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jregistry
from repro.core import losses as jlosses
from repro.core.grad_sync import GradSyncConfig as JSync
from repro.models import transformer as jT
from repro.train import trainer as jtrainer
from repro.train.state import TrainState as JState
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.core.grad_sync import GradSyncConfig as TSync
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tT
from repro_torch.train import trainer as ttrainer
from repro_torch.train.state import TrainState as TState

ARCHS = ("qwen3-1.7b", "gemma2-27b", "gemma-7b", "llama3-405b", "musicgen-medium",
         "granite-moe-3b-a800m", "kimi-k2-1t-a32b", "mamba2-2.7b", "recurrentgemma-9b",
         "llama-3.2-vision-90b")
B, S = 2, 24
EPOCH, GB = 0.05, 2


def _setup(arch, remat=False):
    jcfg = dataclasses.replace(jregistry.get_smoke(arch), compute_dtype=jnp.float32,
                               remat=remat)
    tcfg = dataclasses.replace(tregistry.get_smoke(arch), compute_dtype=torch.float32,
                               remat=remat)
    rng = np.random.RandomState(100)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(0.3 * rng.randn(*p.shape).astype(np.float32))
        if "norm_scale" in jax.tree_util.keystr(path) else p,
        jT.init(jax.random.key(0), jcfg))
    tp = convert.transformer_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.RandomState(7)
    batch = [rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32),
             rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)]
    if jcfg.vision_tokens:
        batch.append(rng.randn(B, jcfg.vision_tokens, jcfg.cross_kv_dim).astype(np.float32))
    return jcfg, tcfg, jp, tp, batch


@pytest.mark.parametrize("arch,remat", [pytest.param(a, r, id=a + ("-remat" if r else ""))
                                        for r in (False, True) for a in ARCHS])
def test_one_lm_train_step_matches_the_reference(arch, remat):
    jcfg, tcfg, jp, tp, batch = _setup(arch, remat)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dy", "dx"))

    def jloss(params, b, dp_axes):
        tokens, labels, *vision = b
        logits, aux = jT.forward(params, tokens, jcfg, vision=vision[0] if vision else None)
        return jlosses.label_smoothing_xent(logits, labels, 0.1), aux

    jcfg_t = jtrainer.TrainerConfig(
        schedule="B", label_smoothing=0.1,
        grad_sync=JSync(strategy="torus2d", fuse=False, comm_dtype=jnp.float32))
    jstep = jtrainer.make_train_step(jloss, mesh, ("dy", "dx"), jcfg_t, donate=False)
    jstate, jm = jstep(JState.create(jp), tuple(jnp.asarray(a) for a in batch),
                       jnp.asarray(EPOCH, jnp.float32), jnp.asarray(GB, jnp.float32))

    groups = convert.leaf_groups(tp, tcfg)
    tcfg_t = ttrainer.TrainerConfig(
        schedule="B", grad_sync=TSync(strategy="torus2d", fuse=False,
                                      comm_dtype=torch.float32))
    tstep = ttrainer.make_train_step(launch_train.loss_fn_for(tcfg, 0.1), tcfg_t,
                                     groups=groups)
    tbatch = tuple(torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
                   for a in batch)
    tstate, tm = tstep(TState.create(tp), tbatch, EPOCH, GB)

    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5, atol=1e-7)
    assert int(tm["skipped"]) == int(jm["skipped"]) == 0
    want = convert.transformer_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                                        device="cpu")
    assert set(want) == set(tstate.params)
    for name, w in want.items():
        np.testing.assert_allclose(tstate.params[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{arch} {name}")
    # the step moved the weights: the comparison is not of two copies of the start
    assert any(not torch.equal(tstate.params[n], tp[n]) for n in tp)


def test_params_tree_is_the_model_tree():
    _, tcfg, _, tp, _ = _setup("llama-3.2-vision-90b")
    model = tT.init(tcfg, seed=0, device="cpu")
    model.load_state_dict(tp)
    flat = dict(model.named_parameters())
    got, want = tT.params_tree(flat), model.tree()
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    assert all(a is b for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


def _grads(tcfg, tp, batch):
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tbatch = tuple(torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)
                   for a in batch)
    loss, aux = launch_train.loss_fn_for(tcfg, 0.1)(params, tbatch, None)
    names = list(params)
    return loss, aux, dict(zip(names, torch.autograd.grad(loss + 0.01 * aux,
                                                          [params[n] for n in names])))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_keeps_the_gradients(arch):
    """The port alone: the loss, the aux loss and every gradient with
    ``remat`` on equal those with it off, to 1e-6 (the recompute runs the
    same fp32 ops on the same inputs; MoE dispatch included)."""
    _, tcfg, _, tp, batch = _setup(arch)
    base = _grads(tcfg, tp, batch)
    rem = _grads(dataclasses.replace(tcfg, remat=True), tp, batch)
    for a, b in zip(rem[:2], base[:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for name, g in base[2].items():
        torch.testing.assert_close(rem[2][name], g, rtol=0, atol=1e-6, msg=f"{arch} {name}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m", "recurrentgemma-9b"])
def test_remat_checkpoints_each_prefix_layer_and_block(arch, monkeypatch):
    """``checkpoint`` wraps ``n_prefix + n_blocks`` units, which together
    cover every layer once in order; with ``remat`` off it is not called."""
    _, tcfg, _, tp, batch = _setup(arch)
    calls = []
    real = tT.ckpt.checkpoint

    def counting(fn, layers, kinds, *args, **kw):
        calls.append(tuple(kinds))
        return real(fn, layers, kinds, *args, **kw)

    monkeypatch.setattr(tT.ckpt, "checkpoint", counting)
    _grads(tcfg, tp, batch)
    assert calls == []
    rcfg = dataclasses.replace(tcfg, remat=True)
    _grads(rcfg, tp, batch)
    assert len(calls) == rcfg.n_prefix + rcfg.n_blocks
    assert [k for unit in calls for k in unit] == list(rcfg.kinds())
    assert all(len(u) == 1 for u in calls[:rcfg.n_prefix])
    assert all(u == rcfg.pattern for u in calls[rcfg.n_prefix:])
