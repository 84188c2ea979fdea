"""The port's recipe math against the JAX package: schedules, batch-size
plans, losses and the LARS / SGD optimizers over a ResNet-tiny param tree.

Inputs come from numpy with a fixed seed and go to both packages.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_control as jbc
from repro.core import lars as jlars
from repro.core import losses as jlosses
from repro.core import schedules as jsched
from repro.models import resnet as jresnet
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import batch_control as tbc
from repro_torch.core import lars as tlars
from repro_torch.core import losses as tlosses
from repro_torch.core import schedules as tsched

EPOCHS = [0.0, 0.5, 1.0, 4.99, 5.0, 10.0, 29.9, 30.0, 33.9, 34.0, 45.0, 89.0, 90.0, 95.0]
BATCHES = [256, 8192, 32768, 65536, 131072]


# --------------------------------------------------------------- schedules --

@pytest.mark.parametrize("name", ["A", "B"])
def test_schedule_lr_and_momentum_match(name):
    js, ts = jsched.make(name), tsched.make(name)
    for e, b in itertools.product(EPOCHS, BATCHES):
        # JAX evaluates in fp32, the port in Python floats: 1e-6 relative
        np.testing.assert_allclose(ts.lr(e), float(js.lr(e)), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ts.mom(e, b), float(js.mom(e, b)),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("exp", ["reference", "exp1", "exp2", "exp3", "exp4"])
def test_paper_schedules_identical(exp):
    j, t = jsched.paper_schedule(exp), tsched.paper_schedule(exp)
    assert [dataclass_tuple(s) for s in t.stages] == [dataclass_tuple(s) for s in j.stages]
    assert t.total_epochs == j.total_epochs
    for e in EPOCHS:
        assert dataclass_tuple(t.stage_at(e)) == dataclass_tuple(j.stage_at(e))


def dataclass_tuple(s):
    return (s.start_epoch, s.end_epoch, s.per_worker_batch)


def test_noncontiguous_stages_raise_in_both():
    for mod in (jsched, tsched):
        with pytest.raises(ValueError):
            mod.BatchSchedule((mod.BatchStage(0, 1, 8), mod.BatchStage(2, 3, 8)))


@pytest.mark.parametrize("exp,dataset_size,n_workers,max_steps", [
    ("exp1", 1281167, 2176, None), ("exp4", 1281167, 4096, 500),
    ("reference", 4096, 8, 7), ("exp3", 100, 1, None)])
def test_build_plan_and_epoch_of_identical(exp, dataset_size, n_workers, max_steps):
    jp = jbc.build_plan(jsched.paper_schedule(exp), dataset_size=dataset_size,
                        n_workers=n_workers, max_steps=max_steps)
    tp = tbc.build_plan(tsched.paper_schedule(exp), dataset_size=dataset_size,
                        n_workers=n_workers, max_steps=max_steps)
    assert tp.total_steps == jp.total_steps
    assert len(tp.stages) == len(jp.stages)
    for js, ts in zip(jp.stages, tp.stages):
        assert (ts.global_batch, ts.num_steps, ts.first_step, ts.start_epoch) == \
            (js.global_batch, js.num_steps, js.first_step, js.start_epoch)
        for i in {0, 1, js.num_steps // 2, max(js.num_steps - 1, 0)}:
            assert tbc.epoch_of(tp, ts, i) == jbc.epoch_of(jp, js, i)


# ------------------------------------------------------------------ losses --

def _logits_labels(seed, shape=(6, 12)):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*shape) * 3).astype(np.float32),
            rng.randint(0, shape[-1], shape[:-1]))


@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.3])
def test_label_smoothing_xent_matches(smoothing):
    x, y = _logits_labels(1)
    want = jlosses.label_smoothing_xent(jnp.asarray(x), jnp.asarray(y), smoothing)
    got = tlosses.label_smoothing_xent(torch.from_numpy(x), torch.from_numpy(y),
                                       smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_label_smoothing_xent_where_mask_matches():
    x, y = _logits_labels(2, (3, 5, 20))
    mask = np.random.RandomState(2).rand(3, 5) > 0.4
    want = jlosses.label_smoothing_xent(jnp.asarray(x), jnp.asarray(y), 0.1,
                                        where=jnp.asarray(mask))
    got = tlosses.label_smoothing_xent(torch.from_numpy(x), torch.from_numpy(y), 0.1,
                                       where=torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    empty = np.zeros_like(mask)     # an all-padding batch gives 0, not NaN
    got = tlosses.label_smoothing_xent(torch.from_numpy(x), torch.from_numpy(y), 0.1,
                                       where=torch.from_numpy(empty))
    assert got.item() == 0.0


def test_softmax_xent_top1_and_ls_xent_ref_match():
    x, y = _logits_labels(3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tlosses.softmax_xent(tx, ty).item(),
                               float(jlosses.softmax_xent(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6)
    np.testing.assert_allclose(tlosses.top1_accuracy(tx, ty).item(),
                               float(jlosses.top1_accuracy(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_allclose(tlosses.ls_xent_ref(tx, ty, 0.1).numpy(),
                               np.asarray(jlosses.ls_xent_ref(jnp.asarray(x),
                                                              jnp.asarray(y), 0.1)),
                               rtol=1e-5, atol=1e-6)


def test_label_smoothing_xent_grad_matches():
    x, y = _logits_labels(4, (8, 30))
    want = jax.grad(lambda l: jlosses.label_smoothing_xent(l, jnp.asarray(y), 0.1))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tlosses.label_smoothing_xent(tx, torch.from_numpy(y), 0.1).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# -------------------------------------------------------------- optimizers --

@pytest.fixture(scope="module")
def tiny_tree():
    """ResNet-tiny params, grads and momentum as numpy trees (fixed seeds)."""
    params = jax.tree.map(np.asarray, jresnet.init(jax.random.key(0),
                                                   jresnet.ResNetConfig.tiny()))
    rng = np.random.RandomState(7)
    grads = jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.05).astype(np.float32), params)
    moms = jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.01).astype(np.float32), params)
    return params, grads, moms


def test_skip_tags_select_the_same_leaves(tiny_tree):
    params = tiny_tree[0]
    cfg = jlars.LARSConfig()
    jskip = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
             if jlars._is_skip(path, cfg)}
    tskip = {tlars.path_str(n) for n in params_from_jax(params, device="cpu")
             if tlars.is_skip(n, tlars.LARSConfig())}
    assert tskip == jskip and len(tskip) > 0


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_lars_update_tree_matches(tiny_tree, nesterov, steps):
    params, grads, moms = tiny_tree
    jcfg = jlars.LARSConfig(use_kernel=False, nesterov=nesterov)
    tcfg = tlars.LARSConfig(nesterov=nesterov)
    jp, jo = params, {"momentum": moms}
    tp = params_from_jax(params, device="cpu")
    to = {"momentum": params_from_jax(moms, device="cpu")}
    tg = params_from_jax(grads, device="cpu")
    for i in range(steps):
        lr, mom = 0.5 * (i + 1), 0.9
        jp, jo = jlars.update(jp, grads, jo, lr=lr, momentum=mom, cfg=jcfg)
        tp, to = tlars.update(tp, tg, to, lr=lr, momentum=mom, cfg=tcfg)
    for got, want in ((tp, jp), (to["momentum"], jo["momentum"])):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                             rtol=1e-6, atol=1e-6),
                     params_to_jax(got), want)


def test_lars_init_and_sgd_update_match(tiny_tree):
    params, grads, _ = tiny_tree
    tp = params_from_jax(params, device="cpu")
    to = tlars.sgd_init(tp)
    assert all(float(v.abs().sum()) == 0.0 for v in to["momentum"].values())
    jp, jo = params, jlars.sgd_init(params)
    tg = params_from_jax(grads, device="cpu")
    for _ in range(2):
        jp, jo = jlars.sgd_update(jp, grads, jo, lr=0.1, momentum=0.9, weight_decay=1e-4)
        tp, to = tlars.sgd_update(tp, tg, to, lr=0.1, momentum=0.9, weight_decay=1e-4)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                         rtol=1e-6, atol=1e-6),
                 params_to_jax(tp), jp)
