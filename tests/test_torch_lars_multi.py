"""The port's multi-tensor LARS step: one call over every leaf of a model.

On the CPU, ``core/lars.update`` goes through the list-of-leaves plain
version (``kernels/ref.py::lars_update_leaves_ref``) and is held against the
JAX package's ``repro.core.lars.update`` over a ResNet-tiny tree. The plan
that cuts the leaves into launches and blocks (``kernels/lars_update.py``)
is plain Python and is checked here at ResNet-50's real leaf shapes. The
kernels themselves are held against the plain version in
tests/test_torch_cuda.py, on a card.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import lars as jlars
from repro.models import resnet as jresnet
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import lars as tlars
from repro_torch.kernels import lars_update as klars
from repro_torch.kernels import ops, ref
from repro_torch.models import resnet

LARS_KW = dict(lr=0.5, mom=0.9, eta=0.01, weight_decay=5e-5, eps=1e-6)


@pytest.fixture(scope="module")
def tiny_tree():
    """ResNet-tiny params, grads and momentum as numpy trees (fixed seeds)."""
    params = jax.tree.map(np.asarray, jresnet.init(jax.random.key(1),
                                                   jresnet.ResNetConfig.tiny()))
    rng = np.random.RandomState(13)
    grads = jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.05).astype(np.float32), params)
    moms = jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.01).astype(np.float32), params)
    return params, grads, moms


@pytest.fixture(scope="module")
def resnet50_numels():
    model = resnet.init(resnet.ResNetConfig.resnet50(num_classes=1000, image_size=224),
                        seed=0, device="cpu")
    return [p.numel() for _, p in model.named_parameters()]


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("steps", [1, 10])
def test_update_over_all_leaves_matches_jax(tiny_tree, nesterov, steps):
    params, grads, moms = tiny_tree
    jcfg = jlars.LARSConfig(use_kernel=False, nesterov=nesterov)
    tcfg = tlars.LARSConfig(nesterov=nesterov)
    jp, jo = params, {"momentum": moms}
    tp = params_from_jax(params, device="cpu")
    to = {"momentum": params_from_jax(moms, device="cpu")}
    tg = params_from_jax(grads, device="cpu")
    ops.reset_launch_counts()
    for _ in range(steps):
        jp, jo = jlars.update(jp, grads, jo, lr=0.5, momentum=0.9, cfg=jcfg)
        tp, to = tlars.update(tp, tg, to, lr=0.5, momentum=0.9, cfg=tcfg)
    assert ops.launch_counts()["lars_update"] == 0     # CPU: the plain version
    for got, want in ((tp, jp), (to["momentum"], jo["momentum"])):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                             rtol=1e-6, atol=1e-6),
                     params_to_jax(got), want)


def test_leaves_plain_version_is_lars_and_momentum_sgd_per_leaf():
    rng = np.random.RandomState(4)
    shapes = [(7,), (64, 3), (5, 5, 2, 2), (1,)]
    ps, gs, vs = ([torch.from_numpy((rng.randn(*s) * k).astype(np.float32)) for s in shapes]
                  for k in (1.0, 0.1, 0.01))
    lars = [True, False, True, False]
    got_p, got_v = ops.lars_update_leaves(ps, gs, vs, lars, **LARS_KW, nesterov=True)
    for p, g, v, is_lars, gp, gv in zip(ps, gs, vs, lars, got_p, got_v):
        if is_lars:
            wp, wv = ref.lars_update_ref(p, g, v, **LARS_KW, nesterov=True)
        else:   # trust 1, no weight decay
            wv = 0.9 * v + 0.5 * g
            wp = p - (0.9 * wv + (wv - 0.9 * v))
        torch.testing.assert_close(gp, wp, rtol=0, atol=0)
        torch.testing.assert_close(gv, wv, rtol=0, atol=0)


def _coverage(numels, launches, chunk):
    seen = [np.zeros(n, dtype=np.int64) for n in numels]
    order = []
    for launch in launches:
        for leaf, start, end in klars.block_ranges(launch, numels, chunk):
            assert 0 <= start < end <= numels[leaf] and end - start <= chunk
            seen[leaf][start:end] += 1
            order.append((leaf, start))
    return seen, order


@pytest.mark.parametrize("max_leaves,chunk", [(klars.MAX_LEAVES, klars.CHUNK),
                                              (40, klars.CHUNK), (7, 4096)])
def test_leaf_plan_covers_every_element_once_at_resnet50_shapes(resnet50_numels,
                                                                max_leaves, chunk):
    numels = resnet50_numels
    launches = klars.leaf_plan(numels, max_leaves=max_leaves, chunk=chunk)
    seen, order = _coverage(numels, launches, chunk)
    assert all(bool((s == 1).all()) for s in seen)
    # a fixed order: leaf by leaf, chunk by chunk, and the same plan again
    assert order == sorted(order)
    assert launches == klars.leaf_plan(numels, max_leaves=max_leaves, chunk=chunk)
    # the leaves sit one after another in the flat outputs, each on a
    # 16-byte boundary
    offsets = [o for launch in launches for o in launch.offsets]
    assert offsets == list(np.cumsum([0] + [-(-n // 4) * 4 for n in numels[:-1]]))
    assert all(len(launch.offsets) <= max_leaves for launch in launches)
    assert len(launches) == -(-len(numels) // max_leaves)


def test_resnet50_is_one_launch_pair(resnet50_numels):
    """ResNet-50's 161 leaves fit one table, so a step is two launches."""
    launches = klars.leaf_plan(resnet50_numels)
    assert len(resnet50_numels) == 161 and len(launches) == 1
    blocks = launches[0].blocks
    assert blocks == sum(-(-n // klars.CHUNK) for n in resnet50_numels)


def test_leaf_plan_starts_each_leaf_on_a_16_byte_boundary():
    """fp32 leaves of any size start at multiples of 4 elements in the flat
    outputs, as a leaf of its own allocation would: the BN kernels load a
    scale and bias that LARS wrote with 16-byte loads."""
    (launch,) = klars.leaf_plan([7, 1, 10, 3, 4, 5])
    assert launch.offsets == (0, 8, 12, 24, 28, 32)


def test_leaf_plan_refuses_empty_and_huge_leaves():
    for bad in ([0], [2**31]):
        with pytest.raises(ValueError):
            klars.leaf_plan(bad)


def test_wrapper_refuses_cpu_leaves_and_ragged_lists():
    t = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        klars.lars_update_cuda([t], [t], [t], [True], **LARS_KW)
    with pytest.raises(ValueError, match="length"):
        klars.lars_update_cuda([t, t], [t], [t], [True], **LARS_KW)
