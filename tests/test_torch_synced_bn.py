"""The port's synced BN (``nn/layers.py:batchnorm`` with a grid) against the
JAX package's ``dp_axes`` BN, on ResNet-tiny over 8 ranks.

The port runs on 8 gloo ranks (``tests/_pt_parity.py``); the reference
runs ``repro.models.resnet.apply(..., dp_axes=("dy", "dx"))`` under
``shard_map`` on a (2, 4) mesh of its 8 CPU devices and differentiates
inside it with ``jax.grad``. Both take the same fp32 weights (seed 3, BN
gammas drawn so that every layer shows) and the same per-rank images, and
differentiate sum(logits * w) with per-rank weights w. The cross-rank sum
carries the cotangents across ranks, so each rank's input gradient holds
the other ranks' terms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _pt_parity import launch, synced_bn_body
from repro.compat import shard_map
from repro.models import resnet as jresnet

pytestmark = pytest.mark.multidevice

AXES = ("dy", "dx")
PER_RANK = 2
# fp32 both sides: convolutions and the cross-rank sums add in other orders
RTOL, ATOL = 1e-4, 1e-4


def _inputs():
    cfg = jresnet.ResNetConfig.tiny(compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jresnet.init(jax.random.key(3), cfg))
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (rng.rand(*p.shape).astype(np.float32) + 0.5)
        if "bn_scale" in jax.tree_util.keystr(path) else p, params)
    images = np.random.RandomState(2).randn(8, PER_RANK, 32, 32, 3).astype(np.float32)
    weights = np.random.RandomState(5).randn(8, PER_RANK, cfg.num_classes).astype(np.float32)
    return cfg, params, images, weights


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    cfg, params, images, weights = _inputs()
    port = launch(synced_bn_body, tmp_path_factory.mktemp("bn"), (2, 4), params, images,
                  weights)
    mesh = jax.make_mesh((2, 4), AXES)
    spec = P(AXES)

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), spec, spec),
                       out_specs=(spec, spec, spec), check_vma=False)
    def f(p, x, w):
        def local(p, x):
            logits = jresnet.apply(p, x[0], cfg, dp_axes=AXES)
            return jnp.sum(logits * w[0]), logits

        (_, logits), (gp, gx) = jax.value_and_grad(local, argnums=(0, 1),
                                                   has_aux=True)(p, x)
        return logits[None], gx, jax.tree.map(lambda g: g[None], gp)

    ref = jax.tree.map(np.asarray, jax.jit(f)(params, images, weights))
    return port, ref


def test_synced_bn_logits_match_on_every_rank(both):
    port, (logits, _, _) = both
    for r in range(8):
        np.testing.assert_allclose(port[r]["logits"], logits[r], rtol=RTOL, atol=ATOL)
    # the moments are the grid's: rank 0's images with their own moments
    # give other logits
    cfg, params, images, _ = _inputs()
    alone = np.asarray(jresnet.apply(params, images[0], cfg))
    assert np.abs(alone - logits[0]).max() > 100 * ATOL


def test_synced_bn_input_gradients_match_on_every_rank(both):
    port, (_, dx, _) = both
    for r in range(8):
        np.testing.assert_allclose(port[r]["dx"], dx[r], rtol=RTOL, atol=ATOL)


def test_synced_bn_param_gradients_match_on_every_rank(both):
    port, (_, _, grads) = both
    for r in range(8):
        jax.tree.map(lambda a, b, r=r: np.testing.assert_allclose(
            a, b[r], rtol=RTOL, atol=ATOL), port[r]["grads"], grads)
