"""The port's ResNet against the JAX package's, from the same weights.

Weights are made by ``repro.models.resnet.init`` and carried across with
``repro_torch.convert.params_from_jax``; images come from numpy with a fixed
seed. Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import losses as jlosses
from repro.models import resnet as jresnet
from repro.nn import layers as jL
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core import losses as tlosses
from repro_torch.models import resnet as tresnet
from repro_torch.nn import layers as tL


def _pair(seed=0, jdtype=jnp.float32, tdtype=torch.float32):
    """(JAX params, JAX config, port model loaded with the same weights)."""
    jcfg = jresnet.ResNetConfig.tiny(compute_dtype=jdtype)
    tcfg = tresnet.ResNetConfig.tiny(compute_dtype=tdtype)
    jparams = jresnet.init(jax.random.key(seed), jcfg)
    model = tresnet.init(tcfg, seed=seed, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu"))
    return jparams, jcfg, model


def _images(seed, n=4, size=32):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


def _nonzero_gamma(jparams, seed=9):
    """bn3 gammas are zero at init, which hides the residual branch; give
    them values so the comparisons see every layer."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, p: jnp.asarray(rng.rand(*p.shape).astype(np.float32) + 0.5)
        if "bn_scale" in jax.tree_util.keystr(path) else p, jparams)


# ---------------------------------------------------------------- layers --

@pytest.mark.parametrize("size,k,stride", [(16, 3, 2), (16, 7, 2), (15, 3, 2),
                                           (16, 3, 1), (16, 1, 2)])
def test_conv_same_padding_matches_xla(size, k, stride):
    """XLA "SAME" pads the extra row/col at the bottom/right at stride 2."""
    rng = np.random.RandomState(size * k + stride)
    x = rng.randn(2, size, size, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 5).astype(np.float32)
    want = jL.conv({"kernel": jnp.asarray(w)}, jnp.asarray(x), stride)
    got = tL.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)   # fp32 conv, sum order


@pytest.mark.parametrize("size", [16, 15, 112])
def test_max_pool_same_padding_matches_xla(size):
    x = np.random.RandomState(size).randn(2, size, size, 4).astype(np.float32)
    want = jL.max_pool(jnp.asarray(x), 3, 2)
    got = tL.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_same_pads_of_the_resnet50_strides():
    assert tL.same_pads(224, 7, 2) == (2, 3)      # stem conv
    assert tL.same_pads(56, 3, 2) == (0, 1)       # v1.5 conv2 at stride 2
    assert tL.same_pads(112, 3, 2) == (0, 1)      # max pool
    assert tL.same_pads(56, 1, 2) == (0, 0)       # projection
    assert tL.same_pads(56, 3, 1) == (1, 1)


def test_batchnorm_rounds_affine_to_bf16_like_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 5, 6).astype(np.float32)
    scale = (rng.rand(6) + 0.5).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    p = {"bn_scale": jnp.asarray(scale, jnp.bfloat16),
         "bn_bias": jnp.asarray(bias, jnp.bfloat16)}
    want, (jm, jv) = jL.batchnorm(p, jnp.asarray(x, jnp.bfloat16), return_stats=True)
    got, (tm, tv) = tL.batchnorm(
        torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
        torch.from_numpy(scale).to(torch.bfloat16),
        torch.from_numpy(bias).to(torch.bfloat16), return_stats=True)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    # fp32 math on identical bf16 inputs, one rounding to bf16 at the end
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7, atol=1e-2)


# ----------------------------------------------------------------- model --

def test_tiny_fp32_logits_match():
    jparams, jcfg, model = _pair(0)
    jparams = _nonzero_gamma(jparams)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    x = _images(1)
    want = jresnet.apply(jparams, jnp.asarray(x), jcfg)
    got = model(torch.from_numpy(x))
    assert got.shape == (4, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)   # fp32, conv sum order


def test_tiny_fp32_param_grads_match():
    # A pre-activation within fp32 rounding of 0 lands on either side of the
    # ReLU kink in the two frameworks and moves that element's gradient by
    # its full size (seed 2 has one at 4.6e-6); these seeds have none.
    jparams, jcfg, model = _pair(3)
    jparams = _nonzero_gamma(jparams, seed=4)
    x = _images(3)
    y = np.random.RandomState(3).randint(0, 10, (4,))

    def jloss(p):
        return jlosses.label_smoothing_xent(jresnet.apply(p, jnp.asarray(x), jcfg),
                                            jnp.asarray(y), 0.1)

    want = jax.grad(jloss)(jparams)
    params = {k: v.detach().requires_grad_(True)
              for k, v in params_from_jax(jax.tree.map(np.asarray, jparams),
                                          device="cpu").items()}
    logits = tresnet.apply(model, torch.from_numpy(x), params=params)
    tlosses.label_smoothing_xent(logits, torch.from_numpy(y), 0.1).backward()
    got = params_to_jax({k: p.grad for k, p in params.items()})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                         rtol=1e-4, atol=1e-4),
                 got, want)


def test_tiny_bf16_logits_match_loosely():
    jparams, jcfg, model = _pair(4, jnp.bfloat16, torch.bfloat16)
    jparams = _nonzero_gamma(jparams, seed=5)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    x = _images(3)
    want = np.asarray(jresnet.apply(jparams, jnp.asarray(x), jcfg))
    got = model(torch.from_numpy(x)).detach().numpy()
    # bf16 activations: each layer rounds to 8 bits of mantissa, and the
    # two frameworks round at different points inside convs and sums
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)


def test_collect_stats_match_and_reuse():
    jparams, jcfg, model = _pair(6)
    x = _images(7, n=6)
    jlogits, jstats = jresnet.apply(jparams, jnp.asarray(x), jcfg, collect_stats=True)
    tlogits, tstats = model(torch.from_numpy(x), collect_stats=True)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    as_np = jax.tree.map(lambda t: t.detach().numpy(), tstats)
    assert jax.tree.structure(as_np) == jax.tree.structure(jstats)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                         rtol=1e-4, atol=1e-5),
                 as_np, jstats)
    # the same batch with its own statistics reproduces the train-mode output
    eval_logits = model(torch.from_numpy(x), stats=tstats)
    np.testing.assert_allclose(eval_logits.detach().numpy(), tlogits.detach().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_resnet50_names_shapes_and_count_match_jax():
    jshapes = jax.eval_shape(lambda: jresnet.init(jax.random.key(0),
                                                  jresnet.ResNetConfig.resnet50()))
    jleaves = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
               tuple(s.shape)
               for path, s in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    with torch.device("meta"):     # shapes only, no weights drawn
        net = tresnet.ResNet(tresnet.ResNetConfig.resnet50(),
                             torch.Generator(device="cpu"))
    tleaves = {n.replace(".", "/"): tuple(p.shape) for n, p in net.named_parameters()}
    assert set(tleaves) == set(jleaves)
    for name, shape in jleaves.items():
        want = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape
        assert tleaves[name] == want, name
    assert tresnet.num_params(net) == sum(int(np.prod(s)) for s in jleaves.values())
    assert 25.0e6 < tresnet.num_params(net) < 26.2e6


def test_convert_round_trip_and_zero_gamma():
    jparams = jax.tree.map(np.asarray, jresnet.init(jax.random.key(1),
                                                    jresnet.ResNetConfig.tiny()))
    back = params_to_jax(params_from_jax(jparams, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
    model = tresnet.init(tresnet.ResNetConfig.tiny(), seed=0, device="cpu")
    for stage in model.stages:
        for block in stage:
            assert float(block.bn3.bn_scale.detach().abs().sum()) == 0.0
