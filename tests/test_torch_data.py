"""The port's synthetic data and augmentation.

``torch.Generator`` and ``jax.random`` give different numbers from one
seed, so the generators are held to shape, dtype, determinism in
(seed, index) and class structure, and the geometric augmentation is held
to the JAX package's with the same random draws fed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import augment as jaug
from repro_torch.data import augment as taug
from repro_torch.data.synthetic import SyntheticImageNet, generator


def test_affine_resample_matches_jax():
    rng = np.random.RandomState(0)
    images = rng.randn(3, 12, 10, 3).astype(np.float32)
    mats = np.stack([[[0.9, -0.2, 1.5], [0.3, 1.1, -0.7]],
                     [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                     [[0.7, 0.4, 4.2], [-0.4, 0.7, 2.9]]]).astype(np.float32)
    want = jaug._affine_resample(jnp.asarray(images), jnp.asarray(mats), (8, 9))
    got = taug.affine_resample(torch.from_numpy(images), torch.from_numpy(mats), (8, 9))
    # bilinear weights in fp32 on both sides
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_random_affine_matches_jax_given_its_draws():
    """Re-derive the JAX op's draws and feed them to the port's matrices."""
    images = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    key = jax.random.key(4)
    want = jaug.random_affine(key, jnp.asarray(images))
    k1, k2, k3 = jax.random.split(key, 3)
    ang = jax.random.uniform(k1, (2,), minval=-15.0, maxval=15.0)
    sc = jax.random.uniform(k2, (2,), minval=0.7, maxval=1.3)
    shift = jax.random.uniform(k3, (2, 2), minval=-0.1, maxval=0.1) * jnp.asarray([16, 16])
    mats = taug.affine_matrices(*(torch.tensor(np.asarray(a)) for a in (ang, sc, shift)),
                                (16, 16), (16, 16))
    got = taug.affine_resample(torch.from_numpy(images), mats, (16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_synthetic_batches_are_deterministic_and_class_structured():
    data = SyntheticImageNet(num_classes=5, image_size=32, seed=3, noise=0.5,
                             device="cpu")
    x, y = data.batch(7, 16)
    assert x.shape == (16, 32, 32, 3) and x.dtype == torch.float32
    assert y.shape == (16,) and y.dtype == torch.int64
    assert int(y.min()) >= 0 and int(y.max()) < 5
    x2, y2 = SyntheticImageNet(num_classes=5, image_size=32, seed=3, noise=0.5,
                               device="cpu").batch(7, 16)
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(data.batch(8, 16)[0], x)
    # each image is nearest to its own class template
    tmpl = data.templates().repeat_interleave(8, 1).repeat_interleave(8, 2)
    dist = ((x[:, None] - tmpl[None]) ** 2).mean(dim=(2, 3, 4))
    assert torch.equal(dist.argmin(1), y)


def test_augment_is_deterministic_in_the_generator():
    images = torch.randn(4, 24, 24, 3)
    a = taug.augment(generator(torch.device("cpu"), 1, 5), images, (16, 16))
    b = taug.augment(generator(torch.device("cpu"), 1, 5), images, (16, 16))
    c = taug.augment(generator(torch.device("cpu"), 1, 6), images, (16, 16))
    assert a.shape == (4, 16, 16, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_photometric_ops_keep_shape_and_flip_mirrors():
    gen = generator(torch.device("cpu"), 0)
    images = torch.randn(64, 4, 5, 3)
    flipped = taug.random_flip(gen, images)
    same = (flipped == images).flatten(1).all(1)
    mirrored = (flipped == images.flip(2)).flatten(1).all(1)
    assert bool((same | mirrored).all()) and 0 < int(mirrored.sum()) < 64
    for op in (taug.random_brightness, taug.random_contrast, taug.random_noise):
        out = op(gen, images)
        assert out.shape == images.shape and torch.isfinite(out).all()
