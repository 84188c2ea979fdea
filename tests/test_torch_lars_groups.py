"""The reference's stacked leaves in the port: ``convert.leaf_groups``, LARS
over a group and the group-aware gradient sync's layout, against the JAX
package on its stacked trees.

With ``scan_blocks`` (every config's default) the JAX transformer stacks
each repeated layer's leaf over the layers; the port keeps a leaf a layer.
LARS takes one trust ratio a JAX leaf, and the sync plans one exchange a
JAX leaf, so the port groups its leaves as the reference stacks them. Both
sides get the same numpy params, gradients and momenta (the port's
unstacked by ``convert.transformer_from_jax``); fp32 on both, the norms
summed in other orders: rtol 1e-6, and atol 1e-8 where p' = p - step
cancels (an fp32 ulp of weights near 0.1 is 7.5e-9).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import grad_sync as jsync
from repro.core import lars as jlars
from repro.models import resnet as jresnet
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.core import grad_sync as tsync
from repro_torch.core import lars as tlars
from repro_torch.kernels import ref

ARCHS = ("qwen3-1.7b", "recurrentgemma-9b", "llama-3.2-vision-90b")
LR, MOM = 0.7, 0.9


def _trees(arch, seed=0, n_layers=None):
    """(JAX cfg, port cfg, JAX params, grads, momenta as numpy trees)."""
    jcfg = dataclasses.replace(jregistry.get_smoke(arch), compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(tregistry.get_smoke(arch), compute_dtype=torch.float32)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    params = jax.tree.map(np.asarray, jT.init(jax.random.key(seed), jcfg))
    rng = np.random.RandomState(seed + 1)

    def like(scale):
        return jax.tree.map(lambda p: (scale * rng.randn(*p.shape)).astype(np.float32),
                            params)
    return jcfg, tcfg, params, like(1e-2), like(1e-3)


def _port(tree, tcfg):
    return convert.transformer_from_jax(tree, tcfg, device="cpu")


def test_groups_are_the_reference_leaves_in_its_flatten_order():
    for arch in ARCHS:
        jcfg, tcfg, params, _, _ = _trees(arch)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        groups = convert.leaf_groups(_port(params, tcfg), tcfg)
        assert [p for p, _ in groups] == [jsync._path_str(k) for k, _ in flat], arch
        port = _port(params, tcfg)
        for (path, names), (_, leaf) in zip(groups, flat):
            stacked = np.stack([port[n].numpy() for n in names])
            want = leaf if convert.is_stacked(path) else leaf[None]
            np.testing.assert_array_equal(stacked, want, err_msg=path)


def test_full_qwen3_has_13_reference_leaves_over_310_port_leaves():
    jcfg, tcfg = jregistry.get("qwen3-1.7b"), tregistry.get("qwen3-1.7b")
    shapes = jax.eval_shape(lambda: jT.init(jax.random.key(0), jcfg))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    # the port's names, from the JAX tree's shapes, unstacked
    names = [f"layers.{i}.{jsync._path_str(k).split('/', 2)[2].replace('/', '.')}"
             for k, _ in flat if jsync._path_str(k).startswith("blocks/")
             for i in range(tcfg.n_layers)]
    names += [jsync._path_str(k).replace("/", ".") for k, _ in flat
              if not jsync._path_str(k).startswith("blocks/")]
    groups = convert.leaf_groups(names, tcfg)
    assert len(names) == 310 and len(groups) == len(flat) == 13
    assert [p for p, _ in groups] == [jsync._path_str(k) for k, _ in flat]
    assert dict(groups)["blocks/0/mixer/k_norm/norm_scale"][27] == \
        "layers.27.mixer.k_norm.norm_scale"


def test_scan_off_gives_groups_of_one():
    _, tcfg, params, _, _ = _trees("recurrentgemma-9b")
    tcfg = dataclasses.replace(tcfg, scan_blocks=False)
    names = list(_port(params, dataclasses.replace(tcfg, scan_blocks=True)))
    groups = convert.leaf_groups(names, tcfg)
    assert all(len(m) == 1 and p.startswith(("prefix/", "embed/", "final_norm/"))
               for p, m in groups)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_lars_equals_the_reference_on_the_stacked_tree(arch, nesterov):
    _, tcfg, params, grads, moms = _trees(arch)
    cfg = tlars.LARSConfig(nesterov=nesterov)
    want_p, want_s = jlars.update(params, grads, {"momentum": moms}, lr=LR, momentum=MOM,
                                  cfg=jlars.LARSConfig(nesterov=nesterov))
    tp, tg, tm = (_port(t, tcfg) for t in (params, grads, moms))
    groups = convert.leaf_groups(tp, tcfg)
    got_p, got_s = tlars.update(tp, tg, {"momentum": tm}, lr=LR, momentum=MOM, cfg=cfg,
                                groups=groups)
    assert list(got_p) == list(tp)   # the params' order
    for got, want in ((got_p, want_p), (got_s["momentum"], want_s["momentum"])):
        want = _port(jax.tree.map(np.asarray, want), tcfg)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-8, err_msg=name)


def test_per_leaf_trust_ratios_miss_the_reference():
    """The fault the groups fix: one trust ratio a port leaf moves a stacked
    weight by far more than the sum order's noise."""
    _, tcfg, params, grads, moms = _trees("qwen3-1.7b", n_layers=4)
    want_p, _ = jlars.update(params, grads, {"momentum": moms}, lr=LR, momentum=MOM)
    want = _port(jax.tree.map(np.asarray, want_p), tcfg)
    tp, tg, tm = (_port(t, tcfg) for t in (params, grads, moms))
    got, _ = tlars.update(tp, tg, {"momentum": tm}, lr=LR, momentum=MOM)
    name = "layers.0.mixer.q.kernel"
    gap = np.abs(got[name].numpy() - want[name].numpy()).max()
    step = np.abs(want[name].numpy() - tp[name].numpy()).max()
    assert gap > 1e-3 * step, (gap, step)


def test_groups_of_one_leave_the_resnet_step_as_before():
    jcfg = jresnet.ResNetConfig.tiny(compute_dtype=jnp.float32)
    params = convert.params_from_jax(
        jax.tree.map(np.asarray, jresnet.init(jax.random.key(0), jcfg)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    grads = {k: 1e-2 * torch.randn(p.shape, generator=gen) for k, p in params.items()}
    moms = {k: 1e-3 * torch.randn(p.shape, generator=gen) for k, p in params.items()}
    cfg = tlars.LARSConfig()
    a = tlars.update(params, grads, {"momentum": moms}, lr=LR, momentum=MOM, cfg=cfg)
    b = tlars.update(params, grads, {"momentum": moms}, lr=LR, momentum=MOM, cfg=cfg,
                     groups=convert.leaf_groups(params))
    names = list(params)
    flags = [not tlars.is_skip(n, cfg) for n in names]
    # the plain per-leaf functions, as the plain version ran before groups
    want = [ref.lars_update_ref(params[n], grads[n], moms[n], lr=LR, mom=MOM, eta=cfg.eta,
                                weight_decay=cfg.weight_decay, eps=cfg.eps) if f else
            ref.momentum_sgd_ref(params[n], grads[n], moms[n], lr=LR, mom=MOM)
            for n, f in zip(names, flags)]
    for n, (wp, wv) in zip(names, want):
        for got_p, got_s in (a, b):
            assert torch.equal(got_p[n], wp) and torch.equal(got_s["momentum"][n], wv), n


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_bucket_layout_is_the_reference_layout(arch, fuse):
    _, tcfg, params, _, _ = _trees(arch, n_layers=None)
    kw = dict(strategy="torus2d", fuse=fuse, bucket_bytes=4096, small_leaf_threshold=1024)
    want = jsync.bucket_layout(params, jsync.GradSyncConfig(comm_dtype=jnp.bfloat16, **kw))
    tp = _port(params, tcfg)
    got = tsync.bucket_layout(tp, tsync.GradSyncConfig(comm_dtype=torch.bfloat16, **kw),
                              groups=convert.leaf_groups(tp, tcfg))
    assert got == want
    if not fuse:
        assert {b["mode"] for b in got} == {"per_leaf", "grouped"}


def test_a_stacked_k_norm_is_a_large_leaf_as_in_the_reference():
    """Qwen3 at 28 layers: a layer's k_norm (head_dim elements) is under the
    small-leaf threshold, the stacked one over it."""
    _, tcfg, params, _, _ = _trees("qwen3-1.7b", n_layers=28)
    kw = dict(strategy="torus2d", fuse=False, small_leaf_threshold=512)
    want = jsync.bucket_layout(params, jsync.GradSyncConfig(comm_dtype=jnp.bfloat16, **kw))
    tp = _port(params, tcfg)
    cfg = tsync.GradSyncConfig(comm_dtype=torch.bfloat16, **kw)
    got = tsync.bucket_layout(tp, cfg, groups=convert.leaf_groups(tp, tcfg))
    assert got == want
    per_leaf = [b["paths"][0] for b in got if b["mode"] == "per_leaf"]
    assert "blocks/0/mixer/k_norm/norm_scale" in per_leaf
    assert not any("k_norm" in p for b in tsync.bucket_layout(tp, cfg)
                   if b["mode"] == "per_leaf" for p in b["paths"])
