"""The plain reference against the port at a tiny size on the CPU, in
float32: the same weights and batch give the same logits, loss, gradients
and LARS step. (The test may import both; the reference imports nothing of
the port.)"""

import dataclasses

import pytest
import torch
from conftest import TINY

from bench.harness import data, runner, spec
from bench.reference import qwen3, resnet
from bench.reference import train as ref_train


def _cell(name, family):
    return runner.load_cell(runner.Options(name, (1,), 0.0, overrides=TINY[family]))


def _close(a, b, tol=2e-5):
    assert torch.allclose(a, b, rtol=tol, atol=tol), float((a - b).abs().max())


def test_resnet_forward_backward_as_the_port():
    from repro_torch.core import losses
    from repro_torch.models import resnet as port
    cell = _cell("resnet50.mlperf256", "resnet")
    cfg, m = cell.config, cell.config["model"]
    model = port.init(port.ResNetConfig(stage_sizes=tuple(m["stage_sizes"]), width=m["width"],
                                        num_classes=m["num_classes"], image_size=m["image_size"],
                                        compute_dtype=torch.float32), device="cpu")
    shapes = resnet.param_shapes(cfg)
    assert shapes == {n: tuple(p.shape) for n, p in model.named_parameters()}
    p = data.weights(shapes, resnet.init_rule, 11, "cpu")
    images, labels = spec.traffic("images").pool(cell, 11, "cpu", 8)[0]
    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    ours = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    port_loss = losses.label_smoothing_xent(port.apply(model, images, params=leaves), labels, 0.1)
    ref_loss = resnet.loss(ours, (images, labels), cfg)
    _close(port_loss, ref_loss)
    g_port = torch.autograd.grad(port_loss, list(leaves.values()))
    g_ref = torch.autograd.grad(ref_loss, list(ours.values()))
    for n, a, b in zip(p, g_port, g_ref):
        _close(a, b, 1e-4)


def test_qwen3_forward_backward_as_the_port():
    from repro_torch.configs import registry
    from repro_torch.core import losses
    from repro_torch.models import transformer as T
    from bench.systems.lm import FIELDS
    cell = _cell("qwen3-1.7b.seq4096", "lm")
    cfg, m = cell.config, cell.config["model"]
    arch = dataclasses.replace(registry.get("qwen3-1.7b"), **{f: m[k] for k, f in FIELDS.items()},
                               compute_dtype=torch.float32)
    shapes = qwen3.param_shapes(cfg)
    assert shapes == {n: tuple(p.shape) for n, p in T.init(arch, device="meta").named_parameters()}
    p = data.weights(shapes, lambda n, s: ("normal", 0.1) if "norm" in n else
                     qwen3.init_rule(n, s), 12, "cpu")
    tokens, labels = spec.traffic("tokens").pool(cell, 12, "cpu", 2)[0]
    leaves = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    ours = {n: t.clone().requires_grad_(True) for n, t in p.items()}
    logits, _ = T.forward(T.params_tree(leaves), tokens, arch)
    port_loss = losses.label_smoothing_xent(logits, labels, 0.1)
    ref_loss = qwen3.loss(ours, (tokens, labels), cfg)
    _close(port_loss, ref_loss)
    g_port = torch.autograd.grad(port_loss, list(leaves.values()))
    g_ref = torch.autograd.grad(ref_loss, list(ours.values()))
    for a, b in zip(g_port, g_ref):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("family", ["resnet", "lm"])
def test_lars_step_as_the_port(family):
    from repro_torch import convert
    from repro_torch.core import lars
    from repro_torch.configs import registry
    name = "resnet50.mlperf256" if family == "resnet" else "qwen3-1.7b.seq4096"
    cell = _cell(name, family)
    mod = ref_train.model(cell.config)
    shapes = mod.param_shapes(cell.config)
    p = data.weights(shapes, lambda n, s: ("normal", 0.5), 3, "cpu")
    g = data.weights(shapes, lambda n, s: ("normal", 0.01), 4, "cpu")
    v = data.weights(shapes, lambda n, s: ("normal", 0.001), 5, "cpu")
    lc = cell.config["recipe"]["lars"]
    cfg = lars.LARSConfig(eta=lc["eta"], eps=lc["eps"], weight_decay=lc["weight_decay"],
                          skip_tags=tuple(lc["skip_tags"]))
    groups = None
    if family == "lm":
        arch = registry.get_smoke("qwen3-1.7b")
        groups = convert.leaf_groups(list(shapes), arch)
    new_p, new_opt = lars.update(p, g, {"momentum": v}, lr=0.7, momentum=0.9, cfg=cfg,
                                 groups=groups)
    rp = {n: t.clone() for n, t in p.items()}
    rv = {n: t.clone() for n, t in v.items()}
    ref_train.lars_step(rp, g, rv, mod.lars_groups(list(shapes), cell.config), lc, 0.7, 0.9)
    for n in shapes:
        _close(new_p[n], rp[n], 1e-6)
        _close(new_opt["momentum"][n], rv[n], 1e-6)
