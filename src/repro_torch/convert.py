"""Carry weights between the JAX package's param trees and the port.

A JAX tree is a nested dict/list of arrays (``repro/models/resnet.py:init``),
passed here as numpy arrays. The port's params are ``{name: tensor}`` with
module paths for names: ``stages.0.1.conv1.kernel`` for the JAX path
``stages/0/1/conv1/kernel``. Conv kernels are HWIO in JAX and OIHW here;
every other leaf (the dense ``(in, out)`` kernel included) keeps its shape.

A JAX transformer tree (``repro/models/transformer.py:init``) holds its
first ``n_prefix`` layers in ``prefix`` and the rest in ``blocks``: one
layer tree per pattern position whose leaves are stacked over ``n_blocks``.
``transformer_from_jax`` unstacks them into the port's ``layers.<i>``, with
layer ``i = n_prefix + b * len(pattern) + j`` from block ``b``, position
``j``. Dense kernels stay (in, out): the port computes ``x @ W`` as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as device_lib

_HWIO_TO_OIHW = (3, 2, 0, 1)
_OIHW_TO_HWIO = (2, 3, 1, 0)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, sub in items:
        yield from _flatten(sub, f"{prefix}.{k}" if prefix else str(k))


def params_from_jax(tree, device=None) -> dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> the port's ``{name: tensor}``."""
    dev = device_lib.resolve(device)
    out = {}
    for name, a in _flatten(tree):
        a = np.asarray(a, dtype=np.float32)
        if a.ndim == 4:
            a = a.transpose(_HWIO_TO_OIHW)
        out[name] = torch.tensor(a, device=dev)
    return out


def layers_from_jax(tree, cfg) -> list:
    """The per-layer subtrees of a JAX transformer tree (params or cache) in
    ``cfg.kinds()`` order: ``prefix`` as it is, then ``blocks`` unstacked."""
    layers = list(tree.get("prefix", []))
    for b in range(cfg.n_blocks):
        for j in range(len(cfg.pattern)):
            layers.append(_index(tree["blocks"][j], b))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"tree holds {len(layers)} layers, {cfg.name} has {cfg.n_layers}")
    return layers


def _index(tree, b):
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, b) for v in tree]
    return np.asarray(tree)[b]


def transformer_from_jax(tree, cfg, device=None) -> dict[str, torch.Tensor]:
    """JAX transformer param tree (numpy leaves) -> the port's state dict."""
    cfg.check_ported()
    flat = {k: v for k, v in tree.items() if k not in ("prefix", "blocks")}
    flat["layers"] = layers_from_jax(tree, cfg)
    return params_from_jax(flat, device)


def _jax_key(component: str):
    # an all-digit component is a list index (``_listify``)
    return (0, int(component), "") if component.isdigit() else (1, 0, component)


def jax_order(names) -> list[str]:
    """The port's names in the order ``jax.tree_util`` flattens the tree
    that ``params_to_jax`` builds from them: dict keys sorted, list indices
    by number (``stages.10`` after ``stages.9``)."""
    return sorted(names, key=lambda n: tuple(_jax_key(c) for c in n.split(".")))


def jax_path(name: str) -> str:
    """The JAX package's path string of a leaf (``_path_str`` of
    ``repro/core/grad_sync.py``): ``stages/0/1/conv1/kernel``."""
    return name.replace(".", "/").lower()


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def params_to_jax(params: dict[str, torch.Tensor]):
    """The port's ``{name: tensor}`` -> JAX-layout tree of numpy arrays."""
    root: dict = {}
    for name, t in params.items():
        a = t.detach().float().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(_OIHW_TO_HWIO)
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return _listify(root)
