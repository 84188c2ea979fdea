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
``j``. Every transformer leaf keeps its JAX shape: dense kernels stay
(in, out), as the port computes ``x @ W`` as JAX does, the MoE expert
stacks (E, d, f), the SSD's and RG-LRU's (W, C) conv kernels and (w, w)
gate matrices, and nothing of a transformer is taken for a conv kernel (an
SSD state in a cache is 4-d too). ``layers_from_jax`` unstacks a JAX cache
the same way: RG-LRU ``hidden``/``conv`` states and the cross layers'
vision k/v included.
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


def to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A leaf of the port in the JAX package's layout (a view): conv
    kernels OIHW -> HWIO, every other leaf as it is."""
    return t.permute(_OIHW_TO_HWIO) if t.dim() == 4 else t


def from_jax_layout(a: np.ndarray) -> np.ndarray:
    """A leaf of the JAX package in the port's layout (a view): conv
    kernels HWIO -> OIHW, every other leaf as it is."""
    return a.transpose(_HWIO_TO_OIHW) if a.ndim == 4 else a


def _tensors(tree, device, layout) -> dict[str, torch.Tensor]:
    dev = device_lib.resolve(device)
    return {name: torch.tensor(layout(np.asarray(a, dtype=np.float32)), device=dev)
            for name, a in _flatten(tree)}


def params_from_jax(tree, device=None) -> dict[str, torch.Tensor]:
    """JAX param tree of the ResNet (numpy leaves) -> the port's
    ``{name: tensor}``, conv kernels HWIO -> OIHW."""
    return _tensors(tree, device, from_jax_layout)


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
    flat = {k: v for k, v in tree.items() if k not in ("prefix", "blocks")}
    flat["layers"] = layers_from_jax(tree, cfg)
    return _tensors(flat, device, lambda a: a)


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


def is_stacked(path: str) -> bool:
    """Whether a JAX path of ``leaf_groups`` is a stacked block leaf (its
    array leads with the layer dim, whatever the count of layers)."""
    return path.startswith("blocks/")


def reference_name(name: str, cfg=None) -> tuple[str, int]:
    """(the name of a port leaf in the reference's tree, its place b in a
    stacked leaf): ``layers.<i>.<rest>`` is ``prefix.<i>.<rest>`` for a
    prefix layer, else ``blocks.<j>.<rest>`` at b, with ``i = n_prefix + b
    * len(pattern) + j``; any other name, or any name without a
    transformer's ``cfg``, is itself at 0. Case is kept (mamba2's
    ``A_log``)."""
    head, _, rest = name.partition(".")
    if cfg is None or head != "layers":
        return name, 0
    idx, _, rest = rest.partition(".")
    i = int(idx)
    if i < cfg.n_prefix:
        return f"prefix.{i}.{rest}", 0
    b, j = divmod(i - cfg.n_prefix, len(cfg.pattern))
    return f"blocks.{j}.{rest}", b


def leaf_groups(names, cfg=None) -> tuple[tuple[str, tuple[str, ...]], ...]:
    """The leaves of the reference's tree that the port's ``names`` form, in
    ``jax.tree_util`` flatten order: ``(JAX path, port names stacked into
    it)`` a leaf.

    With a transformer's ``cfg`` (``n_prefix``/``n_blocks``), the JAX leaf
    ``blocks/<j>/<rest>`` stacks ``layers.<n_prefix + b * len(pattern) +
    j>.<rest>`` over b = 0 .. n_blocks - 1, in b order, as
    ``transformer_from_jax`` unstacks it; a prefix layer is
    ``prefix/<i>/<rest>``. Every other leaf (``embed``, ``final_norm``,
    ``unembed``, and every leaf without a ``cfg``, as the ResNet's) is a
    group of one. The groups depend on the names and the config alone:
    build them once a model.
    """
    stacked: dict[str, list[tuple[int, str]]] = {}
    for name in names:
        jname, b = reference_name(name, cfg)
        stacked.setdefault(jname, []).append((b, name))
    return tuple((jax_path(jname), tuple(n for _, n in sorted(stacked[jname])))
                 for jname in jax_order(stacked))


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
        a = to_jax_layout(t.detach().float().cpu()).numpy()
        *path, leaf = name.split(".")
        node = root
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(a)
    return _listify(root)
