"""LARS optimizer (You et al. [10]), as used by the paper (§3.2).

Paper settings: coefficient (trust ratio eta) = 0.01, eps = 1e-6, momentum
SGD underneath, and all LARS computation in fp32. Weight decay is applied
inside the LARS norm (You et al. eq. 4):

    local_lr = eta * ||w|| / (||g|| + wd * ||w|| + eps)
    v        = m * v + local_lr * global_lr * (g + wd * w)
    w        = w - v            (nesterov: w - (m * v + v - m * v_old))

Bias/BN parameters (paths matching ``skip_tags``) use plain momentum SGD
with no trust ratio and no weight decay.

Parameters are a dict ``{name: tensor}`` keyed by module path
(``stages.0.1.conv1.kernel``); ``name.replace(".", "/")`` is the JAX
package's path string, so the skip tags match the same leaves. A step
updates every leaf, LARS and skip alike, through one call of
``kernels.ops.lars_update_leaves``: two kernel launches on the card (a skip
leaf is a LARS leaf with trust 1 and no weight decay), the plain version on
the host. The JAX package's ``use_kernel`` switch has no counterpart because
the device picks the path.

**Groups.** The reference takes one trust ratio a leaf of its tree, and a
transformer's tree stacks each repeated layer's leaf over the layers
(``blocks/0/mixer/q/kernel``: all 28 of Qwen3-1.7B's q kernels). The port
keeps a leaf a layer, so ``update`` takes the reference's leaves as
``groups`` (``convert.leaf_groups``: a JAX path and the port names stacked
into it) and computes each trust ratio from the norms over a whole group.
Without ``groups`` every leaf is its own group, which is the ResNet's tree.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import convert
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class LARSConfig:
    eta: float = 0.01            # paper: "coefficient of 0.01"
    eps: float = 1e-6            # paper default
    weight_decay: float = 5e-5   # You et al. ImageNet setting
    skip_tags: tuple[str, ...] = ("bias", "bn", "scale", "norm", "embed_norm")
    nesterov: bool = False


def path_str(name: str) -> str:
    """The JAX package's path string for a module parameter name."""
    return name.replace(".", "/").lower()


def is_skip(name: str, cfg: LARSConfig) -> bool:
    ps = path_str(name)
    return any(t in ps for t in cfg.skip_tags)


@functools.lru_cache(maxsize=8)
def _lars_flags(names: tuple[str, ...], cfg: LARSConfig) -> list[bool]:
    """Which leaves take the trust ratio: one string match a leaf, once a model."""
    return [not is_skip(n, cfg) for n in names]


@functools.lru_cache(maxsize=8)
def _grouped_order(names: tuple[str, ...], groups) -> tuple[tuple[str, ...], list[int]]:
    """The names group after group, and each group's count of leaves;
    ``groups`` None: one a leaf (``convert.leaf_groups`` without a config)."""
    if groups is None:
        groups = convert.leaf_groups(names)
    order = tuple(n for _, members in groups for n in members)
    if sorted(order) != sorted(names):
        raise ValueError("lars.update: the groups do not cover the params' names")
    return order, [len(members) for _, members in groups]


def init(params: dict[str, torch.Tensor]) -> dict:
    """Momentum buffers, fp32 (master precision) like the params."""
    return {"momentum": {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}}


@torch.no_grad()
def update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
           opt_state: dict, *, lr: float, momentum: float,
           cfg: LARSConfig = LARSConfig(), groups=None):
    """One LARS step; all math in fp32 (paper §3.2).

    ``groups``: the reference's leaves (``convert.leaf_groups``), each
    taking one trust ratio over its port leaves; None: one a leaf.
    Returns new ``(params, opt_state)`` dicts in ``params``' order; the
    inputs are not modified.
    """
    names = tuple(params)
    order, sizes = _grouped_order(names, groups)
    moms = opt_state["momentum"]
    new_p, new_m = kops.lars_update_leaves(
        # autograd.grad may hand back a conv kernel's gradient in another
        # memory layout than the kernel; the kernels pair elements by offset
        [params[n] for n in order], [grads[n].contiguous() for n in order],
        [moms[n] for n in order], _lars_flags(order, cfg),
        lr=lr, mom=momentum, eta=cfg.eta, weight_decay=cfg.weight_decay,
        eps=cfg.eps, nesterov=cfg.nesterov, groups=sizes)
    by_p, by_m = dict(zip(order, new_p)), dict(zip(order, new_m))
    return {n: by_p[n] for n in names}, {"momentum": {n: by_m[n] for n in names}}


# -- plain momentum-SGD baseline (the no-LARS ablation) ----------------------

def sgd_init(params: dict[str, torch.Tensor]) -> dict:
    return init(params)


@torch.no_grad()
def sgd_update(params, grads, opt_state, *, lr, momentum, weight_decay=0.0):
    new_p, new_m = {}, {}
    for name, p in params.items():
        g32 = grads[name].float() + weight_decay * p.float()
        v_new = momentum * opt_state["momentum"][name] + g32
        new_p[name] = (p.float() - lr * v_new).to(p.dtype)
        new_m[name] = v_new
    return new_p, {"momentum": new_m}
