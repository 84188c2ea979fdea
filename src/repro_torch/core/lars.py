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
"""

from __future__ import annotations

import dataclasses
import functools

import torch

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


def init(params: dict[str, torch.Tensor]) -> dict:
    """Momentum buffers, fp32 (master precision) like the params."""
    return {"momentum": {k: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device)
                         for k, p in params.items()}}


@torch.no_grad()
def update(params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor],
           opt_state: dict, *, lr: float, momentum: float,
           cfg: LARSConfig = LARSConfig()):
    """One LARS step; all math in fp32 (paper §3.2).

    Returns new ``(params, opt_state)`` dicts; the inputs are not modified.
    """
    names = tuple(params)
    moms = opt_state["momentum"]
    new_p, new_m = kops.lars_update_leaves(
        # autograd.grad may hand back a conv kernel's gradient in another
        # memory layout than the kernel; the kernels pair elements by offset
        [params[n] for n in names], [grads[n].contiguous() for n in names],
        [moms[n] for n in names], _lars_flags(names, cfg),
        lr=lr, mom=momentum, eta=cfg.eta, weight_decay=cfg.weight_decay,
        eps=cfg.eps, nesterov=cfg.nesterov)
    return dict(zip(names, new_p)), {"momentum": dict(zip(names, new_m))}


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
