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
package's path string, so the skip tags match the same leaves. The
elementwise update of every LARS leaf is the CUDA kernel on the card
(``kernels.ops.lars_update``); the JAX package's ``use_kernel`` switch has no
counterpart because the device picks the path.
"""

from __future__ import annotations

import dataclasses

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
    moms = opt_state["momentum"]
    new_p, new_m = {}, {}
    for name, p in params.items():
        g, v = grads[name], moms[name]
        if is_skip(name, cfg):
            p32, g32 = p.float(), g.float()
            v_new = momentum * v + lr * g32
            step = (momentum * v_new + (v_new - momentum * v)
                    if cfg.nesterov else v_new)
            p_out = p32 - step
        else:
            p_out, v_new = kops.lars_update(
                p.float().contiguous(), g.float().contiguous(), v,
                lr=lr, mom=momentum, eta=cfg.eta,
                weight_decay=cfg.weight_decay, eps=cfg.eps,
                nesterov=cfg.nesterov)
        new_p[name] = p_out.to(p.dtype)
        new_m[name] = v_new
    return new_p, {"momentum": new_m}


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
