"""The plain training step the benchmark holds the program to: float32
forward and backward of a reference model, the gradient of the mean loss
over the global batch (which is the mean of the ranks' gradients when they
hold equal rows), the paper's non-finite guard at a loss scale of 1, and
LARS (You et al., arXiv:1708.03888, eq. 4; the paper's §3.2) with its
momentum, from the configuration's recipe.

Nothing here imports the program under test or takes anything it made: the
weights and batches come from the benchmark's generators.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

f32 = np.float32


def model(cfg: dict):
    """The reference module that the configuration names."""
    return importlib.import_module(f"bench.reference.{cfg['reference']}")


def smoothed_xent(logits: torch.Tensor, labels: torch.Tensor, a: float) -> torch.Tensor:
    """Per-row cross-entropy against (1 - a) onehot + a / K, float32."""
    x = logits.float()
    lse = torch.logsumexp(x, -1)
    x_y = torch.gather(x, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (1.0 - a) * (lse - x_y) - a * (x.mean(-1) - lse)


def lr_at(sched: dict, epoch: float) -> float:
    """Schedule B (the paper's Table 3): linear warm-up from ``warmup_init``
    to ``base_lr_1`` over ``warmup_epochs``, then base * (1 - e / total)^2
    with base 1 before ``switch_epoch`` and base 2 after; in float32."""
    e = f32(epoch)
    if e < sched["warmup_epochs"]:
        return float(f32(sched["base_lr_1"] - sched["warmup_init"]) * e
                     / f32(sched["warmup_epochs"]) + f32(sched["warmup_init"]))
    d = f32(1.0) - e / f32(sched["total_epochs"])
    base = sched["base_lr_1"] if e < sched["switch_epoch"] else sched["base_lr_2"]
    return float(f32(base) * (d * d))


def momentum_at(sched: dict, global_batch: int) -> float:
    """Momentum from a constant SGD noise scale (Smith and Le):
    1 - (1 - m_ref) B_ref / B, clipped to [0, 0.999]."""
    c = f32((1.0 - sched["ref_momentum"]) * sched["ref_batch"])
    return float(min(max(f32(1.0) - c / f32(global_batch), f32(0.0)), f32(0.999)))


def _norm(ts) -> torch.Tensor:
    return torch.sqrt(sum((t.double() * t.double()).sum() for t in ts))


@torch.no_grad()
def lars_step(p: dict, g: dict, v: dict, groups, lars: dict, lr: float, mom: float) -> None:
    """One LARS step in place, group by group: a group that takes the trust
    ratio scales its step by eta ||w|| / (||g|| + wd ||w|| + eps) (1 where a
    norm is 0) and adds weight decay; the others are momentum SGD."""
    eta, wd, eps = lars["eta"], lars["weight_decay"], lars["eps"]
    for names, trusted in groups:
        if trusted:
            w_n = float(_norm([p[n] for n in names]))
            g_n = float(_norm([g[n] for n in names]))
            trust = eta * w_n / (g_n + wd * w_n + eps) if w_n > 0 and g_n > 0 else 1.0
            for n in names:
                v[n].mul_(mom).add_(trust * lr * (g[n] + wd * p[n]))
                p[n].sub_(v[n])
        else:
            for n in names:
                v[n].mul_(mom).add_(lr * g[n])
                p[n].sub_(v[n])


def train(cfg: dict, params0: dict, batches, *, epoch: float, global_batch: int,
          q=None, rows: slice | None = None, first_update: bool = False) -> dict:
    """Steps of the reference from ``params0``, one a batch of ``batches``
    (each the global batch), at the schedule's ``epoch`` and momentum for
    ``global_batch``. ``q``: the control's rounding of matrix operands;
    ``rows``: train on those rows of each batch only (a planted fault).

    Returns the losses, each step's gradient norm a leaf, and each leaf's
    norm of change from ``params0`` after the last step (float64 floats);
    with ``first_update``, also the momentum after the first step (``v1``,
    on the host)."""
    mod = model(cfg)
    recipe = cfg["recipe"]
    names = list(params0)
    groups = mod.lars_groups(names, cfg)
    lr, mom = lr_at(recipe["schedule"], epoch), momentum_at(recipe["schedule"], global_batch)
    p = {n: t.detach().clone().float() for n, t in params0.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    out = {"loss": [], "grad_norms": []}
    for batch in batches:
        if rows is not None:
            batch = tuple(t[rows] for t in batch)
        leaves = {n: t.requires_grad_(True) for n, t in p.items()}
        with torch.enable_grad():
            loss = mod.loss(leaves, batch, cfg, q)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        p = {n: t.detach() for n, t in leaves.items()}
        out["loss"].append(float(loss.detach()))
        out["grad_norms"].append({n: float(_norm([g])) for n, g in grads.items()})
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                     for g in grads.values())
        if finite:
            lars_step(p, grads, v, groups, recipe["lars"], lr, mom)
        if first_update and "v1" not in out:
            out["v1"] = {n: t.to("cpu", copy=True) for n, t in v.items()}
        del grads, loss
    out["change"] = {n: float(_norm([p[n] - params0[n].float()])) for n in names}
    return out
