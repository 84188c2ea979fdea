"""The comparison that decides ``correct`` for a training cell.

Set-up drives the program's own train state through its first steps, each
through ``Trainer.run``; the reference (``bench/reference/train.py``) takes
the same first weights and batches. Three numbers are compared, each
against its limit in the cell's file:

- ``loss_gap``: the largest |program - reference| / |reference| of the
  steps' losses;
- ``grad_gap``: the first gradient as LARS received it, worked out from
  the program's state after one step (below), a norm a leaf; the worst
  leaf's |program - reference| over the larger of the reference's norm of
  that leaf and of the median leaf (of those whose norm is not 0);
- ``change_gap``: the same of each leaf's norm of change from the first
  weights after the last step, leaving out the leaves whose reference
  gradient lies under a thousandth of the median leaf's at every step:
  they move by round-off and weight decay alone;
- ``grad_gap_median`` and ``change_gap_median``: the median leaf's gap of
  the same two, over the leaves whose reference norm is not 0. The worst
  leaf's gap is that of a few leaves whose norms any rounding moves (the
  reference itself in bf16 reads it as the program does); the median leaf's
  is steady from seed to seed and tells the configuration's bf16 from fp8.

- ``update_diff_median`` (where a cell's limits name it): the median
  leaf's ||v1 - v1_ref|| / ||v1_ref|| of the first step's momentum, the
  update LARS made from the first gradient, taken from the state as it is,
  over the leaves whose first reference gradient is not 0 (the others' v1
  is weight decay alone, the same on both sides).
  A norm sees only the part of a rounding error along the gradient, a
  small random share of it, so the gaps above read much the same for bf16
  and for fp8 on ResNet-50; the difference sees all of it.

The first gradient from the state after one step: momentum starts at 0,
so LARS's first step leaves v1 = lr g for a leaf without the trust ratio,
and v1 = lr t (g + wd p0) with t = eta ||p0|| / (||g|| + wd ||p0|| + eps)
over the group for one with it (t = 1 and v1 = lr wd p0 where g = 0). With
u = v1 / (lr eta ||p0||) and m = ||g|| + wd ||p0|| + eps, g = m u - wd p0,
and m is the root above wd ||p0|| + eps of ||m u - wd p0||^2 = (m - wd
||p0|| - eps)^2, a quadratic in m; solved in float64.
"""

from __future__ import annotations

import math
import statistics

import torch

SMALL = 1e-3    # a leaf whose reference gradient is under this x the median's


def _dot(a, b) -> float:
    return float((a.double() * b.double()).sum())


@torch.no_grad()
def first_grad_norms(p0: dict, v1: dict, groups, lars: dict, lr: float) -> dict[str, float]:
    """Each leaf's norm of the gradient that LARS's first step received,
    from its first weights ``p0`` and its momentum ``v1`` after the step."""
    eta, wd, eps = lars["eta"], lars["weight_decay"], lars["eps"]
    out = {}
    for names, trusted in groups:
        if not trusted:
            out.update({n: math.sqrt(_dot(v1[n], v1[n])) / lr for n in names})
            continue
        w = math.sqrt(sum(_dot(p0[n], p0[n]) for n in names))
        rest = sum(_dot(v1[n] / lr - wd * p0[n].double(), v1[n] / lr - wd * p0[n].double())
                   for n in names)
        if math.sqrt(rest) <= 1e-3 * wd * w:          # g = 0: the trust ratio was 1
            out.update({n: 0.0 for n in names})
            continue
        k = lr * eta * w
        uu = sum(_dot(v1[n], v1[n]) for n in names) / (k * k)
        up = sum(_dot(v1[n], p0[n]) for n in names) / k
        b = wd * w + eps
        a2, a1, a0 = uu - 1.0, 2.0 * (b - wd * up), (wd * w) ** 2 - b * b
        if abs(a2) < 1e-300:
            m = -a0 / a1
        else:
            disc = math.sqrt(max(a1 * a1 - 4.0 * a2 * a0, 0.0))
            m = max((-a1 + disc) / (2.0 * a2), (-a1 - disc) / (2.0 * a2))
        for n in names:
            g = m * (v1[n].double() / k) - wd * p0[n].double()
            out[n] = math.sqrt(float((g * g).sum()))
    return out


def _median(values) -> float:
    """The median leaf's norm, over the leaves whose norm is not 0 (at the
    paper's init two thirds of ResNet-50's leaves have no first gradient)."""
    values = [v for v in values if v > 0]
    return statistics.median(values) if values else 0.0


def _worst(prog: dict, ref: dict, names) -> float:
    names = list(names)
    if not names:
        return 0.0
    med = _median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) if max(ref[n], med) > 0
               else abs(prog[n] - ref[n]) for n in names)


def _gaps(prog: dict, ref: dict, names) -> list[float]:
    """Each leaf's gap over the larger of its reference norm and the median
    leaf's, for the leaves whose reference norm is not 0."""
    med = _median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in names if ref[n] > 0]


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``prog``: {"loss": [...], "grad_norms": {leaf: n}, "change": {leaf: c}};
    ``ref``: the reference's ``train`` result."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    first = ref["grad_norms"][0]
    kept = [n for n in first if n not in set(excluded(ref))]
    grads = _gaps(prog["grad_norms"], first, first)
    changes = _gaps(prog["change"], ref["change"], kept)
    out = {"loss_gap": loss_gap,
           "grad_gap": _worst(prog["grad_norms"], first, first),
           "change_gap": _worst(prog["change"], ref["change"], kept),
           "grad_gap_median": statistics.median(grads) if grads else 0.0,
           "change_gap_median": statistics.median(changes) if changes else 0.0}
    if "v1" in prog and "v1" in ref:
        diffs = [_norm(prog["v1"][n] - ref["v1"][n]) / _norm(ref["v1"][n])
                 for n in ref["v1"] if first[n] > 0]
        out["update_diff_median"] = statistics.median(diffs)
    return out


def _norm(t) -> float:
    return math.sqrt(_dot(t, t))


def excluded(ref: dict) -> list[str]:
    """The leaves ``numbers`` leaves out of the change."""
    return [n for n in ref["grad_norms"][0]
            if all(step[n] < SMALL * _median(step.values()) for step in ref["grad_norms"])]
