"""Label-smoothing cross-entropy (paper §2.1, Szegedy et al. [13]).

With smoothing factor alpha and K classes, the target distribution is
    q(k) = (1 - alpha) * onehot(k) + alpha / K
and the loss is the cross-entropy  -sum_k q(k) log p(k).

There is one path: ``kernels.ops.ls_xent`` runs the CUDA kernels on a CUDA
tensor and their plain versions on a CPU tensor, so the JAX package's
``use_kernel`` switch has no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ls_xent_ref

__all__ = ["label_smoothing_xent", "ls_xent_ref", "softmax_xent",
           "top1_accuracy"]


def label_smoothing_xent(logits: torch.Tensor, labels: torch.Tensor,
                         smoothing: float = 0.1,
                         where: torch.Tensor | None = None) -> torch.Tensor:
    """Mean smoothed cross-entropy.

    logits: (..., K) float; labels: (...) int. ``where``: optional bool mask
    over the batch positions (padding). A masked position's label may lie
    outside [0, K) (a pad id): the kernel sees class 0 there instead, so the
    row's loss is finite and its gradient 0 on both devices.
    """
    if where is not None:
        labels = torch.where(where, labels, torch.zeros_like(labels))
    per = kops.ls_xent(logits, labels, smoothing=smoothing)
    if where is not None:
        per = torch.where(where, per, torch.zeros_like(per))
        return per.sum() / where.sum().clamp(min=1)
    return per.mean()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 where: torch.Tensor | None = None) -> torch.Tensor:
    """Plain CE (the no-LS ablation)."""
    return label_smoothing_xent(logits, labels, smoothing=0.0, where=where)


def top1_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()
