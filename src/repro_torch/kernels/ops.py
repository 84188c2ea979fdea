"""Dispatch to the kernels by the device of the tensors they are given.

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``. A
CUDA tensor goes to the CUDA kernel, or the call raises: there is no
fallback. The first CUDA call builds the kernel library
(``kernels/build.py``) from ``csrc/``.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref, traffic
from repro_torch.kernels.batchnorm import (BatchNorm, bn_bwd_dx_cuda, bn_bwd_sums_cuda,
                                           bn_fwd_apply_cuda, bn_fwd_stats_cuda)
from repro_torch.kernels.flash_attn import (FlashAttention, check_every_row_attends,
                                            flash_attention_bwd_bf16, flash_attention_bwd_f32,
                                            flash_attention_cuda, flash_attention_f32,
                                            flash_attention_tc)
from repro_torch.kernels.lars_update import lars_update_cuda
from repro_torch.kernels.ls_xent import LSXent, ls_xent_bwd_cuda, ls_xent_fwd_cuda
from repro_torch.utils import dtensor

_WRAPPERS = {"lars_update": lars_update_cuda, "ls_xent_fwd": ls_xent_fwd_cuda,
             "ls_xent_bwd": ls_xent_bwd_cuda, "flash_attn": flash_attention_tc,
             "flash_attn_f32": flash_attention_f32, "flash_attn_bwd": flash_attention_bwd_bf16,
             "flash_attn_bwd_f32": flash_attention_bwd_f32, "bn_fwd_stats": bn_fwd_stats_cuda,
             "bn_fwd_apply": bn_fwd_apply_cuda, "bn_bwd_sums": bn_bwd_sums_cuda,
             "bn_bwd_dx": bn_bwd_dx_cuda}


def lars_update_leaves(ps, gs, vs, lars, *, lr, mom, eta, weight_decay, eps,
                       nesterov: bool = False, groups=None):
    """One LARS step over lists of fp32 leaves; returns ``(ps', vs')``.

    ``lars[i]`` False makes leaf i a skip leaf: plain momentum SGD (trust 1,
    no weight decay). ``groups`` counts the consecutive leaves that share a
    trust ratio (the reference's stacked leaves); None: one a leaf. On the
    card: two launches for all leaves (more past ``MAX_LEAVES`` leaves).
    """
    if not ps or not ps[0].is_cuda:
        with traffic.as_kernel("lars_update") as io:
            out = ref.lars_update_leaves_ref(ps, gs, vs, lars, lr=lr, mom=mom, eta=eta,
                                             weight_decay=weight_decay, eps=eps,
                                             nesterov=nesterov, groups=groups)
            io(*ps, *gs, *vs, *out[0], *out[1])
        return out
    return lars_update_cuda(ps, gs, vs, lars, lr=lr, mom=mom, eta=eta,
                            weight_decay=weight_decay, eps=eps, nesterov=nesterov,
                            groups=groups)


def lars_update(p, g, v, *, lr, mom, eta, weight_decay, eps,
                nesterov: bool = False):
    """Fused LARS step for one fp32 leaf; returns ``(p', v')``: a one-leaf
    call of ``lars_update_leaves``."""
    ps, vs = lars_update_leaves([p], [g], [v], [True], lr=lr, mom=mom, eta=eta,
                                weight_decay=weight_decay, eps=eps,
                                nesterov=nesterov)
    return ps[0], vs[0]


def ls_xent(logits: torch.Tensor, labels: torch.Tensor, *,
            smoothing: float) -> torch.Tensor:
    """Per-row label-smoothed cross-entropy, differentiable in ``logits``.

    logits: (..., V) fp32 or bf16; labels: (...) int32 or int64 -> (...) fp32.
    """
    batch_shape = logits.shape[:-1]
    x = logits.reshape(-1, logits.shape[-1])
    if isinstance(x, DTensor):   # the dry run: over the vocab shards, or whole rows
        per = dtensor.ls_xent(x, labels.reshape(-1), smoothing)
        if per is not None:
            return per.reshape(batch_shape)
        x = dtensor.unshard(x, -1)
    per = LSXent.apply(x.contiguous(), labels.reshape(-1), smoothing)
    return per.reshape(batch_shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention with an online softmax (training forward and prefill),
    differentiable in q, k and v.

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D), H % Hkv == 0 (GQA). Masks,
    softcap and scale as ``repro/kernels/flash_attn.py::flash_attention``.
    Raises on both devices when a query row has no key to attend
    (``check_every_row_attends``). On the card, under autograd, the forward
    kernel also writes each row's logsumexp and the backward kernel
    (``csrc/flash_attn_bwd.cu``) gives the gradients; on the host the plain
    version is differentiated by autograd.
    """
    if not q.is_cuda:
        check_every_row_attends(q.shape[1], k.shape[1], window)
        # DTensors (the dry run, meta): each rank's sequences and query heads;
        # a run that counts bytes counts the kernels' (``traffic.attention``)
        return dtensor.headwise(traffic.attention(
            lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                                    softcap=softcap, scale=scale)), q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                scale=scale)


def batchnorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
              stats=None, grid=None, eps: float = 1e-5, relu: bool = False,
              residual: torch.Tensor | None = None, return_stats: bool = False):
    """BN over channel dim 1, then ``+ residual`` and the ReLU where asked,
    differentiable in x, scale, bias and the residual (``kernels/batchnorm.py``).
    The scale and bias (fp32 masters) are rounded to x's dtype.

    ``stats`` (mean, var) are eval's constants; otherwise batch statistics,
    over the ranks of ``grid`` (a built ``TorusGrid``) when it has more than
    one. ``return_stats`` also returns the (mean, var) used, fp32. On the
    card: two launches forward and two backward, whatever the epilogue.
    """
    group, ranks = None, 1
    if grid is not None and grid.size > 1:
        group, ranks = grid.world.group, grid.size
    mean, var = (None, None) if stats is None else stats
    y, mv = BatchNorm.apply(x, scale, bias, residual, mean, var, eps, relu, group, ranks)
    return (y, (mv[0], mv[1])) if return_stats else y


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
