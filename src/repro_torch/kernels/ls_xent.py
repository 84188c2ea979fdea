"""Label-smoothed cross-entropy: kernel wrappers and their autograd.Function.

Replaces ``repro/kernels/ls_xent.py`` (Pallas, forward only). The forward
kernel returns the per-row loss and saves the per-row logsumexp; the
backward kernel turns that into ``dlogits`` without a (R, V) intermediate.
``LSXent`` runs the kernels on CUDA tensors and their plain versions
(``kernels/ref.py``) on CPU tensors, so the CPU tests exercise the same
hand-written backward formula that the kernel computes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(logits: torch.Tensor, labels: torch.Tensor, what: str):
    if not logits.is_cuda or labels.device != logits.device:
        raise ValueError(f"{what}: logits and labels must be on one CUDA device, "
                         f"got {logits.device} and {labels.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{what}: logits must be float32 or bfloat16, got {logits.dtype}")
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: want logits (R, V) and labels (R,), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if not logits.is_contiguous():
        raise ValueError(f"{what}: logits must be contiguous")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: labels must be int32 or int64, got {labels.dtype}")
    return labels.to(torch.int64).contiguous()


def ls_xent_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                     smoothing: float):
    """Per-row (loss, lse), fp32, from (R, V) logits on the card."""
    labels = _check(logits, labels, "ls_xent_fwd_cuda")
    rows, vocab = logits.shape
    loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    err = build.library().ls_xent_fwd(
        logits.data_ptr(), _DTYPES[logits.dtype], labels.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), rows, vocab, smoothing,
        torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "ls_xent_fwd")
    ls_xent_fwd_cuda.launches += 1
    return loss, lse


def ls_xent_bwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, gout: torch.Tensor,
                     smoothing: float) -> torch.Tensor:
    """dlogits, in logits' dtype, from the forward's lse and the row grads."""
    labels = _check(logits, labels, "ls_xent_bwd_cuda")
    rows, vocab = logits.shape
    for name, t in (("lse", lse), ("gout", gout)):
        if (t.device != logits.device or t.dtype != torch.float32
                or t.shape != (rows,) or not t.is_contiguous()):
            raise ValueError(f"ls_xent_bwd_cuda: {name} must be contiguous "
                             f"float32 ({rows},) on {logits.device}")
    dlogits = torch.empty_like(logits)
    err = build.library().ls_xent_bwd(
        logits.data_ptr(), _DTYPES[logits.dtype], labels.data_ptr(),
        lse.data_ptr(), gout.data_ptr(), dlogits.data_ptr(), rows, vocab,
        smoothing, torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "ls_xent_bwd")
    ls_xent_bwd_cuda.launches += 1
    return dlogits


ls_xent_fwd_cuda.launches = 0
ls_xent_bwd_cuda.launches = 0


class LSXent(torch.autograd.Function):
    """Per-row smoothed NLL of (R, V) logits with a gradient for the logits."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing: float):
        if logits.is_cuda:
            loss, lse = ls_xent_fwd_cuda(logits, labels, smoothing)
        else:
            loss, lse = ref.ls_xent_fwd_ref(logits, labels, smoothing)
        ctx.save_for_backward(logits, labels, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, gout):
        logits, labels, lse = ctx.saved_tensors
        gout = gout.float().contiguous()
        if logits.is_cuda:
            d = ls_xent_bwd_cuda(logits, labels, lse, gout, ctx.smoothing)
        else:
            d = ref.ls_xent_bwd_ref(logits, labels, lse, gout, ctx.smoothing)
        return d, None, None
