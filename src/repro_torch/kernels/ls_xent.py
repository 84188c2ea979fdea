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

from repro_torch.kernels import build, ref, traffic

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(logits: torch.Tensor, labels: torch.Tensor, threads: int, what: str):
    if threads not in ROW_THREADS:
        raise ValueError(f"{what}: threads a row must be one of {ROW_THREADS}, got {threads}")
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


# Threads a row (csrc/ls_xent.cu): 32 is a warp a row, 4 rows a block; more
# is a block a row. Only the mappings that the two shapes which run take:
# the ResNet-50 head's (32 | 64, 1000) fp32 and Qwen3-1.7B's (4096, 151936)
# fp32 and bf16 logits. Set from ``python3 -m repro_torch.launch.profile_xent
# --sweep`` on an H100 (PERF.md), by the row's count of 16-byte vectors:
# - forward: a warp while the row is at most 256 vectors (4 KB: the ResNet-50
#   head), so all of its loads go out at once and the merge needs no shared
#   memory; a block of 512 threads above;
# - backward: 512 threads for fp32 rows of 2048 vectors (32 KB) and more,
#   128 otherwise (a warp a row was 1 µs slower at the ResNet-50 head, and
#   512 threads 1.4x slower than 128 on bf16 rows of Qwen3-1.7B's vocab).
ROW_THREADS = (32, 128, 512)   # what the kernels take


def row_threads(vocab: int, elem_size: int, backward: bool = False) -> int:
    """Threads given to each row of ``vocab`` elements of ``elem_size`` bytes."""
    nvec = vocab * elem_size // 16
    if not backward:
        return 32 if nvec <= 256 else 512
    return 512 if elem_size == 4 and nvec >= 2048 else 128


def _empty_at_offset_of(logits: torch.Tensor) -> torch.Tensor:
    """``empty_like(logits)`` at the same offset from a 16-byte boundary, so
    the backward's load and store vectors line up."""
    mis = logits.data_ptr() % 16
    if mis == 0:
        return torch.empty_like(logits)
    n, esize = logits.numel(), logits.element_size()
    buf = torch.empty(n + 16 // esize, dtype=logits.dtype, device=logits.device)
    off = (mis - buf.data_ptr() % 16) % 16 // esize
    return buf[off:off + n].view(logits.shape)


def _fwd_launch(logits: torch.Tensor, labels: torch.Tensor, smoothing: float,
                threads: int):
    """``ls_xent_fwd_cuda`` with ``threads`` a row (one of ``ROW_THREADS``);
    called with another mapping than ``row_threads``'s only by the sweep and
    the card tests."""
    labels = _check(logits, labels, threads, "ls_xent_fwd_cuda")
    rows, vocab = logits.shape
    loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lse = torch.empty(rows, dtype=torch.float32, device=logits.device)
    err = build.library().ls_xent_fwd(
        logits.data_ptr(), _DTYPES[logits.dtype], labels.data_ptr(),
        loss.data_ptr(), lse.data_ptr(), rows, vocab, smoothing, threads,
        torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "ls_xent_fwd")
    ls_xent_fwd_cuda.launches += 1
    return loss, lse


def ls_xent_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                     smoothing: float):
    """Per-row (loss, lse), fp32, from (R, V) logits on the card."""
    return _fwd_launch(logits, labels, smoothing,
                       row_threads(logits.shape[-1], logits.element_size()))


def _bwd_launch(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                gout: torch.Tensor, smoothing: float, threads: int) -> torch.Tensor:
    """``ls_xent_bwd_cuda`` with ``threads`` a row, as ``_fwd_launch``."""
    labels = _check(logits, labels, threads, "ls_xent_bwd_cuda")
    rows, vocab = logits.shape
    for name, t in (("lse", lse), ("gout", gout)):
        if (t.device != logits.device or t.dtype != torch.float32
                or t.shape != (rows,) or not t.is_contiguous()):
            raise ValueError(f"ls_xent_bwd_cuda: {name} must be contiguous "
                             f"float32 ({rows},) on {logits.device}")
    dlogits = _empty_at_offset_of(logits)
    err = build.library().ls_xent_bwd(
        logits.data_ptr(), _DTYPES[logits.dtype], labels.data_ptr(),
        lse.data_ptr(), gout.data_ptr(), dlogits.data_ptr(), rows, vocab,
        smoothing, threads, torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "ls_xent_bwd")
    ls_xent_bwd_cuda.launches += 1
    return dlogits


def ls_xent_bwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, gout: torch.Tensor,
                     smoothing: float) -> torch.Tensor:
    """dlogits, in logits' dtype, from the forward's lse and the row grads."""
    return _bwd_launch(logits, labels, lse, gout, smoothing,
                       row_threads(logits.shape[-1], logits.element_size(), backward=True))


ls_xent_fwd_cuda.launches = 0
ls_xent_bwd_cuda.launches = 0


class LSXent(torch.autograd.Function):
    """Per-row smoothed NLL of (R, V) logits with a gradient for the logits."""

    @staticmethod
    def forward(ctx, logits, labels, smoothing: float):
        if logits.is_cuda:
            loss, lse = ls_xent_fwd_cuda(logits, labels, smoothing)
        else:
            with traffic.as_kernel("ls_xent_fwd") as io:
                loss, lse = ref.ls_xent_fwd_ref(logits, labels, smoothing)
                io(logits, labels, loss, lse)
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
            with traffic.as_kernel("ls_xent_bwd") as io:
                d = ref.ls_xent_bwd_ref(logits, labels, lse, gout, ctx.smoothing)
                io(logits, labels, lse, gout, d)
        return d, None, None
