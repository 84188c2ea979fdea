"""Wrapper of the flash-attention forward kernel (``csrc/flash_attn.cu``).

Replaces ``repro/kernels/flash_attn.py`` (Pallas). The JAX wrapper pads S
and Skv to 128, folds (B, H) and repeats the kv heads in memory; the CUDA
kernel takes the (B, S, H, D) layout as it is, masks the ragged edge itself
and reads kv head ``h // (H // Hkv)`` in place of a repeat, so this wrapper
only checks and launches.

The kernel is a forward only: there is no backward kernel yet, so the
wrapper refuses inputs that autograd tracks rather than return an output
with no gradient. Training through it waits for a later slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)


def check_every_row_attends(S: int, Skv: int, window: int | None) -> None:
    """Raise when some query row has no key to attend.

    That happens iff a window is set and S >= Skv + window (row S - 1 then
    lies a window past the last key, causal or not). The plain version
    gives such a row the mean of v (a softmax over all-masked logits), the
    kernel gives 0, and the model never asks for it (prefill has S == Skv).
    """
    if window is not None and S >= Skv + window:
        raise ValueError(f"flash_attention: with window {window}, query rows past "
                         f"{Skv + window - 1} have no key among {Skv}; got S = {S}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Attention forward on the card; returns (B, S, H, D) in q's dtype.

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D) with H % Hkv == 0; one dtype
    (fp32 or bf16), contiguous, on one CUDA device.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} must be on one CUDA "
                             f"device with q, got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_cuda: q, k, v must share float32 "
                            f"or bfloat16, got {name} {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be a contiguous, "
                             f"16-byte aligned 4-d tensor")
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention_cuda: want q (B, S, H, D) and k, v "
                         f"(B, Skv, Hkv, D) with H % Hkv == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("flash_attention_cuda: the kernel has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window must be >= 1, got {window}")
    check_every_row_attends(S, Skv, window)
    scale = D ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    err = build.library().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
        B, H, Hkv, S, Skv, D, scale, int(causal),
        -1 if window is None else int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
