"""Wrappers of the flash-attention kernels: the two forwards and the backward.

Replace ``repro/kernels/flash_attn.py`` (Pallas). Two kernels, picked by
dtype with no fallback between them, both wgmma on the tensor cores: bf16
goes to ``csrc/flash_attn_tc.cu`` (P rounded to bf16 before P . V), fp32 to
``csrc/flash_attn.cu`` (3xTF32: each operand split into a TF32 high part
and a TF32 remainder, each product taken as hi.hi + hi.lo + lo.hi, so the
result holds fp32's tolerance).
The JAX wrapper pads S and Skv to 128, folds (B, H) and repeats the kv heads
in memory; both kernels take the (B, S, H, D) layout as it is, mask the
ragged edge themselves and read kv head ``h // (H // Hkv)`` in place of a
repeat, so these wrappers only check and launch.

Training: ``FlashAttention`` (a ``torch.autograd.Function``) launches the
forward with each row's logsumexp (``lse``, (B, H, S) fp32) and saves q, k,
v, o and lse; its backward launches three kernels (D = rowsum(dO * o), then
dK/dV, then dQ): bf16 ``csrc/flash_attn_bwd.cu`` (wgmma with TMA at every
head dim), fp32 ``csrc/flash_attn_bwd_f32.cu`` (3xTF32 on wgmma up to D
128, FMAs at D 256), counted once a call by ``flash_attention_bwd_bf16``
or ``flash_attention_bwd_f32``.
Without autograd the forward skips lse.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

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
                         softcap: float | None = None, scale: float | None = None,
                         return_lse: bool = False):
    """Attention forward on the card; returns (B, S, H, D) in q's dtype,
    and with ``return_lse`` also each row's logsumexp, (B, H, S) fp32.

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D) with H % Hkv == 0; one dtype,
    contiguous, on one CUDA device. bf16 launches the tensor-core kernel,
    fp32 the fp32 kernel; any other dtype raises.
    """
    if q.dtype == torch.bfloat16:
        fn = flash_attention_tc
    elif q.dtype == torch.float32:
        fn = flash_attention_f32
    else:
        raise TypeError(f"flash_attention_cuda: q must be float32 or bfloat16, got {q.dtype}")
    return fn(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
              return_lse=return_lse)


def _check(fn_name: str, dtype: torch.dtype, window, **tensors) -> None:
    """Raise on anything the kernels do not take; q, k, v (and their
    like-shaped companions) must be one dtype, contiguous, on one card."""
    q = tensors["q"]
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{fn_name}: {name} must be on one CUDA "
                             f"device with q, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn_name}: q, k, v must be {dtype}, got {name} {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be a contiguous, "
                             f"16-byte aligned 4-d tensor")
    k, v = tensors["k"], tensors["v"]
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"{fn_name}: want q (B, S, H, D) and k, v "
                         f"(B, Skv, Hkv, D) with H % Hkv == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for name in ("o", "dout"):
        if name in tensors and tensors[name].shape != q.shape:
            raise ValueError(f"{fn_name}: {name} must have q's shape {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn_name}: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{fn_name}: window must be >= 1, got {window}")
    check_every_row_attends(S, Skv, window)


def _launch(fn_name: str, dtype: torch.dtype, q, k, v, causal, window, softcap,
            scale, return_lse):
    _check(fn_name, dtype, window, q=q, k=k, v=v)
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = getattr(build.library(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        B, H, Hkv, S, Skv, D, scale, int(causal),
        -1 if window is None else int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, fn_name)
    return (o, lse) if return_lse else o


def flash_attention_tc(q, k, v, *, causal=True, window=None, softcap=None,
                       scale=None, return_lse=False):
    """bf16 attention forward on the tensor cores (``csrc/flash_attn_tc.cu``)."""
    out = _launch("flash_attn_tc_fwd", torch.bfloat16, q, k, v, causal, window,
                  softcap, scale, return_lse)
    flash_attention_tc.launches += 1
    return out


def flash_attention_f32(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None, return_lse=False):
    """fp32 attention forward on the tensor cores in 3xTF32 (``csrc/flash_attn.cu``)."""
    out = _launch("flash_attn_fwd", torch.float32, q, k, v, causal, window,
                  softcap, scale, return_lse)
    flash_attention_f32.launches += 1
    return out


def flash_attention_bwd_cuda(q, k, v, o, lse, dout, *, causal=True, window=None,
                             softcap=None, scale=None):
    """(dq, dk, dv) of the flash forward on the card (``csrc/flash_attn_bwd.cu``,
    ``csrc/flash_attn_bwd_f32.cu``), in the inputs' dtype: q, o, dout (B, S, H, D), k, v (B, Skv, Hkv, D),
    lse (B, H, S) fp32 as the forward wrote it. Picks the bf16 or the fp32
    instance by dtype."""
    if q.dtype == torch.bfloat16:
        fn = flash_attention_bwd_bf16
    elif q.dtype == torch.float32:
        fn = flash_attention_bwd_f32
    else:
        raise TypeError(f"flash_attention_bwd_cuda: q must be float32 or bfloat16, "
                        f"got {q.dtype}")
    return fn(q, k, v, o, lse, dout, causal=causal, window=window, softcap=softcap,
              scale=scale)


def _launch_bwd(dtype, q, k, v, o, lse, dout, causal, window, softcap, scale):
    _check("flash_attn_bwd", dtype, window, q=q, k=k, v=v, o=o, dout=dout)
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if (lse.dtype != torch.float32 or lse.shape != (B, H, S) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"flash_attn_bwd: lse must be contiguous fp32 (B, H, S) = "
                         f"{(B, H, S)} on {q.device}, got {lse.dtype} {tuple(lse.shape)}")
    scale = D ** -0.5 if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # D_i and the kernels' copy of lse, rows padded to a multiple of 128
    sp = -(-S // 128) * 128
    scratch = torch.empty(2 * B * H * sp, dtype=torch.float32, device=q.device)
    name = "flash_attn_bwd" if dtype == torch.bfloat16 else "flash_attn_bwd_f32"
    err = getattr(build.library(), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Hkv, S, Skv, D, scale, int(causal), -1 if window is None else int(window),
        float(softcap or 0.0), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    return dq, dk, dv


def flash_attention_bwd_bf16(q, k, v, o, lse, dout, *, causal=True, window=None,
                             softcap=None, scale=None):
    """The backward on bf16 tensors (``csrc/flash_attn_bwd.cu``: wgmma with
    TMA at every head dim; a call is one count)."""
    out = _launch_bwd(torch.bfloat16, q, k, v, o, lse, dout, causal, window, softcap,
                      scale)
    flash_attention_bwd_bf16.launches += 1
    return out


def flash_attention_bwd_f32(q, k, v, o, lse, dout, *, causal=True, window=None,
                            softcap=None, scale=None):
    """The backward on fp32 tensors (``csrc/flash_attn_bwd_f32.cu``: 3xTF32 on
    wgmma up to D 128, fp32 FMAs at D 256; a call is one count)."""
    out = _launch_bwd(torch.float32, q, k, v, o, lse, dout, causal, window, softcap,
                      scale)
    flash_attention_bwd_f32.launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """The flash forward on the card with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      softcap=softcap, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None


flash_attention_tc.launches = 0
flash_attention_f32.launches = 0
flash_attention_bwd_bf16.launches = 0
flash_attention_bwd_f32.launches = 0
