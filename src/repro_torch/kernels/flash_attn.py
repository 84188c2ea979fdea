"""Wrappers of the flash-attention forward kernels.

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

Both kernels are forwards only: there is no backward kernel yet, so the
wrappers refuse inputs that autograd tracks rather than return an output
with no gradient. Training through it waits for a later slice.
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
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Attention forward on the card; returns (B, S, H, D) in q's dtype.

    q: (B, S, H, D); k/v: (B, Skv, Hkv, D) with H % Hkv == 0; one dtype,
    contiguous, on one CUDA device. bf16 launches the tensor-core kernel,
    fp32 the fp32 kernel; any other dtype raises.
    """
    if q.dtype == torch.bfloat16:
        return flash_attention_tc(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    if q.dtype == torch.float32:
        return flash_attention_f32(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    raise TypeError(f"flash_attention_cuda: q must be float32 or bfloat16, got {q.dtype}")


def _launch(fn_name: str, dtype: torch.dtype, q, k, v, causal, window, softcap,
            scale) -> torch.Tensor:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{fn_name}: {name} must be on one CUDA "
                             f"device with q, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{fn_name}: q, k, v must be {dtype}, got {name} {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be a contiguous, "
                             f"16-byte aligned 4-d tensor")
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"{fn_name}: want q (B, S, H, D) and k, v "
                         f"(B, Skv, Hkv, D) with H % Hkv == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(f"{fn_name}: the kernel has no backward; call it "
                           "under torch.no_grad() or torch.inference_mode()")
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn_name}: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"{fn_name}: window must be >= 1, got {window}")
    check_every_row_attends(S, Skv, window)
    scale = D ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    err = getattr(build.library(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, Hkv, S, Skv, D, scale, int(causal),
        -1 if window is None else int(window), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, fn_name)
    return o


def flash_attention_tc(q, k, v, *, causal=True, window=None, softcap=None,
                       scale=None) -> torch.Tensor:
    """bf16 attention forward on the tensor cores (``csrc/flash_attn_tc.cu``)."""
    o = _launch("flash_attn_tc_fwd", torch.bfloat16, q, k, v, causal, window,
                softcap, scale)
    flash_attention_tc.launches += 1
    return o


def flash_attention_f32(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None) -> torch.Tensor:
    """fp32 attention forward on the tensor cores in 3xTF32 (``csrc/flash_attn.cu``)."""
    o = _launch("flash_attn_fwd", torch.float32, q, k, v, causal, window,
                softcap, scale)
    flash_attention_f32.launches += 1
    return o


flash_attention_tc.launches = 0
flash_attention_f32.launches = 0
