"""Wrapper of the fused LARS kernel (``csrc/lars_update.cu``).

Replaces ``repro/kernels/lars_update.py`` (Pallas). The norms and the trust
ratio are computed outside the kernel, on the device, as the JAX wrapper
does (``kernels/ref.py::lars_trust``); the kernel reads the trust ratio
through a pointer and does the elementwise update in one pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def lars_update_cuda(p: torch.Tensor, g: torch.Tensor, v: torch.Tensor,
                     trust: torch.Tensor, *, lr: float, mom: float,
                     weight_decay: float, nesterov: bool = False):
    """Launch the LARS kernel on fp32 CUDA tensors; returns ``(p', v')``.

    ``trust`` is a one-element fp32 tensor on the same device.
    """
    for name, t in (("p", p), ("g", g), ("v", v), ("trust", trust)):
        if not t.is_cuda or t.device != p.device:
            raise ValueError(f"lars_update_cuda: {name} must be on {p.device}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"lars_update_cuda: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"lars_update_cuda: {name} must be contiguous")
    if g.shape != p.shape or v.shape != p.shape:
        raise ValueError(f"lars_update_cuda: shapes differ: p {tuple(p.shape)}, "
                         f"g {tuple(g.shape)}, v {tuple(v.shape)}")
    if trust.numel() != 1:
        raise ValueError("lars_update_cuda: trust must hold one element")
    lib = build.library()
    p_out = torch.empty_like(p)
    v_out = torch.empty_like(v)
    err = lib.lars_update_f32(
        p.data_ptr(), g.data_ptr(), v.data_ptr(), p_out.data_ptr(),
        v_out.data_ptr(), trust.data_ptr(), lr, mom, weight_decay,
        p.numel(), int(nesterov), torch.cuda.current_stream(p.device).cuda_stream)
    build.check(err, "lars_update_f32")
    lars_update_cuda.launches += 1
    return p_out, v_out


lars_update_cuda.launches = 0
