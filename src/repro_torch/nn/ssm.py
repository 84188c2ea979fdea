"""Mamba-2 SSD block [arXiv:2405.21060] as ``repro/nn/ssm.py``: the chunked
state-space-duality form for prefill and training, the one-token recurrence
for decode. Plain PyTorch, as the reference is plain JAX.

The sequence is cut into chunks of length Q. Inside a chunk the output is a
masked (1-semiseparable) attention-like product; across chunks a recurrence
carries the (H, P, N) state. Decode is ``h = exp(dt*A) h + dt * B x``, O(1)
in the context length.

Parameters under the JAX package's names: ``in_proj.kernel`` (d, 2 d_inner
+ 2N + H) packing [z, x, B, C, dt], ``conv.kernel`` (W, d_inner + 2N),
``dt_bias``, ``A_log``, ``D`` (H,), ``out_norm.norm_scale`` (d_inner),
``out_proj.kernel`` (d_inner, d). One B/C group, shared by the heads.

Numerics kept from the reference:

- softplus as ``logaddexp(x, 0)``, which is ``jax.nn.softplus`` (PyTorch's
  ``F.softplus`` returns x itself above 20, a difference below 2e-9);
- the depthwise conv as the reference's W-tap sum in the compute dtype
  (``nn/layers.py:causal_conv``);
- the intra-chunk decay masked to -60 *before* ``exp``, where the upper
  triangle's positive exponents would overflow;
- zero dt on the padding to a multiple of the chunk: decay exp(0) = 1 and
  input 0, so the state passes the padding unchanged;
- the intra-chunk product contracts in two steps, so no temporary is
  larger than (B, chunks, H, Q, Q) fp32 (1.34 GB for mamba2-2.7b at B 8,
  S 2048): never (..., Q, Q, H, P).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import init as winit
from repro_torch.nn import layers as L
from repro_torch.utils import dtensor


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    dt_min: float = 1e-3
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssd_init(gen: torch.Generator, cfg: SSDConfig) -> nn.ModuleDict:
    di, N, H = cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = gen.device
    zxbcdt = 2 * di + 2 * N + H
    u = torch.rand(H, generator=gen, device=dev)
    dt = torch.exp(u * (math.log(cfg.dt_max) - math.log(cfg.dt_min)) + math.log(cfg.dt_min))
    p = nn.ModuleDict({
        "in_proj": nn.ParameterDict(
            {"kernel": winit.lecun_normal(gen, (cfg.d_model, zxbcdt))}),
        "conv": nn.ParameterDict({"kernel": winit.lecun_normal(
            gen, (cfg.conv_width, di + 2 * N), fan_in=cfg.conv_width)}),
        "out_norm": L.rmsnorm_init(di, dev),
        "out_proj": nn.ParameterDict({"kernel": winit.lecun_normal(gen, (di, cfg.d_model))}),
    })
    p.register_parameter("dt_bias", nn.Parameter(torch.log(torch.expm1(dt))))  # softplus^-1
    p.register_parameter("A_log", nn.Parameter(torch.log(
        torch.arange(1, H + 1, dtype=torch.float32, device=dev))))
    p.register_parameter("D", nn.Parameter(torch.ones(H, device=dev)))
    return p


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(p, u: torch.Tensor, cfg: SSDConfig):
    di, N = cfg.d_inner, cfg.d_state
    zxbcdt = L.dense(u, p["in_proj"]["kernel"])
    return torch.split(zxbcdt, [di, di + 2 * N, cfg.n_heads], dim=-1)


def _conv1d(p, xbc: torch.Tensor, state: torch.Tensor | None = None):
    """Causal depthwise conv of xbc (B, S, C) after ``state`` (B, W-1, C)
    when decoding. Returns (silu(y), new_state)."""
    y, new_state = L.causal_conv(xbc, p["conv"]["kernel"], state)
    return F.silu(y), new_state


def _ssd_chunked(x, dt, A, B_, C, cfg: SSDConfig, h0=None):
    """x: (B, S, H, P) in the compute dtype, dt: (B, S, H) fp32 (after
    softplus), A: (H,) negative, B_/C: (B, S, N). Returns (y (B, S, H, P)
    in x's dtype, h_final (B, H, P, N) fp32)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = min(cfg.chunk, S)
    pad = (-S) % Q
    if pad:
        # dt = 0 padding is exact: decay exp(0) = 1 (state frozen), input dt*x = 0
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (S + pad) // Q

    xa = (x * dt[..., None]).reshape(Bb, nc, Q, H, P).float()       # dt-weighted input
    a = (dt * A).reshape(Bb, nc, Q, H)                              # log decay a step
    Bc = B_.reshape(Bb, nc, Q, N)
    Cc = C.reshape(Bb, nc, Q, N)

    cum = torch.cumsum(a, dim=2)                                    # (B, nc, Q, H)
    # intra-chunk: L[h, i, j] = exp(cum_i - cum_j) for j <= i, masked before
    # exp; heads ahead of positions, so that each pass over these (B, nc, H,
    # Q, Q) temporaries and the batched matmul run on contiguous (Q, Q) blocks
    cum_h = cum.transpose(2, 3).contiguous()                        # (B, nc, H, Q)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    decay = torch.where(mask, cum_h[..., :, None] - cum_h[..., None, :], -60.0).exp_()
    qk = torch.einsum("bcin,bcjn->bcij", Cc, Bc).float()            # (B, nc, Q, Q)
    m = decay * qk[:, :, None]                                      # (B, nc, H, Q, Q)
    del decay
    y_intra = torch.matmul(m, xa.permute(0, 1, 3, 2, 4))            # (B, nc, H, Q, P)
    del m

    # chunk summaries: each chunk's contribution to the state at its end
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)                 # (B, nc, Q, H)
    chunk_state = torch.einsum("bcjn,bcjhp->bchpn", Bc.float(),
                               dec_to_end[..., None] * xa)
    chunk_decay = torch.exp(cum[:, :, -1, :])                       # (B, nc, H)

    # inter-chunk recurrence over the nc chunks
    h = (torch.zeros(Bb, H, P, N, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(h_prev, dim=1)                             # (B, nc, H, P, N)

    dec_from_start = torch.exp(cum)                                 # (B, nc, Q, H)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc.float(), h_prev) * dec_from_start[..., None]
    y = (y_intra.transpose(2, 3) + y_inter).reshape(Bb, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), h


def ssd_apply(p, u: torch.Tensor, cfg: SSDConfig, state: dict | None = None,
              return_state: bool = False):
    """Full-sequence SSD block. u: (B, S, d_model) -> (B, S, d_model), and
    the state {"ssm": fp32 (B, H, P, N), "conv": (B, W-1, d_inner + 2N) in
    u's dtype} with ``return_state``."""
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    xbc, new_conv = _conv1d(p, xbc, None if state is None else state["conv"])
    x, B_, C = torch.split(xbc, [di, N, N], dim=-1)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(*x.shape[:2], H, P)
    y, h = dtensor.batchwise(lambda xh, dt, B_, C, h0, A: _ssd_chunked(xh, dt, A, B_, C, cfg, h0),
                             xh, dt, B_, C, None if state is None else state["ssm"],
                             shared=(A,), what="ssd scan: heads")
    y = y + L.cast(p["D"], y.dtype)[:, None] * xh                   # skip
    y = y.reshape(*u.shape[:2], di)
    y = L.rmsnorm(y * F.silu(z), p["out_norm"]["norm_scale"])
    out = L.dense(y, p["out_proj"]["kernel"])
    if return_state:
        return out, {"ssm": h, "conv": new_conv}
    return out


def ssd_init_state(batch: int, cfg: SSDConfig, dtype=torch.float32, device=None) -> dict:
    return {
        "ssm": torch.zeros(batch, cfg.n_heads, cfg.head_dim, cfg.d_state,
                           dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.d_state,
                            dtype=dtype, device=device),
    }


def _ssd_step(xh, dt, b, c, h_prev, A):
    """One token's recurrence: xh (B, H, P), dt (B, H), b/c (B, N), h_prev
    (B, H, P, N) fp32 -> (y (B, H, P) fp32, h)."""
    decay = torch.exp(dt * A)                                       # (B, H)
    h = h_prev * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhpn", b.float(), dt[..., None] * xh.float())
    return torch.einsum("bn,bhpn->bhp", c.float(), h), h


def ssd_decode_step(p, u: torch.Tensor, state: dict, cfg: SSDConfig):
    """One-token recurrence. u: (B, 1, d_model). Returns (out, new state)."""
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    xbc, new_conv = _conv1d(p, xbc, state["conv"])
    x, B_, C = torch.split(xbc, [di, N, N], dim=-1)
    dt = _softplus(dt_raw.float() + p["dt_bias"])[:, 0]             # (B, H)
    A = -torch.exp(p["A_log"])
    xh = dtensor.split_dim(x[:, 0], -1, H, P)                      # (B, H, P)
    y, h = dtensor.batchwise(_ssd_step, xh, dt, B_[:, 0], C[:, 0], state["ssm"], shared=(A,),
                             what="ssd step: heads")
    y = y.to(u.dtype) + L.cast(p["D"], u.dtype)[:, None] * xh
    y = y.reshape(-1, 1, di)
    y = L.rmsnorm(y * F.silu(z), p["out_norm"]["norm_scale"])
    return L.dense(y, p["out_proj"]["kernel"]), {"ssm": h, "conv": new_conv}
