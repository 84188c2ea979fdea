"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) as
``repro/nn/rglru.py``: linear-in -> temporal conv (width 4) -> RG-LRU ->
gated linear-out. Plain PyTorch, as the reference is plain JAX.

The RG-LRU recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = a^(c * r_t)         with a = sigmoid(Lambda), c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as a log-depth scan (the reference's
``lax.associative_scan``; see ``_scan``), decode as the O(1) update. State
a layer: ``hidden`` (B, w) fp32 and ``conv`` (B, W-1, w), the conv's last
inputs, in the compute dtype.

Parameters under the JAX package's names: ``in_x.kernel``,
``in_gate.kernel`` (d, w), ``conv.kernel`` (W, w), ``rg_kernel``,
``ig_kernel`` (w, w), ``rg_bias``, ``ig_bias``, ``lambda_param`` (w,),
``out.kernel`` (w, d). Numerics kept from the reference:

- the gates' matmuls in fp32 on the fp32 ``rg_kernel``/``ig_kernel``
  (``models/transformer.py:compute_params`` casts only leaves named
  ``kernel``, so these stay fp32), ``log_sigmoid`` as ``F.logsigmoid``,
  ``beta = sqrt(clip(1 - a^2, 1e-12))``;
- the gelu of the gate branch is the tanh approximation (``jax.nn.gelu``);
- the 4-tap conv as the W-tap sum in the compute dtype
  (``nn/layers.py:causal_conv``), its tail copied out of the padded buffer.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import init as winit
from repro_torch.nn import layers as L
from repro_torch.utils import dtensor

# positions a chunk of the scan; its levels run over (B, S/CHUNK, CHUNK, w)
CHUNK = 16


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int | None = None          # default d_model
    conv_width: int = 4
    c: float = 8.0

    @property
    def width(self) -> int:
        return self.d_rnn or self.d_model


def rglru_init(gen: torch.Generator, cfg: RGLRUConfig) -> nn.ModuleDict:
    d, w, dev = cfg.d_model, cfg.width, gen.device
    # Lambda so that a = sigmoid(Lambda) lies in [0.9, 0.999]
    u = 0.9 + 0.099 * torch.rand(w, generator=gen, device=dev)
    p = nn.ModuleDict({
        "in_x": L.dense_init(gen, d, w),
        "in_gate": L.dense_init(gen, d, w),
        "conv": nn.ParameterDict({"kernel": winit.lecun_normal(
            gen, (cfg.conv_width, w), fan_in=cfg.conv_width)}),
        "out": L.dense_init(gen, w, d),
    })
    for name, value in (("rg_kernel", winit.normal(gen, (w, w), std=w ** -0.5)),
                        ("rg_bias", torch.zeros(w, device=dev)),
                        ("ig_kernel", winit.normal(gen, (w, w), std=w ** -0.5)),
                        ("ig_bias", torch.zeros(w, device=dev)),
                        ("lambda_param", torch.log(u / (1 - u)))):
        p.register_parameter(name, nn.Parameter(value))
    return p


def _gates(p, x: torch.Tensor, cfg: RGLRUConfig):
    """(a, beta * i * x), both (B, S, w) fp32. A DTensor ``x`` (the dry
    run) is made whole along w first, as the tensor-parallel program's
    column-parallel gates read it: each rank then computes its columns of
    the gates, sharded as the kernels' columns and the biases are."""
    xf = dtensor.unshard(x, -1).float()
    r = torch.sigmoid(xf @ p["rg_kernel"] + p["rg_bias"])
    i = torch.sigmoid(xf @ p["ig_kernel"] + p["ig_bias"])
    # sigmoid(L)^(c r)
    a = torch.exp(cfg.c * r * dtensor.elementwise(F.logsigmoid, p["lambda_param"]))
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * (i * xf)


def _hillis_steele(a: torch.Tensor, b: torch.Tensor, dim: int):
    """Inclusive scan of (a, b) o (a', b') = (a a', a' b + b') along ``dim``:
    log2(n) levels, each combining every element with the one 2^k before
    it. Returns (cumulative a, h). Out of place, so autograd runs through
    it (the forward's gradients on the host)."""
    n = a.shape[dim]
    d = 1
    while d < n:
        a_prev, b_prev = a.narrow(dim, 0, n - d), b.narrow(dim, 0, n - d)
        a_tail, b_tail = a.narrow(dim, d, n - d), b.narrow(dim, d, n - d)
        b = torch.cat([b.narrow(dim, 0, d), torch.addcmul(b_tail, a_tail, b_prev)], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_tail * a_prev], dim)
        d *= 2
    return a, b


def _scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over (B, S, w) fp32, from h_{-1} = ``h0``
    (zeros when None); returns h (B, S, w).

    Two levels, each a Hillis-Steele scan: inside chunks of ``CHUNK``
    positions (log2 CHUNK passes over the whole tensor), then over the
    chunks' totals (a tensor CHUNK times smaller), then one pass that
    carries each chunk's incoming state in: at S 2048, 4 passes over the
    whole tensor where one scan over S would take 11. The padding to a
    whole chunk is the identity, a = 1 and b = 0, after the last position.
    A carried state enters as the
    reference's prepended step (1, h0), already combined with step 0:
    b_0 <- a_0 h0 + b_0.
    """
    B, S, w = a.shape
    if h0 is not None:
        b = torch.cat([torch.addcmul(b[:, :1], a[:, :1], h0[:, None].float()), b[:, 1:]], 1)
    Q = min(CHUNK, S)
    pad = (-S) % Q
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, pad))
    nc = (S + pad) // Q
    a_in, h_in = _hillis_steele(a.reshape(B, nc, Q, w), b.reshape(B, nc, Q, w), 2)
    # the state at each chunk's end, then the state each chunk starts from
    _, h_end = _hillis_steele(a_in[:, :, -1], h_in[:, :, -1], 1)    # (B, nc, w)
    h_start = F.pad(h_end[:, :-1], (0, 0, 1, 0))
    h = torch.addcmul(h_in, a_in, h_start[:, :, None])
    return h.reshape(B, nc * Q, w)[:, :S]


def rglru_apply(p, u: torch.Tensor, cfg: RGLRUConfig, state: dict | None = None,
                return_state: bool = False):
    """Full-sequence RG-LRU block. u: (B, S, d_model) -> (B, S, d_model),
    and with ``return_state`` the state {"hidden": (B, w) fp32, "conv":
    (B, W-1, w) in u's dtype} after the last position. ``state`` carries a
    previous segment's state in."""
    x = L.dense(u, p["in_x"]["kernel"])
    gate = L.ACTS["gelu"](L.dense(u, p["in_gate"]["kernel"]))
    x, new_conv = L.causal_conv(x, p["conv"]["kernel"], None if state is None else state["conv"])
    a, bx = _gates(p, x, cfg)
    h0 = None if state is None else state["hidden"]
    # independent across the batch and the width: each rank's shards
    h = dtensor.elementwise(lambda a, b: _scan(a, b, h0), a, bx, whole=(1,))
    y = L.dense(h.to(u.dtype) * gate, p["out"]["kernel"])
    if return_state:
        return y, {"hidden": h[:, -1].contiguous(), "conv": new_conv}
    return y


def rglru_init_state(batch: int, cfg: RGLRUConfig, dtype=torch.bfloat16,
                     device=None) -> dict:
    return {"hidden": torch.zeros(batch, cfg.width, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, cfg.conv_width - 1, cfg.width, dtype=dtype,
                                device=device)}


def rglru_decode_step(p, u: torch.Tensor, state: dict, cfg: RGLRUConfig):
    """One-token update. u: (B, 1, d_model). Returns (out, new state)."""
    x = L.dense(u, p["in_x"]["kernel"])
    gate = L.ACTS["gelu"](L.dense(u, p["in_gate"]["kernel"]))
    x, new_conv = L.causal_conv(x, p["conv"]["kernel"], state["conv"])
    a, bx = _gates(p, x, cfg)
    h = a[:, 0] * state["hidden"].float() + bx[:, 0]
    y = L.dense(h[:, None].to(u.dtype) * gate, p["out"]["kernel"])
    return y, {"hidden": h, "conv": new_conv}
