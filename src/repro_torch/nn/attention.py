"""Attention as ``repro/nn/attention.py``: GQA/MQA/MHA, RoPE, qk-norm,
logit softcap, sliding window, cross-attention (the VLM's text queries over
vision keys), and cached decode with a rolling buffer for local
(sliding-window) layers.

Full-sequence self-attention (training forward and prefill) goes through
``kernels.ops.flash_attention``: the hand-written CUDA kernels on the card
(the forward, and under autograd the backward kernel as its gradient), its
plain version on the host. That replaces both the JAX package's
``_sdpa`` branch and its query-chunked branch, which compute the same
function; a cross layer runs it unmasked (``causal=False``) over the
vision tokens. One-token decode uses the plain ``_sdpa``, as the JAX
package's decode is an einsum outside any Pallas kernel.

Parameters come as the model's tree: ``{"q", "k", "v", "o"}: {"kernel":
(in, out)}`` plus ``{"q_norm", "k_norm"}: {"norm_scale"}`` with qk-norm.
The caches are updated in place (the JAX package returns new arrays): a
full-width cache is gigabytes, and a copy a token would move all of it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.nn import layers as L
from repro_torch.utils import dtensor


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    attn_softcap: float | None = None       # gemma2: 50.0
    window: int | None = None               # sliding-window size (local attn)
    query_scale: float | None = None        # default 1/sqrt(head_dim)
    cross_kv_dim: int | None = None         # cross-attn source dim (VLM)

    @property
    def scale(self) -> float:
        return self.query_scale if self.query_scale is not None else self.head_dim ** -0.5


def weak(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar (a weak
    type) to the array's dtype before an op; torch would keep it in fp32."""
    return torch.tensor(value, dtype=dtype).item()


# ------------------------------------------------------------------ RoPE --

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (..., S, H, D); positions: (..., S).

    Frequencies and angles in fp32; sin and cos are cast to x's dtype before
    the multiply, as the JAX package does.
    """
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None, None].float() * freq
    sin, cos = torch.sin(ang).to(x.dtype), torch.cos(ang).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------------------ init --

def attn_init(gen: torch.Generator, cfg: AttnConfig) -> nn.ModuleDict:
    hd, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    kv_in = cfg.cross_kv_dim or cfg.d_model

    p = nn.ModuleDict({"q": L.dense_init(gen, cfg.d_model, h * hd),
                       "k": L.dense_init(gen, kv_in, hkv * hd),
                       "v": L.dense_init(gen, kv_in, hkv * hd),
                       "o": L.dense_init(gen, h * hd, cfg.d_model)})
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, gen.device)
        p["k_norm"] = L.rmsnorm_init(hd, gen.device)
    return p


def _project_qkv(p, x, cfg: AttnConfig, positions=None, kv_src=None):
    """q of x (B, S, d), k and v of ``kv_src`` (x when None): projections,
    qk-norm, then RoPE at ``positions`` (B, S) for self-attention. A cross
    layer passes ``kv_src`` (B, Skv, cross_kv_dim), cast to x's dtype, and
    no positions: no RoPE on either side (the JAX package's
    ``_project_qkv`` with ``use_rope=False``)."""
    kv = x if kv_src is None else kv_src.to(x.dtype)
    q = dtensor.split_dim(L.dense(x, p["q"]["kernel"]), -1, cfg.n_heads, cfg.head_dim)
    k = dtensor.split_dim(L.dense(kv, p["k"]["kernel"]), -1, cfg.n_kv_heads, cfg.head_dim)
    v = dtensor.split_dim(L.dense(kv, p["v"]["kernel"]), -1, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"]["norm_scale"])
        k = L.rmsnorm(k, p["k_norm"]["norm_scale"])
    if kv_src is not None:
        return q, k, v
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def _sdpa(q, k, v, mask, cfg: AttnConfig):
    """Plain GQA attention with the JAX package's casts. q: (B, Sq, H, D),
    k/v: (B, Skv, Hkv, D), mask: (B, Sq, Skv) bool -> (B, Sq, H*D).

    The logits come from an einsum in the promoted type of q and k (bf16 in
    bf16 compute) and go to fp32 for the masked softmax; its weights go back
    to q's dtype before the product with v. DTensors (the dry run): each
    rank's sequences and query heads (``dtensor.headwise``).
    """
    B, Sq, H, D = q.shape
    out = dtensor.headwise(lambda q, k, v, mask: _sdpa_heads(q, k, v, mask, cfg.scale,
                                                             cfg.attn_softcap), q, k, v, mask)
    return out.reshape(B, Sq, H * D)


def _sdpa_heads(q, k, v, mask, scale: float, softcap: float | None):
    """``_sdpa`` over the heads given, (B, Sq, H, D) out; GQA groups from the
    shapes."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqkgd,bskd->bkgqs", (qg * weak(scale, q.dtype)).to(dt),
                          k.to(dt))
    if softcap:
        c = weak(softcap, dt)
        logits = c * torch.tanh(logits / c)
    logits = torch.where(mask[:, None, None], logits.float(), NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(w.dtype, v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(dt), v.to(dt))
    return out.reshape(B, Sq, H, D)


def causal_mask(sq: int, skv: int, q_offset: int = 0, window: int | None = None,
                device=None) -> torch.Tensor:
    """(sq, skv) bool mask; True = attend. q position i attends kv j iff
    j <= i+offset and (no window or j > i+offset-window)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


# --------------------------------------------------------------- forward --

def attend(p, q, k, v, cfg: AttnConfig, causal: bool = True) -> torch.Tensor:
    """Attention of projected q, k, v (causal and windowed as ``cfg`` says,
    or unmasked) and the output projection: the flash kernel on the card,
    its plain version on the host."""
    out = ops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                              softcap=cfg.attn_softcap, scale=cfg.scale)
    return L.dense(dtensor.merge_heads(out), p["o"]["kernel"])


def self_attention(p, x, cfg: AttnConfig):
    """Full-sequence (training / prefill) self-attention of x (B, S, d)."""
    q, k, v = _project_qkv(p, x, cfg, _positions(x))
    return attend(p, q, k, v, cfg)


def cross_attention(p, x, kv_src, cfg: AttnConfig):
    """Cross-attention (VLM): queries from x (B, S, d), keys and values
    from ``kv_src`` (B, Skv, cross_kv_dim); no mask, no RoPE."""
    q, k, v = _project_qkv(p, x, cfg, kv_src=kv_src)
    return attend(p, q, k, v, cfg, causal=False)


# ---------------------------------------------------------------- decode --

def init_kv_cache(batch: int, cache_len: int, cfg: AttnConfig,
                  dtype=torch.bfloat16, device=None) -> dict:
    """cache_len: full seq for global layers, ``window`` for local layers."""
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(p, x, cache: dict, index: int, cfg: AttnConfig):
    """One-token decode. x: (B, 1, d); ``index``: absolute position of the
    new token. Local layers use a rolling buffer: slot = index % cache_len.
    Writes the new k/v into ``cache`` in place; returns (out, cache)."""
    B = x.shape[0]
    cache_len = cache["k"].shape[1]
    positions = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    slot = index % cache_len if cfg.window is not None else index
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    kv_pos = torch.arange(cache_len, device=x.device)[None, :]
    if cfg.window is not None:
        # rolling buffer: absolute position of slot s
        wrap = (index // cache_len) * cache_len
        abs_pos = torch.where(kv_pos <= slot, wrap + kv_pos, wrap - cache_len + kv_pos)
        valid = ((abs_pos <= index) & (abs_pos > index - min(cfg.window, cache_len))
                 & (abs_pos >= 0))
    else:
        valid = kv_pos <= index
    mask = valid.expand(B, cache_len)[:, None, :]
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg)
    return L.dense(out, p["o"]["kernel"]), cache


def decode_cross_attention(p, x, cache: dict, cfg: AttnConfig) -> torch.Tensor:
    """One-token cross-attention over the prefilled vision cache {"k", "v"}
    (B, Skv, Hkv, D), which stays as it is (the reference's
    ``models/transformer.py:_decode_cross``). x: (B, 1, d) -> (B, 1, d)."""
    B = x.shape[0]
    q = L.dense(x, p["q"]["kernel"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"]["norm_scale"])
    mask = torch.ones((B, 1, cache["k"].shape[1]), dtype=torch.bool, device=x.device)
    out = _sdpa(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), mask, cfg)
    return L.dense(out, p["o"]["kernel"])


def kv_cache_layout(k: torch.Tensor, v: torch.Tensor, cache_len: int,
                    dtype=torch.bfloat16) -> dict:
    """The cache of a prompt's projected k/v (B, S, Hkv, D): zero-padded to
    ``cache_len``, or, when the prompt is longer (local layers), its last
    ``cache_len`` positions rolled so that position t sits at slot
    t % cache_len."""
    S = k.shape[1]

    def layout(t):
        if cache_len >= S:
            t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, cache_len - S))
        else:
            start = S - cache_len
            t = torch.roll(t[:, start:], start % cache_len, dims=1)
        return t.to(dtype).contiguous()
    # DTensors (the dry run): each rank's rows; some versions have no rule
    # for roll, or fail the pad
    return {n: dtensor.batchwise(layout, t, what="kv cache layout: heads")
            for n, t in (("k", k), ("v", v))}


def prefill_kv_cache(p, x, cfg: AttnConfig, cache_len: int,
                     dtype=torch.bfloat16) -> dict:
    """Run projections over the prompt and build the cache (last
    ``cache_len`` positions for local layers)."""
    _, k, v = _project_qkv(p, x, cfg, _positions(x))
    return kv_cache_layout(k, v, cache_len, dtype)
