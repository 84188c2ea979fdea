"""Plain Qwen3 decoder (hf:Qwen/Qwen3-1.7B's published architecture) in
float32, written from the model's description and the configuration file,
with no code of the program under test.

Per layer: x + attention(rmsnorm(x)), then x + SwiGLU(rmsnorm(x)). The
attention projects q (H heads), k and v (Hkv heads, grouped-query), applies
RMSNorm over each head's dims to q and k (qk-norm), then half-split RoPE
with base ``rope_theta`` at positions 0 .. S-1, and causal softmax attention
scaled by head_dim^-0.5; query head h reads kv head h // (H / Hkv). The MLP
is down(up(x) * silu(gate(x))). After a final RMSNorm the logits are x E^T
with E the tied embedding table. RMSNorm is x / sqrt(mean(x^2) + eps) times
(1 + w): the weights are handed over in the program's parametrisation,
where w starts at 0 (Hugging Face stores 1 + w).

It runs layer by layer: each layer under ``torch.utils.checkpoint`` (its
activations are recomputed in backward), and the head and the loss in
blocks of rows, so that the float32 step at the benchmark's sizes fits
beside nothing else on one card.

``q`` rounds the operands of every matrix product (the control's lower
precision, ``reference/fp8.py``); None keeps float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.train import smoothed_xent

FAMILY = "lm"
LOSS_ROWS = 1024     # rows of the head and the loss computed at once


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    m = cfg["model"]
    d, h, hkv, hd, f = (m["hidden_size"], m["num_attention_heads"], m["num_key_value_heads"],
                        m["head_dim"], m["intermediate_size"])
    out = {"embed.embedding": (m["vocab_size"], d), "final_norm.norm_scale": (d,)}
    for i in range(m["num_hidden_layers"]):
        pre = f"layers.{i}."
        out.update({pre + "pre_norm.norm_scale": (d,),
                    pre + "mixer.q.kernel": (d, h * hd), pre + "mixer.k.kernel": (d, hkv * hd),
                    pre + "mixer.v.kernel": (d, hkv * hd), pre + "mixer.o.kernel": (h * hd, d),
                    pre + "mixer.q_norm.norm_scale": (hd,), pre + "mixer.k_norm.norm_scale": (hd,),
                    pre + "mlp_norm.norm_scale": (d,), pre + "mlp.up.kernel": (d, f),
                    pre + "mlp.gate.kernel": (d, f), pre + "mlp.down.kernel": (f, d)})
    return out


def init_rule(name: str, shape) -> tuple[str, float]:
    """Embedding normal(0.02), matrices LeCun fan-in normal, norm weights 0
    (applied as 1 + w)."""
    if name.endswith("norm_scale"):
        return "const", 0.0
    if name == "embed.embedding":
        return "normal", 0.02
    return "normal", (1.0 / shape[0]) ** 0.5


def lars_groups(names, cfg: dict):
    """The reference's stacked leaves: a leaf of every layer is one LARS
    group (``layers.*.mixer.q.kernel``), the embedding and the final norm a
    group each: [(names, takes the trust ratio)]."""
    tags = cfg["recipe"]["lars"]["skip_tags"]
    groups: dict[str, list[str]] = {}
    for n in names:
        parts = n.split(".")
        key = "layers.*." + ".".join(parts[2:]) if parts[0] == "layers" else n
        groups.setdefault(key, []).append(n)
    return [(tuple(members), not any(t in key.replace(".", "/").lower() for t in tags))
            for key, members in groups.items()]


def _rms(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _mm(x, w, q):
    return q(x) @ q(w) if q is not None else x @ w


def _rope(x, theta: float):
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q_, k, v, q):
    """Causal GQA softmax attention; q_ (B, S, H, D), k/v (B, S, Hkv, D)."""
    B, S, H, D = q_.shape
    rep = H // k.shape[2]
    qt = q_.transpose(1, 2) * D ** -0.5
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    s = _mm(qt, kt.transpose(-1, -2), q)
    causal = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
    w = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    return _mm(w, vt, q).transpose(1, 2).reshape(B, S, H * D)


def _layer(x, lp: dict, m: dict, q):
    B, S, d = x.shape
    eps, hd = m["rms_norm_eps"], m["head_dim"]
    h = _rms(x, lp["pre_norm.norm_scale"], eps)
    qh = _mm(h, lp["mixer.q.kernel"], q).reshape(B, S, -1, hd)
    kh = _mm(h, lp["mixer.k.kernel"], q).reshape(B, S, -1, hd)
    vh = _mm(h, lp["mixer.v.kernel"], q).reshape(B, S, -1, hd)
    qh = _rope(_rms(qh, lp["mixer.q_norm.norm_scale"], eps), m["rope_theta"])
    kh = _rope(_rms(kh, lp["mixer.k_norm.norm_scale"], eps), m["rope_theta"])
    x = x + _mm(_attention(qh, kh, vh, q), lp["mixer.o.kernel"], q)
    h = _rms(x, lp["mlp_norm.norm_scale"], eps)
    h = _mm(h, lp["mlp.up.kernel"], q) * F.silu(_mm(h, lp["mlp.gate.kernel"], q))
    return x + _mm(h, lp["mlp.down.kernel"], q)


def _loss_rows(x, emb, labels, a: float, q):
    return smoothed_xent(_mm(x, emb.T, q), labels, a).sum()


def loss(p: dict, batch, cfg: dict, q=None) -> torch.Tensor:
    """The mean label-smoothed cross-entropy over every token of the batch
    (tokens (B, S), labels (B, S))."""
    m = cfg["model"]
    tokens, labels = batch
    emb = q(p["embed.embedding"]) if q is not None else p["embed.embedding"]
    x = emb[tokens]
    for i in range(m["num_hidden_layers"]):
        pre = f"layers.{i}."
        lp = {k[len(pre):]: t for k, t in p.items() if k.startswith(pre)}
        x = checkpoint(_layer, x, lp, m, q, use_reentrant=False)
    x = _rms(x, p["final_norm.norm_scale"], m["rms_norm_eps"]).reshape(-1, x.shape[-1])
    labels = labels.reshape(-1)
    a = cfg["recipe"]["label_smoothing"]
    total = sum(checkpoint(_loss_rows, x[r:r + LOSS_ROWS], p["embed.embedding"],
                           labels[r:r + LOSS_ROWS], a, q, use_reentrant=False)
                for r in range(0, x.shape[0], LOSS_ROWS))
    return total / x.shape[0]
