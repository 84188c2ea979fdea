"""Decoder stack of the transformer zoo, as ``repro/models/transformer.py``,
for the layer kinds ``attn`` (global causal self-attention) and ``local``
(sliding-window self-attention) with dense MLPs.

A model is a cycled ``pattern`` of layer kinds over ``n_layers``. The JAX
model scans stacked ``blocks`` after an unscanned ``prefix``; here the
layers are one ``nn.ModuleList`` in ``kinds()`` order, the same order
(``repro_torch.convert.transformer_from_jax`` unstacks a JAX tree).
Parameter names are the JAX paths with "." for "/", under ``layers.<i>``:
``layers.3.mixer.q.kernel``, ``embed.embedding``, ``final_norm.norm_scale``.

Three entry points take the parameters as a nested dict (``Transformer.tree``
or ``compute_params``):
    forward(params, tokens, cfg)                  -> (logits, aux)   (train)
    prefill(params, tokens, cfg)                  -> (last_logits, cache)
    decode_step(params, token, cache, index, cfg) -> (logits, cache)

The ``ssd``, ``rglru`` and ``cross`` kinds and MoE MLPs come in later
slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.nn import attention as A
from repro_torch.nn import init as winit
from repro_torch.nn import layers as L

_LATER = {
    "ssd": "the SSD mixer (nn/ssm.py), a later part of slice G",
    "rglru": "the RG-LRU mixer (nn/rglru.py), a later part of slice G",
    "cross": "cross-attention and the VLM/audio configs, a later part of slice G",
    "moe": "the MoE MLP (nn/moe.py), a later part of slice G",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    pattern: tuple[str, ...] = ("attn",)
    mlp: str = "dense"                   # dense | moe | none
    n_experts: int = 0
    top_k: int = 0
    first_dense: int = 0                 # leading layers forced dense-MLP
    act: str = "silu"
    gated_mlp: bool = True               # False: plain 2-matrix FFN (musicgen)
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    qk_norm: bool = False
    post_norm: bool = False              # gemma2 post-block norms
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    window: int | None = None
    rope_theta: float = 10000.0
    embed_scale: bool = False            # gemma: embeds * sqrt(d)
    tie_embeddings: bool = True
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_unroll: bool = False
    moe_capacity_factor: float = 1.25
    # The JAX model's attention chunking, remat and scan switches. The port
    # keeps them so that a JAX config carries over field for field, and
    # ``n_prefix``/``n_blocks`` (which follow ``scan_blocks``) say how a JAX
    # param tree is stacked; its attention is the flash kernel at any length.
    q_chunk: int = 1024
    q_chunk_unroll: bool = False
    cross_kv_dim: int | None = None
    vision_tokens: int = 0
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    scan_blocks: bool = True
    # citation / provenance
    source: str = ""

    # ------------------------------------------------------------------
    def kinds(self) -> tuple[str, ...]:
        return tuple(self.pattern[i % len(self.pattern)]
                     for i in range(self.n_layers))

    @property
    def n_prefix(self) -> int:
        if not self.scan_blocks:
            return self.n_layers
        rest = self.n_layers - self.first_dense
        return self.first_dense + rest % len(self.pattern)

    @property
    def n_blocks(self) -> int:
        return (self.n_layers - self.n_prefix) // len(self.pattern)

    def attn_cfg(self, kind: str) -> A.AttnConfig:
        if kind not in ("attn", "local"):
            raise NotImplementedError(f"layer kind {kind!r} comes with {_LATER[kind]}")
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, qk_norm=self.qk_norm,
            attn_softcap=self.attn_softcap,
            window=self.window if kind == "local" else None,
            query_scale=self.head_dim ** -0.5)

    def check_ported(self) -> None:
        """Raise for a layer kind or MLP this slice of the port lacks."""
        for kind in set(self.pattern):
            self.attn_cfg(kind)
        if self.mlp == "moe":
            raise NotImplementedError(f"mlp 'moe' comes with {_LATER['moe']}")

    def num_params(self) -> int:
        """Analytic parameter count (no allocation)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        total = v * d                                     # embedding
        if not self.tie_embeddings:
            total += v * d
        per_kind = {}
        o = self.n_heads * self.head_dim * d
        per_kind["attn"] = per_kind["local"] = d * self.n_heads * self.head_dim \
            + 2 * d * self.n_kv_heads * self.head_dim + o
        per_kind["cross"] = d * self.n_heads * self.head_dim + 2 * (
            (self.cross_kv_dim or d) * self.n_kv_heads * self.head_dim) + o
        d_inner = 2 * d                                   # SSDConfig.expand = 2
        per_kind["ssd"] = d * (2 * d_inner + 2 * self.ssm_state
                               + d_inner // self.ssm_head_dim) + d_inner * d
        per_kind["rglru"] = 5 * d * d                     # in x2, gates x2, out
        n_mats = 3 if self.gated_mlp else 2
        mlp_dense = n_mats * d * f
        mlp_moe = self.n_experts * 3 * d * f + d * self.n_experts
        mlp_moe_dense = 3 * d * f * max(self.top_k, 1)    # first_dense layers
        for i, k in enumerate(self.kinds()):
            total += per_kind[k]
            if self.mlp == "none":
                continue
            if self.mlp == "moe":
                total += mlp_moe if i >= self.first_dense else mlp_moe_dense
            else:
                total += mlp_dense
        return total


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(cfg: ArchConfig, device) -> nn.ParameterDict:
    return (L.rmsnorm_init(cfg.d_model, device) if cfg.norm == "rmsnorm"
            else L.layernorm_init(cfg.d_model, device))


def _norm(cfg: ArchConfig, p, x):
    if cfg.norm == "rmsnorm":
        return L.rmsnorm(x, p["norm_scale"])
    return L.layernorm(x, p["norm_scale"], p["norm_bias"])


def _layer_init(gen: torch.Generator, cfg: ArchConfig, kind: str) -> nn.ModuleDict:
    dev = gen.device
    p = nn.ModuleDict({"pre_norm": _norm_init(cfg, dev),
                       "mixer": A.attn_init(gen, cfg.attn_cfg(kind))})
    if cfg.post_norm:
        p["post_mixer_norm"] = _norm_init(cfg, dev)
    if cfg.mlp != "none":
        p["mlp_norm"] = _norm_init(cfg, dev)
        mlp = nn.ModuleDict({"up": L.dense_init(gen, cfg.d_model, cfg.d_ff),
                             "down": L.dense_init(gen, cfg.d_ff, cfg.d_model)})
        if cfg.gated_mlp:
            mlp["gate"] = L.dense_init(gen, cfg.d_model, cfg.d_ff)
        p["mlp"] = mlp
        if cfg.post_norm:
            p["post_mlp_norm"] = _norm_init(cfg, dev)
    return p


def _tree(module: nn.Module):
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    if isinstance(module, nn.ModuleList):
        return [_tree(m) for m in module]
    return {name: _tree(m) for name, m in module.named_children()}


class Transformer(nn.Module):
    """Holds the parameters; the entry points below compute with them."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        dev = gen.device
        self.embed = nn.ParameterDict(
            {"embedding": winit.normal(gen, (cfg.vocab, cfg.d_model), std=0.02)})
        self.final_norm = _norm_init(cfg, dev)
        self.layers = nn.ModuleList(_layer_init(gen, cfg, k) for k in cfg.kinds())
        if not cfg.tie_embeddings:
            self.unembed = nn.ParameterDict(
                {"kernel": winit.normal(gen, (cfg.d_model, cfg.vocab), std=0.02)})

    def tree(self) -> dict:
        """The parameters as the nested dict the entry points take (no copy)."""
        return _tree(self)


def init(cfg: ArchConfig, *, seed: int = 0, device=None) -> Transformer:
    """A model with fresh fp32 weights drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device_lib.resolve(device))
    gen.manual_seed(seed)
    return Transformer(cfg, gen)


def compute_params(params, dtype: torch.dtype) -> dict:
    """The tree with every matrix (``kernel``, ``embedding``) cast to the
    compute dtype once; norm scales stay fp32. The JAX model casts at each
    use, which gives the same values."""
    if isinstance(params, nn.Module):
        params = params.tree()
    if isinstance(params, dict):
        return {k: (L.cast(v, dtype) if k in ("kernel", "embedding")
                    else compute_params(v, dtype)) for k, v in params.items()}
    if isinstance(params, list):
        return [compute_params(v, dtype) for v in params]
    return params


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _mlp_block(p, x, cfg: ArchConfig):
    if cfg.mlp == "none":
        return x
    h = L.mlp(p["mlp"], _norm(cfg, p["mlp_norm"], x), act=cfg.act)
    if cfg.post_norm:
        h = _norm(cfg, p["post_mlp_norm"], h)
    return x + h


def _residual(p, x, h, cfg: ArchConfig):
    """x + (post-normed) mixer output, then the MLP block."""
    if cfg.post_norm:
        h = _norm(cfg, p["post_mixer_norm"], h)
    return _mlp_block(p, x + h, cfg)


def _apply_layer(p, x, cfg: ArchConfig, kind: str):
    h = A.self_attention(p["mixer"], _norm(cfg, p["pre_norm"], x), cfg.attn_cfg(kind))
    return _residual(p, x, h, cfg)


def _embed_in(params, cfg: ArchConfig, tokens):
    x = L.embed(params["embed"]["embedding"], tokens, cfg.compute_dtype)
    if cfg.embed_scale:
        x = x * A.weak(cfg.d_model ** 0.5, cfg.compute_dtype)
    return x


def _logits_out(params, cfg: ArchConfig, x):
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        logits = L.unembed(params["embed"]["embedding"], x)
    else:
        logits = L.dense(x, params["unembed"]["kernel"])
    logits = logits.float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _as_tree(params):
    return params.tree() if isinstance(params, nn.Module) else params


def forward(params, tokens: torch.Tensor, cfg: ArchConfig):
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux). aux is the MoE
    loss of the JAX model, 0 for the dense MLPs ported here.

    On the card the attention is the flash kernel, which has no backward
    yet: under autograd with weights that need gradients it raises, so
    call it under ``torch.no_grad()``. Training the transformer waits for
    a later slice; on the host the plain attention is differentiable."""
    params = _as_tree(params)
    x = _embed_in(params, cfg, tokens)
    for p, kind in zip(params["layers"], cfg.kinds()):
        x = _apply_layer(p, x, cfg, kind)
    return _logits_out(params, cfg, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_len(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    return cache_len if kind == "attn" else min(cfg.window, cache_len)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> list[dict]:
    """One {"k", "v"} per layer, in ``kinds()`` order; local layers hold
    ``min(window, cache_len)`` slots."""
    dev = device_lib.resolve(device)
    return [A.init_kv_cache(batch, _cache_len(cfg, kind, cache_len),
                            cfg.attn_cfg(kind), dtype, dev)
            for kind in cfg.kinds()]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, token: torch.Tensor, cache: list[dict], index: int,
                cfg: ArchConfig):
    """token: (B, 1) int; index: absolute position of the token. Writes the
    token's k/v into ``cache`` in place. Returns (logits (B, 1, V), cache)."""
    params = _as_tree(params)
    x = _embed_in(params, cfg, token)
    for p, c, kind in zip(params["layers"], cache, cfg.kinds()):
        h = _norm(cfg, p["pre_norm"], x)
        h, _ = A.decode_self_attention(p["mixer"], h, c, index, cfg.attn_cfg(kind))
        x = _residual(p, x, h, cfg)
    return _logits_out(params, cfg, x), cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, cfg: ArchConfig, *,
            cache_len: int | None = None, cache_dtype=torch.bfloat16):
    """Process the prompt; return (last-position logits (B, 1, V), cache).

    Each layer projects q, k and v once and uses them for both its cache and
    the flash kernel (the JAX model projects k and v twice, to the same
    values).
    """
    params = _as_tree(params)
    cache_len = cache_len or tokens.shape[1]
    x = _embed_in(params, cfg, tokens)
    positions = A._positions(x)
    cache = []
    for p, kind in zip(params["layers"], cfg.kinds()):
        acfg = cfg.attn_cfg(kind)
        h = _norm(cfg, p["pre_norm"], x)
        q, k, v = A._project_qkv(p["mixer"], h, acfg, positions)
        cache.append(A.kv_cache_layout(k, v, _cache_len(cfg, kind, cache_len),
                                       cache_dtype))
        x = _residual(p, x, A.attend(p["mixer"], q, k, v, acfg), cfg)
    return _logits_out(params, cfg, x[:, -1:]), cache
