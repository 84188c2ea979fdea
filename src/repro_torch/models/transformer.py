"""Decoder stack of the transformer zoo, as ``repro/models/transformer.py``,
for every layer kind of the reference: ``attn`` (global causal
self-attention), ``local`` (sliding-window self-attention), ``cross``
(cross-attention to vision embeddings, the VLM), ``ssd`` (the Mamba-2
block, ``nn/ssm.py``) and ``rglru`` (the RG-LRU block, ``nn/rglru.py``),
with dense or MoE (``nn/moe.py``) MLPs or none.

A model is a cycled ``pattern`` of layer kinds over ``n_layers``. The JAX
model scans stacked ``blocks`` after an unscanned ``prefix``; here the
layers are one ``nn.ModuleList`` in ``kinds()`` order, the same order
(``repro_torch.convert.transformer_from_jax`` unstacks a JAX tree).
Parameter names are the JAX paths with "." for "/", under ``layers.<i>``:
``layers.3.mixer.q.kernel``, ``layers.1.mlp.experts.up``,
``embed.embedding``, ``final_norm.norm_scale``. A layer's cache is
``{"k", "v"}`` for attention (a cross layer's holds the vision tokens'),
``{"ssm", "conv"}`` for SSD and ``{"hidden", "conv"}`` for RG-LRU.

Three entry points take the parameters as a nested dict (``Transformer.tree``,
``params_tree`` of the trainer's flat ``{name: tensor}``, or
``compute_params``); a model with cross layers takes ``vision`` (B,
vision_tokens, cross_kv_dim), the stub vision tower's output:
    forward(params, tokens, cfg, vision=)         -> (logits, aux)   (train)
    prefill(params, tokens, cfg, vision=)         -> (last_logits, cache)
    decode_step(params, token, cache, index, cfg) -> (logits, cache)
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_lib
from repro_torch.nn import attention as A
from repro_torch.nn import init as winit
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M
from repro_torch.nn import rglru as R
from repro_torch.nn import ssm as S


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
    # The JAX model's attention chunking and scan switches. The port keeps
    # them so that a JAX config carries over field for field, and
    # ``n_prefix``/``n_blocks`` (which follow ``scan_blocks``) say how a JAX
    # param tree is stacked; its attention is the flash kernel at any length.
    # ``remat`` recomputes each prefix layer and each pattern block in
    # ``forward``'s backward, as the reference's ``jax.checkpoint`` does.
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
        return A.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta, qk_norm=self.qk_norm,
            attn_softcap=self.attn_softcap,
            window=self.window if kind == "local" else None,
            cross_kv_dim=self.cross_kv_dim if kind == "cross" else None,
            query_scale=self.head_dim ** -0.5)

    def ssd_cfg(self) -> S.SSDConfig:
        # ``ssm_unroll`` picks lax.scan or a loop in the reference; the port loops
        return S.SSDConfig(d_model=self.d_model, d_state=self.ssm_state,
                           head_dim=self.ssm_head_dim, chunk=self.ssm_chunk)

    def rglru_cfg(self) -> R.RGLRUConfig:
        return R.RGLRUConfig(d_model=self.d_model)

    def moe_cfg(self) -> M.MoEConfig:
        return M.MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                           n_experts=self.n_experts, top_k=self.top_k,
                           capacity_factor=self.moe_capacity_factor, act=self.act)

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
        sc = self.ssd_cfg()
        per_kind["ssd"] = d * (2 * sc.d_inner + 2 * sc.d_state + sc.n_heads) \
            + sc.d_inner * d
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

    def active_params(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6*N_active*D)."""
        if self.mlp != "moe":
            return self.num_params()
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff * (
            self.n_layers - self.first_dense)
        return self.num_params() - inactive


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


def _layer_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
                layer_idx: int) -> nn.ModuleDict:
    dev = gen.device
    if kind == "ssd":
        mixer = S.ssd_init(gen, cfg.ssd_cfg())
    elif kind == "rglru":
        mixer = R.rglru_init(gen, cfg.rglru_cfg())
    else:
        mixer = A.attn_init(gen, cfg.attn_cfg(kind))
    p = nn.ModuleDict({"pre_norm": _norm_init(cfg, dev), "mixer": mixer})
    if cfg.post_norm:
        p["post_mixer_norm"] = _norm_init(cfg, dev)
    if cfg.mlp != "none":
        p["mlp_norm"] = _norm_init(cfg, dev)
        if cfg.mlp == "moe" and layer_idx >= cfg.first_dense:
            p["mlp"] = M.moe_init(gen, cfg.moe_cfg())
        else:
            # the dense layers of an MoE model are d_ff * top_k wide, as the
            # reference's (activated compute comparable to an MoE layer's)
            f = cfg.d_ff if cfg.mlp != "moe" else cfg.d_ff * max(cfg.top_k, 1)
            mlp = nn.ModuleDict({"up": L.dense_init(gen, cfg.d_model, f),
                                 "down": L.dense_init(gen, f, cfg.d_model)})
            if cfg.gated_mlp:
                mlp["gate"] = L.dense_init(gen, cfg.d_model, f)
            p["mlp"] = mlp
        if cfg.post_norm:
            p["post_mlp_norm"] = _norm_init(cfg, dev)
    return p


def _tree(module: nn.Module):
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    if isinstance(module, nn.ModuleList):
        return [_tree(m) for m in module]
    tree = dict(module.named_parameters(recurse=False))     # the mixers' own vectors
    tree.update((name, _tree(m)) for name, m in module.named_children())
    return tree


class Transformer(nn.Module):
    """Holds the parameters; the entry points below compute with them."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dev = gen.device
        self.embed = nn.ParameterDict(
            {"embedding": winit.normal(gen, (cfg.vocab, cfg.d_model), std=0.02)})
        self.final_norm = _norm_init(cfg, dev)
        self.layers = nn.ModuleList(_layer_init(gen, cfg, k, i)
                                    for i, k in enumerate(cfg.kinds()))
        if not cfg.tie_embeddings:
            self.unembed = nn.ParameterDict(
                {"kernel": winit.normal(gen, (cfg.d_model, cfg.vocab), std=0.02)})

    def tree(self) -> dict:
        """The parameters as the nested dict the entry points take (no copy)."""
        return _tree(self)


def params_tree(flat: dict[str, torch.Tensor]) -> dict:
    """The trainer's flat ``{name: tensor}`` (``TrainState.params``, the
    names of ``named_parameters``) as the nested dict the entry points
    take, ``Transformer.tree``'s shape: ``layers`` a list, every other
    level a dict. No copy: the tensors are the ones given, so the
    gradients of a loss computed from the tree land on them."""
    root: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    layers = root.get("layers", {})
    root["layers"] = [layers[str(i)] for i in range(len(layers))]
    return root


class _OnMeta(TorchFunctionMode):
    """Sends every factory call's ``device`` to meta: the layers' init code
    names its generator's device, and a generator cannot be made on meta."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if "device" in kwargs:
            kwargs = {**kwargs, "device": "meta"}
        return func(*args, **kwargs)


def init(cfg: ArchConfig, *, seed: int = 0, device=None) -> Transformer:
    """A model with fresh fp32 weights drawn from ``seed`` on ``device``.
    On ``"meta"`` the parameters have their shapes and dtypes and no
    values, and nothing is drawn or allocated: the counterpart of the
    reference's ``jax.eval_shape(lambda: init(key, cfg))``."""
    dev = device_lib.resolve(device)
    if dev.type == "meta":
        with torch.device("meta"), _OnMeta():
            return Transformer(cfg, torch.Generator())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, gen)


def _compute(key: str, value, dtype: torch.dtype):
    if key == "router":                    # the reference routes in fp32
        return value
    if key in ("kernel", "embedding"):
        return L.cast(value, dtype)
    if key == "experts":                   # the stacked (E, d, f) matrices
        return {k: L.cast(v, dtype) for k, v in value.items()}
    return compute_params(value, dtype)


def compute_params(params, dtype: torch.dtype) -> dict:
    """The tree with every matrix (``kernel``, ``embedding``, the expert
    stacks) cast to the compute dtype once; the MoE router's kernel, norm
    scales, the SSD's ``dt_bias``, ``A_log`` and ``D`` and the RG-LRU's
    gate matrices, biases and ``lambda_param`` (used in fp32) stay fp32.
    The JAX model casts at each use, which gives the same values. The casts
    are differentiable: under autograd the gradients of the copies land on
    the fp32 masters, as the trainer needs."""
    if isinstance(params, nn.Module):
        params = params.tree()
    if isinstance(params, dict):
        return {k: _compute(k, v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [compute_params(v, dtype) for v in params]
    return params


# ---------------------------------------------------------------------------
# forward (full sequence)
# ---------------------------------------------------------------------------

def _mlp_block(p, x, cfg: ArchConfig):
    """(x + the MLP's output, the MoE aux loss or None for a dense MLP)."""
    if cfg.mlp == "none":
        return x, None
    h, aux = _norm(cfg, p["mlp_norm"], x), None
    if "router" in p["mlp"]:
        h, aux = M.moe_apply(p["mlp"], h, cfg.moe_cfg())
    else:
        h = L.mlp(p["mlp"], h, act=cfg.act)
    if cfg.post_norm:
        h = _norm(cfg, p["post_mlp_norm"], h)
    return x + h, aux


def _residual(p, x, h, cfg: ArchConfig):
    """x + (post-normed) mixer output, then the MLP block: (x, aux)."""
    if cfg.post_norm:
        h = _norm(cfg, p["post_mixer_norm"], h)
    return _mlp_block(p, x + h, cfg)


def _apply_layer(p, x, cfg: ArchConfig, kind: str, vision=None):
    h = _norm(cfg, p["pre_norm"], x)
    if kind == "ssd":
        h = S.ssd_apply(p["mixer"], h, cfg.ssd_cfg())
    elif kind == "rglru":
        h = R.rglru_apply(p["mixer"], h, cfg.rglru_cfg())
    elif kind == "cross":
        h = A.cross_attention(p["mixer"], h, vision, cfg.attn_cfg(kind))
    else:
        h = A.self_attention(p["mixer"], h, cfg.attn_cfg(kind))
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


def _check_vision(cfg: ArchConfig, vision) -> None:
    if vision is None and "cross" in cfg.pattern:
        raise ValueError(f"{cfg.name} has cross layers: pass vision=(B, "
                         f"{cfg.vision_tokens}, {cfg.cross_kv_dim})")


def _apply_layers(layers, kinds, x, aux_total, cfg: ArchConfig, vision):
    for p, kind in zip(layers, kinds):
        x, aux = _apply_layer(p, x, cfg, kind, vision)
        if aux is not None:
            aux_total = aux_total + aux
    return x, aux_total


def remat_units(cfg: ArchConfig) -> list[tuple[int, int]]:
    """The layer ranges ``forward`` recomputes as one unit under
    ``cfg.remat``: each of the ``n_prefix`` prefix layers, then each block
    of ``len(pattern)`` consecutive layers (the reference's scanned body,
    the order of ``convert.leaf_groups``)."""
    n, base = len(cfg.pattern), cfg.n_prefix
    return ([(i, i + 1) for i in range(base)]
            + [(base + b * n, base + (b + 1) * n) for b in range(cfg.n_blocks)])


def forward(params, tokens: torch.Tensor, cfg: ArchConfig, *, vision=None):
    """tokens: (B, S) int -> (logits (B, S, V) fp32, aux). aux is the MoE
    layers' load-balance loss summed in fp32, 0 without MoE layers.
    ``vision`` (B, vision_tokens, cross_kv_dim) feeds the cross layers.

    Differentiable on both devices: on the card the attention is the flash
    forward kernel, whose gradient is the backward kernel
    (``kernels/flash_attn.py:FlashAttention``); on the host its plain
    version under autograd. With ``cfg.remat`` each unit of
    ``remat_units`` runs under ``torch.utils.checkpoint`` (non-reentrant):
    the forward keeps only each unit's input, and backward runs the unit
    again before its gradient, the flash forward kernel included. The aux
    loss is carried through the units, so the recompute does not add it
    twice."""
    params = _as_tree(params)
    _check_vision(cfg, vision)
    x = _embed_in(params, cfg, tokens)
    aux_total = torch.zeros((), device=x.device)
    layers, kinds = params["layers"], cfg.kinds()
    if not cfg.remat:
        x, aux_total = _apply_layers(layers, kinds, x, aux_total, cfg, vision)
        return _logits_out(params, cfg, x), aux_total
    for a, b in remat_units(cfg):
        x, aux_total = ckpt.checkpoint(_apply_layers, layers[a:b], kinds[a:b], x, aux_total,
                                       cfg, vision, use_reentrant=False)
    return _logits_out(params, cfg, x), aux_total


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_len(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    return min(cfg.window, cache_len) if kind == "local" else cache_len


def _layer_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int, dtype, dev):
    if kind == "ssd":
        return S.ssd_init_state(batch, cfg.ssd_cfg(), dtype, dev)
    if kind == "rglru":
        return R.rglru_init_state(batch, cfg.rglru_cfg(), dtype, dev)
    return A.init_kv_cache(batch, _cache_len(cfg, kind, cache_len),
                           cfg.attn_cfg(kind), dtype, dev)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None) -> list[dict]:
    """One cache a layer, in ``kinds()`` order: {"k", "v"} for attention
    (local layers hold ``min(window, cache_len)`` slots; a cross layer's
    ``cache_len`` slots, as the reference's, until prefill puts the vision
    tokens' k/v there), {"ssm" fp32, "conv" in ``dtype``} for SSD,
    {"hidden" fp32, "conv" in ``dtype``} for RG-LRU."""
    dev = device_lib.resolve(device)
    return [_layer_cache(cfg, kind, batch, cache_len, dtype, dev) for kind in cfg.kinds()]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, token: torch.Tensor, cache: list[dict], index: int,
                cfg: ArchConfig):
    """token: (B, 1) int; index: absolute position of the token. Writes the
    token's k/v, or the SSD or RG-LRU layer's new state, into ``cache`` in
    place; a cross layer reads its vision cache. Returns (logits (B, 1, V),
    cache). MoE layers drop their aux loss."""
    params = _as_tree(params)
    x = _embed_in(params, cfg, token)
    for p, c, kind in zip(params["layers"], cache, cfg.kinds()):
        h = _norm(cfg, p["pre_norm"], x)
        if kind == "ssd":
            h, state = S.ssd_decode_step(p["mixer"], h, c, cfg.ssd_cfg())
            c.update(state)
        elif kind == "rglru":
            h, state = R.rglru_decode_step(p["mixer"], h, c, cfg.rglru_cfg())
            c.update(state)
        elif kind == "cross":
            h = A.decode_cross_attention(p["mixer"], h, c, cfg.attn_cfg(kind))
        else:
            h, _ = A.decode_self_attention(p["mixer"], h, c, index, cfg.attn_cfg(kind))
        x, _ = _residual(p, x, h, cfg)
    return _logits_out(params, cfg, x), cache


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, cfg: ArchConfig, *, vision=None,
            cache_len: int | None = None, cache_dtype=torch.bfloat16):
    """Process the prompt; return (last-position logits (B, 1, V), cache).

    Each attention layer projects q, k and v once and uses them for both its
    cache and the flash kernel (the JAX model projects k and v twice, to the
    same values); a cross layer's cache is the vision tokens' k/v in
    ``cache_dtype``, and its attention the flash kernel unmasked. An SSD or
    RG-LRU layer's cache is its final state as the reference returns it:
    ``ssm`` or ``hidden`` fp32, ``conv`` in the compute dtype. MoE layers
    drop their aux loss.
    """
    params = _as_tree(params)
    _check_vision(cfg, vision)
    cache_len = cache_len or tokens.shape[1]
    x = _embed_in(params, cfg, tokens)
    positions = A._positions(x)
    cache = []
    for p, kind in zip(params["layers"], cfg.kinds()):
        h = _norm(cfg, p["pre_norm"], x)
        if kind == "ssd":
            h, c = S.ssd_apply(p["mixer"], h, cfg.ssd_cfg(), return_state=True)
        elif kind == "rglru":
            h, c = R.rglru_apply(p["mixer"], h, cfg.rglru_cfg(), return_state=True)
        elif kind == "cross":
            acfg = cfg.attn_cfg(kind)
            q, k, v = A._project_qkv(p["mixer"], h, acfg, kv_src=vision)
            c = {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}
            h = A.attend(p["mixer"], q, k, v, acfg, causal=False)
        else:
            acfg = cfg.attn_cfg(kind)
            q, k, v = A._project_qkv(p["mixer"], h, acfg, positions)
            c = A.kv_cache_layout(k, v, _cache_len(cfg, kind, cache_len), cache_dtype)
            h = A.attend(p["mixer"], q, k, v, acfg)
        cache.append(c)
        x, _ = _residual(p, x, h, cfg)
    return _logits_out(params, cfg, x[:, -1:]), cache
