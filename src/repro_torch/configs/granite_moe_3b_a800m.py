"""granite-moe-3b-a800m [moe] -- 40 experts, top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base] 32 layers, d_model 1536, 24
heads GQA kv=8 (head_dim 64), MoE in every layer with 40 experts of d_ff
512, top-8 routing, SwiGLU experts, vocab 49155, tied embeddings.
3,298,693,632 parameters, 882,774,528 active a token. (The JAX package's
copy names the 1b-a400m model in ``source`` but has these widths.)
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", arch_type="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
        d_ff=512, vocab=49_155, pattern=("attn",),
        mlp="moe", n_experts=40, top_k=8,
        act="silu", norm="rmsnorm",
        source="hf:ibm-granite/granite-3.0-3b-a800m-base")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m-smoke", arch_type="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=128, pattern=("attn",),
        mlp="moe", n_experts=4, top_k=2, act="silu", norm="rmsnorm")
