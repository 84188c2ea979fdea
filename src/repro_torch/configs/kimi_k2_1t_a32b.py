"""kimi-k2-1t-a32b [moe] -- trillion-parameter MoE, 384 experts top-8.

[hf:moonshotai/Kimi-K2-Base] 61 layers (the first with a dense FFN, 60
MoE), d_model 7168, 64 heads GQA kv=8 (head_dim 128; the real K2 uses MLA,
which the JAX package replaces with GQA), experts d_ff 2048, 384 experts
top-8 (~32 B active), vocab 163840, untied head, rope theta 50k. No single
card holds it. (The JAX package's copy gives ``arXiv:2501.kimi2``, which is
not an identifier.)
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b", arch_type="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=2048, vocab=163_840, pattern=("attn",),
        mlp="moe", n_experts=384, top_k=8, first_dense=1,
        act="silu", norm="rmsnorm", tie_embeddings=False,
        rope_theta=50_000.0, source="hf:moonshotai/Kimi-K2-Base")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b-smoke", arch_type="moe",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=128, pattern=("attn",),
        mlp="moe", n_experts=4, top_k=2, first_dense=1,
        act="silu", norm="rmsnorm", tie_embeddings=False)
