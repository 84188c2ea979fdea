"""llama-3.2-vision-90b [vlm] -- decoder with interleaved cross-attention.

[hf:meta-llama/Llama-3.2-90B-Vision] 100 layers total: every 5th layer is
a cross-attention layer over vision embeddings (80 self + 20 cross),
d_model 8192, 64 heads GQA kv=8 (head_dim 128), SwiGLU d_ff 28672, vocab
128256, rope theta 500k, untied embeddings. The ViT and projector are a
stub: the model takes precomputed patch embeddings (B, 1601, 7680), which
the cross layers' k/v projections read. (The JAX package's copy names the
11B model in ``source`` but has these widths.)
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b", arch_type="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=28672, vocab=128_256,
        pattern=("attn", "attn", "attn", "attn", "cross"),
        act="silu", norm="rmsnorm", rope_theta=500_000.0,
        tie_embeddings=False, cross_kv_dim=7680, vision_tokens=1601,
        source="hf:meta-llama/Llama-3.2-90B-Vision")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-90b-smoke", arch_type="vlm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=128, pattern=("attn", "cross"),
        act="silu", norm="rmsnorm", tie_embeddings=False,
        cross_kv_dim=96, vision_tokens=16)
