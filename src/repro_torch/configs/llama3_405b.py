"""llama3-405b [dense] -- the largest dense arch of the zoo.

[arXiv:2407.21783] Llama 3.1 405B: 126 layers, d_model 16384, 128 heads
GQA kv=8 (head_dim 128), SwiGLU d_ff 53248, vocab 128256, rope theta 500k,
untied output head. 405,849,243,648 parameters: no single card holds it.
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", arch_type="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
        d_ff=53248, vocab=128_256, pattern=("attn",),
        act="silu", norm="rmsnorm", rope_theta=500_000.0,
        tie_embeddings=False, source="arXiv:2407.21783")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b-smoke", arch_type="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=256, pattern=("attn",),
        act="silu", norm="rmsnorm", tie_embeddings=False)
