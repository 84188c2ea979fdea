"""qwen3-1.7b [dense] -- qk-norm, GQA.

[hf:Qwen/Qwen3-1.7B] 28 layers, d_model 2048, 16 heads GQA kv=8
(head_dim 128), SwiGLU d_ff 6144, vocab 151936, RMSNorm on q/k per head
(qk_norm), tied embeddings, rope theta 1M. 1,720,451,072 parameters.
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b", arch_type="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab=151_936, pattern=("attn",),
        act="silu", norm="rmsnorm", qk_norm=True, rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-1.7B")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b-smoke", arch_type="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=128, pattern=("attn",),
        act="silu", norm="rmsnorm", qk_norm=True)
