"""gemma-7b [dense] -- GeGLU, wide head_dim 256, MHA.

[arXiv:2403.08295] Gemma 7B: 28 layers, d_model 3072, 16 heads kv=16
(head_dim 256; the 2B variant uses MQA), GeGLU d_ff 24576, vocab 256000,
embeddings scaled by sqrt(d_model), tied unembedding.
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b", arch_type="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256_000, pattern=("attn",),
        act="gelu", norm="rmsnorm", embed_scale=True,
        source="arXiv:2403.08295")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma-7b-smoke", arch_type="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab=128, pattern=("attn",),
        act="gelu", norm="rmsnorm", embed_scale=True)
