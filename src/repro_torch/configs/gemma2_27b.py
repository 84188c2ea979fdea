"""gemma2-27b [dense] -- local+global alternating attention, logit softcap.

[arXiv:2408.00118] Gemma 2 27B: 46 layers alternating (local window 4096,
global), d_model 4608, 32 heads GQA kv=16 (head_dim 128), GeGLU d_ff 36864,
vocab 256000, attention softcap 50, final-logit softcap 30, post-block
RMSNorms, embedding scaling, tied embeddings.
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b", arch_type="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab=256_000, pattern=("local", "attn"),
        act="gelu", norm="rmsnorm", post_norm=True, window=4096,
        logit_softcap=30.0, attn_softcap=50.0, embed_scale=True,
        source="arXiv:2408.00118")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-27b-smoke", arch_type="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=128, pattern=("local", "attn"),
        act="gelu", norm="rmsnorm", post_norm=True, window=16,
        logit_softcap=30.0, attn_softcap=50.0, embed_scale=True)
