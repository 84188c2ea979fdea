"""musicgen-medium [audio] -- decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] MusicGen (Copet et al., 2023), medium: 48 layers,
d_model 1536, 24 heads (MHA, kv=24), d_ff 6144, vocab 2048 (EnCodec
codebook). As in the JAX package, the audio codec is not modelled: the
input is token ids (the 4 codebooks flattened by the delay pattern into
one stream). LayerNorm and a plain GELU FFN as the original; RoPE in place
of MusicGen's sinusoidal embedding (the reference's documented departure).
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium", arch_type="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048, pattern=("attn",),
        act="gelu", gated_mlp=False, norm="layernorm",
        tie_embeddings=False, source="arXiv:2306.05284")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-medium-smoke", arch_type="audio",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=128, pattern=("attn",),
        act="gelu", gated_mlp=False, norm="layernorm", tie_embeddings=False)
