"""recurrentgemma-9b [hybrid] -- RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427] Griffin/RecurrentGemma: 38 layers in (rglru, rglru,
local-attn) repeating pattern (2 leading rglru layers form the unscanned
prefix, 12 scanned pattern blocks), d_model 4096, 16 heads with MQA
(kv=1, head_dim 256), GeGLU d_ff 12288, vocab 256000, local window 2048,
Gemma-style embedding scaling. 9,395,240,960 parameters (norms, conv
kernels, gate biases and Lambda aside).
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b", arch_type="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256_000, pattern=("rglru", "rglru", "local"),
        act="gelu", norm="rmsnorm", window=2048, embed_scale=True,
        source="arXiv:2402.19427")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b-smoke", arch_type="hybrid",
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab=128, pattern=("rglru", "rglru", "local"),
        act="gelu", norm="rmsnorm", window=16, embed_scale=True)
