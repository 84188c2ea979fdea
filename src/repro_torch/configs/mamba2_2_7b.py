"""mamba2-2.7b [ssm] -- SSD (state-space duality), attention-free.

[arXiv:2405.21060] Mamba-2 2.7B: 64 SSD layers, d_model 2560 (d_inner
5120, head_dim 64 -> 80 heads), state N=128, no attention, no separate MLP
(the SSD block is the whole layer), vocab 50280; 2,700,349,440 parameters.
Decode carries an O(1) state a layer, whatever the context length.
"""

from repro_torch.models.transformer import ArchConfig


def arch() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", arch_type="ssm",
        n_layers=64, d_model=2560, n_heads=80, n_kv_heads=1, head_dim=64,
        d_ff=0, vocab=50_280, pattern=("ssd",), mlp="none",
        ssm_state=128, ssm_head_dim=64, norm="rmsnorm",
        source="arXiv:2405.21060")


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b-smoke", arch_type="ssm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=0, vocab=128, pattern=("ssd",), mlp="none",
        ssm_state=16, ssm_head_dim=32, norm="rmsnorm")
