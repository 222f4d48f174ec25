"""zamba2-7b — [hybrid] 81L d=3584 (Mamba2) + ONE shared attn block
(32H kv=32, ff=14336), V=32000, ssm_state=64 [arXiv:2411.15242; unverified].

Zamba2 applies a single weight-shared attention+MLP block interleaved with
the Mamba2 backbone; we apply it every 6 mamba layers (13 applications +
tail), which matches the paper's sharing ratio.  d_inner = 2*d = 7168,
112 SSD heads of 64 channels.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, ssm_state=64, d_inner=7168, mamba_headdim=64,
    mamba_version=2, shared_attn_period=6, conv_kernel=4, ssm_chunk=64,
    source="arXiv:2411.15242; unverified",
)

REDUCED = CONFIG.replace(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=512, ssm_state=8, d_inner=128,
                         mamba_headdim=16, shared_attn_period=2, ssm_chunk=8)
