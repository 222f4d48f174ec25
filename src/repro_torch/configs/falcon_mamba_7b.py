"""falcon-mamba-7b — [ssm] 64L d=4096 attention-free, V=65024, state=16.

Pure Mamba1 architecture [arXiv:2410.05355; unverified].  d_inner = 8192,
dt_rank = 256.  Decode state is O(1) in context length -> runs long_500k."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024, ssm_state=16, d_inner=8192, mamba_version=1,
    conv_kernel=4, ssm_chunk=256, source="arXiv:2410.05355; unverified",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=64, d_inner=128, vocab=512,
                         ssm_state=4, ssm_chunk=8)
