"""yi-34b — [dense] 60L d=7168 56H (GQA kv=8) ff=20480 V=64000.

llama-architecture GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab=64000, head_dim=128, rope_theta=5e6,
    source="arXiv:2403.04652; hf",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=320, vocab=512, head_dim=32)
