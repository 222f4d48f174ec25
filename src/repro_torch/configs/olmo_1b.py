"""olmo-1b — [dense] 16L d=2048 16H (kv=16) ff=8192 V=50304.

Non-parametric LayerNorm (no learnable scale/bias), tied embeddings
[arXiv:2402.00838; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=50304, nonparam_ln=True, tie_embeddings=True, rope_theta=10000.0,
    source="arXiv:2402.00838; hf",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab=512)
