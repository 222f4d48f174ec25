"""qwen2.5-32b — [dense] 64L d=5120 40H (GQA kv=8) ff=27648 V=152064.

GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B lineage; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-32B; hf",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=320, vocab=512, head_dim=32)
