"""qwen3-0.6b — [dense] 28L d=1024 16H (GQA kv=8) ff=3072 V=151936.

Per-head qk RMSNorm, head_dim=128 (> d_model/n_heads — Qwen3 style), GQA
[hf:Qwen/Qwen3-0.6B lineage; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
    rope_theta=1e6, source="hf:Qwen/Qwen3-8B; hf",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512, head_dim=32)
