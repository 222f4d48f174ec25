"""deepseek-moe-16b — [moe] 28L d=2048 16H (kv=16) V=102400.

Fine-grained MoE: 64 routed experts (ff=1408) top-6 + 2 shared experts;
layer 0 is dense with ff=10944 [arXiv:2401.06066; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, n_experts=64, n_shared_experts=2, top_k=6,
    d_ff_expert=1408, first_dense_layers=1, d_ff_first_dense=10944,
    rope_theta=10000.0, source="arXiv:2401.06066; hf",
)

REDUCED = CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=96, vocab=512, n_experts=8, top_k=2,
                         d_ff_expert=32, first_dense_layers=1,
                         d_ff_first_dense=96)
