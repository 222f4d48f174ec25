"""kimi-k2-1t-a32b — [moe] 61L d=7168 64H (GQA kv=8 per the paper table —
the real model uses MLA; the table pins GQA) V=163840.

384 routed experts (ff=2048) top-8 + 1 shared; layer 0 dense (ff=18432,
DeepSeek-V3 lineage).  ~1.04T total params, ~32B active
[arXiv:2501.kimi2; unverified; paper-table]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163840, head_dim=128, n_experts=384, n_shared_experts=1, top_k=8,
    d_ff_expert=2048, first_dense_layers=1, d_ff_first_dense=18432,
    rope_theta=5e7, source="arXiv:2501.kimi2; unverified",
)

REDUCED = CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=64, vocab=512, head_dim=16, n_experts=8,
                         top_k=2, d_ff_expert=32, first_dense_layers=1,
                         d_ff_first_dense=96)
