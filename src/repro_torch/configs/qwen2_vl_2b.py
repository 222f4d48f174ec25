"""qwen2-vl-2b — [vlm] 28L d=1536 12H (GQA kv=2) ff=8960 V=151936.

M-RoPE + dynamic resolution [arXiv:2409.12191; hf].  Backbone only: the
vision frontend is a STUB — input_specs provides patch/frame embeddings and
3-axis (t,h,w) position ids.  head_dim = 1536/12 = 128; M-RoPE sections
(16,24,24) over the 64 frequency slots.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128, qkv_bias=True, mrope=True,
    mrope_sections=(16, 24, 24), rope_theta=1e6, tie_embeddings=True,
    source="arXiv:2409.12191; hf",
)

REDUCED = CONFIG.replace(n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512, head_dim=32,
                         mrope_sections=(4, 6, 6))
