"""whisper-base — [audio] enc-dec, 6+6L d=512 8H ff=2048 V=51865.

Conv/audio frontend is a STUB (input_specs provides 1500 precomputed frame
embeddings).  Sinusoidal positions replace the learned tables so the
assigned 32k decoder shapes are well-formed (noted in DESIGN.md — Whisper's
trained context is 448) [arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, enc_frames=1500, tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)

REDUCED = CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=4, d_ff=128, vocab=512, enc_frames=16)
