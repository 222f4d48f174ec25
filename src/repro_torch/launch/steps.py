"""Step builders for serving: prefill and decode (the dense family).

The port of ``make_prefill_step`` and ``make_decode_step`` of the reference
package's ``launch/steps.py``, the entry points its ``examples/serve_lm.py``
drives.  The encdec (whisper) and M-RoPE (vlm) branches, the train step and
the sharding bundles are not ported yet (ROADMAP.md §1 item 11): other
families raise ``NotImplementedError``.
"""
from __future__ import annotations

from ..models import lm
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """(params, batch) -> (last_logits, caches): a fresh ``max_seq`` cache on
    the tokens' device, filled with the prompts ``batch["tokens"]`` (B, S)."""
    lm.require_dense(cfg)

    def prefill(params, batch):
        tokens = batch["tokens"]
        caches = lm.init_cache(cfg, tokens.shape[0], max_seq,
                               device=tokens.device)
        logits, caches, _ = lm.forward(params, tokens, cfg, caches=caches,
                                       q_offset=0)
        return logits[:, -1], caches
    return prefill


def make_decode_step(cfg: ModelConfig):
    """(params, token (B, 1), caches) -> (logits (B, V), caches)."""
    lm.require_dense(cfg)

    def step(params, token, caches):
        return lm.decode_step(params, token, caches, cfg)
    return step
