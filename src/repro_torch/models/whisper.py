"""Whisper-style encoder-decoder backbone (the encdec family; the audio
frontend is a stub).

The port of the reference package's ``models/whisper.py``.  Only the
transformer backbone is modelled: the encoder takes precomputed mel-frame
embeddings (B, enc_frames, d) through the stub ``enc_in_proj``.  Positions
are sinusoids added to the inputs (interleaved: sin on the even columns,
cos on the odd ones), so no attention rotates its queries or keys.

The model is a ``Whisper`` module whose parameters keep the reference's
tree (``param_shapes``): ``enc_layers`` and ``dec_layers`` stacked over
their depths, each layer's weights taken as ``unbind`` views per call
(``lm.unstack``), as ``lm.LM``'s.  Encoder layers attend bidirectionally
over the frames; each decoder layer runs causal self-attention, then
cross-attention over the encoder's K/V (``xattn``), then a GELU MLP.

The decode cache is the reference's pytree plus the port's host index:
``{"self": {k, v (L, B, max_seq, Hkv, hd), index (L,) int32}, "xk", "xv"
(L, B, F, Hkv, hd), "host_index"}``.  ``prefill`` encodes the frames,
writes each layer's cross K/V once, then runs the prompt through the self
cache; a decode step writes its K/V in place and sends both of a layer's
single-token attentions through the registry's ``decode_attention``: the
self-attention below index + 1, the cross-attention over all F frames (one
(B,) length of each a step).  Entry points that allocate take
``device="cuda"`` by default and raise without a card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import lm
from .config import ModelConfig
from .layers import attention_block, gelu_mlp, rmsnorm


def _sinusoid(seq: int, d: int, offset=0, device=None):
    """(seq, d) float32: sin(pos / 10000^(2i/d)) in column 2i and cos in
    column 2i + 1, positions offset .. offset + seq - 1."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None] + offset
    div = torch.exp(-math.log(10000.0)
                    * torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    ang = pos * div
    out = torch.zeros((seq, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes, per-layer entries stacked over a
    leading L dim (the reference's layout)."""
    d = cfg.d_model
    mlp = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    enc_layer = {"attn": lm._attn_shapes(cfg), "ln1": (d,), "ln2": (d,),
                 "mlp": mlp}
    dec_layer = {"attn": lm._attn_shapes(cfg), "xattn": lm._attn_shapes(cfg),
                 "ln1": (d,), "ln2": (d,), "ln3": (d,), "mlp": mlp}
    return {
        "embed": (cfg.vocab, d),
        "enc_in_proj": (d, d),            # stub frontend projection
        "enc_layers": lm.tree_map(lambda s: (cfg.n_enc_layers, *s), enc_layer),
        "enc_final_ln": (d,),
        "dec_layers": lm.tree_map(lambda s: (cfg.n_layers, *s), dec_layer),
        "final_ln": (d,),
    }


class Whisper(lm.Params):
    """The encoder-decoder, built from a nested dict of tensors in
    ``param_shapes(cfg)``'s layout; the tensors become its parameters
    without a copy, ``tree()`` gives them back."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Whisper:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, by the reference's rule read off the stacked shape: 1-D
    shapes and (n_layers, d_model) ones; the rest N(0, 1) / sqrt(shape[-2])
    (the embedding's too).  The distributions are the reference's, the
    numbers another generator's."""
    dev = lm.device_of(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = lm._pdt(cfg)

    def init_one(shape):
        if len(shape) == 1 or shape == (cfg.n_layers, cfg.d_model):
            return torch.ones(shape, dtype=pdt, device=dev)
        return torch.randn(shape, generator=gen, device=dev).mul_(
            1.0 / math.sqrt(shape[-2])).to(pdt)

    return Whisper(cfg, lm.tree_map(init_one, param_shapes(cfg)))


def _tree(params) -> dict:
    return params.tree() if isinstance(params, Whisper) else params


def _encoder_layer(lp: lm.Block, h, cfg: ModelConfig):
    h = h + _encoder_self_attn(lp.attn, rmsnorm(h, lp.ln1, cfg.norm_eps), cfg)
    return h + gelu_mlp(lp.mlp, rmsnorm(h, lp.ln2, cfg.norm_eps))


def encode(params, frames, cfg: ModelConfig):
    """frames: (B, F, d) stub embeddings -> encoder states (B, F, d)."""
    tree = _tree(params)
    cdt = lm._dt(cfg)
    x = frames.to(cdt) @ tree["enc_in_proj"].to(cdt)
    x = x + _sinusoid(x.shape[1], cfg.d_model, device=x.device).to(cdt)[None]
    remat = lm.remat_wanted(tree, cfg)
    for lp in lm.unstack(tree["enc_layers"], cfg.n_enc_layers):
        if remat:
            x = checkpoint(_encoder_layer, lp, x, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _encoder_layer(lp, x, cfg)
    return rmsnorm(x, tree["enc_final_ln"], cfg.norm_eps)


def _encoder_self_attn(p, x, cfg: ModelConfig):
    """Bidirectional self-attention: the cross-attention path with K/V from
    x itself."""
    return attention_block(p, x, cfg, None, layer_cross_kv=_cross_kv(p, x, cfg))


def _cross_kv(p, enc, cfg: ModelConfig):
    """K and V (B, F, Hkv, hd) of ``enc`` under one layer's weights (no
    bias, as the reference's)."""
    b, f, _ = enc.shape
    dt = enc.dtype
    k = (enc @ p["wk"].to(dt)).reshape(b, f, cfg.n_kv_heads, cfg.hd)
    v = (enc @ p["wv"].to(dt)).reshape(b, f, cfg.n_kv_heads, cfg.hd)
    return k, v


def _stacked_cross_kv(tree: dict, enc, cfg: ModelConfig, caches: dict) -> None:
    """Every decoder layer's cross K/V of ``enc``, written into
    ``caches["xk"][i]`` and ``caches["xv"][i]`` in place."""
    for i, lp in enumerate(lm.unstack(tree["dec_layers"], cfg.n_layers)):
        k, v = _cross_kv(lp.xattn, enc, cfg)
        caches["xk"][i].copy_(k)
        caches["xv"][i].copy_(v)


def _decoder_layer(lp: lm.Block, h, enc, cfg: ModelConfig, cache=None,
                   cross=None):
    """One decoder layer.  Without ``cache``: teacher forcing, the cross K/V
    from ``enc``.  With it: ``cache`` this layer's self-attention cache and
    ``cross`` (xk, xv, length), its cross K/V and the step's (B,) lengths F
    (None at a prefill of more than one token)."""
    h = h + attention_block(lp.attn, rmsnorm(h, lp.ln1, cfg.norm_eps),
                            cfg, None, cache=cache)
    if cache is None:
        kv, length = _cross_kv(lp.xattn, enc, cfg), None
    else:
        kv, length = cross[:2], cross[2]
    h = h + attention_block(lp.xattn, rmsnorm(h, lp.ln2, cfg.norm_eps),
                            cfg, None, layer_cross_kv=kv, cross_length=length)
    return h + gelu_mlp(lp.mlp, rmsnorm(h, lp.ln3, cfg.norm_eps))


def decode_forward(params, tokens, enc_states, cfg: ModelConfig, *,
                   caches=None, q_offset=None):
    """Decoder forward: teacher forcing over (B, S) ``tokens`` when
    ``caches`` is None (the cross K/V from ``enc_states``), else the tokens
    through the cache at its host_index (``enc_states`` unused: the cross
    K/V are the cache's).  Returns (logits (B, S, V), caches)."""
    tree = _tree(params)
    cdt = lm._dt(cfg)
    b, s = tokens.shape
    x = F.embedding(tokens, tree["embed"]).to(cdt)
    x = x + _sinusoid(s, cfg.d_model, offset=q_offset or 0,
                      device=x.device).to(cdt)[None]
    layers = lm.unstack(tree["dec_layers"], cfg.n_layers)
    if caches is None:
        remat = lm.remat_wanted(tree, cfg)
        for lp in layers:
            if remat:
                x = checkpoint(_decoder_layer, lp, x, enc_states, cfg,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _decoder_layer(lp, x, enc_states, cfg)
    else:
        idx = caches["host_index"]
        length = cross_length = None
        if s == 1:
            # the decode kernel's (B,) lengths, made once for all layers
            length = torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
            cross_length = torch.full((b,), caches["xk"].shape[2],
                                      dtype=torch.int32, device=x.device)
        sc, xk, xv = caches["self"], caches["xk"], caches["xv"]
        for i, lp in enumerate(layers):
            cache = {"k": sc["k"][i], "v": sc["v"][i], "index": idx,
                     "length": length}
            x = _decoder_layer(lp, x, None, cfg, cache=cache,
                               cross=(xk[i], xv[i], cross_length))
        lm._advance(caches, idx + s)
    x = rmsnorm(x, tree["final_ln"], cfg.norm_eps)
    return x @ tree["embed"].to(cdt).T, caches


def loss_fn(params, batch: dict, cfg: ModelConfig, group=None):
    """batch: {"frames" (B, F, d), "tokens" (B, S), "labels" (B, S)}: the
    reference's loss, ``lm.token_loss`` of the teacher-forced logits (this
    rank's share of the global one over a data ``group``)."""
    enc = encode(params, batch["frames"], cfg)
    logits, _ = decode_forward(params, batch["tokens"], enc, cfg)
    return lm.token_loss(logits, batch["labels"], group)


def init_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """(shape, dtype) of every entry of the decode cache."""
    cdt = lm._dt(cfg)
    hkv, hd, n = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    kv = ((n, batch, max_seq, hkv, hd), cdt)
    xkv = ((n, batch, cfg.enc_frames, hkv, hd), cdt)
    return {"self": {"k": kv, "v": kv, "index": ((n,), torch.int32)},
            "xk": xkv, "xv": xkv}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    caches = lm._zeros(init_cache_specs(cfg, batch, max_seq), lm.device_of(device))
    caches["host_index"] = 0
    return caches


def prefill(params, frames, tokens, cfg: ModelConfig, max_seq: int):
    """Encode the frames, write each layer's cross K/V once, then run the
    prompt tokens (B, S) through a fresh ``max_seq`` self cache.  Returns
    (logits (B, V) at the prompt's last position, caches)."""
    tree = _tree(params)
    enc = encode(tree, frames, cfg)
    caches = init_cache(cfg, tokens.shape[0], max_seq, device=tokens.device)
    _stacked_cross_kv(tree, enc, cfg, caches)
    del enc
    logits, caches = decode_forward(tree, tokens, None, cfg, caches=caches,
                                    q_offset=0)
    return logits[:, -1], caches


def decode_step(params, token, caches: dict, cfg: ModelConfig):
    """One-token decode.  token: (B, 1) int32.  Returns (logits (B, V),
    caches), the same dict, written in place."""
    logits, caches = decode_forward(params, token, None, cfg, caches=caches,
                                    q_offset=caches["host_index"])
    return logits[:, -1], caches
