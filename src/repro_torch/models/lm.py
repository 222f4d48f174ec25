"""Decoder-only LM: the dense family, for serving (prefill, then decode
through a KV cache).

The port of the reference package's ``models/lm.py``.  The model is an
``nn.Module`` (embedding, a ``ModuleList`` of blocks, final norm) whose
parameters keep the reference's layout and names (``wq`` (d, H*hd) used as
``x @ wq``, ``embed`` (V, d), ...), so carrying the reference's weights over
is a copy (``convert.params_from_jax``).  ``lax.scan`` over stacked layers
becomes a loop over the blocks; each block's parameters are views of the
stacked (L, ...) arrays they were made from.  Entry points that allocate
(``init_params``, ``init_cache``) take ``device="cuda"`` by default and
raise without a card.

The cache is the reference's pytree, ``{"layers": {"k", "v", "index"}}``
with k/v (L, B, max_seq, Hkv, hd) and index (L,) int32 on the device, plus
``"host_index"``: index[0] as a host int, so a step never waits on the card
to learn where to write.  A step writes its K/V into the cache in place and
returns the same dict.

Not ported yet (ROADMAP.md §1 item 11): the moe, ssm, hybrid and vlm
families (they raise ``NotImplementedError``), ``loss_fn`` and training.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import attention_block, norm, swiglu


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (the "
            f"dense family is): ROADMAP.md §1 item 11")


def device_of(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# parameter shapes / init
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
         "wo": (h * hd, d)}
    if cfg.qkv_bias:
        s |= {"bq": (h * hd,), "bk": (hkv * hd,), "bv": (hkv * hd,)}
    if cfg.qk_norm:
        s |= {"q_norm": (hd,), "k_norm": (hd,)}
    return s


def _mlp_shapes(d: int, ff: int) -> dict[str, tuple]:
    return {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


def _ln_shapes(cfg: ModelConfig, names: tuple[str, ...]) -> dict[str, tuple]:
    if cfg.nonparam_ln:
        return {}
    return {n: (cfg.d_model,) for n in names}


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes, per-layer entries stacked over a
    leading L dim (the reference's layout)."""
    require_dense(cfg)
    d, V = cfg.d_model, cfg.vocab
    out: dict[str, Any] = {"embed": (V, d)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (V, d)
    out["final_ln"] = (d,)
    layer = {"attn": _attn_shapes(cfg), "mlp": _mlp_shapes(d, cfg.d_ff)}
    layer |= _ln_shapes(cfg, ("ln1", "ln2"))
    out["layers"] = tree_map(lambda s: (cfg.n_layers, *s), layer)
    return out


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One transformer layer: ``attn`` and ``mlp`` weights by name, and the
    norm scales ``ln1``/``ln2`` (None for a non-parametric LayerNorm)."""

    def __init__(self, tensors: dict):
        super().__init__()
        self.attn = nn.ParameterDict({k: _frozen(v)
                                      for k, v in tensors["attn"].items()})
        self.mlp = nn.ParameterDict({k: _frozen(v)
                                     for k, v in tensors["mlp"].items()})
        for name in ("ln1", "ln2"):
            self.register_parameter(
                name, _frozen(tensors[name]) if name in tensors else None)


class LM(nn.Module):
    """The dense decoder-only LM, built from a nested dict of tensors in
    ``param_shapes(cfg)``'s layout (per-layer entries stacked over L)."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        require_dense(cfg)
        self.cfg = cfg
        self.embed = _frozen(tree["embed"])
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings else _frozen(tree["lm_head"]))
        self.final_ln = _frozen(tree["final_ln"])
        self.blocks = nn.ModuleList(
            Block(tree_map(lambda t, i=i: t[i], tree["layers"]))
            for i in range(cfg.n_layers))


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, by the reference's rule (``init_one``), read off the stacked
    shape: 1-D scales are ones; other shapes of at most two dims ending in
    d_model (embeddings, per-layer norm scales) are 0.02 N(0, 1); the rest
    N(0, 1) / sqrt(shape[-2]).  The distributions are the reference's, the
    numbers another generator's."""
    dev = device_of(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = _pdt(cfg)

    def init_one(shape):
        if len(shape) <= 2 and (shape[-1:] == (cfg.d_model,) or len(shape) == 1):
            if not pdt.is_floating_point:
                return torch.zeros(shape, dtype=pdt, device=dev)
            if len(shape) == 1:
                return torch.ones(shape, dtype=pdt, device=dev)
            scale = 0.02
        else:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(pdt)

    return LM(cfg, tree_map(init_one, param_shapes(cfg)))


# ---------------------------------------------------------------------------
# forward (train / prefill), cache-threaded for decode
# ---------------------------------------------------------------------------


def _transformer_block(lp: Block, x, cfg: ModelConfig, positions, cache=None):
    x = x + attention_block(lp.attn, norm(x, lp.ln1, cfg), cfg, positions,
                            cache=cache)
    return x + swiglu(lp.mlp, norm(x, lp.ln2, cfg))


def forward(params: LM, tokens, cfg: ModelConfig, *, caches=None,
            q_offset=None):
    """Shared forward.  tokens: (B, S) int32.

    caches: None for a full forward (logits at every position); a cache
    from ``init_cache`` for prefill and decode, written at its host_index.
    Returns (logits, caches, aux_loss) as the reference does; aux_loss is 0
    for the dense family.
    """
    require_dense(cfg)
    cdt = _dt(cfg)
    b, s = tokens.shape
    x = F.embedding(tokens, params.embed).to(cdt)
    positions = (torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
                 + (q_offset or 0)).expand(b, s)

    layer_caches = [None] * cfg.n_layers
    if caches is not None:
        c, idx = caches["layers"], caches["host_index"]
        # the decode kernel's (B,) lengths, made once for all layers
        length = (torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
                  if s == 1 else None)
        layer_caches = [{"k": c["k"][i], "v": c["v"][i], "index": idx,
                         "length": length} for i in range(cfg.n_layers)]
    for blk, cache in zip(params.blocks, layer_caches):
        x = _transformer_block(blk, x, cfg, positions, cache=cache)
    if caches is not None:
        c["index"].fill_(idx + s)
        caches["host_index"] = idx + s

    x = norm(x, params.final_ln, cfg)
    head = params.embed if cfg.tie_embeddings else params.lm_head
    logits = x @ head.to(cdt).T
    return logits, caches, 0.0


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """(shape, dtype) of every entry of the decode cache."""
    require_dense(cfg)
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    kv = ((L, batch, max_seq, hkv, hd), _dt(cfg))
    return {"layers": {"k": kv, "v": kv, "index": ((L,), torch.int32)}}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> dict:
    dev = device_of(device)
    caches = tree_map(lambda spec: torch.zeros(spec[0], dtype=spec[1], device=dev),
                  init_cache_specs(cfg, batch, max_seq))
    caches["host_index"] = 0
    return caches


def decode_step(params: LM, token, caches: dict, cfg: ModelConfig):
    """One-token decode.  token: (B, 1) int32.  Returns (logits, caches):
    logits (B, V) of the step, caches the same dict, written in place."""
    logits, caches, _ = forward(params, token, cfg, caches=caches,
                                q_offset=caches["host_index"])
    return logits[:, -1], caches
