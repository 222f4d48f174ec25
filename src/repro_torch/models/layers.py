"""Transformer building blocks: norms, RoPE and M-RoPE, GQA attention,
SwiGLU and the GELU MLP.

The port of the reference package's ``models/layers.py``, same names and
layouts: q (B, S, Hkv, G, hd) with query head h = kv * G + g, k and v
(B, S, Hkv, hd), weights (d_in, d_out) used as ``x @ w``.  Compute in the
activations' dtype with float32 normalisation and softmax.  Attention is a
plain grouped einsum up to 8192 keys and a chunked online softmax above.  A
single-token step with a cache, or over precomputed cross-attention K/V,
goes through the registry's ``decode_attention``: the hand-written kernel on
the card, its plain version on the CPU.

On a model axis (``tp``, the mesh's "model" group of M ranks) the blocks
are Megatron's, by the reference's rules (``models/sharding.py``): wq, wk,
wv (and their biases) column-parallel, so a rank holds H/M query heads and
Hkv/M KV heads (head h = kv * G + g: a contiguous block of query heads is
its KV heads' groups), wo row-parallel and summed by one all-reduce
(``tp_sum``, in float32); a dim the rules replicate is computed whole on
every rank.  The decode cache is sharded along S (``cache_spec_for``).  A
prefill attends on the rank's heads, then one all-to-all moves each rank's
S block of every KV head into its cache (``heads_to_seq``).  A decode step
gathers the step's heads (one all-gather), the rank holding row ``index``
writes it, every rank takes ``decode_attention_partial`` over its block,
and the all-gathered partials are merged in rank order
(``decode_attention_merge``): the flash-decoding combine the reference
leaves to GSPMD.  The reference's other GSPMD constraints
(``_pin_cache_sharding``, ``_seq_shard_qkv``) pin layouts that the port
holds by construction, or are levers it does not take.

The model-axis collectives go through ``models/tp.py``, whose operators
autograd differentiates, so the same forward trains: a replicated input
enters a product on this rank's columns through ``copy_to_model`` (only
the products whose columns are cut), row-parallel sums leave through
``reduce_from_model``, gathered columns through ``gather_from_model`` and
a block of a replicated tensor through ``scatter_to_model``.  The no-cache
training forward attends on the rank's heads and reaches no all-to-all.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import registry
from .config import ModelConfig
from .sharding import SeqBlock
from .tp import (all_to_all_model, copy_to_model, gather_from_model,
                 reduce_from_model, scatter_to_model)

ATTN_CHUNK_THRESHOLD = 8192   # plain softmax below, chunked above
KV_CHUNK = 1024


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype)


def nonparam_layernorm(x, eps):
    """OLMo's non-parametric LayerNorm: normalize, no learned scale/bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def norm(x, scale, cfg: ModelConfig):
    if cfg.nonparam_ln:
        return nonparam_layernorm(x, cfg.norm_eps)
    return rmsnorm(x, scale, cfg.norm_eps)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int32."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.float()[..., None] * inv              # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: tuple[int, int, int]):
    """Qwen2-VL M-RoPE: the hd/2 frequency slots split into (t, h, w)
    sections, each rotated by its own position stream.  x: (B, S, H, hd);
    positions3: (3, B, S) int32."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"hd // 2 = {hd // 2}")
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    pos = positions3.float()
    ang = torch.cat([pos[i][..., None] * f                # (B, S, hd/2)
                     for i, f in enumerate(inv.split(list(sections)))], dim=-1)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_scores(q, k, v, causal: bool, q_offset=0):
    """Plain grouped attention: q (B,Sq,Hkv,G,hd), k/v (B,Sk,Hkv,hd).

    The group axis G rides on the query side of the einsum, so KV heads are
    never repeated.  Scaling and masking are in place on the float32 scores
    (the prefill's largest transient).
    """
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float().mul_(scale)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        scores.masked_fill_(qi < ki, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v)


def attention_chunked(q, k, v, causal: bool, q_offset=0, kv_chunk: int = KV_CHUNK):
    """Flash-style online softmax over KV chunks (O(chunk) memory).

    q (B,Sq,Hkv,G,hd), k/v (B,Sk,Hkv,hd).  A Python loop over the chunks in
    place of the reference's ``lax.scan``.  The reference pads Sk up to a
    multiple of ``kv_chunk`` and masks the padding; a masked key adds
    exactly 0, so the last chunk here is simply shorter.
    """
    b, sq, hkv, g, hd = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    m = torch.full((b, hkv, g, sq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, kv_chunk):
        kb, vb = k[:, c0:c0 + kv_chunk], v[:, c0:c0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, kb).float() * scale
        if causal:
            ki = c0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = torch.where((ki <= qi)[None, None, None], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(q.dtype), vb).float()
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)       # (B, Sq, Hkv, G, hd)


def _projections(p, x, cfg: ModelConfig, cross: bool, tp=None):
    """x @ wq (+ bq), and without ``cross`` x @ wk, x @ wv (+ bk, bv):
    (B, S, columns) in x's dtype, each the rank's columns on a model axis
    ``tp``, where a product whose columns are cut takes x through
    ``copy_to_model`` (one for all of them) and a replicated one takes x
    itself."""
    dt = x.dtype
    xf = copy_to_model(x, tp)
    fulls = {"wq": cfg.n_heads * cfg.hd, "wk": cfg.n_kv_heads * cfg.hd,
             "wv": cfg.n_kv_heads * cfg.hd}

    def into(w):
        return xf if p[w].shape[-1] != fulls[w] else x

    q = into("wq") @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    if cross:
        return q, None, None
    k = into("wk") @ p["wk"].to(dt)
    v = into("wv") @ p["wv"].to(dt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _rotated(p, q, k, cfg: ModelConfig, positions):
    """Per-head q_norm / k_norm, then RoPE (M-RoPE with ``cfg.mrope``) at
    ``positions`` (None: no rotation); k None for cross-attention."""
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if k is not None:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if k is not None and positions is not None:
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def _attend(qg, k, v, cfg: ModelConfig, causal: bool, q_offset):
    """Plain grouped attention below ATTN_CHUNK_THRESHOLD keys and queries,
    the chunked online softmax above."""
    if k.shape[1] <= ATTN_CHUNK_THRESHOLD and qg.shape[1] <= ATTN_CHUNK_THRESHOLD:
        return attention_scores(qg, k, v, causal=causal, q_offset=q_offset)
    return attention_chunked(qg, k, v, causal=causal, q_offset=q_offset,
                             kv_chunk=cfg.kv_chunk)


def attention_block(p, x, cfg: ModelConfig, positions, cache=None,
                    layer_cross_kv=None, cross_length=None, tp=None):
    """Full attention: projections + rope + (cached) attention + out proj.

    p: the layer's attention weights by name (wq (d, H*hd), wk/wv
    (d, Hkv*hd), wo (H*hd, d); bq/bk/bv with ``qkv_bias``; q_norm/k_norm
    with ``qk_norm``).  positions: (B, S) int32, (3, B, S) with
    ``cfg.mrope``, or None for no rotation (whisper adds sinusoids to its
    input instead).

    cache: None (train / full forward) or one layer's {k, v, index,
    length}: k/v (B, max_seq, Hkv, hd) views into the stacked cache, index
    the host's int position of the next write, length a (B,) int32 device
    tensor index + 1 for a single-token step.  The new K/V are written into
    k/v in place, which saves the reference's copy of every layer's cache
    per step (``lax.dynamic_update_slice`` returns a new buffer), so only
    the output is returned.  The reference clamps a write that would run
    past max_seq onto the last rows; the port raises.

    layer_cross_kv: None, or precomputed (k, v) (B, F, Hkv, hd): the queries
    attend over all F keys, non-causal and unrotated, with no K/V
    projection and no k_norm (whisper's encoder and cross-attention; no
    cache is read).  With ``cross_length``, (B,) int32 holding F in every
    row (made once a step by the caller), a single-token query goes
    through ``decode_attention`` as a cached step does: the same softmax
    over all F keys.

    tp: the mesh's "model" group over more than one rank, with p holding
    this rank's blocks (module docstring; ``attention_tp``).
    """
    if tp is not None:
        if layer_cross_kv is not None:
            raise NotImplementedError(
                "cross-attention on a model axis (the encdec family) is not "
                "ported yet: ROADMAP.md §1 item 11.7c")
        return attention_tp(p, x, cfg, positions, cache, tp)
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cross = layer_cross_kv is not None
    q, k, v = _projections(p, x, cfg, cross)
    q = q.reshape(b, s, h, hd)
    if cross:
        k, v = layer_cross_kv
    else:
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)
    q, k_rot = _rotated(p, q, None if cross else k, cfg, positions)
    if not cross:
        k = k_rot

    q_offset, length = 0, cross_length
    if cache is not None and not cross:
        # write the new K/V at cache["index"], attend over the written prefix
        idx = cache["index"]
        ck, cv = cache["k"], cache["v"]
        if idx + s > ck.shape[1]:
            raise ValueError(f"KV cache overflow: writing {s} rows at "
                             f"{idx} of a {ck.shape[1]}-row cache")
        ck[:, idx:idx + s] = k
        cv[:, idx:idx + s] = v
        q_offset, length = idx, cache["length"]
        # the reference attends over the whole buffer with keys past
        # idx + s masked; they add exactly 0, so only the prefix is read
        k, v = (ck, cv) if s == 1 else (ck[:, :idx + s], cv[:, :idx + s])

    qg = q.reshape(b, s, hkv, h // hkv, hd)
    if s == 1 and length is not None:
        # one streaming pass over the keys in the decode_attention kernel
        # (cfg.attn_decode_kernel is not read: the device decides)
        kernels = registry.resolve(x.device.type)
        out = kernels.decode_attention(qg[:, 0], k, v, length)[:, None]
    else:
        out = _attend(qg, k, v, cfg, not cross, q_offset)
    return out.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

def tp_sum(y, tp, dtype=None):
    """The sum over the model group of the ranks' partial ``y``, in float32,
    as ``dtype`` (y's by default): one all-reduce, one rounding at the end
    (``reduce_from_model``: the backward is the identity)."""
    return reduce_from_model(y, tp, dtype or y.dtype)


def row_parallel(y, w, tp, full: int):
    """``y @ w`` for a row-parallel ``w`` of ``full`` rows: with w's rows
    sharded (this rank's block of ``full``), y's matching columns (all of
    y's when y holds only them) times w in float32, summed over the ranks
    and rounded once to y's dtype, as the one-device product accumulates
    in float32 and rounds once; with them replicated, y @ w on every
    rank.  A whole (replicated) y gives up its block through
    ``scatter_to_model``, so its cotangent comes back whole."""
    rows = w.shape[0]
    if rows == full:
        return y @ w.to(y.dtype)
    if y.shape[-1] == full:
        y = scatter_to_model(y, tp, -1)
    return tp_sum(y.float() @ w.float(), tp, y.dtype)


def _whole_columns(tp, parts: list, fulls: list) -> list:
    """Each tensor of ``parts`` (B, S, columns) with all of its ``fulls``
    columns on every rank: the sharded ones (fewer columns than their full
    count, this rank's block) gathered over the model group in ONE
    all-gather, the rank order giving the column order."""
    which = [i for i, (t, f) in enumerate(zip(parts, fulls)) if t.shape[-1] != f]
    if not which:
        return list(parts)
    widths = [parts[i].shape[-1] for i in which]
    both = gather_from_model(torch.cat([parts[i] for i in which], dim=-1)[None], tp)
    out = list(parts)
    for i, piece in zip(which, both.split(widths, dim=-1)):
        # (M, B, S, w) -> (B, S, M w): rank r's block at columns r w
        out[i] = piece.movedim(0, -2).reshape(*piece.shape[1:-1], -1)
    return out


def heads_to_seq(tp, kv, idx: int, blk: SeqBlock):
    """The heads-to-sequence exchange of a prefill's K/V: ``kv`` (B, S, n,
    w), this rank's n KV heads (a block of n M in head order) of the rows
    [idx, idx + S); returns this rank's rows of its cache block, with every
    head, (B, r, n M, w), and their first row in the block.  One all-to-all
    over the model group: rank j is sent the rows inside its block."""
    b, s, n, w = kv.shape
    m = tp.size
    spans = [(max(idx, j * blk.rows), min(idx + s, (j + 1) * blk.rows))
             for j in range(m)]
    send = [max(hi - lo, 0) for lo, hi in spans]
    mine = send[tp.index]
    got = all_to_all_model(kv.transpose(0, 1), tp, send, [mine] * m)  # (m r, B, n, w)
    got = got.reshape(m, mine, b, n, w).permute(2, 1, 0, 3, 4)
    return got.reshape(b, mine, m * n, w), spans[tp.index][0] - blk.offset


def attention_tp(p, x, cfg: ModelConfig, positions, cache, tp):
    """``attention_block`` on a model axis (module docstring): p holds this
    rank's blocks; the cache (``cache["block"]``, a ``SeqBlock``) this
    rank's rows of K and V, every head."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g, m = h // hkv, tp.size
    q, k, v = _projections(p, x, cfg, cross=False, tp=tp)
    idx = cache["index"] if cache is not None else 0
    blk = cache["block"] if cache is not None else None
    if blk is not None and idx + s > blk.total:
        raise ValueError(f"KV cache overflow: writing {s} rows at {idx} of a "
                         f"{blk.total}-row cache")

    if s == 1 and cache is not None:
        # a decode step: the step's heads whole on every rank
        q, k, v = _whole_columns(tp, [q, k, v], [h * hd, hkv * hd, hkv * hd])
        q, k = _rotated(p, q.reshape(b, 1, h, hd), k.reshape(b, 1, hkv, hd),
                        cfg, positions)
        ck, cv = cache["k"], cache["v"]
        if blk.offset <= idx < blk.offset + blk.rows:       # the row's owner
            ck[:, idx - blk.offset] = k[:, 0]
            cv[:, idx - blk.offset] = v.reshape(b, hkv, hd)
        kernels = registry.resolve(x.device.type)
        qg = q.reshape(b, hkv, g, hd)
        if blk.rows == blk.total:                           # S replicated
            out = kernels.decode_attention(qg, ck, cv, cache["length"])
        else:
            part = kernels.decode_attention_partial(qg, ck, cv,
                                                    cache["length_block"])
            out = kernels.decode_attention_merge(tp.all_gather(part[None]),
                                                 dtype=q.dtype)
        return row_parallel(out.reshape(b, 1, h * hd), p["wo"], tp, h * hd)

    local = (q.shape[-1] != h * hd and k.shape[-1] != hkv * hd
             and h % m == 0 and hkv % m == 0)
    if local:
        # this rank's query heads and their KV heads; the per-head norm
        # scales, replicated, scale only these heads here
        nq, nk = h // m, hkv // m
        if cfg.qk_norm:
            p = dict(p, q_norm=copy_to_model(p["q_norm"], tp),
                     k_norm=copy_to_model(p["k_norm"], tp))
    else:
        # heads the rules do not cut whole: every head on every rank
        q, k, v = _whole_columns(tp, [q, k, v], [h * hd, hkv * hd, hkv * hd])
        nq, nk = h, hkv
    q, k = _rotated(p, q.reshape(b, s, nq, hd), k.reshape(b, s, nk, hd), cfg,
                    positions)
    v = v.reshape(b, s, nk, hd)
    heads = slice(tp.index * nk, (tp.index + 1) * nk) if local else slice(None)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        kv = torch.cat([k, v], dim=-1)
        if local and blk.rows != blk.total:
            rows, at = heads_to_seq(tp, kv, idx, blk)
        else:
            if local:                                       # S replicated
                kv = tp.all_gather(kv, dim=2)
            lo = max(idx, blk.offset)
            hi = min(idx + s, blk.offset + blk.rows)
            rows, at = kv[:, lo - idx:max(hi, lo) - idx], lo - blk.offset
        ck[:, at:at + rows.shape[1]] = rows[..., :hd]
        cv[:, at:at + rows.shape[1]] = rows[..., hd:]
        if idx:
            # a later chunk attends over the rows written before it
            kk, vv = ck, cv
            if blk.rows != blk.total:
                both = tp.all_gather(torch.cat([ck, cv], dim=-1), dim=1)
                kk, vv = both[..., :hd], both[..., hd:]
            k, v = kk[:, :idx + s, heads], vv[:, :idx + s, heads]
    out = _attend(q.reshape(b, s, nk, g, hd), k, v, cfg, True, idx)
    return row_parallel(out.reshape(b, s, nq * hd), p["wo"], tp, h * hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_hidden(p, x, dt=None, tp=None):
    """SwiGLU's hidden activations silu(x @ w_gate) * (x @ w_up); over a
    model group ``tp`` (the in-projections this rank's columns) x enters
    through ``copy_to_model``."""
    dt = dt or x.dtype
    x = copy_to_model(x, tp)
    return F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))


def swiglu(p, x, dt=None):
    dt = dt or x.dtype
    return swiglu_hidden(p, x, dt) @ p["w_down"].to(dt)


def gelu_mlp(p, x, dt=None):
    """2-matrix GELU MLP (whisper-style).  The GELU is the tanh form, the
    reference's ``jax.nn.gelu`` default (``approximate=True``); torch's
    default erf form differs by up to ~1e-3."""
    dt = dt or x.dtype
    return F.gelu(x @ p["w_up"].to(dt), approximate="tanh") @ p["w_down"].to(dt)
