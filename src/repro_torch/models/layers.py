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

Not ported yet: the reference's GSPMD constraints (``set_tp_mesh``,
``_pin_cache_sharding``, ``_seq_shard_qkv``; they wait for the model axis,
ROADMAP.md §1 item 11.7, and do nothing on the data axes or on one card).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import registry
from .config import ModelConfig

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


def attention_block(p, x, cfg: ModelConfig, positions, cache=None,
                    layer_cross_kv=None, cross_length=None):
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
    """
    b, s, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    q = q.reshape(b, s, h, hd)
    cross = layer_cross_kv is not None
    if cross:
        k, v = layer_cross_kv
    else:
        k = x @ p["wk"].to(dt)
        v = x @ p["wv"].to(dt)
        if cfg.qkv_bias:
            k = k + p["bk"].to(dt)
            v = v + p["bv"].to(dt)
        k = k.reshape(b, s, hkv, hd)
        v = v.reshape(b, s, hkv, hd)

    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        if not cross:
            k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if not cross and positions is not None:
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

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
    elif k.shape[1] <= ATTN_CHUNK_THRESHOLD and s <= ATTN_CHUNK_THRESHOLD:
        out = attention_scores(qg, k, v, causal=not cross, q_offset=q_offset)
    else:
        out = attention_chunked(qg, k, v, causal=not cross, q_offset=q_offset,
                                kv_chunk=cfg.kv_chunk)
    return out.reshape(b, s, h * hd) @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(p, x, dt=None):
    dt = dt or x.dtype
    g = F.silu(x @ p["w_gate"].to(dt))
    u = x @ p["w_up"].to(dt)
    return (g * u) @ p["w_down"].to(dt)


def gelu_mlp(p, x, dt=None):
    """2-matrix GELU MLP (whisper-style).  The GELU is the tanh form, the
    reference's ``jax.nn.gelu`` default (``approximate=True``); torch's
    default erf form differs by up to ~1e-3."""
    dt = dt or x.dtype
    return F.gelu(x @ p["w_up"].to(dt), approximate="tanh") @ p["w_down"].to(dt)
