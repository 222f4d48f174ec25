"""Selective state-space blocks: Mamba1 (falcon-mamba) and the reference's
simplified Mamba2/SSD (zamba2).

The port of the reference package's ``models/ssm.py``, same names, parameter
layouts and dtypes: projections in the activations' dtype; delta, B, C, the
scan and the state h in float32; the convolution tail in the activations'
dtype; y cast back before the ``silu(z)`` gate.

The reference evaluates the linear recurrence h_t = dA_t h_{t-1} + dBx_t
with ``lax.associative_scan`` inside a ``lax.scan`` over chunks, and scans a
prompt that comes with a state (a prefill into a cache) as ONE chunk.  Here
every call chunks at ``cfg.ssm_chunk`` and carries h from chunk to chunk
(the same recurrence; at 8 x 2048 tokens one chunk would be an 8 GiB
(B, S, din, state) float32 tensor for falcon-mamba-7b, 28 GiB for zamba2-7b):

- Mamba1 (a decay per (channel, state)): a loop over the chunk's steps,
  each one ``addcmul`` on (B, din, state), the step's decay and input made
  for the whole chunk first;
- Mamba2 (one scalar decay per head): the SSD form of a chunk, matrix
  products against a (c x c) decay matrix built from differences of
  cumulative log-decays, exp(L_t - L_i) for i <= t.  Never a quotient of
  cumulative products: over a 256-step chunk at delta A ~ -0.7 a step they
  underflow float32.

The scan is plain PyTorch (no TPU kernel is owed: the reference's is no
Pallas kernel); a hand-written selective scan is later work (ROADMAP.md §1
item 11.2).  A single-token step with a state is the same code at one step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig


def _causal_conv(x, w, b, kernel: int):
    """Depthwise causal conv1d: x (B, S, din), w (din, k), b (din,).

    As the reference's ``_causal_conv(x, conv_w.T, ...)``: the current
    sample is multiplied by ``w[:, 0]`` and the one k - 1 steps back by
    ``w[:, k - 1]`` (the reverse of ``F.conv1d``'s cross-correlation),
    summed in float32 in the reference's order, cast to x's dtype."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, kernel - 1, 0))
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(kernel):
        out = out + pad[:, i:i + s, :].float() * wf[:, kernel - 1 - i]
    return (out + b.float()).to(x.dtype)


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


# ---------------------------------------------------------------------------
# the scans: h_t = dA_t h_{t-1} + dBx_t, y_t = h_t . C_t, from state h
# ---------------------------------------------------------------------------

def _scan1_chunk(h, xc, dc, bc, cc, A):
    """One Mamba1 chunk: xc and dc (B, c, din), bc and cc (B, c, st)
    float32, A (din, st), h (B, din, st).  A loop over the chunk's steps,
    one addcmul each.  Returns (y (B, c, din), h after the chunk)."""
    dA = torch.exp(dc[..., None] * A)                   # (B, c, din, st)
    dBx = (dc * xc)[..., None] * bc[:, :, None, :]
    hs = []
    # the steps as one unbind each (its backward one stack), not c
    # indexings (each of whose backward would write a chunk-sized tensor)
    for dA_t, dBx_t in zip(dA.unbind(1), dBx.unbind(1)):
        h = torch.addcmul(dBx_t, dA_t, h)
        hs.append(h)
    return torch.einsum("bcds,bcs->bcd", torch.stack(hs, 1), cc), h


def _scan2_chunk(h, xc, dc, bc, cc, A):
    """One Mamba2 (SSD) chunk: xc (B, c, H, hd), dc (B, c, H), bc and cc
    (B, c, st) float32, A (H,), h (B, H, hd, st).  Returns (y (B, c, H,
    hd), h after the chunk).

    With L_t the cumulative sum of dc A over the chunk, h_t = exp(L_t) h +
    sum_{i<=t} exp(L_t - L_i) dc_i x_i (x) b_i, so y_t = h_t c_t is
    exp(L_t) (h c_t) + sum_{i<=t} exp(L_t - L_i) (c_t . b_i) dc_i x_i."""
    c = xc.shape[1]
    L = torch.cumsum(dc * A, dim=1)                     # (B, c, H), <= 0
    diff = L[:, :, None, :] - L[:, None, :, :]          # (B, t, i, H)
    causal = torch.ones((c, c), dtype=torch.bool, device=xc.device).tril()
    # masked before the exp: exp(-inf) = 0, and a zero gradient through it
    decay = torch.exp(diff.masked_fill(~causal[None, :, :, None], float("-inf")))
    gram = torch.einsum("bts,bis->bti", cc, bc)         # (B, t, i)
    w = decay * (gram[..., None] * dc[:, None, :, :])   # (B, t, i, H)
    y = torch.einsum("btih,bihp->bthp", w, xc)
    y = y + torch.einsum("bhps,bts->bthp", h, cc) * torch.exp(L)[..., None]
    last = torch.exp(L[:, -1:, :] - L) * dc             # (B, i, H)
    h = (h * torch.exp(L[:, -1])[:, :, None, None]
         + torch.einsum("bih,bihp,bis->bhps", last, xc, bc))
    return y, h


def selective_scan(cfg: ModelConfig, xs, delta, Bm, Cm, A, h):
    """The scan of one Mamba layer over S steps from state h, in chunks of
    ``cfg.ssm_chunk`` with h carried from chunk to chunk: Mamba1
    (``cfg.mamba_version`` 1) xs (B, S, din), delta (B, S, din), A (din,
    st), h (B, din, st); Mamba2 xs (B, S, H, hd), delta (B, S, H), A (H,),
    h (B, H, hd, st); Bm and Cm (B, S, st); all float32.  Returns (y like
    xs, h after the last step)."""
    chunk = _scan1_chunk if cfg.mamba_version == 1 else _scan2_chunk
    c = max(1, min(cfg.ssm_chunk, xs.shape[1]))
    ys = []
    for xc, dc, bc, cc in zip(*(t.split(c, dim=1) for t in (xs, delta, Bm, Cm))):
        y, h = chunk(h, xc, dc, bc, cc, A)
        ys.append(y)
    return (torch.cat(ys, 1) if len(ys) > 1 else ys[0]), h


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def scan_inputs(p: dict, x, cfg: ModelConfig, state=None):
    """A Mamba block up to its scan: the in-projection, the causal
    convolution (after the cached tail when a state is given) and its silu,
    and the input-dependent SSM parameters.  Returns (x1, z, the new conv
    tail or None, the scan's (xs, delta, Bm, Cm, A, h0)); version 1 is
    Mamba1 (a low-rank delta per channel), 2 the SSD block (delta per
    head)."""
    b, s, _ = x.shape
    din, st, k = cfg.din, cfg.ssm_state, cfg.conv_kernel
    dt = x.dtype
    xz = x @ p["in_proj"].to(dt)                        # (B, S, 2*din)
    x1, z = torch.chunk(xz, 2, dim=-1)
    if state is None:
        x1, tail = _causal_conv(x1, p["conv_w"], p["conv_b"], k), None
    else:
        seq = torch.cat([state[0], x1], dim=1)          # (B, k-1+s, din)
        x1 = _causal_conv(seq, p["conv_w"], p["conv_b"], k)[:, k - 1:, :]
        tail = seq[:, seq.shape[1] - (k - 1):, :]
    x1 = F.silu(x1)

    if cfg.mamba_version == 1:
        dt_lr = x1 @ p["w_dtx"].to(dt)                  # (B, S, rank)
        pre = dt_lr @ p["w_dt"].to(dt)                  # (B, S, din)
        xs = x1.float()
        hs = (b, din, st)
    else:
        H = din // cfg.mamba_headdim
        pre = x1 @ p["w_dt"].to(dt)                     # (B, S, H)
        xs = x1.float().reshape(b, s, H, cfg.mamba_headdim)
        hs = (b, H, cfg.mamba_headdim, st)
    delta = F.softplus(pre.float() + p["dt_bias"].float())
    Bm = (x1 @ p["w_B"].to(dt)).float()                 # (B, S, st)
    Cm = (x1 @ p["w_C"].to(dt)).float()                 # (B, S, st)
    A = -torch.exp(p["A_log"].float())                  # (din, st) / (H,)
    h = (torch.zeros(hs, dtype=torch.float32, device=x.device)
         if state is None else state[1])
    return x1, z, tail, (xs, delta, Bm, Cm, A, h)


def _forward(p: dict, x, cfg: ModelConfig, state):
    b, s, _ = x.shape
    x1, z, tail, args = scan_inputs(p, x, cfg, state)
    y, h = selective_scan(cfg, *args)
    y = y.reshape(b, s, cfg.din) + args[0].reshape(b, s, cfg.din) * p["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"].to(x.dtype)
    return out, (None if state is None else (tail, h))


def mamba1_forward(p: dict, x, cfg: ModelConfig, state=None):
    """x: (B, S, d).  state: None (train) or (conv_tail, h) for decode.

    Returns (y, new_state): new_state (conv_tail (B, k-1, din), h (B, din,
    state) float32) when a state is given, else None."""
    return _forward(p, x, cfg.replace(mamba_version=1), state)


def mamba1_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    din, st, d, k = cfg.din, cfg.ssm_state, cfg.d_model, cfg.conv_kernel
    r = dt_rank(cfg)
    return {
        "in_proj": (d, 2 * din), "conv_w": (din, k), "conv_b": (din,),
        "w_dtx": (din, r), "w_dt": (r, din), "dt_bias": (din,),
        "w_B": (din, st), "w_C": (din, st),
        "A_log": (din, st), "D": (din,), "out_proj": (din, d),
    }


def mamba2_forward(p: dict, x, cfg: ModelConfig, state=None):
    """Simplified SSD block (scalar A per head, B and C shared by a head's
    channels, no gated norm).  x: (B, S, d).  Returns (y, new_state) as
    ``mamba1_forward``, h (B, H, headdim, state)."""
    return _forward(p, x, cfg.replace(mamba_version=2), state)


def mamba2_param_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    din, st, d, k = cfg.din, cfg.ssm_state, cfg.d_model, cfg.conv_kernel
    H = din // cfg.mamba_headdim
    return {
        "in_proj": (d, 2 * din), "conv_w": (din, k), "conv_b": (din,),
        "w_dt": (din, H), "dt_bias": (H,),
        "w_B": (din, st), "w_C": (din, st),
        "A_log": (H,), "D": (din,), "out_proj": (din, d),
    }


def ssm_state_shapes(cfg: ModelConfig, batch: int) -> tuple[tuple, tuple]:
    """(conv_tail, h) shapes for one layer's decode state."""
    din, st, k = cfg.din, cfg.ssm_state, cfg.conv_kernel
    if cfg.mamba_version == 2:
        H = din // cfg.mamba_headdim
        return ((batch, k - 1, din), (batch, H, cfg.mamba_headdim, st))
    return ((batch, k - 1, din), (batch, din, st))
