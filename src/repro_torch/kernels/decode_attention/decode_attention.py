"""decode_attention: single-token grouped-query attention over a KV cache.

  decode_attention(q, k, v, length)
      q (B, Hkv, G, hd), k and v (B, S, Hkv, hd), length (B,) int32.
      Query head h = kv * G + g attends over the rows [0, length[b]) of its
      KV head; scores, softmax and accumulation in float32, scale
      1 / sqrt(hd); the result (B, Hkv, G, hd) in q's dtype.

Replaces the TPU kernel ``decode_attention_pallas`` of the reference
package's ``kernels/decode_attention/decode_attention.py``, which carries
the online softmax from S block to S block in VMEM.  The CUDA kernel is
``csrc/decode_attention.cu`` (float32 and bfloat16; hd any multiple of 16
bytes' values up to 128: of 8 in bfloat16, of 4 in float32, so zamba2's 112
too; G from 1 to 8).  It is bound by the bytes of K and V, and streams them
at the card's rate only with many blocks in flight, so it splits S:
:func:`split_plan` gives B * Hkv * splits about two blocks an SM where the
pairs alone leave SMs idle and S allows, from the shapes and the card's SM
count alone (never from ``length``); each block stages its rows through a
ring of TMA tensor copies, takes q . K^T and P . V in bfloat16 on tensor
cores, and writes its partial softmax; a second launch folds the splits in
split order, so the same inputs give the same bits on every call.  The
tolerances hold: bf16 products are exact in the float32 accumulator, and P
enters P . V as three bf16 terms whose sum is within 2^-24 p of p, as close
as float32 holds it (one bf16 rounding of P would miss the 2e-5 absolute
tolerance where an output is near 0).  See the source's header.

  decode_attention_partial(q, k, v, length)
      The same over one rank's block of a cache sharded along S (the
      reference's ``cache_spec_for``), length (B,) int32 in [0, S]: the
      block's float32 partial softmax (B, Hkv, G, hd + 2), the numerators
      (the weighted sums of V's rows, undivided), then the max and the sum
      of each query head's scores.  A block with no row below its length
      gives max -1e30 (weight exp(-1e30 - m) = 0 against any real max) and
      sum 0, never NaN.
  decode_attention_merge(partials, dtype=torch.float32)
      M partials (M, B, Hkv, G, hd + 2), in rank order, folded in index
      order into the output (B, Hkv, G, hd) in ``dtype``.  Over the M blocks
      of a cache, with each block's length clamp(length - r S_loc, 0,
      S_loc), the composition is ``decode_attention`` over the whole S, up
      to the order of float32 sums: GSPMD's flash-decoding combine
      across devices (the reference's ``layers.py`` decode), done here by
      hand.  On the card both run the same source's kernels: the split
      kernel writes the partial whatever the split plan (with several
      splits the combine folds them into it, undivided), and the combine
      folds the M partials as it folds splits, so the bits repeat.

The plain versions are the math of the reference's oracle
``ref.py::decode_attention_ref``.  The contract is 1 <= length <= S, which
the decode path always meets (length = index + 1).  The registry hands CPU
callers the plain version and CUDA callers the kernel, which raises on
anything but CUDA tensors.  A call reads no device value on the host and
does not synchronise: the plan and the checks that depend on shapes alone
are made once per shape, so the decode step can be captured in a CUDA
graph.
"""
from __future__ import annotations

import math

import torch

from .. import cuda

MAX_HEAD_DIM = 128
MAX_GROUP = 8
# rows a warp stages at once, warps a block and the most splits
# (csrc/decode_attention.cu)
TILE = 16
WARPS = 4
MAX_SPLITS = 512
# the plan's targets: blocks an SM, and the largest share of a split's K/V
# bytes its partial (max, sum, numerator in float32) may add, written once
# and read once (tools/decode_attention_study.py chose them)
BLOCKS_PER_SM = 2
PARTIAL_SHARE = 1 / 16


def min_split_rows(g: int, hd: int, itemsize: int) -> int:
    """The fewest rows a split may have: one tile for each warp, and enough
    that its partial, 8 * G * (hd + 2) bytes written and read, stays within
    PARTIAL_SHARE of its 2 * hd * itemsize bytes of K and V a row."""
    return max(WARPS * TILE, math.ceil(
        8 * g * (hd + 2) / (PARTIAL_SHARE * 2 * hd * itemsize)))


def split_plan(b: int, hkv: int, s: int, g: int, hd: int, itemsize: int,
               sms: int) -> tuple[int, int]:
    """(splits, rows per split) for B * Hkv (b, kv head) pairs over S rows.
    One split where the pairs cover the SMs; else the fewest rows, a
    multiple of TILE and at least :func:`min_split_rows`, that give B * Hkv
    * splits >= BLOCKS_PER_SM * sms, with at most MAX_SPLITS splits.  Every
    split's first row lies below S.  Shapes only: the plan never reads
    length."""
    if min(b, hkv, s, g, hd, itemsize, sms) < 1:
        raise ValueError(f"decode_attention: no split plan for B {b}, Hkv "
                         f"{hkv}, S {s}, G {g}, hd {hd}, {itemsize}-byte "
                         f"values, {sms} SMs")
    want = 1 if b * hkv >= sms else -(-BLOCKS_PER_SM * sms // (b * hkv))
    rows = max(min_split_rows(g, hd, itemsize), -(-s // want),
               -(-s // MAX_SPLITS))
    rows = -(-rows // TILE) * TILE
    return -(-s // rows), rows


_SMS: dict[int, int] = {}


def sm_count(device: int) -> int:
    """The SM count of card ``device``, read once."""
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: masked float32 softmax attention."""
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / math.sqrt(hd)
    pos = torch.arange(k.shape[1], device=k.device)
    mask = pos[None, None, None, :] < length.to(k.device)[:, None, None, None]
    s = torch.where(mask, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("bhgs,bshd->bhgd", p, v.float()).to(q.dtype)


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor,
                                   length: torch.Tensor) -> torch.Tensor:
    """The plain partial: the masked float32 scores' max over the rows
    below length (-1e30 where there is none), exp(s - max) on those rows
    and 0 elsewhere (not the plain version's uniform weights over a fully
    masked row), their sum, and the undivided P . V."""
    hd = q.shape[-1]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) / math.sqrt(hd)
    pos = torch.arange(k.shape[1], device=k.device)
    mask = pos[None, None, None, :] < length.to(k.device)[:, None, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    num = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return torch.cat([num, m, p.sum(-1, keepdim=True)], dim=-1)


def decode_attention_merge_plain(partials: torch.Tensor,
                                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain merge: the log-sum-exp fold of the partials, in index
    order."""
    m = partials[..., -2].amax(0)
    num = torch.zeros_like(partials[0, ..., :-2])
    den = torch.zeros_like(m)
    for part in partials:
        w = torch.exp(part[..., -2] - m)
        num = num + part[..., :-2] * w[..., None]
        den = den + part[..., -1] * w
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(dtype)


# (shapes, dtypes, card, entry) -> (the C function, its shape and plan
# arguments, float32 workspace values or 0 without a split, whether B * Hkv
# == 0)
_PLANS: dict = {}


def _checked_plan(q, k, v, length, key, partial: bool) -> tuple:
    """Every check, in the order the refusals are pinned (a call whose
    shapes have a plan comes here only to raise); then the plan, kept under
    ``key``: ``decode_attention``'s, or with ``partial``
    ``decode_attention_partial``'s."""
    name = "decode_attention_partial" if partial else "decode_attention"
    dtypes = (torch.float32, torch.bfloat16)
    cuda.require(name, q, dtypes, "q", ndim=4)
    cuda.require(name, k, (q.dtype,), "k", ndim=4)
    cuda.require(name, v, (q.dtype,), "v", ndim=4)
    cuda.require(name, length, (torch.int32,), "length")
    b, hkv, g, hd = q.shape
    s = k.shape[1]
    if tuple(k.shape) != (b, s, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k and v must be (B, S, Hkv, hd) = "
                         f"{(b, s, hkv, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if tuple(length.shape) != (b,):
        raise ValueError(f"decode_attention: length must be ({b},), got "
                         f"{tuple(length.shape)}")
    vec = 16 // q.element_size()          # values in one 16-byte load
    if not (0 < hd <= MAX_HEAD_DIM and hd % vec == 0) \
            or not 1 <= g <= MAX_GROUP or s < 1:
        raise ValueError(f"decode_attention: hd {hd} not a multiple of {vec} "
                         f"up to {MAX_HEAD_DIM}, or G {g} outside [1, "
                         f"{MAX_GROUP}], or S {s} < 1")
    empty = b * hkv == 0
    splits, rows = (1, -(-s // TILE) * TILE) if empty else split_plan(
        b, hkv, s, g, hd, q.element_size(), sm_count(q.get_device()))
    args = (b, s, hkv, g, hd, int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(hd), splits, rows)
    ws = b * hkv * splits * g * (hd + 2) if splits > 1 else 0
    fn = None if empty else getattr(cuda.load("decode_attention"), name)
    plan = _PLANS[key] = (fn, args, ws, empty)
    return plan


def _launch(q, k, v, length, partial: bool) -> torch.Tensor:
    """One call of ``decode_attention`` or, with ``partial``,
    ``decode_attention_partial`` on the card."""
    name = "decode_attention_partial" if partial else "decode_attention"
    key = (q.shape, k.shape, v.shape, length.shape, q.dtype, k.dtype, v.dtype,
           length.dtype, q.get_device(), partial)
    plan = _PLANS.get(key)
    if plan is None or not (
            k.is_cuda and v.is_cuda and length.is_cuda and q.is_contiguous()
            and k.is_contiguous() and v.is_contiguous()
            and length.is_contiguous()):
        plan = _checked_plan(q, k, v, length, key, partial)
    fn, args, ws_values, empty = plan
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) & 15:
        raise ValueError(f"{name}: q, k and v must be 16-byte aligned")
    out = (q.new_empty((*q.shape[:-1], q.shape[-1] + 2), dtype=torch.float32)
           if partial else torch.empty_like(q))
    if empty:
        return out
    ws = q.new_empty(ws_values, dtype=torch.float32) if ws_values else None
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    cuda.check(fn(
        qp, kp, vp, length.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), *args, stream), name)
    cuda.launches[name] += 1
    return out


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: float32 or bfloat16 q, k, v of one dtype,
    int32 lengths, all contiguous on the card."""
    return _launch(q, k, v, length, partial=False)


def decode_attention_partial_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  length: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel for a block's partial: the inputs as
    ``decode_attention_cuda``'s, length in [0, S]."""
    return _launch(q, k, v, length, partial=True)


def decode_attention_merge_cuda(partials: torch.Tensor,
                                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the combine kernel over M partials, (M, B, Hkv, G, hd + 2)
    float32 contiguous on the card, into a (B, Hkv, G, hd) output of
    ``dtype`` (float32 or bfloat16)."""
    name = "decode_attention_merge"
    cuda.require(name, partials, (torch.float32,), "partials", ndim=5)
    m, b, hkv, g, w = partials.shape
    hd = w - 2
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {dtype} not float32 or bfloat16")
    if not (1 <= m <= MAX_SPLITS and 0 < hd <= MAX_HEAD_DIM and g >= 1):
        raise ValueError(f"{name}: {m} partials (1 .. {MAX_SPLITS}) of hd "
                         f"{hd} (1 .. {MAX_HEAD_DIM}) and G {g}")
    out = partials.new_empty((b, hkv, g, hd), dtype=dtype)
    if b * hkv == 0:
        return out
    stream = torch._C._cuda_getCurrentRawStream(partials.get_device())
    cuda.check(cuda.load("decode_attention").decode_attention_merge(
        partials.data_ptr(), out.data_ptr(), m, b * hkv, g, hd,
        int(dtype == torch.bfloat16), stream), name)
    cuda.launches[name] += 1
    return out
