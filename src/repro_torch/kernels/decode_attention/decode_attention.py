"""decode_attention: single-token grouped-query attention over a KV cache.

  decode_attention(q, k, v, length)
      q (B, Hkv, G, hd), k and v (B, S, Hkv, hd), length (B,) int32.
      Query head h = kv * G + g attends over the rows [0, length[b]) of its
      KV head; scores, softmax and accumulation in float32, scale
      1 / sqrt(hd); the result (B, Hkv, G, hd) in q's dtype.

Replaces the TPU kernel ``decode_attention_pallas`` of the reference
package's ``kernels/decode_attention/decode_attention.py``.  The CUDA kernel
is ``csrc/decode_attention.cu`` (float32 and bfloat16; hd any multiple of
16 bytes' values up to 128: of 8 in bfloat16, of 4 in float32, so zamba2's
112 too; G from 1 to 8; see its header).  The plain version is the math of the
reference's oracle ``ref.py::decode_attention_ref``.  The contract is
1 <= length <= S, which the decode path always meets (length = index + 1).
The registry hands CPU callers the plain version and CUDA callers the
kernel, which raises on anything but CUDA tensors.
"""
from __future__ import annotations

import math

import torch

from .. import cuda

MAX_HEAD_DIM = 128
MAX_GROUP = 8


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


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: float32 or bfloat16 q, k, v of one dtype,
    int32 lengths, all contiguous on the card."""
    dtypes = (torch.float32, torch.bfloat16)
    cuda.require("decode_attention", q, dtypes, "q", ndim=4)
    cuda.require("decode_attention", k, (q.dtype,), "k", ndim=4)
    cuda.require("decode_attention", v, (q.dtype,), "v", ndim=4)
    cuda.require("decode_attention", length, (torch.int32,), "length")
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
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q, k and v must be 16-byte "
                             "aligned")
    out = torch.empty_like(q)
    if b * hkv == 0:
        return out
    lib = cuda.load("decode_attention")
    cuda.check(lib.decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
        out.data_ptr(), b, s, hkv, g, hd, int(q.dtype == torch.bfloat16),
        1.0 / math.sqrt(hd), cuda.stream_of(q)), "decode_attention")
    cuda.launches["decode_attention"] += 1
    return out
