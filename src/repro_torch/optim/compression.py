"""Gradient compression: an int8 quantised sum over ranks with error
feedback.

The port of the reference package's ``optim/compression.py``.  Each rank
adds its carried error to its gradient, every rank quantises with ONE
scale (the max over ranks of the local amax, a scalar all-reduce), the
int8 payloads are summed over the ranks as int32 (exact for P <= 2^23, as
the reference sums them), and the quantisation error is carried into the
next step's gradient (error feedback, Karimireddy et al. 2019).

As in the reference the int8 payload is widened to int32 before the sum,
so the sum moves as many bytes as a float32 one; the group's counts
(``launch/mesh.py::Group``) report them.  The reference calls
``compressed_psum`` from no train step (only from its tests), and neither
does the port: it is a function over a group.
"""
from __future__ import annotations

import torch

from ..models.lm import tree_map


def quantize(g: torch.Tensor, bits: int = 8):
    """Symmetric per-tensor int quantisation: (q int8, scale float32)."""
    assert bits == 8
    gf = g.float()
    scale = torch.clamp(gf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group):
    """The quantised mean over ``group``'s ranks (a ``launch/mesh.py``
    ``Group``) of one gradient tensor, with error feedback.

    g: this rank's gradient; err: its carried float32 error buffer.
    Returns (g_mean in g's dtype, new_err).  Every rank agrees on one scale
    before it quantises, so the summed payload dequantises exactly."""
    corrected = g.float() + err
    amax = corrected.abs().max()
    scale = torch.clamp(group.all_reduce(amax, "max") / 127.0, min=1e-12)
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    # the int8 payload summed as int32 (no overflow for P <= 2^23)
    qsum = group.all_reduce(q.to(torch.int32))
    g_mean = (qsum.float() * scale / group.size).to(g.dtype)
    new_err = corrected - dequantize(q, scale)
    return g_mean, new_err


def tree_compressed_psum(grads: dict, errs: dict, group):
    """``compressed_psum`` over every leaf: (tree of means, tree of errors)."""
    out = tree_map(lambda g, e: compressed_psum(g, e, group), grads, errs)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def init_error_buffers(params: dict) -> dict:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
