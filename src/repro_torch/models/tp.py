"""Tensor-parallel collectives that autograd differentiates.

The reference has no counterpart: on a (data, model) mesh GSPMD derives
every collective of the backward pass from the forward's shardings.  Over a
``launch/mesh.py`` ``Group`` (the mesh's "model" group, M ranks), each
operator here is a ``torch.autograd.Function`` whose forward is the
collective the serving path already issued (the same call, so serving's
outputs keep their bits) and whose backward is Megatron's transpose of it:

- ``copy_to_model`` (Megatron's *f*): the identity forward, an all-reduce
  backward.  It goes where a replicated activation enters a product on this
  rank's columns (q/k/v, the SwiGLU in-projections, the experts, the
  vocabulary-parallel head): each rank's cotangent is its columns' part of
  the whole, and the sum over the ranks is the whole.
- ``reduce_from_model`` (*g*): an all-reduce forward (float32, one rounding
  at the end), the identity backward: the sum is replicated, so is its
  cotangent.
- ``gather_from_model``: an all-gather forward whose backward SLICES this
  rank's block of the incoming cotangent.  It must not reduce-scatter: the
  gathered tensor feeds a computation every rank repeats identically, so
  every rank's cotangent is already the whole one (replicated, not
  partial); a reduce-scatter would count it M times.  What follows a
  gather must therefore stay replicated up to a *g*: where a row-parallel
  product takes a block of a replicated tensor it does so through
  ``scatter_to_model`` (the slice forward, an all-gather backward).
- ``all_to_all_model``: the heads-to-sequence exchange of a prefill's K/V,
  with the reverse all-to-all as its backward.  The no-cache training
  forward does not reach it: it runs on this rank's heads and writes no
  cache (``layers.attention_tp``); only a cache-filling prefill exchanges.
- ``vocab_parallel_token_loss``: ``lm.token_loss`` over this rank's (B, S,
  V/M) block of the logits without gathering them: a detached max
  all-reduce, one all-reduce of the sum of exponentials and of the gold
  logit (taken on the rank whose block holds the label), and a backward of
  ``softmax_block - onehot_block`` on each rank.

Over a group of one member (or None) every operator is the identity.  The
collectives are the group's own, counted in the mesh's ``counts``.
"""
from __future__ import annotations

import torch


def _live(group) -> bool:
    return group is not None and group.size > 1


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32, copy=True)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.group.all_reduce(_f32_copy(dy)).to(dy.dtype), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, dtype):
        ctx.dtype = y.dtype
        return group.all_reduce(_f32_copy(y)).to(dtype)

    @staticmethod
    def backward(ctx, dy):
        return dy.to(ctx.dtype), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, dy):
        # replicated cotangents: this rank's block, never a sum
        return dy.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.index * n, n)

    @staticmethod
    def backward(ctx, dy):
        return ctx.group.all_gather(dy.contiguous(), ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send, recv):
        ctx.group, ctx.send, ctx.recv = group, list(send), list(recv)
        return group.all_to_all(x, send, recv)

    @staticmethod
    def backward(ctx, dy):
        return ctx.group.all_to_all(dy, ctx.recv, ctx.send), None, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """*f*: ``x`` (replicated over ``group``) as it enters a product on this
    rank's columns; the backward sums the ranks' cotangents (float32)."""
    return _Copy.apply(x, group) if _live(group) else x


def reduce_from_model(y: torch.Tensor, group, dtype=None) -> torch.Tensor:
    """*g*: the sum over ``group`` of the ranks' partial ``y`` in float32,
    rounded once to ``dtype`` (y's by default); the backward is the
    identity."""
    dtype = dtype or y.dtype
    if not _live(group):
        return y.to(dtype)
    return _Reduce.apply(y, group, dtype)


def gather_from_model(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The members' ``x`` concatenated along ``dim`` in member order; the
    backward takes this rank's block of the (replicated) cotangent."""
    return _Gather.apply(x, group, dim) if _live(group) else x


def scatter_to_model(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` (replicated over
    ``group``); the backward all-gathers the blocks' cotangents into the
    whole (replicated) one."""
    if not _live(group):
        return x
    return _Scatter.apply(x, group, dim % x.dim())


def all_to_all_model(x: torch.Tensor, group, send: list[int],
                     recv: list[int]) -> torch.Tensor:
    """``Group.all_to_all`` (rows ``send[j]`` of ``x`` to member j, ``recv[i]``
    from member i); the backward sends the cotangents' rows back."""
    return _AllToAll.apply(x, group, send, recv) if _live(group) else x


class _VocabCE(torch.autograd.Function):
    """Per-position ``logsumexp - gold`` of a (B, S, V/M) logits block."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        lf = logits.float()
        rows = lf.shape[-1]
        m = group.all_reduce(lf.amax(-1), "max")                 # (B, S)
        e = torch.exp(lf - m[..., None])
        local = labels.long() - group.index * rows
        mine = (local >= 0) & (local < rows) & (labels >= 0)
        at = torch.where(mine, local, 0)
        gold = torch.where(mine, torch.gather(lf, -1, at[..., None])[..., 0], 0.0)
        both = group.all_reduce(torch.stack([e.sum(-1), gold]))  # (2, B, S)
        sumexp, gold = both[0], both[1]
        ctx.save_for_backward(e, sumexp, at, mine)
        ctx.dtype = logits.dtype
        return torch.log(sumexp) + m - gold

    @staticmethod
    def backward(ctx, dnll):
        e, sumexp, at, mine = ctx.saved_tensors
        grad = e / sumexp[..., None]
        grad.scatter_add_(-1, at[..., None], -mine.to(grad.dtype)[..., None])
        return grad.mul_(dnll[..., None]).to(ctx.dtype), None, None


def vocab_parallel_token_loss(logits: torch.Tensor, labels: torch.Tensor, tp,
                              group=None) -> torch.Tensor:
    """``lm.token_loss`` of the whole logits, from this rank's block of the
    vocabulary (``logits`` (B, S, V/M), rank r holding columns r V/M
    onward) over the model group ``tp``: float32 ``logsumexp - gold`` at
    every position whose label is >= 0, the mean over those positions (at
    least 1); over a data ``group``, this rank's sum over the whole group's
    count.  No (B, S, V) tensor is made: the collectives move (B, S) float32
    rows."""
    nll = _VocabCE.apply(logits, labels, tp)
    mask = (labels >= 0).float()
    count = mask.sum()
    if group is not None:
        count = group.all_reduce(count)
    return (nll * mask).sum() / torch.clamp(count, min=1.0)
