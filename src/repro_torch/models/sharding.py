"""Sharding rules: parameter, batch and cache specs for a mesh, and the
blocks they give each rank.

The port of the reference package's ``models/sharding.py``: the same rules,
as pure functions of a mesh's axis names and sizes (``launch/mesh.py``) and
a leaf's path and shape.  Megatron-style tensor parallelism on the "model"
axis (column-parallel in-projections, row-parallel out-projections),
experts sharded for EP, the vocabulary sharded for the embedding and the
head, decode caches sharded along the sequence on "model", batches over
("pod", "data").  A dim that does not divide its axes is replicated.

A spec is the port's stand-in for a ``PartitionSpec``: a tuple with one
entry a dim, each an axis name, a tuple of names or None, trailing Nones
dropped (``spec``; a tuple of one name is the name, as jax normalises it).

``shard`` and ``gather`` move between a whole tensor and this rank's block
of it; ``shard_params`` and ``shard_cache`` cut a parameter or cache tree
into this rank's blocks by the rules, and ``seq_block`` gives a rank's rows
of a cache sharded along S.  On a mesh the port trains and serves the
dense and moe families over data and model axes (``launch/steps.py``,
``optim/adamw.py``, ``models/{layers,moe,lm,tp}.py``): a block the rules
give a rank is what it holds, computes and differentiates (the leaves of
``shard_params`` are the train step's parameters), a dim they replicate is
computed whole on every rank.  The ssm channel sharding and the vlm,
hybrid and encdec families on a model axis wait for ROADMAP.md §1 item
11.7c.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from .config import ModelConfig


def spec(*entries) -> tuple:
    """A normalised spec: lists as tuples, a tuple of one name as the name,
    trailing Nones dropped."""
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            if len(e) == 1:
                e = e[0]
        out.append(e)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(math.prod(mesh.shape[a] for a in axes))


def fit_spec(mesh, shape: tuple, want: tuple) -> tuple:
    """Drop sharding on dims that don't divide their axes."""
    return spec(*(None if ax is None or dim % _axsize(mesh, ax) != 0 else ax
                  for dim, ax in zip(shape, want)))


# -- trees ---------------------------------------------------------------------


def is_leaf(x) -> bool:
    """A tensor, or a (shape, dtype) pair of the port's spec trees."""
    return isinstance(x, torch.Tensor) or (
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], torch.dtype))


def shape_of(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else tuple(leaf[0])


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts and tuples (a cache's (conv, h)
    pair), a tuple's entries named by their index as jax names them."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if not is_leaf(tree) and isinstance(tree, (tuple, list)):
        return tuple(map_with_path(fn, v, path + (str(i),))
                     for i, v in enumerate(tree))
    return fn(path, tree)


# -- parameters ------------------------------------------------------------------

_COL_PARALLEL = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up",
                 "in_proj", "w_dtx", "w_B", "w_C", "w_dt", "enc_in_proj")
_ROW_PARALLEL = ("wo", "w_down", "out_proj")
_VOCAB = ("embed", "lm_head")
_CHANNEL = ("conv_w", "conv_b", "A_log", "D", "dt_bias")


def param_spec_for(mesh, path: tuple[str, ...], shape: tuple) -> tuple:
    name = path[-1]
    want = [None] * len(shape)
    if "experts" in path:
        # (L, E, d, ff): EP, shard experts
        want[1] = "model"
    elif name in _VOCAB:
        want = ["model", None]
    elif name in _COL_PARALLEL:
        want[-1] = "model"
    elif name in _ROW_PARALLEL:
        want[-2] = "model"
    elif name in _CHANNEL:
        # (L, din, ...): shard the channel dim
        if len(shape) >= 2:
            want[1] = "model"
    else:
        return spec()          # norms, router, scalars: replicated
    return fit_spec(mesh, shape, tuple(want))


def param_shardings(cfg: ModelConfig, mesh, specs) -> Any:
    """The spec of every leaf of a parameter tree (tensors or (shape,
    dtype) pairs)."""
    return map_with_path(lambda path, leaf: param_spec_for(mesh, path, shape_of(leaf)),
                         specs)


# -- batches ---------------------------------------------------------------------


def batch_spec(mesh, name: str, shape: tuple) -> tuple:
    dp = dp_axes(mesh)
    if name == "positions" and len(shape) == 3:      # (3, B, S) mrope
        return fit_spec(mesh, shape, (None, dp, None))
    if len(shape) >= 2:
        return fit_spec(mesh, shape, (dp,) + (None,) * (len(shape) - 1))
    return spec()


def batch_shardings(mesh, batch_specs: dict) -> dict:
    return {k: batch_spec(mesh, k, shape_of(v))
            for k, v in batch_specs.items() if v is not None}


# -- decode caches ---------------------------------------------------------------


def cache_spec_for(mesh, path: tuple[str, ...], shape: tuple) -> tuple:
    dp = dp_axes(mesh)
    name = path[-1]
    if name in ("k", "v", "xk", "xv"):
        # (L, B, S, hkv, hd): batch over dp, SEQUENCE over model
        return fit_spec(mesh, shape, (None, dp, "model", None, None)[:len(shape)])
    if name == "index":
        return spec()
    # ssm states: (L, B, ..., din/H, ...), channels on model
    if len(shape) >= 3:
        want = [None, dp] + [None] * (len(shape) - 2)
        want[2] = "model"
        return fit_spec(mesh, shape, tuple(want))
    return spec()


def cache_shardings(mesh, specs) -> Any:
    return map_with_path(lambda path, leaf: cache_spec_for(mesh, path, shape_of(leaf)),
                         specs)


# -- blocks ----------------------------------------------------------------------


def local_shape(shape: tuple, sp: tuple, mesh) -> tuple:
    """The shape of a rank's block of a ``shape`` tensor under ``sp``."""
    return tuple(d // _axsize(mesh, sp[i]) if i < len(sp) else d
                 for i, d in enumerate(shape))


def whole_shape(block: tuple, sp: tuple, mesh) -> tuple:
    """The shape of the whole tensor of which a ``block``-shaped tensor is a
    rank's block under ``sp`` (``local_shape``'s inverse)."""
    return tuple(d * _axsize(mesh, sp[i]) if i < len(sp) else d
                 for i, d in enumerate(block))


def only_axes(sp: tuple, axes: tuple) -> tuple:
    """``sp`` with every entry that names none of ``axes`` made None: the
    spec that cuts a block further along those axes alone."""
    def keep(e):
        names = (e,) if isinstance(e, str) else (e or ())
        return e if any(a in axes for a in names) else None
    return spec(*map(keep, sp))


def shard(t: torch.Tensor, sp: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``sp``: a view."""
    for dim, axes in enumerate(sp):
        n = _axsize(mesh, axes)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index_of(axes) * size, size)
    return t


def gather(t_local: torch.Tensor, sp: tuple, mesh) -> torch.Tensor:
    """The whole tensor of which ``t_local`` is this rank's block under
    ``sp``, on every rank (a collective every rank of the axes joins), in
    contiguous memory: a host copy of a strided one writes ~30x slower
    (``np.save`` walks it in chunks)."""
    t = t_local
    for dim, axes in enumerate(sp):
        n = _axsize(mesh, axes)
        if n > 1:
            group = mesh.group_for(axes)
            if group.size != n:
                raise ValueError(f"gather over {axes}: the mesh holds no live "
                                 f"group of {n} ranks")
            t = group.all_gather(t, dim)
    return t.contiguous()


def spec_at(specs, path):
    """The spec at ``path`` of a (possibly partial) tree of specs: a path
    the tree does not reach is whole (spec ())."""
    for k in path:
        if not isinstance(specs, dict) or k not in specs:
            return spec()
        specs = specs[k]
    return specs if isinstance(specs, tuple) else spec()


def shard_tree(tree, specs, mesh):
    """Every leaf of a tree of whole tensors as this rank's block of it (a
    copy of its own); ``specs`` a tree of specs, leaves it does not reach
    whole."""
    return map_with_path(
        lambda path, t: shard(t, spec_at(specs, path), mesh).clone(), tree)


def gather_tree(tree, specs, mesh):
    """Every leaf of a tree of this rank's blocks as the whole tensor, on
    every rank (collectives every rank joins, in the tree's order)."""
    return map_with_path(lambda path, t: gather(t, spec_at(specs, path), mesh),
                         tree)


def block_slices(shape: tuple, sp: tuple, mesh) -> tuple:
    """The slices of this rank's block of a ``shape`` tensor under ``sp``
    (for a numpy array as for a tensor)."""
    out = []
    for dim, d in enumerate(shape):
        n = _axsize(mesh, sp[dim]) if dim < len(sp) else 1
        size = d // n
        start = mesh.index_of(sp[dim]) * size if n > 1 else 0
        out.append(slice(start, start + size))
    return tuple(out)


def _blocks(tree, mesh, rule):
    def one(path, t):
        block = t[block_slices(tuple(t.shape), rule(mesh, path, tuple(t.shape)),
                               mesh)]
        return block.clone() if isinstance(t, torch.Tensor) else block.copy()
    return map_with_path(one, tree)


def shard_params(tree, mesh):
    """Every leaf of a parameter tree (whole tensors or numpy arrays) as a
    copy of this rank's block under ``param_spec_for``."""
    return _blocks(tree, mesh, param_spec_for)


def shard_cache(tree, mesh):
    """Every leaf of a decode cache tree (whole) as a copy of this rank's
    block under ``cache_spec_for``."""
    return _blocks(tree, mesh, cache_spec_for)


class SeqBlock(NamedTuple):
    """This rank's rows [offset, offset + rows) of a ``total``-row cache."""
    offset: int
    rows: int
    total: int


def seq_block(mesh, total: int) -> SeqBlock:
    """The rows of a ``total``-row K/V cache this rank holds under
    ``cache_spec_for``: a block of total / M on a model axis of M that
    divides it, else all of them (the rule replicates S)."""
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    if m == 1 or total % m:
        return SeqBlock(0, total, total)
    rows = total // m
    return SeqBlock(mesh.coords["model"] * rows, rows, total)


def model_group(mesh):
    """The mesh's "model" group when that axis holds more than one rank,
    else None."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    group = mesh.groups["model"]
    if group.size != mesh.shape["model"]:
        raise ValueError(f"{mesh}: no live group of {mesh.shape['model']} "
                         f"ranks on the model axis")
    return group

