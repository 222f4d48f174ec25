"""Meshes over the ranks of a ``torch.distributed`` group.

The port of the reference package's ``launch/mesh.py``.  A ``Mesh`` names
its axes ("data", "model", or "pod", "data", "model") and their sizes, as a
jax mesh does: ``axis_names`` and ``shape[name]`` are all the sharding rules
read (``models/sharding.py``, ``optim/adamw.py::zero1_spec``), so a mesh
made by ``Mesh(shape)`` alone, with no process group, serves them.  A mesh
over live ranks (``make_local_mesh``, ``make_production_mesh``) also holds
this rank's coordinate on every axis and a ``Group`` for each axis and for
the data axes together (``dp``), whose collectives it counts: the data
group's for data-parallel training (``optim/adamw.py``), the model group's
for tensor- and expert-parallel serving and training (``models/tp.py``'s
autograd operators over it, used by ``models/layers.py``,
``models/moe.py``, ``models/lm.py``: all-reduces of row-parallel sums and
of the column-parallel inputs' cotangents, all-gathers of a decode step's
heads and partial softmaxes, the prefill's heads-to-sequence all-to-all of
K and V, the vocabulary-parallel loss's row statistics).

Ranks are laid out row-major over the axes, as the reference reshapes
``jax.devices()``: rank = (pod_i · data + data_i) · model + model_i, and a
group's members come in ascending rank order, so a block index along the
data axes together is pod_i · data + data_i, jax's order for a tuple of
axes.

The backend (``backend_for``) is NCCL when every rank has a card of its
own and gloo when ranks share one (NCCL refuses two ranks on one card;
gloo stages CUDA tensors through the host) or run on the CPU.  It is
chosen from the ranks and the cards and printed; nothing falls back from
one to the other.
"""
from __future__ import annotations

import datetime
import math
import os
from collections import OrderedDict

import torch
import torch.distributed as dist

#: the data-parallel axes, in the order the rules name them
DP_AXES = ("pod", "data")
#: how long a collective may wait for its peers before it fails: ranks that
#: issue collectives in different orders fail with a message in minutes
#: rather than hanging for gloo's default half hour
PG_TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(world: int, device) -> str:
    """"nccl" when each of ``world`` ranks has a card of its own, "gloo"
    when ranks share a card or run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device="cuda") -> int:
    """Join the ranks ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment) in
    the default process group, with ``backend_for``'s backend and a
    ``PG_TIMEOUT`` on every collective, and return the world size.
    Without them, or with a world of 1, nothing is initialised and the
    world is 1.  A group already initialised is kept."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return 1
    rank = int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        # ranks beyond the cards share them (gloo), round robin
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    backend = backend_for(world, dev)
    print(f"rank {rank} of {world}: backend {backend} ({dev.type}, "
          f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} cards)",
          flush=True)
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    return world


class Group:
    """One process group of a mesh: the members' count (``size``), this
    rank's position among them (``index``) and their collectives, each
    counted in the mesh's ``counts`` by kind: calls and the bytes of the
    whole tensor a call reduces or assembles on a rank.  A group of one
    member returns its input and counts nothing."""

    def __init__(self, pg, size: int, index: int, counts: dict):
        self.pg, self.size, self.index = pg, size, index
        self._counts = counts

    def _count(self, kind: str, t: torch.Tensor) -> None:
        c = self._counts.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the members, in place ("sum" or "max")."""
        if self.size > 1:
            self._count(f"all_reduce_{op}", t)
            dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op], group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The members' ``t`` (one shape) concatenated along ``dim`` in
        member order: a new tensor."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._count("all_gather", out)
        dist.all_gather_into_tensor(out, x, group=self.pg)
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This member's block along ``dim`` of the sum of the members'
        ``t`` (``t.shape[dim]`` divisible by ``size``): a new tensor."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // self.size, *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        self._count("reduce_scatter", x)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=self.pg)
        return out.movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, send: list[int],
                   recv: list[int]) -> torch.Tensor:
        """Rows ``send[j]`` of ``t`` (along dim 0, in member order) to member
        j; the rows received, ``recv[i]`` from member i, concatenated in
        member order: a new tensor.  Counted by the bytes of ``t``."""
        if self.size == 1:
            return t
        x = t.contiguous()
        out = x.new_empty((sum(recv), *x.shape[1:]))
        self._count("all_to_all", x)
        dist.all_to_all_single(out, x, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=self.pg)
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Member ``src``'s ``t`` on every member, in place."""
        if self.size > 1:
            self._count("broadcast", t)
            dist.broadcast(t, src=dist.get_global_rank(self.pg, src),
                           group=self.pg)
        return t


class Mesh:
    """Named axes and their sizes (``axis_names``, ``shape``: an ordered
    name -> size dict), and over live ranks this rank's ``coords`` on each
    axis and its ``Group``s: ``groups[name]`` per axis, ``dp`` over the data
    axes together, ``world`` over every rank.  ``Mesh(shape)`` alone is a
    shape-only mesh (every coordinate 0, groups of one member)."""

    def __init__(self, shape: dict, *, rank: int = 0, groups: dict | None = None,
                 backend: str | None = None):
        self.shape = OrderedDict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.backend = backend
        self.counts: dict = {}
        self.coords = _coords(self.shape, rank)
        groups = groups or {}

        def group(key, size, index):
            return Group(groups.get(key), size if key in groups else 1,
                         index if key in groups else 0, self.counts)

        self.groups = {a: group(a, self.shape[a], self.coords[a])
                       for a in self.axis_names}
        dp = [a for a in DP_AXES if a in self.shape]
        self.dp = group("dp", math.prod(self.shape[a] for a in dp),
                        self.index_of(dp))
        self.world = group("world", mesh_chip_count(self), rank)

    def group_for(self, axes) -> Group:
        """The group of a spec entry: an axis name, or a tuple of names (the
        data axes together)."""
        if isinstance(axes, str):
            return self.groups[axes]
        if tuple(axes) == tuple(a for a in DP_AXES if a in self.shape):
            return self.dp
        raise NotImplementedError(f"no group over the axes {axes}")

    def index_of(self, axes) -> int:
        """This rank's block index along a spec entry's axes (major to
        minor for a tuple)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in names:
            i = i * self.shape[a] + self.coords[a]
        return i

    def reset_counts(self) -> None:
        self.counts.clear()

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, rank={self.rank}, backend={self.backend})"


def mesh_chip_count(mesh) -> int:
    return int(math.prod(mesh.shape.values()))


def _coords(shape: OrderedDict, rank: int) -> dict:
    """``rank``'s coordinate on each axis, row-major."""
    out = {}
    for name in reversed(shape):
        out[name] = rank % shape[name]
        rank //= shape[name]
    return out


def _live_mesh(sizes: tuple, names: tuple) -> Mesh:
    """A mesh of ``sizes`` over the ranks of the default group (a world of
    one without one).  Every rank creates every group, in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = OrderedDict(zip(names, sizes))
    if math.prod(sizes) != world:
        raise RuntimeError(f"a mesh of {dict(shape)} needs {math.prod(sizes)} "
                           f"ranks; the world holds {world}")
    if world == 1:
        return Mesh(shape)
    rank = dist.get_rank()
    coords = [_coords(shape, r) for r in range(world)]
    groups = {"world": dist.group.WORLD}
    dp = [a for a in DP_AXES if a in shape]
    for key, varying in [(a, [a]) for a in names] + [("dp", dp)]:
        members: dict[tuple, list] = {}
        for r, c in enumerate(coords):
            members.setdefault(tuple(c[a] for a in names if a not in varying),
                               []).append(r)
        for ranks in members.values():
            pg = dist.group.WORLD if len(ranks) == world else dist.new_group(
                ranks, timeout=PG_TIMEOUT)
            if rank in ranks:
                groups[key] = pg
    return Mesh(shape, rank=rank, groups=groups, backend=dist.get_backend())


def make_local_mesh(model_axis: int = 1, pod_axis: int = 0) -> Mesh:
    """A mesh over whatever ranks exist (the default group's, or one):
    (data, model), or (pod, data, model) with ``pod_axis``; data takes the
    rest."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = max(model_axis, 1)
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide {world} ranks")
    if pod_axis:
        return _live_mesh((pod_axis, world // (model * pod_axis), model),
                          ("pod", "data", "model"))
    return _live_mesh((world // model, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 (256 ranks) or 2 x 16 x 16 (512): raises unless the world
    holds that many ranks, as ``jax.make_mesh`` fails without the
    devices."""
    if multi_pod:
        return _live_mesh((2, 16, 16), ("pod", "data", "model"))
    return _live_mesh((16, 16), ("data", "model"))
