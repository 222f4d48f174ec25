"""Ranks of a mesh as threads of one process (no jax, no reference).

``thread_meshes(sizes)`` gives one ``launch/mesh.py`` ``Mesh`` a rank,
whose groups (every axis, the data axes together, the world) are
``ThreadGroup``s: each collective is a rendezvous of the members' threads
at a barrier, the members' tensors combined in member order, so every
member gets the same bits, and counted in the mesh's ``counts`` as
``Group`` counts them.  ``run_ranks(fn, meshes)`` runs ``fn(mesh)`` on a
thread a rank and returns the results in rank order; a failure in one rank
aborts the others' barriers and is raised.  Autograd runs each rank's
backward pass on its own thread, so the operators of ``models/tp.py`` are
differentiated as on separate processes, without a process group.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict

import torch

from repro_torch.launch import mesh as M


class _Shared:
    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=120)
        self.slots: list = [None] * n


class ThreadGroup(M.Group):
    """A group whose members are threads (module docstring)."""

    def __init__(self, shared: _Shared, index: int, counts: dict):
        super().__init__(None, shared.n, index, counts)
        self.shared = shared

    def _swap(self, value) -> list:
        self.shared.slots[self.index] = value
        self.shared.barrier.wait()
        got = list(self.shared.slots)
        self.shared.barrier.wait()
        return got

    def all_reduce(self, t, op="sum"):
        if self.size > 1:
            self._count(f"all_reduce_{op}", t)
            got = self._swap(t.clone())
            out = got[0].clone()
            for g in got[1:]:
                out = out + g if op == "sum" else torch.maximum(out, g)
            t.copy_(out)
        return t

    def all_gather(self, t, dim=0):
        if self.size == 1:
            return t
        out = torch.cat(self._swap(t.clone()), dim)
        self._count("all_gather", out)
        return out

    def reduce_scatter(self, t, dim=0):
        if self.size == 1:
            return t
        self._count("reduce_scatter", t)
        got = self._swap(t.clone())
        total = got[0].clone()
        for g in got[1:]:
            total = total + g
        n = t.shape[dim] // self.size
        return total.narrow(dim, self.index * n, n).contiguous()

    def all_to_all(self, t, send, recv):
        if self.size == 1:
            return t
        self._count("all_to_all", t)
        got = self._swap(list(t.contiguous().split(list(send))))
        return torch.cat([got[j][self.index] for j in range(self.size)])

    def broadcast(self, t, src=0):
        if self.size > 1:
            self._count("broadcast", t)
            t.copy_(self._swap(t.clone())[src])
        return t


def thread_meshes(sizes: tuple, names: tuple = ("data", "model")) -> list:
    """A ``Mesh`` of ``sizes`` for each rank, its groups ``ThreadGroup``s
    over the ranks ``_live_mesh`` would put in them."""
    shape = OrderedDict(zip(names, sizes))
    meshes = [M.Mesh(shape, rank=r) for r in range(math.prod(sizes))]
    dp = [a for a in M.DP_AXES if a in shape]
    for key, varying in [(a, [a]) for a in names] + [("dp", dp), ("world", list(names))]:
        members: dict = {}
        for m in meshes:
            members.setdefault(tuple(m.coords[a] for a in names if a not in varying),
                               []).append(m)
        for ms in members.values():
            shared = _Shared(len(ms))
            for i, m in enumerate(ms):
                g = ThreadGroup(shared, i, m.counts)
                if key in ("dp", "world"):
                    setattr(m, key, g)
                else:
                    m.groups[key] = g
    return meshes


def run_ranks(fn, meshes: list) -> list:
    out: list = [None] * len(meshes)
    errors: list = []

    def one(r):
        try:
            out[r] = fn(meshes[r])
        except BaseException as e:              # noqa: BLE001 - re-raised below
            errors.append(e)
            for m in meshes:
                for g in [*m.groups.values(), m.dp, m.world]:
                    if isinstance(g, ThreadGroup):
                        g.shared.barrier.abort()

    threads = [threading.Thread(target=one, args=(r,)) for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return out
