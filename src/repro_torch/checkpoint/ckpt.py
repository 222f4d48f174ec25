"""Atomic, asynchronous checkpoints with restore onto any device.

The port of the reference package's ``checkpoint/ckpt.py``, in the same
on-disk format, so a checkpoint written by either package restores in the
other:

    <dir>/step_000123/
        manifest.json       # step, metadata, each leaf's shape and dtype
        <leafpath>.npy      # one file a leaf, the path's keys joined by "__"

Trees are nested dicts (keys in sorted order, as the reference's pytree
paths) of tensors, numpy arrays or numbers.  numpy has no bfloat16 or
float8, so those leaves are written as their ``uint16``/``uint8`` bits with
the logical dtype in the manifest.  A save writes ``step_X.tmp`` and
``os.replace``s it into place, so a crash mid-save never corrupts the latest
checkpoint.

``AsyncSaver.save`` copies every leaf into host memory of its own before it
returns (the optimizer updates the live tensors in place, where the
reference relies on JAX arrays being immutable) and writes from a
background thread.

Leaves are stored whole, so a checkpoint restores onto any device and any
number of ranks: ``restore(..., device=)`` gives whole leaves, and
``restore(..., shardings=, mesh=)`` (the reference's elastic path) gives
each rank its block of every leaf under a tree of specs
(``models/sharding.py``; ``adamw.state_shardings`` for ZeRO-1 moments), so
a checkpoint saved at P ranks restores at Q.  Saving from P ranks is the
driver's (``runtime/ft.py``): the blocks are gathered, then rank 0 writes.
``copy_into`` then writes a restored tree into live tensors in place (the
model's parameters are views the blocks share).

Departure (ROADMAP.md §3): ``save(keep=)`` and ``AsyncSaver(keep=)`` keep
that many checkpoints; the reference's ``save`` always keeps 3.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..models import sharding
from ..models.lm import copy_into, leaves, tree_map

_SEP = "__"

# numpy cannot hold these: store their bits and the logical dtype
_EXOTIC = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
           torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
           torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_LOGICAL = {name: (tdt, bits) for tdt, (name, bits, _) in _EXOTIC.items()}


def _flatten(tree) -> dict[str, Any]:
    return {_SEP.join(map(str, path)): leaf for path, leaf in leaves(tree)}


def host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (numpy array to write, logical dtype name); bfloat16 and
    float8 as their ``uint16``/``uint8`` bits.  A CPU tensor's array shares
    its memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _EXOTIC:
            name, bits, view = _EXOTIC[t.dtype]
            return t.view(bits).numpy().view(view), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name in _LOGICAL:        # an ml_dtypes array
        return arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8), \
            arr.dtype.name
    return arr, str(arr.dtype)


def _snapshot(leaf):
    """A copy of ``leaf`` in host memory of its own."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone()
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, metadata: dict | None = None,
         keep: int = 3) -> str:
    """Atomic synchronous save of ``tree`` as ``step``; keeps the newest
    ``keep`` checkpoints.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in _flatten(tree).items():
        arr, logical = host_array(leaf)
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": logical}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


class AsyncSaver:
    """Non-blocking checkpoint writer (one in flight at a time).

    ``records`` holds one dict a save: step, the snapshot's seconds (the
    time ``save`` blocks the caller, the wait for the previous write
    excluded), the write's seconds and the bytes written."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.records: list[dict] = []
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, metadata: dict | None = None):
        self.wait()
        t0 = time.perf_counter()
        host = tree_map(_snapshot, tree)
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0,
               "bytes": sum(_nbytes(x) for x in _flatten(host).values())}
        self.records.append(rec)

        def write():
            t1 = time.perf_counter()
            save(self.ckpt_dir, step, host, metadata, self.keep)
            rec["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def from_host(arr: np.ndarray, logical: str, device) -> torch.Tensor:
    """The inverse of ``host_array``: a tensor of its own on ``device``."""
    if logical in _LOGICAL:
        tdt, bits = _LOGICAL[logical]
        signed = arr.view(np.int16 if bits == torch.int16 else np.uint8)
        return torch.from_numpy(np.array(signed)).view(tdt).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def restore(ckpt_dir: str, template, step: int | None = None,
            device=None, shardings=None, mesh=None) -> tuple[Any, int, dict]:
    """Restore into the ``template`` tree's structure: (tree, step,
    metadata).

    Every leaf the manifest holds becomes a new tensor on ``device`` (by
    default the template leaf's device, or the CPU); a leaf it lacks keeps
    the template's value (partial restore).  With ``shardings`` (a tree of
    specs, leaves it does not reach whole) and ``mesh``, a leaf read from
    the manifest becomes this rank's block of it.  The latest step unless
    ``step`` is given."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    want = _flatten(template)
    flat = {}
    for key, info in manifest["leaves"].items():
        like = want.get(key)
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        flat[key] = from_host(np.load(os.path.join(d, key + ".npy")),
                              info["dtype"], dev)

    def leaf(path, t):
        got = flat.get(_SEP.join(map(str, path)))
        if got is None:
            return t
        if shardings is None:
            return got
        return sharding.shard(got, sharding.spec_at(shardings, path), mesh).clone()

    return tree_map(leaf, template, path=()), step, manifest["metadata"]


def _gc(ckpt_dir: str, keep: int = 3):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
