"""Carry the reference package's LM and whisper weights and optimizer
state into the port bit for bit, and the port's back out as numpy in the
reference's layout."""
from __future__ import annotations

import numpy as np
import torch

from . import lm, sharding, whisper
from .config import ModelConfig


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # bfloat16 arrives as ml_dtypes.bfloat16, which torch.from_numpy
    # refuses: carry its bits across as a checkpoint does
    from ..checkpoint.ckpt import from_host, host_array  # ckpt imports lm
    return from_host(*host_array(a), device)


def _check(shapes: dict, tree: dict, path: str = "") -> None:
    """``tree``'s keys and leaf shapes are ``shapes``'."""
    if sorted(shapes) != sorted(tree):
        raise ValueError(f"params{path}: keys {sorted(tree)}, expected "
                         f"{sorted(shapes)}")
    for k, s in shapes.items():
        if isinstance(s, dict):
            _check(s, tree[k], f"{path}[{k!r}]")
        elif tuple(np.shape(tree[k])) != s:
            raise ValueError(f"params{path}[{k!r}]: shape "
                             f"{np.shape(tree[k])}, expected {s}")


def params_from_jax(cfg: ModelConfig, params: dict, device="cuda",
                    mesh=None) -> lm.LM:
    """The port's model holding the same values as ``params``: the reference
    package's parameter pytree as nested dicts of numpy arrays (per-layer
    entries stacked over L), e.g. ``jax.tree.map(np.asarray, params)``; a
    decoder-only family's (the vlm family's too).  On a ``mesh``, this
    rank's blocks of them (``sharding.shard_params``), as ``lm.init_params
    (..., mesh=)`` holds them."""
    dev = lm.device_of(device)
    _check(lm.param_shapes(cfg), params)
    if mesh is not None:
        lm.require_servable(cfg, mesh)
        params = sharding.shard_params(params, mesh)
    return lm.LM(cfg, lm.tree_map(lambda a: _tensor(a, dev), params))


def whisper_from_jax(cfg: ModelConfig, params: dict, device="cuda") -> whisper.Whisper:
    """As ``params_from_jax``, for the encdec family: the reference's
    ``whisper.init_params`` tree, checked against ``whisper.param_shapes``."""
    dev = lm.device_of(device)
    _check(whisper.param_shapes(cfg), params)
    return whisper.Whisper(cfg, lm.tree_map(lambda a: _tensor(a, dev), params))


def opt_state_from_jax(state: dict, device="cuda", shardings=None,
                       mesh=None) -> dict:
    """The port's AdamW state holding the same values as the reference's
    ``adamw.init_state``/``update`` state given as numpy arrays: ``m``,
    ``v`` (and ``master``) as nested dicts in the parameters' layout,
    ``step`` an int32 scalar.  With ``shardings`` (``adamw.state_shardings``'
    tree of specs, ``cell_shardings``' "opt_sh") and ``mesh``, each leaf is
    this rank's block of the reference's, the ZeRO-1 layout
    ``adamw.init_state(..., mesh=)`` makes."""
    dev = lm.device_of(device)
    out = {k: lm.tree_map(lambda a: _tensor(a, dev), state[k])
           for k in ("m", "v", "master") if k in state}
    out["step"] = _tensor(np.asarray(state["step"], np.int32), dev)
    if shardings is not None:
        out = sharding.shard_tree(out, shardings, mesh)
    return out


def to_numpy(tree) -> dict:
    """A nested dict of tensors (``LM.tree()``, ``Whisper.tree()``, an
    optimizer state, a train state) as numpy arrays on the host, copied, encoded as a checkpoint
    stores them (``ckpt.host_array``): bfloat16 leaves come as their
    ``uint16`` bits (numpy has no bfloat16); view them as
    ``ml_dtypes.bfloat16`` to read the values."""
    from ..checkpoint.ckpt import host_array  # ckpt imports lm
    return lm.tree_map(lambda t: host_array(t)[0].copy(), tree)
