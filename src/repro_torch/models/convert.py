"""Carry the reference package's LM weights into the port, bit for bit."""
from __future__ import annotations

import numpy as np
import torch

from . import lm
from .config import ModelConfig


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                    # an owned, writable, contiguous copy
    # bfloat16 arrives as ml_dtypes.bfloat16, which torch.from_numpy
    # refuses: carry its bits through int16
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ModelConfig, params: dict, device="cuda") -> lm.LM:
    """The port's model holding the same values as ``params``: the reference
    package's parameter pytree as nested dicts of numpy arrays (per-layer
    entries stacked over L), e.g. ``jax.tree.map(np.asarray, params)``."""
    dev = lm.device_of(device)
    want = lm.param_shapes(cfg)

    def check(shapes, tree, path):
        if sorted(shapes) != sorted(tree):
            raise ValueError(f"params{path}: keys {sorted(tree)}, expected "
                             f"{sorted(shapes)}")
        for k, s in shapes.items():
            if isinstance(s, dict):
                check(s, tree[k], f"{path}[{k!r}]")
            elif tuple(np.shape(tree[k])) != s:
                raise ValueError(f"params{path}[{k!r}]: shape "
                                 f"{np.shape(tree[k])}, expected {s}")

    check(want, params, "")
    return lm.LM(cfg, lm.tree_map(lambda a: _tensor(a, dev), params))
