"""AdamW with global-norm clipping and LR schedules.

The port of the reference package's ``optim/adamw.py``: plain functions
over the reference's named parameter tree (nested dicts of tensors, as
``LM.tree()`` gives it), with the reference's float32 arithmetic, so that
the two agree to float32 rounding.  ``torch.optim.AdamW`` is not used: its
clipping, master copies and state dtype differ.

The state is ``{"m": tree, "v": tree, "step": int32 scalar}`` (+ ``"master"``,
float32 copies of the parameters, with ``use_master``), the reference's
layout.  ``update`` writes the new parameters and state into their tensors
in place and issues no host synchronisation.

``zero1_spec`` and ``state_shardings`` (ZeRO-1 over GSPMD meshes) are not
ported yet: they wait for ``models/sharding.py`` (ROADMAP.md §1 item 11).
``OptConfig.zero1`` is accepted and does nothing on one process.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.lm import leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | linear | const
    state_dtype: str = "float32"      # bf16 halves optimizer memory (kimi-k2)
    use_master: bool = False          # fp32 master params (extra 4 bytes/param)
    zero1: bool = True


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 scalar tensor on the step's device: linear warm-up, then cosine,
    linear or constant decay."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def init_state(params: dict, cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, step 0 on
    the parameters' device (+ float32 master copies with ``use_master``)."""
    sdt = getattr(torch, cfg.state_dtype)
    dev = next(leaves(params))[1].device
    state = {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), params),
             "v": tree_map(lambda p: torch.zeros(p.shape, dtype=sdt, device=p.device), params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.use_master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(), params)
    return state


def state_specs(params: dict, cfg: OptConfig) -> dict:
    """(shape, dtype) of every entry of the state, allocating nothing;
    ``params`` may hold tensors or (shape, dtype) pairs."""
    sdt = getattr(torch, cfg.state_dtype)

    def shape(p):
        return tuple(p.shape) if isinstance(p, torch.Tensor) else tuple(p[0])

    out = {"m": tree_map(lambda p: (shape(p), sdt), params),
           "v": tree_map(lambda p: (shape(p), sdt), params),
           "step": ((), torch.int32)}
    if cfg.use_master:
        out["master"] = tree_map(lambda p: (shape(p), torch.float32), params)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = [torch.sum(torch.square(g.float())) for _, g in leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """One AdamW step: writes the new parameters and state in place and
    returns (params, state, stats), stats = {"lr", "grad_norm"} (the norm
    before clipping), both float32 scalar tensors."""
    step = state["step"]
    step.add_(1)
    lr = lr_at(step, cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1 - torch.pow(b1, step.float())
    c2 = 1 - torch.pow(b2, step.float())
    sdt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v, master=None):
        gf = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mh = m_new / c1
        vh = v_new / c2
        base = master if master is not None else p.float()
        new = base - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                           + cfg.weight_decay * base)
        m.copy_(m_new.to(sdt))
        v.copy_(v_new.to(sdt))
        if master is not None:
            master.copy_(new)
        p.copy_(new.to(p.dtype))

    if cfg.use_master:
        tree_map(upd, params, grads, state["m"], state["v"], state["master"])
    else:
        tree_map(upd, params, grads, state["m"], state["v"])
    return params, state, {"lr": lr, "grad_norm": gnorm}
