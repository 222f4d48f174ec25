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

ZeRO-1 (``OptConfig.zero1``, on by default as in the reference): on a
mesh whose data axes hold more than one rank, each moment (and master
copy) is this rank's block of ``zero1_spec``'s layout, the reference's
rule: the parameter's spec extended with the data axes on its largest
free dim that they divide (``state_shardings``; ``init_state(...,
mesh=)``).  ``update(..., mesh=)`` then takes this rank's share of the
gradients (``launch/steps.py`` divides the loss so that the shares sum to
the whole batch's gradient) and, for each sharded leaf, reduce-scatters
the gradient along that dim, applies the arithmetic to this rank's block
and all-gathers the new parameter; a leaf no dim of which the data axes
divide keeps whole moments and all-reduces its gradient.  The clipping
norm is the global one: the blocks' squares summed, then one all-reduce.
With ``zero1=False`` every gradient is all-reduced and the moments are
whole on every rank.  Without a mesh, or with one data rank, nothing is
communicated and the arithmetic is the one-process step's.

On a mesh with a model axis the parameters and gradients are this rank's
blocks (``sharding.shard_params``) and ``specs=`` gives the whole leaves'
specs (``sharding.param_shardings`` of the whole shapes; ``steps.
cell_shardings``' "params"): each moment is then ``zero1_spec``'s data-axis
block OF THE MODEL BLOCK (the reference's ``zero1_spec(mesh, param_spec,
shape)``), the data-axis sums run over the data group of this rank's model
index, and the clipping norm adds each model-sharded leaf's squares over
"model" and over the data axes, and each leaf replicated over "model"
(norm scales, the router) once, not M times.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models import sharding
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


def init_state(params: dict, cfg: OptConfig, mesh=None, specs=None) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each parameter, step 0 on
    the parameters' device (+ float32 master copies with ``use_master``);
    on a ``mesh``, each this rank's block of ``state_shardings``' layout
    (on a model axis ``params`` this rank's blocks and ``specs`` the whole
    leaves' specs: module docstring)."""
    sdt = getattr(torch, cfg.state_dtype)
    dev = next(leaves(params))[1].device
    lay = _layout(params, cfg, mesh, specs)

    def zeros(path, p):
        shape = p.shape if mesh is None else sharding.local_shape(
            lay[path].whole, lay[path].moment, mesh)
        return torch.zeros(shape, dtype=sdt, device=p.device)

    state = {"m": tree_map(zeros, params, path=()),
             "v": tree_map(zeros, params, path=()),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.use_master:
        state["master"] = tree_map(
            lambda path, p: (p.detach() if mesh is None else lay[path].block(
                p.detach(), mesh)).float().clone(),
            params, path=())
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
def update(params: dict, grads: dict, state: dict, cfg: OptConfig, mesh=None,
           specs=None):
    """One AdamW step: writes the new parameters and state in place and
    returns (params, state, stats), stats = {"lr", "grad_norm"} (the norm
    before clipping), both float32 scalar tensors.  On a ``mesh`` with more
    than one data rank, ``grads`` is this rank's share and ``state`` is laid
    out by ``init_state(..., mesh=)``; on a model axis params and grads are
    this rank's blocks and ``specs`` the whole leaves' specs (module
    docstring)."""
    if mesh is not None and (mesh.dp.size > 1 or _model(mesh) is not None):
        return _update_mesh(params, grads, state, cfg, mesh, specs)
    step = state["step"]
    step.add_(1)
    lr = lr_at(step, cfg)
    gnorm = global_norm(grads)
    upd = _upd_fn(cfg, step, lr, _clip_scale(cfg, gnorm))
    if cfg.use_master:
        tree_map(upd, params, grads, state["m"], state["v"], state["master"])
    else:
        tree_map(upd, params, grads, state["m"], state["v"])
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _clip_scale(cfg: OptConfig, gnorm):
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0


def _upd_fn(cfg: OptConfig, step, lr, scale):
    """The reference's arithmetic on one leaf (or block): the new parameter
    values written into ``p`` (which may be a view), the moments into ``m``
    and ``v``, the master copy into ``master``."""
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
    return upd


def _update_mesh(params: dict, grads: dict, state: dict, cfg: OptConfig,
                 mesh, specs=None):
    """``update`` on ``mesh``: each gradient summed over the data ranks
    (reduce-scattered to this rank's block along its ZeRO-1 dim, or
    all-reduced), the global norm (``mesh_sq_norm``), the arithmetic on
    this rank's block, the parameter all-gathered over the data ranks."""
    dp = mesh.dp
    lay = _layout(params, cfg, mesh, specs)
    step = state["step"]
    step.add_(1)
    lr = lr_at(step, cfg)
    summed, sq = {}, {}
    for path, g in leaves(grads):
        dim = lay[path].dim
        if dim is None:
            gs = dp.all_reduce(g.to(torch.float32, copy=True))
        else:
            gs = dp.reduce_scatter(g.float(), dim)
        sq[path] = torch.sum(torch.square(gs))
        summed[path] = gs
    gnorm = torch.sqrt(_global_sq(sq, lay, mesh))
    upd = _upd_fn(cfg, step, lr, _clip_scale(cfg, gnorm))
    for path, p in leaves(params):
        rest = [_at(state["m"], path), _at(state["v"], path)]
        if cfg.use_master:
            rest.append(_at(state["master"], path))
        g = summed.pop(path)
        if lay[path].dim is None:
            upd(p, g, *rest)
        else:
            block = lay[path].block(p, mesh)
            upd(block, g, *rest)
            if dp.size > 1:
                p.copy_(dp.all_gather(block, lay[path].dim))
    return params, state, {"lr": lr, "grad_norm": gnorm}


def _global_sq(sq: dict, lay: dict, mesh) -> torch.Tensor:
    """The squared global norm from each leaf's sum of squares ``sq`` (path
    -> float32 scalar) of this rank's part of its data-summed gradient
    (``lay``: ``_layout``'s): the ZeRO-1 blocks' sums added over the data
    ranks (one all-reduce for all of them), then the model-sharded leaves'
    over the model ranks (one more); a leaf replicated over "model" counts
    once."""
    tp = _model(mesh)
    # [cut over "model"][a ZeRO-1 block, or whole over the data axes]
    parts = {c: {True: [], False: []} for c in (True, False)}
    for path, v in sq.items():
        parts[tp is not None and lay[path].cut][lay[path].dim is not None].append(v)
    cuts = [c for c in (True, False) if parts[c][True]]
    total = dict(zip(cuts, mesh.dp.all_reduce(torch.stack(
        [torch.stack(parts[c][True]).sum() for c in cuts])))) if cuts else {}
    for c in (True, False):
        t = total.get(c, 0.0)
        if parts[c][False]:
            t = t + torch.stack(parts[c][False]).sum()
        total[c] = torch.as_tensor(t, dtype=torch.float32)
    if tp is None:
        return total[False]
    return tp.all_reduce(total[True].clone()) + total[False]


def _model(mesh):
    """The mesh's live "model" group of more than one rank, or None."""
    g = mesh.groups.get("model")
    return g if g is not None and g.size > 1 else None


class _Leaf:
    """One leaf's layout on a mesh: ``whole`` its whole shape, ``moment``
    its moments' spec (``zero1_spec``'s), ``dim`` the dim that cuts over
    the data axes (or None), ``cut`` whether "model" cuts the parameter
    (its spec ``spec`` names the axis, which then holds more than one
    rank)."""

    def __init__(self, whole, spec, moment, mesh):
        self.whole, self.moment = whole, moment
        self.dim = dp_dim(moment)
        self.cut = mesh.shape.get("model", 1) > 1 and bool(
            sharding.only_axes(spec, ("model",)))
        self._data = sharding.only_axes(moment, ("pod", "data"))

    def block(self, p, mesh):
        """This rank's data-axis block of ``p``, its model block (a view)."""
        return sharding.shard(p, self._data, mesh)


def _layout(params: dict, cfg: OptConfig, mesh, specs=None) -> dict | None:
    """path -> ``_Leaf`` for every leaf of ``params`` on ``mesh`` (None
    without one).  ``specs``: the whole leaves' parameter specs, needed on
    a model axis, where ``params`` are blocks; without them the leaves are
    taken whole."""
    if mesh is None:
        return None
    if specs is None:
        if _model(mesh) is not None:
            raise ValueError("on a model axis the parameters are blocks: pass "
                             "specs= (the whole leaves' specs)")
        specs = sharding.param_shardings(None, mesh, params)
    whole = {path: (sharding.whole_shape(tuple(p.shape), sharding.spec_at(specs, path),
                                         mesh), p.dtype)
             for path, p in leaves(params)}
    wtree = tree_map(lambda path, p: whole[path], params, path=())
    moments = state_shardings(mesh, specs, wtree, cfg)["m"]
    return {path: _Leaf(whole[path][0], sharding.spec_at(specs, path),
                        _at(moments, path), mesh) for path in whole}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def dp_dim(sp: tuple):
    """The dim a moment spec shards over the data axes, or None."""
    for i, e in enumerate(sp):
        names = (e,) if isinstance(e, str) else (e or ())
        if any(a in ("pod", "data") for a in names):
            return i
    return None


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of optimizer states
# ---------------------------------------------------------------------------


def zero1_spec(mesh, param_spec: tuple, shape: tuple) -> tuple:
    """Extend a param spec with data-axis sharding on the largest free dim."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if not dp:
        return param_spec
    # idempotent: already data-sharded specs pass through (FSDP params)
    flat = set()
    for e in param_spec:
        if isinstance(e, (tuple, list)):
            flat.update(e)
        elif e is not None:
            flat.add(e)
    if flat & set(dp):
        return param_spec
    dpn = math.prod(mesh.shape[a] for a in dp)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    # choose the largest unsharded dim divisible by the dp product
    best, best_dim = -1, None
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % dpn == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim is None:
        return param_spec
    entries[best_dim] = dp if len(dp) > 1 else dp[0]
    return sharding.spec(*entries)


def state_shardings(mesh, param_shardings, params, cfg: OptConfig) -> dict:
    """The state's specs: each moment (and master copy) ``zero1_spec`` of
    its parameter's spec with ``cfg.zero1``, else the parameter's spec;
    ``params`` tensors or (shape, dtype) pairs."""
    m = tree_map(lambda sh, p: zero1_spec(mesh, sh, sharding.shape_of(p))
                 if cfg.zero1 else sh, param_shardings, params)
    out = {"m": m, "v": m, "step": sharding.spec()}
    if cfg.use_master:
        out["master"] = m
    return out
