"""Step builders: train, prefill and decode, for every family.

The port of the reference package's ``launch/steps.py``: the train step its
``launch/train.py`` drives (``make_train_step``, with the loss wrapper,
``DEFAULT_MICRO``, ``micro_batches`` and ``input_specs``), the serving
steps its ``examples/serve_lm.py`` drives, ``cache_specs``,
``model_param_specs`` and a cell's sharding bundle (``cell_shardings``).
The encdec family goes through ``models/whisper.py``; the vlm family's
batches carry ``inputs_embeds`` and (3, B, S) ``positions``.

On a mesh (``launch/mesh.py``) the train step is data-parallel over its
data axes: each rank takes its rows of the global batch, computes its
share of the global loss (``lm.loss_fn(group=)``), and the gradients are
summed over the ranks by ``adamw.update(mesh=)``, by ZeRO-1 or plainly as
the state is laid out.  On a model axis too (the dense and moe families)
each rank holds, differentiates and updates its blocks of the parameters
(``sharding.shard_params``), tensor- and expert-parallel through
``models/tp.py``'s autograd collectives, and takes the loss from its block
of the vocabulary; the batch is split over the data ranks only.  The
serving steps run the same families on a (data, model) mesh: each rank
takes its rows of the global batch and holds its blocks of the parameters
and the cache, the logits its (B, V/M) block (``lm.greedy`` picks across
them).  Training or serving the ssm, hybrid, vlm and encdec families on a
model axis raises (ROADMAP.md §1 item 11.7c).
"""
from __future__ import annotations

import functools
import math

import torch

from ..configs import ShapeSpec
from ..models import lm, sharding, whisper
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw

# gradient-accumulation factors: big models microbatch the 256-seq global
# batch so per-layer live activations stay within device memory
DEFAULT_MICRO = {
    "kimi-k2-1t-a32b": 16, "yi-34b": 8, "qwen2.5-32b": 8,
    "zamba2-7b": 4, "falcon-mamba-7b": 4, "deepseek-moe-16b": 4,
}


def micro_batches(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> int:
    """The number of micro-batches of a train step: ``DEFAULT_MICRO``'s,
    halved until each micro-batch still covers the mesh's data axes."""
    m = DEFAULT_MICRO.get(cfg.name, 1)
    if mesh is not None:
        dpn = math.prod(mesh.shape[a] for a in sharding.dp_axes(mesh))
        while m > 1 and (shape.batch // m) % dpn != 0:
            m //= 2
    return max(m, 1)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """(shape, dtype) of every model input of an (architecture x shape)
    cell, allocating nothing."""
    lm.require_ported(cfg)
    b, s = shape.batch, shape.seq
    i32, cdt = torch.int32, lm._dt(cfg)
    if shape.kind == "decode":
        return {"token": ((b, 1), i32)}
    if shape.kind not in ("train", "prefill"):
        raise ValueError(shape.kind)
    if cfg.family == "vlm":
        out = {"inputs_embeds": ((b, s, cfg.d_model), cdt),
               "positions": ((3, b, s), i32)}
    elif cfg.family == "encdec":
        out = {"frames": ((b, cfg.enc_frames, cfg.d_model), cdt),
               "tokens": ((b, s), i32)}
    else:
        out = {"tokens": ((b, s), i32)}
    if shape.kind == "train":
        out["labels"] = ((b, s), i32)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """(shape, dtype) of every entry of the decode cache of a cell."""
    if cfg.family == "encdec":
        return whisper.init_cache_specs(cfg, shape.batch, shape.seq)
    return lm.init_cache_specs(cfg, shape.batch, shape.seq)


def model_param_specs(cfg: ModelConfig) -> dict:
    """(shape, dtype) of every parameter, in the reference's tree."""
    lm.require_ported(cfg)
    shapes = (whisper.param_shapes(cfg) if cfg.family == "encdec"
              else lm.param_shapes(cfg))
    return lm.tree_map(lambda s: (s, lm._pdt(cfg)), shapes)


def make_loss_fn(cfg: ModelConfig, group=None, mesh=None):
    """(params, batch) -> scalar loss (this rank's share over a data
    ``group``; on a ``mesh`` with a model axis, params this rank's
    blocks)."""
    lm.require_ported(cfg)
    lm.require_servable(cfg, mesh)
    if cfg.family == "encdec":
        return functools.partial(whisper.loss_fn, cfg=cfg, group=group)
    return functools.partial(lm.loss_fn, cfg=cfg, group=group, mesh=mesh)


def value_and_grad(loss_fn, params: dict, batch: dict):
    """(loss, grads): ``loss_fn(params, batch)``, detached, and its gradient
    as a tree like ``params``, taken with respect to detached aliases of
    the parameters (the same storage; nothing is left in their ``.grad``)."""
    live = lm.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(live, batch)
    flat = [t for _, t in lm.leaves(live)]
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    return loss.detach(), lm.tree_map(lambda t: grads[id(t)], live)


def make_train_step(cfg: ModelConfig, ocfg: OptConfig, n_micro: int = 1,
                    mesh=None):
    """(state, batch) -> (state, loss) with gradient accumulation.

    state: {"params": the parameter tree (``LM.tree()``: the model's own
    tensors), "opt": ``adamw.init_state``}; batch: ``input_specs``' train
    entries on the parameters' device, None entries ignored (the vlm
    family's "tokens").  The gradient is taken with respect to detached
    aliases of the parameters; with ``n_micro`` > 1 the batch splits into
    ``n_micro`` equal micro-batches along its batch axis (axis 1 of the
    (3, B, S) "positions") whose gradients are summed in float32 and
    divided by ``n_micro``, and whose losses are averaged, as the
    reference's ``lax.scan`` does.  AdamW then updates the
    parameters and the state in place; the same dict comes back with the
    loss, a float32 scalar tensor (no host synchronisation).

    On a ``mesh`` with more than one data rank, ``batch`` is the GLOBAL
    batch on every rank and "opt" is ``adamw.init_state(..., mesh=mesh)``:
    each micro-batch is split over the data ranks by ``batch_spec`` (rank r
    of P takes rows i·B/n + r·B/(n·P) onward of micro-batch i, as GSPMD
    shards each of the reference's micro-batches), the loss returned is
    the global one (one all-reduce of the ranks' shares), and the step
    equals the reference's one-device step on the global batch up to the
    order of float32 sums.  On a model axis (the dense and moe families;
    the others raise, ROADMAP.md §1 item 11.7c) "params" are this rank's
    blocks (``sharding.shard_params``), "opt" is ``adamw.init_state(...,
    mesh=mesh, specs=cell_shardings(...)["params"])``, the batch's rows
    are replicated over "model", and the loss is the same on every rank of
    the model group."""
    specs = None
    if mesh is not None:
        lm.require_servable(cfg, mesh)
        specs = sharding.param_shardings(cfg, mesh, model_param_specs(cfg))
    model_axis = mesh is not None and mesh.shape.get("model", 1) > 1
    dp = mesh.dp if mesh is not None and mesh.dp.size > 1 else None
    loss_fn = make_loss_fn(cfg, group=dp, mesh=mesh if model_axis else None)

    def rows(key, v, i):
        mb = _micro(key, v, n_micro, i)
        if dp is None:
            return mb
        if mb.shape[1 if key == "positions" else 0] % dp.size:
            raise ValueError(
                f"{key}: a micro-batch of {tuple(mb.shape)} does not split "
                f"over {dp.size} data ranks")
        return sharding.shard(mb, sharding.batch_spec(mesh, key, tuple(mb.shape)),
                              mesh)

    def train_step(state, batch):
        params = state["params"]
        batch = {k: v for k, v in batch.items() if v is not None}
        if n_micro > 1:
            gsum = lm.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
            lsum = 0.0
            for i in range(n_micro):
                mb = {k: rows(k, v, i) for k, v in batch.items()}
                loss, g = value_and_grad(loss_fn, params, mb)
                lm.tree_map(torch.Tensor.add_, gsum, g)
                lsum = lsum + loss
                del g
            grads = lm.tree_map(lambda g: g.div_(n_micro), gsum)
            loss = lsum / n_micro
        else:
            loss, grads = value_and_grad(
                loss_fn, params, {k: rows(k, v, 0) for k, v in batch.items()})
        if dp is not None:
            loss = dp.all_reduce(loss.clone())
        adamw.update(params, grads, state["opt"], ocfg, mesh=mesh, specs=specs)
        return state, loss

    return train_step


def _micro(key: str, v, n: int, i: int):
    """Micro-batch i of n of batch entry ``key``: along axis 0, or axis 1
    of the (3, B, S) "positions"."""
    if n == 1:
        return v
    if key == "positions":
        return v.reshape(v.shape[0], n, v.shape[1] // n, *v.shape[2:])[:, i]
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def _rows(mesh, key: str, v):
    """This rank's rows of the global batch entry ``v`` (``batch_spec``)."""
    if mesh is None or v is None:
        return v
    return sharding.shard(v, sharding.batch_spec(mesh, key, tuple(v.shape)), mesh)


def make_prefill_step(cfg: ModelConfig, max_seq: int, mesh=None):
    """(params, batch) -> (last_logits, caches): a fresh ``max_seq`` cache on
    the inputs' device, filled with the prompts: ``batch["tokens"]`` (B, S);
    the vlm family's "inputs_embeds" (B, S, d) and "positions" (3, B, S);
    the encdec family's "frames" (B, F, d) and prompt "tokens".  On a
    ``mesh`` (dense and moe on a model axis) params are this rank's blocks,
    the batch is global, and the step returns this rank's blocks of the
    logits and of the cache."""
    lm.require_ported(cfg)
    lm.require_servable(cfg, mesh)
    if cfg.family == "encdec":
        def prefill(params, batch):
            return whisper.prefill(params, batch["frames"], batch["tokens"],
                                   cfg, max_seq)
        return prefill

    def prefill(params, batch):
        tokens, embeds = batch.get("tokens"), batch.get("inputs_embeds")
        first = tokens if tokens is not None else embeds
        caches = lm.init_cache(cfg, first.shape[0], max_seq, device=first.device,
                               mesh=mesh)
        logits, caches, _ = lm.forward(
            params, _rows(mesh, "tokens", tokens), cfg, caches=caches,
            positions=_rows(mesh, "positions", batch.get("positions")),
            inputs_embeds=_rows(mesh, "inputs_embeds", embeds), q_offset=0,
            mesh=mesh)
        return logits[:, -1], caches
    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None):
    """(params, token (B, 1), caches) -> (logits (B, V), caches).  With
    M-RoPE the step's position is the reference's: the cache index on all
    three streams (ROADMAP.md §3).  On a ``mesh`` the token is the global
    batch's, the logits this rank's block (``make_prefill_step``)."""
    lm.require_ported(cfg)
    lm.require_servable(cfg, mesh)
    if cfg.family == "encdec":
        def step(params, token, caches):
            return whisper.decode_step(params, token, caches, cfg)
        return step

    def step(params, token, caches):
        token = _rows(mesh, "token", token)
        positions = None
        if cfg.mrope:
            positions = torch.full((3, token.shape[0], 1), caches["host_index"],
                                   dtype=torch.int32, device=token.device)
        return lm.decode_step(params, token, caches, cfg, positions=positions,
                              mesh=mesh)
    return step


def cell_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   ocfg: OptConfig | None = None, fsdp: bool = False) -> dict:
    """Every spec a cell needs, under the reference's keys: "params" and
    "param_specs", "inputs" and "input_sh", for a decode cell
    "cache_specs" and "cache_sh", for a train cell with ``ocfg``
    "opt_specs" and "opt_sh".

    fsdp=True also shards the PARAMETERS over the data axes (``zero1_spec``
    of each parameter's spec), as the reference's; the port runs no FSDP
    step, so those specs are specs only."""
    pspecs = model_param_specs(cfg)
    psh = sharding.param_shardings(cfg, mesh, pspecs)
    if fsdp:
        psh = lm.tree_map(lambda sh, sp: adamw.zero1_spec(mesh, sh, sp[0]),
                          psh, pspecs)
    out = {"params": psh, "param_specs": pspecs}
    ins = input_specs(cfg, shape)
    out["inputs"] = ins
    out["input_sh"] = {k: sharding.batch_spec(mesh, k, v[0]) for k, v in ins.items()}
    if shape.kind == "decode":
        cs = cache_specs(cfg, shape)
        out["cache_specs"] = cs
        out["cache_sh"] = sharding.cache_shardings(mesh, cs)
    if shape.kind == "train" and ocfg is not None:
        out["opt_specs"] = adamw.state_specs(pspecs, ocfg)
        out["opt_sh"] = adamw.state_shardings(mesh, psh, pspecs, ocfg)
    return out
