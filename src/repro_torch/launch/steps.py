"""Step builders: train, prefill and decode (the dense, moe, ssm and hybrid
families).

The port of the reference package's ``launch/steps.py``: the train step its
``launch/train.py`` drives (``make_train_step``, with the loss wrapper,
``DEFAULT_MICRO``, ``micro_batches`` and ``input_specs``) and the serving
steps its ``examples/serve_lm.py`` drives.  The encdec (whisper) and M-RoPE
(vlm) branches, meshes and the sharding bundles (``cell_shardings``,
``cache_specs`` over whisper) are not ported yet (ROADMAP.md §1 item 11):
other families raise ``NotImplementedError``, and so does a mesh.
"""
from __future__ import annotations

import functools

import torch

from ..configs import ShapeSpec
from ..models import lm
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw

# gradient-accumulation factors: big models microbatch the 256-seq global
# batch so per-layer live activations stay within device memory
DEFAULT_MICRO = {
    "kimi-k2-1t-a32b": 16, "yi-34b": 8, "qwen2.5-32b": 8,
    "zamba2-7b": 4, "falcon-mamba-7b": 4, "deepseek-moe-16b": 4,
}


def micro_batches(cfg: ModelConfig, shape: ShapeSpec, mesh=None) -> int:
    """The number of micro-batches of a train step (one process: no data
    axis to cover)."""
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported yet: ROADMAP.md §1 item 11")
    return max(DEFAULT_MICRO.get(cfg.name, 1), 1)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """(shape, dtype) of every model input of an (architecture x shape)
    cell, allocating nothing."""
    lm.require_ported(cfg)
    b, s = shape.batch, shape.seq
    i32 = torch.int32
    if shape.kind == "train":
        return {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
    if shape.kind == "prefill":
        return {"tokens": ((b, s), i32)}
    if shape.kind == "decode":
        return {"token": ((b, 1), i32)}
    raise ValueError(shape.kind)


def make_loss_fn(cfg: ModelConfig):
    """(params, batch) -> scalar loss."""
    lm.require_ported(cfg)
    return functools.partial(lm.loss_fn, cfg=cfg)


def value_and_grad(loss_fn, params: dict, batch: dict):
    """(loss, grads): ``loss_fn(params, batch)``, detached, and its gradient
    as a tree like ``params``, taken with respect to detached aliases of
    the parameters (the same storage; nothing is left in their ``.grad``)."""
    live = lm.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(live, batch)
    flat = [t for _, t in lm.leaves(live)]
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    return loss.detach(), lm.tree_map(lambda t: grads[id(t)], live)


def make_train_step(cfg: ModelConfig, ocfg: OptConfig, n_micro: int = 1):
    """(state, batch) -> (state, loss) with gradient accumulation.

    state: {"params": the parameter tree (``LM.tree()``: the model's own
    tensors), "opt": ``adamw.init_state``}; batch: {"tokens", "labels"}
    (B, S) int32 on the parameters' device.  The gradient is taken with
    respect to detached aliases of the parameters; with ``n_micro`` > 1 the
    batch splits into ``n_micro`` equal micro-batches whose gradients are
    summed in float32 and divided by ``n_micro``, and whose losses are
    averaged, as the reference's ``lax.scan`` does.  AdamW then updates the
    parameters and the state in place; the same dict comes back with the
    loss, a float32 scalar tensor (no host synchronisation).
    """
    loss_fn = make_loss_fn(cfg)

    def train_step(state, batch):
        params = state["params"]
        if n_micro > 1:
            gsum = lm.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
            lsum = 0.0
            for i in range(n_micro):
                mb = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, g = value_and_grad(loss_fn, params, mb)
                lm.tree_map(torch.Tensor.add_, gsum, g)
                lsum = lsum + loss
                del g
            grads = lm.tree_map(lambda g: g.div_(n_micro), gsum)
            loss = lsum / n_micro
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        adamw.update(params, grads, state["opt"], ocfg)
        return state, loss

    return train_step


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """(params, batch) -> (last_logits, caches): a fresh ``max_seq`` cache on
    the tokens' device, filled with the prompts ``batch["tokens"]`` (B, S)."""
    lm.require_ported(cfg)

    def prefill(params, batch):
        tokens = batch["tokens"]
        caches = lm.init_cache(cfg, tokens.shape[0], max_seq,
                               device=tokens.device)
        logits, caches, _ = lm.forward(params, tokens, cfg, caches=caches,
                                       q_offset=0)
        return logits[:, -1], caches
    return prefill


def make_decode_step(cfg: ModelConfig):
    """(params, token (B, 1), caches) -> (logits (B, V), caches)."""
    lm.require_ported(cfg)

    def step(params, token, caches):
        return lm.decode_step(params, token, caches, cfg)
    return step
