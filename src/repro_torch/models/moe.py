"""Mixture-of-Experts with capacity-based dispatch, on one device.

The port of the reference package's ``models/moe.py``.  Each token picks
its top-k experts; its rows are ranked within their expert, clamped to a
per-expert capacity C and placed into an (E, C, d) buffer that three
batched products turn into expert outputs; overflowed rows are dropped and
their probability mass renormalised away, as the reference does.

The rank of a row within its expert is the stable slot of the shuffle's
``bucket_scatter`` with P = E buckets, so it comes from the registry: the
hand-written kernel on the card (``csrc/bucket_scatter.cu``), its plain
version on the CPU.  The reference computes the same integers with a
(T·k, E) one-hot ``cumsum``.

Over a data-parallel group (``launch/mesh.py::Group``; each rank holding
its rows of one global batch) a block computes what the reference's
``_moe_block_gspmd`` computes on the global batch under GSPMD: the
capacity is the global token count's, each row's slot is its rank within
its expert over the global flat order (the local slot plus the exclusive
scan over ranks of the experts' counts: one all-gather of 2E int32 a
block, the paper's MPI_Exscan pattern), and the aux loss is this rank's
share of the global one (global first-choice shares, local probability
sums over the global token count), so the shares and their gradients sum
over the ranks to the reference's.

Not ported yet: the expert-parallel dispatch (``_moe_block_ep``, a
``shard_map`` over the "model" axis) and its mesh registry; ``moe_impl ==
"ep"`` raises (ROADMAP.md §1 item 11.7, the model axis).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import registry
from ..kernels.hash_partition.hash_partition import MAX_P
from .config import ModelConfig
from .layers import swiglu


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows each expert takes from a call of ``n_tokens`` tokens: the
    balanced share times ``capacity_factor``, rounded up to a multiple of 8
    and at least 8."""
    cap = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def top_k(probs, k: int):
    """The k largest entries of each row and their indices, in descending
    order, the lower index first among equals (``lax.top_k``'s order, which
    ``torch.topk`` does not promise)."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(probs, -1, order), order


class Routing(NamedTuple):
    """One call's routing: ``topw``/``topi`` (T, k) the renormalised weights
    and experts of each token; ``slot`` (T·k,) int32 each row's rank within
    its expert (row j is token j // k's (j % k)-th choice); ``counts`` (E,)
    int32 the rows each expert was sent, before the capacity; ``C`` the
    capacity; ``aux`` the load-balancing loss."""
    topw: torch.Tensor
    topi: torch.Tensor
    slot: torch.Tensor
    counts: torch.Tensor
    C: int
    aux: torch.Tensor


def route(p: dict, xt, cfg: ModelConfig, group=None) -> Routing:
    """Route tokens ``xt`` (T, d) through the router ``p["router"]`` (d, E):
    float32 softmax over logits computed in ``xt``'s dtype, top k, weights
    divided by their sum, the Switch-style aux loss E · Σ mean(probs) ·
    (share of tokens whose first choice is each expert), and every row's
    slot in its expert from the registry's ``bucket_scatter``.  Over a data
    ``group`` of P ranks, each with T tokens: slots, counts, capacity and
    the aux loss's shares are the global computation's (module
    docstring)."""
    E, k = cfg.n_experts, cfg.top_k
    if E > MAX_P:
        raise ValueError(f"{cfg.name}: {E} experts; bucket_scatter takes at "
                         f"most {MAX_P}")
    T = xt.shape[0]
    logits = (xt @ p["router"].to(xt.dtype)).float()              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    # the first choices' shares: no gradient, and no wait on the card (a
    # bincount would read its input's max on the host)
    first = F.one_hot(topi[:, 0], E)
    flat_e = topi.reshape(T * k).to(torch.int32).contiguous()
    slot, counts = registry.resolve(xt.device.type).bucket_scatter(flat_e, E)
    if group is None or group.size == 1:
        ce = first.float().mean(0)
        aux = E * torch.sum(probs.mean(0) * ce)
        return Routing(topw, topi, slot, counts, expert_capacity(cfg, T), aux)
    # every rank's expert counts and first-choice counts, in rank order
    both = group.all_gather(torch.stack([counts, first.sum(0).to(torch.int32)])[None])
    before = both[:group.index, 0].sum(0)                   # exclusive scan
    slot = slot + before.to(slot.dtype)[flat_e.long()]
    n = T * group.size
    ce = both[:, 1].sum(0).float() / n
    aux = E * torch.sum(probs.sum(0) / n * ce)
    return Routing(topw, topi, slot, both[:, 0].sum(0).to(counts.dtype),
                   expert_capacity(cfg, n), aux)


def moe_block(p: dict, x, cfg: ModelConfig, group=None):
    """x: (B, S, d) -> (out, aux_loss), the reference's ``_moe_block_gspmd``.

    p: ``router`` (d, E); ``experts`` {w_gate, w_up: (E, d, ff), w_down:
    (E, ff, d)}; optional ``shared`` {w_gate, w_up, w_down}, an always-on
    SwiGLU.  The capacity is the one of this call's B·S tokens, or of the
    whole data ``group``'s (``route``).
    """
    if cfg.moe_impl == "ep":
        raise NotImplementedError(
            "moe_impl='ep' (expert-parallel dispatch over a mesh) is not "
            "ported yet: ROADMAP.md §1 item 11.7 (the model axis)")
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = b * s
    dt = x.dtype
    xt = x.reshape(T, d)
    r = route(p, xt, cfg, group)
    C = r.C
    flat_e = r.topi.reshape(T * k)
    keep = r.slot < C
    slot = torch.where(keep, r.slot, C).long()

    # every dropped row writes column C, which is sliced off
    rows = xt[:, None].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((E, C + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((flat_e, slot), rows)[:, :C]              # (E, C, d)

    ex = p["experts"]
    g = F.silu(torch.bmm(buf, ex["w_gate"].to(dt)))
    u = torch.bmm(buf, ex["w_up"].to(dt))
    eo = torch.bmm(g * u, ex["w_down"].to(dt))                    # (E, C, d)

    # token t's k rows are rows t·k .. t·k + k - 1: summing them in order is
    # the reference's scatter-add over flat_t, without atomics
    contrib = eo[flat_e, torch.clamp(slot, max=C - 1)]
    contrib = contrib * (r.topw.reshape(T * k) * keep.float()).to(dt)[:, None]
    y = contrib.view(T, k, d).sum(1)
    if "shared" in p:
        y = y + swiglu(p["shared"], xt, dt)
    return y.reshape(b, s, d), r.aux


def moe_param_shapes(cfg: ModelConfig) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    shapes = {
        "router": (d, E),
        "experts": {"w_gate": (E, d, ff), "w_up": (E, d, ff),
                    "w_down": (E, ff, d)},
    }
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        shapes["shared"] = {"w_gate": (d, sf), "w_up": (d, sf),
                            "w_down": (sf, d)}
    return shapes
