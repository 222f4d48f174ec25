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

On a mesh with a "model" axis of M ranks (serving and training) each rank
holds E/M experts (the reference's EP rule) and the shared experts' column
and row blocks, and the block input is replicated over "model".  With ``moe_impl == "ep"`` and M
dividing E it is the reference's ``_moe_block_ep``: the router is
replicated, each rank ranks the rows routed to its own experts through
``bucket_scatter`` at P = E/M + 1 (bucket E/M: another rank's, the
reference's ``le_c``; ``ep_slots``), with a capacity per (expert, data
shard), and aux the product of global means over the data axes (this
rank's share of it: its probabilities' sum over the global count times
the global first-choice shares, so the shares and their gradients sum to
the reference's).  Otherwise (the
"gspmd" impl) it is the one-device block's function: global ranks and
capacity (``route``), each rank computing its experts' rows.  Either way
the experts' and the shared experts' partial outputs are summed by ONE
all-reduce over "model" a layer.  Without a model axis "ep" computes the
gspmd block, as the reference's does without an EP mesh.

In training the block's input enters this rank's experts (and the cut
shared experts) through ``tp.copy_to_model``, one for both, and so do the
routing weights, whose cotangent each rank holds only for its own experts'
rows; the partials leave through ``tp.reduce_from_model``.  The router and
the aux loss are computed whole on every rank.  With remat the routing is
recomputed in the backward pass: the same experts and slots, since
``bucket_scatter``'s slots are deterministic.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import registry
from ..kernels.hash_partition.hash_partition import MAX_P
from .config import ModelConfig
from .layers import swiglu, swiglu_hidden, tp_sum
from .sharding import model_group
from .tp import copy_to_model


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


def moe_block(p: dict, x, cfg: ModelConfig, group=None, mesh=None):
    """x: (B, S, d) -> (out, aux_loss), the reference's ``moe_block``.

    p: ``router`` (d, E); ``experts`` {w_gate, w_up: (E, d, ff), w_down:
    (E, ff, d)}; optional ``shared`` {w_gate, w_up, w_down}, an always-on
    SwiGLU.  The capacity is the one of this call's B·S tokens, or of the
    whole data ``group``'s (``route``).  On a ``mesh`` with a model axis,
    p holds this rank's blocks (module docstring).
    """
    M = mesh.shape.get("model", 1) if mesh is not None else 1
    if (cfg.moe_impl == "ep" and mesh is not None and "model" in mesh.shape
            and cfg.n_experts % M == 0):
        return _moe_block_ep(p, x, cfg, mesh)
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = b * s
    xt = x.reshape(T, d)
    r = route(p, xt, cfg, group)
    tp = model_group(mesh)
    E_loc = p["experts"]["w_gate"].shape[0]
    flat_e = r.topi.reshape(T * k)
    xf, topw = _entry(p, xt, r.topw, cfg, tp)
    if E_loc != E:
        # this rank's experts [lo, lo + E_loc); the rest to bucket E_loc
        le = flat_e - tp.index * E_loc
        flat_e = torch.where((le >= 0) & (le < E_loc), le, E_loc)
    y = _experts(p["experts"], xf if E_loc != E else xt, flat_e, r.slot, topw,
                 E_loc, r.C, k)
    return _with_shared(p, y, xt, cfg, tp, xf).reshape(b, s, d), r.aux


def _shared_cut(p: dict, cfg: ModelConfig) -> bool:
    """The shared experts' columns are this rank's block of them."""
    return "shared" in p and \
        p["shared"]["w_down"].shape[0] != cfg.d_ff_expert * cfg.n_shared_experts


def _entry(p: dict, xt, topw, cfg: ModelConfig, tp):
    """(xt, topw) as they enter the rank's share of the block over a model
    group ``tp``: xt through one ``copy_to_model`` when the experts or the
    shared experts are cut, topw through another when the experts are."""
    if tp is None:
        return xt, topw
    cut = p["experts"]["w_gate"].shape[0] != cfg.n_experts
    xf = copy_to_model(xt, tp) if cut or _shared_cut(p, cfg) else xt
    return xf, (copy_to_model(topw, tp) if cut else topw)


def _experts(ex: dict, xt, le, slot, topw, E_loc: int, C: int, k: int):
    """The routed experts' sum over each token's k rows: row j (token j //
    k's (j % k)-th choice) goes to local expert ``le[j]`` (E_loc: none of
    this rank's) at ``slot[j]`` if below the capacity C, into an (E_loc +
    1, C + 1, d) buffer whose last expert and column (every dropped row)
    are sliced off; three batched products; each kept row's output weighted
    by its renormalised probability."""
    T, d = xt.shape
    dt = xt.dtype
    keep = (le < E_loc) & (slot < C)
    slot = torch.where(keep, slot, C).long()
    rows = xt[:, None].expand(T, k, d).reshape(T * k, d)
    buf = torch.zeros((E_loc + 1, C + 1, d), dtype=dt, device=xt.device)
    buf = buf.index_put((le, slot), rows)[:E_loc, :C]             # (E, C, d)
    g = F.silu(torch.bmm(buf, ex["w_gate"].to(dt)))
    u = torch.bmm(buf, ex["w_up"].to(dt))
    eo = torch.bmm(g * u, ex["w_down"].to(dt))                    # (E, C, d)
    # token t's k rows are rows t·k .. t·k + k - 1: summing them in order is
    # the reference's scatter-add over flat_t, without atomics
    contrib = eo[torch.clamp(le, max=E_loc - 1), torch.clamp(slot, max=C - 1)]
    contrib = contrib * (topw.reshape(T * k) * keep.float()).to(dt)[:, None]
    return contrib.view(T, k, d).sum(1)


def _with_shared(p: dict, y, xt, cfg: ModelConfig, tp, xf=None):
    """The experts' ``y`` plus the shared experts' SwiGLU of ``xt``, summed
    over the model group ``tp`` when the experts are split over it: the
    shared experts' partial, when their rules split them too, in the same
    all-reduce (``xf``: xt as it enters their columns, ``_entry``)."""
    if tp is None:
        return y + swiglu(p["shared"], xt) if "shared" in p else y
    terms = [(y, p["experts"]["w_gate"].shape[0] != cfg.n_experts)]
    if "shared" in p:
        cut = _shared_cut(p, cfg)
        sh = p["shared"]
        # a split down-projection's partial in float32, as row_parallel's
        terms.append((swiglu_hidden(sh, xt if xf is None else xf).float()
                      @ sh["w_down"].float() if cut else swiglu(sh, xt), cut))
    split = [t for t, cut in terms if cut]
    out = tp_sum(sum(split[1:], split[0]), tp, y.dtype) if split else 0
    for t, cut in terms:
        if not cut:                    # replicated: whole on every rank
            out = out + t
    return out


def ep_slots(flat_e, E: int, M: int, m_idx: int, kernels):
    """Rank ``m_idx``'s expert-parallel ranks of (T·k,) expert choices:
    ``le`` each row's local expert (E/M: another rank's, the reference's
    ``le_c``) and ``slot`` its rank among the rows of its local expert, in
    row order, from ``bucket_scatter`` at P = E/M + 1 (the reference's
    one-hot cumsum)."""
    E_loc = E // M
    if E_loc + 1 > MAX_P:
        raise ValueError(f"{E} experts over {M} ranks: {E_loc + 1} buckets; "
                         f"bucket_scatter takes at most {MAX_P}")
    le = flat_e - m_idx * E_loc
    le = torch.where((le >= 0) & (le < E_loc), le, E_loc).to(torch.int32)
    slot, _ = kernels.bucket_scatter(le.contiguous(), E_loc + 1)
    return le.long(), slot


def _moe_block_ep(p: dict, x, cfg: ModelConfig, mesh):
    """The reference's ``_moe_block_ep`` on this rank: its experts' rows
    (``ep_slots``) at a capacity of this data shard's tokens, the routed
    and shared partials summed by one all-reduce over "model"; aux the
    product of global means over the data axes."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    M = mesh.shape["model"]
    T = b * s
    xt = x.reshape(T, d)
    logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)
    ce = F.one_hot(topi[:, 0], E).float().mean(0)
    if mesh.dp.size > 1:
        # the product of GLOBAL means, as this rank's share: the global
        # first-choice shares (no gradient) times its probabilities' mean
        # over the global count
        ce = mesh.dp.all_reduce(ce) / mesh.dp.size
        me = me / mesh.dp.size
    aux = E * torch.sum(me * ce)
    le, slot = ep_slots(topi.reshape(T * k), E, M, mesh.coords["model"],
                        registry.resolve(x.device.type))
    tp = model_group(mesh)
    xf, topw = _entry(p, xt, topw, cfg, tp)
    y = _experts(p["experts"], xf, le, slot, topw, E // M,
                 expert_capacity(cfg, T), k)
    return _with_shared(p, y, xt, cfg, tp, xf).reshape(b, s, d), aux


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
