"""Decoder-only LM: the dense, moe, ssm, hybrid and vlm families, for
serving (prefill, then decode through a cache) and training (``loss_fn``).

The port of the reference package's ``models/lm.py``.  The model is an
``nn.Module`` (embedding, the per-layer parameters stacked over L, final
norm) whose parameters keep the reference's layout and names (``wq``
(L, d, H*hd), each layer's used as ``x @ wq``, ``embed`` (V, d), ...), so
carrying the reference's weights over is a copy
(``convert.params_from_jax``).  ``lax.scan`` over stacked layers becomes a
loop over the layers' views of them.  Entry points that allocate
(``init_params``, ``init_cache``) take ``device="cuda"`` by default and
raise without a card.

The moe family (``models/moe.py``) keeps the reference's two stacks:
``"dense_layers"``, the first ``first_dense_layers`` blocks with a SwiGLU of
``d_ff_first_dense``, then ``"layers"``, the rest, each with a routed
``moe`` in place of the MLP; a forward runs them in that order and sums
the MoE blocks' aux losses.

The ssm family (falcon-mamba) is one stack ``"layers"`` of Mamba1 blocks
(``{"mamba", "ln1"}``, ``models/ssm.py``).  The hybrid family (zamba2)
stacks Mamba2 blocks the same way and adds ``"shared_block"``, ONE
attention + SwiGLU block (``{"attn", "mlp", "ln1", "ln2"}``, no L axis)
applied after every group of ``shared_attn_period`` Mamba2 layers, and once
more after the tail of L % period layers: zamba2-7b's 81 layers at period
6 apply it 13 + 1 times, each application with its own KV cache.

The vlm family (qwen2-vl) is the dense layout with M-RoPE: its vision
frontend is a stub, so a forward takes ``inputs_embeds`` (B, S, d) in place
of the token lookup and ``positions`` (3, B, S), one (t, h, w) stream each
(``layers.apply_mrope``); without them the positions count up on all three
streams from ``q_offset``.  The encdec family (whisper) is
``models/whisper.py``'s; this module's functions refuse it.

The cache is the reference's pytree, one ``{"k", "v", "index"}`` a stack
(``{"layers": ...}``, and ``"dense_layers"`` for the moe family) with k/v
(L, B, max_seq, Hkv, hd) and index (L,) int32 on the device, plus
``"host_index"``: index[0] as a host int, so a step never waits on the card
to learn where to write.  A step writes its K/V into the cache in place and
returns the same dict.  An ssm or hybrid cache holds, as the reference's,
``"layers"``: (conv tail (L, B, k-1, din) in the compute dtype, h (L, B,
...) float32), and for the hybrid family ``"shared"``: {"grp": an attention
cache of n_groups, "tail": one without the L axis}; a step overwrites the
layers' states in place.

Training (``loss_fn``; ``launch/steps.py::make_train_step``): a forward
takes each layer's weights as ``unbind`` views of the stacked parameters,
so a gradient reaches the stacked tensor in one piece.  ``LM.tree()`` gives them
as the reference's parameter tree (nested dicts under the reference's
names), which the optimizer state and the checkpoints are keyed by.  They
are built with ``requires_grad=False``, so serving tracks no gradients; the
train step differentiates through detached aliases of them (the same
storage), and ``model.requires_grad_()`` makes ``loss.backward()`` fill
their ``.grad`` as in any module.  ``cfg.remat == "block"`` recomputes each
block in the backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` per layer; per group of Mamba2 layers and its shared
block for the hybrid family, as the reference's ``group_body``).

Serving on a mesh (``mesh=``, ``launch/mesh.py``; the dense and moe
families): ``init_params`` and ``init_cache`` hold this rank's blocks by the
reference's rules (``models/sharding.py``), ``forward`` and ``decode_step``
take this rank's rows of the batch.  On a model axis the embedding (V, d)
is vocabulary-parallel (a rank looks up the tokens of its range, zeroes the
rest, and one all-reduce sums them), the blocks are tensor- and
expert-parallel (``models/layers.py``, ``models/moe.py``), and the head
(``lm_head`` or the tied ``embed``) gives each rank its (B, S, V/M) block of
the logits, the reference's (dp, "model") out-sharding; ``greedy`` picks
the next tokens across the blocks.  The ssm, hybrid and vlm families on a
model axis wait for ROADMAP.md §1 item 11.7c.

Training on a mesh (``loss_fn(mesh=)``; the dense and moe families): the
same forward on this rank's blocks, its collectives ``models/tp.py``'s
autograd operators (the embedding's sum a ``reduce_from_model``, the head's
input a ``copy_to_model``), and the loss ``tp.vocab_parallel_token_loss``
over the (B, S, V/M) block, so no rank holds the whole logits.  With remat
each block's recomputation re-issues its collectives in the backward pass,
in the one order every rank's identical graph gives.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import moe as moe_mod
from . import sharding
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import attention_block, norm, row_parallel, swiglu, swiglu_hidden
from .tp import copy_to_model, reduce_from_model, vocab_parallel_token_loss

#: the decoder-only families of this module
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
#: every family the port runs (encdec through models/whisper.py)
PORTED = FAMILIES + ("encdec",)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported (the "
            f"{', '.join(PORTED)} families are): ROADMAP.md §1 item 11")


def _require_lm(cfg: ModelConfig) -> None:
    """A decoder-only family of this module, as the reference's
    ``param_shapes`` (a ValueError for encdec, models/whisper.py's)."""
    require_ported(cfg)
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family is not a "
                         f"decoder-only LM (models/whisper.py)")


def stacks(cfg: ModelConfig) -> dict[str, int]:
    """The stacks of layers, in the order a forward runs them, and their
    depths: ``{"layers": L}``, or for the moe family with first dense
    layers ``{"dense_layers": first_dense_layers, "layers": the rest}``."""
    fd = cfg.first_dense_layers if cfg.family == "moe" else 0
    out = {"dense_layers": fd} if fd else {}
    out["layers"] = cfg.n_layers - fd
    return out


def unstacked(cfg: ModelConfig) -> tuple[str, ...]:
    """The blocks with no L axis: ``("shared_block",)`` for the hybrid
    family, else none."""
    return ("shared_block",) if cfg.family == "hybrid" else ()


def shared_groups(cfg: ModelConfig) -> tuple[int, int, int]:
    """The hybrid family's (period, groups, tail): the shared block follows
    each of ``groups`` runs of ``period`` Mamba2 layers, and once more the
    ``tail`` of L % period layers when there is one."""
    period = cfg.shared_attn_period or cfg.n_layers
    return (period, *divmod(cfg.n_layers, period))


def device_of(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# parameter shapes / init
# ---------------------------------------------------------------------------


def _attn_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = {"wq": (d, h * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
         "wo": (h * hd, d)}
    if cfg.qkv_bias:
        s |= {"bq": (h * hd,), "bk": (hkv * hd,), "bv": (hkv * hd,)}
    if cfg.qk_norm:
        s |= {"q_norm": (hd,), "k_norm": (hd,)}
    return s


def _mlp_shapes(d: int, ff: int) -> dict[str, tuple]:
    return {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


def _ln_shapes(cfg: ModelConfig, names: tuple[str, ...]) -> dict[str, tuple]:
    if cfg.nonparam_ln:
        return {}
    return {n: (cfg.d_model,) for n in names}


def tree_map(fn, tree, *rest, path=None):
    """``fn`` over the leaves of nested dicts of one structure (``rest`` is
    read at ``tree``'s keys): ``fn(leaf, *rest_leaves)``, or, given a
    ``path`` (a tuple: the keys above ``tree``), ``fn(path, leaf, ...)``
    with each leaf's own path."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest),
                            path=None if path is None else path + (k,))
                for k, v in tree.items()}
    return fn(tree, *rest) if path is None else fn(path, tree, *rest)


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested dict of parameter shapes, per-layer entries stacked over a
    leading L dim (the reference's layout)."""
    _require_lm(cfg)
    d, V = cfg.d_model, cfg.vocab
    out: dict[str, Any] = {"embed": (V, d)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (V, d)
    out["final_ln"] = (d,)
    for name, n in stacks(cfg).items():
        if cfg.family in ("ssm", "hybrid"):
            mshapes = (ssm_mod.mamba1_param_shapes
                       if cfg.family == "ssm" or cfg.mamba_version == 1
                       else ssm_mod.mamba2_param_shapes)
            layer = {"mamba": mshapes(cfg)} | _ln_shapes(cfg, ("ln1",))
        else:
            if name == "layers" and cfg.family == "moe":
                ffn = {"moe": moe_mod.moe_param_shapes(cfg)}
            else:
                ff = cfg.d_ff_first_dense if name == "dense_layers" else cfg.d_ff
                ffn = {"mlp": _mlp_shapes(d, ff)}
            layer = {"attn": _attn_shapes(cfg), **ffn}
            layer |= _ln_shapes(cfg, ("ln1", "ln2"))
        out[name] = tree_map(lambda s, n=n: (n, *s), layer)
    if cfg.family == "hybrid":
        shared = {"attn": _attn_shapes(cfg), "mlp": _mlp_shapes(d, cfg.d_ff)}
        out["shared_block"] = shared | _ln_shapes(cfg, ("ln1", "ln2"))
    return out


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order (the
    reference's pytree order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _param(t: torch.Tensor) -> nn.Parameter:
    # no gradient tracking unless asked for (module docstring)
    return nn.Parameter(t, requires_grad=False)


class Block:
    """One layer's weights, views of the stacked tensors: a transformer
    layer's ``attn`` by name and ``mlp`` (a SwiGLU's, or whisper's GELU
    MLP) or ``moe`` (the router, the experts and the shared experts, nested
    as the reference's), or a Mamba layer's ``mamba``; a whisper decoder
    layer's cross-attention ``xattn``; the parts a layer lacks None; the
    norm scales ``ln1``/``ln2``/``ln3`` (None for a non-parametric
    LayerNorm)."""

    def __init__(self, tensors: dict):
        self.attn = tensors.get("attn")
        self.xattn = tensors.get("xattn")
        self.mlp = tensors.get("mlp")
        self.moe = tensors.get("moe")
        self.mamba = tensors.get("mamba")
        self.ln1 = tensors.get("ln1")
        self.ln2 = tensors.get("ln2")
        self.ln3 = tensors.get("ln3")


def unstack(layers: dict, n_layers: int) -> list[Block]:
    """Each layer's weights as views of the stacked (L, ...) tensors, one
    ``unbind`` a tensor: its backward is one ``stack`` of the L gradients."""
    parts = tree_map(lambda t: t.unbind(0), layers)
    return [Block(tree_map(lambda u, i=i: u[i], parts)) for i in range(n_layers)]


class Params(nn.Module):
    """A nested dict of tensors as a module: a leaf becomes a parameter
    (without a copy), a dict a submodule; ``tree()`` gives the dict back.
    A stack of layers is one: ``model.layers.attn["wq"]`` (L, d, H*hd)."""

    def __init__(self, tensors: dict):
        super().__init__()
        for k, v in tensors.items():
            if isinstance(v, dict):
                self.add_module(k, Params(v))
            else:
                self.register_parameter(k, _param(v))

    def __getitem__(self, name):
        return getattr(self, name)

    def tree(self) -> dict:
        return dict(self._parameters) | {k: m.tree() for k, m in self._modules.items()}


class LM(nn.Module):
    """The decoder-only LM, built from a nested dict of tensors in
    ``param_shapes(cfg)``'s layout (per-layer entries stacked over L); the
    tensors become its parameters without a copy."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        super().__init__()
        _require_lm(cfg)
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.register_parameter(
            "lm_head", None if cfg.tie_embeddings else _param(tree["lm_head"]))
        self.final_ln = _param(tree["final_ln"])
        for name in (*stacks(cfg), *unstacked(cfg)):
            setattr(self, name, Params(tree[name]))

    def tree(self) -> dict:
        """The parameters as the reference's tree: nested dicts of the
        module's own tensors (not copies), per-layer entries stacked."""
        out: dict[str, Any] = {"embed": self.embed}
        if self.lm_head is not None:
            out["lm_head"] = self.lm_head
        out["final_ln"] = self.final_ln
        for name in (*stacks(self.cfg), *unstacked(self.cfg)):
            out[name] = getattr(self, name).tree()
        return out

    @property
    def blocks(self) -> list[Block]:
        """Each layer's weights in the order a forward runs them, views of
        the stacked parameters without autograd history (the hybrid
        family's shared block, which has no L axis, is not among them)."""
        tree = tree_map(torch.Tensor.detach, self.tree())
        return [blk for name, n in stacks(self.cfg).items()
                for blk in unstack(tree[name], n)]


def copy_into(dst: dict, src: dict) -> None:
    """Copy the leaves of nested dict ``src`` into the tensors of ``dst``
    at the same paths, in place; paths ``src`` lacks keep their values.
    Shapes must agree."""
    for k, d in dst.items():
        if k not in src:
            continue
        if isinstance(d, dict):
            copy_into(d, src[k])
            continue
        s = src[k]
        if not isinstance(s, torch.Tensor):
            s = torch.as_tensor(s)
        if tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"{k!r}: shape {tuple(s.shape)}, expected "
                             f"{tuple(d.shape)}")
        if s is not d:
            with torch.no_grad():
                d.copy_(s)


def require_servable(cfg: ModelConfig, mesh) -> None:
    """The families that serve and train on a model axis: dense and moe."""
    if mesh is not None and mesh.shape.get("model", 1) > 1 \
            and cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family on a model axis is not "
            f"ported yet: ROADMAP.md §1 item 11.7c")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", mesh=None) -> LM:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, on
    ``device``, by the reference's rule (``init_one``), read off the stacked
    shape: 1-D scales are ones; other shapes of at most two dims ending in
    d_model (embeddings, per-layer norm scales) are 0.02 N(0, 1); the rest
    N(0, 1) / sqrt(shape[-2]).  The distributions are the reference's, the
    numbers another generator's.  A leaf is drawn in float32 and scaled in
    place before its cast, so a (27, 64, 2048, 1408) expert leaf needs one
    float32 copy beside its bf16 one, not two.  On a ``mesh`` each leaf is
    drawn whole, in the same order, and this rank keeps its block of it
    (``sharding.param_spec_for``): the blocks of the weights one process
    draws without a mesh."""
    require_servable(cfg, mesh)
    dev = device_of(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pdt = _pdt(cfg)

    def init_one(shape):
        if len(shape) <= 2 and (shape[-1:] == (cfg.d_model,) or len(shape) == 1):
            if not pdt.is_floating_point:
                return torch.zeros(shape, dtype=pdt, device=dev)
            if len(shape) == 1:
                return torch.ones(shape, dtype=pdt, device=dev)
            scale = 0.02
        else:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        return torch.randn(shape, generator=gen, device=dev).mul_(scale).to(pdt)

    def leaf(path, shape):
        t = init_one(shape)
        if mesh is None:
            return t
        sp = sharding.param_spec_for(mesh, path, shape)
        return t[sharding.block_slices(shape, sp, mesh)].clone()

    return LM(cfg, tree_map(leaf, param_shapes(cfg), path=()))


# ---------------------------------------------------------------------------
# forward (train / prefill), cache-threaded for decode
# ---------------------------------------------------------------------------


def _mamba_block(lp: Block, x, cfg: ModelConfig, state=None):
    """One Mamba layer: (x, new state or None)."""
    fwd = (ssm_mod.mamba1_forward if cfg.mamba_version == 1
           else ssm_mod.mamba2_forward)
    h, new_state = fwd(lp.mamba, norm(x, lp.ln1, cfg), cfg, state=state)
    return x + h, new_state


def _ssm_stack(tree, x, cfg: ModelConfig, positions, caches, attn_cache,
               remat: bool):
    """The ssm and hybrid families' layers over x.  ``attn_cache(c, i)``
    makes a shared application's per-call cache from an entry of
    ``caches["shared"]`` (None for None).  Each layer's new state is
    written into ``caches["layers"]`` in place.  With ``remat``, each layer
    is recomputed in the backward pass, except in the hybrid family's
    groups, where each group (its Mamba2 layers and the shared block after
    them) is, as the reference's ``jax.checkpoint(group_body)``; its tail
    layers are per layer and its last shared application is not."""
    n = cfg.n_layers
    blks = unstack(tree["layers"], n)

    def layer(i, h, per_layer=remat):
        if caches is not None:
            conv, hs = caches["layers"]
            h, (tail, last) = _mamba_block(blks[i], h, cfg, state=(conv[i], hs[i]))
            conv[i].copy_(tail)
            hs[i].copy_(last)
            return h
        if per_layer:
            return checkpoint(_mamba_block, blks[i], h, cfg, use_reentrant=False,
                              preserve_rng_state=False)[0]
        return _mamba_block(blks[i], h, cfg)[0]

    if cfg.family == "ssm":
        for i in range(n):
            x = layer(i, x)
        return x

    shared = Block(tree["shared_block"])
    period, n_groups, tail = shared_groups(cfg)
    grp = tail_cache = None
    if caches is not None:
        grp, tail_cache = caches["shared"]["grp"], caches["shared"].get("tail")

    def shared_apply(h, cache):
        return _transformer_block(shared, h, cfg, positions, cache=cache)[0]

    def group(g, h):
        for i in range(g * period, (g + 1) * period):
            h = layer(i, h, per_layer=False)
        return shared_apply(h, attn_cache(grp, g))

    for g in range(n_groups):
        x = (checkpoint(group, g, x, use_reentrant=False, preserve_rng_state=False)
             if remat else group(g, x))
    if tail:
        for i in range(n_groups * period, n):
            x = layer(i, x)
        x = shared_apply(x, attn_cache(tail_cache, None))
    return x


def _transformer_block(lp: Block, x, cfg: ModelConfig, positions, cache=None,
                       group=None, mesh=None):
    """One block: (x, aux), aux the MoE's load-balancing loss (0.0 for a
    SwiGLU block; this rank's share of it over a data ``group``).  On a
    ``mesh``'s model axis lp holds this rank's blocks: the SwiGLU's column
    and row blocks end in one all-reduce (the MoE's, ``moe_block``)."""
    tp = sharding.model_group(mesh)
    x = x + attention_block(lp.attn, norm(x, lp.ln1, cfg), cfg, positions,
                            cache=cache, tp=tp)
    if lp.moe is None:
        if tp is None:
            return x + swiglu(lp.mlp, norm(x, lp.ln2, cfg)), 0.0
        # the moe family's only SwiGLU blocks are its first dense layers
        ff = cfg.d_ff_first_dense if cfg.family == "moe" else cfg.d_ff
        cut = tp if lp.mlp["w_down"].shape[0] != ff else None
        return x + row_parallel(swiglu_hidden(lp.mlp, norm(x, lp.ln2, cfg), tp=cut),
                                lp.mlp["w_down"], tp, ff), 0.0
    y, aux = moe_mod.moe_block(lp.moe, norm(x, lp.ln2, cfg), cfg, group=group,
                               mesh=mesh)
    return x + y, aux


def embed_tokens(embed, tokens, cfg: ModelConfig, tp=None):
    """The embedding rows of ``tokens`` in the compute dtype; over a model
    group ``tp`` with ``embed`` this rank's block of the vocabulary, the
    rows of its range, zeros for the rest, summed over the ranks (one
    all-reduce, exact: each token's row comes from one rank)."""
    if tp is None or embed.shape[0] == cfg.vocab:
        return F.embedding(tokens, embed).to(_dt(cfg))
    rows = embed.shape[0]
    local = tokens - tp.index * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(mine, local, 0), embed)
    return reduce_from_model(torch.where(mine[..., None], x.float(), 0.0), tp, _dt(cfg))


def greedy(logits, cfg: ModelConfig, mesh=None):
    """The next tokens (B,) int64, greedy: the argmax over the vocabulary
    of ``logits`` (B, V) in this rank's rows, or on a ``mesh`` (B, V/M), this
    rank's block of the vocabulary; there the block's max and its index are
    gathered over "model" and the first largest taken, so ties go to the
    lowest index as ``argmax`` over all of V; then the rows of every data
    rank are gathered, in the order of the global batch."""
    pick = logits.argmax(-1)
    tp = sharding.model_group(mesh)
    if tp is not None and logits.shape[-1] != cfg.vocab:
        val = logits.gather(-1, pick[:, None])[:, 0].double()
        idx = (pick + tp.index * logits.shape[-1]).double()
        both = tp.all_gather(torch.stack([val, idx], dim=-1)[None])   # (M, B, 2)
        best = both[..., 0].argmax(0)
        pick = both[..., 1].gather(0, best[None])[0].long()
    if mesh is not None and mesh.dp.size > 1:
        pick = mesh.dp.all_gather(pick)
    return pick


def forward(params, tokens, cfg: ModelConfig, *, positions=None,
            inputs_embeds=None, caches=None, q_offset=None, group=None,
            mesh=None):
    """Shared forward.  params: an ``LM`` or its ``tree()`` (nested dicts of
    tensors in ``param_shapes(cfg)``'s layout); tokens: (B, S) int32, or
    None with ``inputs_embeds`` (B, S, d), which replace the embedding
    lookup (the vlm family).  positions: (B, S) int32, or (3, B, S) with
    ``cfg.mrope``; None counts up from ``q_offset`` (on all three streams
    with ``cfg.mrope``).

    caches: None for a full forward (logits at every position); a cache
    from ``init_cache`` for prefill and decode, written at its host_index.
    Returns (logits, caches, aux_loss) as the reference does; aux_loss is
    the sum of the MoE blocks' (0.0 for the other families).  Without a
    cache and with gradients tracked, ``cfg.remat == "block"`` keeps only
    each block's input (each group's, in the hybrid family's groups) for
    the backward pass and recomputes the rest (the routing too: the same
    experts and slots, since both are deterministic).

    group: a data-parallel ``launch/mesh.py`` ``Group`` whose ranks each
    hold their rows of one global batch (training); the MoE blocks then
    route as the global computation does (``moe.route``) and aux_loss is
    this rank's share of the global one.

    mesh: serving or training on a mesh (module docstring): params and
    caches this rank's blocks, tokens its rows; the logits its (B, S, V/M) block on a
    model axis.  The data group is ``group``'s default.
    """
    _require_lm(cfg)
    require_servable(cfg, mesh)
    tp = sharding.model_group(mesh)
    if group is None and mesh is not None and mesh.dp.size > 1:
        group = mesh.dp
    tree = params.tree() if isinstance(params, LM) else params
    cdt = _dt(cfg)
    if inputs_embeds is not None:
        x = inputs_embeds.to(cdt)
    else:
        x = embed_tokens(tree["embed"], tokens, cfg, tp)
    b, s = x.shape[:2]
    if positions is None:
        positions = (torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
                     + (q_offset or 0)).expand(b, s)
        if cfg.mrope:
            positions = positions.expand(3, b, s)

    length = idx = length_block = None
    blk = caches.get("block") if caches is not None else None
    if caches is not None:
        idx = caches["host_index"]
        # the decode kernel's (B,) lengths, made once for all layers, and
        # on a sequence-sharded cache this rank's share of them
        if s == 1 and cfg.family != "ssm":
            length = torch.full((b,), idx + 1, dtype=torch.int32, device=x.device)
            if blk is not None:
                length_block = torch.full(
                    (b,), min(max(idx + 1 - blk.offset, 0), blk.rows),
                    dtype=torch.int32, device=x.device)

    def attn_cache(c, i):
        """Layer i's view of attention cache c (c itself for i None; None
        without a cache)."""
        if c is None:
            return None
        k, v = (c["k"], c["v"]) if i is None else (c["k"][i], c["v"][i])
        return {"k": k, "v": v, "index": idx, "length": length, "block": blk,
                "length_block": length_block}

    remat = caches is None and remat_wanted(tree, cfg)
    total_aux = 0.0
    if cfg.family in ("ssm", "hybrid"):
        x = _ssm_stack(tree, x, cfg, positions, caches, attn_cache, remat)
    else:
        for name, n in stacks(cfg).items():
            c = None if caches is None else caches[name]
            for i, lp in enumerate(unstack(tree[name], n)):
                if remat:
                    x, aux = checkpoint(_transformer_block, lp, x, cfg, positions,
                                        group=group, mesh=mesh, use_reentrant=False,
                                        preserve_rng_state=False)
                else:
                    x, aux = _transformer_block(lp, x, cfg, positions,
                                                cache=attn_cache(c, i), group=group,
                                                mesh=mesh)
                total_aux = total_aux + aux
    if caches is not None:
        _advance(caches, idx + s)

    x = norm(x, tree["final_ln"], cfg)
    head = tree["embed"] if cfg.tie_embeddings else tree["lm_head"]
    if head.shape[0] != cfg.vocab:             # this rank's block of V
        x = copy_to_model(x, tp)
    logits = x @ head.to(cdt).T
    return logits, caches, total_aux


def remat_wanted(tree: dict, cfg: ModelConfig) -> bool:
    """Recompute each block in the backward pass: ``cfg.remat == "block"``
    with a gradient tracked through ``tree``'s parameters."""
    return (cfg.remat == "block" and torch.is_grad_enabled()
            and any(t.requires_grad for _, t in leaves(tree)))


def _advance(caches: dict, index: int) -> None:
    """Every attention cache's device ``index`` and the host_index to
    ``index``."""
    for k, c in caches.items():
        if k == "index":
            c.fill_(index)
        elif isinstance(c, dict):
            _advance(c, index)
    if "host_index" in caches:
        caches["host_index"] = index


def loss_fn(params, batch: dict, cfg: ModelConfig, group=None, mesh=None):
    """Causal LM loss, as the reference computes it: ``token_loss`` plus
    0.01 x the aux loss.  batch: {"tokens" (B, S) int32, "labels" (B, S)
    int32}; the vlm family's "inputs_embeds" and "positions" in place of
    "tokens" (``forward``).  Over a data ``group`` (each rank its rows of
    one global batch) it is this rank's share of the global loss: the
    shares, and their gradients, sum over the ranks to the global batch's.
    On a ``mesh`` with a model axis params are this rank's blocks and the
    loss is taken from its block of the logits
    (``tp.vocab_parallel_token_loss``); every rank of the model group
    holds the same value."""
    logits, _, aux = forward(params, batch.get("tokens"), cfg,
                             positions=batch.get("positions"),
                             inputs_embeds=batch.get("inputs_embeds"),
                             group=group, mesh=mesh)
    tp = sharding.model_group(mesh)
    if tp is not None and logits.shape[-1] != cfg.vocab:
        return vocab_parallel_token_loss(logits, batch["labels"], tp, group) \
            + 0.01 * aux
    return token_loss(logits, batch["labels"], group) + 0.01 * aux


def token_loss(logits, labels, group=None):
    """float32 logits, ``logsumexp - gold`` at every position whose label
    is >= 0, the mean over those positions (at least 1); over a data
    ``group``, this rank's sum over the count of the whole group's
    positions (one all-reduce, no gradient), so that a mask that differs
    between ranks weighs each position as the global mean does."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # a masked label gathers row 0 (the reference wraps -1 to V - 1); either
    # way the mask zeroes its term and its gradient
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    ll = (logz - gold) * mask
    count = mask.sum()
    if group is not None:
        count = group.all_reduce(count)
    return ll.sum() / torch.clamp(count, min=1.0)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache_specs(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    """(shape, dtype) of every entry of the decode cache: one {k, v, index}
    a stack of transformer layers; for the ssm and hybrid families a pair
    (conv tail, h) of the Mamba layers and the hybrid's shared attention
    caches, {"grp": one a group, "tail": one without the L axis}."""
    _require_lm(cfg)
    hkv, hd = cfg.n_kv_heads, cfg.hd

    def attn_cache(*n):
        kv = ((*n, batch, max_seq, hkv, hd), _dt(cfg))
        return {"k": kv, "v": kv, "index": (n, torch.int32)}

    if cfg.family not in ("ssm", "hybrid"):
        return {name: attn_cache(n) for name, n in stacks(cfg).items()}
    conv, h = ssm_mod.ssm_state_shapes(cfg, batch)
    out: dict[str, Any] = {"layers": (((cfg.n_layers, *conv), _dt(cfg)),
                                      ((cfg.n_layers, *h), torch.float32))}
    if cfg.family == "hybrid":
        _, n_groups, tail = shared_groups(cfg)
        out["shared"] = {"grp": attn_cache(n_groups)}
        if tail:
            out["shared"]["tail"] = attn_cache()
    return out


def _zeros(spec, dev):
    if isinstance(spec, dict):
        return {k: _zeros(v, dev) for k, v in spec.items()}
    if isinstance(spec[1], torch.dtype):             # (shape, dtype)
        return torch.zeros(spec[0], dtype=spec[1], device=dev)
    return tuple(_zeros(v, dev) for v in spec)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda",
               mesh=None) -> dict:
    """A zero decode cache for ``batch`` rows of ``max_seq`` positions; on a
    ``mesh`` this rank's blocks of it (``sharding.cache_spec_for``: its rows
    of the batch over the data axes, its rows of S on a model axis, recorded
    as ``"block"``, a ``sharding.SeqBlock``)."""
    specs = init_cache_specs(cfg, batch, max_seq)
    if mesh is not None:
        require_servable(cfg, mesh)
        specs = sharding.map_with_path(
            lambda path, sd: (sharding.local_shape(
                sd[0], sharding.cache_spec_for(mesh, path, sd[0]), mesh), sd[1]),
            specs)
    caches = _zeros(specs, device_of(device))
    caches["host_index"] = 0
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        caches["block"] = sharding.seq_block(mesh, max_seq)
    return caches


def decode_step(params: LM, token, caches: dict, cfg: ModelConfig,
                positions=None, mesh=None):
    """One-token decode.  token: (B, 1) int32; positions: None (the cache
    index) or as ``forward``'s.  Returns (logits, caches): logits (B, V) of
    the step (on a ``mesh``'s model axis this rank's (B, V/M) block),
    caches the same dict, written in place."""
    logits, caches, _ = forward(params, token, cfg, positions=positions,
                                caches=caches, q_offset=caches["host_index"],
                                mesh=mesh)
    return logits[:, -1], caches
