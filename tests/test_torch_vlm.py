"""The port's vlm family (qwen2-vl: M-RoPE over stub image embeddings;
``layers.apply_mrope``, the vlm branches of models/lm.py, launch/steps.py
and launch/train.py) and ``layers.attention_block``'s three modes against
the reference package's, on the CPU.

Weights are the reference's ``init_params`` carried over bit for bit with
``params_from_jax``; embeddings, tokens and activations come from numpy.
Positions follow Qwen2-VL's rope index (arXiv:2409.12191 §2.1): text before
an image counts up on all three streams, an image token at (row, col) of a
g x g grid has (t, h, w) = (start, start + row, start + col), and the text
after it resumes at start + g, so the three streams differ (with identical
streams M-RoPE is plain RoPE).  Tolerances:

- float32 blocks and models: atol 1e-4 on outputs, logits and caches;
- float32 loss: rtol 1e-5; gradients every leaf within 1e-4 x its largest
  |g| of ``jax.grad``'s; a train step's moments within 1e-4 of their
  largest magnitude, its parameters within 1 % of one step's size (lr)
  where the gradient is resolved at that tolerance, else within 2 lr.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeSpec as RShapeSpec  # noqa: E402
from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_numpy  # noqa: E402
from repro_torch.optim import OptConfig, adamw  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
ARCH = "qwen2-vl-2b"
B, S, STEPS, GRID = 2, 24, 3, 3      # a 3 x 3 image after 4 + 2b text tokens


def _port_cfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                               err_msg=what)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def rope_index(n_before: int, grid: int, n: int) -> np.ndarray:
    """(3, n) int32 Qwen2-VL positions of one prompt: n_before text tokens,
    a grid x grid image, then text."""
    pos = np.empty((3, n), np.int32)
    pos[:, :n_before] = np.arange(n_before)
    row, col = np.divmod(np.arange(grid * grid), grid)
    img = slice(n_before, n_before + grid * grid)
    pos[0, img] = n_before
    pos[1, img] = n_before + row
    pos[2, img] = n_before + col
    pos[:, img.stop:] = n_before + grid + np.arange(n - img.stop)
    return pos


def prompt(cfg, embed: np.ndarray, b: int, s: int, seed: int):
    """(inputs_embeds (b, s, d) float32, positions (3, b, s) int32): request
    r has 4 + 2r text tokens (rows of ``embed``), a GRID x GRID image of
    N(0, 0.02) rows, then text."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s))
    emb = embed[toks].astype(np.float32)
    pos = np.empty((3, b, s), np.int32)
    for r in range(b):
        n_before = 4 + 2 * r
        img = slice(n_before, n_before + GRID * GRID)
        emb[r, img] = rng.normal(0, 0.02, (GRID * GRID, cfg.d_model))
        pos[:, r] = rope_index(n_before, GRID, s)
    return emb, pos


@pytest.fixture(scope="module")
def vlm():
    """The float32 reduced config, the reference's weights as numpy and the
    port's model holding them, and one prompt batch."""
    rcfg = rget_reduced(ARCH).replace(**F32)
    cfg = _port_cfg(rcfg)
    params = jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(3)))
    emb, pos = prompt(cfg, params["embed"], B, S, 1)
    return rcfg, cfg, params, params_from_jax(cfg, params, device="cpu"), emb, pos


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rope_index_streams_differ():
    pos = rope_index(4, GRID, 20)
    assert pos[:, :4].tolist() == [[0, 1, 2, 3]] * 3
    assert pos[:, 4 + GRID * GRID - 1].tolist() == [4, 4 + GRID - 1, 4 + GRID - 1]
    assert pos[:, 4 + GRID * GRID].tolist() == [4 + GRID] * 3
    assert not np.array_equal(pos[0], pos[1]) and not np.array_equal(pos[1], pos[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference(dtype):
    """Three distinct streams: each frequency section takes its own."""
    rng = np.random.default_rng(0)
    sections = (4, 6, 6)
    x = rng.normal(size=(2, 11, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 11)).astype(np.int32)
    want = rl.apply_mrope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e6, sections)
    got = tl.apply_mrope(_t(x).to(getattr(torch, dtype)), _t(pos), 1e6, sections)
    assert str(got.dtype) == f"torch.{dtype}"
    _close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7 * 4)
    # the streams matter: the t stream alone (plain RoPE) is another rotation
    rope = tl.apply_rope(_t(x), _t(pos[0]), 1e6)
    assert float((rope - tl.apply_mrope(_t(x), _t(pos), 1e6, sections)).abs().max()) > 0.1


def test_apply_mrope_sections_must_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 32))
    with pytest.raises(ValueError, match="sum to"):
        tl.apply_mrope(x, torch.zeros((3, 1, 2), dtype=torch.int32), 1e6, (4, 6, 4))


def _block_case(arch, seed, s=7, f=9):
    """A reduced config in float32, one layer's attention weights (numpy)
    and inputs x (B, s, d), positions, and a cross K/V (B, f, Hkv, hd)."""
    rcfg = rget_reduced(arch).replace(**F32)
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=shp) / np.sqrt(shp[0] if len(shp) > 1 else 4)).astype(np.float32)
         for k, shp in rlm._attn_shapes(rcfg).items()}
    x = rng.normal(size=(2, s, rcfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, s) if rcfg.mrope else (2, s)).astype(np.int32)
    kv = tuple(rng.normal(size=(2, f, rcfg.n_kv_heads, rcfg.hd)).astype(np.float32)
               for _ in range(2))
    return rcfg, p, x, pos, kv


@pytest.mark.parametrize("mode", ["mrope", "no_positions", "cross"])
def test_attention_block_modes_match_reference(mode):
    """M-RoPE positions (qwen2-vl, qkv_bias); positions None (no rotation,
    causal); precomputed cross K/V (non-causal, no K/V projection), over 7
    queries and over one."""
    rcfg, p, x, pos, kv = _block_case(ARCH if mode == "mrope" else "whisper-base", 5)
    cfg = _port_cfg(rcfg)
    tp = tlm.tree_map(_t, p)
    for s in (x.shape[1], 1):
        xs = x[:, :s]
        if mode == "cross":
            want, _ = rl.attention_block(p, xs, rcfg, None, layer_cross_kv=kv)
            got = tl.attention_block(tp, _t(xs), cfg, None,
                                     layer_cross_kv=tuple(map(_t, kv)))
        else:
            ps = pos[..., :s] if mode == "mrope" else None
            want, _ = rl.attention_block(p, xs, rcfg, ps)
            got = tl.attention_block(tp, _t(xs), cfg, None if ps is None else _t(ps))
        _close(got, want, 1e-4, f"{mode} s={s}")


def test_cross_attention_decode_goes_through_decode_attention(monkeypatch):
    """A single-token query over cross K/V with ``cross_length`` (F in every
    row) asks the registry's decode_attention once, and gives the
    reference's non-causal attention_scores route."""
    rcfg, p, x, _, kv = _block_case("whisper-base", 6, s=1, f=11)
    kernels = treg.resolve("cpu")
    calls = []
    plain = kernels.decode_attention

    def counted(q, k, v, length):
        calls.append((tuple(k.shape), length.tolist()))
        return plain(q, k, v, length)

    monkeypatch.setitem(kernels._fns, "decode_attention", counted)
    want, _ = rl.attention_block(p, x, rcfg, None, layer_cross_kv=kv)
    got = tl.attention_block(tlm.tree_map(_t, p), _t(x), _port_cfg(rcfg), None,
                             layer_cross_kv=tuple(map(_t, kv)),
                             cross_length=torch.full((2,), 11, dtype=torch.int32))
    assert calls == [((2, 11, rcfg.n_kv_heads, rcfg.hd), [11, 11])]
    _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# the model: shapes, caches, forward, prefill and decode
# ---------------------------------------------------------------------------

def test_param_shapes_and_counts_are_the_references():
    from repro.configs import get_config as rget_config
    for rcfg in (rget_reduced(ARCH), rget_config(ARCH)):
        cfg = _port_cfg(rcfg)
        assert _flat(tlm.param_shapes(cfg)) == _flat(rlm.param_shapes(rcfg))
        assert cfg.param_count() == rcfg.param_count()
    full = _flat(tlm.param_shapes(get_config(ARCH)))
    assert sum(int(np.prod(s)) for s in full.values()) == 1_543_714_304


def test_specs_are_the_references():
    rcfg = rget_reduced(ARCH)
    cfg = _port_cfg(rcfg)
    for kind in ("train", "prefill", "decode"):
        got = tsteps.input_specs(cfg, ShapeSpec("t", kind, 16, 4))
        want = rsteps.input_specs(rcfg, RShapeSpec("t", kind, 16, 4))
        assert list(got) == list(want)
        assert {k: (s, str(d)) for k, (s, d) in got.items()} == \
            {k: (v.shape, f"torch.{v.dtype.name}") for k, v in want.items()}
    got = tsteps.cache_specs(cfg, ShapeSpec("t", "decode", 16, 4))
    want = rsteps.cache_specs(rcfg, RShapeSpec("t", "decode", 16, 4))
    assert {k: (s, str(d)) for k, (s, d) in _flat(got).items()} == \
        {k: (v.shape, f"torch.{v.dtype.name}") for k, v in _flat(want).items()}
    got = tsteps.model_param_specs(cfg)
    want = rsteps.model_param_specs(rcfg)
    assert {k: (s, str(d)) for k, (s, d) in _flat(got).items()} == \
        {k: (v.shape, f"torch.{v.dtype.name}") for k, v in _flat(want).items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_from_jax_is_bit_exact(dtype):
    rcfg = rget_reduced(ARCH).replace(param_dtype=dtype, compute_dtype=dtype)
    params = jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(1)))
    model = params_from_jax(_port_cfg(rcfg), params, device="cpu")
    got, want = _flat(to_numpy(model.tree())), _flat(params)
    assert sorted(got) == sorted(want) and "layers/attn/bq" in got
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.view(got[k].dtype), err_msg=k)


def test_forward_matches_reference(vlm):
    """inputs_embeds and three distinct position streams; and without
    positions, the default counting up on all three streams."""
    rcfg, cfg, params, model, emb, pos = vlm
    fwd = jax.jit(functools.partial(rlm.forward, cfg=rcfg))
    want, _, _ = fwd(params, None, positions=jnp.asarray(pos),
                     inputs_embeds=jnp.asarray(emb))
    got, caches, aux = tlm.forward(model, None, cfg, positions=_t(pos),
                                   inputs_embeds=_t(emb))
    assert caches is None and aux == 0.0
    _close(got, want, 1e-4, "rope index positions")
    want, _, _ = fwd(params, None, inputs_embeds=jnp.asarray(emb))
    got, _, _ = tlm.forward(model, None, cfg, inputs_embeds=_t(emb))
    _close(got, want, 1e-4, "default positions")


def test_prefill_and_decode_match_reference(vlm):
    """A prefill of image prompts, then STEPS decode steps at the
    reference's decode positions: logits and every cache entry."""
    rcfg, cfg, params, model, emb, pos = vlm
    rng = np.random.default_rng(4)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]
    prefill = jax.jit(rsteps.make_prefill_step(rcfg, S + STEPS))
    decode = jax.jit(rsteps.make_decode_step(rcfg))
    logits, caches = prefill(params, {"inputs_embeds": jnp.asarray(emb),
                                      "positions": jnp.asarray(pos)})
    want, want_caches = [logits], [caches]
    for t in steps:
        logits, caches = decode(params, jnp.asarray(t), caches)
        want.append(logits)
        want_caches.append(caches)

    logits, caches = tsteps.make_prefill_step(cfg, S + STEPS)(
        model, {"inputs_embeds": _t(emb), "positions": _t(pos)})
    got, got_caches = [logits], [{k: v.clone() for k, v in _flat(caches["layers"]).items()}]
    for t in steps:
        logits, caches = tsteps.make_decode_step(cfg)(model, _t(t), caches)
        got.append(logits)
        got_caches.append({k: v.clone() for k, v in _flat(caches["layers"]).items()})
    _close(torch.stack(got, 1), np.stack([np.asarray(w) for w in want], 1), 1e-4)
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        w = _flat(w["layers"])
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g["index"].numpy(), np.asarray(w["index"]))
        for k in ("k", "v"):
            _close(g[k], w[k], 1e-4, f"{k} after step {i}")
    assert caches["host_index"] == S + STEPS


def test_decode_positions_are_the_cache_index(vlm):
    """The reference's decode rule, kept for parity (ROADMAP §3): after an
    image the step's position is the cache index on all three streams, not
    Qwen2-VL's largest position + 1.  The served logits equal a no-cache
    forward with those positions, and differ from one with Qwen2-VL's
    (by 7.7e-4 here: random weights, positions 6 apart at theta 1e6)."""
    _, cfg, params, model, emb, pos = vlm
    t = np.random.default_rng(6).integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    _, caches = tsteps.make_prefill_step(cfg, S + 1)(
        model, {"inputs_embeds": _t(emb), "positions": _t(pos)})
    served, _ = tsteps.make_decode_step(cfg)(model, _t(t), caches)
    seq = np.concatenate([emb, params["embed"][t]], 1)

    def forward_at(step_pos):
        full = np.concatenate([pos, np.broadcast_to(step_pos, (3, B, 1))], 2)
        return tlm.forward(model, None, cfg, positions=_t(full),
                           inputs_embeds=_t(seq))[0][:, -1]
    _close(served, forward_at(np.int32(S)), 1e-4)
    qwen = pos.max(axis=(0, 2))[:, None] + 1          # (B, 1), < S after an image
    assert (qwen < S).all()
    # at least three times the tolerance that held the cache-index forward
    far = float((served - forward_at(qwen[None].astype(np.int32))).abs().max())
    assert far > 3e-4, far


def test_decode_attention_launches_per_step(vlm, monkeypatch):
    """A decode step asks the registry's decode_attention once per layer;
    the prefill never."""
    _, cfg, _, model, emb, pos = vlm
    kernels = treg.resolve("cpu")
    calls = []
    plain = kernels.decode_attention

    def counted(q, k, v, length):
        calls.append(int(length[0]))
        return plain(q, k, v, length)

    monkeypatch.setitem(kernels._fns, "decode_attention", counted)
    _, caches = tsteps.make_prefill_step(cfg, S + 2)(
        model, {"inputs_embeds": _t(emb), "positions": _t(pos)})
    assert calls == []
    for _ in range(2):
        tsteps.make_decode_step(cfg)(model, torch.ones((B, 1), dtype=torch.int32),
                                     caches)
    assert calls == [S + 1] * cfg.n_layers + [S + 2] * cfg.n_layers


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(vlm, b=B):
    _, cfg, _, _, emb, pos = vlm
    labels = np.random.default_rng(8).integers(0, cfg.vocab, (b, S)).astype(np.int32)
    labels[-1, :3] = -1
    return {"inputs_embeds": emb[:b], "positions": pos[:, :b], "labels": labels}


def test_loss_and_gradients_match_reference(vlm):
    rcfg, cfg, params, model, _, _ = vlm
    batch = _batch(vlm)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, rbatch, rcfg)))(params)
    loss, got = tsteps.value_and_grad(tsteps.make_loss_fn(cfg), model.tree(),
                                      {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    assert float(np.abs(want["layers/attn/bk"]).max()) > 0


def test_train_step_splits_positions_like_reference(vlm):
    """n_micro = 2 over 4 requests: the (3, B, S) positions split along
    their batch axis, the None tokens skipped; loss, parameters and AdamW
    state after one step."""
    rcfg, cfg, _, _, _, _ = vlm
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    params = jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(5)))
    emb, pos = prompt(cfg, params["embed"], 4, S, 9)
    labels = np.random.default_rng(10).integers(0, cfg.vocab, (4, S)).astype(np.int32)
    batch = {"inputs_embeds": emb, "positions": pos, "labels": labels}
    rstate = {"params": params, "opt": radamw.init_state(params, ROptConfig(**kw))}
    rstep = jax.jit(rsteps.make_train_step(rcfg, ROptConfig(**kw), n_micro=2))
    rstate, rloss = rstep(rstate, {k: jnp.asarray(v) for k, v in batch.items()})
    model = params_from_jax(cfg, params, device="cpu")
    ocfg = OptConfig(**kw)
    tstate = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    tstate, tloss = tsteps.make_train_step(cfg, ocfg, n_micro=2)(
        tstate, {"tokens": None, **{k: _t(v) for k, v in batch.items()}})
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want, got = _flat(jax.tree.map(np.asarray, rstate)), _flat(tstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        if not k.startswith("params"):
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5,
                                       atol=1e-4 * float(np.abs(w).max()), err_msg=k)
            continue
        # AdamW's first step moves each parameter by ~lr x the sign of its
        # gradient, so an element whose gradient lies within the gradients'
        # tolerance (1e-4 x the leaf's largest |m|) may move either way
        # (the qkv biases of keys, whose gradient M-RoPE's rotation alone
        # makes nonzero, have some): those within 2 lr, the rest within 1 %
        m = want["opt/m/" + k[len("params/"):]]
        resolved = np.abs(m) > 1e-4 * float(np.abs(m).max())
        diff = np.abs(_np(got[k]) - w)
        assert float(diff.max()) <= 2 * kw["lr"], k
        assert float((diff - 1e-5 * np.abs(w))[resolved].max(initial=0)) <= \
            1e-2 * kw["lr"], k


def test_micro_batches_split_positions_along_the_batch_axis():
    pos = torch.arange(3 * 4 * 5).reshape(3, 4, 5)
    x = torch.arange(4 * 5).reshape(4, 5)
    for i in range(2):
        assert torch.equal(tsteps._micro("positions", pos, 2, i), pos[:, 2 * i:2 * i + 2])
        assert torch.equal(tsteps._micro("labels", x, 2, i), x[2 * i:2 * i + 2])


def test_train_main_runs_the_family():
    """launch/train.py with the reference's stand-in vlm batches (zero
    embeddings, positions counting up on three streams)."""
    with tempfile.TemporaryDirectory() as d:
        res = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16",
                           "--micro", "2", "--ckpt-dir", d])
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    assert int(res["driver"].state["opt"]["step"]) == 2
