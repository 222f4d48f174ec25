"""The port's training path (repro_torch.models.lm.loss_fn, optim.adamw,
launch.steps.make_train_step, checkpoint, runtime.ft, launch.train)
against the reference package's, on the CPU.

Weights are the reference's ``init_params`` carried over bit for bit with
``params_from_jax``; tokens come from numpy.  Tolerances:

- the loss: rtol 1e-5 in float32 (the same float32 operations, summed in
  another order by another library), 2e-2 in bfloat16 (bf16 activations
  rounded at other points);
- gradients: every leaf within 1e-4 x its largest |g| of ``jax.grad``'s;
- ``lr_at``: rtol 1e-6 (cos and pow of float32 in two libraries);
- AdamW ``update``: 1e-6 relative on identical inputs, to each value or
  to its leaf's largest |value| where ``p - lr * step`` cancels (float32
  elementwise); the gradients are chosen so that the global norm is exact
  in any summation order, and the norms are equal;
- three train steps: losses rtol 1e-5; the moments within 1e-4 x their
  leaf's largest |value| (the gradients' bound); parameters within 1 % of
  one step's size, lr 1e-3 (Adam's normalised step m/sqrt(v) is scale
  free: where a gradient entry is near 0 the two packages' rounding of it
  moves the step by up to its own size; 0.3 % seen);
- checkpoints: bitwise.
"""
import dataclasses
import functools
import os
import signal
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import checkpoint as rckpt  # noqa: E402
from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import layers as rl  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models.config import ModelConfig as RModelConfig  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.runtime import ft as rft  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.core import errors as terr  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_jax, params_from_jax, to_numpy)
from repro_torch.optim import OptConfig, adamw  # noqa: E402
from repro_torch.runtime import ft as tft  # noqa: E402
from repro_torch.runtime.retry import RetryPolicy  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
# tests/test_substrate.py's CFG
SUBSTRATE = RModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=2, d_ff=128, vocab=128)


def _port_cfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _jax_params(rcfg, seed=0):
    return jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(seed)))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _np(x):
    """A tensor or array as float32 numpy (bf16 bits read as bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bits(x):
    """Raw bits of a tensor or array, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = to_numpy(x) if x.dtype == torch.bfloat16 else x.detach().numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return toks, labels


def _tbatch(toks, labels):
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}


def _jbatch(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(dtype, masked):
    rcfg = rget_reduced("qwen3-0.6b").replace(param_dtype=dtype, compute_dtype=dtype)
    cfg = _port_cfg(rcfg)
    params = _jax_params(rcfg, 3)
    toks, labels = _tokens(cfg, 2, 12, 4)
    if masked:
        labels[0, :5] = -1
        labels[1, -1] = -1
    want = float(jax.jit(rlm.loss_fn, static_argnums=2)(params, _jbatch(toks, labels), rcfg))
    model = params_from_jax(cfg, params, device="cpu")
    got = float(tlm.loss_fn(model, _tbatch(toks, labels), cfg))
    got_tree = float(tlm.loss_fn(model.tree(), _tbatch(toks, labels), cfg))
    assert got == got_tree
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_loss_all_labels_masked_is_zero():
    cfg = _port_cfg(rget_reduced("qwen3-0.6b"))
    model = tlm.init_params(cfg, seed=0, device="cpu")
    toks, labels = _tokens(cfg, 2, 5, 0)
    labels[:] = -1
    assert float(tlm.loss_fn(model, _tbatch(toks, labels), cfg)) == 0.0


def _port_grads(cfg, tree, batch):
    loss, grads = tsteps.value_and_grad(tsteps.make_loss_fn(cfg), tree, batch)
    return float(loss), {"/".join(p): g for p, g in tlm.leaves(grads)}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "substrate"])
@pytest.mark.parametrize("remat", ["block", "none"])
def test_gradients_match_reference(arch, remat):
    base = SUBSTRATE if arch == "substrate" else rget_reduced(arch)
    rcfg = base.replace(remat=remat, **F32)
    cfg = _port_cfg(rcfg)
    params = _jax_params(rcfg, 1)
    toks, labels = _tokens(cfg, 2, 10, 2)
    labels[1, :3] = -1
    want = jax.jit(jax.grad(lambda p: rlm.loss_fn(p, _jbatch(toks, labels), rcfg)))(params)
    model = params_from_jax(cfg, params, device="cpu")
    _, got = _port_grads(cfg, model.tree(), _tbatch(toks, labels))
    want = _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale, err_msg=k)


def test_remat_leaves_gradients_unchanged():
    """Recomputing each block in the backward pass gives the same bits as
    keeping its activations."""
    cfg = _port_cfg(rget_reduced("qwen3-0.6b").replace(**F32))
    toks, labels = _tokens(cfg, 2, 10, 5)
    out = []
    for remat in ("block", "none"):
        c = cfg.replace(remat=remat)
        model = tlm.init_params(c, seed=2, device="cpu")
        out.append(_port_grads(c, model.tree(), _tbatch(toks, labels)))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_remat_recomputes_blocks(monkeypatch):
    """With remat each block's forward runs twice in a step (forward and
    recomputation), without it once; serving (no gradients) runs once."""
    calls = []
    block = tlm._transformer_block

    def counted(*a, **k):
        calls.append(1)
        return block(*a, **k)

    monkeypatch.setattr(tlm, "_transformer_block", counted)
    for remat, want in (("block", 4), ("none", 2)):
        cfg = _port_cfg(rget_reduced("qwen3-0.6b")).replace(remat=remat)
        model = tlm.init_params(cfg, seed=0, device="cpu")
        toks, labels = _tokens(cfg, 1, 4, 0)
        _port_grads(cfg, model.tree(), _tbatch(toks, labels))
        assert len(calls) == want, remat
        calls.clear()
        with torch.no_grad():
            tlm.loss_fn(model, _tbatch(toks, labels), cfg)
        tlm.loss_fn(model, _tbatch(toks, labels), cfg)   # nothing requires grad
        assert len(calls) == 4, remat
        calls.clear()


def test_backward_fills_module_grads():
    """``model.requires_grad_()`` then ``loss.backward()`` fills each
    stacked parameter's .grad with the train step's gradient."""
    cfg = _port_cfg(rget_reduced("qwen3-0.6b").replace(**F32))
    model = tlm.init_params(cfg, seed=4, device="cpu")
    toks, labels = _tokens(cfg, 2, 6, 1)
    _, want = _port_grads(cfg, model.tree(), _tbatch(toks, labels))
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    tlm.loss_fn(model, _tbatch(toks, labels), cfg).backward()
    for path, p in tlm.leaves(model.tree()):
        torch.testing.assert_close(p.grad, want["/".join(path)], rtol=0, atol=0)


def _qkv(rng, b, sq, sk, hkv, g, hd):
    return (rng.normal(size=(b, sq, hkv, g, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("kind", ["scores", "chunked"])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 30), (False, 0)])
def test_attention_gradients_match_reference(kind, causal, q_offset):
    """d(sum(out * w))/d(q, k, v) against jax.grad; the chunked softmax at
    kv_chunk 8 over 37 keys (a short last chunk)."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 2, 7, 37, 2, 2, 16)
    w = rng.normal(size=q.shape).astype(np.float32)
    if kind == "scores":
        rfn = lambda q, k, v: rl.attention_scores(q, k, v, causal, q_offset)  # noqa: E731
        tfn = lambda q, k, v: tl.attention_scores(q, k, v, causal, q_offset)  # noqa: E731
    else:
        rfn = lambda q, k, v: rl.attention_chunked(q, k, v, causal, q_offset, kv_chunk=8)  # noqa: E731
        tfn = lambda q, k, v: tl.attention_chunked(q, k, v, causal, q_offset, kv_chunk=8)  # noqa: E731
    want = jax.jit(jax.grad(lambda *a: jnp.sum(rfn(*a) * w), argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tfn(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for g, wnt, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=0,
                                   atol=1e-4 * float(np.abs(wnt).max()), err_msg=name)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_matches_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=7, total_steps=40, schedule=schedule)
    ocfg, rocfg = OptConfig(**kw), ROptConfig(**kw)
    for step in range(0, 46):
        got = adamw.lr_at(torch.tensor(step, dtype=torch.int32), ocfg)
        want = radamw.lr_at(jnp.int32(step), rocfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=str(step))
        assert float(adamw.lr_at(step, ocfg)) == float(got)


def _opt_case(seed, pdt):
    """Params, gradients and a mid-run state (step 5) as numpy trees in the
    substrate CFG's layout."""
    rcfg = SUBSTRATE.replace(param_dtype=pdt)
    params = _jax_params(rcfg, seed)
    rng = np.random.default_rng(seed)

    def like(p, scale, positive=False):
        a = rng.normal(size=p.shape).astype(np.float32) * scale
        return np.abs(a) if positive else a

    # gradients k / 64, |k| <= 8: every partial sum of their squares is
    # exact in float32, so the global norm (and the clipping scale) is the
    # same in any summation order
    grads = jax.tree.map(lambda p: (rng.integers(-8, 9, p.shape) / 64).astype(p.dtype),
                         params)
    m = jax.tree.map(lambda p: like(p, 0.01), params)
    v = jax.tree.map(lambda p: like(p, 1e-4, True), params)
    return rcfg, params, grads, m, v


@pytest.mark.parametrize("case", ["clip", "no_clip", "bf16_state", "master",
                                  "bf16_params_master", "no_clip_config"])
def test_update_matches_reference(case):
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=50)
    pdt = "bfloat16" if case == "bf16_params_master" else "float32"
    if case == "clip":
        kw["grad_clip"] = 0.5            # the norm is ~20: clipping active
    elif case == "no_clip":
        kw["grad_clip"] = 1e3            # inactive
    elif case == "no_clip_config":
        kw["grad_clip"] = 0.0            # off
    elif case == "bf16_state":
        kw["state_dtype"] = "bfloat16"
    else:
        kw["use_master"] = True
    ocfg, rocfg = OptConfig(**kw), ROptConfig(**kw)
    rcfg, params, grads, m, v = _opt_case(11, pdt)
    sdt = ml_dtypes.bfloat16 if kw.get("state_dtype") == "bfloat16" else np.float32
    rstate = {"m": jax.tree.map(lambda a: a.astype(sdt), m),
              "v": jax.tree.map(lambda a: a.astype(sdt), v),
              "step": np.int32(5)}
    if ocfg.use_master:
        rstate["master"] = jax.tree.map(lambda p: p.astype(np.float32) + 1e-3, params)
    want_p, want_s, want_stats = jax.jit(functools.partial(radamw.update, cfg=rocfg))(
        params, grads, rstate)

    cfg = _port_cfg(rcfg)
    model = params_from_jax(cfg, params, device="cpu")
    tgrads = tlm.tree_map(lambda a: torch.from_numpy(np.asarray(a).view(np.int16)).view(
        torch.bfloat16) if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)), grads)
    tstate = opt_state_from_jax(rstate, device="cpu")
    p, s, stats = adamw.update(model.tree(), tgrads, tstate, ocfg)
    assert p is not None and s is tstate
    assert float(stats["grad_norm"]) == float(want_stats["grad_norm"])
    np.testing.assert_allclose(float(stats["lr"]), float(want_stats["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == 6 and tstate["step"].dtype == torch.int32
    pairs = [(model.tree(), want_p, "params"), (tstate["m"], want_s["m"], "m"),
             (tstate["v"], want_s["v"], "v")]
    if ocfg.use_master:
        pairs.append((tstate["master"], want_s["master"], "master"))
    for got, want, what in pairs:
        got, want = _flat(got), _flat(want)
        for k in want:
            w = np.asarray(want[k])
            assert str(got[k].dtype) == f"torch.{w.dtype.name}", (what, k)
            w = w.astype(np.float32)
            np.testing.assert_allclose(_np(got[k]), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{what} {k}")


def test_state_specs_and_init_state():
    cfg = _port_cfg(SUBSTRATE)
    model = tlm.init_params(cfg, seed=0, device="cpu")
    for ocfg in (OptConfig(), OptConfig(state_dtype="bfloat16", use_master=True)):
        state = adamw.init_state(model.tree(), ocfg)
        specs = adamw.state_specs(model.tree(), ocfg)
        shape_specs = adamw.state_specs(
            tlm.tree_map(lambda s: (s, torch.bfloat16), tlm.param_shapes(cfg)), ocfg)
        assert specs == shape_specs
        flat_s, flat_t = _flat(specs), _flat(state)
        assert sorted(flat_s) == sorted(flat_t)
        for k, (shape, dt) in flat_s.items():
            assert tuple(flat_t[k].shape) == shape and flat_t[k].dtype == dt, k
        rspecs = radamw.state_specs(
            rlm.param_specs(SUBSTRATE), ROptConfig(**dataclasses.asdict(ocfg)))
        for k, s in _flat(jax.tree.map(lambda x: (x.shape, x.dtype.name), rspecs,
                                       is_leaf=lambda x: hasattr(x, "shape"))).items():
            assert flat_s[k][0] == tuple(s[0]) and str(flat_s[k][1]) == f"torch.{s[1]}", k
        if ocfg.use_master:
            for k, t in _flat(state["master"]).items():
                assert t.dtype == torch.float32 and torch.equal(
                    t, _flat(model.tree())[k].float()), k


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    rcfg = rget_reduced("qwen3-0.6b").replace(**F32)
    cfg = _port_cfg(rcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    params = _jax_params(rcfg, 5)
    rstate = {"params": params, "opt": radamw.init_state(params, ROptConfig(**kw))}
    rstep = jax.jit(rsteps.make_train_step(rcfg, ROptConfig(**kw), n_micro=n_micro))
    model = params_from_jax(cfg, params, device="cpu")
    ocfg = OptConfig(**kw)
    tstate = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    tstep = tsteps.make_train_step(cfg, ocfg, n_micro=n_micro)
    for i in range(3):
        toks, labels = _tokens(cfg, 4, 8, 20 + i)
        rstate, rloss = rstep(rstate, _jbatch(toks, labels))
        tstate, tloss = tstep(tstate, _tbatch(toks, labels))
        assert tloss.dtype == torch.float32 and tloss.shape == ()
        np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5, err_msg=str(i))
    assert tstate["params"] is not None and int(tstate["opt"]["step"]) == 3
    want = _flat(jax.tree.map(np.asarray, rstate))
    got = _flat(tstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        atol = 1e-2 * kw["lr"] if k.startswith("params") else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5, atol=atol, err_msg=k)
    # the module's own parameters moved with the state
    assert torch.equal(model.embed, tstate["params"]["embed"])


def test_adamw_decreases_loss():
    """tests/test_substrate.py::test_adamw_decreases_loss on the port."""
    cfg = _port_cfg(SUBSTRATE)
    ocfg = OptConfig(lr=5e-3, warmup_steps=1, total_steps=100, weight_decay=0.0)
    model = tlm.init_params(cfg, seed=0, device="cpu")
    state = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)).astype(np.int32))
    step = tsteps.make_train_step(cfg, ocfg)
    losses = []
    for _ in range(20):
        state, loss = step(state, {"tokens": toks, "labels": toks})
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses[::5]


def test_step_helpers():
    from repro.configs import ShapeSpec as RShapeSpec
    from repro_torch.configs import ShapeSpec, get_config, get_reduced
    shape = ShapeSpec("t", "train", 16, 8)
    for arch in ("qwen3-0.6b", "yi-34b", "olmo-1b"):
        assert tsteps.micro_batches(get_config(arch), shape) == \
            rsteps.micro_batches(get_config(arch), RShapeSpec("t", "train", 16, 8))
    assert tsteps.DEFAULT_MICRO == rsteps.DEFAULT_MICRO
    cfg = get_reduced("qwen3-0.6b")
    for kind in ("train", "prefill", "decode"):
        got = tsteps.input_specs(cfg, ShapeSpec("t", kind, 16, 8))
        want = rsteps.input_specs(rget_reduced("qwen3-0.6b"), RShapeSpec("t", kind, 16, 8))
        assert {k: (s, str(d)) for k, (s, d) in got.items()} == \
            {k: (v.shape, f"torch.{v.dtype.name}") for k, v in want.items()}
    # on a mesh, halved until a micro-batch covers the data axes, as the
    # reference's (every arch and mesh: tests/test_torch_sharding.py)
    from jax.sharding import AbstractMesh
    from repro_torch.launch.mesh import Mesh
    for arch in ("qwen3-0.6b", "yi-34b", "kimi-k2-1t-a32b"):
        for sizes in ((16, 16), (8, 1), (2, 1)):
            assert tsteps.micro_batches(
                get_config(arch), shape, Mesh(dict(zip(("data", "model"), sizes)))) \
                == rsteps.micro_batches(get_config(arch), RShapeSpec("t", "train", 16, 8),
                                        AbstractMesh(sizes, ("data", "model")))
    # every family of the configs is ported (tests/test_torch_vlm.py,
    # tests/test_torch_whisper.py); a family the port does not know raises
    for arch in ("qwen2-vl-2b", "whisper-base"):
        assert callable(tsteps.make_train_step(get_reduced(arch), OptConfig()))
        assert "labels" in tsteps.input_specs(get_reduced(arch), shape)
    unknown = cfg.replace(family="retnet")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.make_train_step(unknown, OptConfig())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.input_specs(unknown, shape)


def test_tree_views_and_copy_into():
    """tree() is the module's own tensors; the blocks view them; copy_into
    writes into them in place and keeps leaves it is not given."""
    cfg = _port_cfg(rget_reduced("qwen3-0.6b"))
    model = tlm.init_params(cfg, seed=0, device="cpu")
    tree = model.tree()
    assert {id(p) for p in model.parameters()} == {id(t) for _, t in tlm.leaves(tree)}
    wq = tree["layers"]["attn"]["wq"]
    assert model.blocks[1].attn["wq"].data_ptr() == wq[1].data_ptr()
    other = tlm.init_params(cfg, seed=1, device="cpu").tree()
    keep = tree["final_ln"].clone()
    del other["final_ln"]
    tckpt.copy_into(model.tree(), other)
    assert model.tree()["layers"]["attn"]["wq"] is wq
    assert torch.equal(wq, other["layers"]["attn"]["wq"])
    assert torch.equal(model.final_ln, keep)
    with pytest.raises(ValueError, match="shape"):
        tckpt.copy_into(model.tree(), {"embed": torch.zeros(3, 3)})


def test_opt_state_carry_over_is_bit_exact():
    rcfg = SUBSTRATE
    params = _jax_params(rcfg, 2)
    rocfg = ROptConfig(state_dtype="bfloat16", use_master=True)
    rstate = jax.tree.map(np.asarray, radamw.init_state(params, rocfg))
    rng = np.random.default_rng(0)
    rstate["m"] = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(ml_dtypes.bfloat16), rstate["m"])
    rstate["step"] = np.int32(17)
    tstate = opt_state_from_jax(rstate, device="cpu")
    back = to_numpy(tstate)
    for k, w in _flat(rstate).items():
        assert np.array_equal(_bits(_flat(back)[k]), _bits(w)), k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _state(cfg, ocfg, seed=0):
    model = tlm.init_params(cfg, seed=seed, device="cpu")
    return {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}


def test_checkpoint_roundtrip():
    cfg = _port_cfg(SUBSTRATE)
    state = _state(cfg, OptConfig(use_master=True))
    state["opt"]["step"].fill_(3)
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 3, state, {"note": "x"})
        assert tckpt.latest_step(d) == 3
        zeros = tlm.tree_map(torch.zeros_like, state)
        restored, step, meta = tckpt.restore(d, zeros)
        assert step == 3 and meta["note"] == "x"
        for k, t in _flat(state).items():
            r = _flat(restored)[k]
            assert r.dtype == t.dtype and torch.equal(r.view(-1).view(torch.uint8)
                                                      if r.dtype == torch.bfloat16 else r,
                                                      t.view(-1).view(torch.uint8)
                                                      if t.dtype == torch.bfloat16 else t), k
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            import json
            man = json.load(f)
        assert man["leaves"]["params__embed"]["dtype"] == "bfloat16"
        assert np.load(os.path.join(d, "step_00000003", "params__embed.npy")).dtype == np.uint16
        with pytest.raises(FileNotFoundError):
            tckpt.restore(os.path.join(d, "none"), zeros)


def test_checkpoint_atomic_and_gc():
    with tempfile.TemporaryDirectory() as d:
        for s in range(1, 6):
            tckpt.save(d, s, {"x": torch.full((4,), s)})
        steps = sorted(int(p.split("_")[1]) for p in os.listdir(d))
        assert len(steps) == 3 and steps[-1] == 5  # keeps 3 by default
        assert not any(p.endswith(".tmp") for p in os.listdir(d))
        # a stale .tmp from a crashed save is neither listed nor restored
        os.makedirs(os.path.join(d, "step_00000009.tmp"))
        assert tckpt.latest_step(d) == 5


def test_async_saver():
    with tempfile.TemporaryDirectory() as d:
        saver = tckpt.AsyncSaver(d)
        saver.save(7, {"x": torch.arange(8)})
        saver.wait()
        assert tckpt.latest_step(d) == 7
        rec = saver.records[0]
        assert rec["step"] == 7 and rec["bytes"] == 64 and rec["write_s"] >= 0


def test_async_snapshot_survives_in_place_update(monkeypatch):
    """save() returns with a copy of every leaf: an in-place update made
    right after it (as the optimizer makes) does not reach the file, even
    when the write starts only after the update."""
    gate = threading.Event()
    write = tckpt.ckpt.save

    def gated(*a, **k):
        assert gate.wait(10)
        return write(*a, **k)

    monkeypatch.setattr(tckpt.ckpt, "save", gated)
    with tempfile.TemporaryDirectory() as d:
        x = torch.arange(16, dtype=torch.float32)
        b = torch.ones(4, dtype=torch.bfloat16)
        arr = np.arange(3)
        saver = tckpt.AsyncSaver(d)
        saver.save(1, {"x": x, "b": b, "n": arr})
        x.add_(100)
        b.mul_(3)
        arr += 5
        gate.set()
        saver.wait()
        got, _, _ = tckpt.restore(d, {"x": x, "b": b, "n": arr})
        assert torch.equal(got["x"], torch.arange(16, dtype=torch.float32))
        assert torch.equal(got["b"], torch.ones(4, dtype=torch.bfloat16))
        assert torch.equal(got["n"], torch.arange(3))


def _ref_state(seed=0):
    """A reference train state (bf16 params, a mid-run f32 state with a
    master copy) as numpy, and the port's copy of it."""
    rocfg = ROptConfig(use_master=True)
    params = _jax_params(SUBSTRATE, seed)
    rstate = jax.tree.map(np.asarray, radamw.init_state(params, rocfg))
    rng = np.random.default_rng(seed)
    rstate["m"] = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                               rstate["m"])
    rstate["step"] = np.int32(9)
    ref = {"params": params, "opt": rstate}
    port = {"params": params_from_jax(_port_cfg(SUBSTRATE), params, "cpu").tree(),
            "opt": opt_state_from_jax(rstate, "cpu")}
    return ref, port


def test_reference_checkpoint_restores_in_port():
    ref, port = _ref_state(1)
    with tempfile.TemporaryDirectory() as d:
        rckpt.save(d, 9, ref, {"arch": "t"})
        template = tlm.tree_map(torch.zeros_like, port)
        got, step, meta = tckpt.restore(d, template)
        assert step == 9 and meta == {"arch": "t"}
        flat = _flat(got)
        for k, w in _flat(ref).items():
            assert str(flat[k].dtype) == f"torch.{np.asarray(w).dtype.name}", k
            assert np.array_equal(_bits(flat[k]), _bits(w)), k


def test_port_checkpoint_restores_in_reference():
    ref, port = _ref_state(2)
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 9, port, {"arch": "t"})
        template = jax.tree.map(jnp.zeros_like, ref)
        got, step, meta = rckpt.restore(d, template)
        assert step == 9 and meta == {"arch": "t"}
        flat = _flat(jax.tree.map(np.asarray, got))
        for k, w in _flat(ref).items():
            assert flat[k].dtype == np.asarray(w).dtype, k
            assert np.array_equal(_bits(flat[k]), _bits(w)), k


def test_reference_numpy_tree_saves_in_port_format():
    """The port saves the reference's own numpy trees (bf16 leaves as
    ml_dtypes arrays) in the shared format."""
    ref, _ = _ref_state(3)
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 2, ref)
        got, _, _ = rckpt.restore(d, jax.tree.map(jnp.zeros_like, ref))
        for k, w in _flat(ref).items():
            g = np.asarray(_flat(got)[k])
            assert g.dtype == np.asarray(w).dtype and np.array_equal(_bits(g), _bits(w)), k


def test_partial_restore_keeps_template_leaves():
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 1, {"a": torch.arange(4), "b": {"c": torch.ones(2)}})
        tmpl = {"a": torch.zeros(4, dtype=torch.int64), "b": {"c": torch.zeros(2)},
                "new": torch.full((3,), 7.0)}
        got, _, _ = tckpt.restore(d, tmpl)
        assert torch.equal(got["a"], torch.arange(4)) and torch.equal(got["b"]["c"], torch.ones(2))
        assert got["new"] is tmpl["new"]
        tckpt.copy_into(tmpl, got)
        assert torch.equal(tmpl["a"], torch.arange(4))


def test_keep_is_honoured_reference_keeps_three():
    """The reference's AsyncSaver(keep=5) keeps 3 (``save`` calls ``_gc``
    with its default: ROADMAP.md §3); the port's keeps 5, and FTConfig.keep
    reaches the driver's saver."""
    for saver_cls, want in ((rckpt.AsyncSaver, 3), (tckpt.AsyncSaver, 5)):
        with tempfile.TemporaryDirectory() as d:
            saver = saver_cls(d, keep=5)
            for s in range(1, 8):
                saver.save(s, {"x": np.full((2,), s)})
            saver.wait()
            assert len(os.listdir(d)) == want, saver_cls
            assert tckpt.latest_step(d) == 7
    drv = tft.TrainDriver(tft.FTConfig(ckpt_dir="unused", keep=5), {}, None)
    assert drv.saver.keep == 5


# ---------------------------------------------------------------------------
# the fault-tolerance driver and the retry hook
# ---------------------------------------------------------------------------

def test_driver_preemption_checkpoint():
    state = {"x": torch.zeros(3)}

    def step_fn(state, batch):
        state["x"].add_(1)
        return state, torch.tensor(1.0)

    before = signal.getsignal(signal.SIGTERM)
    with tempfile.TemporaryDirectory() as d:
        drv = tft.TrainDriver(tft.FTConfig(ckpt_dir=d, ckpt_every=100), state, step_fn)

        def batches():
            n = 0
            while True:
                if n == 3:
                    os.kill(os.getpid(), signal.SIGTERM)  # simulated preemption
                n += 1
                yield {}

        res = drv.run(batches(), num_steps=100, log_fn=lambda *a: None)
        assert res["steps"] <= 5               # stopped early
        assert tckpt.latest_step(d) == res["steps"]  # final checkpoint written
        got, _, _ = tckpt.restore(d, {"x": torch.zeros(3)})
        assert torch.equal(got["x"], torch.full((3,), float(res["steps"])))
        # a fresh driver resumes in place
        live = {"x": torch.zeros(3)}
        drv2 = tft.TrainDriver(tft.FTConfig(ckpt_dir=d), live, step_fn)
        x = live["x"]
        assert drv2.maybe_resume() and drv2.step == res["steps"]
        assert live["x"] is x and torch.equal(x, got["x"])
    assert signal.getsignal(signal.SIGTERM) == before


def test_driver_restores_handlers_after_a_failing_step():
    before = signal.getsignal(signal.SIGINT)

    def boom(state, batch):
        raise RuntimeError("step failed")

    with tempfile.TemporaryDirectory() as d:
        drv = tft.TrainDriver(tft.FTConfig(ckpt_dir=d), {}, boom)
        with pytest.raises(RuntimeError, match="step failed"):
            drv.run(iter([{}]), num_steps=2)
        assert not drv.maybe_resume()
    assert signal.getsignal(signal.SIGINT) == before


def test_straggler_detection():
    for stats_cls in (tft.StepStats, rft.StepStats):
        st = stats_cls()
        flags = [st.record(0.1, 3.0) for _ in range(10)]
        assert not any(flags)
        assert st.record(1.0, 3.0)  # 10x the EMA
        assert st.stragglers == 1
    mine, ref = tft.StepStats(), rft.StepStats()
    for dt in (0.2, 0.1, 0.9, 0.1, 0.5, 2.0, 0.1):
        assert mine.record(dt, 2.5) == ref.record(dt, 2.5)
    assert (mine.ema, mine.stragglers) == (ref.ema, ref.stragglers)


class _T:
    def __init__(self, overflow):
        self.overflow = overflow


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_overflow_retry(pkg):
    run = tft.run_with_overflow_retry if pkg == "port" else rft.run_with_overflow_retry
    calls = []

    def build(slack):
        calls.append(slack)
        return _T(overflow=len(calls) < 3)

    t, attempts = run(build, base_slack=2.0)
    assert attempts == 2 and calls == [2.0, 4.0, 8.0] and not t.overflow
    with pytest.raises(RuntimeError, match="last slack attempted 4.0"):
        run(lambda s: _T(True), max_retries=1)


def test_run_slack_raises_the_ports_capacity_overflow():
    seen = []
    with pytest.raises(terr.CapacityOverflow) as e:
        RetryPolicy(max_retries=2).run_slack(lambda s: seen.append(s) or _T(True), 1.5)
    assert seen == [1.5, 3.0, 6.0] and e.value.attempts == 3
    t, attempts = RetryPolicy(max_retries=0).run_slack(lambda s: _T(False))
    assert attempts == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_train_main_trains_checkpoints_and_resumes(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                "--batch", "2", "--seq", "16", "--ckpt-dir", d]
        res = ttrain.main(args + ["--steps", "3"])
        assert res["steps"] == 3 and len(res["losses"]) == 3
        assert all(np.isfinite(res["losses"]))
        assert tckpt.latest_step(d) == 3 and res["resumed_at"] is None
        saved, _, meta = tckpt.restore(d, res["driver"].state)
        assert meta == {"arch": "qwen3-0.6b"}
        res2 = ttrain.main(args + ["--steps", "5", "--resume"])
        assert res2["resumed_at"] == 3 and res2["steps"] == 5
        assert len(res2["losses"]) == 2 and tckpt.latest_step(d) == 5
        # the resumed run started from the saved state: its optimizer
        # took two more steps
        assert int(res2["driver"].state["opt"]["step"]) == 5
        assert int(saved["opt"]["step"]) == 3
    out = capsys.readouterr().out
    assert "resumed at step 3" in out and "done: 5 steps" in out


def test_train_rejects_what_is_not_ported():
    """A model axis the world does not hold raises ``make_local_mesh``'s
    ValueError, the production mesh ``make_production_mesh``'s error; the
    ssm family on a model axis names ROADMAP.md item 11.7c (the dense and
    moe families train there: tests/test_torch_sharding.py's spawn)."""
    base = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu"]
    with pytest.raises(ValueError, match="model axis of 2 does not divide 1"):
        ttrain.main(base + ["--model-axis", "2"])
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        ttrain.main(base + ["--production-mesh"])
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*11\.7c"):
        ttrain.main(["--arch", "falcon-mamba-7b", "--reduced", "--device", "cpu",
                     "--model-axis", "2"])
    # the vlm family trains (tests/test_torch_vlm.py); the encdec family
    # exits as the reference's launcher does
    with pytest.raises(SystemExit, match="whisper-specific driver"):
        ttrain.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from repro_torch.data.synth import token_corpus
    cfg = _port_cfg(rget_reduced("qwen3-0.6b"))
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.run(cfg, OptConfig(), token_corpus(50, cfg.vocab), steps=1,
                       batch=1, seq=4, ckpt_dir=d)
