"""The port's moe family (repro_torch.models.moe, the moe branches of
models/lm.py, launch/steps.py and launch/train.py) against the reference
package's, on the CPU.

Weights are the reference's ``init_params`` carried over bit for bit with
``params_from_jax``, or numpy draws; tokens come from numpy.  The port
ranks a row within its expert with the registry's ``bucket_scatter``
(its plain version here), the reference with a one-hot ``cumsum``: the
integers must be equal.  Tolerances:

- integers (capacities, slots, counts, top-k indices): exact;
- float32 MoE block: atol 1e-5 (the same float32 operations, summed in
  another order by another library);
- bfloat16 MoE block, given the reference's top-k: 4 bf16 ulps of the
  output's largest magnitude (products and sums rounded to bf16 at other
  points).  A whole bf16 model is not held: a router logit rounded one way
  or the other changes which experts a token reaches;
- float32 models: atol 1e-4 on logits and caches; the loss rtol 1e-5;
  gradients every leaf within 1e-4 x its largest |g| of ``jax.grad``'s;
  a train step as tests/test_torch_train.py's (parameters within 1 % of
  one step's size);
- checkpoints and remat against no remat: bitwise.
"""
import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.kernels.hash_partition import hash_partition as thp  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_jax, params_from_jax, to_numpy)
from repro_torch.optim import OptConfig, adamw  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")


def _port_cfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_params(rcfg, seed):
    return jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(seed)))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def _reference_ranks(flat_e, E):
    """The reference's within-expert rank (models/moe.py:83-85)."""
    onehot = jax.nn.one_hot(jnp.asarray(flat_e), E, dtype=jnp.int32)
    return np.asarray(jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1))


# ---------------------------------------------------------------------------
# capacity, ranks, top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_reference(arch):
    for E in (8, 64, 384):
        for k in (1, 2, 6, 8):
            for cf in (0.25, 1.0, 1.25, E / k):
                rcfg = rget_reduced(arch).replace(n_experts=E, top_k=k,
                                                  capacity_factor=cf)
                cfg = _port_cfg(rcfg)
                for T in (1, 7, 12, 96, 2048, 24576, 196608):
                    assert tmoe.expert_capacity(cfg, T) == \
                        rmoe.expert_capacity(rcfg, T), (E, k, cf, T)


@pytest.mark.parametrize("E", [8, 64, 384])
@pytest.mark.parametrize("case", ["uniform", "skewed", "one_expert"])
def test_plain_bucket_scatter_is_the_reference_rank(E, case):
    """The registry's bucket_scatter on flat_e gives the reference's one-hot
    cumsum rank, integer for integer, and the per-expert counts."""
    rng = np.random.default_rng(E)
    n = 6 * 517
    if case == "uniform":
        flat_e = rng.integers(0, E, n)
    elif case == "skewed":
        flat_e = np.minimum(rng.zipf(1.5, n) - 1, E - 1)
    else:
        flat_e = np.full(n, E - 1)
    flat_e = flat_e.astype(np.int32)
    slot, counts = treg.resolve("cpu").bucket_scatter(_t(flat_e), E)
    np.testing.assert_array_equal(slot.numpy(), _reference_ranks(flat_e, E))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(flat_e, minlength=E))


def test_top_k_ties_match_lax_top_k():
    """Rows full of exact ties: the port's top_k takes the lower index first
    among equals, as lax.top_k does; torch.topk promises no order."""
    rng = np.random.default_rng(0)
    for E, k in ((8, 2), (64, 6), (384, 8)):
        probs = (rng.integers(0, 4, (300, E)) / 8).astype(np.float32)
        probs[0] = 0.25                                 # one row all equal
        want_w, want_i = lax.top_k(jnp.asarray(probs), k)
        got_w, got_i = tmoe.top_k(_t(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

def _moe_case(rcfg, seed, b=2, s=9, dtype=np.float32):
    """The block's parameters (the reference's init rule, numpy draws) and
    an input, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = rmoe.moe_param_shapes(rcfg)

    def draw(shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(dtype)
    p = jax.tree.map(draw, shapes, is_leaf=lambda x: isinstance(x, tuple))
    x = rng.normal(size=(b, s, rcfg.d_model)).astype(dtype)
    return p, x


MOE_VARIANTS = ("published", "dropping", "no_shared")


def _variant(arch, variant, **kw):
    rcfg = rget_reduced(arch).replace(**kw)
    if variant == "dropping":
        rcfg = rcfg.replace(capacity_factor=0.25)
    elif variant == "no_shared":
        rcfg = rcfg.replace(n_shared_experts=0)
    return rcfg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", MOE_VARIANTS)
def test_moe_block_matches_reference(arch, variant):
    rcfg = _variant(arch, variant, **F32)
    cfg = _port_cfg(rcfg)
    p, x = _moe_case(rcfg, 1, b=3, s=16)
    want, want_aux = jax.jit(functools.partial(rmoe._moe_block_gspmd, cfg=rcfg))(p, x)
    tp = tlm.tree_map(_t, p)
    got, aux = tmoe.moe_block(tp, _t(x), cfg)
    _close(got, want, 1e-5, "out")
    _close(aux, want_aux, 1e-5, "aux")
    r = tmoe.route(tp, _t(x).reshape(-1, cfg.d_model), cfg)
    dropped = int(torch.clamp(r.counts - r.C, min=0).sum())
    if variant == "dropping":
        assert dropped > 0, (dropped, r.C)
    assert ("shared" in p) == (variant != "no_shared")


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16_dispatch_given_reference_top_k(arch, monkeypatch):
    """bfloat16: the reference's top-k (its router logits rounded by its own
    products) fed to the port's dispatch, experts and combine."""
    rcfg = rget_reduced(arch).replace(capacity_factor=0.5)
    cfg = _port_cfg(rcfg)
    p, x = _moe_case(rcfg, 2, b=3, s=16)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jp, jx = jax.tree.map(bf, p), bf(x)
    want, _ = jax.jit(functools.partial(rmoe._moe_block_gspmd, cfg=rcfg))(jp, jx)
    xt = jx.reshape(-1, rcfg.d_model)
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), axis=-1)
    ref_w, ref_i = lax.top_k(probs, rcfg.top_k)
    monkeypatch.setattr(tmoe, "top_k", lambda probs, k: (
        _t(np.asarray(ref_w)), _t(np.asarray(ref_i)).long()))

    def to_bf16(a):
        return _t(np.asarray(a, np.float32)).to(torch.bfloat16)
    got, _ = tmoe.moe_block(tlm.tree_map(to_bf16, p), to_bf16(x), cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    _close(got, want, 4 * 2.0**-8 * float(np.abs(want).max()))


def test_moe_routes_through_the_registry(monkeypatch):
    """Every MoE block's call asks the registry's bucket_scatter for its
    slots once, at P = E on the T·k int32 rows: in the prefill and in each
    decode step, once a MoE layer."""
    kernels = treg.resolve("cpu")
    calls = []
    plain = kernels.bucket_scatter

    def counted(dest, P):
        assert dest.dtype == torch.int32 and dest.is_contiguous() and dest.dim() == 1
        calls.append((dest.numel(), P))
        return plain(dest, P)

    monkeypatch.setitem(kernels._fns, "bucket_scatter", counted)
    cfg = _port_cfg(rget_reduced("deepseek-moe-16b"))
    model = tlm.init_params(cfg, seed=0, device="cpu")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    logits, caches = tsteps.make_prefill_step(cfg, 8)(
        model, {"tokens": torch.zeros((2, 5), dtype=torch.int32)})
    assert calls == [(2 * 5 * cfg.top_k, cfg.n_experts)] * n_moe
    calls.clear()
    tsteps.make_decode_step(cfg)(model, torch.ones((2, 1), dtype=torch.int32), caches)
    assert calls == [(2 * cfg.top_k, cfg.n_experts)] * n_moe


def test_moe_raises_where_not_ported():
    """Expert parallelism serves and trains (tests/test_torch_model_axis.py,
    tests/test_torch_sharding.py's spawn; without a model axis "ep" is the
    gspmd block, as the reference's without an EP mesh, and the launcher's
    ``--moe-impl ep`` trains there); more than 2048 buckets raise a
    ValueError, at P = E and at P = E/M + 1."""
    from repro_torch.launch.mesh import Mesh
    rcfg = rget_reduced("deepseek-moe-16b")
    p, x = _moe_case(rcfg, 3)
    tp = tlm.tree_map(_t, p)
    ep, _ = tmoe.moe_block(tp, _t(x), _port_cfg(rcfg).replace(moe_impl="ep"))
    assert torch.equal(ep, tmoe.moe_block(tp, _t(x), _port_cfg(rcfg))[0])
    big = _port_cfg(rcfg).replace(n_experts=thp.MAX_P + 1)
    tp["router"] = torch.zeros((rcfg.d_model, thp.MAX_P + 1))
    with pytest.raises(ValueError, match=str(thp.MAX_P)):
        tmoe.moe_block(tp, _t(x), big)
    tp["router"] = torch.zeros((rcfg.d_model, thp.MAX_P))
    with pytest.raises(ValueError, match=str(thp.MAX_P)):
        tmoe.moe_block(tp, _t(x), big.replace(moe_impl="ep", n_experts=thp.MAX_P),
                       mesh=Mesh({"data": 1, "model": 1}))
    with tempfile.TemporaryDirectory() as d:
        res = ttrain.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                           "--moe-impl", "ep", "--steps", "1", "--batch", "2",
                           "--seq", "8", "--ckpt-dir", d])
    assert res["steps"] == 1 and np.isfinite(res["losses"][0])
    assert callable(tsteps.make_train_step(_port_cfg(rcfg).replace(moe_impl="ep"),
                                           OptConfig(),
                                           mesh=Mesh({"data": 1, "model": 2})))


# ---------------------------------------------------------------------------
# weights, models, caches
# ---------------------------------------------------------------------------

def test_param_shapes_are_the_references():
    for arch in ARCHS:
        for rcfg in (rget_reduced(arch), rget_reduced(arch).replace(
                first_dense_layers=0, n_shared_experts=0)):
            want = _flat(rlm.param_shapes(rcfg))
            got = _flat(tlm.param_shapes(_port_cfg(rcfg)))
            assert got == want, arch
            assert set(tlm.stacks(_port_cfg(rcfg))) == {
                k for k in rlm.param_shapes(rcfg) if "layers" in k}


def test_opt_state_carry_over_is_bit_exact():
    """The reference's moe AdamW state (bf16 moments, float32 master) comes
    into the port and back out with the same bits."""
    import ml_dtypes
    rcfg = rget_reduced("deepseek-moe-16b")
    params = _jax_params(rcfg, 2)
    rstate = jax.tree.map(np.asarray, radamw.init_state(
        params, ROptConfig(state_dtype="bfloat16", use_master=True)))
    rng = np.random.default_rng(0)
    rstate["m"] = jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(ml_dtypes.bfloat16), rstate["m"])
    rstate["step"] = np.int32(9)
    back = _flat(to_numpy(opt_state_from_jax(rstate, device="cpu")))
    for k, w in _flat(rstate).items():
        w = np.asarray(w)
        w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w
        assert np.array_equal(back[k], w), k


B, S, STEPS = 2, 6, 3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_forward_match_reference(arch):
    rcfg = rget_reduced(arch).replace(**F32)
    cfg = _port_cfg(rcfg)
    params = _jax_params(rcfg, 7)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32) for _ in range(STEPS)]

    prefill = jax.jit(rsteps.make_prefill_step(rcfg, S + STEPS))
    decode = jax.jit(rsteps.make_decode_step(rcfg))
    logits, caches = prefill(params, {"tokens": jnp.asarray(tokens)})
    want, want_caches = [logits], [caches]
    for t in steps:
        logits, caches = decode(params, jnp.asarray(t), caches)
        want.append(logits)
        want_caches.append(caches)
    want_full, _, want_aux = jax.jit(functools.partial(rlm.forward, cfg=rcfg))(
        params, jnp.asarray(tokens))

    model = params_from_jax(cfg, params, device="cpu")
    logits, caches = tsteps.make_prefill_step(cfg, S + STEPS)(model, {"tokens": _t(tokens)})
    snap = lambda c: {k: {n: v.clone() for n, v in c[k].items()}  # noqa: E731
                      for k in tlm.stacks(cfg)}
    got, got_caches = [logits], [snap(caches)]
    for t in steps:
        logits, caches = tsteps.make_decode_step(cfg)(model, _t(t), caches)
        got.append(logits)
        got_caches.append(snap(caches))
    got_full, _, got_aux = tlm.forward(model, _t(tokens), cfg)

    _close(got_full, want_full, 1e-4, "full forward")
    _close(got_aux, want_aux, 1e-5, "aux")
    _close(torch.stack(got, 1), np.stack([np.asarray(w) for w in want], 1), 1e-4,
           "prefill + decode logits")
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        assert sorted(g) == sorted(w), i
        for name in g:
            np.testing.assert_array_equal(g[name]["index"].numpy(),
                                          np.asarray(w[name]["index"]))
            _close(g[name]["k"], w[name]["k"], 1e-4, f"{name} k after step {i}")
            _close(g[name]["v"], w[name]["v"], 1e-4, f"{name} v after step {i}")
    assert caches["host_index"] == S + STEPS


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))


def _port_grads(cfg, tree, toks, labels):
    loss, grads = tsteps.value_and_grad(
        tsteps.make_loss_fn(cfg), tree,
        {"tokens": _t(toks), "labels": _t(labels)})
    return float(loss), {"/".join(p): g for p, g in tlm.leaves(grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """loss = cross entropy + 0.01 aux, and its gradient leaf by leaf (the
    router's reaches it through the top-k weights and mean(probs))."""
    rcfg = rget_reduced(arch).replace(**F32)
    cfg = _port_cfg(rcfg)
    params = _jax_params(rcfg, 1)
    toks, labels = _tokens(cfg, 2, 10, 2)
    labels[1, :3] = -1
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, batch, rcfg)))(params)
    model = params_from_jax(cfg, params, device="cpu")
    loss, got = _port_grads(cfg, model.tree(), toks, labels)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    assert float(np.abs(want["layers/moe/router"]).max()) > 0


def test_remat_leaves_moe_gradients_unchanged():
    """Recomputing each block, its routing included, in the backward pass
    gives the same bits as keeping its activations."""
    cfg = _port_cfg(rget_reduced("deepseek-moe-16b").replace(
        capacity_factor=0.5, **F32))
    toks, labels = _tokens(cfg, 2, 12, 5)
    out = []
    for remat in ("block", "none"):
        c = cfg.replace(remat=remat)
        model = tlm.init_params(c, seed=2, device="cpu")
        out.append(_port_grads(c, model.tree(), toks, labels))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_reference(n_micro):
    rcfg = rget_reduced("deepseek-moe-16b").replace(**F32)
    cfg = _port_cfg(rcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    params = _jax_params(rcfg, 5)
    rstate = {"params": params, "opt": radamw.init_state(params, ROptConfig(**kw))}
    rstep = jax.jit(rsteps.make_train_step(rcfg, ROptConfig(**kw), n_micro=n_micro))
    model = params_from_jax(cfg, params, device="cpu")
    ocfg = OptConfig(**kw)
    tstate = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    tstep = tsteps.make_train_step(cfg, ocfg, n_micro=n_micro)
    toks, labels = _tokens(cfg, 4, 8, 20)
    rstate, rloss = rstep(rstate, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)})
    tstate, tloss = tstep(tstate, {"tokens": _t(toks), "labels": _t(labels)})
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want = _flat(jax.tree.map(np.asarray, rstate))
    got = _flat(tstate)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        atol = 1e-2 * kw["lr"] if k.startswith("params") else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(_np(got[k]), w, rtol=1e-5, atol=atol, err_msg=k)


def test_moe_checkpoint_roundtrip_bitwise():
    cfg = _port_cfg(rget_reduced("kimi-k2-1t-a32b"))
    ocfg = OptConfig(use_master=True)
    model = tlm.init_params(cfg, seed=0, device="cpu")
    state = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    state["opt"]["step"].fill_(2)
    with tempfile.TemporaryDirectory() as d:
        tckpt.save(d, 2, state, {"arch": cfg.name})
        fresh = tlm.init_params(cfg, seed=1, device="cpu")
        live = {"params": fresh.tree(), "opt": adamw.init_state(fresh.tree(), ocfg)}
        tree, step, meta = tckpt.restore(d, live)
        tckpt.copy_into(live, tree)
    assert step == 2 and meta == {"arch": cfg.name}
    got, want = _flat(live), _flat(state)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        g = got[k]
        assert g.dtype == t.dtype, k
        if t.dtype == torch.bfloat16:
            g, t = g.view(torch.int16), t.view(torch.int16)
        assert torch.equal(g, t), k
    assert torch.equal(fresh.layers.moe.experts["w_gate"].view(torch.int16),
                       model.layers.moe.experts["w_gate"].view(torch.int16))


@pytest.mark.parametrize("impl", [[], ["--moe-impl", "gspmd"]])
def test_train_main_runs_the_moe_family(impl):
    with tempfile.TemporaryDirectory() as d:
        res = ttrain.main(["--arch", "deepseek-moe-16b", "--reduced", "--device",
                           "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
                           "--ckpt-dir", d] + impl)
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    assert int(res["driver"].state["opt"]["step"]) == 2
