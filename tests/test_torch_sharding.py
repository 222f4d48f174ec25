"""The port's sharding rules, ZeRO-1 AdamW, compressed gradient sums and
data-parallel training against the reference package.

The rules run on shape-only meshes on both sides (``jax.sharding.
AbstractMesh``; ``launch.mesh.Mesh``) for all ten architectures at full
size and six meshes.  The rank-side checks run in ONE module-scoped spawn
of two gloo ranks (``tests/torch_dp_ranks.py``, jax-free, started as
``torchrun`` would start them) while the reference side runs here:
``compressed_psum`` against the reference's under ``jax.vmap`` with a
named axis; the data-parallel train step, ZeRO-1 on and off, one and two
micro-batches, for the dense family (a label mask on one rank only), the
moe family (capacity binding) and the vlm family, against the reference's
one-device step on the global batch; the ZeRO-1 blocks against
``zero1_spec``; a checkpoint saved at P = 2 restored at P = 1, at P = 2
and by the reference; the agreed preemption; the token pipeline at P = 2;
the launcher.  Then, on a (data 1, model 2) mesh over the same two ranks,
serving: the prefill and decode steps of the reduced qwen3-0.6b (and a
variant whose vocabulary, MLP, S and heads the rules do not cut whole)
and of the reduced deepseek-moe-16b (expert-parallel and gspmd, capacity
binding) against the reference's one-device steps on the same weights in
float32 (rtol 1e-4, atol 1e-5: the same operations, the row-parallel sums
added in another order), their greedy picks, caches, a prompt prefilled in
two chunks, and a decode step's collectives against the layout.  Then, on
that mesh, training: the reduced qwen3-0.6b tensor-parallel and the
reduced deepseek-moe-16b expert-parallel and with its expert-sharded
gspmd block, remat per block, one and two micro-batches, against the
reference's one-device step on the same global batch (the gradients of
the first batch, both steps' losses, the parameters and the AdamW state,
to the data-parallel cases' tolerances); a checkpoint saved there restored
on the mesh and at one process, bitwise; the launcher with
``--model-axis 2``.  The (data 2, model 2) checks spawn four ranks of
their own (tests/test_torch_tp_train.py).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import tempfile
from collections import OrderedDict

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import checkpoint as rckpt  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro.data.pipeline import PipelineConfig as RPipelineConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.data.synth import token_corpus  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import sharding as rsharding  # noqa: E402
from repro.optim import OptConfig as ROptConfig  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import compression as rcomp  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}
SHAPE_IDS = list(rconfigs.SHAPES)
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _amesh(key):
    return AbstractMesh(*MESHES[key])


def _tmesh(key):
    sizes, names = MESHES[key]
    return tmesh.Mesh(OrderedDict(zip(names, sizes)))


def _tshape(s):
    return tconfigs.ShapeSpec(s.name, s.kind, s.seq, s.batch)


@functools.lru_cache(maxsize=None)
def _ref_param_specs(arch):
    return rsteps.model_param_specs(rconfigs.get_config(arch))


def _ref_flat(tree) -> dict:
    """path -> spec tuple of a reference tree of NamedShardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            tuple(sh.spec) for path, sh in flat}


def _port_flat(result, like) -> dict:
    """path -> spec of a port tree of specs laid out as ``like`` (a tree of
    (shape, dtype) pairs: its leaves say where the specs are)."""
    out = {}

    def get(path, _):
        t = result
        for k in path:
            t = t[int(k)] if isinstance(t, tuple) else t[k]
        out[path] = t
    tsharding.map_with_path(get, like)
    return out


# ---------------------------------------------------------------------------
# the rules, on shape-only meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    cfg = tconfigs.get_config(arch)
    want = _ref_flat(rsharding.param_shardings(
        rconfigs.get_config(arch), _amesh(mesh), _ref_param_specs(arch)))
    pspecs = tsteps.model_param_specs(cfg)
    got = _port_flat(tsharding.param_shardings(cfg, _tmesh(mesh), pspecs), pspecs)
    assert got == want
    # leaf by leaf through param_spec_for, the rule itself
    for path, (shape, _) in _port_flat(pspecs, pspecs).items():
        assert tsharding.param_spec_for(_tmesh(mesh), path, shape) == tuple(
            rsharding.param_spec_for(_amesh(mesh), path, shape)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh):
    rcfg, cfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    am, tm = _amesh(mesh), _tmesh(mesh)
    for sid in SHAPE_IDS:
        shape = rconfigs.SHAPES[sid]
        for kind in ("train", "prefill", "decode"):
            rs = dataclasses.replace(shape, kind=kind)
            ins = rsteps.input_specs(rcfg, rs)
            tins = tsteps.input_specs(cfg, _tshape(rs))
            assert sorted(ins) == sorted(tins)
            want = {k: tuple(v.spec) for k, v in
                    rsharding.batch_shardings(am, ins).items()}
            assert tsharding.batch_shardings(tm, tins) == want, (sid, kind)
        if shape.kind == "decode":
            cs = tsteps.cache_specs(cfg, _tshape(shape))
            got = _port_flat(tsharding.cache_shardings(tm, cs), cs)
            want = _ref_flat(rsharding.cache_shardings(
                am, rsteps.cache_specs(rcfg, shape)))
            assert got == want, sid
            for path, (s, _) in _port_flat(cs, cs).items():
                assert tsharding.cache_spec_for(tm, path, s) == tuple(
                    rsharding.cache_spec_for(am, path, s)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_micro_batches_match_reference(arch, mesh):
    rcfg, cfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    for sid, shape in rconfigs.SHAPES.items():
        assert tsteps.micro_batches(cfg, _tshape(shape), _tmesh(mesh)) == \
            rsteps.micro_batches(rcfg, shape, _amesh(mesh)), sid
        assert tsteps.micro_batches(cfg, _tshape(shape)) == \
            rsteps.micro_batches(rcfg, shape), sid


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x1"])
@pytest.mark.parametrize("shape", SHAPE_IDS)
@pytest.mark.parametrize("arch", rconfigs.ARCH_IDS)
def test_cell_shardings_match_reference(arch, shape, mesh):
    """The same keys and, leaf by leaf, the same specs: parameters (also
    with fsdp), inputs, caches, and the optimizer state's ZeRO-1 layout
    with and without zero1 and master copies."""
    rcfg, cfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    am, tm = _amesh(mesh), _tmesh(mesh)
    rs = rconfigs.SHAPES[shape]
    for kw in ({}, {"zero1": False}, {"use_master": True}):
        for fsdp in (False, True):
            want = rsteps.cell_shardings(rcfg, rs, am, ROptConfig(**kw), fsdp)
            got = tsteps.cell_shardings(cfg, _tshape(rs), tm, OptConfig(**kw), fsdp)
            assert sorted(got) == sorted(want)
            pspecs = got["param_specs"]
            assert _port_flat(got["params"], pspecs) == _ref_flat(want["params"])
            assert got["input_sh"] == {k: tuple(v.spec)
                                       for k, v in want["input_sh"].items()}
            if "cache_sh" in want:
                assert _port_flat(got["cache_sh"], got["cache_specs"]) == \
                    _ref_flat(want["cache_sh"])
            if "opt_sh" in want:
                osp = got["opt_specs"]
                assert sorted(got["opt_sh"]) == sorted(want["opt_sh"])
                for k in want["opt_sh"]:
                    like = osp[k]
                    g = got["opt_sh"][k]
                    if k == "step":
                        assert g == tuple(want["opt_sh"][k].spec) == ()
                        continue
                    assert _port_flat(g, like) == _ref_flat(want["opt_sh"][k]), k


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_axes_and_fit_spec(mesh):
    am, tm = _amesh(mesh), _tmesh(mesh)
    assert tsharding.dp_axes(tm) == rsharding.dp_axes(am)
    dp = rsharding.dp_axes(am)
    for shape in [(256, 4096), (1, 4096), (32, 16, 8), (3, 7), (2,)]:
        for want in [(dp,), ("model", None), (None, "model"), (dp, "model"),
                     (None, dp, "model"), ("data", None, "model")]:
            assert tsharding.fit_spec(tm, shape, want) == tuple(
                rsharding.fit_spec(am, shape, want)), (shape, want)


ZERO1_CASES = [
    ("1x1", P(None, "model"), (8, 16)),
    ("16x16", P(None, None, "model"), (28, 1024, 2048)),
    ("16x16", P("model", None), (151936, 1024)),
    ("16x16", P(), (1024,)),
    ("16x16", P(), (7,)),
    ("16x16", P("data", None), (256, 64)),
    ("2x16x16", P(None, "model"), (64, 32)),
    ("2x16x16", P(("pod", "data")), (512,)),
    ("2x1", P(None, None, "model"), (3, 5, 8)),
    ("8x1", P(None, "model", None), (24, 16, 16)),
]


@pytest.mark.parametrize("case", range(len(ZERO1_CASES)))
def test_zero1_spec_matches_reference(case):
    key, spec, shape = ZERO1_CASES[case]
    sizes, names = MESHES.get(key, ((1, 1), ("data", "model")))
    am = AbstractMesh(sizes, names)
    tm = tmesh.Mesh(OrderedDict(zip(names, sizes)))
    want = radamw.zero1_spec(am, spec, shape)
    assert tadamw.zero1_spec(tm, tuple(spec), shape) == tuple(want)
    if case == 0:        # tests/test_substrate.py::test_zero1_spec
        assert tuple(want) == ("data", "model")


def test_spec_normalises_like_partition_spec():
    """A tuple of one name is the name, as PartitionSpec makes it; trailing
    Nones go, as the reference's rules drop them."""
    for entries in [(), (None,), ("data", None), (("data",),), (("pod", "data"), None),
                    (None, "model", None, None), (None, ["pod", "data"])]:
        want = list(P(*entries))
        while want and want[-1] is None:
            want.pop()
        assert tsharding.spec(*entries) == tuple(want), entries


def test_shape_only_mesh_and_layout():
    m = _tmesh("2x16x16")
    assert m.axis_names == ("pod", "data", "model") and tmesh.mesh_chip_count(m) == 512
    # row-major ranks; the data axes' block index pod_i * data + data_i
    r = tmesh.Mesh(m.shape, rank=(1 * 16 + 3) * 16 + 5)
    assert r.coords == {"pod": 1, "data": 3, "model": 5}
    assert r.index_of(("pod", "data")) == 19 and r.index_of("model") == 5
    t = torch.arange(32 * 4).reshape(32, 4)
    assert torch.equal(tsharding.shard(t, (("pod", "data"),), r), t[19:20])
    assert tsharding.local_shape((32, 4), (("pod", "data"),), r) == (1, 4)
    with pytest.raises(ValueError, match="no live group"):
        tsharding.gather(t[:1], (("pod", "data"),), r)
    # no process group: a world of one
    one = tmesh.make_local_mesh()
    assert dict(one.shape) == {"data": 1, "model": 1} and one.dp.size == 1
    with pytest.raises(RuntimeError, match="256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    assert tmesh.backend_for(2, "cpu") == "gloo"


@pytest.mark.parametrize("seed", range(4))
def test_quantize_matches_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(64, 33)) * 10.0 ** (seed - 2)).astype(np.float32)
    if seed == 3:
        g[:] = 0.0                      # the scale's floor
    rq, rs = rcomp.quantize(jnp.asarray(g))
    tq, ts = tcomp.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    np.testing.assert_array_equal(tcomp.dequantize(tq, ts).numpy(),
                                  np.asarray(rcomp.dequantize(rq, rs)))
    deq = tcomp.dequantize(tq, ts).numpy()
    assert float(np.abs(deq - g).max()) <= float(ts) * 0.51
    assert tcomp.init_error_buffers({"a": torch.zeros(3, 2)})["a"].dtype == torch.float32


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

WORLD = 2
ARCHS = ("qwen3-0.6b", "deepseek-moe-16b", "qwen2-vl-2b")
STEPS = 2
KW = dict(lr=1e-3, warmup_steps=2, total_steps=20)
CASES = [(a, z, n) for a in ARCHS for z in (True, False) for n in (1, 2)]
CKPT_CASE = "qwen3-0.6b-zero1-micro1"
LAUNCHER = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "4", "--seq", "16"]
# the launcher on the model axis: the dense family, and the moe family
# expert-parallel (at model axis 1 "ep" is the gspmd block)
TP_LAUNCHERS = {"dense": LAUNCHER,
                "ep": ["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "4", "--seq", "16", "--moe-impl", "ep"]}


# serving on a (data 1, model WORLD) mesh: name -> (arch, config changes,
# max_seq).  24 rows shard S (12 a rank: the prompt's 9 rows all in rank
# 0's block, the 4th decode step's row the first of rank 1's); 25 rows, a
# vocabulary of 511, an MLP of 255 and 3 query heads over 1 KV head (whole
# heads do not divide the axis) are replicated or gathered by the rules
SERVE = {
    "qwen3-0.6b": ("qwen3-0.6b", {}, 24),
    "qwen3-0.6b-replicated": ("qwen3-0.6b", dict(vocab=511, d_ff=255, n_heads=3,
                                                 n_kv_heads=1), 25),
    "deepseek-moe-16b-ep": ("deepseek-moe-16b", dict(capacity_factor=0.5,
                                                     moe_impl="ep"), 24),
    "deepseek-moe-16b-gspmd": ("deepseek-moe-16b", dict(capacity_factor=0.5), 24),
}
SERVE_PROMPT = (4, 9)
# training on the (data 1, model WORLD) mesh: (arch, moe_impl, n_micro); the
# data-parallel cases' weights, batches and reference runs
TP_CASES = [("qwen3-0.6b", "gspmd", 1), ("qwen3-0.6b", "gspmd", 2),
            ("deepseek-moe-16b", "ep", 1), ("deepseek-moe-16b", "ep", 2),
            ("deepseek-moe-16b", "gspmd", 1), ("deepseek-moe-16b", "gspmd", 2)]
TP_CKPT_CASE = "tp-qwen3-0.6b-gspmd-micro1"
SERVE_STEPS = 4
SERVE_CHUNK = 5


def _serve_rcfg(name):
    arch, changes, _ = SERVE[name]
    return rconfigs.get_reduced(arch).replace(**F32, **changes)


def _ref_serve(rcfg, params, case):
    """The reference's one-device prefill and decode steps on the case's
    prompt and tokens: the logits of each step and the last cache."""
    prefill = jax.jit(rsteps.make_prefill_step(rcfg, case["max_seq"]))
    decode = jax.jit(rsteps.make_decode_step(rcfg))
    p = jax.tree.map(jnp.asarray, params)
    logits, caches = prefill(p, {"tokens": jnp.asarray(case["prompt"])})
    out = [np.asarray(logits)]
    for tok in case["decode_tokens"]:
        logits, caches = decode(p, jnp.asarray(tok)[:, None], caches)
        out.append(np.asarray(logits))
    # the prompt in two chunks (a capacity-bound MoE routes each chunk at
    # its own capacity, so the one-shot prefill is not the yardstick)
    prompt, cut = jnp.asarray(case["prompt"]), case["chunk"]
    chunks = jax.tree.map(lambda sd: jnp.zeros(sd.shape, sd.dtype),
                          rlm.init_cache_specs(rcfg, prompt.shape[0], case["max_seq"]))
    _, chunks, _ = rlm.forward(p, prompt[:, :cut], rcfg, caches=chunks, q_offset=0)
    last, _, _ = rlm.forward(p, prompt[:, cut:], rcfg, caches=chunks, q_offset=cut)
    return {"logits": out, "cache": jax.tree.map(np.asarray, caches),
            "chunked_last": np.asarray(last[:, -1])}


def _name(arch, zero1, n_micro):
    return f"{arch}-{'zero1' if zero1 else 'replicated'}-micro{n_micro}"


def _tp_name(arch, impl, n_micro):
    return f"tp-{arch}-{impl}-micro{n_micro}"


def _ref_grads(rcfg, params, batch):
    """The reference's one-device loss gradient on ``batch``."""
    f = jax.jit(jax.grad(lambda p, b: rsteps.make_loss_fn(rcfg)(p, b)))
    return jax.tree.map(np.asarray, f(jax.tree.map(jnp.asarray, params),
                                      {k: jnp.asarray(v) for k, v in batch.items()}))


def _rcfg(arch):
    rcfg = rconfigs.get_reduced(arch).replace(**F32)
    if rcfg.family == "moe":
        rcfg = rcfg.replace(capacity_factor=0.5)        # capacity binds
    return rcfg


def _batches(rcfg, params, seed):
    """STEPS global batches of 4 rows; one for the vlm family, whose state
    after a second step strays from the reference's by more than the
    parameters' tolerance on one process too (its key biases' gradients
    come from M-RoPE's rotation alone), as tests/test_torch_vlm.py holds
    it after one."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(1 if rcfg.family == "vlm" else STEPS):
        b, s = 4, (24 if rcfg.family == "vlm" else 16)
        labels = rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32)
        # rank 1's rows only, with one micro-batch or two: another count
        # of unmasked labels on each rank
        labels[3, :5] = -1
        if rcfg.family == "vlm":
            toks = rng.integers(0, rcfg.vocab, (b, s))
            emb = params["embed"][toks].astype(np.float32)
            emb[:, 4:13] = rng.normal(0, 0.02, (b, 9, rcfg.d_model))
            t = np.arange(s, dtype=np.int32)
            pos = np.stack([t, t // 3 + 1, t % 3 + 2])[:, None].repeat(b, 1)
            pos = pos + np.arange(b, dtype=np.int32)[None, :, None]
            out.append({"inputs_embeds": emb, "positions": pos.astype(np.int32),
                        "labels": labels})
        else:
            out.append({"tokens": rng.integers(0, rcfg.vocab, (b, s)).astype(np.int32),
                        "labels": labels})
    return out


def _ref_run(rcfg, params, batches, n_micro):
    ocfg = ROptConfig(**KW)
    state = {"params": params, "opt": radamw.init_state(params, ocfg)}
    step = jax.jit(rsteps.make_train_step(rcfg, ocfg, n_micro=n_micro))
    losses = []
    for b in batches:
        state, loss = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp_run():
    """Write the inputs, start the two ranks, run the reference side while
    they work, and return (inputs, reference results, rank outputs)."""
    tmp = tempfile.TemporaryDirectory(prefix="torch_dp_")
    d = tmp.name
    params = {a: jax.tree.map(np.asarray, rlm.init_params(_rcfg(a), jax.random.PRNGKey(5)))
              for a in ARCHS}
    batches = {a: _batches(_rcfg(a), params[a], 20 + i) for i, a in enumerate(ARCHS)}
    rng = np.random.default_rng(3)
    psum = {"g": rng.normal(size=(WORLD, 300)).astype(np.float32),
            "err": (rng.normal(size=(WORLD, 300)) * 1e-3).astype(np.float32),
            "tree_g": [{"a": rng.normal(size=(4, 6)).astype(np.float32),
                        "b": {"c": (rng.normal(size=(9,)) * 50).astype(np.float32)}}
                       for _ in range(WORLD)],
            "tree_err": [{"a": np.zeros((4, 6), np.float32),
                          "b": {"c": np.full((9,), 0.01, np.float32)}}
                         for _ in range(WORLD)]}
    serve = []
    for name, (arch, _, _) in SERVE.items():
        rcfg = _serve_rcfg(name)
        # one prompt an architecture: the ep and gspmd cases share theirs
        # and the reference's run
        rng = np.random.default_rng(40 + len(arch))
        serve.append({
            "name": name, "cfg": dataclasses.asdict(rcfg), "max_seq": SERVE[name][2],
            "params": jax.tree.map(np.asarray, rlm.init_params(rcfg, jax.random.PRNGKey(6))),
            "prompt": rng.integers(0, rcfg.vocab, SERVE_PROMPT).astype(np.int32),
            "decode_tokens": [rng.integers(0, rcfg.vocab, SERVE_PROMPT[0]).astype(np.int32)
                              for _ in range(SERVE_STEPS)],
            "chunk": SERVE_CHUNK})
    corpus = token_corpus(600, 128, seed=4)
    pcfg = dict(vocab=128, seq_len=16, global_batch=4, min_len=64, min_quality=0.3)
    cases = [{"name": _name(a, z, n), "cfg": dataclasses.asdict(_rcfg(a)),
              "ocfg": dict(KW, zero1=z), "n_micro": n, "params": params[a],
              "batches": batches[a]} for a, z, n in CASES]
    tp_cases = [{"name": _tp_name(a, impl, n),
                 "cfg": dataclasses.asdict(_rcfg(a).replace(moe_impl=impl)),
                 "ocfg": dict(KW), "n_micro": n, "params": params[a],
                 "batches": batches[a]} for a, impl, n in TP_CASES]
    tp_launcher = {k: v + ["--model-axis", str(WORLD),
                           "--ckpt-dir", os.path.join(d, f"tp_launcher_{k}")]
                   for k, v in TP_LAUNCHERS.items()}
    inputs = {"psum": psum, "cases": cases, "ckpt_case": CKPT_CASE,
              "tp": {"cases": tp_cases, "ckpt_case": TP_CKPT_CASE,
                     "ckpt_dir": os.path.join(d, "tp_ckpt"), "launcher": tp_launcher},
              "ckpt_dir": os.path.join(d, "ckpt"),
              "preempt_dir": os.path.join(d, "preempt"),
              "pipeline": {"corpus": corpus, "pcfg": pcfg},
              "launcher": LAUNCHER + ["--ckpt-dir", os.path.join(d, "launcher")],
              "serve": serve}
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   OMP_NUM_THREADS="1", RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dp_ranks.py"), d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        # the reference side, while the ranks run
        ref = {"cases": {}, "grads": {}}
        for a in ARCHS:
            for n in (1, 2):
                ref["cases"][(a, n)] = _ref_run(_rcfg(a), params[a], batches[a], n)
        for a in {a for a, _, _ in TP_CASES}:
            ref["grads"][a] = _ref_grads(_rcfg(a), params[a], batches[a][0])
        f = jax.vmap(lambda g, e: rcomp.compressed_psum(g, e, ("data",)),
                     axis_name="data")
        ref["psum"] = tuple(map(np.asarray, f(psum["g"], psum["err"])))
        stack = jax.tree.map(lambda *x: np.stack(x), *psum["tree_g"])
        estack = jax.tree.map(lambda *x: np.stack(x), *psum["tree_err"])
        tg, te = jax.vmap(lambda g, e: rcomp.tree_compressed_psum(g, e, ("data",)),
                          axis_name="data")(stack, estack)
        ref["tree_psum"] = (jax.tree.map(np.asarray, tg), jax.tree.map(np.asarray, te))
        pipe = RTokenPipeline(corpus, RPipelineConfig(**pcfg))
        try:
            ref["pipeline"] = {"doc_len": pipe.doc_len, "doc_seed": pipe.doc_seed,
                               "doc_offset": pipe.doc_offset,
                               "total_tokens": pipe.total_tokens,
                               "bucket_stats": {k: np.asarray(v) for k, v
                                                in pipe.bucket_stats.items()},
                               "batches": [next(pipe) for _ in range(2)]}
        finally:
            pipe.close()
        with tempfile.TemporaryDirectory() as ld:
            ref["launcher"] = ttrain.main(LAUNCHER + ["--ckpt-dir", ld])["losses"]
        with tempfile.TemporaryDirectory() as ld:
            ref["launcher_ep"] = ttrain.main(TP_LAUNCHERS["ep"] + ["--ckpt-dir", ld])["losses"]
        # one reference a model: without an EP mesh its "ep" is gspmd
        ref["serve"] = {}
        for case in serve:
            key = (SERVE[case["name"]][0], SERVE[case["name"]][2],
                   tuple(sorted(SERVE[case["name"]][1].items() - {("moe_impl", "ep")})))
            if key not in ref["serve"]:
                ref["serve"][key] = _ref_serve(_serve_rcfg(case["name"]),
                                               case["params"], case)
            ref["serve"][case["name"]] = ref["serve"][key]
        outs = []
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank {r}:\n{stderr[-6000:]}"
            outs.append(torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False))
        yield inputs, ref, outs, d
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max(initial=0))


def _payload(g, err, new_err, scale):
    """The int8 payload a rank summed: (corrected - new_err) / scale."""
    return np.round((g + err - new_err) / scale).astype(np.int8)


def test_ranks_ran_on_a_gloo_data_mesh(dp_run):
    _, _, outs, _ = dp_run
    for r, o in enumerate(outs):
        assert o["world"] == WORLD and o["backend"] == "gloo"
        assert o["mesh"] == {"data": WORLD, "model": 1}, r


def test_compressed_psum_matches_reference_under_vmap(dp_run):
    inputs, ref, outs, _ = dp_run
    ps = inputs["psum"]
    want_mean, want_err = ref["psum"]
    scale = max(float(np.abs(ps["g"] + ps["err"]).max()) / 127.0, 1e-12)
    for r, o in enumerate(outs):
        got = o["psum"]
        assert _ulps(got["g_mean"], want_mean[r]) <= 1
        assert _ulps(got["new_err"], want_err[r]) <= 1
        assert np.array_equal(
            _payload(ps["g"][r], ps["err"][r], got["new_err"], scale),
            _payload(ps["g"][r], ps["err"][r], want_err[r], scale))
        # every rank holds the same mean
        assert np.array_equal(got["g_mean"], outs[0]["psum"]["g_mean"])
    tg, te = ref["tree_psum"]
    for r, o in enumerate(outs):
        for k, w in _flat(tg).items():
            assert _ulps(_flat(o["psum"]["tree_g"])[k], w[r]) <= 1, k
        for k, w in _flat(te).items():
            assert _ulps(_flat(o["psum"]["tree_err"])[k], w[r]) <= 1, k


@pytest.mark.parametrize("arch,zero1,n_micro", CASES,
                         ids=[_name(*c) for c in CASES])
def test_dp_train_step_matches_reference(dp_run, arch, zero1, n_micro):
    """P = 2 against the reference's one-device step on the global batch:
    the losses of both steps (rtol 1e-5; both ranks the same), then the
    parameters (rtol 1e-5, atol 1e-2 lr) and the whole AdamW state
    (gathered; atol 1e-4 x the leaf's largest |w|)."""
    _, ref, outs, _ = dp_run
    name = _name(arch, zero1, n_micro)
    want_losses, want_state = ref["cases"][(arch, n_micro)]
    got = outs[0]["cases"][name]
    assert got["losses"] == outs[1]["cases"][name]["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    want, have = _flat(want_state), _flat(got["state"])
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        h = np.asarray(have[k], np.float32)
        if k.startswith("params") and arch == "qwen2-vl-2b":
            # tests/test_torch_vlm.py's rule for this family, whose key
            # biases get gradients from M-RoPE's rotation alone: AdamW moves
            # an element whose gradient is not resolved (|m| within 1e-4 of
            # the leaf's largest) by ~lr either way, so those within 2 lr,
            # the rest as every other family's
            m = want["opt/m/" + k[len("params/"):]]
            resolved = np.abs(m) > 1e-4 * float(np.abs(m).max())
            diff = np.abs(h - w)
            assert float(diff.max()) <= 2 * KW["lr"], k
            assert float((diff - 1e-5 * np.abs(w))[resolved].max(initial=0)) <= \
                1e-2 * KW["lr"], k
            continue
        atol = 1e-2 * KW["lr"] if k.startswith("params") else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(h, w, rtol=1e-5, atol=atol, err_msg=k)
    if arch == "deepseek-moe-16b":
        # the capacity bound: some expert was sent more rows than it takes
        assert got["overflow"], "no routing overflowed its capacity"


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_blocks_follow_zero1_spec(dp_run, arch):
    """Each rank's moments are its blocks of zero1_spec's layout (with
    zero1) or whole (without), and equal the gathered state's blocks."""
    _, _, outs, _ = dp_run
    for zero1 in (True, False):
        sharded = 0
        for r, o in enumerate(outs):
            for path, b in o["cases"][_name(arch, zero1, 1)]["blocks"].items():
                assert b["shape"] == b["zero1_shape"] and b["is_block"], (r, path)
                data = any("data" in ((e,) if isinstance(e, str) else (e or ()))
                           for e in b["spec"])
                assert data == zero1 or (zero1 and not data), (path, b["spec"])
                sharded += data
        assert (sharded > 0) == zero1


@pytest.mark.parametrize("zero1", [True, False])
def test_collective_counts_follow_the_layout(dp_run, zero1):
    """A dense step's collectives: with ZeRO-1 a reduce-scatter and an
    all-gather per sharded leaf, an all-reduce per whole leaf and one for
    the norm; without it an all-reduce per leaf; and one for the global
    loss and one a micro-batch for the count of unmasked labels."""
    inputs, _, outs, _ = dp_run
    for n_micro in (1, 2):
        name = _name("qwen3-0.6b", zero1, n_micro)
        case = next(c for c in inputs["cases"] if c["name"] == name)
        blocks = outs[0]["cases"][name]["blocks"]
        params = _flat(case["params"])
        sizes = {k: int(v.size) for k, v in params.items()}
        sharded = [k for k, b in blocks.items() if b["shape"] != params[k].shape]
        whole = [k for k in blocks if k not in sharded]
        counts = outs[0]["cases"][name]["counts"]
        assert counts == outs[1]["cases"][name]["counts"]
        want = {"all_reduce_sum": {
            "calls": len(whole) + (1 if sharded else 0) + 1 + n_micro,
            "bytes": 4 * (sum(sizes[k] for k in whole) + (1 if sharded else 0)
                          + 1 + n_micro)}}
        if sharded:
            nbytes = 4 * sum(sizes[k] for k in sharded)
            want["reduce_scatter"] = {"calls": len(sharded), "bytes": nbytes}
            want["all_gather"] = {"calls": len(sharded), "bytes": nbytes}
        assert counts == want, (name, counts, want)


def test_moe_routing_gathers_counts_once_a_block(dp_run):
    """Each MoE block of the reduced deepseek-moe-16b all-gathers its 2 x E
    counts once in the forward and once in its recomputation (remat)."""
    inputs, _, outs, _ = dp_run
    for n_micro in (1, 2):
        name = _name("deepseek-moe-16b", False, n_micro)
        cfg = next(c for c in inputs["cases"] if c["name"] == name)["cfg"]
        moe_layers = cfg["n_layers"] - cfg["first_dense_layers"]
        got = outs[0]["cases"][name]["counts"]["all_gather"]
        E = cfg["n_experts"]
        assert got == {"calls": 2 * moe_layers * n_micro,
                       "bytes": 2 * moe_layers * n_micro * WORLD * 2 * E * 4}


def test_checkpoint_saved_at_p2_restores_at_p1_p2_and_in_reference(dp_run):
    _, _, outs, d = dp_run
    ck = os.path.join(d, "ckpt")
    whole = outs[0]["cases"][CKPT_CASE]["state"]
    assert tckpt.latest_step(ck) == STEPS
    # P = 1: the port's whole leaves, bitwise
    template = jax.tree.map(torch.from_numpy, whole)
    tree, step, meta = tckpt.restore(ck, template, device="cpu")
    assert step == STEPS and meta == {"arch": "qwen3-0.6b"}
    for k, w in _flat(whole).items():
        assert np.array_equal(_flat(tree)[k].numpy(), w), k
    # the reference reads the port's P = 2 checkpoint
    rtree, rstep, _ = rckpt.restore(ck, jax.tree.map(jnp.asarray, whole))
    assert rstep == STEPS
    for k, w in _flat(whole).items():
        assert np.array_equal(np.asarray(_flat(rtree)[k]), w), k
    # P = 2: each rank's blocks bitwise, and the first step from them
    for o in outs:
        c = o["ckpt"]
        assert c["step"] == STEPS and c["bitwise"], c
        assert c["restored_loss"] == c["live_loss"], c


def test_preemption_is_agreed_across_ranks(dp_run):
    _, _, outs, _ = dp_run
    steps = {o["preemption"]["steps"] for o in outs}
    assert len(steps) == 1 and 2 <= steps.pop() <= 3, [o["preemption"] for o in outs]
    for o in outs:
        assert o["preemption"]["latest"] == o["preemption"]["steps"]


def test_token_pipeline_at_p2_is_the_references(dp_run):
    _, ref, outs, _ = dp_run
    want = ref["pipeline"]
    for o in outs:
        got = o["pipeline"]
        for k in ("doc_len", "doc_seed", "doc_offset"):
            assert np.array_equal(got[k], want[k]), k
        assert got["total_tokens"] == want["total_tokens"]
        order = np.argsort(got["bucket_stats"]["bucket"])
        worder = np.argsort(want["bucket_stats"]["bucket"])
        for k in want["bucket_stats"]:
            assert np.array_equal(got["bucket_stats"][k][order],
                                  want["bucket_stats"][k][worder]), k
        for g, w in zip(got["batches"], want["batches"]):
            for k in w:
                assert np.array_equal(g[k], w[k]), k


def test_launcher_trains_data_parallel(dp_run):
    """``launch.train.main`` on two ranks (as torchrun starts it) against
    one process: bf16 weights, so the first loss within 1e-5 and the
    second within 1e-3 (the summed gradients round otherwise)."""
    _, ref, outs, _ = dp_run
    for o in outs:
        assert o["launcher"]["steps"] == 2
        got = o["launcher"]["losses"]
        np.testing.assert_allclose(got[0], ref["launcher"][0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], ref["launcher"][1:], rtol=1e-3)


# ---------------------------------------------------------------------------
# serving on the model axis
# ---------------------------------------------------------------------------


def test_ranks_served_on_a_model_mesh(dp_run):
    _, _, outs, _ = dp_run
    for o in outs:
        assert o["serve_mesh"] == {"data": 1, "model": WORLD}


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serving_matches_reference(dp_run, name):
    """Prefill and 4 decode steps on (data 1, model 2) against the
    reference's one-device steps: every step's logits (rtol 1e-4, atol
    1e-5), the same on both ranks; the greedy picks the reference logits'
    argmax; the cache after the last step, gathered; the last logits of the
    prompt prefilled in two chunks (the reference's forward over the same
    chunks); each rank's rows of S."""
    _, ref, outs, _ = dp_run
    want = ref["serve"][name]
    max_seq = SERVE[name][2]
    for r, o in enumerate(outs):
        got = o["serve"][name]
        assert len(got["logits"]) == len(want["logits"]) == SERVE_STEPS + 1
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"step {i}")
            np.testing.assert_array_equal(got["picks"][i], w.argmax(-1))
            np.testing.assert_array_equal(g, outs[0]["serve"][name]["logits"][i])
        for stack, c in got["cache"].items():
            for k in ("k", "v"):
                np.testing.assert_allclose(c[k], want["cache"][stack][k], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{stack}/{k}")
        np.testing.assert_allclose(got["chunked_last"], want["chunked_last"],
                                   rtol=1e-4, atol=1e-5)
        rows = max_seq // WORLD if max_seq % WORLD == 0 else max_seq
        assert got["block"] == ((r * rows if rows < max_seq else 0), rows, max_seq)


def _decode_layout(cfg: dict, max_seq: int) -> dict:
    """The collectives of one decode step on (data 1, model M) by the
    rules, B rows: an all-reduce (float32, B x d) for the vocabulary-
    parallel embedding, for each row-parallel wo and MLP and for each MoE
    block; an all-gather a layer of the step's sharded q/k/v columns
    (float32, B x their columns) and, with S sharded, of the partial
    softmaxes (M x B x Hkv x G x (hd + 2) float32)."""
    amesh = AbstractMesh((1, WORLD), ("data", "model"))
    rcfg = rconfigs.get_reduced(cfg["name"]).replace(**{
        k: cfg[k] for k in ("vocab", "d_ff", "n_heads", "n_kv_heads", "moe_impl")})
    shapes = rlm.param_specs(rcfg)
    cut = lambda path: any(e is not None for e in rsharding.param_spec_for(  # noqa: E731
        amesh, path, _at_path(shapes, path).shape))
    b, d, hd = SERVE_PROMPT[0], rcfg.d_model, rcfg.hd
    h, hkv = rcfg.n_heads, rcfg.n_kv_heads
    stacks = {"dense_layers": rcfg.first_dense_layers,
              "layers": rcfg.n_layers - rcfg.first_dense_layers} \
        if rcfg.family == "moe" else {"layers": rcfg.n_layers}
    reduces = int(cut(("embed",)))
    gathers, gather_bytes = 0, 0
    for name, n in stacks.items():
        ffn = ("moe", "experts", "w_gate") if name == "layers" and rcfg.family == "moe" \
            else ("mlp", "w_down")
        reduces += n * (int(cut((name, "attn", "wo"))) + int(cut((name,) + ffn)))
        cols = [c for w, c in (("wq", h * hd), ("wk", hkv * hd), ("wv", hkv * hd))
                if cut((name, "attn", w))]
        seq = max_seq % WORLD == 0
        gathers += n * (bool(cols) + seq)
        gather_bytes += n * (4 * b * sum(cols)
                             + seq * 4 * WORLD * b * hkv * (h // hkv) * (hd + 2))
    out = {"all_reduce_sum": {"calls": reduces, "bytes": reduces * 4 * b * d}}
    if gathers:
        out["all_gather"] = {"calls": gathers, "bytes": gather_bytes}
    return out


def _at_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_decode_step_collectives_follow_the_layout(dp_run, name):
    """A decode step's collectives, counted on both ranks, against the
    rules' layout (``_decode_layout``)."""
    inputs, _, outs, _ = dp_run
    case = next(c for c in inputs["serve"] if c["name"] == name)
    want = _decode_layout(case["cfg"], case["max_seq"])
    for o in outs:
        assert o["serve"][name]["counts"] == want, (o["serve"][name]["counts"], want)



# ---------------------------------------------------------------------------
# training on the model axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,impl,n_micro", TP_CASES,
                         ids=[_tp_name(*c) for c in TP_CASES])
def test_tp_train_step_matches_reference(dp_run, arch, impl, n_micro):
    """(data 1, model 2), remat per block, against the reference's jitted
    one-device step on the same global batch: with one micro-batch the
    first batch's gradients gathered over "model" (atol 1e-4 x the leaf's
    largest |g|, rtol 1e-5); both steps' losses (rtol 1e-5, both ranks the
    same); the parameters (rtol 1e-5, atol 1e-2 lr) and the AdamW state
    (atol 1e-4 x the leaf's largest |w|) gathered over both axes."""
    _, ref, outs, _ = dp_run
    name = _tp_name(arch, impl, n_micro)
    want_losses, want_state = ref["cases"][(arch, n_micro)]
    got = outs[0]["tp_cases"][name]
    assert got["losses"] == outs[1]["tp_cases"][name]["losses"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    if n_micro == 1:
        for k, w in _flat(ref["grads"][arch]).items():
            np.testing.assert_allclose(_flat(got["grads"])[k], w, rtol=1e-5,
                                       atol=1e-4 * float(np.abs(w).max()), err_msg=k)
    want, have = _flat(want_state), _flat(got["state"])
    assert sorted(have) == sorted(want)
    for k, w in want.items():
        w = w.astype(np.float32)
        atol = 1e-2 * KW["lr"] if k.startswith("params") else \
            1e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(np.asarray(have[k], np.float32), w, rtol=1e-5,
                                   atol=atol, err_msg=k)
    for r, o in enumerate(outs):
        for path, b in o["tp_cases"][name]["blocks"].items():
            assert b["shape"] == b["zero1_shape"] and b["is_block"], (r, path, b)


def test_tp_train_step_collectives(dp_run):
    """The dense step's collectives on (data 1, model 2): the vocabulary-
    parallel loss's max all-reduce moves a (B, S) float32 row a micro-batch,
    never the (B, S, V) logits; no all-gather (every head divides the
    axis); no all-reduce larger than a (B, S, d) float32 activation."""
    inputs, _, outs, _ = dp_run
    for n_micro in (1, 2):
        name = _tp_name("qwen3-0.6b", "gspmd", n_micro)
        case = next(c for c in inputs["tp"]["cases"] if c["name"] == name)
        b, s = case["batches"][0]["tokens"].shape
        counts = outs[0]["tp_cases"][name]["counts"]
        assert counts == outs[1]["tp_cases"][name]["counts"]
        assert counts["all_reduce_max"] == {"calls": n_micro, "bytes": 4 * b * s}
        assert "all_gather" not in counts and "all_to_all" not in counts, counts
        d, vocab = case["cfg"]["d_model"], case["cfg"]["vocab"]
        sums = counts["all_reduce_sum"]
        assert sums["bytes"] < sums["calls"] * 4 * (b // n_micro) * s * d, sums
        assert 4 * b * s * vocab > sums["bytes"] / sums["calls"]


def test_tp_checkpoint_restores_on_the_mesh_and_at_one_process(dp_run):
    """Saved at (data 1, model 2): restored on the mesh into a fresh state,
    bitwise against the live blocks; here at one process, bitwise against
    the state gathered on the ranks."""
    _, _, outs, d = dp_run
    for o in outs:
        assert o["tp_ckpt"] == {"step": STEPS, "bitwise": True}, o["tp_ckpt"]
    whole = outs[0]["tp_cases"][TP_CKPT_CASE]["state"]
    template = jax.tree.map(torch.from_numpy, whole)
    tree, step, meta = tckpt.restore(os.path.join(d, "tp_ckpt"), template, device="cpu")
    assert step == STEPS and meta == {"arch": "qwen3-0.6b"}
    for k, w in _flat(whole).items():
        assert np.array_equal(_flat(tree)[k].numpy(), w), k


@pytest.mark.parametrize("kind", list(TP_LAUNCHERS))
def test_launcher_trains_on_a_model_axis(dp_run, kind):
    """``launch.train.main(... --model-axis 2)`` on two ranks against one
    process, as ``test_launcher_trains_data_parallel`` holds it: the dense
    family, and the moe family with ``--moe-impl ep``."""
    _, ref, outs, _ = dp_run
    want = ref["launcher" if kind == "dense" else "launcher_ep"]
    for o in outs:
        assert o["tp_launcher"][kind]["steps"] == 2
        got = o["tp_launcher"][kind]["losses"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
