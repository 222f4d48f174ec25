"""The model axis in one process, against the reference package: the
partial softmax and its merge (``decode_attention_partial`` /
``decode_attention_merge``, the plain versions) against the reference's
``decode_attention`` over the whole S; the expert-parallel block against
the reference's ``_moe_block_ep`` on a one-device (data 1, model 1) mesh;
its ranks at P = E/M + 1 against the reference's one-hot cumsum; each
rank's parameter and cache blocks against the reference's
``param_spec_for`` / ``cache_spec_for``; which families build a train step on a model axis
and what still raises there.  The two-rank serving checks run in tests/test_torch_sharding.py's
spawn (tests/torch_dp_ranks.py).

Tolerances: float32 attention within 2e-5 (the reference's own float32
tolerance between its kernel and its oracle), bfloat16 within 2^-7
relative more (one rounding of the output); the float32 MoE block within
1e-5 (tests/test_torch_moe.py's); integers and blocks exact.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from repro.configs import get_reduced as rget_reduced  # noqa: E402
from repro.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro.models import lm as rlm  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import sharding as rsharding  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import sharding as tsharding  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

KERNELS = treg.resolve("cpu")


# ---------------------------------------------------------------------------
# decode_attention over S blocks: partial + merge
# ---------------------------------------------------------------------------

# (B, S, Hkv, G, hd): S divided by M, S that M does not divide, the lm
# shape's grouping
PARTIAL_SHAPES = [(3, 512, 2, 2, 32), (4, 700, 2, 4, 64), (2, 130, 8, 2, 128)]


def _blocks(s: int, m: int) -> list[tuple[int, int]]:
    """M blocks of S rows, each ceil(S / M) but the last (an S that M does
    not divide)."""
    rows = -(-s // m)
    return [(r * rows, min(s, (r + 1) * rows)) for r in range(m)]


def _partial_inputs(shape, seed):
    b, s, hkv, g, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    # 1: every block but the first empty; a length inside the last block;
    # S; the rest random
    length = rng.integers(1, s + 1, b).astype(np.int32)
    length[0] = 1
    length[-1] = s
    if b > 2:
        length[1] = s - 3
    return q, k, v, length


def _merged(q, k, v, length, m):
    """decode_attention over S as M blocks: each block's partial at its
    length clamp(length - offset, 0, rows), the partials merged in block
    order."""
    parts = []
    for lo, hi in _blocks(k.shape[1], m):
        lb = torch.clamp(length - lo, 0, hi - lo).to(torch.int32)
        parts.append(KERNELS.decode_attention_partial(
            q, k[:, lo:hi].contiguous(), v[:, lo:hi].contiguous(), lb))
    return KERNELS.decode_attention_merge(torch.stack(parts), dtype=q.dtype), parts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_partial_merge_matches_reference(shape, m, dtype):
    """Over M blocks (M = 1: a replicated S, one partial) the merged
    partials equal the reference's oracle and its Pallas kernel (interpret
    mode) over the whole S; lengths that leave blocks empty included."""
    jdt, tdt, rtol = {"float32": (jnp.float32, torch.float32, 0.0),
                      "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}[dtype]
    q, k, v, length = _partial_inputs(shape, PARTIAL_SHAPES.index(shape) + m)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(length)]
    got, parts = _merged(*[torch.from_numpy(a).to(tdt) for a in (q, k, v)],
                         torch.from_numpy(length), m)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    for p in parts:
        assert p.dtype == torch.float32 and tuple(p.shape) == (*q.shape[:3], q.shape[3] + 2)
        assert bool(torch.isfinite(p).all())
    got = got.float().numpy()
    ref = np.asarray(da_ref.decode_attention_ref(*jargs), np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=2e-5)
    if m == 2:
        pallas = np.asarray(da_ops.decode_attention(*jargs, interpret=True), np.float32)
        np.testing.assert_allclose(got, pallas, rtol=rtol, atol=2e-5)


def test_empty_block_weighs_nothing():
    """A block with no row below its length gives max -1e30, sum 0 and a
    zero numerator (not the plain version's uniform weights over a masked
    row), and merging it with a live block leaves that block's output."""
    q, k, v, _ = (torch.from_numpy(a) for a in _partial_inputs((2, 64, 2, 2, 32), 5))
    zero = torch.zeros(2, dtype=torch.int32)
    empty = KERNELS.decode_attention_partial(q, k, v, zero)
    assert bool((empty[..., -2] == -1e30).all()) and bool((empty[..., -1] == 0).all())
    assert bool((empty[..., :-2] == 0).all())
    full = torch.full((2,), 64, dtype=torch.int32)
    live = KERNELS.decode_attention_partial(q, k, v, full)
    for pair in ([empty, live], [live, empty]):
        got = KERNELS.decode_attention_merge(torch.stack(pair))
        torch.testing.assert_close(got, KERNELS.decode_attention(q, k, v, full),
                                   rtol=0, atol=2e-5)
    # every block empty (outside the contract, length >= 1): zeros, not NaN
    assert bool((KERNELS.decode_attention_merge(torch.stack([empty, empty])) == 0).all())


def test_partial_and_merge_are_registered_by_device():
    from repro_torch.kernels.decode_attention import decode_attention as tda
    cuda = treg.resolve("cuda")
    assert KERNELS.decode_attention_partial is tda.decode_attention_partial_plain
    assert KERNELS.decode_attention_merge is tda.decode_attention_merge_plain
    assert cuda.decode_attention_partial is tda.decode_attention_partial_cuda
    assert cuda.decode_attention_merge is tda.decode_attention_merge_cuda
    q, k, v, length = (torch.from_numpy(a) for a in _partial_inputs((2, 32, 2, 2, 32), 1))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tda.decode_attention_partial_cuda(q, k, v, length)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tda.decode_attention_merge_cuda(torch.zeros((2, 2, 2, 2, 34)))


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def _port_cfg(rcfg):
    return ModelConfig(**dataclasses.asdict(rcfg))


def _ep_case(seed, b=4, s=16):
    rcfg = rget_reduced("deepseek-moe-16b").replace(capacity_factor=0.5,
                                                    moe_impl="ep")
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda shape: (rng.normal(size=shape) / np.sqrt(shape[-2])
                                    ).astype(np.float32),
                     rmoe.moe_param_shapes(rcfg), is_leaf=lambda x: isinstance(x, tuple))
    x = rng.normal(size=(b, s, rcfg.d_model)).astype(np.float32)
    return rcfg, p, x


@functools.lru_cache(maxsize=None)
def _ref_ep(rcfg):
    """The reference's ``_moe_block_ep`` on a one-device (data 1, model 1)
    mesh, compiled once."""
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return jax.jit(lambda p, x: rmoe._moe_block_ep(p, x, rcfg, jmesh))


@pytest.mark.parametrize("seed", [0, 1])
def test_ep_block_matches_reference_with_drops(seed):
    """The port's EP block on a (data 1, model 1) mesh against the
    reference's ``_moe_block_ep`` on a one-device (data 1, model 1) jax
    mesh, at a capacity that drops rows: outputs within 1e-5, aux within
    1e-6; and, without a model axis, "ep" computes the gspmd block (the
    reference's fallback without an EP mesh)."""
    rcfg, p, x = _ep_case(seed)
    want, want_aux = _ref_ep(rcfg)(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = tlm.tree_map(torch.from_numpy, p)
    cfg = _port_cfg(rcfg)
    got, aux = tmoe.moe_block(tp, torch.from_numpy(x), cfg,
                              mesh=Mesh({"data": 1, "model": 1}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    # the capacity binds: some expert was sent more rows than it takes
    r = tmoe.route(tp, torch.from_numpy(x).reshape(-1, rcfg.d_model), cfg)
    assert int(r.counts.max()) > r.C
    plain, _ = tmoe.moe_block(tp, torch.from_numpy(x), cfg.replace(moe_impl="gspmd"))
    one, _ = tmoe.moe_block(tp, torch.from_numpy(x), cfg)
    assert torch.equal(one, plain)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_ep_slots_match_one_hot_cumsum(m):
    """Each rank's local experts and ranks from ``bucket_scatter`` at P =
    E/M + 1 against the reference's one-hot cumsum (``_moe_block_ep``):
    the local expert of every row exact, the rank of every row of this
    rank's experts exact."""
    E, k, T = 8, 2, 37
    rng = np.random.default_rng(m)
    flat_e = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]).reshape(-1)
    e_loc = E // m
    for idx in range(m):
        le, slot = tmoe.ep_slots(torch.from_numpy(flat_e), E, m, idx, KERNELS)
        ref_le = flat_e - idx * e_loc
        mine = (ref_le >= 0) & (ref_le < e_loc)
        le_c = jnp.where(mine, ref_le, e_loc)
        onehot = jax.nn.one_hot(le_c, e_loc, dtype=jnp.int32)
        ranks = np.asarray(jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=1))
        np.testing.assert_array_equal(le.numpy(), np.asarray(le_c))
        np.testing.assert_array_equal(slot.numpy()[mine], ranks[mine])


def test_ep_refuses_more_than_2048_buckets():
    from repro_torch.kernels.hash_partition import hash_partition as thp
    flat_e = torch.zeros(4, dtype=torch.int64)
    for m in (1, 2):                  # 4097 and 2049 buckets
        with pytest.raises(ValueError, match=str(thp.MAX_P)):
            tmoe.ep_slots(flat_e, 2 * thp.MAX_P, m, 0, KERNELS)
    le, _ = tmoe.ep_slots(flat_e, 2 * thp.MAX_P, 4, 0, KERNELS)   # 1025 buckets
    assert le.tolist() == [0] * 4


# ---------------------------------------------------------------------------
# blocks by the rules
# ---------------------------------------------------------------------------

BLOCK_MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
                "1x4": ((1, 4), ("data", "model"))}


def _rank_meshes(key):
    sizes, names = BLOCK_MESHES[key]
    n = int(np.prod(sizes))
    return AbstractMesh(sizes, names), [Mesh(dict(zip(names, sizes)), rank=r)
                                        for r in range(n)]


def _want_block(a, pspec, mesh):
    """The block of numpy ``a`` a rank of ``mesh`` (the port's, for its
    coordinates) holds under the reference's PartitionSpec."""
    out = a
    for dim, axes in enumerate(tuple(pspec)):
        if axes is None:
            continue
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        n = int(np.prod([mesh.shape[x] for x in names]))
        i = 0
        for x in names:
            i = i * mesh.shape[x] + mesh.coords[x]
        size = a.shape[dim] // n
        out = np.take(out, np.arange(i * size, (i + 1) * size), axis=dim)
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's reduced weights (numpy) and the port's float32 draw
    (seed 4) without a mesh, flattened."""
    rcfg = rget_reduced(arch)
    init = jax.jit(functools.partial(rlm.init_params, rcfg))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(1)))
    cfg = get_reduced(arch).replace(param_dtype="float32")
    whole = {k: t.numpy() for k, t in _flat(tlm.init_params(cfg, 4, "cpu").tree()).items()}
    return params, whole


@pytest.mark.parametrize("mesh_key", list(BLOCK_MESHES))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-moe-16b"])
def test_param_blocks_follow_reference_rules(arch, mesh_key):
    """Every rank's parameter blocks (``shard_params`` of the reference's
    weights, ``init_params(mesh=)``) are the blocks the reference's
    ``param_spec_for`` gives its coordinates; ``init_params(mesh=)``'s are
    the whole draw's blocks, bitwise."""
    params, whole = _weights(arch)
    amesh, ranks = _rank_meshes(mesh_key)
    cfg = get_reduced(arch).replace(param_dtype="float32")
    cut = 0
    for mesh in ranks:
        got = _flat(tsharding.shard_params(params, mesh))
        drawn = _flat(tlm.init_params(cfg, 4, "cpu", mesh=mesh).tree())
        for path, a in _flat(params).items():
            pspec = rsharding.param_spec_for(amesh, path, a.shape)
            np.testing.assert_array_equal(got[path], _want_block(a, pspec, mesh))
            np.testing.assert_array_equal(drawn[path].numpy(),
                                          _want_block(whole[path], pspec, mesh))
            cut += got[path].shape != a.shape
    assert cut > 0


@pytest.mark.parametrize("max_seq", [24, 25])
@pytest.mark.parametrize("mesh_key", list(BLOCK_MESHES))
def test_cache_blocks_follow_reference_rules(mesh_key, max_seq):
    """``init_cache(mesh=)`` holds each rank's block of every cache leaf
    under the reference's ``cache_spec_for``, and ``shard_cache`` cuts a
    whole cache into those blocks; and its ``SeqBlock``: the rank's rows of
    S, or all of them where the rule replicates S (25 rows on a model axis
    of 2 or 4)."""
    amesh, ranks = _rank_meshes(mesh_key)
    cfg = get_reduced("deepseek-moe-16b")
    specs = rlm.init_cache_specs(rget_reduced("deepseek-moe-16b"), 4, max_seq)
    rng = np.random.default_rng(max_seq)
    whole = {name: {leaf: rng.normal(size=specs[name][leaf].shape).astype(np.float32)
                    for leaf in ("k", "v", "index")} for name in tlm.stacks(cfg)}
    m = ranks[0].shape["model"]
    for mesh in ranks:
        caches = tlm.init_cache(cfg, 4, max_seq, "cpu", mesh=mesh)
        cut = tsharding.shard_cache(whole, mesh)
        for name in tlm.stacks(cfg):
            for leaf in ("k", "v", "index"):
                sd = specs[name][leaf]
                pspec = rsharding.cache_spec_for(amesh, (name, leaf), sd.shape)
                want = _want_block(whole[name][leaf], pspec, mesh)
                assert tuple(caches[name][leaf].shape) == want.shape, (name, leaf)
                np.testing.assert_array_equal(cut[name][leaf], want)
        blk = caches["block"]
        if max_seq % m:
            assert blk == (0, max_seq, max_seq)
        else:
            rows = max_seq // m
            assert blk == (mesh.coords["model"] * rows, rows, max_seq)
        assert blk == tsharding.seq_block(mesh, max_seq)


# ---------------------------------------------------------------------------
# what still raises on a model axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "falcon-mamba-7b", "zamba2-7b",
                                  "whisper-base"])
def test_other_families_on_a_model_axis_raise(arch):
    """Serving the vlm, ssm, hybrid and encdec families on a model axis
    raises, naming ROADMAP.md item 11.7c; on the data axis alone they
    build."""
    cfg = get_reduced(arch)
    mesh = Mesh({"data": 1, "model": 2})
    for build in (lambda: tsteps.make_prefill_step(cfg, 16, mesh=mesh),
                  lambda: tsteps.make_decode_step(cfg, mesh=mesh)):
        with pytest.raises(NotImplementedError, match=r"11\.7c"):
            build()
    if cfg.family != "encdec":
        with pytest.raises(NotImplementedError, match=r"11\.7c"):
            tlm.init_params(cfg, 0, "cpu", mesh=mesh)
    assert callable(tsteps.make_prefill_step(cfg, 16, mesh=Mesh({"data": 2, "model": 1})))


def test_training_on_a_model_axis_raises():
    """The dense and moe families build a train step on a model axis (they
    train there: tests/test_torch_sharding.py's spawn, tests/test_torch_tp_train.py);
    the vlm, ssm, hybrid and encdec families raise, naming ROADMAP.md item
    11.7c, and build one on the data axis alone."""
    mesh = Mesh({"data": 1, "model": 2})
    for arch in ("qwen3-0.6b", "deepseek-moe-16b"):
        for impl in ("gspmd", "ep"):
            cfg = get_reduced(arch).replace(moe_impl=impl)
            assert callable(tsteps.make_prefill_step(cfg, 16, mesh=mesh))
            assert callable(tsteps.make_decode_step(cfg, mesh=mesh))
            assert callable(tsteps.make_train_step(cfg, OptConfig(), mesh=mesh))
    for arch in ("qwen2-vl-2b", "falcon-mamba-7b", "zamba2-7b", "whisper-base"):
        cfg = get_reduced(arch)
        with pytest.raises(NotImplementedError, match=r"11\.7c"):
            tsteps.make_train_step(cfg, OptConfig(), mesh=mesh)
        assert callable(tsteps.make_train_step(cfg, OptConfig(),
                                               mesh=Mesh({"data": 2, "model": 1})))
