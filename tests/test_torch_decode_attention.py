"""decode_attention's plain version against the reference: its oracle
``ref.py::decode_attention_ref`` and its Pallas kernel in interpret mode
(``ops.decode_attention``), on the same numpy inputs, at the shapes and
dtypes of tests/test_kernels_decode_attention.py.

All three compute in float32 from the same inputs and round once to q's
dtype.  So an element may differ by 2e-5, the reference's own float32
tolerance between its kernel and its oracle (the same float32 math summed
in another order), plus, in bfloat16, one rounding step of the output:
|got - want| <= 2^-7 |want| + 2e-5.  That is tighter than the reference's
5e-2 in bfloat16, which is as large as a typical output.  bfloat16 inputs
are float32 numpy values rounded to bfloat16 by each framework (both round
to nearest even, so the bits agree).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as tda  # noqa: E402

SHAPES = [(1, 128, 2, 2, 32), (2, 512, 2, 4, 64),
          (4, 1024, 8, 7, 64),      # yi-style grouping
          (2, 700, 4, 1, 32)]       # MHA, S not a multiple of 512
DTYPES = {"float32": (jnp.float32, torch.float32, 0.0),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


def _inputs(shape, seed):
    b, s, hkv, g, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    length = rng.integers(1, s + 1, b).astype(np.int32)
    return q, k, v, length


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_and_pallas(shape, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    q, k, v, length = _inputs(shape, SHAPES.index(shape))
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(length)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + \
        [torch.from_numpy(length)]
    got = tda.decode_attention_plain(*targs)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    got = got.float().numpy()
    ref = np.asarray(da_ref.decode_attention_ref(*jargs), np.float32)
    pallas = np.asarray(da_ops.decode_attention(*jargs, interpret=True),
                        np.float32)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=rtol, atol=2e-5)


def test_plain_full_length_is_unmasked_attention():
    """length == S equals a dense, unmasked softmax attention (float64
    numpy), within 2e-5."""
    b, s, hkv, g, hd = 2, 256, 2, 2, 32
    q, k, v, _ = _inputs((b, s, hkv, g, hd), 9)
    full = torch.full((b,), s, dtype=torch.int32)
    got = tda.decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), full).numpy()
    sc = np.einsum("bhgd,bshd->bhgs", q.astype(np.float64), k) / np.sqrt(hd)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(got, np.einsum("bhgs,bshd->bhgd", p, v), atol=2e-5)


def test_registry_dispatches_by_device():
    assert treg.resolve("cpu").decode_attention is tda.decode_attention_plain
    assert treg.resolve("cuda").decode_attention is tda.decode_attention_cuda


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, length = (torch.from_numpy(a) for a in _inputs(SHAPES[0], 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tda.decode_attention_cuda(q, k, v, length)


# The CUDA kernel's split over S (csrc/decode_attention.cu): split_plan at
# the decode shapes of every LM path (B, S, Hkv, G, hd, bytes a value) and at
# edge shapes, on an H100's 132 SMs.  It must cover [0, S) once, in order, in
# multiples of the staging tile, reach two blocks an SM where the (b, kv
# head) pairs leave SMs idle and S allows, and read shapes only.
SMS = 132
PLAN_SHAPES = {
    "qwen2-vl-2b": (16, 2176, 2, 6, 128, 2),
    "qwen3-0.6b": (32, 2176, 8, 2, 128, 2),
    "deepseek-moe-16b": (16, 2176, 16, 1, 128, 2),
    "zamba2-7b": (8, 2112, 32, 1, 112, 2),
    "whisper-cross": (32, 1500, 8, 1, 64, 2),
    "whisper-self": (32, 128, 8, 1, 64, 2),
    "s-1": (4, 1, 2, 2, 64, 2),
    "s-below-tile": (2, 7, 2, 4, 32, 4),
    "pairs-fill-card": (64, 1024, 8, 1, 128, 2),
    "hd112-float32": (8, 2112, 32, 1, 112, 4),
    "one-pair-long": (1, 8192, 1, 8, 128, 2),
    "ragged-split": (2, 4097, 2, 4, 64, 4),
}


def _plan(name):
    b, s, hkv, g, hd, itemsize = PLAN_SHAPES[name]
    return tda.split_plan(b, hkv, s, g, hd, itemsize, SMS)


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_plan_covers_s_once_in_tiles(name):
    s = PLAN_SHAPES[name][1]
    splits, rows = _plan(name)
    assert splits >= 1 and rows >= tda.TILE and rows % tda.TILE == 0
    spans = [(i * rows, min((i + 1) * rows, s)) for i in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == s
    assert all(lo < hi for lo, hi in spans)                   # none empty
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # in order


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_plan_fills_the_card_where_s_allows(name):
    b, s, hkv, g, hd, itemsize = PLAN_SHAPES[name]
    splits, rows = _plan(name)
    blocks = b * hkv * splits
    shortest = -(-tda.min_split_rows(g, hd, itemsize) // tda.TILE) * tda.TILE
    assert rows >= shortest
    if b * hkv >= SMS:                   # the pairs cover the SMs
        assert splits == 1
    else:       # short of the target only where S allows no shorter split
        assert blocks >= tda.BLOCKS_PER_SM * SMS or rows == shortest


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_split_plan_reads_shapes_only(name):
    """No length reaches the plan: it takes shapes, a value's bytes and the
    SM count, and gives the same plan for the same shapes every time."""
    import inspect
    params = set(inspect.signature(tda.split_plan).parameters)
    assert params == {"b", "hkv", "s", "g", "hd", "itemsize", "sms"}
    assert _plan(name) == _plan(name)


def _split_then_combine(q, k, v, length, splits, rows):
    """The kernel's arithmetic in float32 PyTorch: each split's partial
    (max, sum, numerator) over its rows below length (an empty split: max
    -1e30, sum 0), then the splits folded in order by the log-sum-exp
    merge."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / np.sqrt(q.shape[-1])
    m_all = torch.full(q.shape[:3], -1e30)
    parts = []
    for i in range(splits):
        lo = i * rows
        sc = torch.einsum("bhgd,bshd->bhgs", qf, kf[:, lo:lo + rows]) * scale
        pos = torch.arange(lo, lo + sc.shape[-1])
        live = pos[None, None, None, :] < length[:, None, None, None]
        sc = torch.where(live, sc, -1e30)
        m = torch.where(live.any(-1), sc.amax(-1), -1e30)
        p = torch.where(live, torch.exp(sc - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bhgs,bshd->bhgd", p,
                                                 vf[:, lo:lo + rows])))
        m_all = torch.maximum(m_all, m)
    den = torch.zeros(q.shape[:3])
    num = torch.zeros(q.shape)
    for m, l, n in parts:
        a = torch.exp(m - m_all)
        den = den + l * a
        num = num + n * a[..., None]
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("name", ["s-1", "s-below-tile", "ragged-split",
                                  "one-pair-long"])
def test_split_combine_matches_plain(name):
    """The split plan's partials folded in split order equal the plain
    version within 2e-5, at lengths 1, either side of every split's first
    row, and S."""
    b, s, hkv, g, hd, _ = PLAN_SHAPES[name]
    splits, rows = _plan(name)
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, hkv, g, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    edges = {1, s} | {n for i in range(1, splits) for n in
                      (i * rows - 1, i * rows, i * rows + 1) if 1 <= n <= s}
    for n in sorted(edges):
        length = torch.full((b,), n, dtype=torch.int32)
        got = _split_then_combine(q, k, v, length, splits, rows)
        want = tda.decode_attention_plain(q, k, v, length)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
