"""The hand-written CUDA kernels against their plain PyTorch versions, on a
card: the same inputs, sizes and comparisons as the CPU parity tests of
tests/test_torch_kernels.py, which hold the plain versions against the
reference.  This file imports neither JAX nor the reference, so it runs on
the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import registry as treg  # noqa: E402

# 0, the reference's 2048-row tile, the stencils' 4096-output tile
# (csrc/stencil1d.cu), and the look-back scans' ragged edges: a 4-row
# vector (3, 4, 5) and their 5120-row tile (csrc/lookback.cuh)
SIZES = (0, 1, 3, 4, 5, 2047, 2048, 2049, 4095, 4096, 4097, 5000, 5119, 5120,
         5121, 10239, 10241)
NAMES = ("prefix_sum", "bucket_scatter", "segment_sums", "segment_scan",
         "segment_rank", "stencil1d", "stencil1d_exact", "segment_stencil",
         "decode_attention")
P_BUCKETS = 8
RANK_KINDS = ("row_number", "rank", "dense_rank")
# (weights, center) of the stencil cases: K = 1, 3, 5 and 20 taps
STENCILS = (((0.25, 0.5, 0.25), 1), ((1.5,), 0),
            ((0.1, -0.4, 2.0, 0.3, 0.7), 0), (tuple(np.linspace(0.05, 1.0, 20)), 10))
# (weights, center, exact) of the segment_stencil cases
SEGMENT_STENCILS = (((0.25, 0.5, 0.25), 1, False), ((0.25, 0.5, 0.25), 1, True),
                    ((0.1, -0.4, 2.0, 0.3, 0.7), 0, False), ((1.0,) * 5, 2, True),
                    ((1.0,), 0, False), (tuple(np.linspace(0.05, 1.0, 20)), 19, True),
                    ((1.0 / 7,) * 7, 6, True))
# and, at the sizes around the stencils' tile and at a few tiles, every K of
# 1, 3, 7 and 20 taps at centres 0, K // 2 and K - 1, exact on and off
STENCIL_EDGES = (4095, 4096, 4097, 10241)
SEGMENT_STENCIL_GRID = tuple(
    (tuple(np.linspace(0.05, 1.0, k)) if k > 1 else (1.5,), c, exact)
    for k in (1, 3, 7, 20) for c in sorted({0, k // 2, k - 1})
    for exact in (False, True))


def _values(rng, n, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-50, 50, n).astype(dtype)
    return rng.normal(size=n).astype(dtype)


def _seg_mask(rng, n, p=0.15, first=True):
    """Random 0/1 segment-head mask; row 0 a head when ``first``."""
    m = (rng.random(n) < p).astype(np.int32)
    if n and first:
        m[0] = 1
    return m


def _cases(name, rng, n, dtype):
    """Numpy argument tuples of the primitive's calls at output length n
    (the reference's parity cases, plus window lengths and rank kinds)."""
    if name == "prefix_sum":
        return [(_values(rng, n, dtype),)]
    if name == "bucket_scatter":
        dest = rng.integers(0, P_BUCKETS, n).astype(np.int32)
        if n > 4:                     # some invalid rows (dest == P)
            dest[rng.choice(n, size=n // 6, replace=False)] = P_BUCKETS
        return [(dest, P_BUCKETS)]
    if name == "segment_sums":
        # ids sorted and consecutive over the valid prefix, the invalid tail
        # routed to the overflow slot, as segment_aggregate does
        nvalid = n - n // 5
        starts = _seg_mask(rng, nvalid)
        sid = (np.cumsum(starts) - 1).astype(np.int32)
        nseg = int(sid[-1]) + 1 if nvalid else 1
        sid = np.concatenate([sid, np.full(n - nvalid, nseg, np.int32)])
        return [(_values(rng, n, dtype), sid, np.arange(n) < nvalid, nseg)]
    if name == "segment_scan":
        # dense heads with row 0 a head; sparse heads without one
        return [(_values(rng, n, dtype), _seg_mask(rng, n)),
                (_values(rng, n, dtype), _seg_mask(rng, n, 0.01, first=False))]
    if name == "segment_rank":
        # order heads are a superset of segment heads (run_starts' invariant)
        seg = _seg_mask(rng, n)
        ordb = np.maximum(seg, (rng.random(n) < 0.3).astype(np.int32))
        return [(seg, ordb, kind) for kind in RANK_KINDS]
    if name == "stencil1d":
        return [(_values(rng, n + len(w) - 1, dtype), w) for w, _c in STENCILS]
    if name == "decode_attention":
        # n cache rows (S), B 2, Hkv 2, G 2, hd 32; lengths in [1, S]
        if n == 0:
            return []
        q = _values(rng, 2 * 2 * 2 * 32, dtype).reshape(2, 2, 2, 32)
        k, v = (_values(rng, 2 * n * 2 * 32, dtype).reshape(2, n, 2, 32)
                for _ in range(2))
        return [(q, k, v, rng.integers(1, n + 1, 2).astype(np.int32))]
    if name == "stencil1d_exact":
        out = []
        for w, c in STENCILS[:2] + STENCILS[3:]:
            k = len(w)
            ext = np.zeros(n + k - 1, dtype)
            ext[c:c + n] = _values(rng, n, dtype)
            ext_m = np.zeros(n + k - 1, dtype)   # zero mass at both ends
            ext_m[c:c + n] = 1
            out.append((ext, ext_m, tuple(abs(v) for v in w)))
        return out
    out = []                          # segment_stencil, as segment_stencil1d
    grid = SEGMENT_STENCIL_GRID if n in STENCIL_EDGES else ()
    for w, c, exact in SEGMENT_STENCILS + grid:  # builds it: -2 halo, -1 invalid
        k = len(w)
        ext = np.zeros(n + k - 1, dtype)
        ext[c:c + n] = _values(rng, n, dtype)
        sid = (np.cumsum(_seg_mask(rng, n)) - 1).astype(np.int32)
        sid[n - n // 7:] = -1
        ext_s = np.full(n + k - 1, -2, np.int32)
        ext_s[c:c + n] = sid
        out.append((ext, ext_s, w, c, exact))
    return out


# segment_sums' contract (csrc/segment_sums.cu): rows at or past count are
# not read, ids outside [0, num_segments) are dropped, and only the slots a
# row of the prefix names are defined.  Its hazards, as numpy
# (values, seg_id, valid, num_segments, count) with count None or an int:
# the prefix empty, ending inside a run, whole, past n, and not given;
# padding rows after the groups, valid but with id num_segments; one run
# over every row; every row its own run; every row invalid; fewer slots than
# runs; invalid rows inside runs and runs of invalid rows only.
SUMS_HAZARDS = ("count_0", "count_short", "count_n", "count_past", "no_count",
                "padding_valid", "one_run", "each_row", "all_invalid",
                "overflow", "holes")


def _sums_case(hazard, rng, n):
    values = rng.normal(size=n).astype(np.float32)
    sid = (np.cumsum(_seg_mask(rng, n, 0.02)) - 1).astype(np.int32)
    nseg = int(sid[-1]) + 1 if n else 0
    valid = np.ones(n, bool)
    num, count = nseg + 3, n
    if hazard == "count_0":
        count = 0
    elif hazard == "count_short":
        count = n - n // 3 - 1 if n > 1 else n
    elif hazard == "count_past":
        count = n + 5
    elif hazard == "no_count":
        count = None
    elif hazard == "padding_valid":
        pad = n // 5
        if n - pad:
            num = int(sid[n - pad - 1]) + 1
        sid[n - pad:] = num
    elif hazard == "one_run":
        sid[:], num = 0, 1
    elif hazard == "each_row":
        sid, num = np.arange(n, dtype=np.int32), max(n, 1)
    elif hazard == "all_invalid":
        valid[:] = False
    elif hazard == "overflow":
        num = max(nseg // 2, 1)
    elif hazard == "holes":
        valid = rng.random(n) < 0.7
        valid[sid % 5 == 2] = False
    return values, sid, valid, num, count


def _named(values, seg_id, valid, num_segments, count=None):
    """The slots a row of the prefix names (sorted, unique)."""
    m = len(seg_id) if count is None else max(0, min(int(count), len(seg_id)))
    ids = np.asarray(seg_id[:m])
    return np.unique(ids[(ids >= 0) & (ids < num_segments)])


DTYPES = {"prefix_sum": (np.int32, np.float32), "bucket_scatter": (np.int32,),
          "segment_sums": (np.float32,), "segment_scan": (np.int32, np.float32),
          "segment_rank": (np.int32,), "stencil1d": (np.float32,),
          "stencil1d_exact": (np.float32,), "segment_stencil": (np.float32,),
          "decode_attention": (np.float32,)}


def _to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(name, args, got, want):
    """Integers exact.  Floats: the stencils within rtol 1e-5, atol 1e-6
    (the same taps in the same order; the reference's Pallas kernel folds
    its weights in as constants); decode_attention within 2e-5, the
    reference's own between its kernel and its oracle; segment_scan within 1e-5 of the running
    sum of |x| (the plain version is a global cumsum minus the segment's
    base, so its rounding grows with that sum); the rest within the
    reference's own tolerance between its backends, rtol 1e-4, atol 1e-3."""
    if name == "bucket_scatter":
        ok = args[0] < args[1]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0][ok], want[0][ok])
        return
    if name == "segment_sums":
        slots = _named(*args)
        got, want = got[slots], want[slots]
    assert got.shape == want.shape
    assert got.dtype == want.dtype or name == "segment_sums"
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    elif name == "segment_scan":
        tol = 1e-5 * np.cumsum(np.abs(args[0].astype(np.float64))) + 1e-6
        assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    elif name == "decode_attention":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    elif name in ("stencil1d", "stencil1d_exact", "segment_stencil"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


# the kernels that compute their plain version's float32 operations in the
# same order: bitwise equal on the card (the exact modes' divide too)
BITWISE = ("stencil1d", "stencil1d_exact", "segment_stencil")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_on_card(card, name, n):
    spec = treg.get(name)
    for dtype in DTYPES[name]:
        rng = np.random.default_rng(hash((name, n, np.dtype(dtype).num)) % 2**31)
        for args in _cases(name, rng, n, dtype):
            dargs = tuple(a.to(card) if isinstance(a, torch.Tensor) else a
                          for a in map(_to_torch, args))
            got = spec.kernel(*dargs)
            want = spec.plain(*dargs)
            torch.cuda.synchronize()
            to_np = (lambda t: tuple(v.cpu().numpy() for v in t)) \
                if isinstance(got, tuple) else (lambda t: t.cpu().numpy())
            _assert_same(name, args, to_np(got), to_np(want))
            if name in BITWISE:
                assert torch.equal(got, want), (name, n, args[2:])


# decode_attention at the reference's shapes (B, S, Hkv, G, hd) and at the
# LM decode path's (qwen3-0.6b, 32 requests, a 2304-row cache), with the
# per-row lengths the kernel's loop must get right: one row, either side of
# the reference's 512-row blocks, and the full cache.  Both compute in
# float32 and round once to q's dtype: within 2e-5 (the reference's float32
# tolerance between its kernel and its oracle) plus, in bfloat16, one
# rounding step of the output, |got - want| <= 2^-7 |want| + 2e-5.
DECODE_SHAPES = ((1, 128, 2, 2, 32), (2, 512, 2, 4, 64), (4, 1024, 8, 7, 64),
                 (2, 700, 4, 1, 32), (32, 2304, 8, 2, 128))
DECODE_LENGTHS = (1, 511, 512, 513, 2048, 2304)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_matches_plain_on_card(card, shape, dtype):
    b, s, hkv, g, hd = shape
    tdt, rtol = (torch.float32, 0.0) if dtype == "float32" else (torch.bfloat16, 2.0 ** -7)
    gen = torch.Generator(device=card).manual_seed(b * s + g)
    q = torch.randn((b, hkv, g, hd), device=card, generator=gen).to(tdt)
    k, v = (torch.randn((b, s, hkv, hd), device=card, generator=gen).to(tdt)
            for _ in range(2))
    length = torch.randint(1, s + 1, (b,), device=card, generator=gen,
                           dtype=torch.int32)
    if s == 2304:
        length[:len(DECODE_LENGTHS)] = torch.tensor(DECODE_LENGTHS)
    for lens in (length, torch.full_like(length, s)):
        spec = treg.get("decode_attention")
        got, want = spec.kernel(q, k, v, lens), spec.plain(q, k, v, lens)
        torch.cuda.synchronize()
        assert got.dtype == tdt and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-5)


@pytest.mark.cuda
def test_lm_decode_on_card_matches_cpu(card):
    """Two layers at qwen3-0.6b's widths in float32: prefill and four decode
    steps on the card (the decode_attention kernel) agree with the same
    weights on the CPU (its plain version) within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_config("qwen3-0.6b").replace(n_layers=2, vocab=4096,
                                           param_dtype="float32",
                                           compute_dtype="float32")
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.init_params(cfg, seed=0, device="cpu").to(card)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    toks = [rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32) for _ in range(4)]
    outs = []
    launched = cuda.launches["decode_attention"]
    for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
        logits, caches = steps.make_prefill_step(cfg, 20)(
            model, {"tokens": torch.from_numpy(prompt).to(dev)})
        out = [logits]
        for t in toks:
            logits, caches = steps.make_decode_step(cfg)(
                model, torch.from_numpy(t).to(dev), caches)
            out.append(logits)
        outs.append(torch.stack(out, 1).cpu())
    assert cuda.launches["decode_attention"] - launched == 4 * cfg.n_layers
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-4)


# The look-back scans (csrc/lookback.cuh: prefix_sum, segment_scan,
# segment_rank) on their hazards, at every size above and at one whose
# tiles look back past a window of 32: a view whose data is not 16-byte
# aligned (x[1:] of a fresh tensor, the WORDS fetch); two calls back to back
# on other inputs of one length (the freed status words come back from the
# allocator and must be cleared); one segment head at row 0 and none after
# it (no tile restarts); int32 sums that wrap past 2^31 (exact modulo 2^32).
# Integer values throughout, so float32 sums are exact and every comparison
# is bitwise.
HAZARDS = ("misaligned", "back_to_back", "one_head", "wrap")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES + (33 * 5120 + 5,))
@pytest.mark.parametrize("hazard", HAZARDS)
def test_lookback_hazards_on_card(card, hazard, n):
    from repro_torch.kernels.segment_rank import segment_rank as rk
    from repro_torch.kernels.segment_scan import segment_scan as ss
    from repro_torch.kernels.stream_compact import stream_compact as sc

    rng = np.random.default_rng(n * len(HAZARDS) + HAZARDS.index(hazard))

    def values(m, dtype):
        return torch.from_numpy(rng.integers(-50, 50, m).astype(dtype)).to(card)

    def masks(m):
        seg = _seg_mask(rng, m)
        ordb = np.maximum(seg, (rng.random(m) < 0.3).astype(np.int32))
        return torch.from_numpy(seg).to(card), torch.from_numpy(ordb).to(card)

    def sums_equal(x, got):
        assert torch.equal(got, sc.prefix_sum_plain(x)), (hazard, n, x.dtype)

    def ranks_equal(seg, ordb, got):
        for kind, g in zip(RANK_KINDS, got):
            assert torch.equal(g, rk.segment_rank_plain(seg, ordb, kind)), \
                (hazard, n, kind)

    def ranks(seg, ordb):
        return [rk.segment_rank_cuda(seg, ordb, kind) for kind in RANK_KINDS]

    def scans_equal(x, seg, got):
        assert torch.equal(got, ss.segment_scan_plain(x, seg)), \
            (hazard, n, x.dtype)

    if hazard == "misaligned":
        for dtype in (np.int32, np.float32):
            x = values(n + 1, dtype)[1:]
            assert n == 0 or x.data_ptr() % 16 != 0   # empty: no data
            sums_equal(x, sc.prefix_sum_cuda(x))
        seg, ordb = (t[1:] for t in masks(n + 1))
        ranks_equal(seg, ordb, ranks(seg, ordb))
        for dtype in (np.int32, np.float32):
            x = values(n + 1, dtype)[1:]
            scans_equal(x, seg, ss.segment_scan_cuda(x, seg))
    elif hazard == "back_to_back":
        for dtype in (np.int32, np.float32):
            xs = [values(n, dtype) for _ in range(2)]
            got = [sc.prefix_sum_cuda(x) for x in xs]
            for x, g in zip(xs, got):
                sums_equal(x, g)
        pairs = [masks(n) for _ in range(2)]
        got = [ranks(*p) for p in pairs]
        for p, g in zip(pairs, got):
            ranks_equal(*p, g)
        for dtype in (np.int32, np.float32):
            xs = [values(n, dtype) for _ in range(2)]
            got = [ss.segment_scan_cuda(x, p[0]) for x, p in zip(xs, pairs)]
            for x, p, g in zip(xs, pairs, got):
                scans_equal(x, p[0], g)
    elif hazard == "one_head":
        seg = torch.zeros(n, dtype=torch.int32, device=card)
        seg[:1] = 1
        ordb = seg | torch.from_numpy(
            (rng.random(n) < 0.3).astype(np.int32)).to(card)
        ranks_equal(seg, ordb, ranks(seg, ordb))
        for dtype in (np.int32, np.float32):
            x = values(n, dtype)
            scans_equal(x, seg, ss.segment_scan_cuda(x, seg))
    else:
        x = torch.from_numpy(rng.integers(-2**30, 2**30, n).astype(np.int32)).to(card)
        c = torch.cumsum(x.long(), 0)
        want = ((c + 2**31) % 2**32 - 2**31).int()
        got = sc.prefix_sum_cuda(x)
        assert torch.equal(got, want), (hazard, n)
        sums_equal(x, got)
        # one head at row 0: the segmented sums are the same wrapped sums
        seg = torch.zeros(n, dtype=torch.int32, device=card)
        seg[:1] = 1
        got = ss.segment_scan_cuda(x, seg)
        assert torch.equal(got, want), (hazard, n, "segment_scan")
        scans_equal(x, seg, got)


# f32 look-back scans give the same bits on every call (csrc/lookback.cuh,
# ORDERED): 20 calls on non-integer values over many tiles, the segmented
# scan with heads every ~64 rows and with one head at row 0.
@pytest.mark.cuda
@pytest.mark.parametrize("n", (4 * 5120 + 3, 40 * 5120 + 17))
@pytest.mark.parametrize("name", ("prefix_sum", "segment_scan", "segment_scan_one_head"))
def test_f32_scans_repeat_bitwise_on_card(card, name, n):
    from repro_torch.kernels.segment_scan import segment_scan as ss
    from repro_torch.kernels.stream_compact import stream_compact as sc

    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(card)
    seg = torch.from_numpy(_seg_mask(rng, n, 1 / 64)).to(card)
    if name == "segment_scan_one_head":
        seg.zero_()
        seg[0] = 1
    call = (lambda: sc.prefix_sum_cuda(x)) if name == "prefix_sum" \
        else (lambda: ss.segment_scan_cuda(x, seg))
    first = call()
    bits = first.view(torch.int32)
    for _ in range(19):
        assert torch.equal(call().view(torch.int32), bits), (name, n)
    want = (sc.prefix_sum_plain(x) if name == "prefix_sum"
            else ss.segment_scan_plain(x, seg))
    tol = 1e-5 * torch.cumsum(x.abs().double(), 0) + 1e-4
    assert bool(((first.double() - want.double()).abs() <= tol).all()), (name, n)


# bucket_scatter (csrc/bucket_scatter.cu: one launch, a look-back over P
# counts across tiles of 12288 rows, 16384 above 256 buckets) at its tile's
# edges and at 40 tiles (long look-backs), for P from 1 to the kernel's
# limit: random ids with invalid rows (dest == P) scattered and as a tail;
# every row in one bucket; every row invalid; a view not 16-byte aligned
# (the WORDS fetch); two calls back to back on other inputs of one length
# (the freed status words come back from the allocator and must be
# cleared).  Counts exact, slots exact wherever dest < P.
def bucket_tile(P):
    return 12288 if P <= 256 else 16384


BUCKET_SIZES = {"one": lambda t: 1, "tile-1": lambda t: t - 1,
                "tile": lambda t: t, "tile+1": lambda t: t + 1,
                "3tiles+5": lambda t: 3 * t + 5, "40tiles+3": lambda t: 40 * t + 3}
BUCKET_PS = (1, 2, 8, 256, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(BUCKET_SIZES))
@pytest.mark.parametrize("P", BUCKET_PS)
def test_bucket_scatter_hazards_on_card(card, P, size):
    from repro_torch.kernels.hash_partition import hash_partition as hp

    n = BUCKET_SIZES[size](bucket_tile(P))
    rng = np.random.default_rng(P * 1009 + n)

    def ids(m, invalid=1 / 6):
        d = rng.integers(0, P, m).astype(np.int32)
        d[rng.random(m) < invalid] = P
        return torch.from_numpy(d).to(card)

    def held(d, got=None):
        r1, c1 = got if got is not None else hp.bucket_scatter_cuda(d, P)
        r2, c2 = hp.bucket_scatter_plain(d, P)
        ok = d < P
        assert torch.equal(c1, c2), (P, n)
        assert torch.equal(r1[ok], r2[ok]), (P, n)

    tail = ids(n)
    tail[n - n // 5:] = P
    for d in (ids(n), tail, ids(n, 0.0),
              torch.full((n,), P - 1, dtype=torch.int32, device=card),
              torch.full((n,), P, dtype=torch.int32, device=card)):
        held(d)
    v = ids(n + 1)[1:]
    assert v.data_ptr() % 16 != 0
    held(v)
    a, b = ids(n), ids(n, 0.0)
    ga, gb = hp.bucket_scatter_cuda(a, P), hp.bucket_scatter_cuda(b, P)
    held(a, ga)
    held(b, gb)


@pytest.mark.cuda
def test_bucket_scatter_limits_on_card(card):
    """The library's tiles and bucket limit are the ones the wrapper and
    these tests assume; P above the limit is refused; an empty input gives
    zero counts; one call counts one launch."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.hash_partition import hash_partition as hp

    lib = cuda.load("bucket_scatter")
    assert all(lib.bucket_scatter_tile(P) == bucket_tile(P)
               for P in BUCKET_PS + (255, 257))
    assert lib.bucket_scatter_max_p() == hp.MAX_P
    d = torch.zeros(100, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="outside"):
        hp.bucket_scatter_cuda(d, hp.MAX_P + 1)
    slot, counts = hp.bucket_scatter_cuda(d[:0], 5)
    assert slot.shape == (0,) and counts.tolist() == [0] * 5
    before = cuda.launches["bucket_scatter"]
    slot, counts = hp.bucket_scatter_cuda(d, hp.MAX_P)
    assert cuda.launches["bucket_scatter"] == before + 1
    assert counts[0].item() == 100 and slot.tolist() == list(range(100))


# segment_sums (csrc/segment_sums.cu: one launch, a look-back over 5120-row
# tiles taken by as many blocks as the card holds) on the hazards of its
# contract, at every size above and at a few tiles with ragged ends, with
# count given on the card: against the plain version on the named slots,
# within 1e-4 of the run's sum of |x| (+1e-5); also on a view not 16-byte
# aligned (the guarded fetch) and two calls back to back on other inputs of
# one length (the freed status words come back from the allocator and must
# be cleared).
SUMS_SIZES = SIZES + (3 * 5120 + 7, 33 * 5120 + 5)


def _sums_on_card(card, case):
    values, sid, valid, num, count = case
    c = None if count is None else torch.tensor(count, dtype=torch.int32,
                                                device=card)
    return (torch.from_numpy(values).to(card), torch.from_numpy(sid).to(card),
            torch.from_numpy(valid).to(card), num, c)


def _sums_held(args, got, tag):
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    vals, sid, valid, num, count = args
    slots = torch.from_numpy(_named(None, sid.cpu().numpy(), None, num,
                                    count)).to(vals.device).long()
    want = sr.segment_sums_plain(vals, sid, valid, num, count)[slots]
    mag = sr.segment_sums_plain(vals.abs(), sid, valid, num, count)[slots]
    d = (got[slots] - want).abs()
    assert bool((d <= 1e-4 * mag + 1e-5).all()), tag


@pytest.mark.cuda
@pytest.mark.parametrize("n", SUMS_SIZES)
@pytest.mark.parametrize("hazard", SUMS_HAZARDS)
def test_segment_sums_hazards_on_card(card, hazard, n):
    from repro_torch.kernels.segment_reduce import segment_reduce as sr

    rng = np.random.default_rng(n * len(SUMS_HAZARDS)
                                + SUMS_HAZARDS.index(hazard))
    args = _sums_on_card(card, _sums_case(hazard, rng, n))
    _sums_held(args, sr.segment_sums_cuda(*args), (hazard, n))
    vals, sid, valid, num, count = args
    if n:
        views = [torch.cat([t[:1], t])[1:] for t in (vals, sid, valid)]
        assert views[0].data_ptr() % 16 != 0
        _sums_held((*views, num, count),
                   sr.segment_sums_cuda(*views, num, count),
                   (hazard, n, "misaligned"))
    other = _sums_on_card(card, _sums_case(hazard, rng, n))
    ga, gb = sr.segment_sums_cuda(*args), sr.segment_sums_cuda(*other)
    _sums_held(args, ga, (hazard, n, "back to back, first"))
    _sums_held(other, gb, (hazard, n, "back to back, second"))


# segment_sums gives the same bits on every call (the ORDERED fold): 20
# calls on the partial stage's shape (runs of ~32768 rows, so a run spans
# tiles) and on one run over every row.
@pytest.mark.cuda
@pytest.mark.parametrize("n", (40 * 5120 + 17, 1 << 22))
@pytest.mark.parametrize("shape", ("partial", "one_run"))
def test_segment_sums_repeats_bitwise_on_card(card, shape, n):
    from repro_torch.kernels.segment_reduce import segment_reduce as sr

    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(card)
    groups = max(n // 32768, 1) if shape == "partial" else 1
    sid = (torch.arange(n, device=card) * groups // n).int()
    valid = torch.ones(n, dtype=torch.bool, device=card)
    count = torch.tensor(n, dtype=torch.int32, device=card)
    first = sr.segment_sums_cuda(vals, sid, valid, n, count)[:groups]
    for _ in range(19):
        got = sr.segment_sums_cuda(vals, sid, valid, n, count)[:groups]
        assert torch.equal(got.view(torch.int32), first.view(torch.int32)), \
            (shape, n)
    _sums_held((vals, sid, valid, n, count), sr.segment_sums_cuda(
        vals, sid, valid, n, count), (shape, n))


@pytest.mark.cuda
def test_sort_rebalance_persist_on_card_match_cpu(card):
    """A global sort (one key ascending, two keys descending, a head), a
    stencil over a filtered series (a Rebalance under it) and a persisted
    frame re-entered by a group-by, through hf on the card (prefix_sum,
    segment_sums, stencil1d) and on the CPU (their plain versions): the
    same rows, exact but for the float sums (rtol 1e-5, atol 1e-5) and the
    stencil (rtol 1e-6, atol 1e-6)."""
    from repro_torch import hiframes as hf
    from repro_torch.kernels import cuda

    rng = np.random.default_rng(20)
    n = 50_000
    t = {"id": rng.integers(0, 300, n).astype(np.int32),
         "x": rng.normal(size=n).astype(np.float32),
         "y": rng.integers(-9, 9, n).astype(np.float32)}

    def frames(cfg):
        df = hf.table(t)
        f = df[df["x"] > 0.0]
        p = df.groupby("id").agg(s=("x", "sum"), n=("x", "count")).persist(cfg)
        assert p.node.layout.device_valid(1)
        dev = next(iter(p.node.columns.values())).device
        assert dev.type == cfg.device
        return {"sort": df.sort_values("x"),
                "sort_desc_head": df.sort_values(("y", "id"),
                                                 ascending=False).head(999),
                "sma_after_filter": hf.sma(f, f["x"], 3, out="s"),
                "persisted": p.groupby("id").agg(m=("s", "max"),
                                                 c=("n", "sum"))}

    launched = dict(cuda.launches)
    on_card = {k: v.collect(hf.ExecConfig()).to_numpy()
               for k, v in frames(hf.ExecConfig()).items()}
    cpu = hf.ExecConfig(device="cpu")
    on_cpu = {k: v.collect(cpu).to_numpy() for k, v in frames(cpu).items()}
    for name in ("prefix_sum", "segment_sums", "stencil1d"):
        assert cuda.launches[name] > launched.get(name, 0), name
    tol = {"s": (1e-6, 1e-6), "m": (1e-5, 1e-5)}
    for q, want in on_cpu.items():
        got = on_card[q]
        assert sorted(got) == sorted(want), q
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            if k in tol:
                np.testing.assert_allclose(got[k], want[k], rtol=tol[k][0],
                                           atol=tol[k][1], err_msg=q + k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=q + k)


# the frame path's queries (FRAME_SRC), at sizes that fill several of the
# kernels' tiles
FRAME_SIZES = dict(n_clicks=60_000, n_items=2000, n_users=900, n_sales=50_000,
                   n_cust=700)


def _frame_queries():
    from torch_frame_queries import FRAME_SRC
    fr: dict = {}
    exec(FRAME_SRC, fr)
    return fr


FRAME_NAMES = ("q05_string", "q05_int", "q09_channel", "frame_verbs",
               "null_rows", "concat_channels", "merge_category_keys")


@pytest.mark.cuda
@pytest.mark.parametrize("name", FRAME_NAMES)
def test_frame_query_on_card_matches_cpu(card, name):
    """Each frame-path query through hf on the card (prefix_sum,
    segment_sums, bucket_scatter where the plan exchanges) and on the CPU
    (their plain versions): the same columns, dtypes and rows, ints and
    dictionary codes exact, the float sums and means within rtol 1e-5,
    atol 1e-5; the card's rows, decoded, equal the numpy oracle."""
    from repro_torch import hiframes as hf
    from repro_torch.core import dtypes as tdt
    fr = _frame_queries()
    assert name in fr["FRAME_QUERIES"]
    d = fr["frame_data"](**FRAME_SIZES)
    build = fr["FRAME_QUERIES"][name]
    frame = build(hf, d)
    t = frame.collect(hf.ExecConfig())
    assert not t.overflow
    got = t.to_numpy()
    want = build(hf, d).collect(hf.ExecConfig(device="cpu")).to_numpy()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        if np.issubdtype(want[k].dtype, np.floating):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=name + k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=name + k)
    for c, dt in frame.schema.items():
        if tdt.is_category(dt):
            got[c] = tdt.dict_decode(got[c], tdt.categories_of(dt))
    fr["assert_frame_result"](name, got, d)


@pytest.mark.cuda
def test_frame_path_on_card_launches_its_kernels(card):
    """The string filters and dropna compact through prefix_sum; the float
    sums and means of q09_channel and frame_verbs reduce through
    segment_sums."""
    from repro_torch import hiframes as hf
    from repro_torch.kernels import cuda
    fr = _frame_queries()
    d = fr["frame_data"](**FRAME_SIZES)
    before = dict(cuda.launches)
    for name in ("q09_channel", "frame_verbs", "null_rows"):
        fr["FRAME_QUERIES"][name](hf, d).collect(hf.ExecConfig())
    torch.cuda.synchronize()
    for k in ("prefix_sum", "segment_sums"):
        assert cuda.launches[k] > before.get(k, 0), k


@pytest.mark.cuda
def test_frame_recode_lut_on_card_strided_and_without_sync(card):
    """The recode and fill closures on a non-contiguous view of codes on
    the card: the LUT moves once, from pinned memory, and no call waits on
    the card (CUDA sync debug mode "error" raises on a synchronizing
    call)."""
    from repro_torch.core import api
    lut = np.array([2, 0, 3], np.int32)
    host = torch.tensor([0, 9, -1, 9, 2, 9, 1, 9], dtype=torch.int32)
    c = host.to(card)[::2]
    assert not c.is_contiguous()
    recode, fill = api._recode_fn(lut), api._recode_fn(lut, fill=1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [recode(c), recode(c), fill(c), api._fill_code_fn(4)(c)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = [[2, -1, 3, 0], [2, -1, 3, 0], [2, 1, 3, 0], [0, 4, 2, 1]]
    assert [o.cpu().tolist() for o in outs] == want
    assert all(o.device == c.device and o.dtype == torch.int32 for o in outs)
    assert [o.tolist() for o in (recode(host[::2]), fill(host[::2]))] \
        == want[1:3]


# the segmentation path's queries (SEG_SRC): UDFs, free arrays, group-by
# sugar, transform and head, at sizes that fill several of the kernels' tiles
SEG_SIZES = dict(n_sales=200_000, n_items=5000, n_cust=20_000, n_rows=60_000)


def _seg_queries():
    from torch_segmentation_queries import SEG_SRC
    z: dict = {}
    exec(SEG_SRC, z)
    return z


SEG_NAMES = ("q26_features", "transform_mean", "transform_sum",
             "transform_named", "head2", "sugar_mean", "sugar_size",
             "ext_filter", "ext_assign_agg", "ext_agg")


def _same_rows(got, want, keys, tag):
    """The same columns and dtypes; rows ordered by ``keys``, ints exact,
    floats within rtol 1e-5, atol 1e-3 (sums of ~25000 N(0, 1) values,
    |s| ~ 160, added in another order)."""
    assert sorted(got) == sorted(want), tag
    order = [np.lexsort([d[k] for k in reversed(keys)]) for d in (got, want)]
    for k in want:
        g, w = got[k][order[0]], want[k][order[1]]
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, k)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3,
                                       err_msg=tag + k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=tag + k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEG_NAMES)
def test_segmentation_query_on_card_matches_cpu(card, name):
    """Each segmentation query through hf on the card and on the CPU: the
    same rows and dtypes; the card's rows equal the numpy oracle's."""
    from repro_torch import hiframes as hf
    z = _seg_queries()
    assert name in z["SEG_QUERIES"]
    d = z["seg_data"](**SEG_SIZES)
    build = z["SEG_QUERIES"][name]
    t = build(hf, d).collect(hf.ExecConfig())
    assert not t.overflow
    got = t.to_numpy()
    want = build(hf, d).collect(hf.ExecConfig(device="cpu")).to_numpy()
    _same_rows(got, want, z["SEG_KEYS"][name], name)
    z["assert_seg_result"](name, got, d, atol=1e-2)


@pytest.mark.cuda
def test_segmentation_path_on_card_launches_its_kernels(card):
    """The UDF filter and the collect-block rebalance compact through
    prefix_sum, the float means reduce through segment_sums, head numbers
    rows through segment_rank."""
    from repro_torch import hiframes as hf
    from repro_torch.kernels import cuda
    z = _seg_queries()
    d = z["seg_data"](**SEG_SIZES)
    before = dict(cuda.launches)
    z["q26_features"](hf, d).collect_matrix(list(z["FEATURES"]),
                                            hf.ExecConfig())
    for name in ("transform_mean", "head2"):
        z["SEG_QUERIES"][name](hf, d).collect(hf.ExecConfig())
    torch.cuda.synchronize()
    for k in ("prefix_sum", "segment_sums", "segment_rank"):
        assert cuda.launches[k] > before.get(k, 0), k


@pytest.mark.cuda
def test_segmentation_matrix_and_kmeans_on_card_match_cpu(card):
    """collect_matrix on the card holds the CPU's valid rows bitwise; each
    K-means step on the card from the CPU's centroids gives the same
    assignment and centroids within rtol 1e-5 (TF32 off)."""
    from repro_torch import hiframes as hf
    z = _seg_queries()
    d = z["seg_data"](**SEG_SIZES)
    feats = list(z["FEATURES"])
    frame = z["q26_features"](hf, d)
    mg, cg, capg = frame.collect_matrix(feats, hf.ExecConfig())
    mc, cc, capc = frame.collect_matrix(feats, hf.ExecConfig(device="cpu"))
    assert mg.is_cuda and mg.dtype == torch.float32
    assert cg.tolist() == cc.tolist() and capg == capc
    n = int(cc[0])
    assert torch.equal(mg[:n].cpu(), mc[:n])
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xg, xc = mg[:n], mc[:n]
        cent = xc[:8].clone()
        for _ in range(5):
            ng, ag = z["kmeans_step"](xg, cent.to(card))
            nc, ac = z["kmeans_step"](xc, cent)
            assert torch.equal(ag.cpu(), ac)
            np.testing.assert_allclose(ng.cpu().numpy(), nc.numpy(),
                                       rtol=1e-5, atol=1e-6)
            cent = nc
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.cuda
def test_segmentation_free_arrays_on_card(card):
    """A free array on the card and the same array on the host give the
    same rows; a UDF closing over a card tensor types as float32 (its
    probe on CPU tensors fails, as the reference's trace would) and its
    column still holds the right values."""
    from repro_torch import hiframes as hf
    z = _seg_queries()
    d = z["seg_data"](**SEG_SIZES)
    t, ext = d["grp"], d["ext"]
    df = hf.table(t, "grp")
    host = df[df.x > ext].collect(hf.ExecConfig()).to_numpy()
    dev = df[df.x > torch.from_numpy(ext).to(card)].collect(
        hf.ExecConfig()).to_numpy()
    for k in host:
        np.testing.assert_array_equal(host[k], dev[k])
    np.testing.assert_array_equal(np.sort(host["x"]),
                                  np.sort(t["x"][t["x"] > ext]))
    lut = torch.arange(100, 109, dtype=torch.int32, device=card)
    f = df.assign(z=hf.udf(lambda g: torch.take(lut, g.long()), df.g))
    assert f.schema["z"] == np.dtype(np.float32)
    out = f.collect(hf.ExecConfig()).to_numpy()
    np.testing.assert_array_equal(out["z"].astype(np.int64),
                                  100 + out["g"].astype(np.int64))


# -- the guardrails on the card ----------------------------------------------


def _skewed_tables(n=40_000, m=900, seed=7):
    """tests/test_skew.py's shape: 35 % of the probe rows on key 3."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, m, n).astype(np.int32)
    k[: int(0.35 * n)] = 3
    rng.shuffle(k)
    probe = {"k": k, "v": rng.normal(size=n).astype(np.float32)}
    dim = {"k": np.arange(m, dtype=np.int32),
           "w": rng.normal(size=m).astype(np.float32)}
    return probe, dim


@pytest.mark.cuda
def test_kernel_fault_raises_typed_error_on_card(card):
    """An injected fail_kernel on the card's prefix_sum raises the typed
    KernelBackendError out of collect(): no retry runs the plain version in
    its place, and no table comes back."""
    from repro_torch import hiframes as hf
    from repro_torch.core.errors import KernelBackendError
    from repro_torch.runtime import FaultPlan

    rng = np.random.default_rng(3)
    t = {"k": rng.integers(0, 23, 5000).astype(np.int32),
         "v": rng.normal(size=5000).astype(np.float32)}
    df = hf.table(t)
    q = df[df["v"] > -0.3].groupby("k").agg(s=("v", "sum"))
    got = None
    with pytest.raises(KernelBackendError, match="prefix_sum") as ei:
        got = q.collect(hf.ExecConfig(fault_inject=FaultPlan(
            fail_kernel="prefix_sum")))
    assert got is None
    assert ei.value.kernel == "prefix_sum" and ei.value.backend == "cuda"


@pytest.mark.cuda
def test_salted_join_and_guardrails_on_card_match_cpu(card):
    """The salted skew join (prefix_sum launched by the build side's
    compaction), a validated aggregate, a forced overflow and a healed
    corruption, on the card and on the CPU: the same rows, plans and
    events, and no invariant failure."""
    from repro_torch import hiframes as hf
    from repro_torch.core import stats
    from repro_torch.kernels import cuda
    from repro_torch.runtime import FaultPlan, clear_events

    probe, dim = _skewed_tables()
    rng = np.random.default_rng(11)
    agg = {"k": rng.integers(0, 23, 6000).astype(np.int32),
           "v": rng.normal(size=6000).astype(np.float32)}

    def runs(device):
        stats.clear_realized()
        clear_events()
        kw = {"device": device}
        j = hf.table(probe, "probe").merge(hf.table(dim, "dim"), on="k")
        a = hf.table(agg, "a").groupby("k").agg(s=("v", "sum"),
                                                n=("v", "count"))
        out = {}
        for name, frame, extra in (
                ("salted", j, dict(adaptive_stats=True)),
                ("validate", a, dict(validate=True)),
                ("forced", a, dict(fault_inject=FaultPlan(
                    force_overflow=("HashExchange",)))),
                ("corrupt", a, dict(validate=True, fault_inject=FaultPlan(
                    corrupt_exchange=("HashExchange",))))):
            cfg = hf.ExecConfig(**kw, **extra)
            t = frame.collect(cfg)
            assert not t.overflow and t.invariant_failures == (), name
            # events without their detail: a checksum there sums the
            # partial float sums, whose bits differ between the devices
            out[name] = (t.to_numpy(), [(e.kind, e.attempt, e.op_id)
                                        for e in t.events],
                         frame.physical_plan(cfg).render())
        return out

    before = cuda.launches["prefix_sum"]
    on_card = runs("cuda")
    assert cuda.launches["prefix_sum"] > before
    on_cpu = runs("cpu")
    assert "Salt[build]" in on_card["salted"][2]
    assert [e[0] for e in on_card["forced"][1]] == ["retry"]
    assert [e[0] for e in on_card["corrupt"][1]] == ["degrade_packed"]
    for name, (want, events, plan) in on_cpu.items():
        got = on_card[name][0]
        assert on_card[name][1:] == (events, plan), name
        # rows ordered by their exact columns, the key the most significant
        exact = [c for c in sorted(want, reverse=True) if c != "s"]
        og = np.lexsort([got[c] for c in exact])
        ow = np.lexsort([want[c] for c in exact])
        for c in want:
            if c == "s":
                np.testing.assert_allclose(got[c][og], want[c][ow],
                                           rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(got[c][og], want[c][ow],
                                              err_msg=name + c)


@pytest.mark.cuda
def test_serve_session_on_card_matches_cpu(card):
    """The serving session on the card: "cuda" pinned to the current card
    in the session's config and in every worker thread; the serve mix's
    two passes (pass 2 all hits, no Lowered built, the same rows), a
    rebound second table, and a 4-shard state merged on the card, each
    against the same session on the CPU."""
    import threading

    from repro_torch import hiframes as hf
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.runtime.reshard import reshard
    from repro_torch.runtime.session import Session

    def runs(device):
        with Session(hf.ExecConfig(device=device), workers=2) as sess:
            if device == "cuda":
                assert sess.cfg.device == f"cuda:{torch.cuda.current_device()}"
                seen = [sess._pool.submit(torch.cuda.current_device).result()
                        for _ in range(4)]
                assert seen == [torch.cuda.current_device()] * 4, seen
                assert threading.current_thread() is threading.main_thread()
            ss, it = serve.register_tables(sess, 0.5)
            mix = serve.build_mix(sess)
            p1 = serve.run_pass(sess, mix, 1)
            p2 = serve.run_pass(sess, mix, 1)
            assert serve.smoke_failures(
                p1, p2, p1["collectives"]
                + sess.stats()["register_collectives"]) == []
            serve.register_tables(sess, 0.5, name="b", tables=(
                serve.make_tables(0.5, seed=7)[0], None))
            pb = serve.run_pass(sess, serve.build_mix(sess, sales="b"), 1)
            assert pb["hits"] == 3 and pb["built"] == 0
            n = len(ss["ss_item_sk"])
            lay = dict(kind="block", partitioned_by=(), ascending=True,
                       globally_sorted=False, sorted_by=(),
                       order_ascending=True, counts=[n // 2 + 1, n - n // 2 - 1],
                       capacity=n // 2 + 2, nshards=2, dist="1D_VAR")
            cols = {c: np.concatenate([v[:n // 2 + 1], np.zeros(1, v.dtype),
                                       v[n // 2 + 1:], np.zeros(3, v.dtype)])
                    for c, v in ss.items()}
            r1 = reshard(hf.from_persisted_state(cols, lay, device=device),
                         1, sess.cfg)
            merged = {c: v[:n].cpu().numpy() for c, v in r1.node.columns.items()}
            return ([t.to_numpy() for t in p1["tables"] + p2["tables"]
                     + pb["tables"]], merged, ss)

    before = cuda.launches["segment_sums"]
    on_card, merged, ss = runs("cuda")
    assert cuda.launches["segment_sums"] > before
    on_cpu, merged_cpu, _ = runs("cpu")
    for c, v in ss.items():
        np.testing.assert_array_equal(merged[c], v)
        np.testing.assert_array_equal(merged_cpu[c], v)
    keys = ("ss_customer_sk", "ss_item_sk", "ss_customer_sk") * 3
    for i, (got, want) in enumerate(zip(on_card, on_cpu)):
        og = np.argsort(got[keys[i]], kind="stable")
        ow = np.argsort(want[keys[i]], kind="stable")
        for c in want:
            if c in ("paid", "spend"):
                np.testing.assert_allclose(got[c][og], want[c][ow],
                                           rtol=1e-4, atol=1e-2)
            elif c != "r":
                np.testing.assert_array_equal(got[c][og], want[c][ow],
                                              err_msg=f"{i}.{c}")
    for a, b in zip(on_card[:3], on_card[3:6]):          # pass 2 = pass 1
        for c in a:
            assert a[c].tobytes() == b[c].tobytes(), c


# The training path: the train step, a checkpoint and the token
# pipeline on the card against the CPU.

@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(card):
    """Two layers at qwen3-0.6b's widths (vocab cut to 4096) in float32 with
    TF32 off: the gradient and one train step from the same weights and
    batch on the card and on the CPU.  Every gradient leaf agrees within
    1e-4 x its largest |g| (the bound the CPU tests hold against jax.grad),
    and the step's loss and the loss of the batch after the step within
    1e-5 relative (summation order only)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, adamw

    cfg = get_config("qwen3-0.6b").replace(n_layers=2, vocab=4096,
                                           param_dtype="float32",
                                           compute_dtype="float32")
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 65)).astype(np.int32)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.LM(cfg, lm.tree_map(lambda t: t.detach().to(card, copy=True),
                                        cpu_model.tree()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
            batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                     "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
            _, grads = steps.value_and_grad(steps.make_loss_fn(cfg),
                                            model.tree(), batch)
            state = {"params": model.tree(),
                     "opt": adamw.init_state(model.tree(), ocfg)}
            state, loss = steps.make_train_step(cfg, ocfg)(state, batch)
            with torch.no_grad():
                after = lm.loss_fn(state["params"], batch, cfg)
            out.append((float(loss), float(after), state, grads))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, ac, sc, gc), (lg, ag, sg, gg) = out
    assert abs(lg / lc - 1) <= 1e-5 and abs(ag / ac - 1) <= 1e-5, (lc, lg, ac, ag)
    assert int(sg["opt"]["step"]) == 1 and sg["opt"]["step"].device.type == "cuda"
    for (path, x), (_, y) in zip(lm.leaves(gg), lm.leaves(gc)):
        assert x.device.type == "cuda"
        err = float((x.cpu() - y).abs().max())
        assert err <= 1e-4 * float(y.abs().max()), (path, err)


@pytest.mark.cuda
def test_checkpoint_from_cpu_restores_on_card_bitwise(card, tmp_path):
    """A bf16 train state saved from the CPU restores onto the card with
    the same bits, in place into a live state there."""
    from repro_torch.checkpoint import copy_into, restore, save
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, adamw

    cfg = get_reduced("qwen3-0.6b")
    ocfg = OptConfig(use_master=True)
    model = lm.init_params(cfg, seed=0, device="cpu")
    state = {"params": model.tree(), "opt": adamw.init_state(model.tree(), ocfg)}
    state["opt"]["step"].fill_(4)
    save(str(tmp_path), 4, state)
    live_model = lm.init_params(cfg, seed=1, device=card)
    live = {"params": live_model.tree(),
            "opt": adamw.init_state(live_model.tree(), ocfg)}
    tree, step, _ = restore(str(tmp_path), live)
    assert step == 4
    wq = live["params"]["layers"]["attn"]["wq"]
    copy_into(live, tree)
    assert live["params"]["layers"]["attn"]["wq"] is wq
    bits = {2: torch.int16, 4: torch.int32}
    for (path, x), (_, y) in zip(lm.leaves(live), lm.leaves(state)):
        assert x.device.type == "cuda" and x.dtype == y.dtype, path
        if x.dtype.is_floating_point:
            x, y = x.view(bits[x.element_size()]), y.view(bits[y.element_size()])
        assert torch.equal(x.cpu(), y), path
    assert torch.equal(live_model.blocks[1].attn["wq"].cpu().view(torch.int16),
                       model.blocks[1].attn["wq"].view(torch.int16))


@pytest.mark.cuda
def test_token_pipeline_on_card_matches_cpu(card):
    """The token pipeline's plan on the card (prefix_sum launched) gives the
    CPU's curated rows, offsets, bucket statistics and batches exactly."""
    from repro_torch import hiframes as hf
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.data.synth import token_corpus
    from repro_torch.kernels import cuda

    corpus = token_corpus(20_000, 4096)
    pcfg = PipelineConfig(vocab=4096, seq_len=32, global_batch=4)
    launched = cuda.launches["prefix_sum"]
    on_card = TokenPipeline(corpus, pcfg)
    on_cpu = TokenPipeline(corpus, pcfg, hf.ExecConfig(device="cpu"))
    try:
        assert cuda.launches["prefix_sum"] > launched
        for name in ("doc_len", "doc_seed", "doc_offset"):
            assert np.array_equal(getattr(on_card, name), getattr(on_cpu, name)), name
        assert on_card.total_tokens == on_cpu.total_tokens
        for k, v in on_cpu.bucket_stats.items():
            order_a = np.argsort(on_card.bucket_stats["bucket"])
            order_b = np.argsort(on_cpu.bucket_stats["bucket"])
            assert np.array_equal(on_card.bucket_stats[k][order_a], v[order_b]), k
        for _ in range(2):
            a, b = next(on_card), next(on_cpu)
            assert all(np.array_equal(a[k], b[k]) for k in a)
    finally:
        on_card.close()
        on_cpu.close()


# The moe family: each MoE layer's ranks within its experts come from
# bucket_scatter at P = E.

@pytest.mark.cuda
@pytest.mark.parametrize("P", [64, 384])
@pytest.mark.parametrize("n", [96, 12 * 517, 196_608])
def test_bucket_scatter_at_moe_shapes_matches_plain(card, P, n):
    """Each token's top 6 distinct experts, as a MoE layer routes them:
    slots and counts on the card equal to the plain version's."""
    from repro_torch.kernels.hash_partition import hash_partition as hp
    k = 6
    g = torch.Generator(device=card).manual_seed(n + P)
    dest = torch.rand((n // k, P), device=card, generator=g).argsort(1)[:, :k]
    dest = dest.reshape(-1).to(torch.int32).contiguous()
    got = hp.bucket_scatter_cuda(dest, P)
    want = hp.bucket_scatter_plain(dest.cpu(), P)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def _moe_inputs(cfg, seed, b=3, s=40):
    rng = np.random.default_rng(seed)
    from repro_torch.models import lm, moe

    def draw(shape):
        return torch.from_numpy(
            (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(np.float32))
    p = lm.tree_map(draw, moe.moe_param_shapes(cfg))
    x = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(np.float32))
    return p, x


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_block_on_card_matches_cpu(card, arch, capacity_factor):
    """A reduced config's MoE block in float32 (TF32 off) on the card and
    on the CPU from the same weights and input: the same experts, slots and
    counts, one bucket_scatter launch a call, out and aux within 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import cuda
    from repro_torch.models import lm, moe

    cfg = get_reduced(arch).replace(capacity_factor=capacity_factor,
                                    param_dtype="float32", compute_dtype="float32")
    p, x = _moe_inputs(cfg, 4)
    pc = lm.tree_map(lambda t: t.to(card), p)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want_r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
        want, want_aux = moe.moe_block(p, x, cfg)
        before = cuda.launches["bucket_scatter"]
        got_r = moe.route(pc, x.to(card).reshape(-1, cfg.d_model), cfg)
        got, aux = moe.moe_block(pc, x.to(card), cfg)
        assert cuda.launches["bucket_scatter"] == before + 2
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(got_r.topi.cpu(), want_r.topi)
    assert torch.equal(got_r.slot.cpu(), want_r.slot)
    assert torch.equal(got_r.counts.cpu(), want_r.counts)
    assert got_r.C == want_r.C
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-5


@pytest.mark.cuda
def test_moe_prefill_and_decode_on_card_match_cpu(card):
    """deepseek-moe-16b reduced (head_dim 32) in float32 (TF32 off): prefill
    and 3 decode steps on the card (decode_attention and bucket_scatter
    launched) and on the CPU from the same weights: logits and caches
    within 1e-4."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import cuda
    from repro_torch.launch import steps
    from repro_torch.models import lm

    # head_dim 32, one of the decode kernel's own row layouts
    cfg = get_reduced("deepseek-moe-16b").replace(
        head_dim=32, param_dtype="float32", compute_dtype="float32")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.LM(cfg, lm.tree_map(lambda t: t.to(card, copy=True),
                                        cpu_model.tree()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
            tokens = torch.from_numpy(toks).to(dev)
            before = dict(cuda.launches)
            logits, caches = steps.make_prefill_step(cfg, 9)(
                model, {"tokens": tokens[:, :6]})
            seq = [logits]
            for i in range(6, 9):
                logits, caches = steps.make_decode_step(cfg)(
                    model, tokens[:, i:i + 1], caches)
                seq.append(logits)
            launched = {k: cuda.launches[k] - before[k] for k in before}
            out.append((torch.stack(seq, 1).cpu(), caches, launched))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, cc, _), (lg, cg, launched) = out
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert launched["bucket_scatter"] == n_moe * 4
    assert launched["decode_attention"] == cfg.n_layers * 3
    assert float((lg - lc).abs().max()) <= 1e-4
    for name in lm.stacks(cfg):
        for k in ("k", "v"):
            assert float((cg[name][k].cpu() - cc[name][k]).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_moe_train_step_on_card_matches_cpu(card, remat, capacity_factor):
    """deepseek-moe-16b reduced in float32 (TF32 off), from the same weights
    and batch on the card and on the CPU: the loss (cross entropy + 0.01
    aux) within 1e-5 relative and every gradient leaf within 1e-4 x its
    largest |g|.  The gradient runs back through the dispatch (index_put),
    the combine's gather and, with remat, the routing recomputed in the
    backward pass: one bucket_scatter a MoE layer in the forward, one more
    in the recomputation."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import cuda
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = get_reduced("deepseek-moe-16b").replace(
        remat=remat, capacity_factor=capacity_factor,
        param_dtype="float32", compute_dtype="float32")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    cpu_model = lm.init_params(cfg, seed=1, device="cpu")
    card_model = lm.LM(cfg, lm.tree_map(lambda t: t.detach().to(card, copy=True),
                                        cpu_model.tree()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
            batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                     "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
            before = cuda.launches["bucket_scatter"]
            loss, grads = steps.value_and_grad(steps.make_loss_fn(cfg),
                                               model.tree(), batch)
            out.append((float(loss), grads,
                        cuda.launches["bucket_scatter"] - before))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, gc, _), (lg, gg, launched) = out
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert launched == n_moe * (2 if remat == "block" else 1)
    assert abs(lg / lc - 1) <= 1e-5, (lc, lg)
    for (path, x), (_, y) in zip(lm.leaves(gg), lm.leaves(gc)):
        assert x.device.type == "cuda"
        err = float((x.cpu() - y).abs().max())
        assert err <= 1e-4 * float(y.abs().max()), (path, err)
    assert float(gc["layers"]["moe"]["router"].abs().max()) > 0


# The ssm and hybrid families: decode_attention at the hybrid's head width
# (zamba2-7b: 3584 / 32 = 112), at 96 and at 40, in the 128-wide row layout
# with the lanes past hd idle, against its plain version; then
# each family's train step, and the hybrid's prefill and decode, on the
# card against the CPU.
WIDE_SHAPES = ((1, 128, 2, 2), (4, 700, 4, 3), (8, 2112, 32, 1))
WIDE_LENGTHS = (1, 2, 63, 64, 65, 511, 512, 513, 2047, 2112)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("hd", (112, 96, 40))
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_wide_heads_match_plain_on_card(card, shape, hd, dtype):
    """As test_decode_attention_matches_plain_on_card, at hd 112, 96, 40:
    random and full lengths, and at the hybrid's decode shape every edge of
    WIDE_LENGTHS."""
    b, s, hkv, g = shape
    tdt, rtol = (torch.float32, 0.0) if dtype == "float32" else (torch.bfloat16, 2.0 ** -7)
    gen = torch.Generator(device=card).manual_seed(b * s + g + hd)
    q = torch.randn((b, hkv, g, hd), device=card, generator=gen).to(tdt)
    k, v = (torch.randn((b, s, hkv, hd), device=card, generator=gen).to(tdt)
            for _ in range(2))
    length = torch.randint(1, s + 1, (b,), device=card, generator=gen,
                           dtype=torch.int32)
    spec = treg.get("decode_attention")
    cases = [length, torch.full_like(length, s)]
    if s == 2112:
        cases += [torch.full_like(length, n) for n in WIDE_LENGTHS]
    for lens in cases:
        got, want = spec.kernel(q, k, v, lens), spec.plain(q, k, v, lens)
        torch.cuda.synchronize()
        assert got.dtype == tdt and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-5)


@pytest.mark.cuda
def test_decode_attention_refuses_other_head_widths_on_card(card):
    """hd must be a multiple of one 16-byte load's values (8 in bfloat16, 4
    in float32) up to 128: anything else raises, with no fallback."""
    spec = treg.get("decode_attention")
    for hd, dt in ((100, torch.bfloat16), (102, torch.float32),
                   (136, torch.float32), (256, torch.bfloat16)):
        q = torch.zeros((1, 1, 1, hd), device=card, dtype=dt)
        k = torch.zeros((1, 4, 1, hd), device=card, dtype=dt)
        with pytest.raises(ValueError, match="hd"):
            spec.kernel(q, k, k, torch.ones(1, device=card, dtype=torch.int32))
    q = torch.zeros((1, 1, 1, 100), device=card, dtype=torch.float32)
    k = torch.zeros((1, 4, 1, 100), device=card, dtype=torch.float32)
    got = spec.kernel(q, k, k, torch.ones(1, device=card, dtype=torch.int32))
    assert got.shape == q.shape


# decode_attention's split over S (csrc/decode_attention.cu): shapes its
# split_plan splits, in both dtypes, at lengths 1, 2, either side of every
# split's first row (the rows a split's last row and the next split's first
# row ± 1) and S, every row at one length and at lengths that differ by row;
# then 20 calls on the same inputs, which must give the same bits (the
# splits are folded in a fixed order, with no atomics).
SPLIT_SHAPES = ((1, 8192, 1, 8, 128), (16, 2176, 2, 6, 128), (2, 4097, 2, 4, 64),
                (3, 700, 1, 3, 112))


def _split_lengths(s, splits, rows):
    edges = {1, 2, s - 1, s}
    for i in range(1, splits):
        edges |= {i * rows + d for d in (-2, -1, 0, 1)}
    return sorted(n for n in edges if 1 <= n <= s)


def _decode_inputs(card, shape, tdt, seed):
    b, s, hkv, g, hd = shape
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((b, hkv, g, hd), device=card, generator=gen).to(tdt)
    k, v = (torch.randn((b, s, hkv, hd), device=card, generator=gen).to(tdt)
            for _ in range(2))
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_split_edges_match_plain_on_card(card, shape, dtype):
    from repro_torch.kernels.decode_attention import decode_attention as da
    b, s, hkv, g, hd = shape
    tdt, rtol = (torch.float32, 0.0) if dtype == "float32" else (torch.bfloat16, 2.0 ** -7)
    q, k, v = _decode_inputs(card, shape, tdt, b * s + g + hd)
    splits, rows = da.split_plan(b, hkv, s, g, hd, q.element_size(),
                                 da.sm_count(torch.cuda.current_device()))
    assert splits > 1, (shape, dtype)
    lengths = _split_lengths(s, splits, rows)
    spec = treg.get("decode_attention")
    cases = [torch.full((b,), n, device=card, dtype=torch.int32) for n in lengths]
    cases += [torch.tensor([lengths[(i * 7 + j) % len(lengths)] for j in range(b)],
                           device=card, dtype=torch.int32) for i in range(4)]
    for lens in cases:
        got, want = spec.kernel(q, k, v, lens), spec.plain(q, k, v, lens)
        torch.cuda.synchronize()
        assert got.dtype == tdt and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-5,
                                   msg=lambda m: f"lengths {lens.tolist()}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", SPLIT_SHAPES[:2] + ((32, 1500, 8, 1, 64),),
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_repeats_bitwise_on_card(card, shape, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    bits = torch.int32 if dtype == "float32" else torch.int16
    q, k, v = _decode_inputs(card, shape, tdt, 5)
    b, s = shape[:2]
    gen = torch.Generator(device=card).manual_seed(6)
    length = torch.randint(1, s + 1, (b,), device=card, generator=gen,
                           dtype=torch.int32)
    length[0] = s
    spec = treg.get("decode_attention")
    first = spec.kernel(q, k, v, length).view(bits)
    for _ in range(19):
        assert torch.equal(spec.kernel(q, k, v, length).view(bits), first)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((16, 2176, 2, 6, 128), (32, 1500, 8, 1, 64)),
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_in_a_cuda_graph_on_card(card, shape):
    """A call reads no device value on the host and does not synchronise
    (eager calls under the sync debug mode "error"), and replays inside a
    CUDA graph: new inputs copied into the captured tensors give the plain
    version's result (a split shape, with its workspace and combine, and
    one with a single split)."""
    b, s = shape[:2]
    spec = treg.get("decode_attention")
    q, k, v = _decode_inputs(card, shape, torch.bfloat16, 8)
    length = torch.full((b,), s, device=card, dtype=torch.int32)
    spec.kernel(q, k, v, length)                  # the plan, the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            spec.kernel(q, k, v, length)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = spec.kernel(q, k, v, length)
    q2, k2, v2 = _decode_inputs(card, shape, torch.bfloat16, 9)
    for t, new in ((q, q2), (k, k2), (v, v2)):
        t.copy_(new)
    length.copy_(torch.randint(1, s + 1, (b,), device=card, dtype=torch.int32))
    graph.replay()
    torch.cuda.synchronize()
    want = spec.plain(q, k, v, length)
    torch.testing.assert_close(out.float(), want.float(), rtol=2.0 ** -7, atol=2e-5)


def _ssm_hold_cfg(arch):
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch).replace(param_dtype="float32", compute_dtype="float32")
    # zamba2 at 3 layers, period 2: one group and a tail (2 shared applications)
    return cfg.replace(n_layers=2) if cfg.family == "ssm" else \
        cfg.replace(n_layers=3, shared_attn_period=2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_train_step_on_card_matches_cpu(card, arch):
    """The ssm and hybrid families reduced, in float32 (TF32 off), remat as
    trained: the gradient and one train step from the same weights and
    batch on the card and on the CPU; every gradient leaf within 1e-4 x its
    largest |g|, the losses within 1e-5 relative."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, adamw

    cfg = _ssm_hold_cfg(arch)
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 41)).astype(np.int32)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.LM(cfg, lm.tree_map(lambda t: t.detach().to(card, copy=True),
                                        cpu_model.tree()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
            batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                     "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}
            _, grads = steps.value_and_grad(steps.make_loss_fn(cfg),
                                            model.tree(), batch)
            state = {"params": model.tree(),
                     "opt": adamw.init_state(model.tree(), ocfg)}
            state, loss = steps.make_train_step(cfg, ocfg)(state, batch)
            with torch.no_grad():
                after = lm.loss_fn(state["params"], batch, cfg)
            out.append((float(loss), float(after), grads))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, ac, gc), (lg, ag, gg) = out
    assert abs(lg / lc - 1) <= 1e-5 and abs(ag / ac - 1) <= 1e-5, (lc, lg, ac, ag)
    for (path, x), (_, y) in zip(lm.leaves(gg), lm.leaves(gc)):
        assert x.device.type == "cuda"
        err = float((x.cpu() - y).abs().max())
        assert err <= 1e-4 * float(y.abs().max()), (path, err)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-7b"])
def test_ssm_prefill_and_decode_on_card_match_cpu(card, arch):
    """Prefill and 3 decode steps on the card and on the CPU from the same
    float32 weights (TF32 off): logits and every cache entry within 1e-4;
    the hybrid's steps launch decode_attention once a shared application
    (its reduced hd 16 in the 128-wide row layout), the ssm's never."""
    from repro_torch.kernels import cuda
    from repro_torch.launch import steps
    from repro_torch.models import lm

    cfg = _ssm_hold_cfg(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 21)).astype(np.int32)
    cpu_model = lm.init_params(cfg, seed=0, device="cpu")
    card_model = lm.LM(cfg, lm.tree_map(lambda t: t.to(card, copy=True),
                                        cpu_model.tree()))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
            tokens = torch.from_numpy(toks).to(dev)
            before = cuda.launches["decode_attention"]
            logits, caches = steps.make_prefill_step(cfg, 21)(
                model, {"tokens": tokens[:, :18]})
            seq = [logits]
            for i in range(18, 21):
                logits, caches = steps.make_decode_step(cfg)(
                    model, tokens[:, i:i + 1], caches)
                seq.append(logits)
            out.append((torch.stack(seq, 1).cpu(), caches,
                        cuda.launches["decode_attention"] - before))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, cc, _), (lg, cg, launched) = out
    _, groups, tail = lm.shared_groups(cfg)
    assert launched == (0 if cfg.family == "ssm" else 3 * (groups + (tail > 0)))
    assert float((lg - lc).abs().max()) <= 1e-4
    conv, h = cg["layers"]
    assert float((conv.cpu() - cc["layers"][0]).abs().max()) <= 1e-4
    assert float((h.cpu() - cc["layers"][1]).abs().max()) <= 1e-4
    for name, c in cg.get("shared", {}).items():
        for k in ("k", "v"):
            assert float((c[k].cpu() - cc["shared"][name][k]).abs().max()) <= 1e-4


# The vlm and encdec families: decode_attention at their decode shapes (B,
# S, Hkv, G, hd): qwen2-vl-2b's self-attention over 16 requests' 2176-row
# caches (2 KV heads: 32 blocks on 132 SMs), whisper-base's self-attention
# over 32 requests' 128 rows and its cross-attention over 1500 frames at
# length F; then each family's prefill and decode on the card against the
# CPU.
FAMILY_SHAPES = ((16, 2176, 2, 6, 128), (32, 1500, 8, 1, 64), (32, 128, 8, 1, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", FAMILY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_family_shapes_match_plain_on_card(card, shape, dtype):
    """As test_decode_attention_matches_plain_on_card: random lengths, every
    row full (the cross-attention's F), and one row, either side of 512 and
    of the cache's end where the cache holds them."""
    b, s, hkv, g, hd = shape
    tdt, rtol = (torch.float32, 0.0) if dtype == "float32" else (torch.bfloat16, 2.0 ** -7)
    gen = torch.Generator(device=card).manual_seed(b * s + g + hd)
    q = torch.randn((b, hkv, g, hd), device=card, generator=gen).to(tdt)
    k, v = (torch.randn((b, s, hkv, hd), device=card, generator=gen).to(tdt)
            for _ in range(2))
    length = torch.randint(1, s + 1, (b,), device=card, generator=gen,
                           dtype=torch.int32)
    edges = [n for n in (1, 2, 511, 512, 513, s - 1, s) if 1 <= n <= s]
    cases = [length, torch.full_like(length, s)] + [torch.full_like(length, n)
                                                    for n in edges]
    spec = treg.get("decode_attention")
    for lens in cases:
        got, want = spec.kernel(q, k, v, lens), spec.plain(q, k, v, lens)
        torch.cuda.synchronize()
        assert got.dtype == tdt and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-base"])
def test_family_prefill_and_decode_on_card_match_cpu(card, arch):
    """The reduced config in float32 (TF32 off): a prefill (qwen2-vl: stub
    embeddings with distinct M-RoPE streams; whisper: frames and a 4-token
    prompt) and 3 decode steps on the card and on the CPU from the same
    weights; logits within 1e-4, and decode_attention launched once a layer
    and step (twice for whisper: self and cross)."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import cuda
    from repro_torch.launch import steps
    from repro_torch.models import lm, whisper

    cfg = get_reduced(arch).replace(param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(2)
    encdec = cfg.family == "encdec"
    cpu_model = (whisper if encdec else lm).init_params(cfg, seed=0, device="cpu")
    card_model = type(cpu_model)(cfg, lm.tree_map(lambda t: t.to(card, copy=True),
                                                  cpu_model.tree()))
    if encdec:
        batch = {"frames": rng.normal(size=(2, cfg.enc_frames, cfg.d_model)),
                 "tokens": rng.integers(0, cfg.vocab, (2, 4))}
    else:
        pos = np.stack([np.arange(12), np.arange(12) % 5, np.arange(12)[::-1]])
        batch = {"inputs_embeds": rng.normal(size=(2, 12, cfg.d_model)),
                 "positions": np.broadcast_to(pos[:, None], (3, 2, 12))}
    batch = {k: torch.from_numpy(np.ascontiguousarray(
        v, np.float32 if v.dtype.kind == "f" else np.int32)) for k, v in batch.items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 2, 1)).astype(np.int32))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        for model, dev in ((cpu_model, torch.device("cpu")), (card_model, card)):
            before = cuda.launches["decode_attention"]
            logits, caches = steps.make_prefill_step(cfg, 16)(
                model, {k: v.to(dev) for k, v in batch.items()})
            seq = [logits]
            for t in toks:
                logits, caches = steps.make_decode_step(cfg)(model, t.to(dev), caches)
                seq.append(logits)
            out.append((torch.stack(seq, 1).cpu(),
                        cuda.launches["decode_attention"] - before))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, _), (lg, launched) = out
    assert launched == 3 * cfg.n_layers * (2 if encdec else 1)
    assert float((lg - lc).abs().max()) <= 1e-4


# decode_attention over a cache sharded along S (a model axis of M ranks):
# each block's partial (max, sum, numerator in float32) from the split
# kernel, whatever the split plan, and the M partials folded in rank order
# by the combine kernel.  Shapes (B, S_loc, Hkv, G, hd): a rank's block at
# the tp_serve path's lm and moe shapes (one split each), a block that
# splits, and hd 112; lengths that leave a block empty, end inside one, and
# fill it.  The partial's fields within 1e-4 relative of the plain
# version's (its numerators and sums scale with exp(m) of a max that
# rounds in another order); merged outputs as decode_attention's.
PARTIAL_SHAPES = ((32, 1088, 8, 2, 128), (16, 1088, 16, 1, 128), (16, 1088, 2, 6, 128),
                  (3, 700, 1, 3, 112))


def _partial_lengths(b, s, m):
    total = m * s
    base = [1, s - 1, s, s + 1, total - 1, total]
    return torch.tensor([base[i % len(base)] for i in range(b)], dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("shape", PARTIAL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_partial_merge_match_plain_on_card(card, shape, dtype):
    b, s, hkv, g, hd = shape
    m = 2
    tdt, rtol = (torch.float32, 0.0) if dtype == "float32" else (torch.bfloat16, 2.0 ** -7)
    q, k, v = _decode_inputs(card, (b, m * s, hkv, g, hd), tdt, b + s + hd)
    length = _partial_lengths(b, s, m).to(card)
    part, merge = treg.get("decode_attention_partial"), treg.get("decode_attention_merge")
    got, want = [], []
    for r in range(m):
        kb, vb = (t[:, r * s:(r + 1) * s].contiguous() for t in (k, v))
        lb = torch.clamp(length - r * s, 0, s).to(torch.int32)
        got.append(part.kernel(q, kb, vb, lb))
        want.append(part.plain(q, kb, vb, lb))
    torch.cuda.synchronize()
    for gp, wp in zip(got, want):
        assert gp.dtype == torch.float32 and gp.shape == (b, hkv, g, hd + 2)
        assert bool(torch.isfinite(gp).all())
        empty = wp[..., -1] == 0
        assert torch.equal(gp[..., -1] == 0, empty)
        assert bool((gp[..., -2][empty] == -1e30).all())
        scale = wp.abs().amax(-1, keepdim=True).clamp(min=1e-30)
        off = ((gp - wp).abs() / scale)[~empty]
        assert off.numel() == 0 or float(off.max()) <= 1e-4
    parts = torch.stack(got)
    out = merge.kernel(parts, dtype=tdt)
    torch.testing.assert_close(out.float(), merge.plain(parts, tdt).float(),
                               rtol=rtol, atol=2e-5)
    torch.testing.assert_close(out.float(),
                               treg.get("decode_attention").plain(q, k, v, length).float(),
                               rtol=rtol, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PARTIAL_SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_decode_attention_partial_merge_repeat_bitwise_on_card(card, shape):
    b, s, hkv, g, hd = shape
    q, k, v = _decode_inputs(card, shape, torch.bfloat16, 12)
    length = _partial_lengths(b, s, 1).to(card).clamp(max=s)
    part, merge = treg.get("decode_attention_partial"), treg.get("decode_attention_merge")
    first = part.kernel(q, k, v, length)
    parts = torch.stack([first, torch.flip(first, (0,))])
    out = merge.kernel(parts, dtype=torch.bfloat16).view(torch.int16)
    for _ in range(19):
        assert torch.equal(part.kernel(q, k, v, length), first)
        assert torch.equal(merge.kernel(parts, dtype=torch.bfloat16).view(torch.int16), out)
