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
