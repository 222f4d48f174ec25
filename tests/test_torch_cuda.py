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

SIZES = (0, 1, 2047, 2048, 2049, 5000)
NAMES = ("prefix_sum", "bucket_scatter", "segment_sums")
P_BUCKETS = 8


def _values(rng, n, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-50, 50, n).astype(dtype)
    return rng.normal(size=n).astype(dtype)


def _case(name, rng, n, dtype):
    """Numpy arguments of one primitive call (the reference's parity cases)."""
    if name == "prefix_sum":
        return (_values(rng, n, dtype),)
    if name == "bucket_scatter":
        dest = rng.integers(0, P_BUCKETS, n).astype(np.int32)
        if n > 4:                     # some invalid rows (dest == P)
            dest[rng.choice(n, size=n // 6, replace=False)] = P_BUCKETS
        return (dest, P_BUCKETS)
    # segment_sums: ids sorted and consecutive over the valid prefix, the
    # invalid tail routed to the overflow slot, as segment_aggregate does
    nvalid = n - n // 5
    starts = (rng.random(nvalid) < 0.15).astype(np.int32)
    if nvalid:
        starts[0] = 1
    sid = (np.cumsum(starts) - 1).astype(np.int32)
    nseg = int(sid[-1]) + 1 if nvalid else 1
    sid = np.concatenate([sid, np.full(n - nvalid, nseg, np.int32)])
    return (_values(rng, n, dtype), sid, np.arange(n) < nvalid, nseg)


DTYPES = {"prefix_sum": (np.int32, np.float32), "bucket_scatter": (np.int32,),
          "segment_sums": (np.float32,)}


def _to_torch(a):
    return torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(name, args, got, want):
    if name == "bucket_scatter":
        ok = args[0] < args[1]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0][ok], want[0][ok])
        return
    if name == "segment_sums":
        got, want = got[: args[3]], want[: args[3]]
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype or name == "segment_sums"


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
        args = _case(name, rng, n, dtype)
        dargs = tuple(a.to(card) if isinstance(a, torch.Tensor) else a
                      for a in map(_to_torch, args))
        got = spec.kernel(*dargs)
        want = spec.plain(*dargs)
        torch.cuda.synchronize()
        to_np = (lambda t: tuple(v.cpu().numpy() for v in t)) \
            if isinstance(got, tuple) else (lambda t: t.cpu().numpy())
        _assert_same(name, args, to_np(got), to_np(want))
