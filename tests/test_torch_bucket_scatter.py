"""bucket_scatter without a card: the plain version against the reference,
and the CUDA wrapper's refusals that come before anything is built.

The plain version (a stable argsort plus a bincount) is what the CPU
executors run and what the CUDA kernel (csrc/bucket_scatter.cu) is held
against on a card (tests/test_torch_cuda.py, chip_smoke.py).  Here it is
held against the reference's argsort backend (``bucket_ranks_argsort``) at
every bucket count the kernel takes, up to its limit of 2048, around its
tiles, and against the reference's Pallas kernel (``bucket_ranks``,
interpret mode) at small P and at P = 2048 on a few blocks.  Counts are
exact; slots exact wherever ``dest < P`` (the slots of invalid rows are
don't-care in both packages).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.hash_partition import ops as rops  # noqa: E402
from repro.kernels.hash_partition import ref as rref  # noqa: E402
from repro_torch.kernels.hash_partition import hash_partition as hp  # noqa: E402

PS = (1, 2, 8, 255, 256, 1024, 2048)
# the kernel's tiles: 12288 rows up to 256 buckets, 16384 above
SIZES = (0, 1, 12287, 12288, 12289, 16385, 3 * 16384 + 5)
# random ids with invalid rows scattered; 80 % of the rows in one heavy
# bucket; every row in one bucket; an invalid tail of a fifth of the rows
KINDS = ("random", "heavy", "one_bucket", "invalid_tail")


def _dest(rng, n, P, kind):
    d = rng.integers(0, P + 1, n).astype(np.int32)       # P: invalid
    if kind == "heavy":
        d[rng.random(n) < 0.8] = P // 2
    elif kind == "one_bucket":
        d[:] = P - 1
    elif kind == "invalid_tail":
        d[n - n // 5:] = P
    return d


def _assert_same(d, P, got, want):
    ok = d < P
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[0])[ok], np.asarray(want[0])[ok])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", PS)
def test_plain_matches_reference_argsort(P, kind):
    rng = np.random.default_rng(P * len(KINDS) + KINDS.index(kind))
    for n in SIZES:
        d = _dest(rng, n, P, kind)
        got = hp.bucket_scatter_plain(torch.from_numpy(d), P)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
        assert got[0].shape == (n,) and got[1].shape == (P,)
        _assert_same(d, P, tuple(t.numpy() for t in got),
                     rref.bucket_ranks_argsort(jnp.asarray(d), P))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", (1, 2, 8, 64, 2048))
def test_plain_matches_reference_pallas_interpret(P, kind):
    rng = np.random.default_rng(1000 + P * len(KINDS) + KINDS.index(kind))
    for n in (5, 2500):
        d = _dest(rng, n, P, kind)
        got = hp.bucket_scatter_plain(torch.from_numpy(d), P)
        _assert_same(d, P, tuple(t.numpy() for t in got),
                     rops.bucket_ranks(jnp.asarray(d), P, interpret=True))


def test_plain_slots_are_stable():
    """Slots enumerate each bucket's rows in row order (the reference's
    stable-slot example)."""
    d = torch.tensor([1, 0, 1, 1, 0, 2, 1, 3], dtype=torch.int32)
    slot, counts = hp.bucket_scatter_plain(d, 3)
    assert slot[:7].tolist() == [0, 0, 1, 2, 1, 0, 3]
    assert counts.tolist() == [2, 4, 1]


_D = torch.zeros(16, dtype=torch.int32)
REFUSALS = {
    "cpu_tensor": ((_D, 8), "CUDA tensor"),
    "int64": ((_D.long(), 8), "dtype"),
    "two_dims": ((_D.view(4, 4), 8), "1-D"),
    "strided": ((_D[::2], 8), "contiguous"),
    "p_zero": ((_D, 0), "P=0 outside"),
    "p_above_limit": ((_D, hp.MAX_P + 1), f"P={hp.MAX_P + 1} outside"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cuda_wrapper_refuses_without_a_card(case):
    """The wrapper never falls back to the plain version: what it does not
    take is refused before the library is built or loaded."""
    args, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        hp.bucket_scatter_cuda(*args)
