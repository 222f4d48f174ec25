"""segment_sums with a valid prefix: the port's plain version against the
reference's two backends, its wrapper's refusals, and the one caller,
``segment_aggregate``, passing its count.

The reference takes no count, so it gets the prefix as rows past count made
invalid and routed to the dropped slot.  Its Pallas wrapper
(``ops.segment_sums``, run in interpret mode) takes differences of a prefix
scan at the last VALID row of each run, so it holds only where every run
that names a slot has valid rows up to its end: every hazard but ``holes``,
which goes to ``ref.segment_sums_ref`` alone.  Slots are compared where a
row of the prefix names them (the rest are undefined in both the Pallas
wrapper and the CUDA kernel), within the reference's own tolerance between
its backends, rtol 1e-4 and atol 1e-3.  The hazards and the named slots are
shared with tests/test_torch_cuda.py, which holds the kernel against this
plain version on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import physical as rphys  # noqa: E402
from repro.kernels.segment_reduce import ops as rops  # noqa: E402
from repro.kernels.segment_reduce import ref as rref  # noqa: E402
from repro_torch.core import physical as tphys  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from repro_torch.kernels.segment_reduce import segment_reduce as sr  # noqa: E402
from test_torch_cuda import SUMS_HAZARDS, _named, _sums_case  # noqa: E402

# empty, one row, the look-back's 5120-row tile and its edges, a few tiles
# with a ragged end
SIZES = (0, 1, 5119, 5120, 5121, 3 * 5120 + 7)


def _reference_inputs(seg_id, valid, num_segments, count):
    """The prefix as the reference takes it: rows past count invalid, their
    ids the dropped slot num_segments."""
    n = len(seg_id)
    live = np.arange(n) < (n if count is None else count)
    return (np.where(live, seg_id, num_segments).astype(np.int32),
            valid & live)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("hazard", SUMS_HAZARDS)
def test_plain_with_count_matches_reference(hazard, n):
    rng = np.random.default_rng(n * len(SUMS_HAZARDS)
                                + SUMS_HAZARDS.index(hazard))
    values, sid, valid, num, count = _sums_case(hazard, rng, n)
    c = None if count is None else torch.tensor(count, dtype=torch.int32)
    got = sr.segment_sums_plain(torch.from_numpy(values), torch.from_numpy(sid),
                                torch.from_numpy(valid), num, c).numpy()
    assert got.shape == (num,) and got.dtype == np.float32
    slots = _named(values, sid, valid, num, count)
    rsid, rvalid = _reference_inputs(sid, valid, num, count)
    args = (jnp.asarray(values), jnp.asarray(rsid), jnp.asarray(rvalid), num)
    backends = [rref.segment_sums_ref]
    if hazard != "holes":
        backends.append(lambda *a: rops.segment_sums(*a, interpret=True))
    for backend in backends:
        want = np.asarray(backend(*args))
        np.testing.assert_allclose(got[slots], want[slots], rtol=1e-4,
                                   atol=1e-3)
    # a slot no row of the prefix names is 0 in the plain version
    unnamed = np.setdiff1d(np.arange(num), slots)
    assert not got[unnamed].any()


def test_registry_contract_takes_count():
    plain = treg.resolve("cpu").segment_sums
    x = torch.tensor([1.0, 2.0, 4.0, 8.0])
    sid = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True])
    got = plain(x, sid, valid, 2, torch.tensor(3, dtype=torch.int32))
    assert got.tolist() == [3.0, 4.0]
    assert plain(x, sid, valid, 2).tolist() == [3.0, 12.0]


REFUSALS = {
    "cpu_tensors": (None, "CUDA tensor"),
    "count_int64": (torch.tensor(3, dtype=torch.int64), "count dtype"),
    "count_1d": (torch.tensor([3], dtype=torch.int32), "count must be 0-D"),
    "count_on_cpu": (torch.tensor(3, dtype=torch.int32), "count must be a CUDA"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_cuda_wrapper_refuses(case):
    """A CPU tensor never takes the plain version through the kernel's
    wrapper; a count of the wrong dtype or shape is refused before any
    device check, so the refusal shows without a card."""
    count, match = REFUSALS[case]
    x = torch.zeros(8)
    sid = torch.zeros(8, dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match=match):
        sr.segment_sums_cuda(x, sid, valid, 4, count)


# segment_aggregate over a valid prefix that ends inside a run, around the
# look-back tile, with NaN skipping: the float sums and their derived means
# and spreads go through segment_sums with the count.
AGG_SIZES = ((240, 220), (5121, 5119), (2 * 5120 + 9, 5120))


class _Spy:
    """A CPU kernel set whose segment_sums records the count it is given."""

    def __init__(self):
        self.counts = []
        self._cpu = treg.resolve("cpu")

    def __getattr__(self, name):
        return getattr(self._cpu, name)

    def segment_sums(self, values, seg_id, valid, num_segments, count=None):
        self.counts.append(None if count is None else int(count))
        return self._cpu.segment_sums(values, seg_id, valid, num_segments,
                                      count)


@pytest.mark.parametrize("size", AGG_SIZES, ids=lambda s: f"{s[0]}-{s[1]}")
@pytest.mark.parametrize("fn", ("sum", "mean", "var", "std"))
def test_segment_aggregate_passes_count(fn, size):
    n, count = size
    rng = np.random.default_rng(n + count)
    keys = np.sort(rng.integers(0, max(n // 700, 3), n)).astype(np.int32)
    x = rng.normal(size=n).astype(np.float32)
    x[rng.random(n) < 0.2] = np.nan
    x[keys == 1] = np.nan                # an all-null group
    spec = (fn, "nan")
    spy = _Spy()
    got, gn, _ = tphys.segment_aggregate(
        torch.from_numpy(keys), torch.tensor(count, dtype=torch.int32),
        {"o": (fn, torch.from_numpy(x), True, "nan")}, cap_out=64,
        kernels=spy)
    want, wn, _ = rphys.segment_aggregate(
        jnp.asarray(keys), jnp.int32(count),
        {"o": (spec[0], jnp.asarray(x), True, spec[1])}, cap_out=64)
    assert int(gn) == int(wn)
    assert spy.counts and all(c == count for c in spy.counts)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-3)
