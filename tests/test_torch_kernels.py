"""Kernel parity: the port's plain versions against the reference's ref
backends AND its Pallas kernels in interpret mode, on the same numpy inputs.

Sizes include 0 and the tile edges around 2048 (the reference's), 4096 (the
stencil kernel's) and 5120 (the look-back scans'); dtypes int32 and float32,
with bool covered through the physical layer; stencils with 1, 3, 5 and 20
taps, and at the 4096 edges every segment stencil of 1, 3, 7 and 20 taps at
centres 0, K // 2 and K - 1, exact on and off; rank kinds all three.
Integers are exact; the tolerances of floats are stated at ``_assert_same``
in tests/test_torch_cuda.py (the window kernels' tighter than the
reference's rtol=1e-4, atol=1e-3 between its backends,
tests/test_kernel_registry.py). ``segment_sums`` is compared on the slots
a row of the prefix names only (the reference's Pallas wrapper and the CUDA
kernel leave the others undefined; tests/test_torch_segment_sums.py holds
its valid prefix) and ``bucket_scatter`` slots only where ``dest < P``. The inputs and
comparisons are shared with tests/test_torch_cuda.py, which holds the CUDA
kernels against these plain versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import physical as rphys  # noqa: E402
from repro.kernels import registry as rreg  # noqa: E402
from repro_torch.core import physical as tphys  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402
from test_torch_cuda import (DTYPES, NAMES, SIZES, _assert_same,  # noqa: E402
                             _cases, _np, _to_torch)


def _to_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def test_registry_has_the_main_path_primitives():
    assert set(treg.names()) == set(NAMES)
    assert treg.resolve("cpu").prefix_sum is treg.get("prefix_sum").plain
    assert treg.resolve("cuda").prefix_sum is treg.get("prefix_sum").kernel


# the reference keeps decode_attention outside its registry; its plain
# version is held in tests/test_torch_decode_attention.py
REF_NAMES = tuple(n for n in NAMES if n != "decode_attention")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", REF_NAMES)
def test_plain_matches_reference_backends(name, n):
    plain = getattr(treg.resolve("cpu"), name)
    ref = getattr(rreg.resolve("off"), name)
    spec = rreg.get(name)
    for dtype in DTYPES[name]:
        rng = np.random.default_rng(hash((name, n, np.dtype(dtype).num)) % 2**31)
        for args in _cases(name, rng, n, dtype):
            got = _np(plain(*map(_to_torch, args)))
            jargs = tuple(map(_to_jax, args))
            _assert_same(name, args, got, _np(ref(*jargs)))
            _assert_same(name, args, got,
                         _np(spec.pallas(*jargs, interpret=True)))


def test_bool_values_via_physical_layer():
    """Bool keep flags and bool sums route through int32 casts in the
    physical layer: compact and the group-by sum agree with the reference."""
    rng = np.random.default_rng(5)
    n = 400
    keep = rng.random(n) < 0.5
    cols = {"a": rng.integers(0, 9, n).astype(np.int32),
            "b": rng.random(n) < 0.3}
    got, gcnt, govf = tphys.compact({k: torch.from_numpy(v) for k, v in cols.items()},
                                    torch.from_numpy(keep), 300)
    want, wcnt, wovf = rphys.compact({k: jnp.asarray(v) for k, v in cols.items()},
                                     jnp.asarray(keep), 300)
    assert int(gcnt) == int(wcnt) and bool(govf) == bool(wovf)
    for k in cols:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    keys = np.sort(rng.integers(0, 9, n)).astype(np.int32)
    x = rng.random(n) < 0.5
    got, gn, _ = tphys.segment_aggregate(torch.from_numpy(keys), torch.tensor(n, dtype=torch.int32),
                                         {"s": ("sum", torch.from_numpy(x))}, cap_out=n)
    want, wn, _ = rphys.segment_aggregate(jnp.asarray(keys), jnp.int32(n),
                                          {"s": ("sum", jnp.asarray(x))}, cap_out=n)
    assert int(gn) == int(wn)
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["s"].dtype == torch.int32


@pytest.mark.parametrize("name", NAMES)
def test_kernel_wrapper_refuses_cpu_tensors(name):
    """A kernel wrapper never falls back to its plain version: a tensor off
    the card is refused before anything is built or launched."""
    rng = np.random.default_rng(0)
    args = tuple(map(_to_torch, _cases(name, rng, 64, DTYPES[name][0])[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        treg.get(name).kernel(*args)


def test_lookback_fetch_follows_alignment():
    """How the look-back scans (csrc/lookback.cuh) fetch a tile: TMA bulk
    copies (BULK) when every tensor's data is 16-byte aligned, 4-byte loads
    (WORDS) when any tensor is a view one element in.  segment_scan passes
    its three tensors (x, boundary, out)."""
    from repro_torch.kernels import cuda
    x = torch.zeros(9, dtype=torch.int32)
    v = x[1:]
    assert x.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 4
    assert cuda.scan_load((x,)) == cuda.BULK
    assert cuda.scan_load((x, x.clone())) == cuda.BULK
    assert cuda.scan_load((x, v)) == cuda.WORDS
    assert cuda.scan_load((v,)) == cuda.WORDS
    xf = torch.zeros(9, dtype=torch.float32)
    b, out = torch.zeros(9, dtype=torch.int32), torch.empty(9)
    assert cuda.scan_load((xf, b, out)) == cuda.BULK
    for i in range(3):
        ts = [xf, b, out]
        ts[i] = ts[i][1:]
        assert cuda.scan_load(tuple(ts)) == cuda.WORDS
