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
