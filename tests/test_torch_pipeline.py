"""The port's token pipeline (repro_torch.data.pipeline) against the
reference's (repro.data.pipeline), on the CPU: the curated table, the
packing plan, the bucket statistics and the batches are the reference's
exactly, including the int32 wrap of the packing offsets (ROADMAP.md §3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import PipelineConfig as RPipelineConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RTokenPipeline  # noqa: E402
from repro.data.synth import token_corpus as rtoken_corpus  # noqa: E402
from repro_torch import hiframes as hf  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.data.synth import token_corpus  # noqa: E402
from repro_torch.kernels import registry as treg  # noqa: E402

CPU = hf.ExecConfig(device="cpu")


def _both(corpus, **kw):
    """The reference's pipeline and the port's over one corpus."""
    ref = RTokenPipeline(corpus, RPipelineConfig(**kw))
    try:
        port = TokenPipeline(corpus, PipelineConfig(**kw), CPU)
    except BaseException:
        ref.close()
        raise
    return ref, port


def _stats_by_bucket(stats):
    order = np.argsort(stats["bucket"])
    return {k: np.asarray(v)[order] for k, v in stats.items()}


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=24, global_batch=4),
    dict(vocab=128, seq_len=16, global_batch=3, min_len=300, min_quality=0.55, seed=5),
])
def test_pipeline_matches_reference(kw):
    corpus = token_corpus(3000, kw["vocab"])
    for k, v in rtoken_corpus(3000, kw["vocab"]).items():
        assert np.array_equal(corpus[k], v) and corpus[k].dtype == v.dtype, k
    ref, port = _both(corpus, **kw)
    try:
        for name in ("doc_len", "doc_seed", "doc_offset"):
            got, want = getattr(port, name), getattr(ref, name)
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert port.total_tokens == ref.total_tokens
        got, want = _stats_by_bucket(port.bucket_stats), _stats_by_bucket(ref.bucket_stats)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        mask = (corpus["length"] >= port.cfg.min_len) & \
            (corpus["quality"] > np.float32(port.cfg.min_quality))
        assert np.array_equal(port.doc_len, corpus["length"][mask])
        assert port.total_tokens == int(corpus["length"][mask].sum())
        for i in range(3):
            b, rb = next(port), next(ref)
            for k in ("tokens", "labels"):
                assert b[k].shape == (kw["global_batch"], kw["seq_len"])
                assert b[k].dtype == np.int32 and np.array_equal(b[k], rb[k]), (i, k)
            assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    finally:
        port.close()
        ref.close()
    assert not port._thread.is_alive()


def test_pipeline_stats_and_batches():
    """tests/test_substrate.py::test_pipeline_stats_and_batches on the port."""
    corpus = token_corpus(300, vocab=128)
    pipe = TokenPipeline(corpus, PipelineConfig(vocab=128, seq_len=16,
                                                global_batch=4, min_len=64,
                                                min_quality=0.3), CPU)
    try:
        b = next(iter(pipe))
        assert b["tokens"].shape == (4, 16)
        assert b["labels"].shape == (4, 16)
        assert (b["tokens"] < 128).all()
        assert (pipe.doc_len >= 64).all()
        assert pipe.total_tokens == pipe.doc_len.sum()
        assert pipe.bucket_stats["docs"].sum() == len(pipe.doc_len)
    finally:
        pipe.close()


def test_packing_offsets_wrap_as_the_references():
    """Eight documents of 2^29 tokens: the int32 cumsum wraps past 2^31 in
    both packages (the reference's fault, kept for parity and pinned here;
    the port warns)."""
    n = 8
    corpus = {"doc_id": np.arange(n, dtype=np.int32),
              "length": np.full(n, 2**29, np.int32),
              "quality": np.full(n, 0.9, np.float32),
              "seed": np.arange(n, dtype=np.int32)}
    kw = dict(vocab=64, seq_len=8, global_batch=2)
    ref = RTokenPipeline(corpus, RPipelineConfig(**kw))
    try:
        with pytest.warns(RuntimeWarning, match="wrap"):
            port = TokenPipeline(corpus, PipelineConfig(**kw), CPU)
    finally:
        ref.close()
    port.close()
    want = np.array([0, 2**29, 2**30, 3 * 2**29, -2**31, -3 * 2**29, -2**30,
                     -2**29], np.int32)
    for pipe in (ref, port):
        assert np.array_equal(pipe.doc_offset, want)
        assert pipe.total_tokens == 0
        assert int(pipe.bucket_stats["tokens"].sum()) == 0
        assert pipe.bucket_stats["bucket"].tolist() == [9]
        assert pipe.bucket_stats["docs"].tolist() == [n]


def test_pipeline_compacts_through_prefix_sum(monkeypatch):
    """The curation filter and the cumsum reach the registry's prefix_sum
    (the plain version on the CPU, the CUDA kernel on a card)."""
    spec = treg.get("prefix_sum")
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return spec.plain(*a, **k)

    monkeypatch.setitem(treg._REGISTRY, "prefix_sum",
                        dataclasses.replace(spec, plain=counted))
    pipe = TokenPipeline(token_corpus(500, 64),
                         PipelineConfig(vocab=64, seq_len=8, global_batch=2), CPU)
    pipe.close()
    assert len(calls) >= 2


def test_pipeline_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default ExecConfig works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(token_corpus(50, 64),
                      PipelineConfig(vocab=64, seq_len=8, global_batch=2))
