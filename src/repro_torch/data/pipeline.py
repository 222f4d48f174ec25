"""The LM training data pipeline, built on HiFrames: relational
preprocessing and array computation in one program.

The port of the reference package's ``data/pipeline.py``.  Its relational
stages run through ``repro_torch.hiframes`` (on the card unless
``exec_cfg`` says ``device="cpu"``):

  1. corpus curation: a FILTER of documents by length and quality (a
     compaction, ``prefix_sum``),
  2. the packing plan: a CUMSUM of document lengths (the paper's
     MPI_Exscan pattern) gives every document a contiguous token offset,
  3. curriculum statistics: an AGGREGATE of token and document counts per
     quality bucket,

then a background thread assembles token batches ahead of the consumer,
from the same numpy generators as the reference, so the batches are the
reference's bit for bit.

The offsets are int32 and wrap modulo 2^32 once the curated corpus holds
2^31 tokens or more, as the reference's do (ROADMAP.md §3); the pipeline
warns when that happens.
"""
from __future__ import annotations

import queue
import threading
import warnings
from dataclasses import dataclass

import numpy as np

from ..core import api as hf


@dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    min_len: int = 64
    min_quality: float = 0.2
    prefetch: int = 2
    seed: int = 0


class TokenPipeline:
    """Iterator of {tokens, labels} batches ((global_batch, seq_len) int32
    numpy arrays) from a curated document table."""

    def __init__(self, corpus: dict[str, np.ndarray], cfg: PipelineConfig,
                 exec_cfg=None):
        self.cfg = cfg
        df = hf.table(corpus, name="corpus")
        # 1. curation filter (1D_VAR output)
        cur = df[(df["length"] >= cfg.min_len) &
                 (df["quality"] > cfg.min_quality)]
        # 2. packing plan: cumulative token offsets (MPI_Exscan pattern)
        packed = hf.cumsum(cur, cur["length"], out="offset")
        cols = packed.collect(exec_cfg).to_numpy()
        self.doc_len = cols["length"]
        self.doc_seed = cols["seed"]
        self.doc_offset = cols["offset"] - cols["length"]   # exclusive
        self.total_tokens = int(cols["offset"][-1]) if len(cols["offset"]) else 0
        exact = int(self.doc_len.sum(dtype=np.int64))
        if exact != self.total_tokens:
            warnings.warn(
                f"the curated corpus holds {exact} tokens: the int32 packing "
                f"offsets wrap (total_tokens {self.total_tokens})",
                RuntimeWarning, stacklevel=2)
        # 3. curriculum stats, exposed for logging
        sdf = hf.table({"bucket": (cols["quality"] * 10).astype(np.int32),
                        "length": cols["length"]}, name="stats")
        self.bucket_stats = hf.aggregate(
            sdf, "bucket", tokens=hf.sum_(sdf["length"]),
            docs=hf.count()).collect(exec_cfg).to_numpy()
        self._rng = np.random.default_rng(cfg.seed)
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- batch assembly ------------------------------------------------------
    def _make_batch(self):
        cfg = self.cfg
        n = cfg.global_batch
        toks = np.empty((n, cfg.seq_len + 1), np.int32)
        # sample documents, then generate their tokens from their seeds
        idx = self._rng.integers(0, len(self.doc_len), n)
        for i, d in enumerate(idx):
            rng = np.random.default_rng(int(self.doc_seed[d]) + 7919 * i)
            toks[i] = rng.integers(0, cfg.vocab, cfg.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _producer(self):
        while not self._stop.is_set():
            batch = self._make_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the producer thread and drop the batches it queued."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
