"""Synthetic data generators for the paper's workloads.

- Uniform tables for Fig. 8a/8b micro-benchmarks (the paper draws from a
  uniform distribution "to avoid load balance issues").
- TPCx-BB-like store_sales / item / web_clickstream tables for Q05/Q25/Q26,
  including the Zipf-skewed join key that makes Q05 the paper's skew stress
  (hash partitioning imbalance, §5.1).
"""
from __future__ import annotations

import numpy as np


def relational_tables(n_rows: int, n_keys: int, seed: int = 0):
    """Key + two float columns (paper's basic-relational-ops input)."""
    rng = np.random.default_rng(seed)
    return {
        "id": rng.integers(0, n_keys, n_rows).astype(np.int32),
        "x": rng.normal(size=n_rows).astype(np.float32),
        "y": rng.normal(size=n_rows).astype(np.float32),
    }


def series(n_rows: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n_rows).astype(np.float32)


# -- TPCx-BB-like -------------------------------------------------------------

N_CLASSES = 16
N_CATEGORIES = 8


def store_sales(n_rows: int, n_items: int, n_customers: int, seed: int = 0,
                skew: float = 0.0):
    """ss_item_sk is Zipf-skewed when skew > 0 (Q05's failure mode)."""
    rng = np.random.default_rng(seed)
    if skew > 0:
        # bounded Zipf over item ids
        z = rng.zipf(1.0 + skew, size=n_rows)
        item = ((z - 1) % n_items).astype(np.int32)
    else:
        item = rng.integers(0, n_items, n_rows).astype(np.int32)
    return {
        "ss_item_sk": item,
        "ss_customer_sk": rng.integers(0, n_customers, n_rows).astype(np.int32),
        "ss_ticket_number": rng.integers(0, n_rows, n_rows).astype(np.int32),
        "ss_net_paid": rng.gamma(2.0, 30.0, n_rows).astype(np.float32),
    }


def item(n_items: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return {
        "i_item_sk": np.arange(n_items, dtype=np.int32),
        "i_class_id": rng.integers(1, N_CLASSES + 1, n_items).astype(np.int32),
        "i_category_id": rng.integers(1, N_CATEGORIES + 1, n_items).astype(np.int32),
    }


def web_clickstream(n_rows: int, n_items: int, n_users: int, seed: int = 2,
                    skew: float = 0.0):
    rng = np.random.default_rng(seed)
    if skew > 0:
        z = rng.zipf(1.0 + skew, size=n_rows)
        item_sk = ((z - 1) % n_items).astype(np.int32)
    else:
        item_sk = rng.integers(0, n_items, n_rows).astype(np.int32)
    return {
        "wcs_item_sk": item_sk,
        "wcs_user_sk": rng.integers(0, n_users, n_rows).astype(np.int32),
        "wcs_click_date_sk": rng.integers(0, 365, n_rows).astype(np.int32),
    }


# -- string/categorical variants (docs/dtypes.md) -----------------------------

CATEGORY_NAMES = ("appliances", "books", "clothing", "electronics",
                  "garden", "music", "sports", "toys")
CHANNELS = ("catalog", "store", "web")


def item_ext(n_items: int, seed: int = 1):
    """:func:`item` plus a STRING category-name column (dictionary-encoded
    at ingest).  The name maps deterministically from ``i_category_id`` so
    string-keyed and int-keyed query variants stay comparable."""
    base = item(n_items, seed)
    names = np.asarray(CATEGORY_NAMES, dtype=object)
    base["i_category_name"] = names[(base["i_category_id"] - 1)
                                    % len(CATEGORY_NAMES)]
    return base


def store_sales_ext(n_rows: int, n_items: int, n_customers: int,
                    seed: int = 0, skew: float = 0.0,
                    null_rate: float = 0.02):
    """:func:`store_sales` plus the ingest-coercion stressors: a string
    sales-channel column with ``None`` holes and a nullable float discount
    column (NaN holes) — the Q09-style skipna-aggregation input."""
    base = store_sales(n_rows, n_items, n_customers, seed, skew)
    rng = np.random.default_rng(seed + 2000)
    ch = np.asarray(CHANNELS, dtype=object)[
        rng.integers(0, len(CHANNELS), n_rows)]
    ch[rng.random(n_rows) < null_rate] = None
    base["ss_channel"] = ch
    disc = rng.gamma(1.5, 5.0, n_rows).astype(np.float32)
    disc[rng.random(n_rows) < null_rate] = np.nan
    base["ss_discount"] = disc
    return base


# -- tokenized corpus stub (LM pipeline) --------------------------------------


def token_corpus(n_docs: int, vocab: int, max_len: int = 2048, seed: int = 0):
    """Document table: (doc_id, length, quality, seed) — token content is
    generated lazily per batch from the seed (no corpus on disk needed)."""
    rng = np.random.default_rng(seed)
    return {
        "doc_id": np.arange(n_docs, dtype=np.int32),
        "length": rng.integers(32, max_len, n_docs).astype(np.int32),
        "quality": rng.uniform(0, 1, n_docs).astype(np.float32),
        "seed": rng.integers(0, 2**31 - 1, n_docs).astype(np.int32),
    }
