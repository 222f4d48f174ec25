"""Physical operators of the relational main path, on torch tensors.

Every function here is *per-rank* code: it runs on one rank's
``(capacity,)`` column tensors plus a 0-d int32 valid-row ``count`` tensor,
eagerly, on the device the tensors live on.  Collectives go through
``torch.distributed`` (NCCL between cards, gloo on the CPU):

  MPI_Alltoallv  -> fixed-capacity bucketed all_to_all_single + count vector
  MPI_Exscan     -> all_gather of one scalar per rank, or a log2(P) ladder
                    of batch_isend_irecv
  Isend/Irecv    -> batch_isend_irecv between ranks r and r +- 1 (halos)

All shapes are static and validity is tracked with counts and masks, as in
the reference package's ``core/physical.py``; results match it bit for bit
on integers, bools and hashes.  Counts and flags stay tensors on the device:
nothing here reads a value back to the host.  Key sentinel for sorts is the
dtype max, so padding sorts to the end.

The window functions are here: partitioned (segmented) cumsum, stencils
and ranks over the grouped layout, and the global forms through an
exclusive scan of per-rank values or a halo exchange.  So are the global
sort (sample sort), ``limit``, ``rebalance`` and ``concat``, and the skew
salting of a salted join (``salt_probe``, ``salt_build``; the build side
replicates its hot rows through ``compact``).
"""
from __future__ import annotations

import functools
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import registry as _registry
from .expr import numpy_dtype, promote_types, torch_dtype

M32 = 0xFFFFFFFF
I32_MAX = 2**31 - 1


def _K(kernels, like: torch.Tensor) -> "_registry.KernelSet":
    """The kernel set for a per-rank operator: the executor's, or (direct
    callers, tests) the one for the device ``like`` lives on."""
    return kernels if kernels is not None else _registry.resolve(like.device.type)


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def valid_mask(count: torch.Tensor, cap: int) -> torch.Tensor:
    return torch.arange(cap, dtype=torch.int32, device=count.device) < count


def _sentinel(dtype: torch.dtype):
    """The dtype's max, as a Python scalar: padding sorts after it ties."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).max
    return torch.iinfo(dtype).max


def _lowest(dtype: torch.dtype):
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def _scalar_i32(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 view of a column as int64 (floats by their float32 bits)."""
    if x.is_floating_point():
        x = x.to(torch.float32).view(torch.int32)
    return x.to(torch.int64) & M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for uint32 values held in int64, split into 16-bit
    halves of ``c`` so no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Lowbias32-style integer mix, bit-exact with the reference; floats are
    bitcast first.  Returns uint32 values in an int64 tensor."""
    x = _u32(x)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def hash_combine(h: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Boost-style hash combine on uint32 values (wraps mod 2^32)."""
    return h ^ ((h2 + 0x9E3779B9 + ((h << 6) & M32) + (h >> 2)) & M32)


def hash_keys(cols: dict[str, torch.Tensor],
              key_names: Sequence[str]) -> torch.Tensor:
    """Composite row hash: per-column hash_u32 folded with hash_combine, so
    equal key TUPLES hash equal and co-locate under shuffle_by_key."""
    h = hash_u32(cols[key_names[0]])
    for kn in key_names[1:]:
        h = hash_combine(h, hash_u32(cols[kn]))
    return h


# ---------------------------------------------------------------------------
# compaction (filter backend) — paper: "filter requires no communication"
# ---------------------------------------------------------------------------

def compact(cols: dict[str, torch.Tensor], keep: torch.Tensor, cap_out: int,
            kernels=None):
    """Move rows where ``keep`` into the prefix of fresh (cap_out, ...)
    buffers.  Returns (cols_out, count_out, overflow).

    Slots come from the registry's ``prefix_sum`` of the keep flags.  Rows
    past ``cap_out`` are dropped and flagged (JAX's ``mode="drop"``): every
    parked or overflowing row is sent to one extra slot that is cut off.
    Columns may carry trailing dims (the packed word matrix).
    """
    dev = keep.device
    if keep.shape[0] == 0:
        out = {name: torch.zeros((cap_out,) + tuple(v.shape[1:]),
                                 dtype=v.dtype, device=dev)
               for name, v in cols.items()}
        return out, _scalar_i32(0, dev), torch.tensor(False, device=dev)
    keep = keep.to(torch.int32)
    incl = _K(kernels, keep).prefix_sum(keep)
    total = incl[-1]
    dest = torch.where(keep > 0, incl - 1, cap_out).clamp_(max=cap_out).long()
    overflow = total > cap_out
    out = {}
    for name, v in cols.items():
        buf = torch.zeros((cap_out + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=dev)
        out[name] = buf.index_copy_(0, dest, v)[:cap_out]
    return out, total.clamp(max=cap_out).to(torch.int32), overflow


# ---------------------------------------------------------------------------
# skew salting (adaptive_stats)
# ---------------------------------------------------------------------------

# The salt column a salted join's two SaltOps inject and the join strips.
SALT_COL = "__salt__"


def hot_mask(cols: dict[str, torch.Tensor], key_names: Sequence[str],
             hot: Sequence[tuple]) -> torch.Tensor:
    """Boolean row mask: key tuple in ``hot`` (a static plan constant, the
    same literal set on both join sides, so membership agrees exactly)."""
    k0 = cols[key_names[0]]
    m = torch.zeros(k0.shape[0], dtype=torch.bool, device=k0.device)
    for vals in hot:
        eq = torch.ones_like(m)
        for kn, v in zip(key_names, vals):
            c = cols[kn]
            eq &= c == torch.tensor(v, dtype=c.dtype, device=c.device)
        m |= eq
    return m


def salt_probe(cols: dict[str, torch.Tensor], count, key_names: Sequence[str],
               hot: Sequence[tuple], R: int):
    """Probe-side salting: hot rows get salt ``position % R`` (spreading a
    hot key's rows over R sub-partitions of the keys+salt exchange), every
    other row salt 0.  Row set and order unchanged; returns (cols, count)."""
    k0 = cols[key_names[0]]
    is_hot = hot_mask(cols, key_names, hot)
    pos = torch.arange(k0.shape[0], dtype=torch.int32, device=k0.device)
    out = dict(cols)
    out[SALT_COL] = torch.where(is_hot, pos % R, torch.zeros_like(pos))
    return out, count


def salt_build(cols: dict[str, torch.Tensor], count, key_names: Sequence[str],
               hot: Sequence[tuple], R: int, cap_out: int, kernels=None):
    """Build-side salting: hot rows are replicated to every salt 0..R-1 so
    each probe sub-partition finds its match; other rows keep one salt-0
    copy.  Every (probe row, build row) pair with equal keys then agrees on
    exactly ONE salt value, so the salted join's row set is exactly the
    unsalted one.  Returns (cols, count, overflow) via :func:`compact`."""
    k0 = cols[key_names[0]]
    cap, dev = k0.shape[0], k0.device
    is_hot = hot_mask(cols, key_names, hot)
    valid = valid_mask(count, cap)
    rep = {name: v.repeat((R,) + (1,) * (v.dim() - 1))  # replica r at rows
           for name, v in cols.items()}                 # [r * cap, ...)
    rep[SALT_COL] = torch.arange(R, dtype=torch.int32,
                                 device=dev).repeat_interleave(cap)
    keep = valid.repeat(R) & ((rep[SALT_COL] == 0) | is_hot.repeat(R))
    return compact(rep, keep, cap_out, kernels=kernels)


# ---------------------------------------------------------------------------
# column packing — the byte-transport layer of the packed exchange
# ---------------------------------------------------------------------------

# Word width of the packed transport buffer: every column is bitcast into
# 32-bit words, so a whole table shuffles as ONE (P, bucket_cap, W) payload.
PACK_WORD_BYTES = 4


def col_words(dtype) -> int:
    """32-bit words one value of ``dtype`` occupies in the packed layout:
    4-byte types 1:1, 8-byte types two words, sub-word types one word."""
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return 1
    return max(1, dtype.itemsize // PACK_WORD_BYTES)


def column_words(v: torch.Tensor) -> torch.Tensor:
    """One column as its (rows, n_words) int32 words in the packed layout:
    4-byte types bitcast, 8-byte types split in two, sub-word types
    zero-extended."""
    dt = v.dtype
    if dt == torch.bool:
        return v.to(torch.int32)[:, None]
    if dt.itemsize == 4:
        return v.contiguous().view(torch.int32)[:, None]
    if dt.itemsize == 8:
        return v.contiguous().view(torch.int32).reshape(-1, 2)
    if dt.itemsize == 2:
        return (v.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF)[:, None]
    return v.contiguous().view(torch.uint8).to(torch.int32)[:, None]


def pack_columns(cols: dict[str, torch.Tensor]):
    """Bitcast-pack every column into one (rows, W) int32 word matrix (the
    reference's uint32 words, same bits).  Returns ``(words, layout)``;
    ``layout`` is the ``(name, dtype, word_offset, n_words)`` recipe
    :func:`unpack_columns` inverts.  Floats keep their payload bits exactly:
    NaNs, signed zeros and all."""
    words, layout, off = [], [], 0
    for name, v in cols.items():
        w = column_words(v)
        layout.append((name, v.dtype, off, w.shape[1]))
        off += w.shape[1]
        words.append(w)
    return torch.cat(words, dim=1), layout


def unpack_columns(words: torch.Tensor, layout) -> dict[str, torch.Tensor]:
    """Invert :func:`pack_columns`."""
    out = {}
    for name, dt, off, nw in layout:
        w = words[:, off:off + nw].contiguous()
        if dt == torch.bool:
            out[name] = w[:, 0] != 0
        elif dt.itemsize == 4:
            out[name] = w[:, 0].view(dt)
        elif dt.itemsize == 8:
            out[name] = w.view(dt).reshape(-1)
        elif dt.itemsize == 2:
            out[name] = w[:, 0].to(torch.int16).view(dt)
        else:
            out[name] = w[:, 0].to(torch.uint8).view(dt)
    return out


# ---------------------------------------------------------------------------
# exchange (MPI_Alltoallv analogue) — backbone of shuffle/join/aggregate
# ---------------------------------------------------------------------------

def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Equal-split all_to_all along dim 0 over the default process group."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous())
    return out


def exchange(cols: dict[str, torch.Tensor], count, dest: torch.Tensor, *,
             P: int, bucket_cap: int, cap_out: int, kernels=None,
             packed: bool = True):
    """Route row i of this rank to rank ``dest[i]``.

    Rows are stably grouped by destination into a per-rank bucket buffer
    (the registry's ``bucket_scatter`` gives every row its slot at its
    original position), exchanged with ``all_to_all_single``, then compacted
    into a (cap_out,) valid-prefix buffer.  Row order within a (src, dst)
    pair is preserved and receives concatenate in src order.

    ``packed=True`` ships all columns as one (P, bucket_cap, W) word payload,
    so an exchange of any table costs exactly TWO collectives: counts and
    payload.  ``packed=False`` ships one collective per column.  At P == 1
    there is no collective: the exchange is a compaction.
    """
    n = dest.shape[0]
    valid = valid_mask(count, n)
    dest = torch.where(valid, dest.to(torch.int32), P)

    if P == 1:
        return compact(cols, valid, cap_out, kernels=kernels)

    slot, send_counts = _K(kernels, dest).bucket_scatter(dest, P)
    in_range = dest < P
    overflow_send = torch.any(in_range & (slot >= bucket_cap))
    scatter_slot = torch.where(in_range & (slot < bucket_cap), slot, bucket_cap)
    # flat send-buffer row of every input row; dest == P and slot ==
    # bucket_cap land in rows that are cut off before the collective
    flat_idx = dest.long() * (bucket_cap + 1) + scatter_slot.long()

    sent = send_counts.clamp(max=bucket_cap)
    recv_counts = _all_to_all(sent)

    slot_idx = torch.arange(bucket_cap, dtype=torch.int32, device=dest.device)
    keep = (slot_idx[None, :] < recv_counts[:, None]).reshape(-1)

    def scatter(v):
        buf = torch.zeros(((P + 1) * (bucket_cap + 1),) + tuple(v.shape[1:]),
                          dtype=v.dtype, device=v.device)
        buf.index_copy_(0, flat_idx, v)
        buf = buf[: P * (bucket_cap + 1)].reshape(
            (P, bucket_cap + 1) + tuple(v.shape[1:]))
        return buf[:, :bucket_cap].contiguous()

    if packed:
        words, layout = pack_columns(cols)
        recv = _all_to_all(scatter(words))
        flat = {"__packed__": recv.reshape(P * bucket_cap, -1)}
        out, count_out, overflow_recv = compact(flat, keep, cap_out,
                                                kernels=kernels)
        out = unpack_columns(out["__packed__"], layout)
        return out, count_out, overflow_send | overflow_recv

    flat = {name: _all_to_all(scatter(v)).reshape(-1)
            for name, v in cols.items()}
    out, count_out, overflow_recv = compact(flat, keep, cap_out, kernels=kernels)
    return out, count_out, overflow_send | overflow_recv


def shuffle_by_key(cols: dict[str, torch.Tensor], count, key_names, *,
                   P: int, bucket_cap: int, cap_out: int, kernels=None,
                   packed: bool = True):
    """Hash-partition rows so equal (possibly composite) keys co-locate."""
    if isinstance(key_names, str):
        key_names = (key_names,)
    dest = (hash_keys(cols, key_names) % P).to(torch.int32)
    return exchange(cols, count, dest, P=P, bucket_cap=bucket_cap,
                    cap_out=cap_out, kernels=kernels, packed=packed)


# ---------------------------------------------------------------------------
# local sort — lax.sort(num_keys=k) as stable sorts from the last key up
# ---------------------------------------------------------------------------

def _sortable(k: torch.Tensor) -> torch.Tensor:
    return k.to(torch.uint8) if k.dtype == torch.bool else k


def _lex_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Permutation sorting rows lexicographically by ``keys`` (most
    significant first), ties kept in original order.  Stable sorts applied
    from the least significant key up compose to the multi-key order of
    ``lax.sort(num_keys=k)`` with an index tiebreaker.  ``torch.sort`` and
    ``lax.sort`` order floats alike: NaN after +inf and after the max
    sentinel, -0.0 equal to 0.0."""
    n = keys[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        order = torch.sort(_sortable(k)[perm], stable=True).indices
        perm = perm[order]
    return perm


def local_sort(cols: dict[str, torch.Tensor], count, key_names):
    """Stable lexicographic sort of valid rows by one or more key columns
    (padding sorts to the end via per-dtype max sentinels).

    Returns ``(sorted_cols, skeys)``: ``skeys`` is the tuple of
    SENTINEL-MASKED sorted key tensors, one per name in ``key_names``.
    """
    if isinstance(key_names, str):
        key_names = (key_names,)
    key_names = tuple(key_names)
    cap = cols[key_names[0]].shape[0]
    valid = valid_mask(count, cap)
    keys = [torch.where(valid, cols[kn], _sentinel(cols[kn].dtype))
            for kn in key_names]
    perm = _lex_perm(keys)
    sorted_keys = {kn: k[perm] for kn, k in zip(key_names, keys)}
    sorted_cols = {n: v[perm] for n, v in cols.items()}
    # masked key columns come back with sentinels; restore real values where valid
    for kn, kv in sorted_keys.items():
        sorted_cols[kn] = torch.where(valid, kv, torch.zeros((), dtype=kv.dtype,
                                                             device=kv.device))
    return sorted_cols, tuple(sorted_keys[kn] for kn in key_names)


# ---------------------------------------------------------------------------
# merge join (rank join: one fused union sort; inputs need NOT be pre-sorted)
# ---------------------------------------------------------------------------

def _run_heads(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """True where a row's key tuple differs from the previous row's (row 0
    is always a head)."""
    n = keys[0].shape[0]
    neq = functools.reduce(torch.logical_or, [k[1:] != k[:-1] for k in keys])
    head = torch.ones(n, dtype=torch.bool, device=keys[0].device)
    head[1:] = neq
    return head


def lex_ranks(keycols: Sequence[torch.Tensor], valid: torch.Tensor):
    """Dense lexicographic ranks of row tuples via one multi-key sort.

    Returns ``(ranks, sidx, rank_sorted)``: per-original-row int32 ranks
    (invalid rows get the int32 max), the original indices in sorted order,
    and the rank sequence in sorted order.
    """
    masked = [torch.where(valid, k, _sentinel(k.dtype)) for k in keycols]
    perm = _lex_perm(masked)
    sk = [k[perm] for k in masked]
    rank_sorted = torch.cumsum(_run_heads(sk).to(torch.int32), 0,
                               dtype=torch.int32) - 1
    ranks = torch.zeros(perm.shape[0], dtype=torch.int32, device=perm.device)
    ranks[perm] = rank_sorted
    ranks = torch.where(valid, ranks, I32_MAX)
    return ranks, perm.to(torch.int32), rank_sorted


def merge_join(lcols, lcount, rcols, rcount, lkeys, rkeys, *,
               cap_out: int, r_suffix_map: dict[str, str], how: str = "inner",
               null_fill: dict[str, Any] | None = None):
    """Equi-join of two co-partitioned shards (inner or left-outer) on one
    or more key columns; inputs need not be sorted.

    Both sides' keys are ranked by ONE union sort (:func:`lex_ranks`); per
    left row the matching right range comes from two searchsorteds into the
    right side's sorted ranks, and output slot s maps back to (left row,
    offset in its range) through the prefix sums of the match counts.
    Output follows LEFT row order.  Left-outer: unmatched rows get one slot,
    right columns filled with ``null_fill`` (NaN / null code) or zero, plus
    an int32 ``_matched`` column.  Returns (cols, count, overflow).
    """
    if isinstance(lkeys, str):
        lkeys = (lkeys,)
    if isinstance(rkeys, str):
        rkeys = (rkeys,)
    lkeys, rkeys = tuple(lkeys), tuple(rkeys)
    lcap = lcols[lkeys[0]].shape[0]
    rcap = rcols[rkeys[0]].shape[0]
    lvalid = valid_mask(lcount, lcap)
    rvalid = valid_mask(rcount, rcap)
    dev = lvalid.device

    valid = torch.cat([lvalid, rvalid])
    keycols = []
    for lk, rk in zip(lkeys, rkeys):
        la, ra = lcols[lk], rcols[rk]
        dt = torch_dtype(promote_types(numpy_dtype(la.dtype),
                                       numpy_dtype(ra.dtype)))
        keycols.append(torch.cat([la.to(dt), ra.to(dt)]))
    ranks, sidx, rank_sorted = lex_ranks(keycols, valid)
    lrank = ranks[:lcap]

    # right rows in key-sorted order, from the SAME sort: a stable
    # compaction of the sorted union down to its right-side entries.
    is_r = (sidx >= lcap).to(torch.int32)
    pos_r = torch.cumsum(is_r, 0, dtype=torch.int32) - 1
    scat = torch.where(is_r > 0, pos_r, rcap).long()
    rsorted_rank = torch.full((rcap + 1,), I32_MAX, dtype=torch.int32,
                              device=dev).index_copy_(0, scat, rank_sorted)[:rcap]
    rperm = torch.zeros(rcap + 1, dtype=torch.int32, device=dev) \
        .index_copy_(0, scat, sidx - lcap)[:rcap]

    lo = torch.searchsorted(rsorted_rank, lrank, side="left", out_int32=True)
    hi = torch.searchsorted(rsorted_rank, lrank, side="right", out_int32=True)
    hi = torch.minimum(hi, rcount)
    lo = torch.minimum(lo, rcount)
    matches = (hi - lo).to(torch.int32)
    cnt = torch.where(lvalid, matches, 0)
    if how == "left":
        cnt = torch.where(lvalid & (matches == 0), 1, cnt)

    incl = torch.cumsum(cnt, 0, dtype=torch.int32)
    excl = incl - cnt
    total = incl[-1] if lcap else _scalar_i32(0, dev)
    overflow = total > cap_out

    s = torch.arange(cap_out, dtype=torch.int32, device=dev)
    li = torch.searchsorted(incl, s, side="right", out_int32=True)
    li_c = li.clamp(0, lcap - 1).long()
    matched = matches[li_c] > 0
    rpos = lo[li_c] + (s - excl[li_c])               # position in sorted right
    ri_c = rperm[rpos.clamp(0, rcap - 1).long()].long()   # original right row
    out_valid = s < torch.minimum(total, _scalar_i32(cap_out, dev))
    r_valid = out_valid & matched if how == "left" else out_valid

    out = {}
    for name, v in lcols.items():
        out[name] = torch.where(out_valid, v[li_c], torch.zeros((), dtype=v.dtype,
                                                                device=dev))
    for name, v in rcols.items():
        if name in rkeys:
            continue
        # unmatched left rows NULL-fill right columns: NaN for floats, the
        # null code for categories (null_fill, from the schema); other
        # dtypes zero-fill beside the _matched indicator.
        fill = (null_fill or {}).get(name, 0)
        out[r_suffix_map.get(name, name)] = torch.where(
            r_valid, v[ri_c], torch.tensor(fill, dtype=v.dtype, device=dev))
    if how == "left":
        out["_matched"] = (out_valid & matched).to(torch.int32)
    return out, total.clamp(max=cap_out).to(torch.int32), overflow


# ---------------------------------------------------------------------------
# segmented aggregation (group-by backend over sorted key runs)
# ---------------------------------------------------------------------------

def null_mask(x: torch.Tensor, nulltag: str | None):
    """Row nullity under the in-band null encoding: ``"nan"`` — floats, null
    iff NaN; ``"code"`` — dictionary codes, null iff negative; ``None`` —
    the column cannot hold nulls."""
    if nulltag == "nan":
        if not x.is_floating_point():
            return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
        return torch.isnan(x)
    if nulltag == "code":
        return x < 0
    return None


def null_value(dtype: torch.dtype, nulltag: str | None):
    """The in-band null of a value dtype (NaN / the null code)."""
    if nulltag == "code" or not dtype.is_floating_point:
        return -1
    return float("nan")


def _value_spec(spec):
    """Normalize a values entry: (fn, x) or (fn, x, skipna, nulltag)."""
    if len(spec) == 2:
        fn, x = spec
        return fn, x, True, None
    fn, x, skipna, nulltag = spec
    return fn, x, skipna, nulltag


def _zero_where_not(v: torch.Tensor, x: torch.Tensor, fill) -> torch.Tensor:
    return torch.where(v, x, torch.tensor(fill, dtype=x.dtype, device=x.device))


def segment_aggregate(keys_sorted, count, values: dict[str, tuple],
                      *, cap_out: int, kernels=None,
                      presorted: Sequence[str] = ()):
    """Aggregate ``values`` over runs of equal (grouped) composite keys.

    Same contract as the reference's ``physical.segment_aggregate``: the
    valid prefix has equal key tuples contiguous; ``values`` maps name ->
    (fn, x) or (fn, x, skipna, nulltag) with fn in {sum, mean, count, min,
    max, prod, any, all, var, std, first, nunique}; ``presorted`` names
    nunique entries whose values arrive sorted within each key run.  The
    reference's ``jax.ops.segment_*`` become ``scatter_reduce``/``index_add_``
    into ``cap_out + 1`` slots (the last collects padding), then a slice;
    float sums go through the registry's ``segment_sums`` over the valid
    prefix (``count``).
    Returns ``({__key0__..., **aggs}, n_groups, overflow)``.
    """
    if not isinstance(keys_sorted, (tuple, list)):
        keys_sorted = (keys_sorted,)
    keys_sorted = tuple(keys_sorted)
    cap = keys_sorted[0].shape[0]
    dev = keys_sorted[0].device
    valid = valid_mask(count, cap)
    n_valid = count.reshape(()).to(torch.int32)
    seg_start = valid & _run_heads(keys_sorted)
    seg_id = torch.cumsum(seg_start.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_id = torch.where(valid, seg_id, cap_out)          # padding -> dropped
    n_seg = torch.sum(seg_start.to(torch.int32), dtype=torch.int32)
    overflow = n_seg > cap_out
    slots = seg_id.clamp(max=cap_out).long()              # overflow -> dropped

    def reduce(x, how, fill):
        out = torch.full((cap_out + 1,), fill, dtype=x.dtype, device=dev)
        return out.scatter_reduce_(0, slots, x, how)[:cap_out]

    def isum(x):
        out = torch.zeros(cap_out + 1, dtype=x.dtype, device=dev)
        return out.index_add_(0, slots, x)[:cap_out]

    def ssum(x, v=None):
        v = valid if v is None else v
        if x.dtype == torch.bool:
            x = x.to(torch.int32)      # sum(:x < 1.0) counts True rows
        if x.is_floating_point():
            # slots past the last group are undefined: masked by gvalid below
            return _K(kernels, x).segment_sums(x.contiguous(), seg_id, v,
                                               cap_out, n_valid)
        # integer sums stay exact on the plain path, as in the reference
        return isum(_zero_where_not(v, x, 0))

    def smin(x, v=None):
        v = valid if v is None else v
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        big = _sentinel(x.dtype)
        return reduce(_zero_where_not(v, x, big), "amin", big)

    def smax(x, v=None):
        v = valid if v is None else v
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        small = _lowest(x.dtype)
        return reduce(_zero_where_not(v, x, small), "amax", small)

    def sprod(x, v=None):
        v = valid if v is None else v
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        return reduce(_zero_where_not(v, x, 1), "prod", 1)

    group_n = isum(valid.to(torch.int32))

    out: dict[str, torch.Tensor] = {}
    for i, ks in enumerate(keys_sorted):
        neg = _lowest(ks.dtype)
        out[f"__key{i}__"] = reduce(_zero_where_not(valid, ks, neg), "amax", neg)

    for name, spec in values.items():
        fn, x, skipna, nulltag = _value_spec(spec)
        nullm = null_mask(x, nulltag) if x is not None else None
        # vvalid: rows contributing under skipna; vn: their per-group count;
        # has_null: whether the group saw a null (skipna=False poisoning).
        vvalid = valid if nullm is None else valid & ~nullm
        vn = has_null = None
        if nullm is not None:
            vn = isum(vvalid.to(torch.int32))
            has_null = vn < group_n

        def _null_out(res):
            """null-fill groups with no contributing rows (skipna) or with
            any null row (skipna=False)."""
            if nullm is None:
                return res
            bad = (vn == 0) if skipna else has_null
            return torch.where(bad, torch.tensor(
                null_value(res.dtype, nulltag), dtype=res.dtype, device=dev), res)

        if fn == "count":
            out[name] = group_n if nullm is None else vn
        elif fn == "sum":
            out[name] = ssum(x, vvalid if skipna else valid)
        elif fn == "mean":
            xf = x.to(torch.float32)
            v = vvalid if skipna else valid
            n = vn if (skipna and nullm is not None) else group_n
            out[name] = _null_out(ssum(xf, v) / n.clamp(min=1))
        elif fn == "min":
            out[name] = _null_out(smin(x, vvalid if skipna else valid))
        elif fn == "max":
            out[name] = _null_out(smax(x, vvalid if skipna else valid))
        elif fn == "prod":
            out[name] = sprod(x, vvalid if skipna else valid)
        elif fn == "any":
            flag = (x != 0).to(torch.int32)
            out[name] = smax(flag, vvalid if skipna else valid) > 0
        elif fn == "all":
            flag = (x != 0).to(torch.int32)
            out[name] = smin(flag, vvalid if skipna else valid) > 0
        elif fn in ("var", "std"):
            xf = x.to(torch.float32)
            v = vvalid if skipna else valid
            n = (vn if (skipna and nullm is not None) else group_n).clamp(min=1)
            m = ssum(xf, v) / n
            m2 = ssum(xf * xf, v) / n
            var = (m2 - m * m).clamp(min=0.0)
            out[name] = _null_out(torch.sqrt(var) if fn == "std" else var)
        elif fn == "first":
            v = vvalid if skipna else valid
            idx = torch.arange(cap, dtype=torch.int32, device=dev)
            first_idx = reduce(torch.where(v, idx, cap), "amin", I32_MAX)
            res = x[first_idx.clamp(0, cap - 1).long()]
            if nullm is not None and skipna:
                res = torch.where(first_idx >= cap, torch.tensor(
                    null_value(res.dtype, nulltag), dtype=res.dtype,
                    device=dev), res)
            out[name] = res
        elif fn == "nunique" and name in presorted:
            # x arrives sorted within each key run (a trailing key of the
            # planner's LocalSort): distinct values are contiguous.
            boundary = (seg_start | _run_heads((x,))) & vvalid
            out[name] = isum(boundary.to(torch.int32))
        elif fn == "nunique":
            # aux sort by (keys..., x) groups x within each key run; group
            # order matches the main segment order for ascending keys.
            masked = [torch.where(valid, k, _sentinel(k.dtype))
                      for k in keys_sorted]
            perm = _lex_perm(masked + [x])
            sk = [k[perm] for k in masked]
            sx = x[perm]
            seg_start2 = valid & _run_heads(sk)  # valid rows stay a prefix
            seg_id2 = torch.cumsum(seg_start2.to(torch.int32), 0,
                                   dtype=torch.int32) - 1
            slots2 = torch.where(valid, seg_id2, cap_out).clamp(max=cap_out).long()
            boundary = (seg_start2 | _run_heads((sx,))) & valid
            snullm = null_mask(sx, nulltag)
            if snullm is not None:
                boundary = boundary & ~snullm   # null runs don't count
            b = torch.zeros(cap_out + 1, dtype=torch.int32, device=dev)
            out[name] = b.index_add_(0, slots2, boundary.to(torch.int32))[:cap_out]
        else:
            raise ValueError(fn)
    gvalid = torch.arange(cap_out, dtype=torch.int32, device=dev) \
        < n_seg.clamp(max=cap_out)
    for name in out:
        out[name] = torch.where(gvalid, out[name],
                                torch.zeros((), dtype=out[name].dtype, device=dev))
    return out, n_seg.clamp(max=cap_out).to(torch.int32), overflow


# ---------------------------------------------------------------------------
# map-side partial aggregation (combiner algebra for the shuffle engine)
#
# Every decomposable agg fn splits into partial statistics a shard can
# pre-reduce over its LOCAL key groups before the hash exchange.  The whole
# algebra lives in one table (AGG_DECOMP), which partial_decompose,
# final_aggregate and the planner's schema annotation all read.
# first and nunique are not decomposable: they stay on the raw-row path.
# ---------------------------------------------------------------------------


class PartialSpec:
    """One partial column of a decomposable aggregation.

    ``suffix``     the wire column is named ``__p_<out>__<suffix>``
    ``partial_fn`` segment fn reducing raw rows map-side
    ``combine_fn`` segment fn merging per-shard partials reduce-side
    ``dtype``      wire dtype as a function of the value column's dtype
    ``prep``       input transform applied before the partial stage
    """

    __slots__ = ("suffix", "partial_fn", "combine_fn", "dtype", "prep")

    def __init__(self, suffix, partial_fn, combine_fn=None, dtype=None,
                 prep=None):
        self.suffix = suffix
        self.partial_fn = partial_fn
        self.combine_fn = combine_fn or partial_fn
        self.dtype = dtype or (lambda vd: np.dtype(np.int32)
                               if np.dtype(vd) == np.bool_ else np.dtype(vd))
        self.prep = prep or (lambda x: x)


def _dt_i32(_vd):
    return np.dtype(np.int32)


def _dt_f32(_vd):
    return np.dtype(np.float32)


def _as_f32(x):
    return x.to(torch.float32)


def _as_flag(x):
    return (x != 0).to(torch.int32)


def _as_int_if_bool(x):
    # min/max of a bool column compare as 0/1 int32, as on the raw path
    return x.to(torch.int32) if x.dtype == torch.bool else x


def _mean_final(p):
    return p["s"] / p["n"].clamp(min=1)


def _var_final(p):
    n = p["n"].clamp(min=1)
    m = p["s"] / n
    m2 = p["q"] / n
    return (m2 - m * m).clamp(min=0.0)


# fn -> (partial column specs, finalize(dict suffix -> combined tensor))
AGG_DECOMP: dict[str, tuple[tuple[PartialSpec, ...], Any]] = {
    "sum":   ((PartialSpec("s", "sum"),), lambda p: p["s"]),
    "count": ((PartialSpec("n", "count", combine_fn="sum", dtype=_dt_i32),),
              lambda p: p["n"]),
    "min":   ((PartialSpec("m", "min", prep=_as_int_if_bool),),
              lambda p: p["m"]),
    "max":   ((PartialSpec("m", "max", prep=_as_int_if_bool),),
              lambda p: p["m"]),
    "prod":  ((PartialSpec("p", "prod"),), lambda p: p["p"]),
    "any":   ((PartialSpec("b", "max", dtype=_dt_i32, prep=_as_flag),),
              lambda p: p["b"] != 0),
    "all":   ((PartialSpec("b", "min", dtype=_dt_i32, prep=_as_flag),),
              lambda p: p["b"] != 0),
    "mean":  ((PartialSpec("s", "sum", dtype=_dt_f32, prep=_as_f32),
               PartialSpec("n", "count", combine_fn="sum", dtype=_dt_i32)),
              _mean_final),
    "var":   ((PartialSpec("s", "sum", dtype=_dt_f32, prep=_as_f32),
               PartialSpec("q", "sum", dtype=_dt_f32,
                           prep=lambda x: _as_f32(x) * _as_f32(x)),
               PartialSpec("n", "count", combine_fn="sum", dtype=_dt_i32)),
              _var_final),
    "std":   ((PartialSpec("s", "sum", dtype=_dt_f32, prep=_as_f32),
               PartialSpec("q", "sum", dtype=_dt_f32,
                           prep=lambda x: _as_f32(x) * _as_f32(x)),
               PartialSpec("n", "count", combine_fn="sum", dtype=_dt_i32)),
              lambda p: torch.sqrt(_var_final(p))),
}

DECOMPOSABLE_AGGS = frozenset(AGG_DECOMP)


def decomposable(fn: str, skipna: bool = True, nulltag: str | None = None) -> bool:
    """Whether this agg can take the partial/final two-stage path
    (``skipna=False`` on a nullable column needs the group's full rows)."""
    if fn not in AGG_DECOMP:
        return False
    return skipna or nulltag is None


def _partial_marker(partial_fn: str, dtype: torch.dtype):
    """The in-band "no contributing rows" marker a null-masked partial
    min/max reduces to; the finalizer maps it back to null."""
    if partial_fn == "min":
        return _sentinel(dtype)
    return _lowest(dtype)


def partial_decompose(name: str, fn: str, x: torch.Tensor, skipna: bool = True,
                      nulltag: str | None = None):
    """Partial-column specs for one decomposable agg output: a list of
    ``(partial_name, partial_fn, tensor)`` triples feeding segment_aggregate.
    With a ``nulltag`` null rows contribute the reduction identity and count
    partials count NON-null rows, so the wire schema is unchanged."""
    if not decomposable(fn, skipna, nulltag):
        raise ValueError(f"{fn} is not decomposable")
    specs, _final = AGG_DECOMP[fn]
    nullm = null_mask(x, nulltag) if x is not None else None
    out = []
    for s in specs:
        pcol = f"__p_{name}__{s.suffix}"
        if nullm is None:
            out.append((pcol, s.partial_fn, s.prep(x)))
            continue
        if s.partial_fn == "count":
            out.append((pcol, "sum", (~nullm).to(torch.int32)))
            continue
        arr = s.prep(x)
        if s.partial_fn in ("min", "max"):
            ident = _partial_marker(s.partial_fn, arr.dtype)
        elif s.partial_fn == "prod":
            ident = 1
        else:                                   # sum
            ident = 0
        out.append((pcol, s.partial_fn, _zero_where_not(~nullm, arr, ident)))
    return out


def partial_aggregate(keys_sorted, count, values: dict[str, tuple],
                      *, cap_out: int, kernels=None):
    """Map-side stage: reduce each LOCAL key run to its partial statistics
    (one output row per local distinct key tuple)."""
    pvals: dict[str, tuple[str, torch.Tensor]] = {}
    for name, spec in values.items():
        fn, x, skipna, nulltag = _value_spec(spec)
        for pcol, pfn, arr in partial_decompose(name, fn, x, skipna, nulltag):
            pvals[pcol] = (pfn, arr)
    return segment_aggregate(keys_sorted, count, pvals, cap_out=cap_out,
                             kernels=kernels)


def final_aggregate(keys_sorted, count, agg_fns: dict[str, Any],
                    cols: dict[str, torch.Tensor], *, cap_out: int,
                    kernels=None):
    """Reduce-side stage: combine partial rows from every shard (grouped by
    key after the exchange and local sort) into final results.  ``agg_fns``
    maps output name -> fn, or ``(fn, skipna, nulltag)``; ``cols`` holds the
    partial ``__p_<name>__*`` columns."""
    norm = {name: (spec if isinstance(spec, tuple) else (spec, True, None))
            for name, spec in agg_fns.items()}
    cvals: dict[str, tuple[str, torch.Tensor]] = {}
    for name, (fn, skipna, tag) in norm.items():
        if not decomposable(fn, skipna, tag):
            raise ValueError(f"{fn} is not decomposable")
        for s in AGG_DECOMP[fn][0]:
            pcol = f"__p_{name}__{s.suffix}"
            cvals[pcol] = (s.combine_fn, cols[pcol])
    agg, n_seg, ovf = segment_aggregate(keys_sorted, count, cvals,
                                        cap_out=cap_out, kernels=kernels)
    dev = n_seg.device
    gvalid = torch.arange(cap_out, dtype=torch.int32, device=dev) < n_seg
    out = {k: v for k, v in agg.items() if k.startswith("__key")}
    for name, (fn, skipna, nulltag) in norm.items():
        specs, final = AGG_DECOMP[fn]
        p = {s.suffix: agg[f"__p_{name}__{s.suffix}"] for s in specs}
        res = final(p)
        if nulltag is not None and skipna:
            # undo the skipna identities: all-null groups reduced to the
            # pure marker/identity — map them back to the null value
            null = torch.tensor(null_value(res.dtype, nulltag), dtype=res.dtype,
                                device=dev)
            if fn in ("min", "max"):
                marker = _partial_marker(specs[0].partial_fn, res.dtype)
                res = torch.where(gvalid & (res == marker), null, res)
            elif fn in ("mean", "var", "std"):
                res = torch.where(gvalid & (p["n"] == 0), null, res)
        out[name] = res
    return out, n_seg, ovf


# ---------------------------------------------------------------------------
# partitioned (segmented) windows — OVER (PARTITION BY ... ORDER BY ...)
#
# The physical planner guarantees the input is hash-partitioned on the
# partition keys (every group lives whole on ONE rank) and locally sorted by
# (partition keys, order keys), so the three operators below are
# collective-free segment computations over the grouped layout.
# ---------------------------------------------------------------------------

def run_starts(keys: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """Boolean mask: True at the first row of each run of equal key tuples
    (grouped input).  Invalid rows are never starts."""
    return valid & _run_heads(keys)


def _segment_first_index(seg_start: torch.Tensor) -> torch.Tensor:
    """For every row, the index of its segment's first row (running max of
    start positions; rows before the first start map to 0)."""
    idx = torch.arange(seg_start.shape[0], dtype=torch.int32,
                       device=seg_start.device)
    if seg_start.shape[0] == 0:
        return idx
    return torch.cummax(torch.where(seg_start, idx, 0), 0).values


def segment_cumsum(x: torch.Tensor, part_keys: Sequence[torch.Tensor], count,
                   kernels=None, nulltag: str | None = None):
    """Grouped cumulative sum through the registry's ``segment_scan``.  No
    collectives: groups are rank-local under hash(partition_by).

    With a ``nulltag`` the semantics match pandas cumsum on nullable data:
    null rows stay null in the output and the running total skips them.
    """
    cap = x.shape[0]
    valid = valid_mask(count, cap)
    nullm = null_mask(x, nulltag)
    skip = valid if nullm is None else valid & ~nullm
    if x.dtype == torch.bool:
        x = x.to(torch.int32)            # cumsum of bool promotes anyway
    xz = _zero_where_not(skip, x, 0)
    seg_start = run_starts(part_keys, valid)
    out = _K(kernels, xz).segment_scan(xz, seg_start.to(torch.int32))
    if nullm is not None:
        out = torch.where(nullm, torch.tensor(null_value(out.dtype, nulltag),
                                              dtype=out.dtype, device=out.device),
                          out)
    return _zero_where_not(valid, out, 0)


def segment_stencil1d(x: torch.Tensor, part_keys: Sequence[torch.Tensor],
                      count, weights: Sequence[float], center: int,
                      exact: bool = False, kernels=None):
    """Boundary-masked 1-D stencil: taps that would cross a group edge are
    zeroed (the zero-border convention applied per group).  No halo
    exchange: groups are rank-local, so neighbours outside the group are
    masked by segment-id mismatch in the registry's ``segment_stencil``.

    ``exact=True`` renormalizes each output by the realized weight mass of
    the taps that contributed (pandas' ``min_periods=1`` rolling mean for
    uniform weights).  Sentinel ids: -1 for invalid rows, -2 for the halo
    rows at both ends, so neither ever matches a real group.
    """
    w = [float(v) for v in weights]
    k_left, k_right = center, len(w) - 1 - center
    cap = x.shape[0]
    dev = x.device
    valid = valid_mask(count, cap)
    xz = torch.where(valid, x.to(torch.float32), 0.0)
    seg_start = run_starts(part_keys, valid)
    sid = torch.cumsum(seg_start.to(torch.int32), 0, dtype=torch.int32) - 1
    sid = torch.where(valid, sid, -1)                # padding never matches
    ext_x = torch.cat([torch.zeros(k_left, device=dev), xz,
                       torch.zeros(k_right, device=dev)])
    ext_s = torch.cat([torch.full((k_left,), -2, dtype=torch.int32, device=dev),
                       sid,
                       torch.full((k_right,), -2, dtype=torch.int32, device=dev)])
    out = _K(kernels, xz).segment_stencil(ext_x, ext_s, w, center, exact)
    return torch.where(valid, out, 0.0)


def segment_rank(part_keys: Sequence[torch.Tensor],
                 order_keys: Sequence[torch.Tensor], count, kind: str,
                 kernels=None):
    """SQL ranking within groups of rows sorted by (part_keys, order_keys).

    row_number: 1-based position in the group (ties broken by the stable
    sort).  rank: 1 + position of the first row with the same order-key
    tuple (ties share, gaps after).  dense_rank: 1 + number of distinct
    order-key tuples before this row's (ties share, no gaps).  The two head
    masks (group starts; (group, order) run starts, so every group start is
    also a run start) feed the registry's ``segment_rank``.
    """
    if kind not in ("row_number", "rank", "dense_rank"):
        raise ValueError(kind)
    cap = part_keys[0].shape[0]
    valid = valid_mask(count, cap)
    seg_start = run_starts(part_keys, valid)
    if kind == "row_number":
        order_start = seg_start
    else:
        order_start = run_starts(tuple(part_keys) + tuple(order_keys), valid)
    r = _K(kernels, seg_start).segment_rank(seg_start.to(torch.int32),
                                            order_start.to(torch.int32), kind)
    return torch.where(valid, r, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# distributed scans (MPI_Exscan analogue)
# ---------------------------------------------------------------------------

def _rank_of(P: int) -> int:
    return dist.get_rank() if P > 1 else 0


def all_gather_rows(t: torch.Tensor, P: int) -> torch.Tensor:
    """(P * n, ...) concatenation of every rank's (n, ...) ``t``, in rank
    order."""
    parts = [torch.empty_like(t) for _ in range(P)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def _all_gather_scalars(v: torch.Tensor, P: int) -> torch.Tensor:
    """(P,) tensor of every rank's 0-d ``v``, in rank order."""
    return all_gather_rows(v.reshape(1), P)


def _send_recv(sends: Sequence[tuple[torch.Tensor, int]],
               recvs: Sequence[tuple[torch.Tensor, int]]) -> None:
    """Post ``sends`` ((tensor, peer rank)) and ``recvs`` ((buffer, peer
    rank)) as one ``batch_isend_irecv`` and wait for all of them.  gloo
    moves only host memory point to point, so under gloo CUDA tensors go
    through host copies (its collectives stage them the same way); NCCL
    takes them as they are."""
    stage = dist.get_backend() == "gloo" and any(
        t.is_cuda for t, _ in list(sends) + list(recvs))
    host = (lambda t: t.cpu()) if stage else (lambda t: t)
    bufs = [host(b) for b, _ in recvs]
    ops = [dist.P2POp(dist.isend, host(t.contiguous()), peer)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, b, peer)
            for b, (_, peer) in zip(bufs, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if stage:
        for b, (dst, _) in zip(bufs, recvs):
            dst.copy_(b)


def exscan_scalar(v: torch.Tensor, P: int, method: str = "allgather"):
    """Exclusive prefix sum of a per-rank 0-d tensor across the P ranks of
    the default process group.

    ``"allgather"`` gathers every rank's value and sums those of the lower
    ranks; ``"ladder"`` is the Hillis-Steele ladder of the reference's
    ``ppermute`` form: log2(P) rounds, each a ``batch_isend_irecv`` from
    rank r to rank r + shift (ranks with no sender receive 0)."""
    if P == 1:
        return torch.zeros_like(v)
    me = _rank_of(P)
    if method == "ladder":
        x = v.reshape(1).clone()
        shift = 1
        while shift < P:
            y = torch.zeros_like(x)
            _send_recv([(x, me + shift)] if me + shift < P else [],
                       [(y, me - shift)] if me - shift >= 0 else [])
            x = x + y
            shift *= 2
        return (x - v.reshape(1)).reshape(v.shape)
    if method != "allgather":
        raise ValueError(f"exscan method must be 'allgather' or 'ladder', "
                         f"got {method!r}")
    allv = _all_gather_scalars(v, P)
    below = torch.arange(P, device=v.device) < me
    return torch.where(below, allv, torch.zeros((), dtype=v.dtype,
                                                device=v.device)).sum().to(v.dtype)


def dist_cumsum(x: torch.Tensor, count, P: int = 1, method: str = "allgather",
                kernels=None):
    """Distributed cumulative sum over the valid prefix of each rank: the
    registry's ``prefix_sum`` on the rank, plus the exclusive scan of the
    ranks' totals."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    cap = x.shape[0]
    xz = _zero_where_not(valid_mask(count, cap), x, 0)
    local = _K(kernels, xz).prefix_sum(xz) if cap else xz
    total = local[-1] if cap else torch.zeros((), dtype=x.dtype, device=x.device)
    return local + exscan_scalar(total, P, method=method)


def global_rank(order_keys: Sequence[torch.Tensor], count, cap: int, kind: str,
                P: int = 1, method: str = "allgather", kernels=None):
    """GLOBAL SQL ranking (no PARTITION BY) over the rank-concatenated
    stream, through an exclusive scan of per-rank counts: never a second
    global sort.

    row_number: 1-based global position in arrival order.  rank and
    dense_rank REQUIRE equal order-key tuples adjacent across the global
    stream (the planner checks it); ties straddling ranks are reconciled
    from tiny all-gathered per-rank scalars (count, first and last key
    tuple, trailing-run start, run count), so no rows move.
    """
    if kind not in ("row_number", "rank", "dense_rank"):
        raise ValueError(kind)
    dev = count.device
    valid = valid_mask(count, cap)
    cnt = count.to(torch.int32).reshape(())
    idx = torch.arange(cap, dtype=torch.int32, device=dev)

    def out(r):
        return torch.where(valid, r, 0).to(torch.int32)

    if kind == "row_number":
        return out(exscan_scalar(cnt, P, method=method) + idx + 1)

    keys = tuple(order_keys)
    order_start = run_starts(keys, valid)
    start_idx = _segment_first_index(order_start)          # local run start
    run_ord = torch.cumsum(order_start.to(torch.int32), 0, dtype=torch.int32)

    if P == 1:
        return out(start_idx + 1 if kind == "rank" else run_ord)

    # -- tiny boundary gathers (one scalar all_gather per quantity) ----------
    last_i = (cnt - 1).clamp(0, cap - 1).long()
    cnts = _all_gather_scalars(cnt, P)
    ts = _all_gather_scalars(start_idx[last_i], P)   # trailing run's start
    runs = _all_gather_scalars(order_start.to(torch.int32).sum(
        dtype=torch.int32), P)
    firsts = [_all_gather_scalars(k[0], P) for k in keys]
    lasts = [_all_gather_scalars(k[last_i], P) for k in keys]
    bases = torch.cumsum(cnts, 0, dtype=torch.int32) - cnts      # exclusive
    me = _rank_of(P)
    base = bases[me]

    def key_eq(cols_a, j, cols_b):
        return functools.reduce(torch.logical_and,
                                [a[j] == b for a, b in zip(cols_a, cols_b)])

    if kind == "rank":
        # Walk back from this rank: while the previous rank's trailing run
        # carries this rank's first key, the leading run started there (or
        # earlier, when that whole rank holds the key).
        fk = [k[0] for k in keys]
        g = base                                   # leading run's global start
        alive = cnt > 0
        for j in range(me - 1, -1, -1):
            nonempty = cnts[j] > 0
            take = alive & nonempty & key_eq(lasts, j, fk)
            g = torch.where(take, bases[j] + ts[j], g)
            alive = alive & (~nonempty | (take & (ts[j] == 0)))
        return out(torch.where(start_idx == 0, g, base + start_idx) + 1)

    # dense_rank: distinct runs on ranks before this one, minus the boundary
    # merges (a run continuing across consecutive non-empty ranks counts
    # once).  merge[j]: rank j's first key equals the last key of the
    # nearest previous non-empty rank.
    prev_any = torch.zeros((), dtype=torch.bool, device=dev)
    prev_last = [torch.zeros((), dtype=k.dtype, device=dev) for k in keys]
    merges = []
    for j in range(P):
        nonempty = cnts[j] > 0
        merges.append(nonempty & prev_any & key_eq(firsts, j, prev_last))
        prev_last = [torch.where(nonempty, c[j], p)
                     for c, p in zip(lasts, prev_last)]
        prev_any = prev_any | nonempty
    m = torch.stack(merges).to(torch.int32)
    runs_before = runs[:me].sum(dtype=torch.int32) - m[:me + 1].sum(dtype=torch.int32)
    return out(runs_before + run_ord)


# ---------------------------------------------------------------------------
# 1-D stencil with halo exchange (SMA / WMA)
# ---------------------------------------------------------------------------

def halo_exchange(x: torch.Tensor, count, k_left: int, k_right: int, P: int = 1):
    """Count-aware halo exchange over the valid prefixes.

    Each rank's valid rows are the prefix ``x[:count]``; the global array is
    the concatenation of the prefixes.  The left halo is the left
    neighbour's valid tail ``x[count - k_left : count]``; the right halo is
    the right neighbour's head ``x[:k_right]``.  Zeros at the global
    borders.  Rank r sends its tail to r + 1 and its head to r - 1 in one
    ``batch_isend_irecv``.  The window radius must not exceed the smallest
    non-empty rank's count (1D_BLOCK layouts with radius << block).
    """
    cap = x.shape[0]
    dev = x.device
    xz = _zero_where_not(valid_mask(count, cap), x, 0)
    left = torch.zeros(k_left, dtype=x.dtype, device=dev)
    right = torch.zeros(k_right, dtype=x.dtype, device=dev)
    if P == 1:
        return left, right
    me = _rank_of(P)
    sends, recvs = [], []
    if k_left:
        # the valid tail, its start clamped into the buffer like
        # lax.dynamic_slice clamps it
        start = (count.to(torch.int64) - k_left).clamp(0, max(cap - k_left, 0))
        tail = xz[(start + torch.arange(k_left, device=dev)).clamp(max=cap - 1)]
        if me + 1 < P:
            sends.append((tail, me + 1))
        if me > 0:
            recvs.append((left, me - 1))
    if k_right:
        if me > 0:
            sends.append((xz[:k_right], me - 1))
        if me + 1 < P:
            recvs.append((right, me + 1))
    _send_recv(sends, recvs)
    return left, right


def stencil1d(x: torch.Tensor, count, weights: Sequence[float], center: int,
              P: int = 1, kernels=None, exact: bool = False):
    """out[i] = sum_j w[j] * x[i + j - center] over the distributed valid
    prefix, halos from the neighbouring ranks (the paper's SMA/WMA).  The
    weighted sum runs in the registry's ``stencil1d``.

    ``exact=True`` renormalizes rows near the GLOBAL borders by the realized
    weight mass: the mass is the same stencil of a ones vector through the
    same halo machinery, so a tap into a populated neighbour rank counts
    while a tap past the global ends does not.  Both stencils and the
    renormalize run in ONE ``stencil1d_exact`` kernel pass.
    """
    w = [float(v) for v in weights]
    k_left, k_right = center, len(w) - 1 - center
    cap = x.shape[0]
    dev = x.device
    valid = valid_mask(count, cap)

    def build_ext(vals):
        vz = torch.where(valid, vals.to(torch.float32), 0.0)
        left, right = halo_exchange(vz, count, k_left, k_right, P)
        # ext[k_left + i] = v[i] (valid rows); the right halo lands AT the
        # dynamic position k_left + count, so windows never straddle padding
        ext = torch.zeros(cap + k_left + k_right, dtype=torch.float32,
                          device=dev)
        ext[k_left:k_left + cap] = vz
        if k_right:
            pos = (k_left + count.to(torch.int64)
                   + torch.arange(k_right, device=dev))
            ext.index_copy_(0, pos, right)
        if k_left:
            ext[:k_left] = left
        return ext

    kset = _K(kernels, x)
    if exact:
        out = kset.stencil1d_exact(
            build_ext(x), build_ext(torch.ones(cap, device=dev)), w)
    else:
        out = kset.stencil1d(build_ext(x), w)
    return torch.where(valid, out, 0.0)


# ---------------------------------------------------------------------------
# limit (first n rows in global rank-concatenation order; df.head backend)
# ---------------------------------------------------------------------------

def limit(cols: dict[str, torch.Tensor], count, n: int, P: int, cap_out: int,
          method: str = "allgather"):
    """Keep the first ``n`` valid rows of the global concatenation.

    No rows move: each rank clamps its valid count to its slice of
    ``[0, n)`` through an exclusive scan of the counts (a REP input passes
    P = 1: every rank keeps its own first ``n``).  Buffers shrink to
    ``cap_out`` as views (the clamped count is <= n <= cap_out).
    """
    count = count.to(torch.int32)
    base = exscan_scalar(count, P, method=method)
    cnt = torch.minimum((n - base).clamp(min=0), count).to(torch.int32)
    return {k: v[:cap_out] for k, v in cols.items()}, cnt


# ---------------------------------------------------------------------------
# rebalance (1D_VAR -> 1D_BLOCK) and sample sort
# ---------------------------------------------------------------------------

def rebalance(cols: dict[str, torch.Tensor], count, *, P: int,
              bucket_cap: int, cap_out: int, kernels=None,
              packed: bool = True):
    """Even out row counts across ranks, keeping the global row order:
    global row g goes to rank ``g // ceil(total / P)``.  At P == 1 it is a
    compaction of the valid prefix."""
    cap = next(iter(cols.values())).shape[0]
    if P == 1:
        return compact(cols, valid_mask(count, cap), cap_out, kernels=kernels)
    counts = _all_gather_scalars(count.to(torch.int32), P)
    total = counts.sum(dtype=torch.int32)
    base = counts[:_rank_of(P)].sum(dtype=torch.int32)
    block = torch.clamp((total + P - 1) // P, min=1)
    g = base + torch.arange(cap, dtype=torch.int32, device=count.device)
    dest = torch.where(valid_mask(count, cap), g // block, P).to(torch.int32)
    return exchange(cols, count, dest, P=P, bucket_cap=bucket_cap,
                    cap_out=cap_out, kernels=kernels, packed=packed)


def sample_sort(cols: dict[str, torch.Tensor], count, key_names, *, P: int,
                bucket_cap: int, cap_out: int, n_samples: int = 64,
                ascending: bool = True, pre_sorted: bool = False,
                kernels=None, packed: bool = True):
    """Global sort: local sort -> splitter selection -> route -> local sort.

    ``key_names`` may name several columns (lexicographic order, all
    ascending or all descending); ``pre_sorted=True`` skips the first local
    sort (the planner sets it when the input already has the order).

    Every rank samples ``n_samples`` key tuples evenly from its valid
    prefix (an empty rank sends sentinels), one ``all_gather`` a key column
    collects them, and P - 1 splitter tuples are taken at even quantiles
    of their lexicographic order.  A row goes to the number of splitters
    at or below it (``side="right"``, so rows that tie a splitter stay
    together): by ``torch.searchsorted`` on one key, by dense ranks over
    the rows and the splitters (:func:`lex_ranks`) on several.  After the
    exchange a local sort orders each rank; a descending sort routes to
    ``P - 1 - dest`` and reverses each rank's valid prefix.
    """
    if isinstance(key_names, str):
        key_names = (key_names,)
    key_names = tuple(key_names)
    scols = cols if pre_sorted else local_sort(cols, count, key_names)[0]
    k0 = scols[key_names[0]]
    cap, dev = k0.shape[0], k0.device
    valid = valid_mask(count, cap)

    def masked(v):
        return torch.where(valid, v, _sentinel(v.dtype))

    if P > 1:
        # sample positions in int64: i * count leaves int32 past 2^25 rows
        pos = (torch.arange(n_samples, device=dev)
               * count.to(torch.int64).clamp(min=1)) // n_samples
        pos = pos.clamp(0, max(cap - 1, 0))
        samples = []
        for kn in key_names:
            kv = scols[kn]
            samp = (torch.where(count > 0, kv[pos], _sentinel(kv.dtype))
                    if cap else torch.full((n_samples,), _sentinel(kv.dtype),
                                           dtype=kv.dtype, device=dev))
            samples.append(all_gather_rows(samp, P))         # (P * n,)
        perm = _lex_perm(samples)
        qpos = torch.arange(1, P, device=dev) * (P * n_samples) // P
        splitters = [s[perm][qpos] for s in samples]
        if len(key_names) == 1:
            dest = torch.searchsorted(_sortable(splitters[0]).contiguous(),
                                      _sortable(masked(k0)).contiguous(),
                                      right=True)
        else:
            # dense ranks over rows and splitters: the splitters' ranks
            # ascend, so a search on ranks IS the tuple comparison
            joint = [torch.cat([masked(scols[kn]), sp])
                     for kn, sp in zip(key_names, splitters)]
            jvalid = torch.cat([valid, torch.ones(P - 1, dtype=torch.bool,
                                                  device=dev)])
            ranks = lex_ranks(joint, jvalid)[0]
            dest = torch.searchsorted(ranks[cap:].contiguous(),
                                      ranks[:cap].contiguous(), right=True)
        dest = dest.to(torch.int32)
        if not ascending:
            dest = (P - 1) - dest
    else:
        dest = torch.zeros(cap, dtype=torch.int32, device=dev)
    out, cnt, ovf = exchange(scols, count, dest, P=P, bucket_cap=bucket_cap,
                             cap_out=cap_out, kernels=kernels, packed=packed)
    out, _ = local_sort(out, cnt, key_names)
    if not ascending:
        # reverse the valid prefix; padding rows stay where they are
        capo = out[key_names[0]].shape[0]
        ar = torch.arange(capo, device=dev)
        idx = torch.where(valid_mask(cnt, capo),
                          (cnt.to(torch.int64) - 1).clamp(min=0) - ar, ar)
        idx = idx.clamp(0, max(capo - 1, 0))
        out = {k: v[idx] for k, v in out.items()}
    return out, cnt, ovf


# ---------------------------------------------------------------------------
# concat
# ---------------------------------------------------------------------------

def concat(parts: Sequence[tuple[dict[str, torch.Tensor], torch.Tensor]],
           cap_out: int, kernels=None):
    """Vertical concat of per-rank tables: the parts stacked, then their
    valid prefixes compacted into one (counts add, padding squeezed)."""
    names = list(parts[0][0])
    stacked = {n: torch.cat([p[0][n] for p in parts]) for n in names}
    keep = torch.cat([valid_mask(c, next(iter(p.values())).shape[0])
                      for p, c in parts])
    return compact(stacked, keep, cap_out, kernels=kernels)
