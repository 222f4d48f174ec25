"""Physical operators of the relational main path, on torch tensors.

Every function here is *per-rank* code: it runs on one rank's
``(capacity,)`` column tensors plus a 0-d int32 valid-row ``count`` tensor,
eagerly, on the device the tensors live on.  Collectives go through
``torch.distributed`` (NCCL between cards, gloo on the CPU):

  MPI_Alltoallv  -> fixed-capacity bucketed all_to_all_single + count vector

All shapes are static and validity is tracked with counts and masks, as in
the reference package's ``core/physical.py``; results match it bit for bit
on integers, bools and hashes.  Counts and flags stay tensors on the device:
nothing here reads a value back to the host.  Key sentinel for sorts is the
dtype max, so padding sorts to the end.

Operators of later slices (windows, sort, rebalance, salting, limit, concat)
are not here yet; ``SALT_COL`` is kept because the planner names it.
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
# column packing — the byte-transport layer of the packed exchange
# ---------------------------------------------------------------------------

# The salt column a salted join's two SaltOps inject (planner vocabulary).
SALT_COL = "__salt__"

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


def pack_columns(cols: dict[str, torch.Tensor]):
    """Bitcast-pack every column into one (rows, W) int32 word matrix (the
    reference's uint32 words, same bits).  Returns ``(words, layout)``;
    ``layout`` is the ``(name, dtype, word_offset, n_words)`` recipe
    :func:`unpack_columns` inverts.  Floats keep their payload bits exactly:
    NaNs, signed zeros and all."""
    words, layout, off = [], [], 0
    for name, v in cols.items():
        dt = v.dtype
        if dt == torch.bool:
            w = v.to(torch.int32)[:, None]
        elif dt.itemsize == 4:
            w = v.contiguous().view(torch.int32)[:, None]
        elif dt.itemsize == 8:
            w = v.contiguous().view(torch.int32).reshape(-1, 2)
        elif dt.itemsize == 2:
            w = (v.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF)[:, None]
        else:
            w = v.contiguous().view(torch.uint8).to(torch.int32)[:, None]
        layout.append((name, dt, off, w.shape[1]))
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
    float sums go through the registry's ``segment_sums``.
    Returns ``({__key0__..., **aggs}, n_groups, overflow)``.
    """
    if not isinstance(keys_sorted, (tuple, list)):
        keys_sorted = (keys_sorted,)
    keys_sorted = tuple(keys_sorted)
    cap = keys_sorted[0].shape[0]
    dev = keys_sorted[0].device
    valid = valid_mask(count, cap)
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
            return _K(kernels, x).segment_sums(x.contiguous(), seg_id, v,
                                               cap_out)
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
