"""End-to-end smoke run of the PyTorch/CUDA package on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, in order; any failure raises and the exit code is not 0:

1. Report and build: the card's name and power limit, the nvcc build of
   every kernel in ``src/repro_torch/csrc`` (one process per source, in
   parallel), TF32 off for matmuls and cuDNN.
2. Kernel phases: each of the nine hand-written kernels against its plain
   PyTorch version on the card, at sizes 0 .. 2^27 (segment lengths 1, 64
   and 2^16; stencils of 1, 3, 5, 7 and 20 taps at centres 0, K // 2 and
   the main path's K - 1; decode_attention at the reference's test shapes
   in float32 and bfloat16 and at the moe and LM paths' decode shapes
   with lengths 1 .. the cache's rows, and at head widths 112 (the hybrid
   path's) and 96, in float32 and bfloat16, at the reference's shapes, a
   group of 4 and the hybrid's decode shape (8, 2112, 32, 1, 112) with
   lengths 1 .. 2112, timed there too beside SDPA, and at the vlm and
   encdec paths' decode shapes, qwen2-vl-2b's (16, 2176, 2, 6, 128) and
   whisper-base's self (32, 128, 8, 1, 64) and cross (32, 1500, 8, 1, 64),
   in float32 and bfloat16 with lengths 1 .. the rows, each timed beside
   SDPA), then held again and timed on the main path's inputs with CUDA
   events (median of 15 runs, each the mean of back-to-back calls filling
   ~2 ms) beside the plain version, one PyTorch library
   call where there is one, and its bound (the larger of bytes moved /
   3.35 TB/s and operations / 67 TFLOP/s).  The three look-back scans
   (prefix_sum, segment_scan, segment_rank) are also held on their hazards:
   sizes around the 5120-row tile and the 4-row vector, views not 16-byte
   aligned, two calls back to back, int32 sums past 2^31, one segment head
   at row 0 of 2^27 rows; torch.profiler shows each call running one
   kernel and at most one memset; 20 calls of the float32 scans on
   non-integer values give the same bits.  segment_sums (a look-back that
   reads only the valid prefix below its count and writes only run totals)
   is held on the slots the runs name, on the hazards of that contract
   around its 5120-row tile, on misaligned views and back to back, profiled
   as one kernel plus one memset, 20 calls with the same bits, and timed at
   the aggregate's partial and final stages and with every row its own run
   beside torch.segment_reduce.  bucket_scatter (a look-back
   over P counts) is held exactly at P = 1 .. 2048, around its tile, on one
   bucket, all rows invalid, an invalid tail, misaligned views and back to
   back calls, profiled as one kernel plus one memset, and timed at P = 8
   and 256 beside torch.sort(stable=True); at the moe path's P = 64 over
   each token's 6 distinct experts at n = 196,608 (its prefill) and 96 (a
   decode step) and 24,576 (a train micro-batch), held against the
   reference's one-hot cumsum rank too and
   timed at 196,608 beside it and torch.sort(stable=True).  The stencils
   are held bitwise (0 ulps) in every mode, also around their 4096-output
   tile, on ragged ends, on views not 16-byte aligned and past the 1024
   taps staged at once.  decode_attention's two entries over a cache
   sharded along S (decode_attention_partial, decode_attention_merge) at a
   rank's block of 1088 rows (two ranks' 2176-row caches) at the lm and moe
   paths' decode shapes and at the tp_serve path's, in float32 and
   bfloat16: each block's partial against the plain partial, the merge
   against the plain merge, the merged blocks against the one-call kernel
   and the plain version over the whole S, at lengths that leave a block
   empty; 20 calls of each with the same bits; each timed beside its plain
   version and its bound, with its device time.
3. The nineteen main paths, each with the launch counters zeroed just
   before it and read just after:
   - relational, through ``hf`` at P = 1: Fig. 8a filter, join and
     aggregate and TPCx-BB Q26 / Q26-multikey against numpy oracles;
     prefix_sum and segment_sums must have launched;
   - windows, through ``hf``: Fig. 8b cumsum, SMA, WMA and exact rolling
     mean at 2^25 rows, a partitioned WMA after a join and five chained
     grouped windows (cumsum, exact rolling mean, rank, dense_rank,
     row_number) over 2^25 rows in 5793 groups, against numpy oracles
     (cut from 2^27 rows in 11585 groups for the time limit, by half when
     tp_serve came and again when tp_train came);
     prefix_sum, segment_scan, segment_rank, stencil1d, stencil1d_exact and
     segment_stencil must have launched;
   - sort, through ``hf`` at P = 1: a global sort of Fig. 8a's table (2^25
     rows, cut from 2^27 for the time limit) and its descending head of
     1000, bench_validate.py's group-by ->
     join -> sort, rank / dense_rank / row_number over Fig. 8b's series by
     its values, an SMA after a filter (a Rebalance under the stencil), a
     concat of two halves feeding the Fig. 8a aggregate, and Fig. 12's Q26
     against a persisted and a cold item dimension, each twice, with the
     reference's plan counts; against numpy and scipy oracles; prefix_sum,
     segment_sums and stencil1d must have launched;
   - frame, through ``hf`` at P = 1 on bench_tpcx.py's string inputs at
     scale 32, cut from 64 for the tp_train path (12.8 M web clicks over
     Zipf-skewed items, 640 K items with a category name, 12.8 M store
     sales with a channel and a discount, 2 % of each null): Q05 over
     category names (its plan the int-category Q05's), the Q09 channel
     rollup, dropna -> fillna -> assign -> astype
     -> rename -> drop and a column from a string predicate feeding a
     group-by, the rows where either nullable column is null, a concat of
     two halves whose dictionaries differ, and a merge on category keys
     whose dictionaries only overlap; against numpy, the host's dictionary
     encoding timed apart; prefix_sum and segment_sums must have launched;
   - segmentation, the paper's customer-segmentation program
     (examples/customer_segmentation.py: min_count 4, 8 centroids, 20
     iterations) through ``hf`` at P = 1 on Q26's tables at scale 64: the
     fluent Q26 stage with its count filter a UDF (2,881,085 rows, exact),
     ``collect_matrix`` of the four features (the plan's collect-block
     rebalance; rows exact), K-means in PyTorch on the card (TF32 off; each
     iteration held in float64: every row at its nearest centroid and every
     centroid its rows' mean, within relative 1e-5), the cluster ids back
     into the features' frame as a free array, then ``size``, ``mean``, a
     selected ``sum``, ``transform("mean")`` and ``head(3)`` by cluster
     (head's plan one exchange and one local sort) against numpy; then
     Fig. 10's built-in and UDF filters over 2^27 rows with the same plan
     and rows, their walls, overhead and aten op histograms; prefix_sum,
     segment_sums and segment_rank must have launched;
   - guardrails, through ``hf`` at P = 1: Fig. 8a's join shape (2^25 probe
     rows, 35 % on key 3, as tests/test_skew.py's, against a 2^21-row
     dimension; each cut by half for the time limit) under adaptive
     statistics, planned with 2 SaltOps and a salted MergeJoin, beside the
     same join unsalted (rows exact, on the card; the salting's build side
     launches prefix_sum); 2^25 Zipf(1.5)
     keys summed and counted under adaptive capacities (no overflow on the
     first run, the second sized from the realized group count) beside
     safe capacities, with their peak memory; Fig. 8a's aggregate and Q26
     with and without ``validate`` (no invariant failure, the same rows,
     both walls); Fig. 8a's aggregate healed after a forced overflow (one
     retry, rendered by explain()) and after a packed-exchange corruption
     (degraded to the unpacked exchange), and a kernel fault that raises
     KernelBackendError; prefix_sum and segment_sums must have launched;
   - serve, through ``repro_torch.launch.serve`` at P = 1: a Session
     registers store_sales (25.6 M rows, hash-partitioned on ss_item_sk)
     and item (256 k rows, replicated), timed with its collectives; two
     passes of the three-query mix (Q26, per-item sums, a global
     leaderboard rank), each query twice through ``submit``: pass 2 all
     hits, no ``Lowered`` built, fewer collectives than pass 1 with
     registration, its rows bitwise pass 1's, both against numpy, the same
     prefix_sum and segment_sums launches in both; a second store_sales
     (seed 7) served by the same plans, rebound, with its own rows; the
     memory held after store_sales is registered again (does the cache pin
     the replaced shards?); the mix as one-shot collect()s over host
     tables; a 4-shard block state of store_sales with uneven counts
     merged to P = 1 by ``reshard`` (one index_select, no host gather);
     prefix_sum and segment_sums must have launched;
   - exchange_p2, two ranks on the one card joined by gloo (NCCL refuses
     two ranks on one card; gloo stages CUDA tensors through the host):
     Fig. 8a join at 2^22 x 2^18 rows, Q26 at scale 16, a sort of Fig.
     8a's table and a global rank of the series at 2^22 rows (each cut by
     half for the time limit when dp_train came, and again when tp_train
     came), the SMA after a filter,
     Fig. 12's two Q26 legs, and the frame path's Q05 over category names
     and merge on category keys (each rank encoding the host tables
     itself, the dictionaries equal on both), ``transform("sum")`` and
     ``head(2)`` over 2^22 rows in 9 groups (a third in one), and the
     segmentation program's ``collect_matrix`` (each rank's count its
     1D_BLOCK block, bucket_scatter launched in each), the guardrails' skew
     join at 2^21 x 2^19 salted and unsalted (the salted per-rank max/mean
     lower, as many all_to_all), and Fig. 8a's aggregate at 2^22 rows
     healed after a forced overflow and a corruption, and the serving
     session over a 2^22-row store_sales (six concurrent submits with the
     same cache outcomes on both ranks; a 1-shard state registered, split
     1 -> 2 and its hash claim re-established by one exchange, then grouped
     on its key with no exchange), through ``hf`` at P = 2,
     rows against numpy
     oracles, all_to_all calls against the plan's shuffle census (the
     persisted leg's fewer than the cold leg's), each rank of the sort
     holding a quarter of the rows or more; bucket_scatter must have
     launched in each rank, prefix_sum in the sum over the ranks;
   - dp_train, two ranks on the one card joined by gloo (launch/mesh.py's
     backend where ranks share a card), through ``launch.train.run`` on
     ``make_local_mesh(model_axis=1)``: first at qwen3-0.6b's full width
     and 2 layers in float32 (TF32 off) on a global batch of 8 x 512
     tokens, (a) the data-parallel loss and summed gradients against one
     rank's on the whole batch (within 1e-4 relative; 1e-4 x each leaf's
     largest |g|), (b) a ZeRO-1 step's moments (each rank's blocks of
     ``zero1_spec``'s layout) against a replicated-moment step's (within
     1e-6 of each leaf's largest), and the optimizer bytes a rank of each,
     (c) ``tree_compressed_psum`` of the gradients within half a
     quantisation step of their plain mean, its error buffers exact and
     its means the same on both ranks; then qwen3-0.6b at 14 layers (bf16,
     remat per block, ZeRO-1) trained 3 steps of a global 8 x 2048 tokens
     (4 x 2048 a rank) from the token pipeline at P = 2 over 2^16
     documents, every loss finite and the first within 0.5 of ln V; (d)
     the one checkpoint restored at P = 1 (bitwise against the gathered
     live state) and at P = 2 (bitwise blocks, and the first step's loss
     from it equal to the live state's); (e) that step's collectives by
     kind, calls and bytes, against the ZeRO-1 layout.  prefix_sum and
     bucket_scatter must have launched in each rank;
   - tp_train, in dp_train's two ranks on a (data 1, model 2) mesh over the
     same world, through ``launch.steps.make_train_step`` and
     ``launch.train.run`` (models/tp.py's autograd collectives, the
     vocabulary-parallel loss): at full width and 2 layers in float32 (TF32
     off) on a global batch of 8 x 512 tokens, (a) qwen3-0.6b and (b)
     deepseek-moe-16b expert-parallel (its first dense layer and one MoE
     layer) against one rank's step without a mesh (the gspmd block): the
     loss within 1e-4 relative, each gradient within 1e-4 of its leaf's
     largest |g|, the parameters after one AdamW step within 2 lr where
     |g| is below 1e-4 of its leaf's largest and within rtol 1e-5, atol
     1e-2 lr elsewhere; (b) must launch bucket_scatter at P = 33 once a MoE
     layer in the forward and once in the recomputation; then (c)
     qwen3-0.6b at 14 layers (bf16, remat per block, ZeRO-1) trained 3
     steps of a global 4 x 2048 tokens from the token pipeline, every loss
     finite and the first within 0.5 of ln V, and one more step's
     collectives by kind against the layout (``tp_train_layout``);
     prefix_sum and bucket_scatter must have launched in each rank;
   - tp_serve, in dp_train's two ranks on a (data 1, model 2) mesh over the
     same world, through ``repro_torch.launch.steps`` (bf16, random weights
     from a seed, each rank holding its blocks by the reference's rules):
     qwen3-0.6b at full width and depth prefills 8 prompts of 2048 tokens
     into 2176-row caches (1088 rows a rank) and decodes 32 greedy tokens
     (picked across the ranks' vocabulary blocks); deepseek-moe-16b at full
     width and 4 layers (the first dense layer and 3 MoE layers,
     expert-parallel) prefills 4 x 2048 and decodes 16.  Each rank must
     launch decode_attention_partial and decode_attention_merge once a
     layer and decode step, bucket_scatter once a MoE layer in the prefill
     and each step (P = 33 buckets), and no whole decode_attention; one
     decode step of each under torch.profiler must show the split, combine
     and scatter_tiles kernels; a decode step's collectives must be the
     rules' layout.  Then the holds: at 2 layers in float32 the mesh's
     prefill and decode logits within 1e-4 relative of one rank's without
     a mesh, and at the path's size in bf16 the mesh's largest logit
     deviation from one rank's bf16 run no larger than one rank's
     bf16-against-float32 deviation on the same prompts and tokens;
   - lm, through ``repro_torch.launch.steps`` as examples/serve_lm.py
     drives the reference: qwen3-0.6b (28 layers, bf16, random weights from
     a seed) serves 32 prompts of 2048 tokens with 128 greedy new tokens;
     decode_attention must have launched exactly 28 x 128 times.  After the
     path, the served logits of two requests are held against the port's
     own no-cache forward (within 0.1), and the same path at 2 layers in
     float32 (within 1e-3);
   - train, through ``repro_torch.launch.train.run`` as its ``main``
     drives it: the HiFrames token pipeline over ``synth.token_corpus``'s
     2^24 documents (~17 G tokens) on the card (filter, int32 packing
     cumsum, bucket aggregate), against numpy (rows and seeds exact,
     offsets and sums as wrapping int32, the int64 total beside); then
     qwen3-0.6b (14 of its 28 layers, bf16, remat per block, random
     weights from a seed) trained 10 AdamW steps of 8 x 2048 tokens under the
     fault-tolerant driver, checkpoints every 5 steps: every loss finite,
     the first within 0.5 of ln V; a restore into a fresh state, bitwise;
     two more steps from the live and the restored state (the first loss
     equal, the second within 1e-2); the step at 2 layers in float32 held
     against the CPU (losses within 1e-4 relative).  prefix_sum must have
     launched, decode_attention must not;
   - moe, through ``repro_torch.launch.steps``: deepseek-moe-16b as
     published (28 layers, 1 dense + 27 MoE of 64 experts, top 6, 2 shared;
     bf16, random weights from a seed, 32.75 GB) serves 16 prompts of 2048
     tokens with 128 greedy new tokens; decode_attention must have launched
     exactly 28 x 128 times and bucket_scatter (each MoE layer's ranks
     within its experts) 27 x (1 + 128).  After the path: the same weights
     at capacity factor E / top_k (no row dropped, checked) serve 2 x 256
     prompt tokens + 32 new, held against the no-cache forward (within
     0.1), and 2 layers (1 dense + 1 MoE) at full width in float32 are held
     against the CPU: a full forward and a prefill + decode (logits within
     1e-3) and the train step's loss (within 1e-4 relative) and gradient
     (each leaf within 1e-4 x its largest |g|, remat per block as trained);
   - moe_train, through ``repro_torch.launch.train.run``: deepseek-moe-16b
     at full width and 2 layers (1 dense + 1 MoE, bf16, remat per block)
     trained 5 AdamW steps of 8 x 2048 tokens in 4 micro-batches on a
     2^16-document token corpus; every loss finite, the first within 0.5
     of ln V; the one checkpoint restored into a fresh state, bitwise.
     prefix_sum and bucket_scatter must have launched, decode_attention
     must not;
   - ssm, through ``repro_torch.launch.steps``: falcon-mamba-7b as
     published (64 Mamba1 layers, d 4096, d_inner 8192, state 16, dt_rank
     256, V 65024, chunk 256; bf16, random weights from a seed, 13.55 GiB)
     serves 8 prompts of 2048 tokens with 64 greedy new tokens;
     decode_attention must not launch (no attention, no kernel on the
     path: the scan is plain PyTorch);
   - hybrid, the same way: zamba2-7b as published (81 Mamba2 layers, d
     3584, d_inner 7168, 112 heads of 64, state 64, chunk 64; one shared
     attention + SwiGLU block of 32 heads of 112, ff 14336, after every 6
     layers and after the tail; V 32000; 12.7 GiB) serves 8 x 2048 prompt
     tokens + 64 new (max_seq 2112); decode_attention must have launched
     exactly 14 x 64 = 896 times, at hd 112.
   After each of the two: the served logits of two requests against the
   port's own no-cache forward (within 0.1); one layer of the prefill timed
   beside its scan alone, with the scan's bound; and the full widths in
   float32 (falcon at 2 layers, zamba2 at 3 of period 2: one group and a
   tail) held against the CPU: a forward and a prefill of 56 tokens + 8
   decode steps (logits within 1e-3) and the train step on 2 x 64 tokens
   (remat as trained; the loss within 1e-4 relative, each gradient leaf
   within 1e-4 x its largest |g|);
   - vlm, through ``repro_torch.launch.steps``: qwen2-vl-2b as published
     (28 layers, d 1536, 12 heads over 2 KV heads of 128, ff 8960, V
     151936, qkv_bias, M-RoPE (16, 24, 24); bf16, random weights from a
     seed, 1.54 B parameters) serves 16 requests of 2048 prompt positions,
     each 64 + 16 r text tokens, one 32 x 32 grid of 1024 visual tokens
     (stub embeddings from a seed) and text, at Qwen2-VL's rope index,
     with 128 greedy new tokens at the reference's decode positions;
     decode_attention must have launched exactly 28 x 128 times;
   - encdec, the same way: whisper-base as published (6 + 6 layers, d
     512, 8 heads of 64, ff 2048, V 51865; bf16, seeded) serves 32
     requests of 1500 seeded frame embeddings behind the 4-token
     start-of-transcript prompt with 124 greedy new tokens;
     decode_attention must have launched exactly 2 x 6 x 124 times (the
     self-attention and the cross-attention over the 1500 frames).
   After each of the two: the served logits of two requests against the
   no-cache forward (within 0.1), and the full widths in float32 (qwen2-vl
   at 2 layers, whisper at full depth) held against the CPU: a forward and
   a prefill (qwen2-vl: 128 positions with an 8 x 8 image; whisper: 1500
   frames and 24 tokens) + 8 decode steps (logits within 1e-3), and the
   train step (remat per block; the loss within 1e-4 relative, each
   gradient leaf within 1e-4 x its largest |g|).
4. Report: a JSON line of query wall times, LM serving and training times, peak memory
   and the checks' largest differences (with a digest of the bytes of the
   float32 cumsums, fig8b_cumsum's and the grouped one's, and of
   fig8a_aggregate's sums and means, to compare two runs), a JSON line of
   the nine kernel records, and a last line
   ``{"ok": true, "device": {...}}``.

``--quick`` stops after phase 2 at sizes up to 1_000_003 and prints ptxas's
register and shared-memory report: a short first check of new kernels.
``--profile DIR`` runs every query a second time under ``torch.profiler``
and writes its per-op device-time table to ``DIR/profile_<query>.txt``, and
profiles 4 LM decode steps (``DIR/profile_lm_decode.txt``) and one train
step (``DIR/profile_train_step.txt``).  These traces
come minutes after the process's first profiler session and may miss
device events (see ``one_call_profiles``).
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_OPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores
REPEATS = 15


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, torch) -> float:
    """Median milliseconds of one ``fn()`` over REPEATS runs (CUDA events),
    after one warm-up run.  A run calls ``fn`` back to back as many times
    as fill about 2 ms (at least once) and counts the mean, so the host's
    work of launching a short kernel overlaps the device's, as in a stream
    of calls, and is not timed as device time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(50, int(2e-3 / max(time.perf_counter() - t0, 1e-6))))
    times = []
    for _ in range(REPEATS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def host_us(torch, fn, rounds: int = 15, calls: int = 50) -> float:
    """Median host microseconds of one ``fn()`` over rounds of ``calls``
    calls back to back, synchronised between rounds: the time the host
    spends in a call (checks, allocation, launch), as long as the device
    keeps up and the launch queue never fills."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound_ms(bytes_moved: float, ops: float) -> tuple[float, str]:
    tb, to = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def traced(torch, fn, margin: float = 0.02):
    """Run ``fn()`` once under torch.profiler, ``margin`` seconds inside the
    traced window.  Returns the profile, the device events it holds (name
    -> count) and the number of host events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        fn()
        torch.cuda.synchronize()
        time.sleep(margin)
    seen: dict = {}
    host = 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            host += e.count
        elif not e.key.startswith("Activity Buffer"):
            seen[e.key[:80]] = seen.get(e.key[:80], 0) + e.count
    return prof, seen, host


def one_launch(torch, fn, kernel: str, tag: str) -> dict:
    """Profile one ``fn()`` (torch.profiler) and assert that the card ran
    exactly one kernel whose name holds ``kernel``, at most one memset and
    nothing else.  Returns the device events seen, name -> count.  The call
    sits 20 ms inside the traced window.  A trace that holds no device
    event at all, not even the memset, is taken again, up to five times:
    the count is asserted on the first trace that holds any."""
    for _ in range(5):
        _, seen, host = traced(torch, fn)
        if seen:
            break
        log(f"{tag}: the profiler recorded no device event ({host} host "
            f"events); again")
    mine = sum(c for k, c in seen.items() if kernel in k)
    memsets = sum(c for k, c in seen.items() if "memset" in k.lower())
    assert mine == 1 and memsets <= 1 and mine + memsets == sum(seen.values()), \
        f"{tag}: one call ran {seen}"
    return seen


# The look-back scans of csrc/lookback.cuh (prefix_sum, segment_scan,
# segment_rank): ragged sizes around the 5120-row tile and the 4-row vector,
# and one size whose tiles look back past a window of 32.
LOOKBACK_KERNEL = "scan_tiles"
LOOKBACK_SIZES = (1, 3, 4, 5, 5119, 5120, 5121, 10239, 10241, 33 * 5120 + 5)


def misaligned(t):
    """A contiguous view of ``t``'s data one element in: not 16-byte
    aligned, so the wrapper picks the kernel's WORDS fetch (4-byte loads)."""
    v = t[1:]
    assert v.data_ptr() % 16 != 0
    return v


def wrapped(x):
    """The int32 prefix sums of ``x`` modulo 2^32, from int64."""
    c = x.long().cumsum(0)
    return ((c + 2**31) % 2**32 - 2**31).int()


def same_bits(torch, call, tag: str, times: int = 20) -> int:
    """Call ``call()`` ``times`` times and assert that every float32 result
    has the bits of the first; returns ``times``."""
    bits = call().view(torch.int32)
    for i in range(times - 1):
        assert torch.equal(call().view(torch.int32), bits), \
            f"{tag}: call {i + 2} of {times} differs from the first"
    return times


def digest(a: np.ndarray) -> str:
    """A short hash of an array's bytes, to compare two runs' results."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def one_call_profiles(torch, n: int) -> dict:
    """One call of each look-back wrapper under torch.profiler (prefix_sum
    and segment_scan in int32 and float32, the three rank kinds,
    bucket_scatter at P = 8 and 256, segment_sums at its partial and final
    stages; n rows): one scan_tiles (or scatter_tiles, sum_tiles) kernel and
    at most one memset each.  These must be the process's first
    torch.profiler sessions, and are taken within a second of each other:
    on an H100 (torch 2.11, CUDA 12.8) the device timestamps of a trace
    drift from its host timeline from about 10 s after the process's first
    session on, and within a minute most traces hold no device event at
    all, with or without work in between (tools/profiler_probe.py)."""
    from repro_torch.kernels.hash_partition import hash_partition as hp
    from repro_torch.kernels.segment_rank import segment_rank as rk
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    from repro_torch.kernels.segment_scan import segment_scan as ss
    from repro_torch.kernels.stream_compact import stream_compact as sc
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randint(-8, 9, (n,), device=dev, generator=g, dtype=torch.int32)
    seg = (torch.rand(n, device=dev, generator=g) < 1 / 64).int()
    seg[:1] = 1
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.3).int()
    out = {"prefix_sum": {str(v.dtype): one_launch(
        torch, lambda: sc.prefix_sum_cuda(v), LOOKBACK_KERNEL,
        f"prefix_sum {v.dtype}") for v in (x, x.float())}}
    out["segment_scan"] = {str(v.dtype): one_launch(
        torch, lambda: ss.segment_scan_cuda(v, seg), LOOKBACK_KERNEL,
        f"segment_scan {v.dtype}") for v in (x, x.float())}
    out["segment_rank"] = {kind: one_launch(
        torch, lambda: rk.segment_rank_cuda(seg, ordb, kind), LOOKBACK_KERNEL,
        f"segment_rank {kind}") for kind in rk.KINDS}
    dest = {P: torch.randint(0, P + 1, (n,), device=dev, generator=g,
                             dtype=torch.int32) for P in BUCKET_TIMED_PS}
    out["bucket_scatter"] = {f"P={P}": one_launch(
        torch, lambda: hp.bucket_scatter_cuda(dest[P], P), BUCKET_KERNEL,
        f"bucket_scatter P={P}") for P in BUCKET_TIMED_PS}
    # the partial stage's shape (sorted ids in 4096 groups, count = n) and
    # the final stage's (4096 rows of n, count = 4096)
    sid = (torch.arange(n, device=dev) * SUMS_GROUPS // n).to(torch.int32)
    vals = x.float()
    every = torch.ones(n, dtype=torch.bool, device=dev)
    counts = {stage: torch.tensor(c, dtype=torch.int32, device=dev)
              for stage, c in (("partial", n), ("final", SUMS_GROUPS))}
    out["segment_sums"] = {stage: one_launch(
        torch, lambda: sr.segment_sums_cuda(vals, sid, every, n, c),
        SUMS_KERNEL, f"segment_sums {stage}") for stage, c in counts.items()}
    log(f"one call each: {out}")
    return out


# bucket_scatter (csrc/bucket_scatter.cu): the bucket counts it is held at
# (384: kimi-k2's experts), and the two it is timed at (a node of 8 cards;
# a 256-rank deployment)
BUCKET_PS = (1, 2, 8, 255, 256, 384, 1024, 2048)
BUCKET_TIMED_PS = (8, 256)
BUCKET_KERNEL = "scatter_tiles"
# and at the moe paths' shapes: P = E = 64 over the T·k rows of
# deepseek-moe-16b's prefill (16 x 2048 tokens, top 6), decode step (16
# tokens) and train micro-batch (8 // 4 x 2048 tokens), timed at the
# prefill's
MOE_BUCKET_P = 64
MOE_BUCKET_NS = (16 * 2048 * 6, 16 * 6, 8 // 4 * 2048 * 6)


def bucket_scatter_phases(torch, sizes, record: dict):
    """bucket_scatter against its plain version: counts exact, slots exact
    wherever dest < P (the rest are don't-care), at every P of BUCKET_PS,
    at ``sizes`` and around the kernel's tile (T - 1, T, T + 1, a few tiles
    and 40 tiles with ragged ends); on its hazards: every row in one
    bucket, every row invalid, invalid rows scattered and as a tail, a view
    not 16-byte aligned (the WORDS fetch), two calls back to back (the
    second gets the first's freed status words, which the kernel must
    clear).  Then timed at n = sizes[-1] for P in BUCKET_TIMED_PS beside
    the plain version, its bound and torch.sort(stable=True) (a reference
    point: it sorts, and is not the same function)."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.hash_partition import hash_partition as hp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    lib = cuda.load("bucket_scatter")
    tiles = {P: lib.bucket_scatter_tile(P) for P in BUCKET_PS}

    def held(dest, P, tag, got=None):
        r1, c1 = got if got is not None else hp.bucket_scatter_cuda(dest, P)
        r2, c2 = hp.bucket_scatter_plain(dest, P)
        ok = (dest >= 0) & (dest < P)
        assert torch.equal(c1, c2), f"bucket_scatter counts P={P} {tag}"
        assert torch.equal(r1[ok], r2[ok]), f"bucket_scatter slots P={P} {tag}"

    def ids(n, P, invalid=0.0):
        """Bucket ids in [0, P), a share ``invalid`` of them P."""
        d = torch.randint(0, P, (n,), device=dev, generator=g, dtype=torch.int32)
        if invalid:
            d[torch.rand(n, device=dev, generator=g) < invalid] = P
        return d

    for P in BUCKET_PS:
        tile = tiles[P]
        edges = (tile - 1, tile, tile + 1, 3 * tile + 5, 40 * tile + 3)
        for n in sizes + list(edges):
            held(ids(n, P, 1 / (P + 1)), P, f"n={n}")
        for n in edges + (sizes[-2],):
            held(torch.full((n,), P - 1, dtype=torch.int32, device=dev), P,
                 f"one bucket n={n}")
            held(torch.full((n,), P, dtype=torch.int32, device=dev), P,
                 f"all invalid n={n}")
            d = ids(n, P, 1 / 6)
            d[n - n // 5:] = P
            held(d, P, f"invalid scattered and as a tail n={n}")
            held(misaligned(ids(n + 1, P, 1 / 6)), P, f"misaligned n={n}")
            a, b = ids(n, P, 1 / 6), ids(n, P)
            ga, gb = hp.bucket_scatter_cuda(a, P), hp.bucket_scatter_cuda(b, P)
            held(a, P, f"back to back (first) n={n}", ga)
            held(b, P, f"back to back (second) n={n}", gb)
        log(f"bucket_scatter P={P}: ok at sizes {sizes} and {edges}, one "
            f"bucket, all invalid, invalid tail, misaligned, back to back")

    n = sizes[-1]
    by_p = {}
    for P in BUCKET_TIMED_PS:
        dest = ids(n, P)
        held(dest, P, f"timed inputs n={n}")
        k = {"ms": time_ms(lambda: hp.bucket_scatter_cuda(dest, P), torch),
             "plain_ms": time_ms(lambda: hp.bucket_scatter_plain(dest, P),
                                 torch),
             "stable_sort_ms": time_ms(
                 lambda: torch.sort(dest, stable=True), torch)}
        k["bound_ms"], k["bound_by"] = bound_ms(8.0 * n + 4 * P, n)
        by_p[P] = k
        del dest
    rec = {"name": "bucket_scatter", "route": "cuda",
           "source": "src/repro_torch/csrc/bucket_scatter.cu",
           "replaces": "src/repro/kernels/hash_partition/hash_partition.py:44",
           "shape": f"int32 dest, n={n}, P=256", "max_abs_err": 0.0,
           **by_p[256], "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent; stable_sort_ms is "
                           "torch.sort(dest, stable=True), a reference point",
           "tile_rows_by_p": tiles, "by_p": by_p}

    # the moe path's shapes: each token's top_k distinct experts
    P, k = MOE_BUCKET_P, 6

    def expert_ids(n):
        d = torch.rand((n // k, P), device=dev, generator=g).argsort(1)[:, :k]
        return d.reshape(-1).to(torch.int32).contiguous()
    for n in MOE_BUCKET_NS:
        held(expert_ids(n), P, f"moe n={n}")
    n = MOE_BUCKET_NS[0]
    dest = expert_ids(n)
    held(dest, P, f"moe timed inputs n={n}")

    def onehot_rank():
        # the reference's formula (src/repro/models/moe.py:83-85) in torch
        onehot = torch.nn.functional.one_hot(dest.long(), P).to(torch.int32)
        return ((torch.cumsum(onehot, 0, dtype=torch.int32) - onehot)
                * onehot).sum(1, dtype=torch.int32)
    assert torch.equal(onehot_rank(), hp.bucket_scatter_cuda(dest, P)[0]), \
        "bucket_scatter against the one-hot cumsum rank"
    moe = {"n": n, "P": P,
           "ms": time_ms(lambda: hp.bucket_scatter_cuda(dest, P), torch),
           "plain_ms": time_ms(lambda: hp.bucket_scatter_plain(dest, P), torch),
           "onehot_cumsum_ms": time_ms(onehot_rank, torch),
           "stable_sort_ms": time_ms(lambda: torch.sort(dest, stable=True),
                                     torch)}
    moe["bound_ms"], moe["bound_by"] = bound_ms(8.0 * n + 4 * P, n)
    rec["moe_p64"] = moe
    log(f"bucket_scatter P={P}: ok at the moe path's n = {MOE_BUCKET_NS}; "
        f"timed {moe}")
    record["bucket_scatter"] = rec


def kernel_phases(torch, sizes, record: dict):
    from repro_torch.kernels import cuda
    from repro_torch.kernels.stream_compact import stream_compact as sc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # -- prefix_sum: int32 exact; float32 with integer values exact (every
    # partial sum is an integer below 2^24); float32 normal values within
    # 1e-5 of the running sum of |x|.
    err = 0.0
    for n in sizes:
        xi = torch.randint(-1000, 1000, (n,), device=dev, generator=g,
                           dtype=torch.int32)
        got, want = sc.prefix_sum_cuda(xi), sc.prefix_sum_plain(xi)
        assert torch.equal(got, want), f"prefix_sum int32 n={n}"
        xf = torch.randint(-8, 9, (n,), device=dev, generator=g).float()
        got, want = sc.prefix_sum_cuda(xf), sc.prefix_sum_plain(xf)
        assert torch.equal(got, want), f"prefix_sum f32 (integer values) n={n}"
        if 0 < n <= 1 << 22:
            xn = torch.randn(n, device=dev, generator=g)
            got, want = sc.prefix_sum_cuda(xn), sc.prefix_sum_plain(xn)
            tol = 1e-5 * torch.cumsum(xn.abs().double(), 0) + 1e-4
            d = (got.double() - want.double()).abs()
            assert bool((d <= tol).all()), f"prefix_sum f32 n={n}"
            err = max(err, float(d.max()))
        log(f"prefix_sum n={n}: ok")
    # the look-back hazards: ragged sizes; views not 16-byte aligned (the
    # WORDS fetch); two calls back to back on other inputs of one length
    # (the second gets the first's freed status words from the allocator,
    # which the kernel must clear); int32 sums that wrap past 2^31 (exact
    # modulo 2^32).
    for n in LOOKBACK_SIZES + (sizes[-2],):
        for dt in (torch.int32, torch.float32):
            xs = [torch.randint(-8, 9, (n + 1,), device=dev, generator=g).to(dt)
                  for _ in range(2)]
            x = misaligned(xs[0])
            assert torch.equal(sc.prefix_sum_cuda(x), sc.prefix_sum_plain(x)), \
                f"prefix_sum {dt} misaligned n={n}"
            a, b = (v[:n] for v in xs)
            ga = sc.prefix_sum_cuda(a)
            gb = sc.prefix_sum_cuda(b)
            assert torch.equal(ga, sc.prefix_sum_plain(a)) and \
                torch.equal(gb, sc.prefix_sum_plain(b)), \
                f"prefix_sum {dt} back to back n={n}"
    for n in LOOKBACK_SIZES + (sizes[-2], sizes[-1]):
        xw = torch.randint(-2**30, 2**30, (n,), device=dev, generator=g,
                           dtype=torch.int32)
        got = sc.prefix_sum_cuda(xw)
        assert torch.equal(got, wrapped(xw)), f"prefix_sum int32 wrap n={n}"
        assert torch.equal(got, sc.prefix_sum_plain(xw)), \
            f"prefix_sum int32 wrap against plain n={n}"
    del xw, got
    log(f"prefix_sum hazards: ok at sizes {LOOKBACK_SIZES}")

    n = sizes[-1]
    xi = (torch.rand(n, device=dev, generator=g) < 0.5).to(torch.int32)
    xf = xi.float()
    rec = {"name": "prefix_sum", "route": "cuda",
           "source": "src/repro_torch/csrc/prefix_sum.cu",
           "replaces": "src/repro/kernels/stream_compact/stream_compact.py:36",
           "shape": f"int32 keep flags, n={n}", "max_abs_err": err,
           "ms": time_ms(lambda: sc.prefix_sum_cuda(xi), torch),
           "plain_ms": time_ms(lambda: sc.prefix_sum_plain(xi), torch),
           "library_ms": time_ms(
               lambda: torch.cumsum(xi, 0, dtype=torch.int32), torch),
           "library_call": "torch.cumsum(dtype=torch.int32)",
           "f32_ms": time_ms(lambda: sc.prefix_sum_cuda(xf), torch),
           "f32_library_ms": time_ms(lambda: torch.cumsum(xf, 0), torch)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n, n)
    record["prefix_sum"] = rec
    del xi, xf

    bucket_scatter_phases(torch, sizes, record)

    segment_sums_phases(torch, sizes, record)
    cuda.reset_launches()


# segment_sums (csrc/segment_sums.cu): the main path's shapes, n = 2^27 rows
# in 4096 groups.  The partial stage of Fig. 8a's aggregate reduces n sorted
# rows (num_segments = cap_out = n); the final stage, after the exchange,
# 4096 partial rows at the front of an n-row buffer (count = 4096).
SUMS_KERNEL = "sum_tiles"
SUMS_GROUPS = 4096
SUMS_HAZARDS = ("count_0", "count_short", "count_past", "no_count",
                "padding_valid", "one_run", "each_row", "all_invalid",
                "overflow", "holes")


def sums_case(torch, g, hazard: str, n: int):
    """One hazard of segment_sums' contract on the card: (values, seg_id,
    valid, num_segments, count) with sorted ids consecutive from 0 (a run
    every ~50 rows) and count a 0-d int32 tensor or None: the prefix empty,
    ending inside a run, past n, not given; padding rows after the groups,
    valid but with id num_segments; one run; every row its own run; every
    row invalid; fewer slots than runs; invalid rows inside runs and runs of
    invalid rows only."""
    dev = torch.device("cuda")
    vals = torch.randn(n, device=dev, generator=g)
    head = torch.rand(n, device=dev, generator=g) < 0.02
    head[:1] = True
    seg = torch.cumsum(head.int(), 0, dtype=torch.int32) - 1
    nseg = int(seg[-1]) + 1 if n else 0
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    num, count = nseg + 3, n
    if hazard == "count_0":
        count = 0
    elif hazard == "count_short":
        count = n - n // 3 - 1 if n > 1 else n
    elif hazard == "count_past":
        count = n + 5
    elif hazard == "no_count":
        count = None
    elif hazard == "padding_valid":
        pad = n // 5
        if n - pad:
            num = int(seg[n - pad - 1]) + 1
        seg[n - pad:] = num
    elif hazard == "one_run":
        seg.zero_()
        num = 1
    elif hazard == "each_row":
        seg = torch.arange(n, dtype=torch.int32, device=dev)
        num = max(n, 1)
    elif hazard == "all_invalid":
        valid.zero_()
    elif hazard == "overflow":
        num = max(nseg // 2, 1)
    elif hazard == "holes":
        valid = (torch.rand(n, device=dev, generator=g) < 0.7) & (seg % 5 != 2)
    c = None if count is None else torch.tensor(count, dtype=torch.int32,
                                                device=dev)
    return vals, seg, valid, num, c


def sums_named(torch, seg, num: int, count):
    """The slots a row of the prefix names (the rest are undefined)."""
    m = seg.numel() if count is None else max(0, min(int(count), seg.numel()))
    ids = seg[:m]
    return torch.unique(ids[(ids >= 0) & (ids < num)]).long()


def sums_held(torch, args, tag: str, got=None) -> float:
    """segment_sums' kernel against its plain version on the named slots:
    within 1e-4 of the run's sum of |x| (+1e-5).  Returns the largest
    difference."""
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    vals, seg, valid, num, count = args
    if got is None:
        got = sr.segment_sums_cuda(*args)
    slots = sums_named(torch, seg, num, count)
    want = sr.segment_sums_plain(*args)[slots]
    mag = sr.segment_sums_plain(vals.abs(), seg, valid, num, count)[slots]
    d = (got[slots] - want).abs()
    assert bool((d <= 1e-4 * mag + 1e-5).all()), f"segment_sums {tag}"
    return float(d.max()) if slots.numel() else 0.0


def segment_sums_phases(torch, sizes, record: dict):
    """segment_sums against its plain version on the named slots: at
    ``sizes`` in 4096 and 2^20 groups, with and without count; on its
    hazards (sums_case) around the 5120-row tile, on views not 16-byte
    aligned and back to back; at the main path's partial and final stages
    (the final stage with count, and without: the padding then dropped by
    its id, invalid as the main path gives it and valid); 20 calls of the
    partial stage and of one run over 2^27 rows with the same bits; timed at
    the partial stage (count = n, as segment_aggregate passes it), the final
    stage (count = 4096) and with every row its own run, beside the plain
    version, index_add_ and torch.segment_reduce (its lengths built outside
    the timed call), each shape's bound from the bytes the contract moves: 9
    a row of the prefix read, 4 a run written."""
    from repro_torch.kernels.segment_reduce import segment_reduce as sr
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for groups in (SUMS_GROUPS, 1 << 20):
        for n in sizes:
            seg = torch.sort(torch.randint(0, groups, (n,), device=dev,
                                           generator=g)).values
            # renumber to consecutive ids, like segment_aggregate's seg_id
            head = torch.ones(n, dtype=torch.bool, device=dev)
            head[1:] = seg[1:] != seg[:-1]
            seg = torch.cumsum(head.int(), 0, dtype=torch.int32) - 1
            n_seg = int(seg[-1]) + 1 if n else 0
            valid = torch.rand(n, device=dev, generator=g) < 0.9
            vals = torch.randn(n, device=dev, generator=g)
            for c in (None, torch.tensor(n, dtype=torch.int32, device=dev)):
                err = max(err, sums_held(torch, (vals, seg, valid, n_seg + 7, c),
                                         f"groups={groups} n={n}"))
        log(f"segment_sums groups={groups}: ok at sizes {sizes}")
    for n in LOOKBACK_SIZES + (sizes[-2],):
        for hazard in SUMS_HAZARDS:
            args = sums_case(torch, g, hazard, n)
            err = max(err, sums_held(torch, args, f"{hazard} n={n}"))
            vals, seg, valid, num, c = args
            views = [torch.cat([t[:1], t])[1:] for t in (vals, seg, valid)]
            assert views[0].data_ptr() % 16 != 0
            sums_held(torch, (*views, num, c), f"{hazard} misaligned n={n}")
            other = sums_case(torch, g, hazard, n)
            ga, gb = sr.segment_sums_cuda(*args), sr.segment_sums_cuda(*other)
            sums_held(torch, args, f"{hazard} back to back n={n}", ga)
            sums_held(torch, other, f"{hazard} back to back n={n}", gb)
    log(f"segment_sums hazards {SUMS_HAZARDS}: ok at sizes "
        f"{LOOKBACK_SIZES + (sizes[-2],)}")

    n, groups = sizes[-1], SUMS_GROUPS
    vals = torch.randn(n, device=dev, generator=g)
    rows = torch.arange(n, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    count_n = torch.tensor(n, dtype=torch.int32, device=dev)
    count_g = torch.tensor(groups, dtype=torch.int32, device=dev)
    final = torch.full((n,), n, dtype=torch.int32, device=dev)
    final[:groups] = torch.arange(groups, dtype=torch.int32, device=dev)
    for c, pad_valid in ((count_g, False), (None, False), (None, True)):
        err = max(err, sums_held(
            torch, (vals, final, (rows < groups) | pad_valid, n, c),
            f"final stage n={n} count={c is not None} pad_valid={pad_valid}"))
    log(f"segment_sums final-stage shape n={n}: ok")
    seg = (rows * groups // n).to(torch.int32)
    partial = (vals, seg, every, n, count_n)
    err = max(err, sums_held(torch, partial, f"partial stage n={n}"))
    # one run of 2^27 rows: held within its own tolerance (1e-4 of the sum
    # of |x|, ~1.1e4), its difference kept apart from the others
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    one_run = (vals, zeros, every, n, count_n)
    one_run_err = sums_held(torch, one_run, f"one run n={n}")
    each_row = (vals, rows.to(torch.int32), every, n, count_n)
    err = max(err, sums_held(torch, each_row, f"each row n={n}"))
    repeats = {tag: same_bits(torch, lambda a=a, k=k: sr.segment_sums_cuda(*a)[:k],
                              f"segment_sums {tag}")
               for tag, a, k in (("partial", partial, groups),
                                 ("one_run", one_run, 1))}
    log(f"segment_sums partial-stage shape n={n}: ok; same bits {repeats}")
    # one-call yardsticks at the partial stage: a contended-atomic index_add_
    # into num slots, and torch.segment_reduce over the sorted segments'
    # lengths (its 4096 sums held against the kernel's)
    idx = seg.long()
    lengths = torch.bincount(idx, minlength=groups)
    reduce = torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)
    mine = sr.segment_sums_cuda(*partial)[:groups]
    mag = sr.segment_sums_plain(vals.abs(), seg, every, n)[:groups]
    assert bool(((reduce - mine).abs() <= 1e-4 * mag + 1e-5).all()), \
        "segment_sums against torch.segment_reduce"
    yard = {"Tensor.index_add_": time_ms(
                lambda: torch.zeros(n, device=dev).index_add_(0, idx, vals),
                torch),
            "torch.segment_reduce(sum, lengths, unsafe=True)": time_ms(
                lambda: torch.segment_reduce(vals, "sum", lengths=lengths,
                                             unsafe=True), torch)}
    fastest = min(yard, key=yard.get)
    final_args = (vals, final, rows < groups, n, count_g)
    rec = {"name": "segment_sums", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_sums.cu",
           "replaces": "src/repro/kernels/segment_reduce/segment_reduce.py:33",
           "shape": f"partial stage: f32 values, n={n}, {groups} groups, "
                    f"num_segments={n}, count={n}",
           "max_abs_err": err,
           "ms": time_ms(lambda: sr.segment_sums_cuda(*partial), torch),
           "plain_ms": time_ms(lambda: sr.segment_sums_plain(*partial), torch),
           "library_ms": yard[fastest], "library_call": fastest,
           "library_calls_ms": yard,
           "segment_reduce_max_abs_diff": float((reduce - mine).abs().max()),
           "final_stage_ms": time_ms(lambda: sr.segment_sums_cuda(*final_args),
                                     torch),
           "each_row_ms": time_ms(lambda: sr.segment_sums_cuda(*each_row),
                                  torch),
           "same_bits_of_calls": repeats, "one_run_max_abs_err": one_run_err}
    rec["bound_ms"], rec["bound_by"] = bound_ms(9.0 * n + 4.0 * groups, n)
    rec["final_stage_bound_ms"] = bound_ms(13.0 * groups, groups)[0]
    rec["each_row_bound_ms"] = bound_ms(13.0 * n, n)[0]
    record["segment_sums"] = rec

def ulps(torch, a, b) -> int:
    """Largest distance of two float32 or bfloat16 tensors (of one dtype) in
    units in the last place of that dtype (+0 and -0 equal)."""
    bits, mag = ((torch.int16, 0x7FFF) if a.dtype == torch.bfloat16
                 else (torch.int32, 0x7FFFFFFF))

    def ordered(t):
        i = t.contiguous().view(bits).long()
        return torch.where(i < 0, -(i & mag), i)
    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


# The main path's shapes of the window kernels: 2^27 rows; the partitioned
# queries' groups hold 2^27 / 11585 ~ 11585 rows on average.
GROUPS = 11585
# the window and sort paths' rows (cut from 2^27 for the time limit when
# tp_serve came, and to 2^25 when tp_train came) and the window path's
# ~sqrt(n) groups
WINDOW_ROWS, WINDOW_GROUPS = 2**25, 5793
SORT_ROWS = 2**25


def window_kernel_phases(torch, sizes, record: dict):
    from repro_torch.kernels import cuda
    from repro_torch.kernels.segment_rank import segment_rank as rk
    from repro_torch.kernels.segment_scan import segment_scan as ss
    from repro_torch.kernels.stencil1d import stencil1d as st
    from repro_torch.kernels.stream_compact import stream_compact as sc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    wrng = np.random.default_rng(5)

    def heads(n, mean_len):
        """int32 segment-head mask, row 0 a head, one head per mean_len rows
        on average."""
        h = (torch.rand(n, device=dev, generator=g) < 1.0 / mean_len)
        h[:1] = True
        return h.to(torch.int32)

    # -- segment_scan: int32 exact; float32 of integer values exact (every
    # partial sum of the plain version's global cumsum is an integer below
    # 2^24); float32 normal values within 1e-5 of the running sum of |x|
    # (+1e-4), the plain version's own rounding (a global cumsum minus the
    # segment's base).
    err = 0.0
    for mean_len in (1, 64, 1 << 16):
        for n in sizes:
            b = heads(n, mean_len)
            xi = torch.randint(-1000, 1000, (n,), device=dev, generator=g,
                               dtype=torch.int32)
            assert torch.equal(ss.segment_scan_cuda(xi, b),
                               ss.segment_scan_plain(xi, b)), \
                f"segment_scan int32 n={n} L={mean_len}"
            xf = torch.randint(-8, 9, (n,), device=dev, generator=g).float()
            assert torch.equal(ss.segment_scan_cuda(xf, b),
                               ss.segment_scan_plain(xf, b)), \
                f"segment_scan f32 (integer values) n={n} L={mean_len}"
            if 0 < n <= 1 << 22:
                xn = torch.randn(n, device=dev, generator=g)
                got, want = ss.segment_scan_cuda(xn, b), ss.segment_scan_plain(xn, b)
                tol = 1e-5 * torch.cumsum(xn.abs().double(), 0) + 1e-4
                d = (got.double() - want.double()).abs()
                assert bool((d <= tol).all()), f"segment_scan f32 n={n} L={mean_len}"
                err = max(err, float(d.max()))
        log(f"segment_scan mean segment {mean_len}: ok at sizes {sizes}")
    # the timed inputs, held like the normal values above
    n = sizes[-1]
    b = heads(n, GROUPS)
    xn = torch.randn(n, device=dev, generator=g)
    got, want = ss.segment_scan_cuda(xn, b), ss.segment_scan_plain(xn, b)
    tol = 1e-5 * torch.cumsum(xn.abs().double(), 0) + 1e-4
    d = (got.double() - want.double()).abs()
    assert bool((d <= tol).all()), f"segment_scan f32 timed inputs n={n}"
    err = max(err, float(d.max()))
    del got, want, tol, d
    rec = {"name": "segment_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_scan.cu",
           "replaces": "src/repro/kernels/segment_scan/segment_scan.py:48",
           "shape": f"f32 x, n={n}, mean segment {GROUPS}", "max_abs_err": err,
           "ms": time_ms(lambda: ss.segment_scan_cuda(xn, b), torch),
           "plain_ms": time_ms(lambda: ss.segment_scan_plain(xn, b), torch),
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * n, n)
    record["segment_scan"] = rec
    del b, xn

    # the look-back hazards, as prefix_sum's and segment_rank's: ragged
    # sizes; views not 16-byte aligned; two calls back to back on other
    # inputs of one length; int32 sums that wrap past 2^31 (exact modulo
    # 2^32); one segment head at row 0 and none after it (no tile restarts:
    # the longest look-back chains), up to 2^27 rows.  Integer values, so
    # the float32 sums are exact too: every comparison is bitwise.
    def scans_equal(x, b, tag):
        assert torch.equal(ss.segment_scan_cuda(x, b),
                           ss.segment_scan_plain(x, b)), f"segment_scan {tag}"

    for n in LOOKBACK_SIZES + (sizes[-2],):
        for mean_len in (1, 64, 1 << 16):
            for dt in (torch.int32, torch.float32):
                tag = f"{dt} n={n} L={mean_len}"
                bs = [heads(n + 1, mean_len) for _ in range(2)]
                xs = [torch.randint(-8, 9, (n + 1,), device=dev,
                                    generator=g).to(dt) for _ in range(2)]
                scans_equal(misaligned(xs[0]), misaligned(bs[0]),
                            f"misaligned {tag}")
                a = [ss.segment_scan_cuda(x[:n], h[:n]) for x, h in zip(xs, bs)]
                want = [ss.segment_scan_plain(x[:n], h[:n])
                        for x, h in zip(xs, bs)]
                assert all(map(torch.equal, a, want)), \
                    f"segment_scan back to back {tag}"
    for n in LOOKBACK_SIZES + (sizes[-2], sizes[-1]):
        one = torch.zeros(n, dtype=torch.int32, device=dev)
        one[0] = 1
        xw = torch.randint(-2**30, 2**30, (n,), device=dev, generator=g,
                           dtype=torch.int32)
        got = ss.segment_scan_cuda(xw, one)
        assert torch.equal(got, wrapped(xw)), f"segment_scan int32 wrap n={n}"
        scans_equal(xw, one, f"int32 wrap, one head at row 0, n={n}")
        scans_equal(xw, heads(n, 64), f"int32 wrap n={n}")
        xf = torch.randint(-8, 9, (n,), device=dev, generator=g).float()
        scans_equal(xf, one, f"f32 one head at row 0, n={n}")
    xn = torch.randn(n, device=dev, generator=g)
    record["segment_scan"]["one_head_at_row_0_ms"] = time_ms(
        lambda: ss.segment_scan_cuda(xn, one), torch)
    del one, xw, got, xf, xn
    log(f"segment_scan hazards: ok at sizes {LOOKBACK_SIZES}")

    # float32 look-back scans give the same bits on every call: 20 calls
    # each on normal values, prefix_sum and segment_scan (heads of the main
    # path's mean length and one head at row 0)
    repeats = {"prefix_sum": {}, "segment_scan": {}}
    for n in (LOOKBACK_SIZES[-1], sizes[-1]):
        xn = torch.randn(n, device=dev, generator=g)
        b = heads(n, GROUPS)
        one = torch.zeros(n, dtype=torch.int32, device=dev)
        one[0] = 1
        repeats["prefix_sum"][n] = same_bits(
            torch, lambda: sc.prefix_sum_cuda(xn), f"prefix_sum f32 n={n}")
        repeats["segment_scan"][n] = min(
            same_bits(torch, lambda: ss.segment_scan_cuda(xn, b),
                      f"segment_scan f32 n={n}"),
            same_bits(torch, lambda: ss.segment_scan_cuda(xn, one),
                      f"segment_scan f32 one head n={n}"))
        log(f"f32 prefix_sum, segment_scan n={n}: 20 calls each, the same bits")
    for name, r in repeats.items():
        record[name]["f32_calls_bitwise_equal"] = r
    del xn, b, one

    # -- segment_rank: all three kinds exact, ties in the order key (run
    # heads ~ 3 rows apart inside segments).
    for mean_len in (1, 64, 1 << 16):
        for n in sizes:
            seg = heads(n, mean_len)
            ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.3).int()
            for kind in rk.KINDS:
                assert torch.equal(rk.segment_rank_cuda(seg, ordb, kind),
                                   rk.segment_rank_plain(seg, ordb, kind)), \
                    f"segment_rank {kind} n={n} L={mean_len}"
        log(f"segment_rank mean segment {mean_len}: ok at sizes {sizes}")

    # the look-back hazards, every kind: ragged sizes; views not 16-byte
    # aligned; two calls back to back on other inputs of one length; one
    # segment head at row 0 and none after it (no tile restarts: the
    # longest look-back chains), up to 2^27 rows.
    def ranks_equal(seg, ordb, tag):
        for kind in rk.KINDS:
            assert torch.equal(rk.segment_rank_cuda(seg, ordb, kind),
                               rk.segment_rank_plain(seg, ordb, kind)), \
                f"segment_rank {kind} {tag}"

    for n in LOOKBACK_SIZES + (sizes[-2],):
        for mean_len in (1, 64, 1 << 16):
            segs = [heads(n + 1, mean_len) for _ in range(2)]
            ords = [s | (torch.rand(n + 1, device=dev, generator=g) < 0.3).int()
                    for s in segs]
            ranks_equal(misaligned(segs[0]), misaligned(ords[0]),
                        f"misaligned n={n} L={mean_len}")
            a = [rk.segment_rank_cuda(segs[i][:n], ords[i][:n], kind)
                 for i in range(2) for kind in rk.KINDS]
            b = [rk.segment_rank_plain(segs[i][:n], ords[i][:n], kind)
                 for i in range(2) for kind in rk.KINDS]
            assert all(map(torch.equal, a, b)), \
                f"segment_rank back to back n={n} L={mean_len}"
    for n in LOOKBACK_SIZES + (sizes[-2], sizes[-1]):
        seg = torch.zeros(n, dtype=torch.int32, device=dev)
        seg[0] = 1
        ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.125).int()
        ranks_equal(seg, ordb, f"one head at row 0, n={n}")
    single_head_ms = {kind: time_ms(
        lambda: rk.segment_rank_cuda(seg, ordb, kind), torch)
        for kind in rk.KINDS}
    del seg, ordb
    log(f"segment_rank hazards: ok at sizes {LOOKBACK_SIZES}")

    n = sizes[-1]
    seg = heads(n, GROUPS)
    ordb = seg | (torch.rand(n, device=dev, generator=g) < 0.125).int()
    ranks_equal(seg, ordb, f"timed inputs n={n}")
    by_kind = {}
    for kind in rk.KINDS:
        k = {"ms": time_ms(lambda: rk.segment_rank_cuda(seg, ordb, kind), torch),
             "plain_ms": time_ms(lambda: rk.segment_rank_plain(seg, ordb, kind),
                                 torch),
             "one_head_at_row_0_ms": single_head_ms[kind]}
        k["bound_ms"], k["bound_by"] = bound_ms(
            (8.0 if kind == "row_number" else 12.0) * n, n)
        by_kind[kind] = k
    rec = {"name": "segment_rank", "route": "cuda",
           "source": "src/repro_torch/csrc/segment_rank.cu",
           "replaces": "src/repro/kernels/segment_rank/segment_rank.py:67",
           "shape": f"rank, n={n}, mean segment {GROUPS}, runs of ~8",
           "max_abs_err": 0.0, **by_kind["rank"],
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent",
           "by_kind": by_kind}
    record["segment_rank"] = rec
    del seg, ordb

    # -- the stencils: K in {1, 3, 5, 7, 20} at centres 0 and K // 2, and
    # the main path's (K, centre) pairs: (3, 1) of the SMA, the WMA and the
    # partitioned WMA, (20, 19) of the exact rolling mean, (7, 6) of the
    # grouped exact rolling mean.  Every mode bitwise equal to the plain
    # version (the same float32 operations in the same order, the exact
    # modes' divide too): 0 ulps.
    centres = {1: (0,), 3: (0, 1), 5: (0, 2), 7: (0, 3, 6), 20: (0, 10, 19)}

    def layout(n, k, c, mean_len=64):
        """ext as stencil1d / segment_stencil1d build it: zero halos of c
        and k - 1 - c rows around n values; ext_s with -2 halos, segment
        ids (one head per mean_len rows on average) and the last n // 7
        rows invalid (-1)."""
        ext = torch.zeros(n + k - 1, device=dev)
        ext[c:c + n] = torch.randn(n, device=dev, generator=g)
        ext_m = torch.zeros(n + k - 1, device=dev)
        ext_m[c:c + n] = 1.0
        sid = torch.cumsum(heads(n, mean_len), 0, dtype=torch.int32) - 1
        sid[n - n // 7:] = -1
        ext_s = torch.full((n + k - 1,), -2, dtype=torch.int32, device=dev)
        ext_s[c:c + n] = sid
        return ext, ext_m, ext_s

    errs = {"stencil1d": 0.0, "stencil1d_exact": 0.0, "segment_stencil": 0.0}
    worst = {"stencil1d": 0, "stencil1d_exact": 0, "segment_stencil": 0}

    def held(name, got, want, tag):
        """One kernel call against its plain version: bitwise, folded into
        the kernel's own record."""
        u = ulps(torch, got, want)
        worst[name] = max(worst[name], u)
        assert torch.equal(got, want), f"{tag}: {u} ulps"
        if got.numel():
            errs[name] = max(errs[name], float((got - want).abs().max()))

    def all_modes(ext, ext_m, ext_s, w, wpos, c, tag):
        held("stencil1d", st.stencil1d_cuda(ext, w),
             st.stencil1d_plain(ext, w), f"stencil1d {tag}")
        held("stencil1d_exact", st.stencil1d_exact_cuda(ext, ext_m, wpos),
             st.stencil1d_exact_plain(ext, ext_m, wpos), f"stencil1d_exact {tag}")
        for exact, ww in ((False, w), (True, wpos)):
            held("segment_stencil",
                 st.segment_stencil_cuda(ext, ext_s, ww, c, exact),
                 st.segment_stencil_plain(ext, ext_s, ww, c, exact),
                 f"segment_stencil exact={exact} {tag}")

    for k, cs in centres.items():
        w = [float(v) for v in wrng.normal(size=k)]
        wpos = [abs(v) + 0.05 for v in w]
        for n in sizes:
            ext = torch.randn(n + k - 1, device=dev, generator=g)
            held("stencil1d", st.stencil1d_cuda(ext, w),
                 st.stencil1d_plain(ext, w), f"stencil1d K={k} n={n}")
            for c in cs:
                all_modes(*layout(n, k, c), w, wpos, c, f"K={k} c={c} n={n}")
        log(f"stencils K={k} centres {cs}: ok at sizes {sizes}")
    # around the kernel's 4096-output tile and at a few tiles, ragged ends,
    # and views not 16-byte aligned (the WORDS fetch); K = 4 (one whole step
    # of the register window) and K = 1100 (staged again past the 1024 taps
    # a block holds at once, with a centre beyond them)
    edges = (4095, 4096, 4097, 3 * 4096 + 5, 10 * 4096 + 3)
    for k, cs in {**centres, 4: (0, 2, 3), 1100: (0, 550, 1099)}.items():
        w = [float(v) for v in wrng.normal(size=k)]
        wpos = [abs(v) + 0.05 for v in w]
        for n in edges:
            for c in cs:
                arrays = layout(n, k, c)
                all_modes(*arrays, w, wpos, c, f"K={k} c={c} n={n}")
                views = [misaligned(torch.cat([t[:1], t])) for t in arrays]
                all_modes(*views, w, wpos, c, f"misaligned K={k} c={c} n={n}")
        log(f"stencils K={k}: ok around the tile, on ragged ends and "
            f"misaligned views at sizes {edges}")
    log(f"stencils: every mode within {worst} ulps")

    # The main path's calls at 2^27 rows, each held against its plain
    # version on the timed inputs.  fig8b_wma's: K = 3.
    n = sizes[-1]
    ext = torch.randn(n + 2, device=dev, generator=g)
    w3 = [0.25, 0.5, 0.25]
    wt = torch.tensor(w3, device=dev).view(1, 1, 3)
    conv = torch.nn.functional.conv1d
    got = st.stencil1d_cuda(ext, w3)
    held("stencil1d", got, st.stencil1d_plain(ext, w3),
         f"stencil1d timed inputs K=3 n={n}")
    lib = conv(ext.view(1, 1, -1), wt).view(-1)
    rec = {"name": "stencil1d", "route": "cuda",
           "source": "src/repro_torch/csrc/stencil1d.cu",
           "replaces": "src/repro/kernels/stencil1d/stencil1d.py:48",
           "shape": f"K=3, n={n}", "max_abs_err": errs["stencil1d"],
           "library_max_abs_diff": float((got - lib).abs().max()),
           "ms": time_ms(lambda: st.stencil1d_cuda(ext, w3), torch),
           "plain_ms": time_ms(lambda: st.stencil1d_plain(ext, w3), torch),
           "library_ms": time_ms(lambda: conv(ext.view(1, 1, -1), wt), torch),
           "library_call": "torch.nn.functional.conv1d (TF32 off)"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(8.0 * n, 2.0 * 3 * n)
    record["stencil1d"] = rec
    del ext, got, lib

    # fig8b_rolling_mean_exact's call: K = 20, centre 19
    ext, ext_m, _s = layout(n, 20, 19)
    del _s
    w20 = [0.05] * 20
    held("stencil1d_exact", st.stencil1d_exact_cuda(ext, ext_m, w20),
         st.stencil1d_exact_plain(ext, ext_m, w20),
         f"stencil1d_exact timed inputs K=20 c=19 n={n}")
    rec = {"name": "stencil1d_exact", "route": "cuda",
           "source": "src/repro_torch/csrc/stencil1d.cu",
           "replaces": "src/repro/kernels/stencil1d/stencil1d.py:86",
           "shape": f"K=20, centre 19, n={n}",
           "max_abs_err": errs["stencil1d_exact"],
           "max_ulps": worst["stencil1d_exact"],
           "ms": time_ms(lambda: st.stencil1d_exact_cuda(ext, ext_m, w20), torch),
           "plain_ms": time_ms(lambda: st.stencil1d_exact_plain(ext, ext_m, w20),
                               torch),
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * n, 4.0 * 20 * n + 2.0 * n)
    record["stencil1d_exact"] = rec
    del ext, ext_m

    # segment_stencil: the partitioned WMA's call (K = 3, centre 1, not
    # exact) is the record's; the grouped exact rolling mean's (K = 7,
    # centre 6) goes beside it under "exact_k7".  Segment ids of groups of
    # the main path's mean length.
    ext, _m, ext_s = layout(n, 3, 1, GROUPS)
    del _m
    held("segment_stencil", st.segment_stencil_cuda(ext, ext_s, w3, 1),
         st.segment_stencil_plain(ext, ext_s, w3, 1),
         f"segment_stencil timed inputs K=3 c=1 n={n}")
    rec = {"name": "segment_stencil", "route": "cuda",
           "source": "src/repro_torch/csrc/stencil1d.cu",
           "replaces": "src/repro/kernels/stencil1d/stencil1d.py:138",
           "shape": f"K=3, centre 1, not exact, n={n}, mean segment {GROUPS}",
           "ms": time_ms(lambda: st.segment_stencil_cuda(ext, ext_s, w3, 1), torch),
           "plain_ms": time_ms(lambda: st.segment_stencil_plain(ext, ext_s, w3, 1),
                               torch),
           "library_ms": None, "library_call": None,
           "library_note": "no one-call equivalent"}
    rec["bound_ms"], rec["bound_by"] = bound_ms(12.0 * n, 3.0 * 3 * n)
    del ext, ext_s
    ext, _m, ext_s = layout(n, 7, 6, GROUPS)
    del _m
    w7 = [1.0 / 7] * 7
    held("segment_stencil", st.segment_stencil_cuda(ext, ext_s, w7, 6, True),
         st.segment_stencil_plain(ext, ext_s, w7, 6, True),
         f"segment_stencil timed inputs K=7 c=6 exact n={n}")
    k7 = {"shape": f"K=7, centre 6, exact, n={n}, mean segment {GROUPS}",
          "ms": time_ms(lambda: st.segment_stencil_cuda(ext, ext_s, w7, 6, True),
                        torch),
          "plain_ms": time_ms(
              lambda: st.segment_stencil_plain(ext, ext_s, w7, 6, True), torch)}
    k7["bound_ms"], k7["bound_by"] = bound_ms(12.0 * n, 5.0 * 7 * n + 2.0 * n)
    rec.update(max_abs_err=errs["segment_stencil"],
               max_ulps=worst["segment_stencil"], exact_k7=k7)
    record["segment_stencil"] = rec
    del ext, ext_s
    cuda.reset_launches()


# The LM serving path: qwen3-0.6b at its published widths and depth, 32
# requests of 2048 prompt tokens and 128 greedy new tokens (cut from 256 to
# keep the script within its time limit; the cache holds 2048 + 128 rows and
# fills exactly).  decode_attention is timed at the cache's last step, 2176
# rows, the length its earlier runs were timed at.
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_NEW = 32, 2048, 128
LM_MID = LM_PROMPT + LM_NEW


def decode_attention_timed_shapes() -> dict:
    """The decode shapes (B, S, Hkv, G, hd) decode_attention is timed at,
    every row at length S: the lm, moe, hybrid (hd 112), vlm and encdec
    (self and cross) paths'."""
    from repro_torch.configs import get_config

    def of(arch, b, s):
        cfg = get_config(arch)
        return b, s, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    ecfg = get_config(ENC_ARCH)
    return {"lm": of(LM_ARCH, LM_BATCH, LM_MID),
            "moe": of(MOE_ARCH, MOE_BATCH, MOE_PROMPT + MOE_NEW),
            "hd112": of(SSM_ARCHS["hybrid"], SSM_BATCH, SSM_PROMPT + SSM_NEW),
            "vlm": of(VLM_ARCH, VLM_BATCH, VLM_PROMPT + VLM_NEW),
            "encdec_cross": (ENC_BATCH, ecfg.enc_frames, ecfg.n_kv_heads,
                             ecfg.n_heads // ecfg.n_kv_heads, ecfg.hd),
            "encdec_self": of(ENC_ARCH, ENC_BATCH, ENC_PROMPT + ENC_NEW)}


def decode_attention_layer_views() -> dict:
    """The calls a decode step makes at each timed shape, each on its own
    layer's view of a stacked cache: a layer each (whisper: each of self
    and cross), the hybrid's shared applications."""
    from repro_torch.configs import get_config
    return {"lm": get_config(LM_ARCH).n_layers,
            "moe": get_config(MOE_ARCH).n_layers,
            "hd112": shared_applications(get_config(SSM_ARCHS["hybrid"])),
            "vlm": get_config(VLM_ARCH).n_layers,
            "encdec_cross": get_config(ENC_ARCH).n_layers,
            "encdec_self": get_config(ENC_ARCH).n_layers}


def decode_attention_device_times(torch, n: int = 20) -> dict:
    """decode_attention's device time a call at each timed shape in
    bfloat16, every row at length S: the card's kernels of n calls in one
    torch.profiler window (``traced``), summed (the split kernel and the
    combine), over n; and the kernels a call launches.  Run right after
    one_call_profiles, among the process's first profiler sessions (later
    windows may hold no device event); a window with none is taken again,
    up to three times, else the time is None (not measured)."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for name, (b, s, hkv, gq, hd) in decode_attention_timed_shapes().items():
        q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).bfloat16()
        k, v = (torch.randn((b, s, hkv, hd), device=dev, generator=g).bfloat16()
                for _ in range(2))
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        da.decode_attention_cuda(q, k, v, full)     # the plan, the library
        out[name] = {"device_ms": None, "device_launches_a_call": None}
        for _ in range(3):
            prof, _seen, _host = traced(torch, lambda: [
                da.decode_attention_cuda(q, k, v, full) for _ in range(n)])
            us, count = 0.0, 0
            for e in prof.key_averages():
                if "decode_attention" in e.key and \
                        str(e.device_type).endswith("CUDA"):
                    us += e.self_device_time_total
                    count += e.count
            if count:
                out[name] = {"device_ms": us / 1e3 / n,
                             "device_launches_a_call": count / n}
                break
        del q, k, v
    # the partial and the merge over a cache sharded along S (TP_MODEL
    # ranks), each timed alone: a rank's block of every row, its partial,
    # and the TP_MODEL partials' merge
    for name, (b, s, hkv, gq, hd) in sharded_shapes().items():
        q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).bfloat16()
        k, v = (torch.randn((b, s, hkv, hd), device=dev, generator=g).bfloat16()
                for _ in range(2))
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        parts = torch.stack([da.decode_attention_partial_cuda(q, k, v, full)] * TP_MODEL)
        calls = {"partial": lambda: da.decode_attention_partial_cuda(q, k, v, full),
                 "merge": lambda: da.decode_attention_merge_cuda(parts, torch.bfloat16)}
        for entry, call in calls.items():
            key = f"{entry}_{name}"
            out[key] = {"device_ms": None, "device_launches_a_call": None}
            for _ in range(3):
                prof, _seen, _host = traced(torch, lambda: [call() for _ in range(n)])
                us, count = 0.0, 0
                for e in prof.key_averages():
                    if "decode_attention" in e.key and \
                            str(e.device_type).endswith("CUDA"):
                        us += e.self_device_time_total
                        count += e.count
                if count:
                    out[key] = {"device_ms": us / 1e3 / n,
                                "device_launches_a_call": count / n}
                    break
        del q, k, v, parts
    log(f"decode_attention device ms a call (one window of {n} calls): {out}")
    return out


# decode_attention over a cache sharded along S on the tp_serve path's
# TP_MODEL ranks: a rank's block (1088 rows of the 2176-row caches) at the
# lm and moe paths' decode shapes (B 32 and 16), and at the tp_serve
# path's own (B 8 and 4: few (b, KV head) pairs, so the partial splits S
# and folds the splits itself)
TP_MODEL = 2


def sharded_shapes() -> dict:
    """(B, S_loc, Hkv, G, hd) of a rank's block at which the partial and
    the merge are held and timed."""
    from repro_torch.configs import get_config

    def of(arch, b):
        cfg = get_config(arch)
        return (b, LM_MID // TP_MODEL, cfg.n_kv_heads,
                cfg.n_heads // cfg.n_kv_heads, cfg.hd)
    return {"lm": of(LM_ARCH, LM_BATCH), "moe": of(MOE_ARCH, MOE_BATCH),
            "tp_lm": of(LM_ARCH, TP_LM[0]), "tp_moe": of(MOE_ARCH, TP_MOE[0])}


def decode_attention_sharded_phases(torch, record: dict, device: dict):
    """decode_attention_partial and decode_attention_merge, the entries over
    a cache sharded along S, at each of ``sharded_shapes`` with TP_MODEL
    blocks, in float32 and bfloat16: each block's partial against the plain
    partial (its normalised output numerator / sum within decode_attention's
    tolerance of the plain one's; an empty block max -1e30 and sum 0), the
    merge against the plain merge, the merged blocks against the one-call
    kernel and the plain version over the whole S (|got - want| <= 2^-7
    |want| + 2e-5 in bfloat16, 2e-5 in float32), at lengths that leave a
    block empty, end inside one, fill one and fill both; then 20 calls of
    each with the same bits; then each timed (CUDA events) beside its plain
    version and its bound, with the device time of ``device``.  No single
    PyTorch call computes either (SDPA returns no partial softmax), so
    library_ms is null."""
    from repro_torch.kernels.decode_attention import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    rel = {f32: 0.0, bf16: 2.0 ** -7}
    err = {"partial": 0.0, "merge": 0.0, "one_call": 0.0}
    recs = {"partial": {}, "merge": {}}
    for name, (b, s, hkv, gq, hd) in sharded_shapes().items():
        total = TP_MODEL * s
        edges = [1, s - 1, s, s + 1, total - 1, total]
        lengths = torch.tensor([edges[i % len(edges)] for i in range(b)],
                               dtype=torch.int32, device=dev)
        for dt in (f32, bf16):
            q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).to(dt)
            k, v = (torch.randn((b, total, hkv, hd), device=dev, generator=g).to(dt)
                    for _ in range(2))
            blocks = [(k[:, r * s:(r + 1) * s].contiguous(),
                       v[:, r * s:(r + 1) * s].contiguous(),
                       torch.clamp(lengths - r * s, 0, s).to(torch.int32))
                      for r in range(TP_MODEL)]
            parts = []
            for kb, vb, lb in blocks:
                got = da.decode_attention_partial_cuda(q, kb, vb, lb)
                want = da.decode_attention_partial_plain(q, kb, vb, lb)
                empty = want[..., -1] == 0
                assert torch.equal(got[..., -1] == 0, empty), f"{name} {dt}: empty"
                assert bool((got[..., -2][empty] == -1e30).all()), f"{name} {dt}"
                assert bool(torch.isfinite(got).all()), f"{name} {dt}: not finite"
                norm = lambda p: (p[..., :-2] / p[..., -1:].clamp(min=1e-30))  # noqa: E731
                d = (norm(got) - norm(want)).abs()[~empty]
                bound = (rel[dt] * norm(want).abs() + 2e-5)[~empty]
                assert bool((d <= bound).all()), f"partial {name} {dt}"
                err["partial"] = max(err["partial"], float(d.max()) if d.numel() else 0.0)
                parts.append(got)
            parts = torch.stack(parts)
            merged = da.decode_attention_merge_cuda(parts, dt)
            want = da.decode_attention_merge_plain(parts, dt)
            one = da.decode_attention_cuda(q, k, v, lengths)
            plain = da.decode_attention_plain(q, k, v, lengths)
            for got_, want_, key in ((merged, want, "merge"), (merged, plain, "merge"),
                                     (one, plain, "one_call")):
                d = (got_.float() - want_.float()).abs()
                assert bool((d <= rel[dt] * want_.float().abs() + 2e-5).all()), \
                    f"{key} {name} {dt}"
                err[key] = max(err[key], float(d.max()))
            err.setdefault("partial_merge_vs_one_call", 0.0)
            err["partial_merge_vs_one_call"] = max(
                err["partial_merge_vs_one_call"],
                float((merged.float() - one.float()).abs().max()))
            del q, k, v, blocks, parts
        # bfloat16, every row full: 20 calls with the same bits, then timed
        q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).to(bf16)
        kb, vb = (torch.randn((b, s, hkv, hd), device=dev, generator=g).to(bf16)
                  for _ in range(2))
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        part = lambda: da.decode_attention_partial_cuda(q, kb, vb, full)  # noqa: E731
        parts = torch.stack([part(), torch.roll(part(), 1, 0)])
        merge = lambda: da.decode_attention_merge_cuda(parts, bf16)  # noqa: E731
        same_bits(torch, part, f"decode_attention_partial {name}")
        first = merge().view(torch.int16)
        for i in range(19):
            assert torch.equal(merge().view(torch.int16), first), f"merge {name} {i}"
        splits, rows = da.split_plan(b, hkv, s, gq, hd, 2,
                                     da.sm_count(torch.cuda.current_device()))
        window = {e: device.get(f"{e}_{name}", {}) for e in recs}
        p_bytes = 2.0 * b * s * hkv * hd * 2 + q.numel() * 2 + 4.0 * b \
            + 4.0 * b * hkv * gq * (hd + 2)
        recs["partial"][name] = {
            "shape": f"bf16 q ({b}, {hkv}, {gq}, {hd}), a block of k/v ({b}, {s}, "
                     f"{hkv}, {hd}), all lengths {s}; {splits} splits",
            "splits": splits, "rows_per_split": rows, "same_bits_calls": 20,
            "ms": time_ms(part, torch),
            "plain_ms": time_ms(lambda: da.decode_attention_partial_plain(q, kb, vb, full),
                                torch),
            "device_ms": window["partial"].get("device_ms"),
            "device_launches_a_call": window["partial"].get("device_launches_a_call"),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(p_bytes, 4.0 * b * hkv * gq * hd * s)))}
        m_bytes = parts.numel() * 4.0 + b * hkv * gq * hd * 2
        recs["merge"][name] = {
            "shape": f"{TP_MODEL} bf16-output partials ({b}, {hkv}, {gq}, {hd + 2})",
            "same_bits_calls": 20,
            "ms": time_ms(merge, torch),
            "plain_ms": time_ms(lambda: da.decode_attention_merge_plain(parts, bf16), torch),
            "device_ms": window["merge"].get("device_ms"),
            "device_launches_a_call": window["merge"].get("device_launches_a_call"),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(m_bytes, 4.0 * TP_MODEL * b * hkv * gq * (hd + 1))))}
        for e in recs:
            r = recs[e][name]
            r["of_bound"] = r["bound_ms"] / r["ms"]
            if r["device_ms"]:
                r["of_bound_device"] = r["bound_ms"] / r["device_ms"]
        del q, kb, vb, parts
        log(f"decode_attention partial and merge at {name} {(b, s, hkv, gq, hd)}: ok; "
            f"partial {recs['partial'][name]}, merge {recs['merge'][name]}")
    common = {"route": "cuda", "source": "src/repro_torch/csrc/decode_attention.cu",
              "replaces": "src/repro/kernels/decode_attention/decode_attention.py:67",
              "library_ms": None, "library_call": None}
    for e in recs:
        head = recs[e]["lm"]
        record[f"decode_attention_{e}"] = {
            "name": f"decode_attention_{e}", **common, **head,
            "max_abs_err": err[e], **{n: r for n, r in recs[e].items() if n != "lm"}}
    record["decode_attention_merge"]["one_call_max_abs_err"] = err["one_call"]
    record["decode_attention_merge"]["partial_merge_vs_one_call_max_abs_diff"] = \
        err["partial_merge_vs_one_call"]


def decode_attention_phases(torch, record: dict, device: dict):
    """decode_attention against its plain version: the reference's test
    shapes (random and full lengths) in float32 and bfloat16, and the
    decode shapes of the moe and LM paths, each with per-row lengths 1,
    511, 512, 513, 2048, its cache's rows and random ones; then at the
    hybrid's head width 112 and at 96 (the lanes past hd idle): the
    reference's shapes, a group of 4, and the hybrid path's decode shape
    with lengths 1 .. its cache's rows; then the vlm and encdec paths'
    shapes.  Every timed shape (``decode_attention_timed_shapes``: lm, moe,
    hd112, vlm, encdec_cross, encdec_self) is held in bfloat16 either side
    of each split's first row (float32's too at the vlm shape) and timed
    beside SDPA, with its split plan, blocks, kernels a call, the device
    time of ``device`` (``decode_attention_device_times``) and the
    wrapper's host microseconds a call.  Both compute in float32 and round
    once to q's dtype, so an element may differ by 2e-5 (the reference's
    float32 tolerance between its kernel and its oracle) plus, in bfloat16,
    one rounding step of the output: |got - want| <= 2^-7 |want| + 2e-5."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.decode_attention import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    rel = {f32: 0.0, bf16: 2.0 ** -7}
    err = {f32: 0.0, bf16: 0.0}
    of_bound = {f32: 0.0, bf16: 0.0}     # largest |got - want| / its bound
    worst_bf16 = [0]

    def inputs(b, s, hkv, gq, hd, dt):
        q = torch.randn((b, hkv, gq, hd), device=dev, generator=g).to(dt)
        k, v = (torch.randn((b, s, hkv, hd), device=dev, generator=g).to(dt)
                for _ in range(2))
        return q, k, v

    def held(q, k, v, length, tag):
        got = da.decode_attention_cuda(q, k, v, length)
        want = da.decode_attention_plain(q, k, v, length)
        assert got.dtype == q.dtype and got.shape == q.shape, tag
        diff = (got.float() - want.float()).abs()
        share = float((diff / (rel[q.dtype] * want.float().abs() + 2e-5)).max())
        assert share <= 1, f"decode_attention {tag}: {share} of the bound"
        of_bound[q.dtype] = max(of_bound[q.dtype], share)
        d = float(diff.max())
        err[q.dtype] = max(err[q.dtype], d)
        if q.dtype == bf16:
            worst_bf16[0] = max(worst_bf16[0], ulps(torch, got, want))
        return got

    for b, s, hkv, gq, hd in ((1, 128, 2, 2, 32), (2, 512, 2, 4, 64),
                              (4, 1024, 8, 7, 64), (2, 700, 4, 1, 32)):
        for dt in (f32, bf16):
            q, k, v = inputs(b, s, hkv, gq, hd, dt)
            length = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                                   dtype=torch.int32)
            for lens, what in ((length, "random"),
                               (torch.full_like(length, s), "full")):
                held(q, k, v, lens, f"{(b, s, hkv, gq, hd)} {dt} {what} lengths")
        log(f"decode_attention {(b, s, hkv, gq, hd)}: ok in float32 and bfloat16")

    for arch, b, s in ((MOE_ARCH, MOE_BATCH, MOE_PROMPT + MOE_NEW),
                       (LM_ARCH, LM_BATCH, LM_PROMPT + LM_NEW)):
        cfg = get_config(arch)
        hkv, gq, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
        edges = torch.tensor([1, 511, 512, 513, 2048, s], dtype=torch.int32)
        for dt in (bf16, f32):
            q, k, v = inputs(b, s, hkv, gq, hd, dt)
            length = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                                   dtype=torch.int32)
            length[:len(edges)] = edges
            held(q, k, v, length, f"{arch} path shape {dt}")
            log(f"decode_attention {arch} path shape {(b, s, hkv, gq, hd)} "
                f"{dt}: ok")
            del q, k, v

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = decode_attention_timed_shapes()

    def timed_shape(name: str) -> dict:
        """bf16 inputs at timed shape ``name``, held at the lengths either
        side of every split's first row (and of the first tile's end, 1, 2
        and S), then with every row at length S held, and the kernel, its
        plain version and SDPA (the yardstick, never called by the port: on
        inputs already laid out (B, H, 1, hd) / (B, Hkv, S, hd), a mask of
        ones, GQA grouping h = kv * G + g as the kernel's) timed; the
        kernel's device time and the kernels a call launched in the early
        window (``device``; None where it held no event), the wrapper's host
        microseconds a call as the decode step calls it (a call a layer,
        each on its layer's view of stacked caches, whose values are not
        read for the time), the split plan, and the bound: K and V read
        once, q read and the output written once, the lengths read."""
        b, s, hkv, gq, hd = timed[name]
        q, k, v = inputs(b, s, hkv, gq, hd, bf16)
        splits, rows = da.split_plan(b, hkv, s, gq, hd, 2,
                                     da.sm_count(torch.cuda.current_device()))
        edges = {1, 2, 15, 16, 17, s - 1, s} | {
            i * rows + d for i in range(1, splits) for d in (-1, 0, 1)}
        edges = sorted(n for n in edges if 1 <= n <= s)
        for n in edges:
            held(q, k, v, torch.full((b,), n, dtype=torch.int32, device=dev),
                 f"{name} {(b, s, hkv, gq, hd)} length {n}")
        mixed = torch.tensor([edges[i % len(edges)] for i in range(b)],
                             dtype=torch.int32, device=dev)
        held(q, k, v, mixed, f"{name} {(b, s, hkv, gq, hd)} mixed edges")
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        got = held(q, k, v, full, f"timed inputs {(b, s, hkv, gq, hd)}")
        qs = q.reshape(b, hkv * gq, 1, hd)
        ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
        mask = torch.ones((b, 1, 1, s), dtype=torch.bool, device=dev)
        lib = sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        call = lambda: da.decode_attention_cuda(q, k, v, full)  # noqa: E731
        views = decode_attention_layer_views()[name]
        kst, vst = (torch.empty((views, b, s, hkv, hd), dtype=bf16, device=dev)
                    for _ in range(2))
        layer = itertools.cycle(range(views))

        def step_call():
            i = next(layer)
            return da.decode_attention_cuda(q, kst[i], vst[i], full)
        for _ in range(views):                  # a first decode step
            step_call()
        window = device.get(name, {})
        out = {"shape": f"bf16 q ({b}, {hkv}, {gq}, {hd}), k/v ({b}, {s}, "
                        f"{hkv}, {hd}), all lengths {s}",
               "splits": splits, "rows_per_split": rows,
               "blocks": b * hkv * splits,
               "held_lengths": edges,
               "library_max_abs_diff": float(
                   (got.float().reshape(b, hkv * gq, 1, hd) - lib.float()).abs().max()),
               "ms": time_ms(call, torch),
               "device_ms": window.get("device_ms"),
               "device_launches_a_call": window.get("device_launches_a_call"),
               "host_us_a_call": host_us(torch, step_call),
               "host_us_layer_views": views,
               "plain_ms": time_ms(lambda: da.decode_attention_plain(q, k, v, full),
                                   torch),
               "library_ms": time_ms(
                   lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True), torch)}
        # the split kernel, and the combine where there are splits
        assert out["device_launches_a_call"] in (None, 1 + (splits > 1)), \
            f"decode_attention {name}: {out['device_launches_a_call']} " \
            f"kernels a call traced, {splits} splits"
        out["bound_ms"], out["bound_by"] = bound_ms(
            2.0 * b * s * hkv * hd * 2 + 2.0 * q.numel() * 2 + 4.0 * b,
            4.0 * b * hkv * gq * hd * s)
        out["of_bound"] = out["bound_ms"] / out["ms"]
        if out["device_ms"]:
            out["of_bound_device"] = out["bound_ms"] / out["device_ms"]
        del q, k, v, ks, vs, qs, lib, got, kst, vst
        return out

    # timed at the main path's shape in bfloat16, all rows at LM_MID
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/decode_attention.py:67",
           **timed_shape("lm"),
           "max_abs_err": max(err.values()), "max_abs_err_f32": err[f32],
           "max_abs_err_bf16": err[bf16], "max_ulps_bf16": worst_bf16[0],
           "library_call": "torch.nn.functional.scaled_dot_product_attention"
                           "(enable_gqa=True, boolean mask)"}
    # the moe path's decode shape (16 KV heads of 128, G = 1)
    for dt in err:
        err[dt] = 0.0
    rec["moe"] = {**timed_shape("moe"), "max_abs_err_bf16": err[bf16]}
    rec["max_abs_err"] = max(rec["max_abs_err"], *err.values())

    # the hybrid's head width (zamba2-7b: 3584 / 32 = 112) and 96, in the
    # row layout of the next width (128) with the lanes past hd idle: the
    # reference's test shapes, a group of 4, and the hybrid's decode shape
    # with lengths 1 .. its cache's rows
    hb, hs = SSM_BATCH, SSM_PROMPT + SSM_NEW
    hcfg = get_config(SSM_ARCHS["hybrid"])
    hkv, gq, hhd = hcfg.n_kv_heads, hcfg.n_heads // hcfg.n_kv_heads, hcfg.hd
    for dt in err:                       # the wide cases' own maxima
        err[dt] = 0.0
    edges = (1, 2, 63, 64, 65, 511, 512, 513, 2047, 2048, 2049, hs)
    for hd in (hhd, 96):
        for b, s, kvh, gg in ((1, 128, 2, 2), (2, 512, 2, 4), (4, 1024, 8, 7),
                              (2, 700, 4, 1), (8, 1024, 8, 4), (hb, hs, hkv, gq)):
            for dt in (f32, bf16):
                q, k, v = inputs(b, s, kvh, gg, hd, dt)
                length = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                                       dtype=torch.int32)
                cases = [length, torch.full_like(length, s)]
                if s == hs:
                    cases += [torch.tensor(edges[i:i + b], dtype=torch.int32,
                                           device=dev).repeat(2)[:b]
                              for i in range(0, len(edges), b)]
                for lens in cases:
                    held(q, k, v, lens, f"{(b, s, kvh, gg, hd)} {dt}")
                del q, k, v
            log(f"decode_attention hd {hd} {(b, s, kvh, gg)} and the reference's "
                f"shapes: ok in float32 and bfloat16")

    # timed at the hybrid's decode shape in bfloat16, every row at the
    # cache's last step (hs rows)
    rec["hd112"] = {**timed_shape("hd112"),
                    "max_abs_err_f32": err[f32], "max_abs_err_bf16": err[bf16]}
    rec["max_abs_err"] = max(rec["max_abs_err"], *err.values())

    # the vlm and encdec paths' decode shapes: qwen2-vl-2b's self-attention
    # (2 KV heads of 128, groups of 6: B x Hkv = 32 blocks on 132 SMs) and
    # whisper-base's self-attention over its 128-row caches and its
    # cross-attention over F = 1500 frames (8 KV heads of 64, G = 1), with
    # lengths 1 .. the rows, each timed beside SDPA with every row full (the
    # cross-attention's length F at every step)
    for name in ("vlm", "encdec_cross", "encdec_self"):
        b, s, kvh, gg, hd = timed[name]
        for dt in err:
            err[dt] = 0.0
        edges = [n for n in (1, 2, 511, 512, 513, 2047, 2048, 2049, s - 1, s)
                 if n <= s]
        for dt in (f32, bf16):
            q, k, v = inputs(b, s, kvh, gg, hd, dt)
            length = torch.randint(1, s + 1, (b,), device=dev, generator=g,
                                   dtype=torch.int32)
            length[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
            for lens in (length, torch.full_like(length, s)):
                held(q, k, v, lens, f"{name} {(b, s, kvh, gg, hd)} {dt}")
            # float32's split plan: either side of every split's first row
            # (bfloat16's are held in timed_shape)
            splits, rows = da.split_plan(
                b, kvh, s, gg, hd, q.element_size(),
                da.sm_count(torch.cuda.current_device()))
            if dt == f32:
                for n in sorted({i * rows + d for i in range(1, splits)
                                 for d in (-1, 0, 1)}):
                    held(q, k, v, torch.full_like(length, n),
                         f"{name} {(b, s, kvh, gg, hd)} {dt} length {n}")
            del q, k, v
        rec[name] = {**timed_shape(name),
                     "max_abs_err_f32": err[f32], "max_abs_err_bf16": err[bf16]}
        rec["max_abs_err"] = max(rec["max_abs_err"], *err.values())
        log(f"decode_attention {name} {(b, s, kvh, gg, hd)}: ok in float32 and "
            f"bfloat16; {rec[name]}")
    rec["max_share_of_tolerance"] = {"f32": of_bound[f32], "bf16": of_bound[bf16]}
    rec["max_ulps_bf16"] = worst_bf16[0]
    record["decode_attention"] = rec
    cuda.reset_launches()


# ---------------------------------------------------------------------------
# phase 3: the main path through hf, against numpy oracles
# ---------------------------------------------------------------------------

def q26(hf, ss, it, min_count=4):
    """TPCx-BB Q26 (benchmarks/bench_tpcx.py:20)."""
    store_sales, item = hf.table(ss, "ss"), hf.table(it, "it")
    sale_items = hf.join(store_sales, item, on=("ss_item_sk", "i_item_sk"))
    c_i = hf.aggregate(
        sale_items, "ss_customer_sk",
        c_i_count=hf.count(),
        id1=hf.sum_(sale_items["i_class_id"] == 1),
        id2=hf.sum_(sale_items["i_class_id"] == 2),
        id3=hf.sum_(sale_items["i_class_id"] == 3))
    return c_i[c_i["c_i_count"] > min_count]


def q26_multikey(hf, ss, dim, min_count=4):
    """Q26 on the composite (item, region) key (benchmarks/bench_tpcx.py:32)."""
    store_sales, d = hf.table(ss, "ss"), hf.table(dim, "dim")
    sale_items = hf.join(
        store_sales, d,
        on=[("ss_item_sk", "i_item_sk"), ("ss_region", "i_region")])
    per_key = hf.aggregate(
        sale_items, by=("ss_item_sk", "ss_region"),
        n=hf.count(),
        paid=hf.sum_(sale_items["ss_net_paid"]),
        id1=hf.sum_(sale_items["i_class_id"] == 1),
        id2=hf.sum_(sale_items["i_class_id"] == 2))
    return per_key[per_key["n"] > min_count]


def join_tables(n_left: int, n_right: int):
    """Fig. 8a join's tables (bench_relational.py:43): every left id in
    [0, n_right), the right ids an arange."""
    rng = np.random.default_rng(1)
    left = {"id": rng.integers(0, n_right, n_left).astype(np.int32),
            "x": rng.normal(size=n_left).astype(np.float32)}
    right = {"cid": np.arange(n_right, dtype=np.int32),
             "w": rng.normal(size=n_right).astype(np.float32)}
    return left, right


def join_want(left, right) -> dict:
    """Every left row matches right row id (cid is an arange), in left
    order."""
    return {"id": left["id"], "x": left["x"], "w": right["w"][left["id"]]}


# TPCx-BB Q26 at scale 64 of bench_tpcx.run (bench_tpcx.py:126)
Q26_SCALE = 64


_Q26_TABLES: dict = {}


def q26_tables(synth, sf: int = Q26_SCALE):
    """store_sales and item at scale ``sf``, and the number of customers;
    made once a process and shared by the paths (none writes into them)."""
    if sf not in _Q26_TABLES:
        n_sales, n_items, n_cust = 400_000 * sf, 20_000 * sf, 50_000 * sf
        ss = synth.store_sales(n_sales, n_items, n_cust, seed=10)
        it = synth.item(n_items, seed=11)
        _Q26_TABLES[sf] = ss, it, n_cust
    return _Q26_TABLES[sf]


def q26_want(ss, it, n_cust: int) -> dict:
    """Q26's rows from numpy bincounts, in customer order."""
    cls = it["i_class_id"][ss["ss_item_sk"]]
    cust = ss["ss_customer_sk"]
    n_c = np.bincount(cust, minlength=n_cust)
    want = {"ss_customer_sk": np.flatnonzero(n_c > 4).astype(np.int32)}
    k = want["ss_customer_sk"]
    want["c_i_count"] = n_c[k].astype(np.int32)
    for c in (1, 2, 3):
        want[f"id{c}"] = np.bincount(cust, weights=(cls == c),
                                     minlength=n_cust)[k].astype(np.int32)
    return want


def sorted_rows(cols: dict, by) -> dict:
    """The rows of ``cols`` ordered by the columns ``by`` (lexicographic,
    the first most significant), to compare results whose row order
    depends on P."""
    order = np.lexsort([cols[k] for k in reversed(by)])
    return {k: v[order] for k, v in cols.items()}


def region_tables(ss, it, n_regions=4, seed=13):
    """The region column and (item, region) dimension of bench_tpcx.py:50."""
    rng = np.random.default_rng(seed)
    ss = dict(ss)
    ss["ss_region"] = rng.integers(0, n_regions,
                                   len(ss["ss_item_sk"])).astype(np.int32)
    n_items = len(it["i_item_sk"])
    dim = {"i_item_sk": np.tile(it["i_item_sk"], n_regions),
           "i_region": np.repeat(np.arange(n_regions, dtype=np.int32), n_items),
           "i_class_id": np.tile(it["i_class_id"], n_regions)}
    return ss, dim


def check_equal(got: dict, want: dict, tag: str, float_tol=None):
    """Exact on every column, except float columns named in ``float_tol``
    (column -> (rtol, atol))."""
    float_tol = float_tol or {}
    assert set(got) == set(want), (tag, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (tag, k, g.shape, w.shape)
        if k in float_tol and np.issubdtype(g.dtype, np.floating):
            rtol, atol = float_tol[k]
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{tag}.{k}")
        else:
            assert np.array_equal(g, w), f"{tag}.{k} differs"


def profile_run(torch, fn, path: str) -> dict:
    """Run ``fn()`` once under torch.profiler; write the per-op table to
    ``path`` and return device-time totals in ms: kernels, copies, wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    sort = "self_device_time_total"
    with open(path, "w") as f:
        f.write(ka.table(sort_by=sort, row_limit=40))
    # device-side events only (kernels, copies): the aten ops that launch
    # them report the same time again
    dev = {"kernels": 0.0, "copies": 0.0}
    top = []
    for e in ka:
        t = getattr(e, sort, 0.0) / 1e3
        if t <= 0 or not str(e.device_type).endswith("CUDA"):
            continue
        kind = "copies" if "memcpy" in e.key.lower() or \
            "memset" in e.key.lower() else "kernels"
        dev[kind] += t
        top.append((t, e.key[:60]))
    top.sort(reverse=True)
    busy = dev["kernels"] + dev["copies"]
    return {"wall_ms": round(wall * 1e3, 3),
            "kernel_ms": round(dev["kernels"], 3),
            "copy_ms": round(dev["copies"], 3),
            "idle_share": round(max(0.0, 1 - busy / (wall * 1e3)), 4),
            "top": [[round(t, 3), k] for t, k in top[:6]]}


def query_runner(torch, hf, queries: dict, profile_dir: str | None):
    """``run(tag, frame)``: collect ``frame`` on the card, record its wall
    time, peak memory and rows out under ``queries[tag]`` (and a profile
    with ``profile_dir``), and return its columns as numpy."""
    cfg = hf.ExecConfig()          # the card

    def run(tag, frame):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t = frame.collect(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert not t.overflow, f"{tag}: capacity overflow {t.overflow_ops}"
        out = t.to_numpy()
        queries[tag] = {"wall_s": round(wall, 4),
                        "peak_gib": round(torch.cuda.max_memory_allocated()
                                          / 2**30, 3),
                        "rows_out": int(len(next(iter(out.values()))))}
        log(f"{tag}: {queries[tag]}")
        if profile_dir:
            prof = profile_run(torch, lambda: frame.collect(cfg), os.path.join(
                profile_dir, f"profile_{tag}.txt"))
            queries[tag]["profile"] = prof
            log(f"{tag} profile: {prof}")
        return out
    return run


def main_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
              checks: dict | None = None):
    """The relational path: Fig. 8a and TPCx-BB Q26; the digest of the
    aggregate's float sums and means goes into ``checks``."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    n8a = 2**27

    # Fig. 8a filter (bench_relational.py:27)
    t = synth.relational_tables(n8a, 1000, seed=0)
    df = hf.table(t)
    out = run("fig8a_filter", df[df.x < 0.5])
    m = t["x"] < np.float32(0.5)
    check_equal(out, {k: v[m] for k, v in t.items()}, "filter")
    queries["fig8a_filter"]["rows_in"] = n8a
    del t, df, out, m

    # Fig. 8a join (bench_relational.py:43): 2^26 left rows, 2^22 right
    left, right = join_tables(2**26, 2**22)
    out = run("fig8a_join", hf.join(hf.table(left, "l"), hf.table(right, "r"),
                                     on=("id", "cid")))
    # left order kept at P = 1
    check_equal(out, join_want(left, right), "join")
    queries["fig8a_join"]["rows_in"] = 2**26 + 2**22
    del left, right, out

    # Fig. 8a aggregate (bench_relational.py:64): sum(x), mean(y) by id
    t = synth.relational_tables(n8a, 4096, seed=2)
    df = hf.table(t)
    out = run("fig8a_aggregate", agg8a_frame(hf, df))
    check_equal(out, agg8a_want(t), "aggregate", float_tol=AGG8A_TOL)
    # segment_sums folds its tiles in order, so the bits are the same in
    # every run
    checks["fig8a_aggregate_digest"] = digest(np.concatenate([out["s"],
                                                              out["m"]]))
    queries["fig8a_aggregate"]["rows_in"] = n8a
    del t, df, out

    # TPCx-BB Q26 at scale 64 of bench_tpcx.run (bench_tpcx.py:126)
    ss, it, n_cust = q26_tables(synth)
    out = run("fig11_q26", q26(hf, ss, it))
    check_equal(out, q26_want(ss, it, n_cust), "q26")
    queries["fig11_q26"]["rows_in"] = len(ss["ss_item_sk"]) + len(it["i_item_sk"])
    del out

    ssr, dim = region_tables(ss, it)
    out = run("fig11_q26_multikey", q26_multikey(hf, ssr, dim))
    key = ssr["ss_item_sk"].astype(np.int64) * 4 + ssr["ss_region"]
    nk = len(it["i_item_sk"]) * 4
    n_k = np.bincount(key, minlength=nk)
    sel = np.flatnonzero(n_k > 4)
    cls = it["i_class_id"][ssr["ss_item_sk"]]
    want = {"ss_item_sk": (sel // 4).astype(np.int32),
            "ss_region": (sel % 4).astype(np.int32),
            "n": n_k[sel].astype(np.int32),
            "paid": np.bincount(key, weights=ssr["ss_net_paid"].astype(np.float64),
                                minlength=nk)[sel].astype(np.float32)}
    for c in (1, 2):
        want[f"id{c}"] = np.bincount(key, weights=(cls == c),
                                     minlength=nk)[sel].astype(np.int32)
    # ~20 gamma(2, 30) values per key: float32 sums within 1e-4 relative
    check_equal(out, want, "q26_multikey", float_tol={"paid": (1e-4, 1e-2)})
    queries["fig11_q26_multikey"]["rows_in"] = len(key) + len(dim["i_item_sk"])


def agg8a_frame(hf, df):
    """Fig. 8a's aggregate (bench_relational.py:64): sum(x), mean(y) by id."""
    return hf.aggregate(df, "id", s=hf.sum_(df["x"]), m=hf.mean(df["y"]))


# float32 sums of ~32768 N(0,1) values (|s| ~ 180) against a float64
# oracle; their means (|m| ~ 0.005) are held 10x tighter than the change
# one missing row would make (~3e-5)
AGG8A_TOL = {"s": (1e-4, 1e-2), "m": (1e-4, 1e-6)}


def agg8a_want(t: dict, n_keys: int = 4096) -> dict:
    """Fig. 8a aggregate's rows from numpy bincounts, in key order."""
    cnt = np.bincount(t["id"], minlength=n_keys)
    keys = np.flatnonzero(cnt).astype(np.int32)
    sx = np.bincount(t["id"], weights=t["x"].astype(np.float64),
                     minlength=n_keys)
    sy = np.bincount(t["id"], weights=t["y"].astype(np.float64),
                     minlength=n_keys)
    return {"id": keys, "s": sx[keys].astype(np.float32),
            "m": (sy[keys] / cnt[keys]).astype(np.float32)}


def check_close(tag, got, want, rtol, atol) -> float:
    """|got - want| <= atol + rtol |want| elementwise; the largest
    difference."""
    d = np.abs(got.astype(np.float64) - want)
    bad = d > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{tag}: {int(bad.sum())} rows off, first at "
                           f"{int(np.argmax(bad))}, max diff {d.max()}")
    return float(d.max()) if d.size else 0.0


def stencil_f32(v, weights, center, prev_ok=None, next_ok=None):
    """The stencil's float32 operations in numpy, tap by tap: zero halos,
    and (partitioned) taps across a group edge zeroed through the masks
    ``prev_ok`` / ``next_ok`` of a 3-tap window."""
    n, k = len(v), len(weights)
    ext = np.concatenate([np.zeros(center, np.float32), v,
                          np.zeros(k - 1 - center, np.float32)])
    acc = np.zeros(n, np.float32)
    for j, w in enumerate(weights):
        tap = ext[j:j + n]
        if prev_ok is not None and j != center:
            tap = np.where(prev_ok if j < center else next_ok, tap,
                           np.float32(0))
        acc = acc + np.float32(w) * tap
    return acc


def window_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
                checks: dict | None = None, n: int = WINDOW_ROWS,
                groups: int = WINDOW_GROUPS):
    """The window path: Fig. 8b (bench_analytics.py:29-62) and the
    partitioned windows (bench_analytics.py:64-76) at n = WINDOW_ROWS; the
    largest difference of each float check goes into ``checks``."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    x = synth.series(n, seed=3)
    df = hf.table({"x": x})
    x64 = x.astype(np.float64)
    csum = np.cumsum(x64)

    # fig8b_cumsum: float32 look-back scan against a float64 oracle.  The
    # scan adds in another order; its error grows with the magnitude of the
    # partial sums (|S| reaches ~3.5e4), so: within 1e-5 of the running max
    # |S| (+1e-3), ~40 float32 roundings of that magnitude.  The order is
    # fixed, so the digest of the result is the same in every run.
    out = run("fig8b_cumsum", hf.cumsum(df, df["x"], out="c"))
    assert np.array_equal(out["x"], x)
    scale = np.maximum.accumulate(np.abs(csum))
    checks["fig8b_cumsum"] = check_close("fig8b_cumsum", out["c"], csum,
                                         0.0, 1e-5 * scale + 1e-3)
    checks["fig8b_cumsum_digest"] = digest(out["c"])
    queries["fig8b_cumsum"]["rows_in"] = n
    del out, scale

    # fig8b_sma / fig8b_wma: the float32 tap operations replayed in numpy;
    # the kernel does the same operations, so equal within 1e-6
    for tag, frame, w in (
            ("fig8b_sma", hf.sma(df, df["x"], 3, out="s"), [1.0 / 3] * 3),
            ("fig8b_wma", hf.wma(df, df["x"], [1, 2, 1], out="s"),
             [0.25, 0.5, 0.25])):
        out = run(tag, frame)
        want = stencil_f32(x, w, 1)
        checks[tag] = check_close(tag, out["s"], want, 1e-6, 1e-6)
        checks[tag + "_bitwise"] = bool(np.array_equal(out["s"], want))
        queries[tag]["rows_in"] = n
        del out, want

    # fig8b_rolling_mean_exact: the mean of the min(i + 1, 20) rows that
    # exist, from float64 cumsum differences.  The kernel sums 20 taps of
    # |x| < 6 with weight 1/20 and divides by the summed weights: ~40
    # float32 roundings of values below 6, so atol 2e-5, rtol 1e-5.
    out = run("fig8b_rolling_mean_exact",
              hf.rolling_mean(df, df["x"], 20, out="m", exact=True))
    c0 = np.concatenate([[0.0], csum])
    i = np.arange(n)
    lo = np.maximum(i - 19, 0)
    want = (c0[i + 1] - c0[lo]) / (i + 1 - lo)
    checks["fig8b_rolling_mean_exact"] = check_close(
        "fig8b_rolling_mean_exact", out["m"], want, 1e-5, 2e-5)
    queries["fig8b_rolling_mean_exact"]["rows_in"] = n
    del out, c0, i, lo, want, df, csum, x64

    # the partitioned fact table: ~sqrt(n) groups, t a permutation
    rng = np.random.default_rng(7)
    g = rng.integers(0, groups, n).astype(np.int32)
    t = rng.permutation(n).astype(np.int32)
    t8 = (t // 8).astype(np.int32)
    w0 = rng.normal(size=groups).astype(np.float32)
    # the oracle's order: sort once by (g, t) (unique keys)
    perm = np.argsort((g.astype(np.int64) << 32) | t)
    gs, ts, xs = g[perm], t[perm], x[perm]
    head = np.ones(n, bool)
    head[1:] = gs[1:] != gs[:-1]
    idx = np.arange(n)
    first = np.maximum.accumulate(np.where(head, idx, 0))
    nxt = np.ones(n, bool)
    nxt[:-1] = ~head[1:]             # row i + 1 is in row i's group
    nxt[-1] = False

    # partitioned WMA after a join on g (bench_analytics.py:64-76): the
    # exchanges (compactions at P = 1), the merge join, the local sort and
    # segment_stencil.  The value x * w0 and the three taps replayed in
    # float32 numpy: equal within 1e-6.
    j = hf.join(hf.table({"g": g, "t": t, "x": x}, "fact"),
                hf.table({"g": np.arange(groups, dtype=np.int32), "w0": w0},
                         "dim"), on="g")
    out = run("partitioned_wma", hf.wma(j, j["x"] * j["w0"], [1, 2, 1],
                                        out="ww", partition_by="g",
                                        order_by="t"))
    for k, v in (("g", gs), ("t", ts), ("x", xs), ("w0", w0[gs])):
        assert np.array_equal(out[k], v), f"partitioned_wma.{k} differs"
    want = stencil_f32(xs * w0[gs], [0.25, 0.5, 0.25], 1, ~head, nxt)
    checks["partitioned_wma"] = check_close("partitioned_wma", out["ww"],
                                            want, 1e-6, 1e-6)
    checks["partitioned_wma_bitwise"] = bool(np.array_equal(out["ww"], want))
    queries["partitioned_wma"]["rows_in"] = n + groups
    del out, want, j

    # grouped_windows: one frame chaining five windows over the groups
    fact = hf.table({"g": g, "t": t, "t8": t8, "x": x}, "fact")
    a = fact.over("g", order_by="t").cumsum(fact["x"], out="c")
    b = a.over("g", order_by="t").rolling_mean(a["x"], 7, out="m", exact=True)
    c = b.over("g", order_by="t8").rank(out="r")
    d = c.over("g", order_by="t8").dense_rank(out="dr")
    e = d.over("g", order_by="t8").row_number(out="rn")
    out = run("grouped_windows", e)
    for k, v in (("g", gs), ("t", ts), ("t8", ts // 8), ("x", xs)):
        assert np.array_equal(out[k], v), f"grouped_windows.{k} differs"
    # segmented cumsum from float64: within 1e-5 of the group's running sum
    # of |x| (+1e-4), as in phase 2
    cs = np.cumsum(xs.astype(np.float64))
    base = np.where(first > 0, cs[np.maximum(first - 1, 0)], 0.0)
    ca = np.cumsum(np.abs(xs.astype(np.float64)))
    abase = np.where(first > 0, ca[np.maximum(first - 1, 0)], 0.0)
    checks["grouped_cumsum"] = check_close("grouped_cumsum", out["c"],
                                           cs - base, 0.0,
                                           1e-5 * (ca - abase) + 1e-4)
    checks["grouped_cumsum_digest"] = digest(out["c"])
    # exact rolling mean over the min(pos + 1, 7) rows of the group: 7 taps
    lo = np.maximum(first, idx - 6)
    win = cs - np.where(lo > 0, cs[np.maximum(lo - 1, 0)], 0.0)
    checks["grouped_rolling_mean"] = check_close(
        "grouped_rolling_mean", out["m"], win / (idx - lo + 1), 1e-5, 1e-5)
    del cs, base, ca, abase, lo, win
    # the ranks over (g, t8): exact
    run_head = head.copy()
    run_head[1:] |= (ts[1:] // 8) != (ts[:-1] // 8)
    run_first = np.maximum.accumulate(np.where(run_head, idx, 0))
    runs = np.cumsum(run_head)
    for k, want in (("rn", idx - first + 1), ("r", run_first - first + 1),
                    ("dr", runs - runs[first] + 1)):
        assert np.array_equal(out[k], want.astype(np.int32)), \
            f"grouped_windows.{k} differs"
    queries["grouped_windows"]["rows_in"] = n


# ---------------------------------------------------------------------------
# the sort path: global sort, limit, rebalance, concat and persist at P = 1
# ---------------------------------------------------------------------------

# Fig. 12's two legs as the reference plans them at P = 1 (shuffles,
# all_to_all): Q26 against the cold item dimension, and against the one
# persisted hash-partitioned on i_item_sk, whose side needs no exchange.
# tests/test_torch_sort.py holds both packages' plans to these numbers.
Q26_LEGS = {"cold": (3, 6), "persisted": (2, 4)}


def q26_fluent(ss, item, min_count=4):
    """TPCx-BB Q26 over any item-dimension frame (bench_tpcx.py:65-74)."""
    si = ss.merge(item, on=("ss_item_sk", "i_item_sk"))
    c = si.groupby("ss_customer_sk").agg(
        c_i_count="count", id1=(si["i_class_id"] == 1, "sum"),
        id2=(si["i_class_id"] == 2, "sum"), id3=(si["i_class_id"] == 3, "sum"))
    return c[c["c_i_count"] > min_count]


def persisted_dim(hf, it, cfg):
    """bench_tpcx.py:178-181: the item dimension deduplicated by a
    first-aggregate on its key, persisted hash-partitioned on it."""
    return (hf.table(it, "it").groupby("i_item_sk")
            .agg(i_class_id=("i_class_id", "first")).persist(cfg))


def stable_order(x: np.ndarray) -> np.ndarray:
    """``np.argsort(x, kind="stable")`` of a float32 array without NaNs, as
    one sort of 64-bit keys: the order-preserving bits of x (with -0.0
    taken as 0.0, as the sort compares them) above the row index."""
    u = (x + np.float32(0)).view(np.uint32)
    s = np.where(u >> np.uint32(31), ~u, u | np.uint32(0x80000000))
    key = (s.astype(np.uint64) << np.uint64(32)) \
        | np.arange(len(x), dtype=np.uint64)
    key.sort()
    return (key & np.uint64(0xFFFFFFFF)).astype(np.int64)


def fig14_inputs(synth, n: int):
    """bench_validate.py:20-32's tables: n fact rows with keys in
    [0, n / 16), and the dimension over those keys."""
    rng = np.random.default_rng(14)
    nk = n // 16
    fact = {"k": rng.integers(0, nk, n).astype(np.int32),
            "v": synth.series(n, seed=14)}
    kdim = {"k": np.arange(nk, dtype=np.int32),
            "w": rng.normal(size=nk).astype(np.float32)}
    return fact, kdim


def fig14_frame(hf, fact, kdim):
    """bench_validate.py:20-32: group-by sum/count -> join -> sort."""
    agg = hf.aggregate(hf.table(fact, "fact"), by="k", v_sum=("v", "sum"),
                       v_cnt=("v", "count"))
    return hf.join(agg, hf.table(kdim, "dim"), on="k").sort_values("v_sum")


def global_rank_frame(hf, x, kinds=("rank", "dense_rank", "row_number")):
    """The global rank kinds of the series ``x`` by its values, chained
    (columns r, dr, rn): one sample sort under the first."""
    frame = hf.table({"x": x})
    for kind, col in zip(kinds, ("r", "dr", "rn")):
        frame = getattr(hf, kind)(frame, None, "x", out=col)
    return frame


def sma_after_filter_frame(hf, x):
    """An SMA of 3 over the positive values of ``x``: the filter makes the
    input 1D_VAR, so a Rebalance comes before the stencil."""
    f = hf.table({"x": x})
    f = f[f["x"] > 0.0]
    return hf.sma(f, f["x"], 3, out="s")


def concat_aggregate_frame(hf, t):
    """``t`` in two halves, concatenated, then Fig. 8a's sum by id."""
    h = len(t["id"]) // 2
    both = hf.concat(hf.table({k: v[:h] for k, v in t.items()}, "a"),
                     hf.table({k: v[h:] for k, v in t.items()}, "b"))
    return hf.aggregate(both, "id", s=hf.sum_(both["x"]))


def sort_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
              checks: dict | None = None, n: int = SORT_ROWS):
    """The sort path at P = 1: a global sort of Fig. 8a's table and its
    descending head, bench_validate.py's group-by -> join -> sort, the
    global rank kinds over Fig. 8b's series, an SMA after a filter (a
    Rebalance under the stencil), a concat feeding the Fig. 8a aggregate,
    and Fig. 12's Q26 against a persisted and a cold item dimension, each
    twice; every query against numpy."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    cfg = hf.ExecConfig()

    # sort_fig8a: the sorted x bitwise, every row whole: at P = 1 the sort
    # is stable, so the rows are the input's in numpy's stable order
    t = synth.relational_tables(n, 1000, seed=0)
    df = hf.table(t)
    out = run("sort_fig8a", df.sort_values("x"))
    order = stable_order(t["x"])
    assert np.array_equal(out["x"], np.sort(t["x"])), "sort_fig8a.x"
    check_equal(out, {k: v[order] for k, v in t.items()}, "sort_fig8a")
    queries["sort_fig8a"]["rows_in"] = n
    # the descending sort is the stable ascending order reversed
    out = run("sort_desc_head", df.sort_values("x", ascending=False).head(1000))
    check_equal(out, {k: v[order[::-1][:1000]] for k, v in t.items()},
                "sort_desc_head")
    queries["sort_desc_head"]["rows_in"] = n
    del t, df, out, order

    # fig14_pipeline: sums within the aggregate's tolerance, in order
    fact, kdim = fig14_inputs(synth, n)
    nk = len(kdim["k"])
    out = run("fig14_pipeline", fig14_frame(hf, fact, kdim))
    assert np.all(np.diff(out["v_sum"]) >= 0), "fig14_pipeline order"
    cnt = np.bincount(fact["k"], minlength=nk)
    keys = np.flatnonzero(cnt)
    s = np.bincount(fact["k"], weights=fact["v"].astype(np.float64),
                    minlength=nk)
    by_k = np.argsort(out["k"])
    check_equal({c: v[by_k] for c, v in out.items()},
                {"k": keys.astype(np.int32), "v_sum": s[keys].astype(np.float32),
                 "v_cnt": cnt[keys].astype(np.int32), "w": kdim["w"][keys]},
                "fig14_pipeline", float_tol={"v_sum": (1e-4, 1e-3)})
    queries["fig14_pipeline"]["rows_in"] = n + nk
    del fact, kdim, out, cnt, keys, s, by_k

    # global_rank over Fig. 8b's series: a SampleSort, then the ranks of the
    # sorted keys, exact against scipy
    from scipy.stats import rankdata
    x = synth.series(n, seed=3)
    out = run("global_rank", global_rank_frame(hf, x))
    xs = np.sort(x)
    assert np.array_equal(out["x"], xs), "global_rank.x"
    # rankdata may give ranks in its input's float dtype: float64 holds
    # every rank of 2^27 rows exactly, float32 not past 2^24
    x64 = xs.astype(np.float64)
    for col, method in (("r", "min"), ("dr", "dense"), ("rn", "ordinal")):
        assert np.array_equal(out[col], rankdata(x64, method=method)), \
            f"global_rank.{col}"
    queries["global_rank"]["rows_in"] = n
    del out, xs, x64

    # sma_after_filter: the filter makes the series 1D_VAR, so a Rebalance
    # (a compaction at P = 1) comes before the stencil; held as Fig. 8b's
    # SMA is, against the float32 taps replayed in numpy
    out = run("sma_after_filter", sma_after_filter_frame(hf, x))
    xf = x[x > np.float32(0)]
    assert np.array_equal(out["x"], xf), "sma_after_filter.x"
    want = stencil_f32(xf, [1.0 / 3] * 3, 1)
    checks["sma_after_filter"] = check_close("sma_after_filter", out["s"],
                                             want, 1e-6, 1e-6)
    checks["sma_after_filter_bitwise"] = bool(np.array_equal(out["s"], want))
    queries["sma_after_filter"]["rows_in"] = n
    del x, out, xf, want

    # concat_aggregate: Fig. 8a's aggregate table in two halves, concatenated
    # and aggregated; fig8a_aggregate's oracle and tolerance
    t = synth.relational_tables(n, 4096, seed=2)
    out = run("concat_aggregate", concat_aggregate_frame(hf, t))
    cnt = np.bincount(t["id"], minlength=4096)
    keys = np.flatnonzero(cnt).astype(np.int32)
    sx = np.bincount(t["id"], weights=t["x"].astype(np.float64), minlength=4096)
    check_equal(out, {"id": keys, "s": sx[keys].astype(np.float32)},
                "concat_aggregate", float_tol={"s": (1e-4, 1e-2)})
    queries["concat_aggregate"]["rows_in"] = n
    del t, out

    # fig12_q26_persisted (bench_tpcx.py:169-190): Q26 against the persisted
    # and the cold item dimension, each twice; the plans are the reference's
    ss, it, n_cust = q26_tables(synth)
    want = q26_want(ss, it, n_cust)
    t0 = time.perf_counter()
    pdim = persisted_dim(hf, it, cfg)
    queries["fig12_persist_dim_s"] = round(time.perf_counter() - t0, 4)
    ss_df = hf.table(ss, "ss")
    for leg, item in (("cold", hf.table(it, "it")), ("persisted", pdim)):
        frame = q26_fluent(ss_df, item)
        plan = frame.physical_plan(cfg)
        got = (plan.shuffle_count(), plan.collective_count())
        assert got == Q26_LEGS[leg], f"fig12 {leg}: plan {got}"
        for i in (1, 2):
            tag = f"fig12_q26_{leg}_{i}"
            check_equal(run(tag, frame), want, tag)
            queries[tag]["rows_in"] = len(ss["ss_item_sk"]) + len(it["i_item_sk"])
            queries[tag]["shuffles"], queries[tag]["all_to_all"] = got


# The frame path: TPCx-BB's string queries (bench_tpcx.py:100-125, 192-210)
# and the frame, null and dtype verbs, at Q26's scale 64.
FRAME_SCALE = Q26_SCALE // 2            # 64 before the tp_train path came
# a dimension keyed by category name: four of synth.CATEGORY_NAMES, two new
FRAME_DIM_NAMES = ("bikes", "books", "garden", "music", "toys", "wine")


def frame_tables(synth, sf: int = FRAME_SCALE):
    """bench_tpcx.run's string inputs at scale ``sf``: web clicks over
    Zipf-skewed items, the item table with its category name, and store
    sales with a string channel and a discount, each with 2 % nulls."""
    n_sales, n_items, n_cust = 400_000 * sf, 20_000 * sf, 50_000 * sf
    wcs = synth.web_clickstream(n_sales, n_items, n_cust, seed=12, skew=1.1)
    itx = synth.item_ext(n_items, seed=11)
    ssx = synth.store_sales_ext(n_sales, n_items, n_cust, seed=10)
    return wcs, itx, ssx


def category_dim():
    rng = np.random.default_rng(21)
    return {"i_category_name": np.asarray(FRAME_DIM_NAMES, dtype=object),
            "w": rng.normal(size=len(FRAME_DIM_NAMES)).astype(np.float32)}


def q05_frame(wcs_df, item_df, books, media):
    """TPCx-BB Q05 (bench_tpcx.py:100): clicks per user on one category,
    on two others, and all clicks."""
    j = wcs_df.merge(item_df, on=("wcs_item_sk", "i_item_sk"))
    return j.groupby("wcs_user_sk").agg(
        clicks_books=(j["i_category_name"] == books, "sum"),
        clicks_media=(j["i_category_name"].isin(media), "sum"),
        total="count")


def q09_channel_frame(ss_df):
    """bench_tpcx.py:113: a string isin filter, the nullable channel as the
    group key, skipna sum/mean/count over the nullable discount."""
    f = ss_df[ss_df["ss_channel"].isin(["web", "catalog"])]
    return f.groupby("ss_channel").agg(
        revenue=("ss_net_paid", "sum"), avg_disc=("ss_discount", "mean"),
        n_disc=("ss_discount", "count"), n="count")


def frame_verbs_frame(ss_df):
    """dropna, fillna, assign, astype, rename, drop, a column assigned from
    a string predicate, then a group-by on the renamed channel."""
    v = (ss_df.dropna(subset="ss_channel").fillna({"ss_discount": 0.0})
         .assign(net=lambda d: d.ss_net_paid - d.ss_discount)
         .astype({"ss_customer_sk": np.float32})
         .rename(columns={"ss_channel": "channel"})
         .drop("ss_ticket_number"))
    v["is_web"] = v["channel"] == "web"
    return v.groupby("channel").agg(
        net=("net", "sum"), cust=("ss_customer_sk", "mean"),
        web=("is_web", "sum"), n="count")


def null_rows_frame(ss_df):
    """The sales whose channel or discount is null: a category isna and a
    float isna, one int column out."""
    null = ss_df.ss_channel.isna() | ss_df.ss_discount.isna()
    return ss_df[null][["ss_ticket_number"]]


def sales_halves(ssx: dict, code: np.ndarray) -> tuple[dict, dict]:
    """The two halves of the sales for concat_channels: the first keeps
    only its catalog and store rows (``code`` 0 and 1), so its dictionary
    differs from the second's."""
    h = len(code) // 2
    keep = np.flatnonzero((code[:h] == 0) | (code[:h] == 1))
    return ({k: v[:h][keep] for k, v in ssx.items()},
            {k: v[h:] for k, v in ssx.items()})


def concat_channels_frame(hf, a_df, b_df):
    both = hf.concat(a_df, b_df)
    return both.groupby("ss_channel").agg(
        n="count", revenue=("ss_net_paid", "sum"))


def merge_category_frame(itx_df, dim_df):
    j = itx_df.merge(dim_df, on="i_category_name")
    return j.groupby("i_category_name").agg(
        n="count", w=("w", "max"), cls=("i_class_id", "sum"))


def channel_codes(channels: np.ndarray, synth) -> np.ndarray:
    """The sales channels as codes into synth.CHANNELS (sorted), -1 for
    None: the dictionary ingest builds, without its per-row loop."""
    code = np.full(len(channels), -1, np.int32)
    for i, c in enumerate(synth.CHANNELS):
        code[channels == c] = i
    return code


def q05_want(wcs, itx, synth) -> dict:
    """Q05's rows from numpy bincounts over category ids, in user order
    (the names map from i_category_id, synth.item_ext)."""
    names = list(synth.CATEGORY_NAMES)
    cat = itx["i_category_id"][wcs["wcs_item_sk"]] - 1
    user = wcs["wcs_user_sk"]
    n_u = np.bincount(user)
    keys = np.flatnonzero(n_u)
    media = (cat == names.index("electronics")) | (cat == names.index("music"))
    return {"wcs_user_sk": keys.astype(np.int32),
            "clicks_books": np.bincount(user, weights=cat == names.index("books"),
                                        minlength=len(n_u))[keys].astype(np.int32),
            "clicks_media": np.bincount(user, weights=media,
                                        minlength=len(n_u))[keys].astype(np.int32),
            "total": n_u[keys].astype(np.int32)}


def merge_category_want(itx, dim, synth) -> dict:
    """The merged names' rows in the union dictionary's code order."""
    union = sorted(set(synth.CATEGORY_NAMES) | set(dim["i_category_name"]))
    cat = itx["i_category_id"] - 1
    out = {c: [] for c in ("i_category_name", "n", "w", "cls")}
    for name, w in zip(dim["i_category_name"], dim["w"]):
        if name not in synth.CATEGORY_NAMES:
            continue
        m = cat == list(synth.CATEGORY_NAMES).index(name)
        out["i_category_name"].append(union.index(name))
        out["n"].append(int(m.sum()))
        out["w"].append(w)
        out["cls"].append(int(itx["i_class_id"][m].sum()))
    order = np.argsort(out["i_category_name"])
    return {"i_category_name": np.asarray(out["i_category_name"], np.int32)[order],
            "n": np.asarray(out["n"], np.int32)[order],
            "w": np.asarray(out["w"], np.float32)[order],
            "cls": np.asarray(out["cls"], np.int32)[order]}


def max_rel(got: dict, want: dict, cols) -> float:
    """The largest |got - want| / |want| over the float columns ``cols``
    (a zero in ``want`` divides by the smallest normal float32)."""
    tiny = np.finfo(np.float32).tiny
    return max(float(np.max(np.abs(got[c].astype(np.float64) - want[c])
                            / np.maximum(np.abs(want[c].astype(np.float64)),
                                         tiny), initial=0.0))
               for c in cols)


def per_channel(code: np.ndarray, cols: dict) -> tuple[np.ndarray, dict]:
    """The channels with rows (code >= 0) and, per column, its float64 sum
    per channel."""
    ok = code >= 0
    n = np.bincount(code[ok], minlength=3)
    keys = np.flatnonzero(n)
    return keys.astype(np.int32), {
        c: np.bincount(code[ok], weights=np.asarray(v)[ok].astype(np.float64),
                       minlength=3)[keys] for c, v in cols.items()}


def frame_path(torch, hf, synth, queries: dict, profile_dir: str | None = None,
               checks: dict | None = None, sf: int = FRAME_SCALE):
    """The frame path at P = 1: Q05 over string category names (its plan
    the int-category Q05's), the Q09 channel rollup, the frame, null and
    dtype verbs, the null-row filter, a concat that recodes its parts'
    dictionaries and a merge on category keys; every query against numpy.
    Host-side ingest (dictionary encoding) is timed apart from the
    queries."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    cfg = hf.ExecConfig()
    wcs, itx, ssx = frame_tables(synth, sf)
    n_sales = len(ssx["ss_channel"])
    ingest = {}
    t0 = time.perf_counter()
    wcs_df, itx_df = hf.table(wcs, "wcs"), hf.table(itx, "itx")
    ingest["wcs_itx_s"] = round(time.perf_counter() - t0, 4)
    t0 = time.perf_counter()
    ss_df = hf.table(ssx, "ssx")
    ingest["ssx_s"] = round(time.perf_counter() - t0, 4)
    code = channel_codes(ssx["ss_channel"], synth)
    assert np.array_equal(ss_df.node.columns["ss_channel"], code)

    # q05_string: the string predicates plan as the int-category Q05's
    names = list(synth.CATEGORY_NAMES)
    itx_int = {k: v for k, v in itx.items() if k != "i_category_name"}
    itx_int["i_category_name"] = (itx["i_category_id"] - 1).astype(np.int32)
    frame = q05_frame(wcs_df, itx_df, "books", ["electronics", "music"])
    plans = [f.physical_plan(cfg) for f in (frame, q05_frame(
        wcs_df, hf.table(itx_int, "itx"), names.index("books"),
        [names.index("electronics"), names.index("music")]))]
    got = [(p.counts(), p.shuffle_census(P=2), p.shuffle_row_bytes())
           for p in plans]
    assert got[0] == got[1], f"q05_string plans {got[0]}, int {got[1]}"
    out = run("q05_string", frame)
    check_equal(out, q05_want(wcs, itx, synth), "q05_string")
    queries["q05_string"]["rows_in"] = len(wcs["wcs_user_sk"]) \
        + len(itx["i_item_sk"])
    queries["q05_string"]["plan_like_int"] = True

    # q09_channel: the web and catalog codes, skipna over the discount
    out = run("q09_channel", q09_channel_frame(ss_df))
    disc = ssx["ss_discount"]
    ok = ~np.isnan(disc)
    sel = np.where((code == 0) | (code == 2), code, -1)
    keys, s = per_channel(sel, {"revenue": ssx["ss_net_paid"],
                                "disc": np.where(ok, disc, 0), "n_disc": ok,
                                "n": np.ones(n_sales)})
    tol = {"revenue": (1e-4, 1e-2), "avg_disc": (1e-4, 1e-5)}
    want = {"ss_channel": keys, "revenue": s["revenue"].astype(np.float32),
            "avg_disc": (s["disc"] / s["n_disc"]).astype(np.float32),
            "n_disc": s["n_disc"].astype(np.int32),
            "n": s["n"].astype(np.int32)}
    check_equal(out, want, "q09_channel", tol)
    checks["q09_channel_max_rel"] = max_rel(out, want, tol)
    queries["q09_channel"]["rows_in"] = n_sales

    # frame_verbs: dropna -> fillna -> assign -> astype -> rename -> drop,
    # a string-predicate column, and the group-by on the renamed channel
    out = run("frame_verbs", frame_verbs_frame(ss_df))
    net = ssx["ss_net_paid"] - np.where(ok, disc, np.float32(0))
    keys, s = per_channel(code, {
        "net": net, "n": np.ones(n_sales), "web": code == 2,
        "cust": ssx["ss_customer_sk"].astype(np.float32)})
    tol = {"net": (1e-4, 1e-2), "cust": (1e-4, 1e-2)}
    want = {"channel": keys, "net": s["net"].astype(np.float32),
            "cust": (s["cust"] / s["n"]).astype(np.float32),
            "web": s["web"].astype(np.int32), "n": s["n"].astype(np.int32)}
    check_equal(out, want, "frame_verbs", tol)
    checks["frame_verbs_max_rel"] = max_rel(out, want, tol)
    queries["frame_verbs"]["rows_in"] = n_sales

    out = run("null_rows", null_rows_frame(ss_df))
    want = ssx["ss_ticket_number"][(code < 0) | ~ok]
    check_equal({"ss_ticket_number": np.sort(out["ss_ticket_number"])},
                {"ss_ticket_number": np.sort(want)}, "null_rows")
    queries["null_rows"]["rows_in"] = n_sales
    del out, want, net, sel, disc, ok

    # concat_channels: the first half's dictionary (2 names, no null)
    # differs from the second's
    a, b = sales_halves(ssx, code)
    t0 = time.perf_counter()
    parts = (hf.table(a, "a"), hf.table(b, "b"))
    ingest["concat_halves_s"] = round(time.perf_counter() - t0, 4)
    assert parts[0].schema["ss_channel"] != parts[1].schema["ss_channel"]
    out = run("concat_channels", concat_channels_frame(hf, *parts))
    cc = channel_codes(np.concatenate([a["ss_channel"], b["ss_channel"]]),
                       synth)
    paid = np.concatenate([a["ss_net_paid"], b["ss_net_paid"]])
    keys, s = per_channel(cc, {"n": np.ones(len(cc)), "revenue": paid})
    want = {"ss_channel": keys, "n": s["n"].astype(np.int32),
            "revenue": s["revenue"].astype(np.float32)}
    check_equal(out, want, "concat_channels", {"revenue": (1e-4, 1e-2)})
    checks["concat_channels_max_rel"] = max_rel(out, want, ("revenue",))
    queries["concat_channels"]["rows_in"] = len(cc)
    del a, b, parts, cc, paid

    # merge_category_keys: the item table's 8 names against a dimension
    # of 6 (4 shared), both recoded onto the union dictionary
    dim = category_dim()
    frame = merge_category_frame(itx_df, hf.table(dim, "cdim"))
    union = tuple(sorted(set(synth.CATEGORY_NAMES) | set(FRAME_DIM_NAMES)))
    assert frame.schema["i_category_name"].categories == union
    out = run("merge_category_keys", frame)
    check_equal(out, merge_category_want(itx, dim, synth),
                "merge_category_keys")
    queries["merge_category_keys"]["rows_in"] = len(itx["i_item_sk"]) \
        + len(FRAME_DIM_NAMES)
    queries["frame_ingest"] = ingest
    log(f"frame ingest (host dictionary encoding): {ingest}")


# The segmentation path: the paper's customer-segmentation program
# (examples/customer_segmentation.py, its defaults: min_count 4, 8
# centroids, 20 iterations) on Q26's tables at scale 64, and Fig. 10's
# built-in and UDF filters (benchmarks/bench_udf.py) at Fig. 8a's 2^27 rows
# in place of the bench's 1 M.
SEG_CENTROIDS = 8
SEG_ITERATIONS = 20
SEG_HEAD = 3
FIG10_ROWS = 2**27


def seg_queries() -> dict:
    """SEG_SRC of tests/torch_segmentation_queries.py, executed: the query
    functions and K-means step the CPU tests hold against the reference."""
    import runpy
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "torch_segmentation_queries.py")
    z: dict = {}
    exec(runpy.run_path(path)["SEG_SRC"], z)
    return z


def kmeans_run(torch, z, x, k: int = SEG_CENTROIDS,
               iters: int = SEG_ITERATIONS):
    """The program's K-means on the card from the first ``k`` rows: every
    iteration's centroids (the start first) and assignment, and its ms
    from CUDA events."""
    cent = x[:k].clone()
    cents, assigns = [cent], []
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    marks[0].record()
    for i in range(iters):
        cent, a = z["kmeans_step"](x, cent)
        marks[i + 1].record()
        cents.append(cent)
        assigns.append(a)
    torch.cuda.synchronize()
    return cents, assigns, [marks[i].elapsed_time(marks[i + 1])
                            for i in range(iters)]


def kmeans_check(torch, x, cents, assigns) -> dict:
    """Each iteration on its own, in float64 so drift cannot compound: the
    row's centroid is within relative 1e-5 (+ 1e-6) of its nearest squared
    distance to that iteration's centroids, and each new centroid is the
    mean of its assigned rows within relative 1e-5 (+ 1e-6).  Returns the
    largest excess distance and relative centroid error."""
    x64 = x.double()
    k = cents[0].shape[0]
    worst_d, worst_c = 0.0, 0.0
    for i, (prev, new, a) in enumerate(zip(cents[:-1], cents[1:], assigns)):
        d = ((x64[:, None] - prev.double()[None]) ** 2).sum(-1)
        dmin = d.min(1).values
        got = d.gather(1, a[:, None])[:, 0]
        assert bool((got <= dmin * (1 + 1e-5) + 1e-6).all()), \
            f"kmeans iteration {i}: a row is not at its nearest centroid"
        worst_d = max(worst_d, float((got - dmin).max()))
        tot = torch.zeros(k, x.shape[1], dtype=torch.float64,
                          device=x.device).index_add_(0, a, x64)
        cnt = torch.bincount(a, minlength=k).double().clamp(min=1)[:, None]
        mean = tot / cnt
        err = (new.double() - mean).abs()
        assert bool((err <= 1e-5 * mean.abs() + 1e-6).all()), \
            f"kmeans iteration {i}: centroids {new} against {mean}"
        worst_c = max(worst_c, float((err / mean.abs().clamp(min=1e-6)).max()))
    return {"kmeans_max_excess_sq_distance": worst_d,
            "kmeans_centroid_max_rel": worst_c}


def seg_profile_frames(base, cluster) -> dict:
    """The cluster profile: the free array of cluster ids attached to the
    features' frame, then group-by sugar over it."""
    g = base.assign(cluster=cluster).groupby("cluster")
    return {"seg_profile_size": g.size(), "seg_profile_mean": g.mean(),
            "seg_profile_sum": g[["id1", "id2", "id3"]].sum(),
            "seg_transform": g.transform("mean"),
            "seg_head": g.head(SEG_HEAD)}


def seg_profile_want(z, feats: dict, cl: np.ndarray) -> dict:
    """The cluster profile's results from numpy (means in float64)."""
    keys = np.flatnonzero(np.bincount(cl)).astype(np.int32)
    stats = {c: z["group_stats"](cl, v) for c, v in feats.items()}
    n = stats["id1"][1]
    f32 = np.float32
    tr = dict(feats, cluster=cl)
    tr.update({f"{c}_mean": s[2][cl].astype(f32) for c, s in stats.items()})
    m = z["first_rows"](cl, SEG_HEAD)
    return {"seg_profile_size": {"cluster": keys,
                                 "size": n[keys].astype(np.int32)},
            "seg_profile_mean": {"cluster": keys, **{
                c: s[2][keys].astype(f32) for c, s in stats.items()}},
            "seg_profile_sum": {"cluster": keys, **{
                c: stats[c][0][keys].astype(np.int32)
                for c in ("id1", "id2", "id3")}},
            "seg_transform": tr,
            "seg_head": {c: v[m] for c, v in tr.items() if c in feats
                         or c == "cluster"}}


def op_histogram(torch, fn) -> dict:
    """The aten ops one call of ``fn`` dispatches, counted on the host by
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.key.startswith("aten::")}


def fig10(torch, hf, synth, z, queries: dict, checks: dict):
    """Fig. 10 (bench_udf.py:32-58): the built-in predicate and the same
    predicate as a UDF over 2^27 rows: the same physical plan and rows;
    walls (median of 3 alternating runs of each bound plan, after one
    warm-up) and the aten op histograms of one call each."""
    cfg = hf.ExecConfig()
    t = synth.relational_tables(FIG10_ROWS, 100, seed=4)
    df = hf.table(t)
    frames = {"fig10_builtin": z["fig10_builtin"](hf, df),
              "fig10_udf": z["fig10_udf"](hf, df)}
    plans = [f.physical_plan(cfg) for f in frames.values()]
    shape = [(p.counts(), p.shuffle_census(P=2),
              [type(o).__name__ for o in p.ops]) for p in plans]
    assert shape[0] == shape[1], f"fig10 plans differ: {shape}"
    bound = {tag: f.lower(cfg) for tag, f in frames.items()}
    walls: dict = {tag: [] for tag in bound}
    outs = {}
    for rep in range(4):
        for tag, plan in bound.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plan()
            torch.cuda.synchronize()
            if rep:
                walls[tag].append(time.perf_counter() - t0)
            outs[tag] = out
    b, u = outs["fig10_builtin"], outs["fig10_udf"]
    assert not b.overflow and not u.overflow
    n = int(b.counts[0])
    assert int(u.counts[0]) == n
    for k in t:
        assert torch.equal(b.columns[k][:n], u.columns[k][:n]), f"fig10.{k}"
    m = t["x"] * np.float32(2.0) + t["y"] > np.float32(0.5)
    check_equal(b.to_numpy(), {k: v[m] for k, v in t.items()}, "fig10_builtin")
    hist = {tag: op_histogram(torch, plan) for tag, plan in bound.items()}
    hb, hu = hist["fig10_builtin"], hist["fig10_udf"]
    diff = {k: [hb.get(k, 0), hu.get(k, 0)] for k in sorted(set(hb) | set(hu))
            if hb.get(k, 0) != hu.get(k, 0)}
    for tag in bound:
        queries[tag] = {"wall_s": round(float(np.median(walls[tag])), 4),
                        "walls_s": [round(w, 4) for w in walls[tag]],
                        "rows_in": FIG10_ROWS, "rows_out": n,
                        "aten_ops": sum(hist[tag].values()),
                        "aten_histogram": hist[tag]}
    wb = queries["fig10_builtin"]["wall_s"]
    queries["fig10_udf"]["overhead_pct"] = round(
        (queries["fig10_udf"]["wall_s"] - wb) / wb * 100, 2)
    queries["fig10_udf"]["same_plan"] = True
    queries["fig10_udf"]["aten_histogram_diff"] = diff
    checks["fig10_aten_histograms_equal"] = not diff
    log(f"fig10: builtin {queries['fig10_builtin']}; "
        f"udf {queries['fig10_udf']}")


def segmentation_path(torch, hf, synth, queries: dict,
                      profile_dir: str | None = None,
                      checks: dict | None = None):
    """The customer-segmentation program at P = 1 through ``hf``: Q26's
    relational stage with a UDF filter (seg_features), matrix assembly
    rebalanced to 1D_BLOCK (seg_matrix), K-means in PyTorch on the card
    (seg_kmeans), the cluster ids back into a frame as a free array and
    profiled with the group-by sugar, transform and head; then Fig. 10.
    Every step against numpy."""
    run = query_runner(torch, hf, queries, profile_dir)
    checks = {} if checks is None else checks
    cfg = hf.ExecConfig()
    z = seg_queries()
    ss, it, n_cust = q26_tables(synth)
    want = q26_want(ss, it, n_cust)
    n = len(want["ss_customer_sk"])

    frame = z["q26_features"](hf, {"ss": ss, "it": it})
    feats = run("seg_features", frame)
    order = np.argsort(feats["ss_customer_sk"], kind="stable")
    check_equal({k: v[order] for k, v in feats.items()}, want, "seg_features")
    queries["seg_features"]["rows_in"] = len(ss["ss_item_sk"]) \
        + len(it["i_item_sk"])

    cols = list(z["FEATURES"])
    plan = frame.lower(cfg, cols, collect_block=True).pplan.counts()
    assert plan["rebalances"] == 1, plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mat, counts, cap = frame.collect_matrix(cols, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert mat.is_cuda and mat.dtype == torch.float32
    assert tuple(mat.shape) == (cap, len(cols)) and int(counts[0]) == n
    x = mat[:n]
    xh = x.cpu().numpy()
    for i, c in enumerate(cols):    # the features' rows, in their order
        assert np.array_equal(xh[:, i], feats[c].astype(np.float32)), c
    queries["seg_matrix"] = {
        "wall_s": round(wall, 4), "rows_out": n, "capacity": int(cap),
        "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "matrix_mb": round(mat.numel() * 4 / 1e6, 1), "plan": plan}
    log(f"seg_matrix: {queries['seg_matrix']}")
    if profile_dir:
        queries["seg_matrix"]["profile"] = profile_run(
            torch, lambda: frame.collect_matrix(cols, cfg),
            os.path.join(profile_dir, "profile_seg_matrix.txt"))
    del xh, mat

    cents, assigns, ms = kmeans_run(torch, z, x)
    checks.update(kmeans_check(torch, x, cents, assigns))
    cent = cents[-1]
    assert bool(torch.isfinite(cent).all())
    sizes = torch.bincount(assigns[-1], minlength=SEG_CENTROIDS).tolist()
    queries["seg_kmeans"] = {
        "rows": n, "centroids": SEG_CENTROIDS, "iterations": SEG_ITERATIONS,
        "ms_per_iteration_median": round(float(np.median(ms)), 4),
        "ms_per_iteration_min": round(float(np.min(ms)), 4),
        "ms_first_iteration": round(ms[0], 4),
        "ms_total": round(float(np.sum(ms)), 4), "cluster_sizes": sizes,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    log(f"seg_kmeans: {queries['seg_kmeans']}")
    del cents, assigns

    # the free array of cluster ids flows back into a frame
    cluster = z["kmeans_step"](x, cent)[1].to(torch.int32)
    cl = cluster.cpu().numpy()
    frames = seg_profile_frames(hf.table(feats, "features"), cluster)
    head = frames["seg_head"].physical_plan(cfg).counts()
    assert head["hash_exchanges"] == 1 and head["local_sorts"] == 1, head
    wants = seg_profile_want(z, feats, cl)
    for tag, f in frames.items():
        out = run(tag, f)
        keys = ("cluster", "ss_customer_sk") \
            if tag in ("seg_transform", "seg_head") else ("cluster",)
        w = wants[tag]
        got, exp = z["sort_rows"](out, keys), z["sort_rows"](w, keys)
        tol = {c: (1e-4, 0.0) for c in w if np.issubdtype(w[c].dtype,
                                                          np.floating)}
        check_equal(got, exp, tag, tol)
        if tol:
            checks[f"{tag}_max_rel"] = max_rel(got, exp, tol)
        queries[tag]["rows_in"] = n
    queries["seg_head"]["plan"] = head
    del x, cluster, frames, wants
    torch.cuda.empty_cache()
    fig10(torch, hf, synth, z, queries, checks)


# ---------------------------------------------------------------------------
# the guardrails path: adaptive statistics, salted skew joins, validate,
# fault injection and the retry policy
# ---------------------------------------------------------------------------

# Fig. 8a join's shape (bench_relational.py:43) with tests/test_skew.py's
# skew: SKEW_HOT of the probe rows on key 3
SKEW_JOIN = (2**25, 2**21)      # cut from (2^26, 2^22) for the time limit
SKEW_HOT = 0.35
ZIPF_ROWS = 2**25                # cut from 2^27, then 2^26, for the time limit
FIG8A_ROWS = 2**26               # cut from 2^27 for the time limit


def skew_tables(n_probe: int, n_dim: int, seed: int = 7):
    """tests/test_skew.py::_skewed raised: a probe (k int32, v float32)
    with SKEW_HOT of its rows on key 3 and the rest uniform over the
    dimension's keys, and a dimension (k an arange, w float32) covering
    every key."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_dim, n_probe).astype(np.int32)
    k[: int(SKEW_HOT * n_probe)] = 3
    rng.shuffle(k)
    probe = {"k": k, "v": rng.normal(size=n_probe).astype(np.float32)}
    dim = {"k": np.arange(n_dim, dtype=np.int32),
           "w": rng.normal(size=n_dim).astype(np.float32)}
    return probe, dim


def skew_join_frame(hf, probe, dim):
    return hf.table(probe, "probe").merge(hf.table(dim, "dim"), on="k")


def pair_keys(xp, k, v):
    """Each row's (k, bits of v) as one 64-bit word: the sorted words of
    two row sets are equal iff the row multisets are (numpy or torch)."""
    if xp is np:
        return (k.astype(np.int64) << 32) | (v.view(np.uint32)
                                             .astype(np.int64))
    return (k.to(xp.int64) << 32) | (v.view(xp.int32).to(xp.int64)
                                     & 0xFFFFFFFF)


def check_skew_join(out: dict, probe: dict, dim: dict, tag: str) -> None:
    """Every probe row once, each with its dimension row's w (numpy)."""
    assert len(out["k"]) == len(probe["k"]), (tag, len(out["k"]))
    assert np.array_equal(out["w"], dim["w"][out["k"]]), f"{tag}.w"
    assert np.array_equal(np.sort(pair_keys(np, out["k"], out["v"])),
                          np.sort(pair_keys(np, probe["k"], probe["v"]))), \
        f"{tag}: (k, v) rows"


def timed_collect(torch, frame, cfg):
    """collect() on the card: (table, wall seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t = frame.collect(cfg)
    torch.cuda.synchronize()
    return (t, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def occupancy(counts) -> float:
    """max / mean of the per-rank row counts."""
    c = np.asarray(counts, dtype=np.float64)
    return float(c.max() / c.mean()) if c.sum() else 0.0


def guardrails_path(torch, hf, synth, queries: dict, checks: dict):
    """Adaptive statistics, salting and the execution guardrails through
    ``hf`` at P = 1 on the card: a salted skew join beside the same join
    unsalted, a Zipf aggregate sized by adaptive caps (first run sampled,
    second realized) beside safe capacities, Fig. 8a's aggregate and Q26
    with and without validate, and Fig. 8a's aggregate under a forced
    overflow, a packed-exchange corruption and a kernel fault."""
    from repro_torch.core.errors import KernelBackendError
    from repro_torch.kernels import cuda
    from repro_torch.runtime import FaultPlan

    dev = torch.device("cuda")

    # -- skew_join: 2 SaltOps and a salted MergeJoin, rows exact ----------
    probe, dim = skew_tables(*SKEW_JOIN)
    frame = skew_join_frame(hf, probe, dim)
    cfgs = {"skew_join_salted": hf.ExecConfig(adaptive_stats=True),
            "skew_join_unsalted": hf.ExecConfig()}
    # unsalted, salted, salted, unsalted: the best wall of two each, the
    # rows held on each one's first run
    for tag in ("skew_join_unsalted", "skew_join_salted",
                "skew_join_salted", "skew_join_unsalted"):
        cfg = cfgs[tag]
        before = cuda.launches["prefix_sum"]
        t, wall, peak = timed_collect(torch, frame, cfg)
        assert not t.overflow and t.events == (), (tag, t.overflow_ops)
        n = int(t.counts.sum())
        assert n == SKEW_JOIN[0], (tag, n)
        if tag in queries:
            queries[tag]["wall_s"] = round(min(wall, queries[tag]["wall_s"]),
                                           4)
            queries[tag]["walls_s"].append(round(wall, 4))
            continue
        k, v, w = (t.columns[c][:n] for c in ("k", "v", "w"))
        assert torch.equal(w, torch.from_numpy(dim["w"]).to(dev)[k.long()]), \
            f"{tag}.w"
        pk = torch.from_numpy(probe["k"]).to(dev)
        pv = torch.from_numpy(probe["v"]).to(dev)
        assert torch.equal(torch.sort(pair_keys(torch, k, v)).values,
                           torch.sort(pair_keys(torch, pk, pv)).values), \
            f"{tag}: (k, v) rows"
        del k, v, w, pk, pv, t
        plan = frame.physical_plan(cfg)
        mj = [op for op in plan.ops if type(op).__name__ == "MergeJoin"]
        queries[tag] = {"wall_s": round(wall, 4), "walls_s": [round(wall, 4)],
                        "peak_gib": round(peak, 3),
                        "rows_in": sum(SKEW_JOIN), "rows_out": n,
                        "prefix_sum_launches":
                            cuda.launches["prefix_sum"] - before,
                        "plan": plan.counts(), "salted": mj[0].salted}
    sq, uq = queries["skew_join_salted"], queries["skew_join_unsalted"]
    log(f"skew_join_salted: {sq}")
    log(f"skew_join_unsalted: {uq}")
    assert sq["plan"]["salt_ops"] == 2 and sq["salted"], sq
    assert uq["plan"]["salt_ops"] == 0 and not uq["salted"], uq
    # the build side's replication compacts through prefix_sum
    assert sq["prefix_sum_launches"] > uq["prefix_sum_launches"], (sq, uq)
    del probe, dim, frame

    # -- zipf_agg_adaptive: adaptive caps, sampled then realized ---------
    rng = np.random.default_rng(4)
    zk = rng.zipf(1.5, ZIPF_ROWS).astype(np.int32)
    zv = rng.random(ZIPF_ROWS, dtype=np.float32)
    zd = {"k": zk, "v": zv}
    frame = hf.table(zd, "z").groupby("k").agg(s=("v", "sum"),
                                               c=("v", "count"))
    kd, vd = torch.from_numpy(zk).to(dev), torch.from_numpy(zv).to(dev)
    keys, inv, cnt = torch.unique(kd, return_inverse=True, return_counts=True)
    sums = torch.zeros(len(keys), dtype=torch.float64, device=dev) \
        .index_add_(0, inv, vd.to(torch.float64))
    del kd, vd, inv

    def held(t, tag):
        n = int(t.counts.sum())
        assert n == len(keys), (tag, n, len(keys))
        assert torch.equal(t.columns["k"][:n], keys), f"{tag}.k"
        assert torch.equal(t.columns["c"][:n].to(torch.int64), cnt), \
            f"{tag}.c"
        s = t.columns["s"][:n].to(torch.float64)
        assert torch.allclose(s, sums, rtol=1e-4, atol=1e-6), f"{tag}.s"
        return float(((s - sums).abs() / sums.abs().clamp(min=1e-30)).max())

    acfg = hf.ExecConfig(adaptive_stats=True, safe_capacities=False,
                         auto_retry=0)
    runs = {}
    for tag, cfg in (("zipf_agg_adaptive", acfg),
                     ("zipf_agg_adaptive_realized", acfg),
                     ("zipf_agg_safe", hf.ExecConfig())):
        pa = [op for op in frame.lower(cfg).pplan.ops
              if type(op).__name__ == "PartialAgg"][0]
        t, wall, peak = timed_collect(torch, frame, cfg)
        assert not t.overflow and t.events == (), (tag, t.overflow_ops)
        runs[tag] = {"wall_s": round(wall, 4), "peak_gib": round(peak, 3),
                     "rows_in": ZIPF_ROWS, "rows_out": int(t.counts.sum()),
                     "partial_agg_cap": int(pa.cap),
                     "ndv_est": pa.ndv_est, "ndv_src": pa.ndv_src,
                     "max_rel_s": held(t, tag)}
        queries[tag] = runs[tag]
        log(f"{tag}: {runs[tag]}")
        del t
    assert runs["zipf_agg_adaptive"]["ndv_src"] == "sample", runs
    assert runs["zipf_agg_adaptive_realized"]["ndv_src"] == "realized", runs
    assert runs["zipf_agg_adaptive_realized"]["ndv_est"] == len(keys), runs
    del zk, zv, zd, frame, keys, cnt, sums
    torch.cuda.empty_cache()

    # -- validate: the checks' cost on Fig. 8a's aggregate and Q26 -------
    t8 = synth.relational_tables(FIG8A_ROWS, 4096, seed=2)
    agg8 = agg8a_frame(hf, hf.table(t8))
    ss, it, n_cust = q26_tables(synth)
    frames = {"fig8a_aggregate": (agg8, FIG8A_ROWS),
              "fig11_q26": (q26(hf, ss, it),
                            len(ss["ss_item_sk"]) + len(it["i_item_sk"]))}
    for name, (frame, rows_in) in frames.items():
        rec = {"rows_in": rows_in}
        outs = {}
        # plain, validated, validated, plain: the best of two each
        for cfg_tag in ("plain", "validate", "validate", "plain"):
            cfg = hf.ExecConfig(validate=cfg_tag == "validate")
            t, wall, peak = timed_collect(torch, frame, cfg)
            assert not t.overflow and t.invariant_failures == (), (name, t)
            outs[cfg_tag] = t.to_numpy()
            rec[f"wall_s_{cfg_tag}"] = round(min(
                wall, rec.get(f"wall_s_{cfg_tag}", wall)), 4)
            rec[f"peak_gib_{cfg_tag}"] = round(peak, 3)
        check_equal(outs["validate"], outs["plain"], f"validate_{name}")
        rec["overhead"] = round(rec["wall_s_validate"]
                                / rec["wall_s_plain"] - 1, 4)
        rec["wall_s"] = rec["wall_s_validate"]
        queries[f"validate_{name}"] = rec
        log(f"validate_{name}: {rec}")
    want8 = agg8a_want(t8)
    clean = agg8.collect(hf.ExecConfig()).to_numpy()
    check_equal(clean, want8, "fig8a_aggregate", AGG8A_TOL)

    # -- forced overflow, corruption and a kernel fault on Fig. 8a -------
    for tag, cfg, kinds in (
            ("forced_overflow", hf.ExecConfig(fault_inject=FaultPlan(
                force_overflow=("HashExchange",))), ["retry"]),
            ("corrupt_heal", hf.ExecConfig(validate=True, fault_inject=FaultPlan(
                corrupt_exchange=("HashExchange",))), ["degrade_packed"])):
        t, wall, peak = timed_collect(torch, agg8, cfg)
        assert not t.overflow and t.invariant_failures == (), (tag, t)
        assert [e.kind for e in t.events] == kinds, (tag, t.events)
        out = t.to_numpy()
        check_equal(out, want8, tag, AGG8A_TOL)
        queries[tag] = {"wall_s": round(wall, 4), "peak_gib": round(peak, 3),
                        "rows_in": FIG8A_ROWS, "rows_out": len(out["id"]),
                        "events": [e.render() for e in t.events],
                        "same_bits_as_clean_run": all(
                            np.array_equal(out[c], clean[c]) for c in clean)}
        log(f"{tag}: {queries[tag]}")
        if tag == "forced_overflow":
            txt = agg8.explain(hf.ExecConfig())
            assert "events (previous run):" in txt and "] retry op#" in txt, txt
            queries[tag]["explain_events"] = txt.split(
                "events (previous run):\n", 1)[1].splitlines()
    got, raised = None, None
    try:
        got = agg8.collect(hf.ExecConfig(fault_inject=FaultPlan(
            fail_kernel="prefix_sum")))
    except KernelBackendError as e:
        raised = e
    assert got is None and raised is not None, "kernel fault: no raise"
    assert raised.kernel == "prefix_sum" and raised.backend == "cuda", raised
    queries["kernel_fault"] = {"raised": type(raised).__name__,
                               "message": str(raised)}
    log(f"kernel_fault: {queries['kernel_fault']}")
    del t8, agg8, frames, outs, clean
    torch.cuda.empty_cache()


# The serving path: launch/serve.py's session at scale 128 (25.6 M
# store_sales rows, 16 bytes each; 256 k items; 1.28 M customers), each
# query of the mix twice a pass, and a 4-shard state of store_sales merged
# to P = 1 with these uneven shares of its rows.
SERVE_SCALE = 128
SERVE_REPEATS = 2
SERVE_SHARES = (0.4, 0.1, 0.3, 0.2)
SERVE_NAMES = ("q26", "per_item", "leaderboard")
SERVE_KEYS = {"q26": ("ss_customer_sk",), "per_item": ("ss_item_sk",),
              "leaderboard": ("ss_customer_sk",)}
SERVE_TOL = {"paid": (1e-4, 1e-2), "spend": (1e-4, 1e-2)}


def serve_want(ss, it, n_items: int, n_cust: int) -> dict:
    """The serve mix's rows from numpy bincounts (float sums in float64,
    then float32), keyed by query; the leaderboard's ranks are checked
    against its own spends (``check_serve``)."""
    cust, item = ss["ss_customer_sk"], ss["ss_item_sk"]
    paid = ss["ss_net_paid"].astype(np.float64)
    cls = it["i_class_id"][item]
    n_c = np.bincount(cust, minlength=n_cust)
    k = np.flatnonzero(n_c > 4)
    q26w = {"ss_customer_sk": k.astype(np.int32),
            "c_i_count": n_c[k].astype(np.int32)}
    for c in (1, 2):
        q26w[f"id{c}"] = np.bincount(cust, weights=(cls == c),
                                     minlength=n_cust)[k].astype(np.int32)
    n_i = np.bincount(item, minlength=n_items)
    ki = np.flatnonzero(n_i)
    kc = np.flatnonzero(n_c)
    return {"q26": q26w,
            "per_item": {"ss_item_sk": ki.astype(np.int32),
                         "paid": np.bincount(item, weights=paid,
                                             minlength=n_items)[ki]
                         .astype(np.float32),
                         "n": n_i[ki].astype(np.int32)},
            "leaderboard": {"ss_customer_sk": kc.astype(np.int32),
                            "spend": np.bincount(cust, weights=paid,
                                                 minlength=n_cust)[kc]
                            .astype(np.float32)}}


def check_serve(tag: str, name: str, out: dict, want: dict) -> None:
    """One result of the mix against ``serve_want``: ints exact, float sums
    within SERVE_TOL; the leaderboard's ranks exact against the descending
    min-rank of the spends it returned."""
    from scipy.stats import rankdata
    got = sorted_rows(out, SERVE_KEYS[name])
    if name == "leaderboard":
        r = got.pop("r")
        assert np.array_equal(r, rankdata(-got["spend"].astype(np.float64),
                                          method="min")), f"{tag}.r"
    check_equal(got, want[name], tag, SERVE_TOL)


def synced_wall(torch, fn):
    """(fn(), seconds) on the host clock, the card synchronised around."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pass_record(res: dict, wall: float, launched: dict) -> dict:
    """A pass's totals and each query's median plan and exec seconds."""
    recs = res["records"]
    med = {name: {f: round(float(np.median([getattr(r, f) for r in
                                             recs[i::len(SERVE_NAMES)]])), 5)
                  for f in ("plan_s", "exec_s")}
           for i, name in enumerate(SERVE_NAMES)}
    return {"wall_s": round(wall, 4), "queries": res["queries"],
            "hits": res["hits"], "lowered_built": res["built"],
            "collectives": res["collectives"],
            "cache": [r.cache for r in recs], "median_s": med,
            "launches": launched}


def serve_path(torch, hf, synth, queries: dict, checks: dict):
    """The serving layer through ``repro_torch.launch.serve`` at P = 1 on
    the card: registration (timed, its collectives counted), the mix's two
    passes through ``submit`` (the smoke contract, rows against numpy,
    pass 2 bitwise pass 1's, the same launches), a second store_sales that
    the same plans serve by rebinding, the mix as one-shot collect()s over
    host tables, a 4-shard state merged to P = 1 on the card with no host
    gather, and the memory a re-registered table leaves held."""
    import gc
    import tempfile
    import types

    from repro_torch.core import ir
    from repro_torch.kernels import cuda
    from repro_torch.launch import serve
    from repro_torch.runtime.reshard import _index_map, reshard
    from repro_torch.runtime.session import Session

    n_sales, n_items, n_cust = serve.sizes(SERVE_SCALE)
    tables = serve.make_tables(SERVE_SCALE, seed=0)
    ss, it = tables
    ss_b = serve.make_tables(SERVE_SCALE, seed=7)[0]
    want = serve_want(ss, it, n_items, n_cust)
    cfg = hf.ExecConfig()
    watched = ("prefix_sum", "segment_sums")
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as sdir, \
            Session(cfg, session_dir=sdir) as sess:
        _, wall = synced_wall(torch, lambda: serve.register_tables(
            sess, SERVE_SCALE, tables=tables))
        reg = sess.stats()["register_collectives"]
        queries["serve_register"] = {
            "wall_s": round(wall, 4), "collectives": reg,
            "rows_in": n_sales + n_items,
            "capacity": int(sess.table("store_sales").node.layout.capacity)}
        log(f"serve_register: {queries['serve_register']}")
        mix = serve.build_mix(sess)
        runs = {}
        for p in (1, 2):
            before = {k: cuda.launches[k] for k in watched}
            res, wall = synced_wall(torch, lambda: serve.run_pass(
                sess, mix, SERVE_REPEATS))
            launched = {k: cuda.launches[k] - before[k] for k in watched}
            runs[p] = res
            queries[f"serve_pass{p}"] = pass_record(res, wall, launched)
            log(f"serve_pass{p}: {queries[f'serve_pass{p}']}")
        p1, p2 = runs[1], runs[2]
        fails = serve.smoke_failures(p1, p2, p1["collectives"] + reg)
        assert not fails, fails
        l1, l2 = (queries[f"serve_pass{p}"]["launches"] for p in (1, 2))
        assert l1 == l2 and all(l1[k] > 0 for k in watched), (l1, l2)
        for i, (t1, t2) in enumerate(zip(p1["tables"], p2["tables"])):
            name = SERVE_NAMES[i % len(SERVE_NAMES)]
            o1, o2 = t1.to_numpy(), t2.to_numpy()
            check_serve(f"serve_{name}", name, o1, want)
            assert all(o1[c].tobytes() == o2[c].tobytes() for c in o1), \
                f"serve_{name}: pass 2 differs from pass 1"
        checks["serve_pass2_bitwise"] = True

        # the same plans over another table of the same shape: a rebind
        serve.register_tables(sess, SERVE_SCALE, name="store_sales_b",
                              tables=(ss_b, None))
        res, wall = synced_wall(torch, lambda: serve.run_pass(
            sess, serve.build_mix(sess, sales="store_sales_b"), 1))
        assert res["hits"] == res["queries"] and res["built"] == 0, res
        want_b = serve_want(ss_b, it, n_items, n_cust)
        for name, t in zip(SERVE_NAMES, res["tables"]):
            check_serve(f"serve_rebind_{name}", name, t.to_numpy(), want_b)
        queries["serve_rebind"] = pass_record(res, wall, {})
        log(f"serve_rebind: {queries['serve_rebind']}")

        # does a cached plan keep a replaced table's shards alive?
        del mix, p1, p2, runs, res, t1, t2
        gc.collect()
        held = torch.cuda.memory_allocated()
        serve.register_tables(sess, SERVE_SCALE, tables=(ss, None))
        gc.collect()
        queries["serve_memory"] = {
            "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
            "held_gib_before_reregister": round(held / 2**30, 3),
            "held_gib_after_reregister": round(
                torch.cuda.memory_allocated() / 2**30, 3),
            "store_sales_gib": round(16 * n_sales / 2**30, 3)}
        log(f"serve_memory: {queries['serve_memory']}")

    # the mix as one-shot collect()s over host tables, no session
    host = {"store_sales": hf.table(ss, "store_sales"),
            "item": hf.table(it, "item").replicate()}
    for name, build in zip(SERVE_NAMES, serve.build_mix(
            types.SimpleNamespace(table=host.__getitem__))):
        t, wall, peak = timed_collect(torch, build(), cfg)
        assert not t.overflow, name
        check_serve(f"serve_oneshot_{name}", name, t.to_numpy(), want)
        queries[f"serve_oneshot_{name}"] = {
            "wall_s": round(wall, 4), "peak_gib": round(peak, 3),
            "rows_in": n_sales + (n_items if name == "q26" else 0)}
        log(f"serve_oneshot_{name}: {queries[f'serve_oneshot_{name}']}")

    # a 4-shard block state of store_sales merged to P = 1 on the card
    counts = (np.asarray(SERVE_SHARES) * n_sales).astype(np.int64)
    counts[-1] = n_sales - counts[:-1].sum()
    cap = int(counts.max())
    state = {c: np.zeros(len(counts) * cap, v.dtype) for c, v in ss.items()}
    lo = 0
    for r, n in enumerate(counts):
        for c, v in ss.items():
            state[c][r * cap:r * cap + n] = v[lo:lo + n]
        lo += n
    layout = dict(kind="block", partitioned_by=(), ascending=True,
                  globally_sorted=False, sorted_by=(), order_ascending=True,
                  counts=counts, capacity=cap, nshards=len(counts),
                  dist="1D_VAR")
    p4 = hf.from_persisted_state(state, layout, name="ss4")
    del state

    def no_gather(self, src):
        raise AssertionError("reshard gathered on the host")
    gather = ir.ScanLayout.gather_host
    ir.ScanLayout.gather_host = no_gather
    try:
        r1, wall = synced_wall(torch, lambda: reshard(p4, 1, cfg))
    finally:
        ir.ScanLayout.gather_host = gather
    lay = r1.node.layout
    assert lay.counts.tolist() == [n_sales] and lay.device_valid(1), lay
    # the host's share: the index map from the counts, in numpy
    _, map_wall = synced_wall(torch, lambda: _index_map(counts, cap, 1))
    for c, v in ss.items():
        got = r1.node.columns[c][:n_sales].cpu().numpy()
        assert np.array_equal(got, v), f"serve_reshard.{c}"
    queries["serve_reshard"] = {"wall_s": round(wall, 4), "rows_in": n_sales,
                                "index_map_s": round(map_wall, 4),
                                "shards": counts.tolist(), "to": 1,
                                "capacity_in": cap}
    log(f"serve_reshard: {queries['serve_reshard']}")
    del p4, r1
    torch.cuda.empty_cache()


# The exchange path: two ranks on the one card, joined by gloo (NCCL refuses
# two ranks on one card; gloo stages CUDA tensors through the host, so the
# walls are gloo's, not NCCL's).  Fig. 8a join at a quarter of the
# relational path's rows, cut for that staging, and Q26 at its scale.
# cut from 2^24 x 2^20 (and the sort's 2^24 rows, the Q26 and frame tables'
# scale 64, the serving session's 2^24 sales rows) to pay for the dp_train
# path within the time limit, and each by half again for the tp_train path
P2_JOIN = (2**22, 2**18)
P2_WORLD = 2
P2_SCALE = 16


P2_SORT = 2**22
# the skew join at P = 2: an eighth of the guardrails path's rows each side,
# cut for gloo's host staging, as P2_JOIN is (2^22 x 2^20 before tp_train)
P2_SKEW_JOIN = (2**21, 2**19)


def exchange_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of the exchange path (started by torch.multiprocessing):
    the queries through ``hf`` on the card at P = world, each with the
    all_to_all calls counted against the plan's census; rank 0 holds the
    rows against the numpy oracles.  Writes its walls, counts and launches
    to out_dir."""
    import torch
    import torch.distributed as dist
    from scipy.stats import rankdata

    from repro_torch import hiframes as hf
    from repro_torch.core import ir
    from repro_torch.data import synth
    from repro_torch.kernels import cuda

    from repro_torch.launch.mesh import PG_TIMEOUT

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=PG_TIMEOUT)
    calls = [0]
    a2a = dist.all_to_all_single

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)
    dist.all_to_all_single = counted
    cfg = hf.ExecConfig()          # the card
    left, right = join_tables(*P2_JOIN)
    ss, it, n_cust = q26_tables(synth, P2_SCALE)
    t8a = synth.relational_tables(P2_SORT, 1000, seed=0)
    x = synth.series(P2_SORT, seed=3)
    wcs, itx, _ = frame_tables(synth, P2_SCALE)
    cdim = category_dim()
    z = seg_queries()
    grp, _ = z["group_table"](P2_SORT)

    def as_rows(key, want):
        def check(tag, out, t):
            check_equal(sorted_rows(out, key), sorted_rows(want(), key), tag)
        return check

    def check_sort(tag, out, t):
        # the rank-concatenated rows are the input's in stable order, and
        # each rank took at least a quarter of them: the splitters split
        order = stable_order(t8a["x"])
        check_equal(out, {k: v[order] for k, v in t8a.items()}, tag)
        assert int(t.counts.min()) >= P2_SORT // 4, \
            f"{tag}: {t.counts.tolist()}"

    def check_rank(tag, out, t):
        xs = np.sort(x)
        assert np.array_equal(out["x"], xs), f"{tag}.x"
        assert np.array_equal(out["r"], rankdata(xs.astype(np.float64),
                                                 method="min")), tag

    def check_groups(name):
        def check(tag, out, t):
            res["queries"][tag]["max_abs_diff"] = z["assert_seg_result"](
                name, out, {"grp": grp, "ext": None}, atol=5e-2)
        return check

    def check_sma(tag, out, t):
        xf = x[x > np.float32(0)]
        assert np.array_equal(out["x"], xf), f"{tag}.x"
        check_close(tag, out["s"], stencil_f32(xf, [1.0 / 3] * 3, 1),
                    1e-6, 1e-6)

    q26_rows = len(ss["ss_item_sk"]) + len(it["i_item_sk"])
    runs = {"p2_fig8a_join": (
                lambda: hf.join(hf.table(left, "l"), hf.table(right, "r"),
                                on=("id", "cid")),
                as_rows(("id", "x"), lambda: join_want(left, right)),
                sum(P2_JOIN)),
            "p2_fig11_q26": (lambda: q26(hf, ss, it),
                             as_rows(("ss_customer_sk",),
                                     lambda: q26_want(ss, it, n_cust)),
                             q26_rows),
            "p2_sort": (lambda: hf.table(t8a).sort_values("x"), check_sort,
                        P2_SORT),
            "p2_global_rank": (lambda: global_rank_frame(hf, x, ("rank",)),
                               check_rank, P2_SORT),
            "p2_sma_after_filter": (lambda: sma_after_filter_frame(hf, x),
                                    check_sma, P2_SORT),
            "p2_fig12_q26_cold": (
                lambda: q26_fluent(hf.table(ss, "ss"), hf.table(it, "it")),
                as_rows(("ss_customer_sk",), lambda: q26_want(ss, it, n_cust)),
                q26_rows),
            "p2_fig12_q26_persisted": (
                lambda: q26_fluent(hf.table(ss, "ss"),
                                   persisted_dim(hf, it, cfg)),
                as_rows(("ss_customer_sk",), lambda: q26_want(ss, it, n_cust)),
                q26_rows),
            # each rank encodes the whole host table itself
            "p2_q05_string": (
                lambda: q05_frame(hf.table(wcs, "wcs"), hf.table(itx, "itx"),
                                  "books", ["electronics", "music"]),
                as_rows(("wcs_user_sk",), lambda: q05_want(wcs, itx, synth)),
                len(wcs["wcs_user_sk"]) + len(itx["i_item_sk"])),
            "p2_merge_category_keys": (
                lambda: merge_category_frame(hf.table(itx, "itx"),
                                             hf.table(cdim, "cdim")),
                as_rows(("i_category_name",),
                        lambda: merge_category_want(itx, cdim, synth)),
                len(itx["i_item_sk"]) + len(FRAME_DIM_NAMES)),
            # the group-by sugar on tests/test_skew.py's shape, hot group
            # included
            "p2_transform_sum": (
                lambda: z["transform_sum"](hf, {"grp": grp}),
                check_groups("transform_sum"), P2_SORT),
            "p2_head2": (lambda: z["head2"](hf, {"grp": grp}),
                         check_groups("head2"), P2_SORT)}
    res = {"rank": rank, "queries": {}}
    torch.cuda.synchronize()
    cuda.reset_launches()
    for tag, (build, check, rows_in) in runs.items():
        frame = build()
        calls[0] = 0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = frame.collect(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert not t.overflow, f"{tag}: capacity overflow {t.overflow_ops}"
        out = t.to_numpy()
        census = frame.physical_plan(cfg).shuffle_census(P=world)["all_to_all"]
        assert calls[0] == census, f"{tag}: {calls[0]} all_to_all, census {census}"
        res["queries"][tag] = {}
        if rank == 0:
            check(tag, out, t)
        # every dictionary of the plan, inputs and recodings included
        dicts = sorted({dt.categories for n in ir.topo_order(frame.node)
                        for dt in n.schema.values()
                        if getattr(dt, "categories", None) is not None})
        res["queries"][tag].update({
            "dictionaries": hashlib.sha256(repr(dicts).encode()).hexdigest()[:16],
            "wall_s": round(wall, 4), "rows_in": rows_in,
            "rows_out": int(len(next(iter(out.values())))),
            "rows_by_rank": t.counts.cpu().tolist(),
            "all_to_all": calls[0], "census": census, "nshards": t.nshards})
    res["queries"]["p2_seg_matrix"] = p2_seg_matrix(
        torch, dist, hf, cuda, z, (ss, it, n_cust), cfg, calls)
    res["queries"].update(p2_guardrails(torch, dist, hf, synth, calls))
    res["queries"].update(p2_serve(torch, dist, hf, calls))
    q = res["queries"]
    assert q["p2_fig12_q26_persisted"]["all_to_all"] \
        < q["p2_fig12_q26_cold"]["all_to_all"], q
    torch.cuda.synchronize()
    res["launches"] = dict(cuda.launches)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def p2_seg_matrix(torch, dist, hf, cuda, z, q26: tuple, cfg,
                  calls: list) -> dict:
    """The segmentation program's matrix at P = world: Q26 through the UDF
    filter, then collect_matrix.  Each rank's count is its 1D_BLOCK block
    (ceil(n / P), the rest last), bucket_scatter moved the rows, the
    all_to_all calls are the plan's census, and rank 0 holds the ranks'
    rows together against the oracle's."""
    ss, it, n_cust = q26
    rank, world = dist.get_rank(), dist.get_world_size()
    frame = z["q26_features"](hf, {"ss": ss, "it": it})
    cols = list(z["FEATURES"])
    census = frame.lower(cfg, cols, collect_block=True).pplan \
        .shuffle_census(P=world)["all_to_all"]
    before = dict(cuda.launches)
    calls[0] = 0
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mat, counts, cap = frame.collect_matrix(cols, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scatters = cuda.launches["bucket_scatter"] \
        - before.get("bucket_scatter", 0)
    assert scatters > 0, f"p2_seg_matrix: no bucket_scatter in rank {rank}"
    assert calls[0] == census, \
        f"p2_seg_matrix: {calls[0]} all_to_all, census {census}"
    counts = counts.tolist()
    n = sum(counts)
    block = -(-n // world)
    assert counts == [min(block, max(n - r * block, 0))
                      for r in range(world)], f"p2_seg_matrix: counts {counts}"
    assert tuple(mat.shape) == (cap, len(cols)) and mat.is_cuda
    parts = [None] * world
    dist.all_gather_object(parts, mat[:counts[rank]].cpu().numpy())
    if rank == 0:
        want = q26_want(ss, it, n_cust)
        got = np.concatenate(parts)
        exp = np.stack([want[c] for c in cols], 1).astype(np.float32)
        assert np.array_equal(got[np.lexsort(got.T[::-1])],
                              exp[np.lexsort(exp.T[::-1])]), \
            "p2_seg_matrix rows"
    return {"wall_s": round(wall, 4), "rows_out": n, "rows_by_rank": counts,
            "capacity": int(cap), "all_to_all": calls[0], "census": census,
            "bucket_scatter": scatters, "nshards": world,
            "rows_in": len(ss["ss_item_sk"]) + len(it["i_item_sk"])}


def p2_guardrails(torch, dist, hf, synth, calls: list) -> dict:
    """The guardrails at P = world: the skew join salted and unsalted
    (rows exact, per-rank counts, the salted max/mean lower, as many
    all_to_all as unsalted), and Fig. 8a's aggregate (at P2_SORT rows) under
    a forced overflow and a packed-exchange corruption, each healed with
    the oracle's rows and the all_to_all calls of every run of the retry
    loop."""
    from repro_torch.runtime import FaultPlan
    rank, world = dist.get_rank(), dist.get_world_size()
    probe, dim = skew_tables(*P2_SKEW_JOIN)
    t8 = synth.relational_tables(P2_SORT, 4096, seed=2)
    skew = skew_join_frame(hf, probe, dim)
    agg = agg8a_frame(hf, hf.table(t8))

    def census(frame, **kw):
        return frame.physical_plan(hf.ExecConfig(**kw)).shuffle_census(
            P=world)["all_to_all"]
    runs = {"p2_skew_join_salted": (skew, dict(adaptive_stats=True), None,
                                    census(skew, adaptive_stats=True)),
            "p2_skew_join": (skew, {}, None, census(skew)),
            "p2_forced_overflow": (agg, {}, {"force_overflow":
                                             ("HashExchange",)},
                                   2 * census(agg)),
            "p2_corrupt_heal": (agg, dict(validate=True),
                                {"corrupt_exchange": ("HashExchange",)},
                                census(agg) + census(agg,
                                                     packed_exchange=False))}
    out = {}
    for tag, (frame, kw, fault, a2a) in runs.items():
        cfg = hf.ExecConfig(**kw, **({"fault_inject": FaultPlan(**fault)}
                                     if fault else {}))
        calls[0] = 0
        dist.barrier()
        t, wall, _peak = timed_collect(torch, frame, cfg)
        assert not t.overflow and t.invariant_failures == (), (tag, t)
        assert calls[0] == a2a, f"{tag}: {calls[0]} all_to_all, expected {a2a}"
        rows = t.to_numpy()
        counts = t.counts.tolist()
        if rank == 0:
            if frame is skew:
                check_skew_join(rows, probe, dim, tag)
            else:
                check_equal(sorted_rows(rows, ("id",)), agg8a_want(t8), tag,
                            AGG8A_TOL)
        out[tag] = {"wall_s": round(wall, 4), "rows_by_rank": counts,
                    "rows_out": sum(counts),
                    "occupancy_max_mean": round(occupancy(counts), 4),
                    "all_to_all": calls[0], "nshards": world,
                    "events": [e.render() for e in t.events],
                    "event_kinds": [e.kind for e in t.events],
                    "rows_in": (sum(P2_SKEW_JOIN) if frame is skew
                                else P2_SORT)}
    kinds = {tag: q["event_kinds"] for tag, q in out.items()}
    assert kinds == {"p2_skew_join_salted": [], "p2_skew_join": [],
                     "p2_forced_overflow": ["retry"],
                     "p2_corrupt_heal": ["degrade_packed"]}, kinds
    salted, plain = out["p2_skew_join_salted"], out["p2_skew_join"]
    assert salted["occupancy_max_mean"] < plain["occupancy_max_mean"], \
        (salted, plain)
    assert salted["all_to_all"] == plain["all_to_all"], (salted, plain)
    return out


# the serving session at P = 2: launch/serve.py's tables at 2^23 sales rows
P2_SERVE_SCALE = 2**22 / 200_000      # 2^23 sales rows before tp_train


def p2_serve(torch, dist, hf, calls: list) -> dict:
    """The serving session at P = world: store_sales (2^23 rows) and item
    registered, the mix submitted six times at once (admission 4, workers
    4; rows against numpy on rank 0, at least one hit, the same cache
    outcomes on every rank, the all_to_all calls the records' count), then
    a 1-shard state of store_sales registered into the 2-rank session (a
    split 1 -> 2 whose hash claim one exchange re-establishes: 2
    all_to_all) and grouped on its key (0 exchanges planned, 0 all_to_all)."""
    from repro_torch.launch import serve
    from repro_torch.runtime.session import Session
    rank, world = dist.get_rank(), dist.get_world_size()
    n_sales, n_items, n_cust = serve.sizes(P2_SERVE_SCALE)
    tables = serve.make_tables(P2_SERVE_SCALE, seed=0)
    ss, it = tables
    want = serve_want(ss, it, n_items, n_cust) if rank == 0 else None
    out = {}

    def timed(tag, fn):
        calls[0] = 0
        dist.barrier()
        res, wall = synced_wall(torch, fn)
        out[tag] = {"wall_s": round(wall, 4), "all_to_all": calls[0],
                    "nshards": world}
        return res

    with Session(hf.ExecConfig(), admission=4, workers=4) as sess:
        timed("p2_serve_register", lambda: serve.register_tables(
            sess, P2_SERVE_SCALE, tables=tables))
        out["p2_serve_register"]["rows_in"] = n_sales + n_items
        mix = serve.build_mix(sess)
        tabs = timed("p2_serve_submit6", lambda: [
            f.result() for f in [sess.submit(q()) for _ in range(2)
                                 for q in mix]])
        recs = [t.query_record for t in tabs]
        cache = [r.cache for r in recs]
        views = [None] * world
        dist.all_gather_object(views, cache)
        assert all(v == cache for v in views), views
        assert "hit" in cache, cache
        rec = out["p2_serve_submit6"]
        assert rec["all_to_all"] == sum(r.collectives for r in recs), \
            (rec, [r.collectives for r in recs])
        rec.update(cache=cache, rows_in=6 * n_sales,
                   rows_by_rank=[t.counts.tolist() for t in tabs])
        if rank == 0:
            for i, t in enumerate(tabs):
                name = SERVE_NAMES[i % len(SERVE_NAMES)]
                check_serve(f"p2_serve_{name}", name, t.to_numpy(), want)
        layout = dict(kind="hash", partitioned_by=("ss_item_sk",),
                      ascending=True, globally_sorted=False, sorted_by=(),
                      order_ascending=True, counts=[n_sales],
                      capacity=n_sales, nshards=1, dist="1D_VAR")
        one = hf.from_persisted_state(ss, layout, name="ss1")
        timed("p2_serve_split", lambda: sess.register("ss_split", one))
        lay = sess.table("ss_split").node.layout
        assert (lay.kind, lay.nshards) == ("hash", world), lay
        assert out["p2_serve_split"]["all_to_all"] == 2, out
        out["p2_serve_split"].update(rows_in=n_sales,
                                     rows_by_rank=lay.counts.tolist())
        g = sess.table("ss_split").groupby("ss_item_sk").agg(
            paid=("ss_net_paid", "sum"), n=("ss_net_paid", "count"))
        exchanges = g.lower(sess.cfg).pplan.counts()["hash_exchanges"]
        assert exchanges == 0, exchanges
        t = timed("p2_serve_split_groupby", lambda: sess.collect(g))
        assert out["p2_serve_split_groupby"]["all_to_all"] == 0, out
        out["p2_serve_split_groupby"].update(
            rows_in=n_sales, exchanges=exchanges,
            cache=t.query_record.cache)
        if rank == 0:
            check_serve("p2_serve_split_groupby", "per_item", t.to_numpy(),
                        want)
    for tag, q in out.items():
        log(f"{tag} (rank {rank}): {q}")
    return out


def exchange_path(torch, queries: dict) -> dict:
    """The exchange path: P2_WORLD processes on the one card, each running
    ``exchange_rank``; bucket_scatter must have launched in every rank.
    Returns the launch counts summed over the ranks."""
    import socket
    import tempfile

    import torch.multiprocessing as mp
    torch.cuda.empty_cache()       # leave the card's memory to the ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(exchange_rank, args=(P2_WORLD, port, out_dir),
                 nprocs=P2_WORLD, join=True)
        ranks = []
        for r in range(P2_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        assert r["launches"]["bucket_scatter"] > 0, \
            f"bucket_scatter never launched in rank {r['rank']}"
    for tag in ranks[0]["queries"]:
        per = [r["queries"][tag] for r in ranks]
        # the same codes on every rank, so recoded keys hash alike
        assert len({q.get("dictionaries") for q in per}) == 1, (tag, per)
        queries[tag] = {**per[0], "wall_s_by_rank": [q["wall_s"] for q in per],
                        "wall_s": max(q["wall_s"] for q in per),
                        "transport": f"gloo over tcp://localhost, {P2_WORLD} "
                                     f"ranks on one card (host staging)"}
        log(f"{tag}: {queries[tag]}")
    queries["exchange_p2_launches_by_rank"] = [r["launches"] for r in ranks]
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


# The dp_train path: launch/train.py's ``run`` data-parallel
# over DP_WORLD ranks on the one card, joined by gloo (launch/mesh.py's
# choice where ranks share a card; NCCL refuses two ranks on one card, and
# gloo stages CUDA tensors through the host): qwen3-0.6b at full width and
# DP_LAYERS layers (as the train path), bf16, remat per block, ZeRO-1 AdamW,
# DP_STEPS steps of a global batch of DP_BATCH x DP_SEQ tokens (DP_BATCH /
# DP_WORLD rows a rank) from the token pipeline at P = DP_WORLD over a
# DP_DOCS-document corpus; the one checkpoint at the end.  Before it, at
# full width and 2 layers in float32 (TF32 off) on a global batch of
# DP_HOLD tokens: (a) the data-parallel step against one rank's step on the
# whole batch, (b) ZeRO-1's moments against a replicated-moment step's,
# (c) tree_compressed_psum of the step's gradients against their plain
# mean.  After it: (d) the checkpoint restored at P = 1 (bitwise) and at
# P = 2 (bitwise, and the first step's loss from it equal to the live
# state's), (e) that step's collectives against the ZeRO-1 layout.
DP_WORLD = 2
# the train path's 14 layers: with tied embeddings and random weights a
# shallower stack keeps each position's residual near its own token's
# embedding, and the first loss far above ln V (19.55 at 4 layers)
DP_LAYERS = 14
DP_BATCH, DP_SEQ = 8, 2048
DP_STEPS = 3                             # 4 before the tp_train path came
DP_DOCS = 2**16
DP_HOLD = (8, 512)


def dp_probe(torch, mesh, dev) -> dict:
    """The four collectives the data-parallel step relies on, on tensors of
    the card, before the path relies on them: reduce-scatter, all-gather,
    broadcast and all-reduce MAX over the data group."""
    g, P, r = mesh.dp, mesh.dp.size, mesh.dp.index
    full = torch.arange(4 * P, dtype=torch.float32, device=dev) + r
    want = sum(torch.arange(4 * P, dtype=torch.float32) + i for i in range(P))
    assert torch.equal(g.reduce_scatter(full).cpu(), want[4 * r:4 * r + 4])
    whole = g.all_gather(torch.full((4,), float(r), device=dev))
    assert torch.equal(whole.cpu(), torch.arange(P).repeat_interleave(4).float())
    b = g.broadcast(torch.full((3,), float(r + 7), device=dev))
    assert bool((b == 7).all())
    m = g.all_reduce(torch.tensor([float(r)], device=dev), "max")
    assert float(m) == P - 1
    mesh.reset_counts()
    return {"reduce_scatter": True, "all_gather": True, "broadcast": True,
            "all_reduce_max": True, "device": str(full.device)}


def opt_bytes(state: dict) -> int:
    from repro_torch.models import lm
    return sum(t.numel() * t.element_size() for k in ("m", "v", "master")
               if k in state for _, t in lm.leaves(state[k]))


def dp_hold(torch, mesh, dev) -> dict:
    """(a)-(c) at full width and 2 layers in float32 (``hold_cfg``), rank 0's
    weights on both ranks, one global batch of DP_HOLD tokens."""
    import hashlib

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm, sharding
    from repro_torch.optim import OptConfig, adamw, compression

    cfg = hold_cfg(get_config(LM_ARCH))
    model = lm.init_params(cfg, seed=3, device=dev)
    for _, t in lm.leaves(model.tree()):
        mesh.world.broadcast(t.data)
    weights = model.tree()
    b, s = DP_HOLD
    batch = token_batches(torch, cfg.vocab, b, s, 1, 17, dev)[0]
    local = {k: sharding.shard(v, sharding.batch_spec(mesh, k, tuple(v.shape)), mesh)
             for k, v in batch.items()}
    dp = mesh.dp
    out = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "batch": b, "seq": s, "rows_per_rank": int(local["tokens"].shape[0])}

    # (a) this rank's share of the loss and its gradient, summed over the
    # ranks, against rank 0's step on the whole batch
    share, g = steps.value_and_grad(steps.make_loss_fn(cfg, group=dp), weights, local)
    g_sum = lm.tree_map(lambda x: dp.all_reduce(x.clone()), g)
    loss_dp = float(dp.all_reduce(share.clone()))
    if mesh.rank == 0:
        loss_one, g_one = steps.value_and_grad(steps.make_loss_fn(cfg), weights, batch)
        rel = {"/".join(k): float((x - y).abs().max() / y.abs().max())
               for (k, x), (_, y) in zip(lm.leaves(g_sum), lm.leaves(g_one))}
        out |= {"loss_one_rank": float(loss_one), "loss_dp": loss_dp,
                "loss_rel": abs(loss_dp / float(loss_one) - 1),
                "grad_max_rel": max(rel.values()), "grad_rel": rel}
        # float32 on both sides, TF32 off: only the order of sums differs
        assert out["loss_rel"] <= 1e-4 and out["grad_max_rel"] <= 1e-4, out
        del g_one

    # (c) the compressed sum of these gradients against their plain mean
    mean_c, new_err = compression.tree_compressed_psum(
        g, compression.init_error_buffers(g), dp)
    worst, digest = 0.0, hashlib.sha256()
    for (k, x), (_, e), (_, gs), (_, gl) in zip(lm.leaves(mean_c), lm.leaves(new_err),
                                              lm.leaves(g_sum), lm.leaves(g)):
        scale = torch.clamp(dp.all_reduce(gl.abs().max(), "max") / 127.0, min=1e-12)
        step_err = float((x - gs / dp.size).abs().max() / scale)
        # half a quantisation step, plus float32 rounding of the two sums
        assert step_err <= 0.5 * (1 + 1e-4), ("/".join(k), step_err)
        q = torch.clamp(torch.round(gl / scale), -127, 127)
        assert torch.equal(e, gl - q * scale), "/".join(k)
        worst = max(worst, step_err)
        digest.update(x.cpu().numpy().tobytes())
    out |= {"compressed_max_err_steps": worst,
            "compressed_digest": digest.hexdigest()[:16]}
    del mean_c, new_err, g, g_sum

    # (b) one step with ZeRO-1 moments and one with replicated moments
    runs = {}
    for zero1 in (True, False):
        ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE,
                         zero1=zero1)
        params = lm.tree_map(lambda t: t.detach().clone(), weights)
        state = {"params": params, "opt": adamw.init_state(params, ocfg, mesh=mesh)}
        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        mesh.reset_counts()
        state, loss = step(state, batch)
        runs[zero1] = {"state": state, "loss": float(loss), "ocfg": ocfg,
                       "counts": {k: dict(v) for k, v in mesh.counts.items()},
                       "opt_bytes": opt_bytes(state["opt"])}
    z, r = runs[True], runs[False]
    opt_sh = adamw.state_shardings(mesh, sharding.param_shardings(cfg, mesh, weights),
                                   weights, z["ocfg"])
    whole = sharding.gather_tree(z["state"]["opt"], opt_sh, mesh)
    moment_rel, sharded = 0.0, 0
    for name in ("m", "v"):
        for (k, blk), (_, w), (_, rep), (_, p) in zip(
                lm.leaves(z["state"]["opt"][name]), lm.leaves(whole[name]),
                lm.leaves(r["state"]["opt"][name]), lm.leaves(weights)):
            sp = sharding.spec_at(opt_sh[name], k)
            assert tuple(blk.shape) == sharding.local_shape(tuple(p.shape), sp, mesh)
            assert torch.equal(blk, sharding.shard(w, sp, mesh)), k
            sharded += int(tuple(blk.shape) != tuple(p.shape))
            moment_rel = max(moment_rel, float((w - rep).abs().max()
                                               / rep.abs().max().clamp(min=1e-30)))
    param_diff = max(float((x.float() - y.float()).abs().max()) for (_, x), (_, y)
                     in zip(lm.leaves(z["state"]["params"]),
                            lm.leaves(r["state"]["params"])))
    # one arithmetic on the same summed gradients; only the clipping norm's
    # order of sums differs (blocks, then one all-reduce)
    assert moment_rel <= 1e-6, moment_rel
    out |= {"loss_zero1": z["loss"], "loss_replicated": r["loss"],
            "moment_max_rel_zero1_vs_replicated": moment_rel,
            "param_max_abs_zero1_vs_replicated": param_diff,
            "sharded_moment_leaves": sharded,
            "opt_bytes_zero1": z["opt_bytes"], "opt_bytes_replicated": r["opt_bytes"],
            "counts_zero1": z["counts"], "counts_replicated": r["counts"]}
    if mesh.rank == 0:
        out["step_loss_rel_vs_one_rank"] = abs(z["loss"] / out["loss_one_rank"] - 1)
        assert out["step_loss_rel_vs_one_rank"] <= 1e-4, out
    return out


def dp_expected_counts(state: dict, opt_sh: dict, n_micro: int) -> dict:
    """The collectives of one data-parallel step the ZeRO-1 layout implies:
    a reduce-scatter (float32 gradient) and an all-gather (parameter) per
    sharded leaf; an all-reduce per whole leaf and one for the norm; one
    for the global loss and one a micro-batch for the label count."""
    from repro_torch.models import lm, sharding
    from repro_torch.optim import adamw

    sharded, whole = [], []
    for path, p in lm.leaves(state["params"]):
        sp = sharding.spec_at(opt_sh["m"], path)
        (sharded if adamw.dp_dim(sp) is not None else whole).append(p)
    out = {"all_reduce_sum": {
        "calls": len(whole) + bool(sharded) + 1 + n_micro,
        "bytes": 4 * (sum(p.numel() for p in whole) + bool(sharded) + 1 + n_micro)}}
    if sharded:
        out["reduce_scatter"] = {"calls": len(sharded),
                                 "bytes": 4 * sum(p.numel() for p in sharded)}
        out["all_gather"] = {"calls": len(sharded),
                             "bytes": sum(p.numel() * p.element_size() for p in sharded)}
    return out


def dp_rank(rank: int, world: int, port: int, out_dir: str, ckpt_dir: str) -> None:
    """One rank of the dp_train path (started by torch.multiprocessing):
    the collectives probed, the float32 holds, then the bf16 run through
    ``train.run`` on the data mesh, the restores and the counted step.
    Writes its records and launches to out_dir."""
    import math

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.data import synth
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps, train
    from repro_torch.models import lm, sharding
    from repro_torch.optim import OptConfig, adamw
    from repro_torch.runtime import FTConfig, TrainDriver

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = M.backend_for(world, dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=M.PG_TIMEOUT)
    mesh = M.make_local_mesh(model_axis=1)
    res = {"rank": rank, "backend": backend, "mesh": dict(mesh.shape),
           "probe": dp_probe(torch, mesh, dev)}
    t0 = time.perf_counter()
    res["hold_f32_2l"] = dp_hold(torch, mesh, dev)
    res["hold_s"] = round(time.perf_counter() - t0, 3)
    torch.cuda.empty_cache()

    cfg = get_config(LM_ARCH).replace(n_layers=DP_LAYERS)
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    corpus = synth.token_corpus(DP_DOCS, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    mesh.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    # ckpt_every past the last step: the driver's one save at the end
    run = train.run(cfg, ocfg, corpus, steps=DP_STEPS, batch=DP_BATCH, seq=DP_SEQ,
                    ckpt_dir=ckpt_dir, ckpt_every=DP_STEPS + 1, device=dev,
                    log_every=1, mesh=mesh)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    res["launches"] = dict(cuda.launches)
    run_counts = {k: dict(v) for k, v in mesh.counts.items()}
    peak = torch.cuda.max_memory_allocated()
    drv = run["driver"]
    losses = run["losses"]
    assert len(losses) == DP_STEPS and all(map(math.isfinite, losses)), losses
    ln_v = math.log(cfg.vocab)
    assert abs(losses[0] - ln_v) <= 0.5, (losses[0], ln_v)
    state, opt_sh = drv.state, run["cell"]["opt_sh"]
    rec = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "remat": cfg.remat, "world": world, "backend": backend,
           "global_batch": DP_BATCH, "rows_per_rank": DP_BATCH // world,
           "seq": DP_SEQ, "steps": run["steps"], "docs": DP_DOCS,
           "pipeline_s": round(run["pipeline_s"], 3), "run_s": round(run_s, 3),
           "losses": losses,
           "step_ms": [round(x * 1e3, 3) for x in drv.stats.times],
           "step_median_ms": round(float(np.median(drv.stats.times)) * 1e3, 3),
           "peak_gib": round(peak / 2**30, 3),
           "opt_bytes_zero1": opt_bytes(state["opt"]),
           "opt_bytes_replicated": sum(2 * p.numel() * 4 for _, p
                                       in lm.leaves(state["params"])),
           "run_collectives": run_counts,
           "saves": [{k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in r.items()} for r in drv.saver.records]}

    # (d) P = 1: the whole checkpoint against the live state gathered
    t0 = time.perf_counter()
    whole = sharding.gather_tree(state, {"opt": opt_sh}, mesh)
    if rank == 0:
        tree, step, meta = restore(ckpt_dir, whole, device=dev)
        assert step == DP_STEPS and meta == {"arch": cfg.name}, (step, meta)
        differ = differing_bits(torch, tree, whole)
        assert not differ, f"dp restore at P = 1: entries differ {differ}"
        del tree
    del whole
    rec["restore_p1_s"] = round(time.perf_counter() - t0, 3)
    # P = 2: each rank's blocks into a fresh state, bitwise
    t0 = time.perf_counter()
    fresh_model = lm.init_params(cfg, seed=1, device=dev)
    fresh = {"params": fresh_model.tree(),
             "opt": adamw.init_state(fresh_model.tree(), ocfg, mesh=mesh)}
    again = TrainDriver(FTConfig(ckpt_dir=ckpt_dir), fresh, None, mesh=mesh,
                        shardings={"opt": opt_sh})
    assert again.maybe_resume() and again.step == DP_STEPS, again.step
    differ = differing_bits(torch, fresh, state)
    assert not differ, f"dp restore at P = 2: entries differ {differ}"
    rec["restore_p2_s"] = round(time.perf_counter() - t0, 3)
    # the first step from each state on one batch: the same loss; (e) the
    # live step's collectives against the layout
    step_fn = steps.make_train_step(cfg, ocfg, mesh=mesh)
    batch = token_batches(torch, cfg.vocab, DP_BATCH, DP_SEQ, 1, 23, dev)[0]
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, live_loss = step_fn(state, batch)
    live_loss = float(live_loss)
    rec["counted_step_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    counts = {k: dict(v) for k, v in mesh.counts.items()}
    _, restored_loss = step_fn(fresh, batch)
    restored_loss = float(restored_loss)
    assert live_loss == restored_loss, (live_loss, restored_loss)
    want = dp_expected_counts(state, opt_sh, 1)
    assert counts == want, (counts, want)
    rec |= {"resume_loss_live": live_loss, "resume_loss_restored": restored_loss,
            "step_collectives": counts}
    res["train"] = rec
    # the tp_train and tp_serve paths in the same ranks, the training state
    # freed first
    del run, drv, state, fresh, fresh_model, again, step_fn, batch
    torch.cuda.empty_cache()
    res["tp_train"] = tp_train(torch, rank, dev, os.path.join(ckpt_dir, "tp"))
    log(f"tp_train rank {rank}: {json.dumps(res['tp_train'])}")
    torch.cuda.empty_cache()
    res["tp_serve"] = tp_serve(torch, rank, dev)
    log(f"tp_serve rank {rank}: {json.dumps(res['tp_serve'])}")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dp_train_path(torch, queries: dict, checks: dict, runs: dict) -> dict:
    """The dp_train path: DP_WORLD processes on the one card, each running
    ``dp_rank``; prefix_sum and bucket_scatter (the token pipeline at P =
    DP_WORLD) must have launched in every rank, and the ranks must agree.
    Returns the launch counts of the bf16 run summed over the ranks; the
    ranks' tp_serve records go to ``runs["tp_serve"]``."""
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp
    torch.cuda.empty_cache()       # leave the card's memory to the ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_train_")
    try:
        with tempfile.TemporaryDirectory() as out_dir:
            mp.spawn(dp_rank, args=(DP_WORLD, port, out_dir, ckpt_dir),
                     nprocs=DP_WORLD, join=True)
            ranks = []
            for r in range(DP_WORLD):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for r in ranks:
        for name in ("prefix_sum", "bucket_scatter"):
            assert r["launches"][name] > 0, \
                f"{name} never launched in dp_train rank {r['rank']}"
    r0, r1 = ranks[0], ranks[1]
    for key in ("losses", "resume_loss_live", "step_collectives"):
        assert r0["train"][key] == r1["train"][key], (key, r0["train"][key],
                                                      r1["train"][key])
    h0, h1 = r0["hold_f32_2l"], r1["hold_f32_2l"]
    assert h0["compressed_digest"] == h1["compressed_digest"], (h0, h1)
    assert h0["loss_zero1"] == h1["loss_zero1"]
    rec = {**r0["train"], "hold_f32_2l": h0, "backend": r0["backend"],
           "probe": r0["probe"], "hold_s": r0["hold_s"],
           "step_ms_by_rank": [r["train"]["step_ms"] for r in ranks],
           "peak_gib_by_rank": [r["train"]["peak_gib"] for r in ranks],
           "opt_bytes_zero1_by_rank": [r["train"]["opt_bytes_zero1"] for r in ranks],
           "transport": f"gloo over tcp://localhost, {DP_WORLD} ranks on one "
                        f"card (host staging): walls are gloo's, not NCCL's"}
    checks["dp_train_f32_2l_loss_rel_vs_one_rank"] = h0["loss_rel"]
    checks["dp_train_f32_2l_grad_rel_vs_one_rank"] = h0["grad_max_rel"]
    checks["dp_train_zero1_moment_rel_vs_replicated"] = h0[
        "moment_max_rel_zero1_vs_replicated"]
    checks["dp_train_compressed_max_err_steps"] = h0["compressed_max_err_steps"]
    checks["dp_train_restore_bitwise"] = True
    checks["dp_train_resume_loss_diff"] = abs(r0["train"]["resume_loss_live"]
                                              - r0["train"]["resume_loss_restored"])
    queries["dp_train"] = rec
    log(f"dp_train: {rec}")
    queries["dp_train_launches_by_rank"] = [r["launches"] for r in ranks]
    runs["tp_train"] = [r["tp_train"] for r in ranks]
    runs["tp_serve"] = [r["tp_serve"] for r in ranks]
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


def tp_train_path(torch, queries: dict, checks: dict, runs: dict) -> dict:
    """The tp_train path's records from dp_train's ranks (``tp_train``, run
    there with the counters zeroed just before its bf16 run and read just
    after): both ranks the same losses and step collectives, the holds'
    deviations.  Returns the run's launches summed over the ranks."""
    ranks = runs["tp_train"]
    r0, r1 = ranks
    for key in ("losses", "step_collectives"):
        assert r0["run"][key] == r1["run"][key], (key, r0["run"][key], r1["run"][key])
    for k in ("dense", "ep"):
        h = r0["hold"][k]
        checks[f"tp_train_{k}_f32_2l_loss_rel_vs_one_rank"] = h["loss_rel"]
        checks[f"tp_train_{k}_f32_2l_grad_rel_vs_one_rank"] = h["grad_max_rel"]
        checks[f"tp_train_{k}_f32_2l_param_max_abs_vs_one_rank"] = h["param_max_abs"]
    queries["tp_train"] = {
        "by_rank": ranks,
        "transport": f"gloo over tcp://localhost, {TP_MODEL} ranks on one card "
                     f"(host staging): walls are gloo's, not NCCL's"}
    log(f"tp_train: {json.dumps(queries['tp_train'])}")
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


def tp_serve_path(torch, queries: dict, checks: dict, runs: dict) -> dict:
    """The tp_serve path's records from dp_train's ranks (``tp_serve``, run
    there with the counters zeroed just before its bf16 runs and read just
    after): both ranks fed the same tokens, its checks.  Returns its
    launches summed over the ranks."""
    ranks = runs["tp_serve"]
    for k in ("lm", "moe"):
        assert ranks[0][k]["tokens_digest"] == ranks[1][k]["tokens_digest"], k
        assert ranks[0][k]["step_collectives"] == ranks[1][k]["step_collectives"], k
    for r in ranks:
        for k, v in r["hold"].items():
            if k.endswith("_rel"):
                checks[f"tp_serve_{k}"] = v
            else:
                checks[f"tp_serve_{k}_tp_vs_one_rank"] = v["tp_vs_one_rank_max_abs"]
                checks[f"tp_serve_{k}_one_rank_vs_f32"] = v["one_rank_bf16_vs_f32_max_abs"]
    queries["tp_serve"] = {
        "by_rank": ranks,
        "transport": f"gloo over tcp://localhost, {TP_MODEL} ranks on one card "
                     f"(host staging): walls are gloo's, not NCCL's"}
    log(f"tp_serve: {json.dumps(queries['tp_serve'])}")
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


# The tp_train path, run in dp_train's two rank processes on a (data 1,
# model TP_MODEL) mesh over the same world (gloo, one card), through
# launch/steps.py's make_train_step and launch/train.py's run: tensor- and
# expert-parallel training (models/tp.py's autograd collectives, the
# vocabulary-parallel loss).  First two holds at full width and 2 layers in
# float32 (TF32 off) on a global batch of TP_TRAIN_HOLD tokens, each against
# one rank's step without a mesh on the same weights and batch: (a)
# qwen3-0.6b, (b) deepseek-moe-16b (the first dense layer and one MoE
# layer) expert-parallel against one rank's gspmd block, bucket_scatter
# launched at P = E/M + 1 = 33 once a MoE layer in the forward and once in
# the recomputation (remat per block): the loss within 1e-4 relative, each
# gradient leaf within 1e-4 of its largest |g|, the parameters after one
# AdamW step within 2 lr where |g| is below 1e-4 of the leaf's largest and
# within rtol 1e-5, atol 1e-2 lr elsewhere.  Then (c) qwen3-0.6b at
# TP_TRAIN_LAYERS layers in bf16, remat per block, ZeRO-1 (at data 1 the
# moments are whole blocks of the model blocks), TP_TRAIN_STEPS steps of a
# global TP_TRAIN_BATCH x TP_TRAIN_SEQ tokens from the token pipeline, the
# first loss within 0.5 of ln V; one more step's collectives against the
# layout (``tp_train_layout``); prefix_sum and bucket_scatter (the
# pipeline) launched in each rank.
TP_TRAIN_HOLD = (8, 512)
TP_TRAIN_MOE_LAYERS = 2
TP_TRAIN_LAYERS = DP_LAYERS
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 4, 2048
TP_TRAIN_STEPS = 3


def tp_train_layout(cfg, b: int, s: int) -> dict:
    """The collectives of one dense train step on (data 1, model 2), one
    micro-batch of b x s, every dim cut whole (as tests/test_torch_sharding.py
    and the thread ranks count them): float32 all-reduces of a (b, s, d)
    activation, a layer two in the forward (wo's and the SwiGLU's sums),
    one in the recomputation with remat (the SwiGLU's sum comes after the
    last tensor it saves, so its early stop skips it), two in the backward
    (the cotangents of the q/k/v and SwiGLU inputs) and, with qk_norm, two
    of the per-head norm scales' (hd,) gradients; once a step the
    embedding's sum, the head input's cotangent, the loss's sum of
    exponentials with the gold logit ((2, b, s)) and the clipping norm's
    scalar; the loss's max, (b, s)."""
    act = 4 * b * s * cfg.d_model
    remat = int(cfg.remat == "block")
    norms = 2 * int(cfg.qk_norm)
    calls = cfg.n_layers * (4 + remat + norms) + 4
    nbytes = (cfg.n_layers * ((4 + remat) * act + norms * 4 * cfg.hd)
              + 2 * act + 8 * b * s + 4)
    return {"all_reduce_sum": {"calls": calls, "bytes": nbytes},
            "all_reduce_max": {"calls": 1, "bytes": 4 * b * s}}


def tp_hold(torch, mesh, dev, cfg, one_cfg, seed: int) -> dict:
    """One float32 hold of the tp_train path: ``cfg``'s gradient and one
    AdamW step on ``mesh`` against one rank's of ``one_cfg`` without a
    mesh, on rank 0's draw of the weights and one batch; the bucket_scatter
    launches of the mesh's gradient and the bucket counts ``ep_slots``
    asked for."""
    from repro_torch.kernels import cuda
    from repro_torch.launch import steps
    from repro_torch.models import lm, moe, sharding
    from repro_torch.optim import OptConfig, adamw

    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    whole = lm.init_params(cfg, seed=seed, device=dev).tree()
    for _, t in lm.leaves(whole):
        mesh.world.broadcast(t.data)
    b, s = TP_TRAIN_HOLD
    batch = token_batches(torch, cfg.vocab, b, s, 1, 19, dev)[0]
    pspecs = sharding.param_shardings(cfg, mesh, steps.model_param_specs(cfg))
    params = sharding.shard_params(whole, mesh)
    buckets, ep_slots = [], moe.ep_slots

    def counted(flat_e, E, M, m_idx, kernels):
        buckets.append(E // M + 1)
        return ep_slots(flat_e, E, M, m_idx, kernels)
    moe.ep_slots = counted
    try:
        torch.cuda.synchronize()
        before = cuda.launches["bucket_scatter"]
        loss, g = steps.value_and_grad(steps.make_loss_fn(cfg, mesh=mesh), params, batch)
        torch.cuda.synchronize()
        launched = cuda.launches["bucket_scatter"] - before
    finally:
        moe.ep_slots = ep_slots
    g = sharding.gather_tree(g, pspecs, mesh)
    state = {"params": params,
             "opt": adamw.init_state(params, ocfg, mesh=mesh, specs=pspecs)}
    _, step_loss = steps.make_train_step(cfg, ocfg, mesh=mesh)(state, batch)
    after = sharding.gather_tree(state["params"], pspecs, mesh)
    del state, params
    out = {"model": cfg.name, "layers": cfg.n_layers, "moe_impl": cfg.moe_impl,
           "dtype": cfg.param_dtype, "batch": b, "seq": s, "loss_tp": float(loss),
           "step_loss_tp": float(step_loss), "bucket_scatter_launches": launched,
           "ep_buckets": buckets}
    if mesh.rank != 0:
        return out
    # one rank, no mesh: rank 0's weights (the mesh holds copies of blocks)
    loss1, g1 = steps.value_and_grad(steps.make_loss_fn(one_cfg), whole, batch)
    grad_rel = {"/".join(k): float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                for (k, x), (_, y) in zip(lm.leaves(g), lm.leaves(g1))}
    del g
    st1 = {"params": whole, "opt": adamw.init_state(whole, ocfg)}
    steps.make_train_step(one_cfg, ocfg)(st1, batch)
    lr = ocfg.lr
    worst, worst_resolved = 0.0, 0.0
    for (k, x), (_, w), (_, gw) in zip(lm.leaves(after), lm.leaves(st1["params"]),
                                       lm.leaves(g1)):
        diff = (x - w).abs()
        worst = max(worst, float(diff.max()))
        resolved = gw.abs() > 1e-4 * gw.abs().max()
        if bool(resolved.any()):
            worst_resolved = max(worst_resolved, float(
                (diff - 1e-5 * w.abs())[resolved].max()))
    out |= {"loss_one_rank": float(loss1), "loss_rel": abs(float(loss) / float(loss1) - 1),
            "grad_max_rel": max(grad_rel.values()), "grad_rel": grad_rel,
            "param_max_abs": worst, "param_resolved_max_excess": worst_resolved}
    # float32 on both sides, TF32 off: the order of sums differs
    assert out["loss_rel"] <= 1e-4 and out["grad_max_rel"] <= 1e-4, out
    assert worst <= 2 * lr and worst_resolved <= 1e-2 * lr, out
    return out


def tp_train(torch, rank: int, dev, ckpt_dir: str) -> dict:
    """The tp_train path in this rank (see TP_TRAIN_*): the holds, then the
    bf16 run through ``train.run`` with the counters zeroed just before
    it, then one counted step."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.data import synth
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig

    mesh = M.make_local_mesh(model_axis=TP_MODEL)
    assert dict(mesh.shape) == {"data": 1, "model": TP_MODEL}, mesh
    t0 = time.perf_counter()
    dense = hold_cfg(get_config(LM_ARCH))
    moe_cfg = hold_cfg(get_config(MOE_ARCH)).replace(n_layers=TP_TRAIN_MOE_LAYERS)
    hold = {"dense": tp_hold(torch, mesh, dev, dense, dense, 3)}
    torch.cuda.empty_cache()
    hold["ep"] = tp_hold(torch, mesh, dev, moe_cfg.replace(moe_impl="ep"), moe_cfg, 4)
    torch.cuda.empty_cache()
    n_moe = moe_cfg.n_layers - moe_cfg.first_dense_layers
    ep_p = moe_cfg.n_experts // TP_MODEL + 1
    # the forward and the recomputation, each MoE layer, at P = E/M + 1
    assert hold["ep"]["bucket_scatter_launches"] == 2 * n_moe, hold["ep"]
    assert hold["ep"]["ep_buckets"] == [ep_p] * (2 * n_moe), hold["ep"]
    assert hold["dense"]["bucket_scatter_launches"] == 0, hold["dense"]
    hold_s = time.perf_counter() - t0

    cfg = get_config(LM_ARCH).replace(n_layers=TP_TRAIN_LAYERS)
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    corpus = synth.token_corpus(DP_DOCS, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launches()
    mesh.reset_counts()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    run = train.run(cfg, ocfg, corpus, steps=TP_TRAIN_STEPS, batch=TP_TRAIN_BATCH,
                    seq=TP_TRAIN_SEQ, ckpt_dir=ckpt_dir, ckpt_every=TP_TRAIN_STEPS + 1,
                    device=dev, log_every=1, mesh=mesh)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    for name in ("prefix_sum", "bucket_scatter"):
        assert launches[name] > 0, f"{name} never launched in tp_train rank {rank}"
    losses = run["losses"]
    assert len(losses) == TP_TRAIN_STEPS and all(map(math.isfinite, losses)), losses
    assert abs(losses[0] - math.log(cfg.vocab)) <= 0.5, (losses[0], math.log(cfg.vocab))
    drv = run["driver"]
    state = drv.state
    rec = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
           "remat": cfg.remat, "mesh": dict(mesh.shape),
           "global_batch": TP_TRAIN_BATCH, "seq": TP_TRAIN_SEQ,
           "steps": run["steps"], "losses": losses,
           "pipeline_s": round(run["pipeline_s"], 3), "run_s": round(run_s, 3),
           "step_ms": [round(x * 1e3, 3) for x in drv.stats.times],
           "step_median_ms": round(float(np.median(drv.stats.times)) * 1e3, 3),
           "peak_gib": round(peak / 2**30, 3),
           "param_bytes": sum(t.numel() * t.element_size()
                              for _, t in lm.leaves(state["params"])),
           "opt_bytes": opt_bytes(state["opt"]),
           "run_collectives": {k: dict(v) for k, v in mesh.counts.items()},
           "saves": [{k: (round(v, 3) if isinstance(v, float) else v)
                      for k, v in r.items()} for r in drv.saver.records]}
    # one more step, counted, against the layout
    step_fn = steps.make_train_step(cfg, ocfg, mesh=mesh)
    batch = token_batches(torch, cfg.vocab, TP_TRAIN_BATCH, TP_TRAIN_SEQ, 1, 29, dev)[0]
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss = step_fn(state, batch)
    loss = float(loss)
    rec["counted_step_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    counts = {k: dict(v) for k, v in mesh.counts.items()}
    want = tp_train_layout(cfg, TP_TRAIN_BATCH, TP_TRAIN_SEQ)
    assert counts == want, (counts, want)
    assert math.isfinite(loss), loss
    rec |= {"step_collectives": counts, "counted_step_loss": loss}
    del run, drv, state, step_fn, batch
    return {"rank": rank, "hold": hold, "hold_s": round(hold_s, 3), "run": rec,
            "launches": launches}


# The tp_serve path, run in dp_train's two rank processes on a (data 1,
# model TP_MODEL) mesh over the same world (gloo, one card): qwen3-0.6b at
# full width and depth and deepseek-moe-16b at full width and TP_MOE_LAYERS
# layers (the first dense layer and 3 MoE layers: depth cut for time),
# expert-parallel, bf16, through launch/steps.py.  Each prefills its
# requests into a LM_MID-row cache (LM_MID / TP_MODEL rows a rank) and
# decodes greedily on: the decode continues the prefilled requests.  Then
# one decode step of each under torch.profiler; then the holds: at 2
# layers in float32 (TP_HOLD) the mesh's logits against one rank's without
# a mesh, and at the path's size in bf16 the largest logit deviation from
# one rank's bf16 run against one rank's bf16-against-float32 deviation on
# the same prompts and tokens (rank 0 the lm's, rank 1 the moe's, at once).
TP_LM = (8, 2048, 32)            # requests, prompt tokens, greedy new tokens
TP_MOE = (4, 2048, 16)
TP_MOE_LAYERS = 4
TP_HOLD = (2, 160, 4, 256)       # requests, prompt tokens, decode steps, max_seq
TP_KERNELS = {"decode_attention_partial": "decode_attention_split",
              "decode_attention_merge": "decode_attention_combine",
              "bucket_scatter": BUCKET_KERNEL}


def tp_cfgs() -> dict:
    from repro_torch.configs import get_config
    return {"lm": get_config(LM_ARCH),
            "moe": get_config(MOE_ARCH).replace(n_layers=TP_MOE_LAYERS, moe_impl="ep")}


def tp_expected_launches() -> dict:
    """Each rank's launches on the path: a partial and a merge a layer and
    decode step (the cache is sharded along S: no whole decode_attention);
    a bucket_scatter a MoE layer in the prefill and in each decode step."""
    cfgs = tp_cfgs()
    lm_n, moe_n = cfgs["lm"].n_layers * TP_LM[2], cfgs["moe"].n_layers * TP_MOE[2]
    moe = cfgs["moe"]
    return {"decode_attention_partial": lm_n + moe_n,
            "decode_attention_merge": lm_n + moe_n,
            "bucket_scatter": (moe.n_layers - moe.first_dense_layers) * (1 + TP_MOE[2]),
            "decode_attention": 0}


def tp_decode_layout(cfg, mesh, b: int, max_seq: int) -> dict:
    """The collectives of one decode step on ``mesh`` by the rules (as
    tests/test_torch_sharding.py counts them): an all-reduce (float32, B x
    d) for the vocabulary-parallel embedding, each row-parallel wo and
    SwiGLU and each MoE block; a layer's all-gather of the step's sharded
    q/k/v columns (B x their columns, compute dtype) and, with S sharded,
    of the partials (TP_MODEL x B x Hkv x G x (hd + 2) float32)."""
    from repro_torch.models import lm, sharding
    shapes = lm.param_shapes(cfg)
    at = lambda path: functools.reduce(lambda t, k: t[k], path, shapes)  # noqa: E731
    cut = lambda path: any(e is not None for e in  # noqa: E731
                           sharding.param_spec_for(mesh, path, at(path)))
    m, d, hd = mesh.shape["model"], cfg.d_model, cfg.hd
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    item = lm._dt(cfg).itemsize
    reduces, gathers, gbytes = int(cut(("embed",))), 0, 0
    for name, n in lm.stacks(cfg).items():
        ffn = ("moe", "experts", "w_gate") if name == "layers" and cfg.family == "moe" \
            else ("mlp", "w_down")
        reduces += n * (int(cut((name, "attn", "wo"))) + int(cut((name,) + ffn)))
        cols = [c for w, c in (("wq", h * hd), ("wk", hkv * hd), ("wv", hkv * hd))
                if cut((name, "attn", w))]
        seq = max_seq % m == 0
        gathers += n * (bool(cols) + seq)
        gbytes += n * (item * b * sum(cols) + seq * 4 * m * b * hkv * (h // hkv) * (hd + 2))
    return {"all_reduce_sum": {"calls": reduces, "bytes": reduces * 4 * b * d},
            "all_gather": {"calls": gathers, "bytes": gbytes}}


def tp_generate(torch, cfg, model, mesh, prompt, new: int, max_seq: int,
                tokens=None, counted: bool = False) -> dict:
    """Prefill ``prompt`` into a ``max_seq``-row cache and decode ``new``
    steps through launch/steps.py on ``mesh`` (None: one rank, no mesh):
    greedy (``lm.greedy`` across the vocabulary blocks), or fed ``tokens``
    (new, B).  Returns the logits of every step gathered over the
    vocabulary (new + 1, B, V) float32, the tokens fed, the prefill's
    seconds, each step's ms (CUDA events, the pick included), with
    ``counted`` the collectives of the first decode step, and the live
    model, cache, step and next token for one more step."""
    from repro_torch.launch import steps
    from repro_torch.models import lm, sharding
    tp = sharding.model_group(mesh)

    def whole(lg):
        if tp is not None and lg.shape[-1] != cfg.vocab:
            lg = tp.all_gather(lg, dim=-1)
        return lg.float()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = steps.make_prefill_step(cfg, max_seq, mesh=mesh)(
        model, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, fed, counts = [whole(logits)], [], None
    step = steps.make_decode_step(cfg, mesh=mesh)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(new + 1)]
    for i in range(new):
        marks[i].record()
        tok = (lm.greedy(logits, cfg, mesh) if tokens is None else tokens[i]
               )[:, None].to(torch.int32)
        fed.append(tok[:, 0])
        if counted and i == 0:
            mesh.reset_counts()
        logits, caches = step(model, tok, caches)
        if counted and i == 0:
            counts = {k: dict(v) for k, v in mesh.counts.items()}
        out.append(whole(logits))
    marks[new].record()
    torch.cuda.synchronize()
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(new)]
    nxt = lm.greedy(logits, cfg, mesh)[:, None].to(torch.int32)
    return {"logits": torch.stack(out), "tokens": torch.stack(fed) if fed else None,
            "prefill_s": prefill_s, "step_ms": step_ms, "counts": counts,
            "live": (model, caches, step, nxt)}


def tp_serve(torch, rank: int, dev) -> dict:
    """The tp_serve path in this rank (see TP_*): the launches of its bf16
    runs (counters zeroed just before), the kernels one profiled decode
    step of each model launched, and the holds."""
    from repro_torch.kernels import cuda
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm

    mesh = M.make_local_mesh(model_axis=TP_MODEL)
    assert dict(mesh.shape) == {"data": 1, "model": TP_MODEL}, mesh
    cfgs = tp_cfgs()
    shapes = {"lm": TP_LM, "moe": TP_MOE}
    t_path = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    models = {k: lm.init_params(c, seed=5, device=dev, mesh=mesh) for k, c in cfgs.items()}
    prompts = {k: torch.from_numpy(np.random.default_rng(30 + i).integers(
        0, cfgs[k].vocab, shapes[k][:2]).astype(np.int32)).to(dev)
        for i, k in enumerate(cfgs)}
    torch.distributed.barrier()
    cuda.reset_launches()
    runs = {k: tp_generate(torch, cfgs[k], models[k], mesh, prompts[k], shapes[k][2],
                           LM_MID, counted=True) for k in cfgs}
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    path_s = time.perf_counter() - t_path
    peak = torch.cuda.max_memory_allocated()

    # one more decode step of each model in one profiler window: the
    # kernels the card ran (this process's first profiler session)
    def steps_once():
        for r in runs.values():
            model, caches, step, tok = r["live"]
            step(model, tok, caches)
    seen = {}
    for _ in range(3):                 # a window with no device event: again
        _, seen, _ = traced(torch, steps_once)
        if seen:
            break
    profiled = {name: sum(c for k, c in seen.items() if kern in k)
                for name, kern in TP_KERNELS.items()}
    assert all(profiled.values()), f"tp_serve rank {rank}: the profile saw {seen}"
    want = tp_expected_launches()
    got = {k: launches[k] for k in want}
    assert got == want, f"tp_serve rank {rank}: launches {got}, expected {want}"
    rec = {"rank": rank, "mesh": dict(mesh.shape), "path_s": round(path_s, 3),
           "peak_gib": round(peak / 2**30, 3), "launches": launches,
           "profiled_kernels": profiled,
           "profiled_names": sorted(k for k in seen if any(
               kern in k for kern in TP_KERNELS.values()))}
    for k, r in runs.items():
        b, s, new = shapes[k]
        layout = tp_decode_layout(cfgs[k], mesh, b, LM_MID)
        assert r["counts"] == layout, (k, r["counts"], layout)
        assert bool(torch.isfinite(r["logits"]).all()), f"tp_serve {k}: not finite"
        rec[k] = {"model": cfgs[k].name, "layers": cfgs[k].n_layers,
                  "requests": b, "prompt_tokens": s, "new_tokens": new,
                  "max_seq": LM_MID, "rows_a_rank": LM_MID // TP_MODEL,
                  "prefill_s": round(r["prefill_s"], 4),
                  "step_median_ms": round(float(np.median(r["step_ms"])), 3),
                  "step_min_ms": round(float(np.min(r["step_ms"])), 3),
                  "step_max_ms": round(float(np.max(r["step_ms"])), 3),
                  "step_collectives": r["counts"],
                  "tokens_digest": digest(r["tokens"].cpu().numpy())}
    rec["hold"] = tp_holds(torch, rank, mesh, dev, cfgs, runs, prompts)
    rec["hold_s"] = round(time.perf_counter() - t_path - path_s, 3)
    return rec


def tp_holds(torch, rank: int, mesh, dev, cfgs: dict, runs: dict, prompts: dict) -> dict:
    """(a) float32 at 2 layers (TP_HOLD), both models: the mesh's prefill
    and decode logits against one rank's without a mesh on the same
    weights and tokens, within 1e-4 of the largest |logit| (TF32 off; the
    row-parallel sums add in another order); (b) bf16 at the path's size:
    rank 0 runs the lm's one-rank bf16 and float32 steps, rank 1 the moe's,
    fed the path's tokens; the mesh's largest logit deviation from one
    rank's bf16 must not exceed one rank's bf16-against-float32 one."""
    import dataclasses

    from repro_torch.models import lm
    out = {}
    b, s, new, max_seq = TP_HOLD
    for k, cfg in cfgs.items():
        c32 = cfg.replace(n_layers=2, param_dtype="float32", compute_dtype="float32")
        prompt = torch.from_numpy(np.random.default_rng(50).integers(
            0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
        tp = tp_generate(torch, c32, lm.init_params(c32, seed=6, device=dev, mesh=mesh),
                         mesh, prompt, new, max_seq)
        one = tp_generate(torch, c32, lm.init_params(c32, seed=6, device=dev), None,
                          prompt, new, max_seq, tokens=tp["tokens"])
        rel = float((tp["logits"] - one["logits"]).abs().max()
                    / one["logits"].abs().max())
        assert rel <= 1e-4, f"tp_serve {k} float32 2-layer hold: {rel}"
        out[f"{k}_f32_2l_rel"] = rel
        del tp, one
        torch.cuda.empty_cache()
    # (b): each rank one model's one-rank runs, at once
    k = ("lm", "moe")[rank % 2]
    cfg, run = cfgs[k], runs[k]
    tokens = run["tokens"]
    full = lm.init_params(cfg, seed=5, device=dev)
    one16 = tp_generate(torch, cfg, full, None, prompts[k], len(tokens), LM_MID,
                        tokens=tokens)["logits"]
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    one32 = tp_generate(torch, c32, full, None, prompts[k], len(tokens), LM_MID,
                        tokens=tokens)["logits"]
    dev_tp = float((run["logits"] - one16).abs().max())
    gap = float((one16 - one32).abs().max())
    out[f"{k}_bf16"] = {"tp_vs_one_rank_max_abs": dev_tp,
                        "one_rank_bf16_vs_f32_max_abs": gap,
                        "positions": int(one16.shape[0] * one16.shape[1])}
    assert dev_tp <= gap, f"tp_serve {k} bf16: {dev_tp} from one rank, gap {gap}"
    del full, one16, one32
    torch.cuda.empty_cache()
    return out


def cache_indexes(caches: dict):
    """Every attention cache's device ``index`` in a decode cache."""
    for k, c in caches.items():
        if k == "index":
            yield c
        elif isinstance(c, dict):
            yield from cache_indexes(c)


def lm_serve(torch, cfg, keep: list, seed: int = 0,
             shape: tuple = (LM_BATCH, LM_PROMPT, LM_NEW), model=None,
             batch=None) -> dict:
    """Serve ``cfg`` as examples/serve_lm.py does, through the port's entry
    points (launch/steps.py): random weights from ``seed`` on the card (or
    ``model``), ``shape`` = (requests, prompt positions, new tokens): the
    prompts' token ids from numpy (or the prefill's ``batch``: the vlm
    family's stub embeddings and positions, the encdec family's frames and
    prompt tokens), one prefill into a cache of prompt + new rows, then
    greedy decode steps.  Returns timings, the prefill's batch, and the
    logits of requests ``keep`` at the prefill's last position and at every
    decode step."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    dev = torch.device("cuda")
    b, s, t = shape
    if model is None:
        model = lm.init_params(cfg, seed=seed, device=dev)
    if batch is None:
        prompts = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))
        batch = {"tokens": torch.from_numpy(prompts.astype(np.int32)).to(dev)}
    prefill = steps.make_prefill_step(cfg, s + t)
    step = steps.make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    peak_prefill = torch.cuda.max_memory_allocated()
    kept, gen = [logits[keep]], []
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(t + 1)]
    t0 = time.perf_counter()
    for i in range(t):
        marks[i].record()
        gen.append(tok)
        logits, caches = step(model, tok, caches)
        kept.append(logits[keep])
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    marks[t].record()
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(t)]
    assert caches["host_index"] == s + t
    assert all(bool((i == s + t).all()) for i in cache_indexes(caches))
    return {"model": model, "batch": batch, "tokens": batch.get("tokens"),
            "gen": torch.cat(gen, 1),
            "kept": torch.stack(kept, 1), "keep": keep, "shape": shape,
            "stats": {
                "prefill_ms": round(t_prefill * 1e3, 3),
                "prefill_tok_s": round(b * s / t_prefill, 1),
                "decode_ms": round(t_decode * 1e3, 3),
                "decode_step_median_ms": round(float(np.median(step_ms)), 4),
                "decode_step_min_ms": round(float(np.min(step_ms)), 4),
                "decode_tok_s": round(b * t / t_decode, 1),
                "peak_prefill_gib": round(peak_prefill / 2**30, 3),
                "peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}}


def full_forward(torch, cfg, model, batch: dict, keep: list, gen):
    """The no-cache forward's logits over the prompts of requests ``keep``
    of the prefill's ``batch`` followed by their tokens ``gen`` (k, t): the
    vlm family's at the reference's decode positions (the cache index on
    all three streams), the encdec family's teacher-forced over the encoded
    frames."""
    from repro_torch.models import lm, whisper

    if cfg.family == "encdec":
        enc = whisper.encode(model, batch["frames"][keep], cfg)
        seq = torch.cat([batch["tokens"][keep], gen], 1)
        return whisper.decode_forward(model, seq, enc, cfg)[0]
    if "inputs_embeds" not in batch:
        return lm.forward(model, torch.cat([batch["tokens"][keep], gen], 1), cfg)[0]
    pos = batch["positions"][:, keep]
    s, t = pos.shape[2], gen.shape[1]
    emb = torch.nn.functional.embedding(gen, model.embed)
    step_pos = (s + torch.arange(t, dtype=torch.int32, device=gen.device)
                ).expand(3, len(keep), t)
    return lm.forward(model, None, cfg, positions=torch.cat([pos, step_pos], 2),
                      inputs_embeds=torch.cat([batch["inputs_embeds"][keep], emb],
                                              1))[0]


def lm_against_full_forward(torch, cfg, run: dict) -> float:
    """The served logits of the kept requests (the prefill's last position
    and every decode step) against the port's own no-cache full forward
    over prompt + generated tokens; the largest absolute difference.  Also
    holds the outputs' shapes, finiteness and token range."""
    keep, gen, kept = run["keep"], run["gen"], run["kept"]
    b, s, t = run["shape"]
    assert gen.shape == (b, t)
    assert bool(((gen >= 0) & (gen < cfg.vocab)).all())
    assert kept.shape == (len(keep), t + 1, cfg.vocab)
    assert bool(torch.isfinite(kept.float()).all())
    with torch.no_grad():
        full = full_forward(torch, cfg, run["model"], run["batch"], keep, gen[keep])
    want = full[:, s - 1:]
    assert bool(torch.isfinite(want.float()).all())
    return float((kept.float() - want.float()).abs().max())


def lm_path(torch, queries: dict, runs: dict):
    """The LM serving path: qwen3-0.6b as published (bf16 weights and
    compute, 28 layers), random weights, requests 0 and LM_BATCH - 1 kept
    for the checks after the path."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    run = lm_serve(torch, cfg, keep=[0, LM_BATCH - 1])
    queries["lm_serve"] = {"model": cfg.name, "requests": LM_BATCH,
                           "prompt_tokens": LM_PROMPT, "new_tokens": LM_NEW,
                           **run["stats"]}
    log(f"lm_serve: {queries['lm_serve']}")
    runs["lm"] = run


def lm_checks(torch, run: dict, queries: dict, checks: dict,
              profile_dir: str | None):
    """After the counted path: (a) its bf16 logits against the no-cache
    forward within 0.1 (the reference's own bound for its bf16 decode path,
    tests/test_kernels_decode_attention.py:67); with ``profile_dir``, a
    profile of a few decode steps; (b) the same path at qwen3-0.6b's widths
    with 2 layers in float32 within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps

    cfg = get_config(LM_ARCH)
    d = lm_against_full_forward(torch, cfg, run)
    checks["lm_bf16_28l_vs_full_forward"] = d
    assert d <= 0.1, f"lm bf16: decode logits differ from the full forward by {d}"
    log(f"lm bf16, {cfg.n_layers} layers: max |decode - full forward| = {d}")
    if profile_dir:
        # a fresh prefill, 4 warm decode steps, then 4 profiled ones
        model, tokens = run["model"], run["tokens"]
        logits, caches = steps.make_prefill_step(cfg, LM_PROMPT + 8)(
            model, {"tokens": tokens})
        step = steps.make_decode_step(cfg)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        state = {"tok": tok, "caches": caches}

        def decode(n):
            for _ in range(n):
                lg, state["caches"] = step(model, state["tok"], state["caches"])
                state["tok"] = lg.argmax(-1)[:, None].to(torch.int32)
        decode(4)
        prof = profile_run(torch, lambda: decode(4),
                           os.path.join(profile_dir, "profile_lm_decode.txt"))
        queries["lm_serve"]["profile_4_decode_steps"] = prof
        log(f"lm decode profile (4 steps): {prof}")
        del state, caches, logits
    run.clear()
    torch.cuda.empty_cache()

    cfg32 = cfg.replace(n_layers=2, param_dtype="float32",
                        compute_dtype="float32")
    run32 = lm_serve(torch, cfg32, keep=[0, LM_BATCH - 1], seed=1)
    d = lm_against_full_forward(torch, cfg32, run32)
    checks["lm_f32_2l_vs_full_forward"] = d
    queries["lm_serve_f32_2l"] = run32["stats"]
    assert d <= 1e-3, f"lm float32: decode logits differ from the full forward by {d}"
    log(f"lm float32, 2 layers: max |decode - full forward| = {d}; "
        f"{run32['stats']}")
    run32.clear()
    torch.cuda.empty_cache()


# The training path: qwen3-0.6b at its published widths and TRAIN_LAYERS
# of its 28 layers (cut to keep the script within its time limit; bf16,
# remat per block, random weights from a seed) trained through
# launch/train.py's run(): the HiFrames token pipeline over a pretraining-
# scale document table (2^24 documents, ~17 G tokens), 10 AdamW steps of
# 8 x 2048 tokens under the fault-tolerant driver, checkpoints every 5
# steps.  The steps are the first of a TRAIN_SCHEDULE-step cosine schedule,
# so every step here, the resumed ones included, has lr > 0.  Then a
# restore into a fresh state, two steps from each state, and the gradient
# and step at 2 layers in float32 held against the CPU.
TRAIN_DOCS = 2**24
TRAIN_LAYERS = 14
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_MORE = 10, 5, 2
TRAIN_SCHEDULE = 100
# batch, seq of the float32 hold on the CPU (seq cut from 128, then 64, to
# keep the script within its time limit; the vlm hold's prompt needs 40)
TRAIN_HOLD = (2, 48)
BF16_OPS_PER_S = 989e12          # H100 SXM data sheet, dense bf16


def wrap32(x: np.ndarray) -> np.ndarray:
    """int64 values as the int32 they wrap to."""
    return ((x + 2**31) % 2**32 - 2**31).astype(np.int32)


def pipeline_checks(pipe, corpus: dict) -> dict:
    """The token pipeline's plan outputs against numpy: the curated rows
    and seeds exactly; the packing offsets, total and per-bucket token sums
    as int32 sums that wrap, as the reference computes them; and the exact
    (int64) total beside the wrapped one."""
    cfg = pipe.cfg
    mask = (corpus["length"] >= cfg.min_len) & \
        (corpus["quality"] > np.float32(cfg.min_quality))
    length, seed = corpus["length"][mask], corpus["seed"][mask]
    assert np.array_equal(pipe.doc_len, length), "pipeline: curated lengths"
    assert np.array_equal(pipe.doc_seed, seed), "pipeline: curated seeds"
    exact = np.cumsum(length, dtype=np.int64)
    want_offset = wrap32(exact - length)
    assert np.array_equal(pipe.doc_offset, want_offset), "pipeline: offsets"
    assert pipe.total_tokens == int(wrap32(exact[-1:])[0]), "pipeline: total"
    bucket = (corpus["quality"][mask] * 10).astype(np.int32)
    keys = np.unique(bucket)
    tokens = np.array([int(length[bucket == k].sum(dtype=np.int64)) for k in keys])
    docs = np.array([int((bucket == k).sum()) for k in keys])
    order = np.argsort(pipe.bucket_stats["bucket"])
    got = {k: np.asarray(v)[order] for k, v in pipe.bucket_stats.items()}
    assert np.array_equal(got["bucket"], keys), "pipeline: buckets"
    assert np.array_equal(got["tokens"], wrap32(tokens)), "pipeline: bucket tokens"
    assert np.array_equal(got["docs"], docs), "pipeline: bucket docs"
    return {"docs_in": int(len(mask)), "docs_curated": int(mask.sum()),
            "total_tokens_int64": int(exact[-1]),
            "total_tokens_int32": pipe.total_tokens,
            "offsets_wrapped": int((pipe.doc_offset < 0).sum()),
            "buckets": int(len(keys))}


def differing_bits(torch, a: dict, b: dict) -> dict:
    """Per leaf of two trees of tensors of one structure, dtype and shape,
    the number of entries whose bits differ (leaves with none left out)."""
    from repro_torch.models import lm
    la, lb = dict(lm.leaves(a)), dict(lm.leaves(b))
    assert la.keys() == lb.keys(), (sorted(la), sorted(lb))
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.uint8}
    out = {}
    for k, x in la.items():
        y = lb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if x.dtype.is_floating_point:
            x, y = x.view(bits[x.element_size()]), y.view(bits[y.element_size()])
        n = int((x != y.to(x.device)).sum())
        if n:
            out["/".join(k)] = n
    return out


def token_batches(torch, vocab: int, b: int, s: int, n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
                    "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)})
    return out


def hold_cfg(cfg):
    """``cfg``'s widths in float32 at 2 layers; the hybrid family at 3
    layers of period 2 (one group and a tail: two shared applications);
    the encdec family at its full depth."""
    c = cfg.replace(param_dtype="float32", compute_dtype="float32")
    if cfg.family == "hybrid":
        return c.replace(n_layers=3, shared_attn_period=2)
    return c if cfg.family == "encdec" else c.replace(n_layers=2)


def hold_models(torch, cfg) -> tuple:
    """``hold_cfg(cfg)``: random weights from a seed on the CPU, and a copy
    of them on the card."""
    from repro_torch.models import lm, whisper

    c = hold_cfg(cfg)
    cpu_model = (whisper if c.family == "encdec" else lm).init_params(
        c, seed=3, device="cpu")
    card_model = type(cpu_model)(c, lm.tree_map(
        lambda t: t.detach().to("cuda", copy=True), cpu_model.tree()))
    return cpu_model, card_model


def train_hold(torch, cfg, ocfg, models=None, batch_of=None) -> dict:
    """The train step at ``hold_cfg(cfg)`` (TF32 off) on the card and on
    the CPU from the same weights (``models`` from ``hold_models``, made
    here if None; the step updates them) and batch (TRAIN_HOLD's tokens,
    or ``batch_of(model, device)``):
    each gradient leaf's largest difference over its largest |g|, the
    step's loss, and the loss of the same batch after the update."""
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    c = hold_cfg(cfg)
    cpu_model, card_model = models or hold_models(torch, cfg)
    b, s = TRAIN_HOLD
    if batch_of is None:
        def batch_of(model, dev):
            return token_batches(torch, c.vocab, b, s, 1, 17, dev)[0]
    out = {}
    for name, model in (("cpu", cpu_model), ("cuda", card_model)):
        batch = batch_of(model, torch.device(name))
        params = model.tree()
        opt = adamw.init_state(params, ocfg)
        t0 = time.perf_counter()
        # make_train_step's body at n_micro 1, keeping the gradient
        loss, grads = steps.value_and_grad(steps.make_loss_fn(c), params, batch)
        adamw.update(params, grads, opt, ocfg)
        loss = float(loss)
        dt = time.perf_counter() - t0
        with torch.no_grad():
            after = float(steps.make_loss_fn(c)(params, batch))
        out[name] = {"loss": loss, "after": after, "s": dt, "grads": grads}
    cpu, card = out["cpu"], out["cuda"]
    grad_rel = {"/".join(k): float((x.cpu() - y).abs().max() / y.abs().max())
                for (k, x), (_, y) in zip(lm.leaves(card["grads"]),
                                          lm.leaves(cpu["grads"]))}
    return {"loss_cpu": cpu["loss"], "loss_cuda": card["loss"],
            "loss_rel": abs(card["loss"] / cpu["loss"] - 1),
            "after_cpu": cpu["after"], "after_cuda": card["after"],
            "after_rel": abs(card["after"] / cpu["after"] - 1),
            "grad_max_rel": max(grad_rel.values()), "grad_rel": grad_rel,
            "step_s_cpu": round(cpu["s"], 3), "step_s_cuda": round(card["s"], 3)}


def train_path(torch, queries: dict, checks: dict, profile_dir: str | None = None):
    """The training path, through launch/train.py's ``run`` as its
    ``main`` drives it (see TRAIN_*), then the restore, the resume and the
    float32 hold; every check raises.  With ``profile_dir``, one more step
    of the live state under torch.profiler (``profile_train_step.txt``)."""
    import math
    import shutil
    import tempfile

    from repro_torch.checkpoint import copy_into, restore
    from repro_torch.configs import get_config
    from repro_torch.data import synth
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, adamw

    cfg = get_config(LM_ARCH).replace(n_layers=TRAIN_LAYERS)
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    t0 = time.perf_counter()
    corpus = synth.token_corpus(TRAIN_DOCS, cfg.vocab)
    corpus_s = time.perf_counter() - t0
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train.run(cfg, ocfg, corpus, steps=TRAIN_STEPS,
                        batch=TRAIN_BATCH, seq=TRAIN_SEQ, ckpt_dir=ckpt_dir,
                        ckpt_every=TRAIN_CKPT_EVERY, device="cuda",
                        log_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        drv, pipe = res["driver"], res["pipeline"]
        pipe_rec = pipeline_checks(pipe, corpus)
        del corpus
        losses = res["losses"]
        assert len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)), losses
        ln_v = math.log(cfg.vocab)
        assert abs(losses[0] - ln_v) <= 0.5, (losses[0], ln_v)
        step_s = float(np.median(drv.stats.times))
        tok_s = TRAIN_BATCH * TRAIN_SEQ / step_s
        rec = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
               "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
               "steps": res["steps"], "schedule_steps": TRAIN_SCHEDULE,
               "corpus_s": round(corpus_s, 3),
               "pipeline_s": round(res["pipeline_s"], 3), **pipe_rec,
               "run_s": round(run_s, 3), "losses": losses,
               "step_ms": [round(t * 1e3, 3) for t in drv.stats.times],
               "step_median_ms": round(step_s * 1e3, 3),
               "tokens_per_s": round(tok_s, 1),
               "mfu_bf16": round(cfg.model_flops_per_token() * tok_s
                                 / BF16_OPS_PER_S, 4),
               "model_flops_per_token": cfg.model_flops_per_token(),
               "peak_gib": round(peak / 2**30, 3),
               "stragglers": res["stragglers"],
               "saves": [{k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in r.items()} for r in drv.saver.records]}
        log(f"train: {rec}")

        # restore into a fresh state, bitwise
        fresh_model = lm.init_params(cfg, seed=1, device="cuda")
        fresh = {"params": fresh_model.tree(),
                 "opt": adamw.init_state(fresh_model.tree(), ocfg)}
        t0 = time.perf_counter()
        tree, step, meta = restore(ckpt_dir, fresh, device="cuda")
        copy_into(fresh, tree)
        torch.cuda.synchronize()
        rec["restore_s"] = round(time.perf_counter() - t0, 3)
        del tree
        assert step == TRAIN_STEPS and meta == {"arch": cfg.name}, (step, meta)
        differ = differing_bits(torch, fresh, drv.state)
        assert not differ, f"restore: entries differ {differ}"
        rec["restored_leaves"] = sum(1 for _ in lm.leaves(fresh))
        checks["train_restore_bitwise"] = True

        # two more steps on one batch from the live and from the restored
        # state.  The second loss reads the first step's update, made at
        # lr > 0 from the restored step, moments and parameters: a state
        # restored wrong changes that update by a factor of order 1, so the
        # loss by about as much as the update moved it (``moved``, the first
        # loss less the second); one restored right differs only where the
        # card sums a gradient in another order (atomics), a bf16 ulp at a
        # few entries.  Hence the bound: 1 % of ``moved``.  (On an H100 the
        # two states came out bitwise equal, PERF.md §6; scaling the
        # restored v by 4 moves the second loss by ~30 % of ``moved``.)
        step_fn = steps.make_train_step(cfg, ocfg)
        batch = token_batches(torch, cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, 1, 23,
                              torch.device("cuda"))[0]
        rec["resume_lr"] = [float(adamw.lr_at(TRAIN_STEPS + i + 1, ocfg))
                            for i in range(TRAIN_MORE)]
        live, again = [], []
        state = drv.state
        for _ in range(TRAIN_MORE):
            state, loss = step_fn(state, batch)
            live.append(float(loss))
        for _ in range(TRAIN_MORE):
            fresh, loss = step_fn(fresh, batch)
            again.append(float(loss))
        moved = again[0] - again[1]
        d = [abs(x - y) for x, y in zip(live, again)]
        differ = differing_bits(torch, fresh, state)
        rec |= {"resume_losses_live": live, "resume_losses_restored": again,
                "resume_moved": moved, "resume_entries_differing": differ}
        checks["train_resume_first_loss_diff"] = d[0]
        checks["train_resume_second_loss_diff"] = d[1]
        checks["train_resume_moved"] = moved
        # the first step's forward sees the same bits and is deterministic
        assert d[0] == 0.0, f"resume: first loss differs by {d[0]}"
        assert moved > 0.0, f"resume: the step did not lower the loss {again}"
        assert d[1] <= 0.01 * moved, \
            f"resume: second loss differs by {d[1]}, the step moved it {moved}"
        if profile_dir:
            prof = profile_run(torch, lambda: float(step_fn(state, batch)[1]),
                               os.path.join(profile_dir, "profile_train_step.txt"))
            rec["profile_1_step"] = prof
            log(f"train step profile: {prof}")
        del fresh, fresh_model, state, batch, drv, res
        torch.cuda.empty_cache()

        hold = train_hold(torch, cfg, ocfg)
        rec["hold_f32_2l"] = hold
        checks["train_f32_2l_grad_rel_vs_cpu"] = hold["grad_max_rel"]
        checks["train_f32_2l_loss_rel_vs_cpu"] = hold["loss_rel"]
        checks["train_f32_2l_after_rel_vs_cpu"] = hold["after_rel"]
        # float32 on both sides, TF32 off: only summation order differs.
        # Every gradient leaf within 1e-4 x its largest |g|, the bound the
        # CPU tests hold the port's gradients to against jax.grad
        assert hold["grad_max_rel"] <= 1e-4, hold
        assert hold["loss_rel"] <= 1e-4 and hold["after_rel"] <= 1e-4, hold
        log(f"train hold (2 layers, float32, card against CPU): {hold}")
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    queries["train"] = rec


# The moe path: deepseek-moe-16b as published (28 layers: 1 dense with ff
# 10944, then 27 MoE with 64 routed experts of ff 1408, top 6, and 2 shared;
# d 2048, 16 heads, V 102400; bf16, random weights from a seed), served
# through launch/steps.py: 16 requests of 2048 prompt tokens, 128 greedy new
# tokens (cut from 256 to keep the script within its time limit).  Every
# MoE layer ranks its T·k rows within their experts through bucket_scatter
# (P = E = 64), once in the prefill and once a decode step.  After the path:
# the same weights at capacity_factor E / top_k (C >= T: no row dropped)
# held against the no-cache forward; full width at 2 layers (1 dense + 1
# MoE) in float32 held against the CPU, its logits and its train step's
# gradient.  Then moe_train: 2 layers (1 dense + 1 MoE; cut from 4 to keep
# the script within its time limit) at full width trained through
# launch/train.run, one checkpoint at the end, restored bitwise.
MOE_ARCH = "deepseek-moe-16b"
MOE_BATCH, MOE_PROMPT, MOE_NEW = 16, 2048, 128
MOE_NODROP = (2, 256, 32)        # requests, prompt tokens, new tokens
# requests, tokens, of them decoded last (tokens cut from 128, then 64, for
# the time limit)
SERVE_HOLD = (2, 32, 8)
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 5, 8, 2048
MOE_TRAIN_DOCS = 2**16


class RouteRecorder:
    """Wraps ``repro_torch.models.moe.route`` while in use.  With ``first``,
    keeps the first ``first`` calls' (counts, C, rows) and then unwraps
    itself, so that the calls after them run as the port runs them; without
    it, counts every call and sums the rows each drops on the device (no
    host synchronisation)."""

    def __init__(self, first: int | None = None):
        self.first_n, self.calls, self.first, self.dropped = first, 0, [], None

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = orig = moe.route

        def route(p, xt, cfg, group=None):
            r = orig(p, xt, cfg, group)
            self.calls += 1
            if self.first_n is not None:
                self.first.append((r.counts, r.C, r.slot.numel()))
                if len(self.first) == self.first_n:
                    moe.route = orig
                return r
            over = (r.counts - r.C).clamp(min=0).sum()
            self.dropped = over if self.dropped is None else self.dropped + over
            return r
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._orig

    def dropped_rows(self) -> int:
        return 0 if self.dropped is None else int(self.dropped)


def moe_path(torch, queries: dict, runs: dict):
    """The moe serving path (see MOE_*); requests 0 and MOE_BATCH - 1 kept
    for the checks after the path."""
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    torch.cuda.empty_cache()
    n_moe = cfg.n_layers - cfg.first_dense_layers
    # the prefill's routings recorded; the decode steps run unwrapped
    with RouteRecorder(first=n_moe) as rec:
        run = lm_serve(torch, cfg, keep=[0, MOE_BATCH - 1],
                       shape=(MOE_BATCH, MOE_PROMPT, MOE_NEW))
    assert rec.calls == n_moe, rec.calls
    # each prefill layer's share of its T·k rows dropped: Σ max(counts - C,
    # 0) / (T·k)
    shares = [float((c - C).clamp(min=0).sum()) / n for c, C, n in rec.first]
    queries["moe_serve"] = {
        "model": cfg.name, "layers": cfg.n_layers, "experts": cfg.n_experts,
        "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "requests": MOE_BATCH, "prompt_tokens": MOE_PROMPT,
        "new_tokens": MOE_NEW, **run["stats"],
        "prefill_capacity": rec.first[0][1],
        "prefill_drop_share_first_moe_layer": shares[0],
        "prefill_drop_share_by_layer": shares}
    log(f"moe_serve: {queries['moe_serve']}")
    runs["moe"] = run


def serve_hold(torch, cfg, models) -> dict:
    """``hold_cfg(cfg)`` (the moe family: 1 dense + 1 MoE layer) in float32
    (TF32 off) on the card and on the CPU from the same weights and tokens:
    the largest logit difference of a full forward, and of a prefill of the
    first tokens followed by the last SERVE_HOLD[2] fed one by one."""
    from repro_torch.launch import steps
    from repro_torch.models import lm

    c = hold_cfg(cfg)
    b, s, t = SERVE_HOLD
    cpu_model, card_model = models
    toks = np.random.default_rng(5).integers(0, c.vocab, (b, s)).astype(np.int32)
    out = {}
    for name, model in (("cpu", cpu_model), ("cuda", card_model)):
        tokens = torch.from_numpy(toks).to(name)
        with torch.no_grad():
            full, _, aux = lm.forward(model, tokens, c)
            logits, caches = steps.make_prefill_step(c, s)(
                model, {"tokens": tokens[:, :s - t]})
            served = [logits]
            for i in range(s - t, s):
                logits, caches = steps.make_decode_step(c)(
                    model, tokens[:, i:i + 1], caches)
                served.append(logits)
        out[name] = (full.cpu(), torch.stack(served, 1).cpu(), float(aux))
    (fc, sc, ac), (fg, sg, ag) = out["cpu"], out["cuda"]
    return {"forward_max_abs": float((fg - fc).abs().max()),
            "served_max_abs": float((sg - sc).abs().max()),
            "aux_cpu": ac, "aux_cuda": ag,
            "logit_scale": float(fc.abs().max())}


def moe_checks(torch, run: dict, queries: dict, checks: dict):
    """After the counted moe path: (a) its bf16 logits finite and in range;
    the same weights at capacity_factor E / top_k (no row dropped, checked)
    serving MOE_NODROP, held against the no-cache forward within 0.1; (b)
    serve_hold within 1e-3; (c) train_hold on the same 2-layer weights: the
    loss within 1e-4 relative, each gradient leaf within 1e-4 x its
    largest |g|."""
    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig

    cfg = get_config(MOE_ARCH)
    b, s, t = run["shape"]
    gen, kept = run["gen"], run["kept"]
    assert gen.shape == (b, t) and bool(((gen >= 0) & (gen < cfg.vocab)).all())
    assert kept.shape == (2, t + 1, cfg.vocab)
    assert bool(torch.isfinite(kept.float()).all()), "moe_serve: logits not finite"
    model = run["model"]
    run.clear()
    torch.cuda.empty_cache()

    nd = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    with RouteRecorder() as rec:
        run_nd = lm_serve(torch, nd, keep=[0, MOE_NODROP[0] - 1],
                          shape=MOE_NODROP, seed=2, model=model)
        d = lm_against_full_forward(torch, nd, run_nd)
    dropped = rec.dropped_rows()
    checks["moe_nodrop_rows_dropped"] = dropped
    checks["moe_nodrop_vs_full_forward"] = d
    queries["moe_nodrop"] = {"capacity_factor": nd.capacity_factor,
                             "route_calls": rec.calls, **run_nd["stats"]}
    assert dropped == 0, f"moe_nodrop: {dropped} rows dropped at C >= T"
    assert d <= 0.1, f"moe bf16: decode logits differ from the full forward by {d}"
    log(f"moe_nodrop ({nd.n_layers} layers, bf16, capacity factor "
        f"{nd.capacity_factor}): 0 rows dropped in {rec.calls} routings; max "
        f"|decode - full forward| = {d}")
    del model, run_nd
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    models = hold_models(torch, cfg)
    hold = serve_hold(torch, cfg, models)
    hold["s"] = round(time.perf_counter() - t0, 3)
    queries["moe_hold_f32_2l"] = hold
    checks["moe_f32_2l_forward_vs_cpu"] = hold["forward_max_abs"]
    checks["moe_f32_2l_served_vs_cpu"] = hold["served_max_abs"]
    assert max(hold["forward_max_abs"], hold["served_max_abs"]) <= 1e-3, hold
    log(f"moe hold (2 layers, float32, card against CPU): {hold}")

    # the train step's gradient through the dispatch (index_put), the
    # combine's gather and the routing recomputed under remat, against the
    # CPU's, as train_path holds the dense step
    t0 = time.perf_counter()
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    grad = train_hold(torch, cfg, ocfg, models)
    grad["s"] = round(time.perf_counter() - t0, 3)
    del models
    queries["moe_train_hold_f32_2l"] = grad
    checks["moe_f32_2l_grad_rel_vs_cpu"] = grad["grad_max_rel"]
    checks["moe_f32_2l_loss_rel_vs_cpu"] = grad["loss_rel"]
    checks["moe_f32_2l_after_rel_vs_cpu"] = grad["after_rel"]
    assert grad["grad_max_rel"] <= 1e-4, grad
    assert grad["loss_rel"] <= 1e-4 and grad["after_rel"] <= 1e-4, grad
    log(f"moe train hold (2 layers, float32, card against CPU): {grad}")
    torch.cuda.empty_cache()


def moe_train_path(torch, queries: dict, checks: dict):
    """deepseek-moe-16b at full width and MOE_TRAIN_LAYERS layers trained
    through launch/train.py's ``run`` (bf16, remat per block, n_micro
    DEFAULT_MICRO's 4) on a small token corpus: every loss finite, the
    first within 0.5 of ln V; the one checkpoint (at the end) restored into
    a fresh state, bitwise."""
    import math
    import shutil
    import tempfile

    from repro_torch.checkpoint import copy_into, restore
    from repro_torch.configs import get_config
    from repro_torch.data import synth
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import OptConfig, adamw

    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    micro = steps.DEFAULT_MICRO[cfg.name]
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    corpus = synth.token_corpus(MOE_TRAIN_DOCS, cfg.vocab)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_moe_train_")
    torch.cuda.empty_cache()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # ckpt_every past the last step: the driver's one save at the end
        res = train.run(cfg, ocfg, corpus, steps=MOE_TRAIN_STEPS,
                        batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ, micro=micro,
                        ckpt_dir=ckpt_dir, ckpt_every=MOE_TRAIN_STEPS + 1,
                        device="cuda", log_every=1)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        drv = res["driver"]
        losses = res["losses"]
        assert len(losses) == MOE_TRAIN_STEPS and all(map(math.isfinite, losses)), losses
        ln_v = math.log(cfg.vocab)
        assert abs(losses[0] - ln_v) <= 0.5, (losses[0], ln_v)
        step_s = float(np.median(drv.stats.times))
        tok_s = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / step_s
        rec = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.param_dtype,
               "remat": cfg.remat, "n_micro": micro, "batch": MOE_TRAIN_BATCH,
               "seq": MOE_TRAIN_SEQ, "steps": res["steps"],
               "params": cfg.param_count(),
               "active_params": cfg.active_param_count(),
               "pipeline_s": round(res["pipeline_s"], 3),
               "run_s": round(run_s, 3), "losses": losses,
               "step_ms": [round(x * 1e3, 3) for x in drv.stats.times],
               "step_median_ms": round(step_s * 1e3, 3),
               "tokens_per_s": round(tok_s, 1),
               "mfu_bf16": round(6 * cfg.active_param_count() * tok_s
                                 / BF16_OPS_PER_S, 4),
               "peak_gib": round(peak / 2**30, 3),
               "stragglers": res["stragglers"],
               "saves": [{k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in r.items()} for r in drv.saver.records]}
        log(f"moe_train: {rec}")

        # restore into a fresh state on the card, bitwise (the tree read
        # onto the host first: two states and a tree would not fit)
        fresh_model = lm.init_params(cfg, seed=1, device="cuda")
        fresh = {"params": fresh_model.tree(),
                 "opt": adamw.init_state(fresh_model.tree(), ocfg)}
        t0 = time.perf_counter()
        tree, step, meta = restore(ckpt_dir, fresh, device="cpu")
        copy_into(fresh, tree)
        torch.cuda.synchronize()
        rec["restore_s"] = round(time.perf_counter() - t0, 3)
        del tree
        assert step == MOE_TRAIN_STEPS and meta == {"arch": cfg.name}, (step, meta)
        differ = differing_bits(torch, fresh, drv.state)
        assert not differ, f"moe restore: entries differ {differ}"
        rec["restored_leaves"] = sum(1 for _ in lm.leaves(fresh))
        checks["moe_train_restore_bitwise"] = True
        del fresh, fresh_model, drv, res
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    queries["moe_train"] = rec


# The ssm and hybrid serving paths: falcon-mamba-7b (64 Mamba1 layers, d
# 4096, d_inner 8192, state 16, dt_rank 256, V 65024, chunk 256) and
# zamba2-7b (81 Mamba2 layers, d 3584, d_inner 7168, 112 SSD heads of 64,
# state 64, chunk 64; one shared attention + SwiGLU block of 32 heads of
# 112, ff 14336, after every 6 layers and after the tail: 14 applications;
# V 32000), as published, bf16, random weights from a seed: 8 requests of
# 2048 prompt tokens, then 64 greedy new tokens (max_seq 2112, the hybrid's
# 14 KV caches fill exactly).  After each path: two requests against the
# no-cache forward; one layer of the prefill timed beside its scan alone;
# the float32 holds (hold_cfg) against the CPU.
SSM_ARCHS = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-7b"}
SSM_BATCH, SSM_PROMPT, SSM_NEW = 8, 2048, 64
SSM_F32 = (2, 256, 8)            # the full-depth float32 serve: requests, prompt, new


def shared_applications(cfg) -> int:
    """The hybrid family's shared-block applications a forward (0 for any
    other family): one a group, one more after a tail."""
    from repro_torch.models import lm
    if cfg.family != "hybrid":
        return 0
    _, groups, tail = lm.shared_groups(cfg)
    return groups + (tail > 0)


def ssm_path(torch, queries: dict, runs: dict, family: str):
    """The ssm or hybrid serving path (see SSM_*); requests 0 and
    SSM_BATCH - 1 kept for the checks after the path."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(SSM_ARCHS[family])
    torch.cuda.empty_cache()
    run = lm_serve(torch, cfg, keep=[0, SSM_BATCH - 1],
                   shape=(SSM_BATCH, SSM_PROMPT, SSM_NEW))
    queries[f"{family}_serve"] = {
        "model": cfg.name, "layers": cfg.n_layers,
        "params": sum(int(np.prod(s)) for _, s in lm.leaves(lm.param_shapes(cfg))),
        "shared_applications": shared_applications(cfg),
        "requests": SSM_BATCH, "prompt_tokens": SSM_PROMPT,
        "new_tokens": SSM_NEW, **run["stats"]}
    log(f"{family}_serve: {queries[f'{family}_serve']}")
    runs[family] = run


def scan_profile(torch, cfg, model, prefill_ms: float) -> dict:
    """One Mamba layer at the prefill's shape (SSM_BATCH x SSM_PROMPT,
    bf16, a zero state as a prefill's), timed with CUDA events beside its
    scan alone (``ssm.selective_scan`` on that layer's inputs), the scan's
    bound, and the layers' share of the served prefill.  The bound: the
    scan's float32 inputs read once and y and h written once, against its
    operations (Mamba1: per (token, channel, state) the decay's product and
    exp, dBx's product, h's multiply-add and y's: 7; Mamba2, per (token,
    head, channel, state): dBx's product, h's and y's multiply-adds: 5) at
    the float32 rate."""
    from repro_torch.models import lm, ssm
    from repro_torch.models.layers import norm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    blk = model.blocks[0]
    x = torch.randn((SSM_BATCH, SSM_PROMPT, cfg.d_model), device=dev,
                    generator=gen).to(getattr(torch, cfg.compute_dtype))
    conv, h = ssm.ssm_state_shapes(cfg, SSM_BATCH)
    state = (torch.zeros(conv, dtype=x.dtype, device=dev),
             torch.zeros(h, dtype=torch.float32, device=dev))
    with torch.no_grad():
        layer_ms = time_ms(lambda: lm._mamba_block(blk, x, cfg, state=state), torch)
        args = ssm.scan_inputs(blk.mamba, norm(x, blk.ln1, cfg), cfg, state)[3]
        scan_ms = time_ms(lambda: ssm.selective_scan(cfg, *args), torch)
    xs, h0 = args[0], args[5]
    read = sum(4.0 * a.numel() for a in args)
    ops = (7 if cfg.mamba_version == 1 else 5) * xs.numel() * cfg.ssm_state
    bound, by = bound_ms(read + 4.0 * (xs.numel() + h0.numel()), ops)
    return {"layer_ms": layer_ms, "scan_ms": scan_ms,
            "scan_share_of_layer": scan_ms / layer_ms,
            "layers_share_of_prefill": cfg.n_layers * layer_ms / prefill_ms,
            "scan_bound_ms": bound, "scan_bound_by": by,
            "scan_of_bound": bound / scan_ms,
            "shape": f"x ({SSM_BATCH}, {SSM_PROMPT}, {cfg.d_model}) "
                     f"{cfg.compute_dtype}, chunk {cfg.ssm_chunk}"}


def forward_noise(torch, cfg, run: dict) -> float:
    """The no-cache forward against itself: the kept requests' logits at
    the prompt's last position from a forward over the prompt alone and
    from one over prompt + generated tokens (the same tokens and weights;
    only the shapes of the GEMMs and of the attention differ): their
    largest absolute difference, the bf16 forward's own noise."""
    from repro_torch.models import lm

    keep = run["keep"]
    s = run["shape"][1]
    seq = torch.cat([run["tokens"][keep], run["gen"][keep]], 1)
    with torch.no_grad():
        short = lm.forward(run["model"], seq[:, :s], cfg)[0][:, s - 1]
        full = lm.forward(run["model"], seq, cfg)[0][:, s - 1]
    return float((short.float() - full.float()).abs().max())


def ssm_checks(torch, run: dict, queries: dict, checks: dict, family: str):
    """After the counted ssm or hybrid path: (a) its bf16 logits against
    the no-cache forward within 0.1, or within twice the no-cache forward's
    own noise (``forward_noise``) where that is larger: zamba2-7b's bf16
    forward differs from itself by more than 0.1 at two lengths (PERF.md
    §6), so (a') the same weights' widths and depth in float32
    serve SSM_F32 against their no-cache forward within 1e-3; the scan's
    profile; (b) serve_hold within 1e-3; (c) train_hold on the same
    weights (remat as trained): the loss within 1e-4 relative, each
    gradient leaf within 1e-4 x its largest |g|."""
    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig

    cfg = get_config(SSM_ARCHS[family])
    d = lm_against_full_forward(torch, cfg, run)
    noise = forward_noise(torch, cfg, run)
    bound = max(0.1, 2 * noise)
    checks[f"{family}_bf16_vs_full_forward"] = d
    checks[f"{family}_bf16_full_forward_noise"] = noise
    assert d <= bound, f"{family} bf16: decode logits differ from the full " \
        f"forward by {d} (bound {bound}: the forward's own noise {noise})"
    log(f"{family} bf16, {cfg.n_layers} layers: max |decode - full forward| = "
        f"{d}; the no-cache forward against itself {noise}")
    prof = scan_profile(torch, cfg, run["model"],
                        queries[f"{family}_serve"]["prefill_ms"])
    queries[f"{family}_scan"] = prof
    log(f"{family} scan (one layer of the prefill): {prof}")
    run.clear()
    torch.cuda.empty_cache()

    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    run32 = lm_serve(torch, c32, keep=[0, SSM_F32[0] - 1], seed=1, shape=SSM_F32)
    d = lm_against_full_forward(torch, c32, run32)
    checks[f"{family}_f32_full_depth_vs_full_forward"] = d
    queries[f"{family}_serve_f32"] = run32["stats"]
    assert d <= 1e-3, f"{family} float32: decode logits differ from the full forward by {d}"
    log(f"{family} float32, {cfg.n_layers} layers: max |decode - full forward| = "
        f"{d}; {run32['stats']}")
    run32.clear()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    models = hold_models(torch, cfg)
    hold = serve_hold(torch, cfg, models)
    hold["s"] = round(time.perf_counter() - t0, 3)
    queries[f"{family}_hold_f32"] = hold
    checks[f"{family}_f32_forward_vs_cpu"] = hold["forward_max_abs"]
    checks[f"{family}_f32_served_vs_cpu"] = hold["served_max_abs"]
    assert max(hold["forward_max_abs"], hold["served_max_abs"]) <= 1e-3, hold
    log(f"{family} hold (float32, card against CPU): {hold}")

    t0 = time.perf_counter()
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    grad = train_hold(torch, cfg, ocfg, models)
    grad["s"] = round(time.perf_counter() - t0, 3)
    del models
    queries[f"{family}_train_hold_f32"] = grad
    checks[f"{family}_f32_grad_rel_vs_cpu"] = grad["grad_max_rel"]
    checks[f"{family}_f32_loss_rel_vs_cpu"] = grad["loss_rel"]
    checks[f"{family}_f32_after_rel_vs_cpu"] = grad["after_rel"]
    assert grad["grad_max_rel"] <= 1e-4, grad
    assert grad["loss_rel"] <= 1e-4 and grad["after_rel"] <= 1e-4, grad
    log(f"{family} train hold (float32, card against CPU): {grad}")
    torch.cuda.empty_cache()



# The vlm and encdec serving paths.  vlm: qwen2-vl-2b as published (28
# layers, d 1536, 12 query heads over 2 KV heads of 128, ff 8960, V 151936,
# qkv_bias, tied embeddings, M-RoPE sections (16, 24, 24), theta 1e6; bf16,
# random weights from a seed) serves 16 requests of 2048 prompt positions:
# 64 + 16 r text tokens (rows of its own embedding), one 32 x 32 grid of
# 1024 visual tokens (an 896 x 896 image at 14-pixel patches merged 2 x 2;
# N(0, 0.02) rows from a seed: the vision tower is a stub), then text, at
# Qwen2-VL's rope index; then 128 greedy new tokens (max_seq 2176).
# encdec: whisper-base as published (6 + 6 layers, d 512, 8 heads of 64, ff
# 2048, V 51865, 1500 frames; bf16, random weights from a seed) serves 32
# requests of 1500 seeded frame embeddings (30 s of audio each; the conv
# frontend a stub) behind the 4-token start-of-transcript prompt, then 124
# greedy new tokens (max_seq 128).  After each path: two requests against
# the no-cache forward; the float32 holds against the CPU.
VLM_ARCH = "qwen2-vl-2b"
VLM_BATCH, VLM_PROMPT, VLM_NEW, VLM_GRID = 16, 2048, 128, 32
VLM_HOLD = (2, 128, 8, 8)        # requests, prompt positions, image grid, new tokens
ENC_ARCH = "whisper-base"
ENC_BATCH, ENC_PROMPT, ENC_NEW = 32, 4, 124
ENC_SOT = (50258, 50259, 50359, 50363)   # start of transcript, en, transcribe,
#                                          no timestamps
ENC_HOLD = (2, 24, 8)            # requests, prompt tokens, new tokens
MM_ARCHS = {"vlm": VLM_ARCH, "encdec": ENC_ARCH}


def rope_index(n_before: int, grid: int, n: int) -> np.ndarray:
    """(3, n) int32 Qwen2-VL positions (arXiv:2409.12191 §2.1) of a prompt
    of n_before text tokens, a grid x grid image, then text: text counts up
    on all three streams, an image token at (row, col) is (t, h, w) =
    (start, start + row, start + col), and the text after it resumes at
    start + grid."""
    pos = np.empty((3, n), np.int32)
    pos[:, :n_before] = np.arange(n_before)
    row, col = np.divmod(np.arange(grid * grid), grid)
    img = slice(n_before, n_before + grid * grid)
    pos[0, img] = n_before
    pos[1, img] = n_before + row
    pos[2, img] = n_before + col
    pos[:, img.stop:] = n_before + grid + np.arange(n - img.stop)
    return pos


def vlm_batch(torch, cfg, model, b: int, s: int, grid: int, dev, seed: int,
              text0: int, step: int) -> dict:
    """The vlm prefill's batch on ``dev``: request r's ``text0 + step r``
    text tokens, a grid x grid image and text after it, as ``inputs_embeds``
    (text: rows of ``model``'s embedding of numpy token ids; image: N(0,
    0.02) numpy draws) and ``positions`` (``rope_index``)."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    n_img = grid * grid
    img = torch.from_numpy(rng.normal(0, 0.02, (b, n_img, cfg.d_model)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        emb = torch.nn.functional.embedding(toks.to(dev), model.embed)
    pos = np.empty((3, b, s), np.int32)
    for r in range(b):
        n0 = text0 + step * r
        emb[r, n0:n0 + n_img] = img[r]
        pos[:, r] = rope_index(n0, grid, s)
    return {"inputs_embeds": emb, "positions": torch.from_numpy(pos).to(dev)}


def encdec_batch(torch, cfg, b: int, s: int, dev, seed: int) -> dict:
    """The encdec prefill's batch on ``dev``: N(0, 1) numpy frame embeddings
    (b, F, d) in the compute dtype and prompts of s tokens, ENC_SOT then
    numpy draws."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.enc_frames, cfg.d_model), dtype=np.float32)
    toks = np.concatenate([np.tile(ENC_SOT, (b, 1)),
                           rng.integers(0, cfg.vocab, (b, max(s - len(ENC_SOT), 0)))],
                          1)[:, :s]
    return {"frames": torch.from_numpy(frames).to(dev).to(
                getattr(torch, cfg.compute_dtype)),
            "tokens": torch.from_numpy(toks.astype(np.int32)).to(dev)}


def mm_path(torch, queries: dict, runs: dict, family: str):
    """The vlm or encdec serving path (see VLM_* and ENC_*); the first and
    last requests kept for the checks after the path."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm, whisper

    dev = torch.device("cuda")
    cfg = get_config(MM_ARCHS[family])
    torch.cuda.empty_cache()
    if family == "vlm":
        shape = (VLM_BATCH, VLM_PROMPT, VLM_NEW)
        model = lm.init_params(cfg, seed=0, device=dev)
        batch = vlm_batch(torch, cfg, model, VLM_BATCH, VLM_PROMPT, VLM_GRID,
                          dev, seed=0, text0=64, step=16)
        shapes = lm.param_shapes(cfg)
    else:
        shape = (ENC_BATCH, ENC_PROMPT, ENC_NEW)
        model = whisper.init_params(cfg, seed=0, device=dev)
        batch = encdec_batch(torch, cfg, ENC_BATCH, ENC_PROMPT, dev, seed=0)
        shapes = whisper.param_shapes(cfg)
    run = lm_serve(torch, cfg, keep=[0, shape[0] - 1], shape=shape, model=model,
                   batch=batch)
    queries[f"{family}_serve"] = {
        "model": cfg.name, "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
        "params": sum(int(np.prod(v)) for _, v in lm.leaves(shapes)),
        "requests": shape[0], "prompt_positions": shape[1],
        "enc_frames": cfg.enc_frames if family == "encdec" else 0,
        "new_tokens": shape[2], **run["stats"]}
    log(f"{family}_serve: {queries[f'{family}_serve']}")
    runs[family] = run


def hold_inputs(torch, c, model, dev) -> tuple:
    """The float32 holds' prompt batch on ``dev`` (the vlm family: VLM_HOLD's
    requests of 16 + 8 r text tokens, an 8 x 8 image, then text; the
    encdec family: ENC_HOLD's frames and prompt tokens) and the tokens
    decoded after it, (requests, new tokens) from numpy."""
    if c.family == "vlm":
        b, s, grid, t = VLM_HOLD
        batch = vlm_batch(torch, c, model, b, s, grid, dev, seed=5, text0=16, step=8)
    else:
        b, s, t = ENC_HOLD
        batch = encdec_batch(torch, c, b, s, dev, seed=5)
    feed = np.random.default_rng(6).integers(0, c.vocab, (b, t)).astype(np.int32)
    return batch, torch.from_numpy(feed).to(dev)


def mm_hold(torch, cfg, models) -> dict:
    """``hold_cfg(cfg)`` in float32 (TF32 off) on the card and on the CPU
    from the same weights and inputs (``hold_inputs``): the largest logit
    difference of a no-cache forward over the prompt and the fed tokens
    (``full_forward``), and of a prefill of the prompt followed by the fed
    tokens one by one."""
    from repro_torch.launch import steps

    c = hold_cfg(cfg)
    out = {}
    for name, model in zip(("cpu", "cuda"), models):
        batch, feed = hold_inputs(torch, c, model, torch.device(name))
        b, t = feed.shape
        s = batch["tokens" if c.family == "encdec" else "positions"].shape[-1]
        with torch.no_grad():
            full = full_forward(torch, c, model, batch, list(range(b)), feed)
            logits, caches = steps.make_prefill_step(c, s + t)(model, batch)
            served = [logits]
            for i in range(t):
                logits, caches = steps.make_decode_step(c)(model, feed[:, i:i + 1],
                                                           caches)
                served.append(logits)
        out[name] = (full.cpu(), torch.stack(served, 1).cpu())
    (fc, sc), (fg, sg) = out["cpu"], out["cuda"]
    return {"forward_max_abs": float((fg - fc).abs().max()),
            "served_max_abs": float((sg - sc).abs().max()),
            "served_vs_forward_cpu": float((sc - fc[:, -t - 1:]).abs().max()),
            "logit_scale": float(fc.abs().max())}


def mm_checks(torch, run: dict, queries: dict, checks: dict, family: str):
    """After the counted vlm or encdec path: (a) its bf16 logits against the
    no-cache forward within 0.1; (b) ``mm_hold`` within 1e-3 (the vlm family
    at 2 layers, the encdec family at full depth, both at full width); (c)
    ``train_hold`` on the same weights (remat per block as trained; the vlm
    family on TRAIN_HOLD's positions): the loss within 1e-4 relative, each
    gradient leaf within 1e-4 x its largest |g|."""
    from repro_torch.configs import get_config
    from repro_torch.optim import OptConfig

    cfg = get_config(MM_ARCHS[family])
    d = lm_against_full_forward(torch, cfg, run)
    checks[f"{family}_bf16_vs_full_forward"] = d
    assert d <= 0.1, f"{family} bf16: decode logits differ from the full forward by {d}"
    log(f"{family} bf16, {cfg.n_layers} layers: max |decode - full forward| = {d}")
    run.clear()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    models = hold_models(torch, cfg)
    hold = mm_hold(torch, cfg, models)
    hold["s"] = round(time.perf_counter() - t0, 3)
    queries[f"{family}_hold_f32"] = hold
    checks[f"{family}_f32_forward_vs_cpu"] = hold["forward_max_abs"]
    checks[f"{family}_f32_served_vs_cpu"] = hold["served_max_abs"]
    assert max(hold["forward_max_abs"], hold["served_max_abs"],
               hold["served_vs_forward_cpu"]) <= 1e-3, hold
    log(f"{family} hold (float32, card against CPU): {hold}")

    def batch_of(model, dev):
        """The train hold's batch: TRAIN_HOLD's positions with a 4 x 4 image
        (vlm), ENC_HOLD's frames and prompt (encdec); numpy labels."""
        c = hold_cfg(cfg)
        if family == "vlm":
            n, s = TRAIN_HOLD
            batch = vlm_batch(torch, c, model, n, s, 4, dev, seed=7, text0=16, step=8)
        else:
            n, s = ENC_HOLD[:2]
            batch = encdec_batch(torch, c, n, s, dev, seed=7)
        labels = np.random.default_rng(17).integers(0, cfg.vocab, (n, s))
        return dict(batch, labels=torch.from_numpy(labels.astype(np.int32)).to(dev))

    t0 = time.perf_counter()
    ocfg = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_SCHEDULE)
    grad = train_hold(torch, cfg, ocfg, models, batch_of=batch_of)
    grad["s"] = round(time.perf_counter() - t0, 3)
    del models
    queries[f"{family}_train_hold_f32"] = grad
    checks[f"{family}_f32_grad_rel_vs_cpu"] = grad["grad_max_rel"]
    checks[f"{family}_f32_loss_rel_vs_cpu"] = grad["loss_rel"]
    checks[f"{family}_f32_after_rel_vs_cpu"] = grad["after_rel"]
    assert grad["grad_max_rel"] <= 1e-4, grad
    assert grad["loss_rel"] <= 1e-4 and grad["after_rel"] <= 1e-4, grad
    log(f"{family} train hold (float32, card against CPU): {grad}")
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", metavar="DIR", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    try:
        from repro_torch import hiframes as hf
        from repro_torch.configs import get_config
        from repro_torch.data import synth
        from repro_torch.kernels import cuda
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 3

    # phase 1: report and build
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # one nvcc per source, all started now; each kernel's first call waits
    # for its own library, so phase 2 runs while the longest one compiles
    t_build = time.perf_counter()
    cuda.start_builds(force=True, verbose=args.quick)
    log(f"kernel build: started {len(cuda.SOURCES)} sources")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # phase 2: kernels against their plain versions
    sizes = [0, 1, 2047, 2048, 2049, 1_000_003]
    if not args.quick:
        sizes.append(1 << 27)
    record: dict = {}
    kernel_phases(torch, sizes, record)
    ptxas = cuda.finish_builds()
    log(f"kernel build: every source built within "
        f"{time.perf_counter() - t_build:.1f} s of the start")
    if args.quick:
        log(ptxas)
    # the process's first profiler sessions, back to back (later windows
    # may hold no device event)
    profiled = one_call_profiles(torch, sizes[-2])
    t0 = time.perf_counter()
    da_device = decode_attention_device_times(torch)
    da_s = time.perf_counter() - t0
    window_kernel_phases(torch, sizes, record)
    t0 = time.perf_counter()
    decode_attention_phases(torch, record, da_device)
    decode_attention_sharded_phases(torch, record, da_device)
    log(f"decode_attention phases: {da_s:.1f} s of device-time windows, "
        f"{time.perf_counter() - t0:.1f} s of holds and timing")
    for name, seen in profiled.items():
        record[name]["one_call"] = seen
    torch.cuda.synchronize()
    for r in record.values():
        log(f"{r['name']} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']})")

    queries: dict = {}
    checks: dict = {}
    if not args.quick:
        # phase 3: the main paths, each with the counters zeroed just
        # before it and read just after
        if args.profile:
            os.makedirs(args.profile, exist_ok=True)
        # kernels each path must launch: None for at least once, a number
        # for exactly that many (the LM path: one per layer and decode step)
        lm_runs: dict = {}
        moe_cfg = get_config(MOE_ARCH)
        hybrid_cfg = get_config(SSM_ARCHS["hybrid"])
        paths = {
            "relational": (lambda: main_path(torch, hf, synth, queries,
                                             args.profile, checks),
                           dict.fromkeys(("prefix_sum", "segment_sums"))),
            "windows": (lambda: window_path(torch, hf, synth, queries,
                                            args.profile, checks),
                        dict.fromkeys(("prefix_sum", "segment_scan",
                                       "segment_rank", "stencil1d",
                                       "stencil1d_exact", "segment_stencil"))),
            "sort": (lambda: sort_path(torch, hf, synth, queries,
                                       args.profile, checks),
                     dict.fromkeys(("prefix_sum", "segment_sums",
                                    "stencil1d"))),
            "frame": (lambda: frame_path(torch, hf, synth, queries,
                                         args.profile, checks),
                      dict.fromkeys(("prefix_sum", "segment_sums"))),
            "segmentation": (lambda: segmentation_path(
                torch, hf, synth, queries, args.profile, checks),
                dict.fromkeys(("prefix_sum", "segment_sums",
                               "segment_rank"))),
            "guardrails": (lambda: guardrails_path(torch, hf, synth,
                                                   queries, checks),
                           dict.fromkeys(("prefix_sum", "segment_sums"))),
            "serve": (lambda: serve_path(torch, hf, synth, queries, checks),
                      dict.fromkeys(("prefix_sum", "segment_sums"))),
            # counted in its ranks (each must launch bucket_scatter) and
            # summed over them; Q26's sums are integer (no segment_sums)
            "exchange_p2": (lambda: exchange_path(torch, queries),
                            dict.fromkeys(("bucket_scatter", "prefix_sum"))),
            # counted in its ranks (each must launch both in its token
            # pipeline at P = 2) and summed over them
            "dp_train": (lambda: dp_train_path(torch, queries, checks, lm_runs),
                         dict.fromkeys(("prefix_sum", "bucket_scatter"))),
            # run in dp_train's ranks (counted there, summed over them): the
            # token pipeline's kernels in each rank's bf16 run
            "tp_train": (lambda: tp_train_path(torch, queries, checks, lm_runs),
                         dict.fromkeys(("prefix_sum", "bucket_scatter"))),
            # run in dp_train's ranks (counted there, summed over them): a
            # partial and a merge a layer and decode step, a bucket_scatter
            # a MoE layer in the prefill and each decode step
            "tp_serve": (lambda: tp_serve_path(torch, queries, checks, lm_runs),
                         {k: TP_MODEL * n for k, n in tp_expected_launches().items()}),
            "lm": (lambda: lm_path(torch, queries, lm_runs),
                   {"decode_attention": get_config(LM_ARCH).n_layers * LM_NEW}),
            # the pipeline's filter, cumsum and aggregate; the train steps
            # run no hand-written kernel (no cache, no Pallas in the step)
            "train": (lambda: train_path(torch, queries, checks, args.profile),
                      dict.fromkeys(("prefix_sum",))),
            # one decode_attention a layer and decode step; one bucket_scatter
            # a MoE layer in the prefill and in each decode step
            "moe": (lambda: moe_path(torch, queries, lm_runs),
                    {"decode_attention": moe_cfg.n_layers * MOE_NEW,
                     "bucket_scatter": (moe_cfg.n_layers
                                        - moe_cfg.first_dense_layers)
                     * (1 + MOE_NEW)}),
            # the pipeline and the MoE layers' routing (twice a micro-batch
            # with remat: forward and recomputation); no decode
            "moe_train": (lambda: moe_train_path(torch, queries, checks),
                          dict.fromkeys(("prefix_sum", "bucket_scatter"))),
            # no hand-written kernel on the ssm path: an attention-free model
            "ssm": (lambda: ssm_path(torch, queries, lm_runs, "ssm"),
                    {"decode_attention": 0}),
            # one decode_attention a shared application and decode step
            "hybrid": (lambda: ssm_path(torch, queries, lm_runs, "hybrid"),
                       {"decode_attention": shared_applications(hybrid_cfg)
                        * SSM_NEW}),
            # one decode_attention a layer and decode step
            "vlm": (lambda: mm_path(torch, queries, lm_runs, "vlm"),
                    {"decode_attention": get_config(VLM_ARCH).n_layers * VLM_NEW}),
            # two a decoder layer and decode step: self and cross-attention
            "encdec": (lambda: mm_path(torch, queries, lm_runs, "encdec"),
                       {"decode_attention": 2 * get_config(ENC_ARCH).n_layers
                        * ENC_NEW})}
        launched = {}
        for path, (drive, must) in paths.items():
            t0 = time.perf_counter()
            cuda.reset_launches()
            counted = drive()
            torch.cuda.synchronize()
            launched[path] = counted or dict(cuda.launches)
            log(f"{path} path: {time.perf_counter() - t0:.1f} s, launches "
                f"{launched[path]}")
            for name, count in must.items():
                assert count == 0 or launched[path][name] > 0, \
                    f"{name} never launched on the {path} path"
                assert count is None or launched[path][name] == count, \
                    f"{name}: {launched[path][name]} launches on the {path} " \
                    f"path, expected {count}"
            if path == "lm":
                t0 = time.perf_counter()
                lm_checks(torch, lm_runs["lm"], queries, checks, args.profile)
                log(f"lm checks: {time.perf_counter() - t0:.1f} s")
            elif path == "moe":
                t0 = time.perf_counter()
                moe_checks(torch, lm_runs["moe"], queries, checks)
                log(f"moe checks: {time.perf_counter() - t0:.1f} s")
            elif path in SSM_ARCHS:
                t0 = time.perf_counter()
                ssm_checks(torch, lm_runs[path], queries, checks, path)
                log(f"{path} checks: {time.perf_counter() - t0:.1f} s")
            elif path in MM_ARCHS:
                t0 = time.perf_counter()
                mm_checks(torch, lm_runs[path], queries, checks, path)
                log(f"{path} checks: {time.perf_counter() - t0:.1f} s")
        for path in ("train", "moe_train", "dp_train", "tp_train"):
            assert launched[path]["decode_attention"] == 0, launched[path]
        log(f"checks (max abs diff; bitwise): {checks}")
        for r in record.values():
            by_path = {p: c[r["name"]] for p, c in launched.items()}
            r["launches"] = sum(by_path.values())
            r["launches_by_path"] = by_path
    assert "jax" not in sys.modules and "repro" not in sys.modules

    # phase 4: report
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kern = [{**{k: r.get(k) for k in keys},
             **{k: v for k, v in r.items() if k not in keys}}
            for r in record.values()]
    log(json.dumps({"queries": queries, "checks": checks, "card": smi}))
    log(json.dumps({"kernels": kern}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
