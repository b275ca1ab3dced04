#!/usr/bin/env python3
"""Smoke test of spark_rapids_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from the checkout (one nvcc per source,
all at once), holds each kernel against its plain PyTorch twin on the card,
runs the engine's main query through a session at 16,777,216 fact rows, the
benchmark step at bench.py's shapes, the main query again under the
distributed plan (partial aggregate -> key exchange over a 4-position mesh
-> per-shard final aggregate), and three string-keyed star-schema reports
(TPC-DS q3/q7/q36 shapes over 16,777,216 sales and SF10 dimensions) on one
device and Q7 under the distributed plan, and then the parquet scan: the
fact table written by pyarrow (row groups of 1,048,576, snappy and
uncompressed) decoded on the card and held against pq.read_table, the
engine query through read_parquet on both plans (in turns with the Arrow,
no-pruning and host-decode forms of it, and at 1 row group a dispatch,
without the scan's prefetch thread, and with neither) and star Q7 from
parquet files, and last the star reports over TPC-DS's own column types
(every money column decimal(7,2), written as FIXED_LEN_BYTE_ARRAY) from
parquet on one device and distributed, exact against an int64 oracle, and
over the same files the reports in TPC-DS's ORDER BY ... LIMIT 100 (top-k;
Q36 with its ROLLUP, ranked by a window), q51's running window over the 16.76 M
per-(item, date) quantities, and their out-of-core sort under the
distributed plan, and last the joins of TPC-DS q97 (a full outer join whose
8.39 M-row build side takes the sub-partition join), q10 (existence joins),
q58 (string keys with conditions) and q28 (cross joins) over store,
catalog and web sales and their SF10 dimensions from parquet, both plans,
the TPC-DS aggregates q65 and q39, and the decimal star's first 4,194,304
sales in seven more file forms (zstd, gzip, columns pyarrow decodes, v2
pages, lz4, 64 files under each reader strategy, a row filter) read by Q3
and Q7 with the scan's counters held to their predictions, the decimal
star, q65, q39a and q58 under ANSI mode, and last the memory layer: 1 GiB
through the spill catalog under each codec, the running window, the
out-of-core sort, q97 and the distributed engine query at the session's
memory budget and at a tight one (spills to host and disk, results equal)
and injected OOMs, and last the host engine: decimal star Q7 with every
parquet scan on the host (both plans), ordered Q7 with a cast the device
refuses on the host between device stages (both plans), and the engine
query with spark.rapids.sql.enabled=false, each beside the same query on
the card, and then the strings: TPC-DS q23's frequent items, a text report
and LIKE/RLIKE over item's descriptions, the long-string layout, and last
the rest of the string functions and the casts from and to STRING (TPC-DS
q21 with its date window cast from string literals, a formatted store
report, and a parse of sales staged as text, under ANSI too), and the plan
nodes and planner passes of slice 17 (TPC-DS q28 with its predicates
pushed into the parquet decode, an aggregate-only report pushed whole, a
year's window of sales sorted by date pruned by the footer statistics, a
sample, a range and the cost-based optimizer's placements); it checks
each against numpy oracles, holds kernels A and C to their exact launch
counts there, and holds them against their twins on the inputs those paths
hand them (a merged batch of 4 row groups). Each phase prints one JSON
line; then a `kernels` line, the card's `nvidia-smi` name and power limit,
and last `{"ok": true, "device": {...}}`. Any failure exits non-zero
without that last line. Without CUDA (or without the package beside this
file) it exits 2 and prints no result. It imports nothing of JAX.

Kernel times are device times from CUDA events (see time_ms), the median
of 10 rounds after warm-up, back to back on one input. Kernel B is also
timed cold, over 4 copies of its input in turns (201 MB, 4x the L2), and
per CUDA kernel from a torch.profiler trace; its bound share is taken from
the cold time. Each query's warm collect() is timed
WALL_ROUNDS times with pallas.mode auto and off in turns, each star
report's STAR_ROUNDS times with pallas.mode auto, and the bench step
WALL_ROUNDS times with CUDA events; each is reported as its median, min
and max, and each star report's device idle share comes from one traced
collect; the ordered reports, the running window and the out-of-core
sort are timed ORDERED_ROUNDS times each, with the sort's host merge
seconds beside its wall, and the join queries JOINS_ROUNDS times each,
with q97's device idle share from one traced collect; each parquet_files
form's Q3 and Q7 collects (Q3 alone for the 64 lz4 files' reader
strategies) are timed FILES_ROUNDS times after the checked one, beside
the snappy files'. A query's first collect is its checked, counted one,
and warms it up for the timed ones. Bounds are bytes moved (each input
read once, each output written once) over the H100's published memory
rate. Launch counts are read per path: every count is set to 0 just
before a run of the path and read just after.

The star, decimal star, join and aggregate tables, their numpy oracles and
their parquet files are made on the host in two worker processes
(start_data) while the card runs the phases before them; the workers end
with the run.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np

# fact/dim shapes of the engine query and the bench step (bench.py:42-46)
QUERY_FACT_ROWS = 16_777_216
N_FACT = 4_194_304
N_DIM = 65_536
N_GROUPS = 1_024
KEY_SPACE = 131_072
K_STEPS = 8
# the round counts below were cut to keep the whole script near half of
# its 1,200 s limit with the parquet_files phase (slice 10): WALL_ROUNDS
# from 11 to 5, STAR_ROUNDS from 5 to 1, DECODE_ROUNDS from 5 to 1,
# PARQUET_ROUNDS from 7 to 1, ORDERED_ROUNDS, JOINS_ROUNDS and AGG_ROUNDS
# from 3 to 1; no size changed. Slice 15 cut parquet_files' depth: its
# seven forms hold the first 4,194,304 sales, not 16,777,216
# (FILES_SALES_ROWS; the phase took 240-319 s and the script 902-1,048 s
# of its 1,200 s before the strings_ext phase was added)
WALL_ROUNDS = 5
MESH_POSITIONS = 4
H100_BYTES_PER_S = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def hbm_rate(name: str) -> float:
    if "H100" not in name:
        raise RuntimeError(f"no memory rate on record for {name!r}; "
                           "the bounds are for an H100")
    return H100_BYTES_PER_S


def spread(xs) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def time_ms(torch, fn, warmup: int = 3, rounds: int = 10,
            calls: int = 20) -> float:
    """Device time of one call: the median over `rounds` of the CUDA-event
    time of `calls` back-to-back calls, divided by `calls`. A sleep kernel
    queued ahead of each round keeps the card busy while the host enqueues
    the round, so the events time the card's work and not the host's
    launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms of spinning at 2 GHz
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_busy_s(torch, prof) -> float:
    """Seconds in which the card ran a kernel or a copy, from a
    torch.profiler trace: the union of the device events' intervals. The
    trace's raw events are read: prof.events() builds a Python event tree
    first, which took seconds for the tens of thousands of events of one
    collect."""
    spans = sorted((e.start_ns(), e.end_ns()) for e in
                   prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e9


def idle_share(torch, fn) -> float:
    """The card's idle share of one traced call of fn (which ends in a
    synchronize): 1 - device busy time / wall time. Only the card's
    activity is traced: the host's operator events are not read, and
    recording them slowed the call and the trace's processing."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_s(torch, prof)
    if busy <= 0.0:
        raise AssertionError("the trace of a collect holds no device event")
    return 1.0 - busy / wall


def rotating(fn, copies):
    """A call of fn on the argument tuples of `copies` in turn. With copies
    that together hold three L2 caches or more, each call reads its inputs
    from device memory, as a caller that streams fresh data does."""
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def first_call_args(torch, module, name: str, fn) -> tuple:
    """Run fn() with `module.<name>` (a kernel wrapper the path calls through
    its module) wrapped, and return copies of the arguments of its first
    call: the inputs the path gives the kernel. The wrapper counts its
    launches through its module name, so the stand-in carries the count
    and hands it back."""
    real, seen = getattr(module, name), []

    def keep(*args):
        if not seen:
            seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return real(*args)

    keep.launches = real.launches
    setattr(module, name, keep)
    try:
        fn()
    finally:
        setattr(module, name, real)
        real.launches = keep.launches
    if not seen:
        raise AssertionError(f"{name} was not called")
    return seen[0]


def fused_joins(plan: str) -> int:
    """The broadcast joins inside the fused stages of an explain() tree.
    Kernel A runs twice per fused join per probe batch."""
    return sum(ln.count("BroadcastHashJoin[") for ln in plan.splitlines()
               if "TpuFusedStageExec" in ln)


def murmur3_on_path(torch, args, rate: float, **where) -> dict:
    """Kernel A on the arguments a path handed it: bit for bit against its
    plain twin and against itself on repeat, then timed there. Raises on
    any difference; returns the phase's record (`where` names the path)."""
    from spark_rapids_tpu_torch.ops.pallas_probe import (murmur3_rows,
                                                         murmur3_rows_plain)
    got, again = murmur3_rows(*args), murmur3_rows(*args)
    err = int((got.to(torch.int64) - murmur3_rows_plain(*args)
               .to(torch.int64)).abs().max())
    if err != 0 or not torch.equal(got, again):
        raise AssertionError(f"murmur3_rows differs from its plain twin on "
                             f"the keys of {where} by up to {err}")
    return dict(where, rows=args[0].shape[0], key_dtype=str(args[0].dtype),
                live_rows=int(args[1].sum()), bit_identical_to_plain=True,
                max_abs_err=err,
                ms=time_ms(torch, lambda: murmur3_rows(*args)),
                plain_ms=time_ms(torch, lambda: murmur3_rows_plain(*args)),
                bound_ms=args[0].shape[0] * (
                    sum(t.element_size() for t in args) + 4) / rate * 1e3)


def i64_err(torch, got, plain) -> float:
    """Largest |got - plain| of two int64 results, as a double. The wrapped
    int64 difference is 0 exactly where the two agree, and a non-zero
    int64 never rounds to 0.0 as a double."""
    if got.numel() == 0:
        return 0.0
    return float((got - plain).to(torch.float64).abs().max())


def segsum_i64_on_path(torch, args, rate: float, **where) -> dict:
    """Kernel C on the arguments a path handed it, as murmur3_on_path does
    for A, with the library call's time beside it: index_add_ into the
    groups, any id outside [0, groups) sent to one spare slot (index_add_
    raises on them)."""
    from spark_rapids_tpu_torch.ops.pallas_groupby import (
        segment_sum_i64, segment_sum_i64_plain)
    vals, ids, groups = args
    got, again = segment_sum_i64(*args), segment_sum_i64(*args)
    err = i64_err(torch, got, segment_sum_i64_plain(*args))
    if err != 0 or not torch.equal(got, again):
        raise AssertionError(f"segment_sum_i64 differs from its plain twin "
                             f"on the values of {where} by up to {err}")
    in_range = (ids >= 0) & (ids < groups)
    lib_ids = torch.where(in_range, ids, groups).to(torch.int64)
    return dict(where, rows=vals.shape[0], groups=groups,
                id_dtype=str(ids.dtype),
                ids_out_of_range=int((~in_range).sum()),
                groups_nonzero=int((got != 0).sum()),
                sum_of_values=int(got.sum()), bit_identical_to_plain=True,
                max_abs_err=err,
                ms=time_ms(torch, lambda: segment_sum_i64(*args)),
                plain_ms=time_ms(torch,
                                 lambda: segment_sum_i64_plain(*args)),
                library_ms=time_ms(torch, lambda: torch.zeros(
                    groups + 1, dtype=torch.int64,
                    device=vals.device).index_add_(0, lib_ids, vals)),
                bound_ms=(vals.shape[0] * (vals.element_size()
                                           + ids.element_size())
                          + groups * 8) / rate * 1e3)


def cuda_kernel_ms(torch, fn, calls: int = 20) -> dict:
    """Device time that each CUDA kernel of one call of fn adds: the median
    over `calls` calls, by kernel name, from a torch.profiler trace. A
    kernel counts from the later of its start and the end of the kernels
    before it to its own end, since a kernel launched as a programmatic
    dependent starts its blocks before the kernel before it has ended."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per, busy_to = {}, None
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        start, end = e.time_range.start, e.time_range.end
        own = end - (start if busy_to is None else max(start, busy_to))
        busy_to = end if busy_to is None else max(busy_to, end)
        # "void (anonymous namespace)::segsum_partials<int>(...)" ->
        # "segsum_partials"
        name = re.split(r"[<(]", e.name.replace(
            "(anonymous namespace)::", ""), maxsplit=1)[0]
        name = name.split("::")[-1].removeprefix("void ").strip()
        per.setdefault(name, []).append(max(own, 0) / 1e3)
    return {k: statistics.median(v) for k, v in sorted(per.items())}


def segsum_inputs(gen, n: int, groups: int):
    """Kernel B's inputs at the bench step's shape: f64 values U(0.5, 1.5)
    with 30 % zeros (the unmatched rows) and int32 ids uniform in
    [0, groups), as numpy arrays."""
    vals = np.where(gen.random(n) < 0.3, 0.0, gen.uniform(0.5, 1.5, n))
    return vals, gen.integers(0, groups, n).astype(np.int32)


def bench_step_runs(torch, dev, counters):
    """WALL_ROUNDS timed calls of the bench step (benchstep.many_steps at
    bench.py's shapes, K_STEPS steps a call) after one warm-up, each
    checked against numpy (rtol 1e-9), bit for bit against the warm-up and
    for its matched row count. The launch counts of the kernel wrappers in
    `counters` are set to 0 before each call. Returns the ms per step of
    each call, the set of launch-count tuples seen and the matched rows."""
    from spark_rapids_tpu_torch import benchstep
    data = benchstep.make_data(N_FACT, N_DIM, N_GROUPS, KEY_SPACE, seed=0)
    fk, fg, fv, dk, dw = data
    tens = [torch.from_numpy(a).to(dev) for a in data]
    ix = np.clip(np.searchsorted(dk, fk), 0, len(dk) - 1)
    matched = (dk[ix] == fk) & (fv > 0.6)
    want_sums = np.bincount(fg, weights=np.where(matched, fv * dw[ix], 0.0),
                            minlength=N_GROUPS)

    def step():
        return benchstep.many_steps(*tens, n_groups=N_GROUPS,
                                    key_space=KEY_SPACE, k_steps=K_STEPS)

    first, _ = step()
    step_ms, counts = [], set()
    for _ in range(WALL_ROUNDS):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sums, rows = step()
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end) / K_STEPS)
        counts.add(tuple(fn.launches for fn in counters))
        if not np.allclose(sums.cpu().numpy(), want_sums, rtol=1e-9,
                           atol=0.0):
            raise AssertionError("bench step sums differ from the oracle")
        if not torch.equal(sums, first):
            raise AssertionError("bench step sums are not bit-identical "
                                 "on repeat")
        if int(rows) != int(matched.sum()):
            raise AssertionError("bench step matched rows differ from the "
                                 "oracle")
    return step_ms, counts, int(rows)


def query_tables(pa, n_fact: int, n_dim: int, key_space: int, n_groups: int,
                 seed: int = 1):
    """The engine query's fact and dim tables as Arrow tables."""
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "k": rng.integers(0, key_space, n_fact, dtype=np.int64),
        "g": rng.integers(0, n_groups, n_fact, dtype=np.int64
                          ).astype(np.int32),
        "v": rng.uniform(0.5, 1.5, n_fact),
        "c": rng.integers(0, 2 ** 30, n_fact, dtype=np.int64),
    })
    dim = pa.table({
        "k": rng.permutation(key_space)[:n_dim].astype(np.int64),
        "w": rng.integers(0, 2 ** 30, n_dim, dtype=np.int64),
    })
    return fact, dim


def main_query(sess, fact, dim, paths: dict = None):
    """The engine's main query as a DataFrame of `sess`: filter v > 0.6,
    inner join on k, sum(c + w) and count(v) by g. The tables are `fact`
    and `dim`, or read_parquet of paths["fact"] and paths["dim"]."""
    from spark_rapids_tpu_torch.expr import Count, Sum, col
    if paths is not None:
        f = sess.read_parquet(paths["fact"])
        d = sess.read_parquet(paths["dim"])
    else:
        f, d = sess.from_arrow(fact), sess.from_arrow(dim)
    return f.filter(col("v") > 0.6).join(d, on="k") \
        .group_by("g").agg(total=Sum(col("c") + col("w")),
                           cnt=Count(col("v")))


def _joined(k, v, dim):
    """The query's filter and join on fact columns k and v: the mask of
    rows that pass both, and each row's dim w (dim keys are unique)."""
    dk = dim.column("k").to_numpy()
    dw = dim.column("w").to_numpy()
    order = np.argsort(dk)
    dk, dw = dk[order], dw[order]
    ix = np.clip(np.searchsorted(dk, k), 0, len(dk) - 1)
    return (dk[ix] == k) & (v > 0.6), dw[ix]


def query_oracle(fact, dim):
    """numpy: filter v > 0.6, inner join on k, sum(c + w) and count(v) by g."""
    g = fact.column("g").to_numpy()
    c = fact.column("c").to_numpy()
    hit, w = _joined(fact.column("k").to_numpy(), fact.column("v").to_numpy(),
                     dim)
    cnt = np.bincount(g[hit], minlength=N_GROUPS)
    total = np.zeros(N_GROUPS, np.int64)
    np.add.at(total, g[hit], c[hit] + w[hit])
    groups = np.nonzero(cnt)[0]
    return groups, total[groups], cnt[groups]


def segsum_path_inputs(fact, dim, cap: int):
    """The first fused batch's int64 segmented sum as the distributed
    query's partial aggregate runs it (Sum's sum): the batch's joined rows
    sorted by g, dense group ids, values c + w, and padding rows at id
    cap-1 with value 0."""
    g = fact.column("g").to_numpy()[:cap]
    c = fact.column("c").to_numpy()[:cap]
    hit, w = _joined(fact.column("k").to_numpy()[:cap],
                     fact.column("v").to_numpy()[:cap], dim)
    by_g = np.argsort(g[hit], kind="stable")
    gid = np.unique(g[hit][by_g], return_inverse=True)[1]
    ids = np.full(cap, cap - 1, np.int32)
    vals = np.zeros(cap, np.int64)
    ids[:len(gid)] = gid
    vals[:len(gid)] = (c[hit] + w[hit])[by_g]
    return vals, ids


# ---- the star-schema reports (TPC-DS q3/q7/q36 shapes)
# dimension rows of TPC-DS at scale factor 10 (specification v3.2.0, Table
# 3-2); the fact table is cut from about 28.8 M rows to the engine query's
# 16 batches of 1,048,576
STAR_SALES_ROWS = 16_777_216
STAR_DIMS = {"date_dim": 73_049, "item": 102_000, "store": 102}
STAR_SYLLABLES = ("amalg", "edu pack", "exporti", "importo", "scholar",
                  "univ", "corp", "maxi", "brand", "nameless")
STAR_CATEGORIES = ("Books", "Children", "Electronics", "Home", "Jewelry",
                   "Men", "Music", "Shoes", "Sports", "Women")
STAR_STATES = ("TN", "GA", "AL", "SD", "MI", "OH", "TX", "LA", "NC")
STAR_ROUNDS = 1


def star_tables(pa, n_sales: int, n_dates: int, n_items: int, n_stores: int,
                seed: int = 11) -> dict:
    """store_sales, date_dim, item and store as Arrow tables, from one
    numpy seed. Surrogate keys are aranges. Brands are TPC-DS style
    "<syllable><syllable> #<1..10>" (1,000 possible); categories are
    TPC-DS's ten, 0.5 % null; the sales price is in cents, 3 % null."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_dates)
    date_dim = pa.table({
        "d_date_sk": i.astype(np.int64),
        "d_year": (1900 + i // 365).astype(np.int32),
        "d_moy": (i % 365 // 31 + 1).astype(np.int32),
        "d_dow": (i % 7).astype(np.int32),
    })
    syl = np.array(STAR_SYLLABLES, dtype=object)
    b = rng.integers(0, 1000, n_items)
    brand = syl[b // 100] + syl[b // 10 % 10] + " #" + \
        (b % 10 + 1).astype(str).astype(object)
    cats = np.array(STAR_CATEGORIES, dtype=object)
    item = pa.table({
        "i_item_sk": np.arange(n_items, dtype=np.int64),
        "i_brand": pa.array(brand.tolist(), pa.string()),
        "i_category": pa.array(cats[rng.integers(0, len(cats), n_items)]
                               .tolist(), pa.string(),
                               mask=rng.random(n_items) < 0.005),
        "i_price": rng.uniform(1, 200, n_items).round(2),
    })
    states = np.array(STAR_STATES, dtype=object)
    store = pa.table({
        "s_store_sk": np.arange(n_stores, dtype=np.int64),
        "s_state": pa.array(states[np.arange(n_stores) % len(states)]
                            .tolist(), pa.string()),
    })
    store_sales = pa.table({
        "ss_sold_date_sk": rng.integers(0, n_dates, n_sales, dtype=np.int64),
        "ss_item_sk": rng.integers(0, n_items, n_sales, dtype=np.int64),
        "ss_store_sk": rng.integers(0, n_stores, n_sales, dtype=np.int64),
        "ss_quantity": rng.integers(1, 101, n_sales, dtype=np.int32),
        "ss_sales_price": pa.array(rng.uniform(0, 200, n_sales).round(2),
                                   mask=rng.random(n_sales) < 0.03),
    })
    return {"store_sales": store_sales, "date_dim": date_dim, "item": item,
            "store": store}


def star_data(pa, n_sales=STAR_SALES_ROWS, dims=STAR_DIMS) -> dict:
    """star_tables and their star_oracle (the star_query and
    parquet_star_q7 phases read the same tables), with the seconds it
    took."""
    t0 = time.monotonic()
    star = star_tables(pa, n_sales, *dims.values())
    return {"tables": star, "oracle": star_oracle(pa, star),
            "setup_s": time.monotonic() - t0}


def star_queries(sess, m, t: dict, paths: dict = None) -> dict:
    """Q3, Q7 and Q36 as DataFrames of `sess`, written with the
    constructors of namespace `m` (col, lit, Sum, Average, Count, Max, Min,
    Coalesce, CaseWhen, IsNotNull), which both engines share. Each
    dimension renames its key to the fact's in a select, and the joins use
    on=. The tables are read from `t` (Arrow tables), or with read_parquet
    from `paths` (a parquet file of each table) when given."""
    c = m.col

    def read(name):
        if paths is not None:
            return sess.read_parquet(paths[name])
        return sess.from_arrow(t[name], label=name)

    ss = read("store_sales")
    dd = read("date_dim").select(
        "d_year", "d_moy", ss_sold_date_sk=c("d_date_sk"))
    it = read("item").select(
        "i_brand", "i_category", "i_price", ss_item_sk=c("i_item_sk"))
    st = read("store").select(
        "s_state", ss_store_sk=c("s_store_sk"))
    q3 = ss.join(dd, on="ss_sold_date_sk") \
        .filter((c("d_moy") == m.lit(11))
                & m.IsNotNull(c("ss_sales_price"))) \
        .join(it, on="ss_item_sk") \
        .group_by("d_year", "i_brand") \
        .agg(sum_agg=m.Sum(c("ss_sales_price")))
    q7 = ss.join(it, on="ss_item_sk").join(st, on="ss_store_sk") \
        .filter(c("s_state") == m.lit("TN")) \
        .group_by("i_category") \
        .agg(q=m.Average(c("ss_quantity")), p=m.Average(c("ss_sales_price")),
             n=m.Count(m.lit(1)))
    q36 = ss.join(it, on="ss_item_sk") \
        .select(cat=m.Coalesce(c("i_category"), m.lit("unknown")),
                bucket=m.CaseWhen(
                    [(c("ss_sales_price") > m.lit(150.0), m.lit("lux")),
                     (c("ss_sales_price") > m.lit(50.0), m.lit("mid"))],
                    m.lit("base")),
                margin=c("ss_sales_price") - c("i_price")) \
        .group_by("cat", "bucket") \
        .agg(m=m.Average(c("margin")), n=m.Count(m.lit(1)),
             hi=m.Max(c("margin")), lo=m.Min(c("margin")))
    return {"q3": q3, "q7": q7, "q36": q36}


def star_namespace() -> SimpleNamespace:
    """The port's constructors that star_queries uses."""
    from spark_rapids_tpu_torch import expr as E
    return SimpleNamespace(**{n: getattr(E, n) for n in (
        "col", "lit", "Sum", "Average", "Count", "Max", "Min", "Coalesce",
        "CaseWhen", "IsNotNull")})


# key columns, and the columns compared with rtol 1e-9 (f64 sums and
# averages); every other column is compared exactly
STAR_KEYS = {"q3": ("d_year", "i_brand"), "q7": ("i_category",),
             "q36": ("cat", "bucket")}
STAR_APPROX = {"q3": ("sum_agg",), "q7": ("q", "p"), "q36": ("m",)}


def _codes(vals, valid=None):
    """Dense codes of a small host array in sorted order, and the sorted
    values (None, sorting last, for the null rows)."""
    valid = np.ones(len(vals), bool) if valid is None else valid
    vocab, code = np.unique(vals[valid], return_inverse=True)
    codes = np.full(len(vals), len(vocab), np.int64)
    codes[valid] = code
    return codes, list(vocab) + [None]


def _strings(col):
    return np.array(col.to_pylist(), dtype=object)


def _grouped(pa, keys, cols):
    """numpy group-by. `keys` maps each key name to (codes, values) from
    _codes; `cols` maps each output name to (op, values, valid) with op
    sum, mean, count, max or min over the valid rows. Groups come out
    sorted by key, nulls last (Arrow's order); an empty sum, mean, max or
    min is null."""
    combined = np.zeros(len(next(iter(cols.values()))[1]), np.int64)
    for codes, vocab in keys.values():
        combined = combined * len(vocab) + codes
    groups, gid = np.unique(combined, return_inverse=True)
    ng = len(groups)
    out, rest = {}, groups
    for name, (_, vocab) in reversed(list(keys.items())):
        out[name] = [vocab[k] for k in rest % len(vocab)]
        rest = rest // len(vocab)
    out = {name: out[name] for name in keys}
    for name, (op, vals, valid) in cols.items():
        cnt = np.bincount(gid[valid], minlength=ng)
        if op == "count":
            out[name] = cnt.tolist()
            continue
        if op in ("sum", "mean"):
            r = np.bincount(gid[valid], weights=vals[valid].astype(np.float64),
                            minlength=ng)
            if op == "mean":
                r = r / np.maximum(cnt, 1)
        else:  # sort by (group, value): each group's last or first row
            g, v = gid[valid], vals[valid]
            order = np.lexsort((v, g))
            g, v = g[order], v[order]
            edge = g[1:] != g[:-1]
            pick = np.r_[edge, True] if op == "max" else np.r_[True, edge]
            r = np.zeros(ng)
            r[g[pick]] = v[pick]
        out[name] = [float(x) if c else None for x, c in zip(r, cnt)]
    return pa.table(out)


def star_oracle(pa, t: dict) -> dict:
    """numpy answers to Q3, Q7 and Q36, independent of the engine: the
    dimension keys are aranges, so each join is a gather."""
    ss, it = t["store_sales"], t["item"]
    date = ss.column("ss_sold_date_sk").to_numpy()
    item = ss.column("ss_item_sk").to_numpy()
    store = ss.column("ss_store_sk").to_numpy()
    qty = ss.column("ss_quantity").to_numpy()
    pcol = ss.column("ss_sales_price")
    price = pcol.fill_null(0).to_numpy()
    pvalid = pcol.is_valid().to_numpy(zero_copy_only=False)
    cat = _strings(it.column("i_category"))
    cvalid = it.column("i_category").is_valid().to_numpy(zero_copy_only=False)
    iprice = it.column("i_price").to_numpy()
    tn = _strings(t["store"].column("s_state")) == "TN"
    year_c, years = _codes(t["date_dim"].column("d_year").to_numpy())
    moy = t["date_dim"].column("d_moy").to_numpy()[date]
    brand_c, brands = _codes(_strings(it.column("i_brand")))
    cat_c, cats = _codes(cat, cvalid)
    cat36_c, cats36 = _codes(np.where(cvalid, cat, "unknown"))
    ones = np.ones(len(date), bool)

    k = (moy == 11) & pvalid
    q3 = _grouped(pa, {"d_year": (year_c[date][k], years),
                       "i_brand": (brand_c[item][k], brands)},
                  {"sum_agg": ("sum", price[k], ones[k])})
    k = tn[store]
    q7 = _grouped(pa, {"i_category": (cat_c[item][k], cats)},
                  {"q": ("mean", qty[k], ones[k]),
                   "p": ("mean", price[k], pvalid[k]),
                   "n": ("count", qty[k], ones[k])})
    # CASE order: lux, then mid, else base (a null price is neither)
    bucket = np.where(pvalid & (price > 150.0), 1,
                      np.where(pvalid & (price > 50.0), 2, 0))
    margin = price - iprice[item]
    q36 = _grouped(pa, {"cat": (cat36_c[item], cats36),
                        "bucket": (bucket, ["base", "lux", "mid", None])},
                   {"m": ("mean", margin, pvalid),
                    "n": ("count", margin, ones),
                    "hi": ("max", margin, pvalid),
                    "lo": ("min", margin, pvalid)})
    return {"q3": q3, "q7": q7, "q36": q36}


def check_star(name: str, out, want) -> None:
    """Raise unless `out` (a collect() result) equals the oracle table
    `want`: keys, counts, MIN and MAX exactly, sums and averages within
    rtol 1e-9, nulls in the same places."""
    out = out.sort_by([(k, "ascending") for k in STAR_KEYS[name]])
    if out.num_rows != want.num_rows:
        raise AssertionError(f"{name}: {out.num_rows} groups, oracle "
                             f"{want.num_rows}")
    for col in want.column_names:
        got, exp = out.column(col).to_pylist(), want.column(col).to_pylist()
        if col not in STAR_APPROX[name]:
            ok = got == exp
        else:
            ok = [g is None for g in got] == [e is None for e in exp] and \
                np.allclose([g for g in got if g is not None],
                            [e for e in exp if e is not None],
                            rtol=1e-9, atol=0.0)
        if not ok:
            raise AssertionError(f"{name}: column {col} differs from the "
                                 "oracle")


def star_phases(torch, pa, mesh_conf: dict, counters, n_sales=STAR_SALES_ROWS,
                dims=STAR_DIMS, conf=None, device=None, data=None):
    """Phases 8 and 9: Q3, Q7 and Q36 on one device, then Q7 under the
    distributed plan (`mesh_conf`), each checked against star_oracle, timed
    and traced. `counters` are the kernel wrappers A, B and C, whose
    launch counts are set to 0 around each run; `conf` is added to every
    session's settings; `data` (star_data) gives the tables, made here
    without it. The path's checked, counted run comes first and warms
    each query up for the timed collects. Returns the counts of the two
    paths' runs, and the arguments of A's first call in a one-device Q7
    collect and of C's first call in a distributed Q7 collect (outside the
    counted runs)."""
    from spark_rapids_tpu_torch.exec import exchange
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession
    conf = dict(conf or {})
    # ---- 8. the star-schema reports (Q3, Q7, Q36) on one device, fusion
    # on, pallas.mode auto: kernel A sizes every fused probe, C never runs
    ns = star_namespace()

    def counted(fn):
        """fn() with every launch count set to 0 just before it; returns
        (fn's result, the counts of A, B and C just after)."""
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counters}

    def timed_collects(name, q, expect):
        """STAR_ROUNDS warm collects, each checked against the oracle and
        for its launches: A > 0 and C as `expect` says."""
        walls, seen = [], set()
        for _ in range(STAR_ROUNDS):
            t0 = time.perf_counter()
            out, n = counted(q.collect)
            walls.append(time.perf_counter() - t0)
            check_star(name, out, star_want[name])
            seen.add(tuple(sorted(n.items())))
        if len(seen) != 1 or n["murmur3_rows"] == 0 or \
                not expect(n["segment_sum_i64"]):
            raise AssertionError(f"{name} launched {sorted(seen)} per "
                                 "collect")
        return walls, n

    data = data or star_data(pa, n_sales, dims)
    star, star_want = data["tables"], data["oracle"]
    sess = TpuSession(dict(conf, **{"spark.rapids.tpu.fusion.enabled": True}),
                      device)
    sq = star_queries(sess, ns, star)
    for name, q in sq.items():
        plan = q.explain()
        if "TpuFusedStageExec" not in plan or "TpuShuffled" in plan:
            raise AssertionError(f"{name}: not the fused broadcast plan:\n"
                                 f"{plan}")
    # the path's run: one collect of each query between the counter reads
    outs, star_launches = counted(lambda: [q.collect() for q in sq.values()])
    for name, out in zip(sq, outs):
        check_star(name, out, star_want[name])
    if star_launches["segment_sum_i64"] or \
            star_launches["murmur3_rows"] == 0:
        raise AssertionError(f"the star path launched {star_launches}")
    per_query = {}
    for name, q in sq.items():
        walls, n = timed_collects(name, q, lambda c: c == 0)
        per_query[name] = {
            "groups": star_want[name].num_rows,
            "warm_collect_s": spread(walls), "launches_per_collect": n,
            "device_idle_share": idle_share(torch, q.collect)}
    a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                             sq["q7"].collect)
    emit({"phase": "star_query", "fact_rows": n_sales, "dim_rows": dims,
          "setup_s": data["setup_s"],
          "rtol_sums_averages": 1e-9, "exact": "keys, counts, min, max",
          "queries": per_query, "launches_per_path_run": star_launches})

    # ---- 9. Q7 under the distributed plan: fused [probes, filter, partial
    # aggregate] -> key exchange on the string key -> per-shard final
    dsess = TpuSession(dict(mesh_conf, **conf), device)
    q7 = star_queries(dsess, ns, star)["q7"]
    plan = q7.explain()
    if not (plan.startswith("TpuHashAggregateExec[final")
            and "TpuShuffleExchangeExec" in plan and "PartialAgg[" in plan):
        raise AssertionError(f"q7: not the distributed plan:\n{plan}")
    before = exchange.MESH_EXCHANGES
    out, dstar_launches = counted(q7.collect)
    check_star("q7", out, star_want["q7"])
    if exchange.MESH_EXCHANGES < before + 1 or \
            dstar_launches["murmur3_rows"] == 0 or \
            dstar_launches["segment_sum_i64"] == 0:
        raise AssertionError(f"distributed q7 launched {dstar_launches}, "
                             f"{exchange.MESH_EXCHANGES - before} exchanges")
    before = exchange.MESH_EXCHANGES
    dwalls7, _ = timed_collects("q7", q7, lambda c: c > 0)
    emit({"phase": "star_query_distributed", "fact_rows": n_sales,
          "query": "q7", "mesh_positions": MESH_POSITIONS,
          "groups": star_want["q7"].num_rows,
          "mesh_exchanges_per_collect":
              (exchange.MESH_EXCHANGES - before) / STAR_ROUNDS,
          "warm_collect_s": spread(dwalls7),
          "device_idle_share": idle_share(torch, q7.collect),
          "launches_per_path_run": dstar_launches})
    c_args = first_call_args(torch, pallas_groupby, "segment_sum_i64",
                             q7.collect)
    return star_launches, dstar_launches, a_args, c_args


# ---- the parquet scan (slice 5): the engine query's and the star schema's
# tables written by pyarrow in row groups of 1,048,576 rows
PARQUET_ROW_GROUP = 1 << 20
CHUNKS_PER_DISPATCH = 4  # spark.rapids.tpu.pipeline.scan.chunksPerDispatch
ARROW_BATCH_ROWS = 1 << 20  # spark.rapids.sql.batchSizeRows
DECODE_ROUNDS = 1
# warm collects of each parquet_query variant, in turns, on each plan
PARQUET_ROUNDS = 1
DPP_OFF = {"spark.rapids.sql.dynamicFilePruning.enabled": False}
HOST_DECODE = {"spark.rapids.sql.format.parquet.deviceDecode.enabled": False}
ONE_RG = {"spark.rapids.tpu.pipeline.scan.chunksPerDispatch": 1}
NO_PREFETCH = {"spark.rapids.tpu.pipeline.prefetch.depth": 0}
SERIAL = {"spark.rapids.tpu.pipeline.enabled": False}


def check_query(out, want, what: str) -> None:
    """Raise unless the engine query's result equals the numpy oracle
    (groups, sums and counts exactly)."""
    out = out.sort_by("g")
    for name, w in zip(("g", "total", "cnt"), want):
        if not np.array_equal(out.column(name).to_numpy(), w):
            raise AssertionError(f"query column {name} differs from the "
                                 f"oracle ({what})")


def write_parquet(pq, tables: dict, d: str, compression: str = "snappy",
                  tag: str = "") -> dict:
    """Each table into d/<name><tag>.parquet; returns the paths."""
    paths = {}
    for name, t in tables.items():
        paths[name] = os.path.join(d, f"{name}{tag}.parquet")
        pq.write_table(t, paths[name], row_group_size=PARQUET_ROW_GROUP,
                       compression=compression)
    return paths


def packed_groups(pq, paths, per: int) -> int:
    """The packed dispatches a scan of `paths` makes at `per` row groups a
    dispatch: every group of two row groups or more (a lone row group
    decodes by itself)."""
    n = 0
    for path in paths:
        rgs = pq.ParquetFile(path).metadata.num_row_groups
        n += (rgs // per + (rgs % per > 1)) if per > 1 else 0
    return n


def check_decoded(pa, batches, want, what: str) -> None:
    """Raise unless the decoded batches hold `want` (pq.read_table of the
    same file), value for value and validity for validity."""
    from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
    got = pa.concat_tables([batch_to_arrow(b) for b, _ in batches])
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} rows, pyarrow "
                             f"{want.num_rows}")
    for name in want.column_names:
        if not got.column(name).equals(want.column(name)):
            raise AssertionError(f"{what}: column {name} differs from "
                                 "pyarrow")


def parquet_phases(torch, pa, mesh_conf: dict, counters, fact, dim,
                   n_sales=STAR_SALES_ROWS, dims=STAR_DIMS, conf=None,
                   device=None, rounds=PARQUET_ROUNDS,
                   decode_rounds=DECODE_ROUNDS, star=None):
    """Phases parquet_decode, parquet_query and parquet_star_q7 (slice 5),
    over files written to a temporary directory that is removed after.
    `counters` are the kernel wrappers A, B and C; `conf` is added to every
    session's settings; `star` (star_data) gives the star tables, made
    here without it. Each query's checked, counted run comes first and
    warms it up for the timed collects. Returns the launch counts of each path's run, and
    the arguments of A's first call in a parquet star Q7 collect and of
    C's first call in a distributed parquet query collect without pruning
    (outside the counted runs)."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.io import parquet_device as P
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **{"spark.rapids.tpu.fusion.enabled": True})

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        P.COUNTERS.reset()
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counters}, \
            P.COUNTERS.snapshot()

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parquet_") as d:
        # ---- parquet_decode: the fact table, snappy and uncompressed, each
        # decoded 4 row groups a packed dispatch and row group by row group,
        # held against pq.read_table and timed against it
        t0 = time.monotonic()
        paths = {c: write_parquet(pq, {"fact": fact}, d, c, f"_{c}")["fact"]
                 for c in ("snappy", "none")}
        write_s = time.monotonic() - t0
        raw_bytes = fact.num_rows * sum(
            np.dtype(t.to_pandas_dtype()).itemsize for t in fact.schema.types)
        files = {}
        for comp, path in paths.items():
            want = pq.read_table(path)
            schema = Schema.from_arrow(want.schema)
            pf = pq.ParquetFile(path)
            row = {"file_bytes": os.path.getsize(path),
                   "row_groups": pf.metadata.num_row_groups}
            read_walls = []
            for _ in range(decode_rounds):
                t0 = time.perf_counter()
                pq.read_table(path)
                read_walls.append(time.perf_counter() - t0)
            row["pq_read_table_s"] = spread(read_walls)
            for cpd in (4, 1):
                def run():
                    return list(P.device_decode_file(pf, path, schema, dev,
                                                     cpd))
                out, _, counts = counted(run)
                check_decoded(pa, out, want, f"{comp} file, {cpd} row "
                              "groups a dispatch")
                if cpd == 4 and (counts["declined_chunks"] or
                                 counts["fused_dispatches"] * 4 !=
                                 row["row_groups"]):
                    raise AssertionError(f"{comp}: the packed decode was "
                                         f"not taken everywhere: {counts}")
                del out
                walls = []
                for _ in range(decode_rounds):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = run()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    del out
                med = statistics.median(walls)
                row[f"chunks_per_dispatch_{cpd}"] = {
                    "wall_s": spread(walls), "batches": len(run()),
                    "file_gb_per_s": row["file_bytes"] / med / 1e9,
                    "raw_gb_per_s": raw_bytes / med / 1e9,
                    "h2d_bytes": counts["h2d_bytes"],
                    "h2d_copies": counts["h2d_copies"],
                    "fused_dispatches": counts["fused_dispatches"],
                    "scan_chunks": counts["scan_chunks"],
                    "declined_chunks": counts["declined_chunks"]}
            files[comp] = row
        emit({"phase": "parquet_decode", "rows": fact.num_rows,
              "row_group_rows": PARQUET_ROW_GROUP, "raw_bytes": raw_bytes,
              "write_s": write_s, "exact_vs_pyarrow": True, "files": files})

        # ---- parquet_query: the engine query through read_parquet, one
        # device and distributed, in turns with the same query from Arrow
        # tables, without dynamic pruning (which lets the join fuse), with
        # the host decode, and with each pipelining mechanism turned off:
        # one row group a dispatch, no prefetch thread, neither
        want = query_oracle(fact, dim)
        qpaths = {"fact": paths["snappy"],
                  "dim": write_parquet(pq, {"dim": dim}, d)["dim"]}
        fact_batches = -(-pq.ParquetFile(qpaths["fact"]).metadata
                         .num_row_groups // CHUNKS_PER_DISPATCH)
        arrow_batches = -(-fact.num_rows // ARROW_BATCH_ROWS)
        variants = {"parquet": ({}, qpaths),
                    "parquet_no_dpp": (DPP_OFF, qpaths),
                    "from_arrow": ({}, None),
                    "host_decode": (HOST_DECODE, qpaths),
                    "parquet_1_row_group_a_dispatch": (ONE_RG, qpaths),
                    "parquet_no_prefetch_thread": (NO_PREFETCH, qpaths),
                    "parquet_serial": (SERIAL, qpaths)}
        for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
            dfs = {v: main_query(TpuSession(dict(conf, **extra, **vc), dev),
                                 fact, dim, p)
                   for v, (vc, p) in variants.items()}
            shapes = {v: df.explain() for v, df in dfs.items()}
            if "TpuFusedStageExec" in shapes["parquet"] or \
                    "TpuFusedStageExec" not in shapes["parquet_no_dpp"] or \
                    "TpuFileScanExec(parquet)" not in shapes["parquet"]:
                raise AssertionError(f"{plan}: unexpected plans:\n"
                                     f"{shapes['parquet']}\n"
                                     f"{shapes['parquet_no_dpp']}")
            runs = {}
            for v, df in dfs.items():
                out, n, scan = counted(df.collect)
                check_query(out, want, f"{plan} {v}")
                runs[v] = {"launches": n, "scan": scan}
            # A twice per fused join per batch; C as many times a batch as
            # on the same query from Arrow: 4 merged batches, not 16
            fused, arrow = runs["parquet_no_dpp"]["launches"], \
                runs["from_arrow"]["launches"]
            want_a = 2 * fused_joins(shapes["parquet_no_dpp"]) * fact_batches
            want_c = arrow["segment_sum_i64"] // arrow_batches * fact_batches
            if fused["murmur3_rows"] != want_a or \
                    fused["segment_sum_i64"] != want_c or \
                    arrow["segment_sum_i64"] % arrow_batches or \
                    (want_c > 0) != (plan == "distributed"):
                raise AssertionError(f"{plan}: the fused parquet query "
                                     f"launched {fused}, not A {want_a} and "
                                     f"C {want_c}")
            for v, n_rg in (("parquet", CHUNKS_PER_DISPATCH),
                            ("parquet_no_prefetch_thread",
                             CHUNKS_PER_DISPATCH),
                            ("parquet_1_row_group_a_dispatch", 1),
                            ("parquet_serial", 1)):
                sc = runs[v]["scan"]
                if sc["declined_chunks"] or sc["fused_dispatches"] != \
                        packed_groups(pq, qpaths.values(), n_rg):
                    raise AssertionError(f"{plan} {v}: the parquet scan did "
                                         f"not decode {n_rg} row groups a "
                                         f"dispatch: {sc}")
            if plan == "distributed":
                # C on the inputs this path gives it (outside the counted run)
                c_args = first_call_args(torch, pallas_groupby,
                                         "segment_sum_i64",
                                         dfs["parquet_no_dpp"].collect)
            walls = {v: [] for v in dfs}
            order = list(dfs)
            for i in range(rounds):
                for v in order if i % 2 == 0 else order[::-1]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = dfs[v].collect()
                    torch.cuda.synchronize()
                    walls[v].append(time.perf_counter() - t0)
                    check_query(out, want, f"{plan} {v}")
            launches[f"parquet_query_{plan}"] = runs["parquet"]["launches"]
            launches[f"parquet_query_{plan}_no_dpp"] = fused
            emit({"phase": "parquet_query", "plan": plan,
                  "fact_rows": fact.num_rows, "dim_rows": dim.num_rows,
                  "exact": True, "fact_batches": fact_batches,
                  "fused_joins_no_dpp": fused_joins(shapes["parquet_no_dpp"]),
                  "warm_collect_s": {v: spread(w) for v, w in walls.items()},
                  "device_idle_share": {
                      v: idle_share(torch, dfs[v].collect)
                      for v in ("parquet", "parquet_no_dpp")},
                  "per_collect": runs})

        # ---- parquet_star_q7: star Q7 over the four star tables in parquet,
        # one device: dictionary strings, nulls, and the pruning wiring
        star = star or star_data(pa, n_sales, dims)
        star_want = star["oracle"]["q7"]
        t0 = time.monotonic()
        spaths = write_parquet(pq, star["tables"], d)
        write_s = time.monotonic() - t0
        q7 = star_queries(TpuSession(conf, dev), star_namespace(),
                          star["tables"], spaths)["q7"]
        plan = q7.explain()
        if "TpuFusedStageExec" not in plan or "TpuShuffled" in plan:
            raise AssertionError(f"parquet q7: not the fused broadcast "
                                 f"plan:\n{plan}")
        out, n, scan = counted(q7.collect)
        check_star("q7", out, star_want)
        sales_batches = -(-pq.ParquetFile(spaths["store_sales"]).metadata
                          .num_row_groups // CHUNKS_PER_DISPATCH)
        want_a = 2 * fused_joins(plan) * sales_batches
        if n["murmur3_rows"] != want_a or n["segment_sum_i64"]:
            raise AssertionError(f"parquet q7 launched {n}, not A {want_a} "
                                 "and C 0")
        # A on the inputs this path gives it (outside the counted run)
        a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                                 q7.collect)
        walls = []
        for _ in range(STAR_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check_star("q7", q7.collect(), star_want)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches["parquet_star_q7"] = n
        emit({"phase": "parquet_star_q7", "fact_rows": n_sales,
              "dim_rows": dims, "setup_s": star["setup_s"],
              "write_s": write_s,
              "file_bytes": {k: os.path.getsize(v) for k, v in spaths.items()},
              "rtol_averages": 1e-9, "exact": "keys, counts",
              "sales_batches": sales_batches, "fused_joins": fused_joins(plan),
              "warm_collect_s": spread(walls),
              "device_idle_share": idle_share(torch, q7.collect),
              "launches_per_collect": n, "scan_per_collect": scan})
    return launches, a_args, c_args


# ---- star_decimal (slice 6): the star reports over TPC-DS v3.2.0's own
# column types, from parquet: every money column decimal(7,2), written
# with pyarrow's defaults (decimals as FIXED_LEN_BYTE_ARRAY(4)), snappy
STAR_MONEY = ("ss_list_price", "ss_sales_price", "ss_ext_sales_price",
              "ss_net_profit", "ss_coupon_amt")
MONEY = (7, 2)  # decimal(7,2)
# Average over decimal(p, s) is decimal(p + 4, s + 4), rounded HALF_UP
AVG_EXTRA_SCALE = 4
# kernel C's launches a batch in a fused partial aggregate, one for each
# int64 segmented sum: a Count 1; a decimal Sum 2 (its sum, and its count
# of valid rows); Min and Max 1 (the count); a decimal Average 2 (its sum
# and its count); an Average over an int 1 (its count: its sum is f64,
# which is not C). Q3: 2; Q7: 1 + 3 x 2 + 1; Q36: 2 + 2 + 1 + 1 + 1
STAR_DECIMAL_C_PER_BATCH = {"q3": 2, "q7": 8, "q36": 7}
STAR_DECIMAL_KEYS = {"q3": ("d_year", "i_brand"), "q7": ("i_category",),
                     "q36": ("cat", "bucket")}


def decimal_array(pa, unscaled, p: int, s: int, valid=None):
    """int64 unscaled values -> an Arrow decimal128(p, s) array, built from
    its 16-byte two's-complement words (no Python Decimal a row)."""
    unscaled = np.asarray(unscaled, np.int64)
    words = np.empty((len(unscaled), 2), np.int64)
    words[:, 0], words[:, 1] = unscaled, unscaled >> 63
    nulls = 0 if valid is None else int((~valid).sum())
    bitmap = pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()) \
        if nulls else None
    return pa.Array.from_buffers(pa.decimal128(p, s), len(unscaled),
                                 [bitmap, pa.py_buffer(words.tobytes())],
                                 null_count=nulls)


def unscaled(col):
    """An Arrow decimal128 column of <= 18 digits -> (int64 unscaled
    values, bool validity), read from its 16-byte words' low halves."""
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    n = len(arr)
    words = np.frombuffer(arr.buffers()[1], np.int64,
                          count=2 * (arr.offset + n))[2 * arr.offset::2]
    valid = np.asarray(arr.is_valid()) if arr.null_count else \
        np.ones(n, bool)
    return np.where(valid, words, 0), valid


def star_decimal_tables(pa, n_sales: int, n_dates: int, n_items: int,
                        n_stores: int, seed: int = 11) -> dict:
    """star_tables' tables with TPC-DS's money columns as decimal(7,2):
    ss_list_price (1.00 to 200.00), ss_sales_price (at most the list
    price, 3 % null), ss_ext_sales_price (sales price x quantity),
    ss_coupon_amt (0 on 80 % of rows), ss_net_profit (ext price less
    coupon less the wholesale cost, negative on many rows) and
    i_current_price; ss_quantity stays int32."""
    t = star_tables(pa, n_sales, n_dates, n_items, n_stores, seed)
    rng = np.random.default_rng(seed + 1)
    qty = t["store_sales"].column("ss_quantity").to_numpy().astype(np.int64)
    price_valid = t["store_sales"].column("ss_sales_price").is_valid() \
        .to_numpy(zero_copy_only=False)
    lst = rng.integers(100, 20_001, n_sales)
    sales = (lst * rng.uniform(0.2, 1.0, n_sales)).astype(np.int64)
    ext = sales * qty
    coupon = np.where(rng.random(n_sales) < 0.2,
                      (ext * rng.uniform(0, 0.5, n_sales)).astype(np.int64),
                      0)
    wholesale = (lst * rng.uniform(0.3, 1.0, n_sales)).astype(np.int64) * qty
    money = {"ss_list_price": lst, "ss_sales_price": sales,
             "ss_ext_sales_price": ext, "ss_net_profit": ext - coupon -
             wholesale, "ss_coupon_amt": coupon}
    ss = t["store_sales"].drop_columns(["ss_sales_price"])
    for name in STAR_MONEY:
        ss = ss.append_column(name, decimal_array(
            pa, money[name], *MONEY,
            price_valid if name == "ss_sales_price" else None))
    item = t["item"].drop_columns(["i_price"]).append_column(
        "i_current_price", decimal_array(
            pa, rng.integers(9, 10_000, n_items), *MONEY))
    return dict(t, store_sales=ss, item=item)


def star_decimal_queries(sess, m, paths: dict, rollup: bool = False,
                         **sales_options) -> dict:
    """Q3, Q7 and Q36 over star_decimal_tables' parquet files, as
    DataFrames of `sess` with the port's constructors `m`
    (star_namespace): Q3 sums
    ss_ext_sales_price (decimal(17,2)); Q7 averages the quantity (a
    double) and three prices (decimal(11,6)); Q36 divides two decimal
    sums (a double), buckets by a CASE on the sales price against
    decimal literals, and takes MIN and MAX of a decimal difference.
    paths["store_sales"] is a path or a list of them, read with
    `sales_options` (`filters=`). With `rollup`, Q36 is its input before
    the grouping (rollup_q36 groups it)."""
    from decimal import Decimal
    c = m.col
    sales = paths["store_sales"]
    ss = sess.read_parquet(*([sales] if isinstance(sales, str) else sales),
                           **sales_options)
    dd = sess.read_parquet(paths["date_dim"]).select(
        "d_year", "d_moy", ss_sold_date_sk=c("d_date_sk"))
    it = sess.read_parquet(paths["item"]).select(
        "i_brand", "i_category", "i_current_price",
        ss_item_sk=c("i_item_sk"))
    st = sess.read_parquet(paths["store"]).select(
        "s_state", ss_store_sk=c("s_store_sk"))
    q3 = ss.join(dd, on="ss_sold_date_sk") \
        .filter(c("d_moy") == m.lit(11)) \
        .join(it, on="ss_item_sk") \
        .group_by("d_year", "i_brand") \
        .agg(sum_agg=m.Sum(c("ss_ext_sales_price")))
    q7 = ss.join(it, on="ss_item_sk").join(st, on="ss_store_sk") \
        .filter(c("s_state") == m.lit("TN")) \
        .group_by("i_category") \
        .agg(agg1=m.Average(c("ss_quantity")),
             agg2=m.Average(c("ss_list_price")),
             agg3=m.Average(c("ss_coupon_amt")),
             agg4=m.Average(c("ss_sales_price")), n=m.Count(m.lit(1)))
    price = c("ss_sales_price")
    q36 = ss.join(it, on="ss_item_sk") \
        .select("ss_net_profit", "ss_ext_sales_price",
                cat=m.Coalesce(c("i_category"), m.lit("unknown")),
                bucket=m.CaseWhen(
                    [(price > m.lit(Decimal("150.00")), m.lit("lux")),
                     (price > m.lit(Decimal("50.00")), m.lit("mid"))],
                    m.lit("base")),
                margin=price - c("i_current_price"))
    if rollup:
        return {"q3": q3, "q7": q7, "q36": q36}
    q36 = q36 \
        .group_by("cat", "bucket") \
        .agg(profit=m.Sum(c("ss_net_profit")),
             sales=m.Sum(c("ss_ext_sales_price")), hi=m.Max(c("margin")),
             lo=m.Min(c("margin")), n=m.Count(m.lit(1))) \
        .select("cat", "bucket", "profit", "sales", "hi", "lo", "n",
                gross_margin=c("profit") / c("sales"))
    return {"q3": q3, "q7": q7, "q36": q36}


def decimal_mean(total: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """Spark's decimal average in int64: the exact mean of unscaled sums,
    rounded HALF_UP (on the magnitude) at AVG_EXTRA_SCALE more digits."""
    n = np.maximum(cnt, 1)
    q, r = np.divmod(np.abs(total), n)
    unit = 10 ** AVG_EXTRA_SCALE
    out = q * unit + (2 * r * unit + n) // (2 * n)
    return np.where(total < 0, -out, out)


def _grouped_exact(keys: dict, cols: dict) -> dict:
    """numpy group-by in int64. `keys` as in _grouped; `cols` maps each
    output name to (op, int64 values, valid) with op isum, iavg (HALF_UP
    decimal mean), fmean (double mean), count, imax or imin. Rows sort by
    group once; each column reduces its valid rows' runs (np.*.reduceat).
    Returns {name: list}, groups sorted by key, nulls last; an empty
    group's value None."""
    combined = np.zeros(len(next(iter(cols.values()))[1]), np.int64)
    for codes, vocab in keys.values():
        combined = combined * len(vocab) + codes
    groups, gid = np.unique(combined, return_inverse=True)
    ng = len(groups)
    out, rest = {}, groups
    for name, (_, vocab) in reversed(list(keys.items())):
        out[name] = [vocab[k] for k in rest % len(vocab)]
        rest = rest // len(vocab)
    out = {name: out[name] for name in keys}
    order = np.argsort(gid, kind="stable")
    gid = gid[order]
    ufunc = {"isum": np.add, "iavg": np.add, "imax": np.maximum,
             "imin": np.minimum}
    for name, (op, vals, valid) in cols.items():
        keep = valid[order]
        g, v = gid[keep], vals[order][keep]
        cnt = np.bincount(g, minlength=ng)
        if op == "count":
            out[name] = cnt.tolist()
            continue
        if op == "fmean":
            r = np.bincount(g, weights=v.astype(np.float64), minlength=ng) \
                / np.maximum(cnt, 1)
        else:
            r = np.zeros(ng, np.int64)
            if len(g):
                starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
                r[g[starts]] = ufunc[op].reduceat(v.astype(np.int64), starts)
            if op == "iavg":
                r = decimal_mean(r, cnt)
        out[name] = [x.item() if c else None for x, c in zip(r, cnt)]
    return out


def star_decimal_oracle(pa, t: dict) -> dict:
    """numpy int64 answers to the decimal Q3, Q7 and Q36: every decimal
    result as its unscaled int (sums exact, averages by decimal_mean),
    Q7's quantity average and Q36's ratio as doubles."""
    ss, it = t["store_sales"], t["item"]
    date = ss.column("ss_sold_date_sk").to_numpy()
    item = ss.column("ss_item_sk").to_numpy()
    store = ss.column("ss_store_sk").to_numpy()
    qty = ss.column("ss_quantity").to_numpy().astype(np.int64)
    m = {name: unscaled(ss.column(name)) for name in STAR_MONEY}
    price, pvalid = m["ss_sales_price"]
    cat = _strings(it.column("i_category"))
    cvalid = it.column("i_category").is_valid().to_numpy(zero_copy_only=False)
    tn = _strings(t["store"].column("s_state")) == "TN"
    year_c, years = _codes(t["date_dim"].column("d_year").to_numpy())
    moy = t["date_dim"].column("d_moy").to_numpy()[date]
    brand_c, brands = _codes(_strings(it.column("i_brand")))
    cat_c, cats = _codes(cat, cvalid)
    cat36_c, cats36 = _codes(np.where(cvalid, cat, "unknown"))
    ones = np.ones(len(date), bool)

    k = moy == 11
    ext, _ = m["ss_ext_sales_price"]
    q3 = _grouped_exact({"d_year": (year_c[date][k], years),
                         "i_brand": (brand_c[item][k], brands)},
                        {"sum_agg": ("isum", ext[k], ones[k])})
    k = tn[store]
    q7 = _grouped_exact({"i_category": (cat_c[item][k], cats)},
                        {"agg1": ("fmean", qty[k], ones[k]),
                         "agg2": ("iavg", m["ss_list_price"][0][k], ones[k]),
                         "agg3": ("iavg", m["ss_coupon_amt"][0][k], ones[k]),
                         "agg4": ("iavg", price[k], pvalid[k]),
                         "n": ("count", qty[k], ones[k])})
    # CASE order: lux, then mid, else base (a null price is neither);
    # decimal(7,2) against 150.00 and 50.00 compares the unscaled cents
    bucket = np.where(pvalid & (price > 15_000), 1,
                      np.where(pvalid & (price > 5_000), 2, 0))
    iprice, _ = unscaled(it.column("i_current_price"))
    margin = price - iprice[item]
    q36 = _grouped_exact({"cat": (cat36_c[item], cats36),
                          "bucket": (bucket, ["base", "lux", "mid", None])},
                         {"profit": ("isum", m["ss_net_profit"][0], ones),
                          "sales": ("isum", ext, ones),
                          "hi": ("imax", margin, pvalid),
                          "lo": ("imin", margin, pvalid),
                          "n": ("count", margin, ones)})
    q36["gross_margin"] = [None if s in (None, 0) else
                           float(np.float64(p) / np.float64(s))
                           for p, s in zip(q36["profit"], q36["sales"])]
    return {"q3": q3, "q7": q7, "q36": q36}


# columns compared with rtol 1e-9 (a double average); every other column is
# compared exactly, decimals as their unscaled ints
STAR_DECIMAL_APPROX = {"q7": ("agg1",)}
# each decimal result's type, by Spark's rules: Sum decimal(p + 10, s),
# Average decimal(p + 4, s + 4), a difference decimal(p + 1, s)
STAR_DECIMAL_TYPES = {
    "q3": {"sum_agg": (17, 2)},
    "q7": {"agg2": (11, 6), "agg3": (11, 6), "agg4": (11, 6)},
    "q36": {"profit": (17, 2), "sales": (17, 2), "hi": (8, 2),
            "lo": (8, 2)}}


def check_star_decimal(pa, name: str, out, want: dict,
                       ordered: bool = False) -> None:
    """Raise unless `out` (a collect() result) equals the int64 oracle:
    every decimal's type (STAR_DECIMAL_TYPES), keys, counts, every decimal
    (as its unscaled int) and Q36's ratio exactly, Q7's quantity average
    within rtol 1e-9. Rows are compared in key order, or as they come when
    `ordered` (the oracle's rows then in the query's order)."""
    if not ordered:
        out = out.sort_by([(k, "ascending")
                           for k in STAR_DECIMAL_KEYS[name]])
    if out.num_rows != len(next(iter(want.values()))):
        raise AssertionError(f"decimal {name}: {out.num_rows} groups, "
                             f"oracle {len(next(iter(want.values())))}")
    for col, (p, sc) in STAR_DECIMAL_TYPES[name].items():
        if out.schema.field(col).type != pa.decimal128(p, sc):
            raise AssertionError(f"decimal {name}: column {col} is "
                                 f"{out.schema.field(col).type}, not "
                                 f"decimal({p},{sc})")
    for col, exp in want.items():
        c = out.column(col)
        if pa.types.is_decimal(c.type):
            vals, valid = unscaled(c)
            got = [int(v) if ok else None for v, ok in zip(vals, valid)]
        else:
            got = c.to_pylist()
        if col in STAR_DECIMAL_APPROX.get(name, ()):
            ok = [g is None for g in got] == [e is None for e in exp] and \
                np.allclose([g for g in got if g is not None],
                            [e for e in exp if e is not None],
                            rtol=1e-9, atol=0.0)
        else:
            ok = got == exp
        if not ok:
            raise AssertionError(f"decimal {name}: column {col} differs "
                                 "from the oracle")


def star_decimal_data(pa, d: str, n_sales=STAR_SALES_ROWS,
                      dims=STAR_DIMS) -> dict:
    """star_decimal_tables, their int64 oracle and their parquet files in
    directory d (the star_decimal and ordered_reports phases read the same
    files), with the seconds it took."""
    import pyarrow.parquet as pq
    t0 = time.monotonic()
    star = star_decimal_tables(pa, n_sales, *dims.values())
    want = star_decimal_oracle(pa, star)
    paths = write_parquet(pq, star, d, tag="_decimal")
    return {"tables": star, "oracle": want, "paths": paths,
            "files_head": files_head(pa, star, d),
            "setup_s": time.monotonic() - t0}


def star_decimal_phases(torch, pa, mesh_conf: dict, counters,
                        n_sales=STAR_SALES_ROWS, dims=STAR_DIMS, conf=None,
                        device=None, rounds=STAR_ROUNDS,
                        decode_rounds=DECODE_ROUNDS, data=None):
    """Phase star_decimal: Q3, Q7 and Q36 over decimal money columns read
    from parquet, on one device and under the distributed plan
    (`mesh_conf`), each checked against star_decimal_oracle, launch-counted
    (A twice per fused join per merged batch; C STAR_DECIMAL_C_PER_BATCH a
    merged batch of a fused partial aggregate, so never on one device)
    and timed; and the FLBA decode of the five money columns beside
    pq.read_table. Returns the launch counts of each plan's run (one
    collect of each query) and the arguments of A's first call in a
    one-device Q7 collect and of C's first call in a distributed Q3
    collect (the decimal sum's unscaled values). `data` (star_decimal_data)
    gives the tables and files; without it they are made in a temporary
    directory. Each plan's checked, counted run comes first and warms its
    queries up for the timed collects."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.io import parquet_device as P
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **{"spark.rapids.tpu.fusion.enabled": True})

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counters}

    launches, record = {}, {}
    with (contextlib.nullcontext() if data is not None else
          tempfile.TemporaryDirectory(prefix="chip_smoke_decimal_")) as d:
        if data is None:
            data = star_decimal_data(pa, d, n_sales, dims)
        want, paths = data["oracle"], data["paths"]
        setup_s = data["setup_s"]
        sales_path = paths["store_sales"]
        batches = -(-pq.ParquetFile(sales_path).metadata.num_row_groups
                    // CHUNKS_PER_DISPATCH)

        # the FLBA decode alone: the five money columns, 4 row groups a
        # dispatch, against pq.read_table of the same columns
        pf = pq.ParquetFile(sales_path)
        kinds = {pf.metadata.schema.column(i).name:
                 (pf.metadata.schema.column(i).physical_type,
                  pf.metadata.schema.column(i).length)
                 for i in range(len(pf.metadata.schema))}
        if any(kinds[c] != ("FIXED_LEN_BYTE_ARRAY", 4) for c in STAR_MONEY):
            raise AssertionError(f"the money columns are not FLBA(4): "
                                 f"{kinds}")
        money_want = pq.read_table(sales_path, columns=list(STAR_MONEY))
        schema = Schema.from_arrow(money_want.schema)

        def decode():
            return list(P.device_decode_file(pf, sales_path, schema, dev,
                                             CHUNKS_PER_DISPATCH))
        check_decoded(pa, decode(), money_want, "the FLBA money columns")
        decode_walls, read_walls = [], []
        for _ in range(decode_rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode()
            torch.cuda.synchronize()
            decode_walls.append(time.perf_counter() - t0)
            del out
            t0 = time.perf_counter()
            pq.read_table(sales_path, columns=list(STAR_MONEY))
            read_walls.append(time.perf_counter() - t0)
        values = n_sales * len(STAR_MONEY)
        record["flba_decode"] = {
            "columns": list(STAR_MONEY), "values": values,
            "flba_bytes": values * 4, "wall_s": spread(decode_walls),
            "pq_read_table_s": spread(read_walls),
            "values_per_s": values / statistics.median(decode_walls),
            "exact_vs_pyarrow": True}

        ns = star_namespace()
        for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
            sq = star_decimal_queries(TpuSession(dict(conf, **extra), dev),
                                      ns, paths)
            shapes = {n: q.explain() for n, q in sq.items()}
            for n, q in sq.items():
                partial = [ln for ln in shapes[n].splitlines()
                           if "TpuFusedStageExec" in ln
                           and "PartialAgg[" in ln]
                if (plan == "distributed") != bool(partial):
                    raise AssertionError(f"decimal {n} ({plan}): the "
                                         "partial aggregate is not fused as "
                                         f"expected:\n{shapes[n]}")
            outs, run = counted(lambda: [q.collect() for q in sq.values()])
            for n, out in zip(sq, outs):
                check_star_decimal(pa, n, out, want[n])
            want_a = sum(2 * fused_joins(shapes[n]) * batches for n in sq)
            want_c = sum(STAR_DECIMAL_C_PER_BATCH[n] * batches for n in sq) \
                if plan == "distributed" else 0
            if run["murmur3_rows"] != want_a or \
                    run["segment_sum_i64"] != want_c or want_a == 0:
                raise AssertionError(f"decimal star ({plan}) launched {run}, "
                                     f"not A {want_a} and C {want_c}")
            path = "star_decimal" if plan == "one_device" else \
                "star_decimal_distributed"
            launches[path] = run
            if plan == "one_device":
                a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                                         sq["q7"].collect)
            else:
                c_args = first_call_args(torch, pallas_groupby,
                                         "segment_sum_i64", sq["q3"].collect)
            per_query = {}
            for n, q in sq.items():
                walls, seen = [], set()
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    out, c = counted(q.collect)
                    walls.append(time.perf_counter() - t0)
                    check_star_decimal(pa, n, out, want[n])
                    seen.add(tuple(sorted(c.items())))
                if len(seen) != 1:
                    raise AssertionError(f"decimal {n} ({plan}) launched "
                                         f"{sorted(seen)} per collect")
                per_query[n] = {"groups": len(next(iter(want[n].values()))),
                                "fused_joins": fused_joins(shapes[n]),
                                "warm_collect_s": spread(walls),
                                "launches_per_collect": dict(seen.pop()),
                                "device_idle_share": idle_share(torch,
                                                                q.collect)}
            record[plan] = {"queries": per_query,
                            "launches_per_path_run": run}
    emit({"phase": "star_decimal", "fact_rows": n_sales, "dim_rows": dims,
          "money_type": "decimal(%d,%d)" % MONEY, "sales_batches": batches,
          "setup_s": setup_s, "exact": "every decimal (int64 oracle), keys, "
          "counts, Q36 ratio", "rtol_double_average": 1e-9, **record})
    return launches, a_args, c_args


# ---- ordered_reports: the star reports' ORDER BY ... LIMIT 100, Q36's
# rank, a running window and an out-of-core sort over the decimal files
ORDERED_ROUNDS = 1
ORDERED_LIMIT = 100
# the TPC-DS orders (column, ascending, nulls_first) of each ordered report
ORDERED_KEYS = {
    "q3": (("d_year", True, True), ("sum_agg", False, False),
           ("i_brand", True, True)),
    "q7": (("i_category", True, True),),
    "q36": (("lochierarchy", False, False), ("parent", True, True),
            ("rank_within_parent", True, True), ("cat", True, True),
            ("bucket", True, True))}
# Q36's rollup(cat, bucket) levels: (grouping id, the columns it nulls)
ROLLUP_LEVELS = ((0, ()), (1, ("bucket",)), (3, ("cat", "bucket")))
# C a merged batch in the ordered reports: the decimal star's, but Q36's
# partial aggregate sits above its Expand, where fusion ends the chain, so
# it runs unfused and launches no C
ORDERED_C_PER_BATCH = dict(STAR_DECIMAL_C_PER_BATCH, q36=0)
# the per-(item, date) quantities sorted out of core under the distributed
# plan
OOC_KEYS = (("qty", False, False), ("ss_item_sk", True, True),
            ("ss_sold_date_sk", True, True))


def ordered_namespace() -> SimpleNamespace:
    """star_namespace with the window and bitwise constructors, the STRING
    type, and `Expand(df, projections, names)`, a DataFrame over the
    port's Expand node (the frontend has no rollup: a ROLLUP is an Expand
    below the aggregate)."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.frontend import DataFrame
    from spark_rapids_tpu_torch.plan.nodes import CpuExpandExec
    m = star_namespace()
    for n in ("Rank", "RowNumber", "Lag", "WindowAggregate", "RowFrame",
              "ShiftRight", "BitwiseAnd"):
        setattr(m, n, getattr(E, n))
    m.string = T.STRING
    m.Expand = lambda df, projections, names: DataFrame(
        df.session, CpuExpandExec(projections, names, df.plan))
    return m


def rollup_q36(m, base):
    """TPC-DS Q36's ROLLUP over star_decimal_queries' Q36 input `base`:
    rollup(cat, bucket) as an Expand with the grouping id g (0, 1, 3), the
    sums by (cat, bucket, g), grouping(x) as shiftright(g, k) & 1,
    lochierarchy = grouping(cat) + grouping(bucket), and rank() over
    (partition by lochierarchy, case when grouping(bucket) = 0 then cat
    end order by gross margin), that partition's second key kept as
    `parent` (it is also TPC-DS's `case when lochierarchy = 0 then cat
    end` of the ORDER BY)."""
    c, lit = m.col, m.lit
    cols = ("ss_net_profit", "ss_ext_sales_price", "margin", "cat",
            "bucket")
    projections = [[lit(None, m.string) if n in nulled else c(n)
                    for n in cols] + [lit(g)]
                   for g, nulled in ROLLUP_LEVELS]
    g = c("g")

    def grouping(k):
        return m.BitwiseAnd(m.ShiftRight(g, lit(k)), lit(1))

    return m.Expand(base, projections, cols + ("g",)) \
        .group_by("cat", "bucket", "g") \
        .agg(profit=m.Sum(c("ss_net_profit")),
             sales=m.Sum(c("ss_ext_sales_price")), hi=m.Max(c("margin")),
             lo=m.Min(c("margin")), n=m.Count(lit(1))) \
        .select("cat", "bucket", "profit", "sales", "hi", "lo", "n",
                gross_margin=c("profit") / c("sales"),
                lochierarchy=grouping(1) + grouping(0),
                parent=m.CaseWhen([(grouping(0) == lit(0), c("cat"))],
                                  lit(None, m.string))) \
        .window(partition_by=["lochierarchy", "parent"],
                order_by=[(c("gross_margin"), True, True)],
                rank_within_parent=m.Rank())


def ordered_queries(sess, m, paths: dict) -> dict:
    """star_decimal_queries' Q3 and Q7 in TPC-DS's ORDER BY ... LIMIT 100,
    Q36 in its true form (rollup_q36, ordered by lochierarchy desc, parent,
    rank_within_parent, then cat and bucket to break ties, LIMIT 100), the
    running window of q51 (a cumulative sum of the quantity per item over
    dates, its row number and the previous day's quantity) and the
    per-(item, date) quantities sorted by quantity."""
    c = m.col
    q = star_decimal_queries(sess, m, paths, rollup=True)
    out = {n: q[n].sort(*ORDERED_KEYS[n]).limit(ORDERED_LIMIT)
           for n in ("q3", "q7")}
    out["q36"] = rollup_q36(m, q["q36"]).sort(*ORDERED_KEYS["q36"]) \
        .limit(ORDERED_LIMIT)
    per_day = sess.read_parquet(
        paths["store_sales"],
        columns=["ss_item_sk", "ss_sold_date_sk", "ss_quantity"]) \
        .group_by("ss_item_sk", "ss_sold_date_sk") \
        .agg(qty=m.Sum(c("ss_quantity")))
    out["running_window"] = per_day.window(
        partition_by=["ss_item_sk"], order_by=["ss_sold_date_sk"],
        cum_qty=m.WindowAggregate(m.Sum(c("qty")), m.RowFrame(None, 0)),
        rn=m.RowNumber(), prev=m.Lag(c("qty"), 1))
    out["ooc_sort"] = per_day.sort(*OOC_KEYS)
    return out


def _sort_key(values, ascending: bool, nulls_first: bool):
    """One np.lexsort key of a list of values (ints, floats or strings,
    None for null) in the given order: its dense rank among the distinct
    values, nulls placed as asked."""
    vocab = sorted({v for v in values if v is not None})
    rank = {v: i for i, v in enumerate(vocab)}
    nul = -1 if nulls_first == ascending else len(vocab)
    key = np.array([nul if v is None else rank[v] for v in values], np.int64)
    return key if ascending else -key


def rollup_oracle(q36: dict) -> dict:
    """star_decimal_oracle's Q36 rows rolled up over (cat, bucket): the
    rows themselves (lochierarchy 0), one per category and one in all
    (sums and counts added, hi the max and lo the min of the non-null
    ones), each with its gross margin, lochierarchy, parent (the category
    at lochierarchy 0, else null) and rank within (lochierarchy, parent)
    by gross margin, nulls first."""
    def merged(rows):
        his = [r["hi"] for r in rows if r["hi"] is not None]
        los = [r["lo"] for r in rows if r["lo"] is not None]
        return {"profit": sum(r["profit"] for r in rows),
                "sales": sum(r["sales"] for r in rows),
                "hi": max(his) if his else None,
                "lo": min(los) if los else None,
                "n": sum(r["n"] for r in rows)}

    base = [dict(zip(q36, vals)) for vals in zip(*q36.values())]
    out = [dict(r, lochierarchy=0, parent=r["cat"]) for r in base]
    for cat in sorted({r["cat"] for r in base}):
        out.append(dict(merged([r for r in base if r["cat"] == cat]),
                        cat=cat, bucket=None, lochierarchy=1, parent=None))
    out.append(dict(merged(base), cat=None, bucket=None, lochierarchy=2,
                    parent=None))
    for r in out:
        p, s_ = r["profit"], r["sales"]
        r["gross_margin"] = None if s_ in (None, 0) else \
            float(np.float64(p) / np.float64(s_))
    for r in out:
        g = r["gross_margin"]
        r["rank_within_parent"] = 1 + sum(
            1 for h in out if (h["lochierarchy"], h["parent"]) ==
            (r["lochierarchy"], r["parent"]) and g is not None and (
                h["gross_margin"] is None or h["gross_margin"] < g))
    return {k: [r[k] for r in out] for k in out[0]}


def ordered_oracle(want: dict) -> dict:
    """The ordered reports' rows: star_decimal_oracle's Q3 and Q7 rows and
    Q36's rolled up (rollup_oracle), lexsorted on each report's keys, the
    first 100."""
    out = {}
    for name in ("q3", "q7", "q36"):
        cols = rollup_oracle(want[name]) if name == "q36" else \
            dict(want[name])
        keys = [_sort_key(cols[k], a, nf) for k, a, nf in ORDERED_KEYS[name]]
        order = np.lexsort(keys[::-1])[:ORDERED_LIMIT]
        out[name] = {k: [v[i] for i in order] for k, v in cols.items()}
    return out


def per_day_oracle(t: dict) -> dict:
    """numpy int64: the quantity of each (item, date) over all sales, in
    (item, date) order, with the running window's cum_qty, rn and prev
    (0 where null), and the out-of-core sort's order of those rows."""
    ss = t["store_sales"]
    n_dates = t["date_dim"].num_rows
    key = ss.column("ss_item_sk").to_numpy() * n_dates + \
        ss.column("ss_sold_date_sk").to_numpy()
    groups, gid = np.unique(key, return_inverse=True)
    qty = np.bincount(gid, weights=ss.column("ss_quantity").to_numpy()) \
        .astype(np.int64)
    item, date = groups // n_dates, groups % n_dates
    n = len(groups)
    first = np.r_[True, item[1:] != item[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    csum = np.cumsum(qty)
    return {"ss_item_sk": item, "ss_sold_date_sk": date, "qty": qty,
            "cum_qty": csum - csum[start] + qty[start],
            "rn": (np.arange(n) - start + 1).astype(np.int32),
            "prev": np.r_[0, qty[:-1]] * ~first, "prev_valid": ~first,
            "ooc_order": np.lexsort((date, item, -qty))}


def check_per_day(out, want: dict, what: str) -> None:
    """Raise unless a running-window or out-of-core-sort result equals the
    int64 oracle row for row."""
    cols = ("ss_item_sk", "ss_sold_date_sk", "qty")
    order = slice(None)
    if what == "ooc_sort":
        order = want["ooc_order"]
    else:
        cols += ("cum_qty", "rn", "prev")
    if out.num_rows != len(want["qty"]):
        raise AssertionError(f"{what}: {out.num_rows} rows, oracle "
                             f"{len(want['qty'])}")
    for col in cols:
        c = out.column(col)
        got = c.fill_null(0).to_numpy() if c.null_count else c.to_numpy()
        if col == "prev":
            valid = c.is_valid().to_numpy(zero_copy_only=False)
            if not np.array_equal(valid, want["prev_valid"]):
                raise AssertionError(f"{what}: the nulls of prev differ")
        if not np.array_equal(got, want[col][order]):
            raise AssertionError(f"{what}: column {col} differs from the "
                                 "oracle")


def ordered_phases(torch, pa, mesh_conf: dict, counters,
                   n_sales=STAR_SALES_ROWS, dims=STAR_DIMS, conf=None,
                   device=None, rounds=ORDERED_ROUNDS, data=None):
    """Phase ordered_reports, over star_decimal_data's files (made here in a
    temporary directory without `data`): the ordered Q3, Q7 and Q36 and the
    running window on one device and under the distributed plan
    (`mesh_conf`), and the out-of-core sort under the distributed plan.
    Each result is held against its oracle row for row; A and C launch as
    on the decimal star reports (A twice per fused join per merged batch,
    C ORDERED_C_PER_BATCH a merged batch, distributed only: none in Q36,
    whose partial aggregate sits above its rollup's Expand) and not at all
    in the running window and the sort, whose aggregate over a bare scan
    fuses nothing. Each plan's checked, counted run comes first and
    warms its queries up for the timed collects. Returns the launch counts
    of each plan's run (one collect of each query) and the arguments of A's first call in a
    one-device ordered Q7 collect and of C's first in a distributed
    ordered Q3 collect."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.exec import sort as S
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **{"spark.rapids.tpu.fusion.enabled": True})

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        S.COUNTERS.reset()
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counters}

    def check(name, out):
        if name in ("running_window", "ooc_sort"):
            check_per_day(out, per_day, name)
        else:
            check_star_decimal(pa, name, out, ordered[name], ordered=True)

    launches, record = {}, {}
    with (contextlib.nullcontext() if data is not None else
          tempfile.TemporaryDirectory(prefix="chip_smoke_ordered_")) as d:
        if data is None:
            data = star_decimal_data(pa, d, n_sales, dims)
        t0 = time.monotonic()
        ordered = ordered_oracle(data["oracle"])
        per_day = per_day_oracle(data["tables"])
        oracle_s = time.monotonic() - t0
        batches = -(-pq.ParquetFile(data["paths"]["store_sales"]).metadata
                    .num_row_groups // CHUNKS_PER_DISPATCH)
        m = ordered_namespace()
        for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
            qs = ordered_queries(TpuSession(dict(conf, **extra), dev), m,
                                 data["paths"])
            if plan == "one_device":
                del qs["ooc_sort"]  # one batch there: an in-core sort
            shapes = {n: q.explain() for n, q in qs.items()}
            for n in ("q3", "q7", "q36"):
                if not shapes[n].startswith("TpuTopKExec"):
                    raise AssertionError(f"ordered {n} ({plan}) is not a "
                                         f"top-k:\n{shapes[n]}")
            outs, run = counted(lambda: [q.collect() for q in qs.values()])
            for n, out in zip(qs, outs):
                check(n, out)
            del outs
            want_a = sum(2 * fused_joins(shapes[n]) * batches
                         for n in ("q3", "q7", "q36"))
            want_c = sum(ORDERED_C_PER_BATCH[n] * batches
                         for n in ("q3", "q7", "q36")) \
                if plan == "distributed" else 0
            if run["murmur3_rows"] != want_a or \
                    run["segment_sum_i64"] != want_c or want_a == 0:
                raise AssertionError(f"ordered reports ({plan}) launched "
                                     f"{run}, not A {want_a} and C {want_c}")
            path = "ordered_reports" if plan == "one_device" else \
                "ordered_reports_distributed"
            launches[path] = run
            if plan == "one_device":
                a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                                         qs["q7"].collect)
            else:
                c_args = first_call_args(torch, pallas_groupby,
                                         "segment_sum_i64", qs["q3"].collect)
            per_query = {}
            for n, q in qs.items():
                walls, seen, sorts, merge = [], set(), set(), []
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    out, c = counted(q.collect)
                    walls.append(time.perf_counter() - t0)
                    check(n, out)
                    del out
                    seen.add(tuple(sorted(c.items())))
                    snap = S.COUNTERS.snapshot()
                    sorts.add((snap["in_core"], snap["out_of_core"]))
                    merge.append(snap["host_merge_s"])
                if len(seen) != 1:
                    raise AssertionError(f"ordered {n} ({plan}) launched "
                                         f"{sorted(seen)} per collect")
                if n == "ooc_sort" and sorts != {(0, 1)}:
                    raise AssertionError(f"the sort ran (in core, out of "
                                         f"core) {sorts}, not out of core")
                rec = {"rows": len(per_day["qty"]) if n in (
                           "running_window", "ooc_sort") else
                       len(next(iter(ordered[n].values()))),
                       "fused_joins": fused_joins(shapes[n]),
                       "warm_collect_s": spread(walls),
                       "launches_per_collect": dict(seen.pop()),
                       "sorts_in_core_out_of_core": sorted(sorts)}
                if n == "ooc_sort":
                    rec["host_merge_s"] = spread(merge)
                    rec["host_merge_share"] = statistics.median(
                        x / w for x, w in zip(merge, walls))
                if n == "running_window" and plan == "one_device":
                    rec["device_idle_share"] = idle_share(torch, q.collect)
                per_query[n] = rec
            record[plan] = {"queries": per_query,
                            "launches_per_path_run": run,
                            "plan_q36": shapes["q36"].splitlines()}
    emit({"phase": "ordered_reports", "fact_rows": n_sales, "dim_rows": dims,
          "sales_batches": batches, "oracle_s": oracle_s,
          "per_day_groups": len(per_day["qty"]),
          "exact": "every column against the numpy int64 oracles, row for "
          "row", "rtol_double_average": 1e-9, **record})
    return launches, a_args, c_args


# ---- tpcds_joins: TPC-DS q97, q10, q58 and q28 shapes: a full outer join
# of two aggregates (the sub-partition join on one device), existence
# joins under OR, string-keyed joins with conditions, and cross joins of
# one-row aggregates
JOIN_SIZES = {"store_sales": 16_777_216, "catalog_sales": 8_388_608,
              "web_sales": 4_194_304, "date_dim": 73_049, "item": 102_000,
              "customer": 500_000, "customer_address": 250_000,
              "customer_demographics": 1_920_800}
# customer_demographics is dsdgen's cross product of its eight attributes,
# the first varying fastest: 2 x 5 x 7 x 20 x 4 x 7 x 7 x 7 = 1,920,800
CD_ATTRS = (("cd_gender", ("M", "F")),
            ("cd_marital_status", ("M", "S", "D", "W", "U")),
            ("cd_education_status", ("Primary", "Secondary", "College",
                                     "2 yr Degree", "4 yr Degree",
                                     "Advanced Degree", "Unknown")),
            ("cd_purchase_estimate", tuple(range(500, 10_001, 500))),
            ("cd_credit_rating", ("Good", "High Risk", "Low Risk",
                                  "Unknown")),
            ("cd_dep_count", tuple(range(7))),
            ("cd_dep_employed_count", tuple(range(7))),
            ("cd_dep_college_count", tuple(range(7))))
FIRST_DATE_SK = 2_415_022  # date_dim's d_date_sk of 1900-01-02
N_STORES = 102  # TPC-DS store at SF10
SOLD_DATE_SK = (2_450_816, 2_452_642)  # the sales' five years
Q10_COUNTIES = ("Rush County", "Toole County", "Jefferson County",
                "Dona Ana County", "La Porte County")
N_COUNTIES = 1_800
# q28's six buckets: quantity from, to; the lower bounds of list price,
# coupon amount and wholesale cost (ranges of 10, 1000 and 20)
Q28_BUCKETS = ((0, 5, 8, 459, 57), (6, 10, 90, 2323, 31),
               (11, 15, 142, 12214, 79), (16, 20, 135, 6071, 38),
               (21, 25, 122, 836, 17), (26, 30, 154, 7326, 7))
# q58's band: each channel's revenue within +-10 % of the others'
Q58_BAND = 0.1
# q97's month window: d_month_seq over the sales' whole five years
Q97_MONTHS = (1176, 1236)
JOINS_LIMIT = 100
JOINS_ROUNDS = 1
# sold dates are uniform over every row group, so dynamic pruning would
# skip nothing, and a join carrying its filter is not fused (in either
# engine): the phase turns it off so the date joins fuse and launch A
JOINS_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False}


def _item_ids(n: int):
    """TPC-DS i_item_id: 16 characters, "AAAAAAAA" and then the id's
    number in base 16 with the letters A to P; each id on two item rows,
    as TPC-DS keeps two versions of an item."""
    k = np.arange(n) // 2 + 1
    chars = np.full((n, 16), ord("A"), np.uint8)
    chars[:, 8:] += ((k[:, None] >> (4 * np.arange(7, -1, -1))) & 15) \
        .astype(np.uint8)
    return chars.view("S16").ravel().astype(str)


def _cd_codes(n: int):
    """The attribute codes of customer_demographics rows 1..n, the first
    attribute varying fastest (dsdgen's order)."""
    return np.unravel_index(np.arange(n), [len(v) for _, v in CD_ATTRS],
                            order="F")


def _first_day(sizes) -> int:
    """date_dim's first day after 1900-01-02: none at full size, the
    sales' first day when the table is cut (it then starts there)."""
    return 0 if sizes["date_dim"] >= JOIN_SIZES["date_dim"] else \
        SOLD_DATE_SK[0] - FIRST_DATE_SK


def join_tables(pa, sizes=JOIN_SIZES, seed: int = 31) -> dict:
    """The tables of the tpcds_joins phase at `sizes`, from one seed: the
    date_dim of TPC-DS (d_date_sk from 2,415,022 for 1900-01-02, with
    d_year, d_moy, d_qoy and d_month_seq; cut below its 73,049 days, it
    starts at the sales' first day), items whose i_item_id each
    stands on two rows, customers with an address and a demographics row
    drawn uniformly, addresses whose ca_county is drawn from 1,800 names
    (q10's five among them), customer_demographics as dsdgen's cross
    product (cut to its first rows below full size), and the three sales
    tables, sold dates uniform over 1998-01-02 .. 2003-01-02 and
    customers and items uniform, their money columns decimal(7,2); store
    sales also carry ss_store_sk (uniform over 102 stores) and items
    i_category (TPC-DS's ten), from a second generator."""
    if sizes["customer_demographics"] > int(np.prod(
            [len(v) for _, v in CD_ATTRS])):
        raise ValueError("customer_demographics has 1,920,800 rows at most")
    rng = np.random.default_rng(seed)
    n_item, n_cust = sizes["item"], sizes["customer"]
    n_addr, n_cd = sizes["customer_address"], sizes["customer_demographics"]
    day = np.arange(sizes["date_dim"]) + _first_day(sizes)
    when = np.datetime64("1900-01-02") + day
    year = when.astype("datetime64[Y]").astype(np.int64) + 1970
    moy = when.astype("datetime64[M]").astype(np.int64) % 12 + 1
    t = {"date_dim": pa.table({
        "d_date_sk": FIRST_DATE_SK + day,
        "d_year": year.astype(np.int32), "d_moy": moy.astype(np.int32),
        "d_qoy": ((moy - 1) // 3 + 1).astype(np.int32),
        "d_month_seq": ((year - 1900) * 12 + moy - 1).astype(np.int32)})}
    t["item"] = pa.table({"i_item_sk": np.arange(1, n_item + 1),
                          "i_item_id": pa.array(_item_ids(n_item))})
    cd = {"cd_demo_sk": np.arange(1, n_cd + 1)}
    for (name, vals), codes in zip(CD_ATTRS, _cd_codes(n_cd)):
        col = np.array(vals)[codes]
        cd[name] = pa.array(col.astype(np.int32) if col.dtype.kind == "i"
                            else col)
    t["customer_demographics"] = pa.table(cd)
    counties = np.array(list(Q10_COUNTIES) + [
        f"County {i}" for i in range(N_COUNTIES - len(Q10_COUNTIES))])
    t["customer_address"] = pa.table({
        "ca_address_sk": np.arange(1, n_addr + 1),
        "ca_county": pa.array(counties[rng.integers(0, N_COUNTIES,
                                                    n_addr)])})
    t["customer"] = pa.table({
        "c_customer_sk": np.arange(1, n_cust + 1),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n_cust),
        "c_current_cdemo_sk": rng.integers(1, n_cd + 1, n_cust)})

    def sales(p: str, n: int, customers, money) -> None:
        cols = {f"{p}_sold_date_sk": rng.integers(SOLD_DATE_SK[0],
                                                  SOLD_DATE_SK[1] + 1, n),
                f"{p}_item_sk": rng.integers(1, n_item + 1, n)}
        for c in customers:
            cols[f"{p}_{c}"] = rng.integers(1, n_cust + 1, n)
        # quantities to 100 in store, 200 in catalog, 400 on the web: each
        # channel's revenue an item is then of one size, as q58's +-10 %
        # conditions expect (uniform items would leave no item otherwise)
        qty = rng.integers(1, 100 * sizes["store_sales"] // n + 1, n)
        wholesale = rng.integers(100, 10_001, n)  # 1.00 .. 100.00
        lst = (wholesale * rng.uniform(1.0, 2.0, n)).astype(np.int64)
        ext = (lst * rng.uniform(0.2, 1.0, n)).astype(np.int64) * qty
        vals = {"quantity": qty.astype(np.int32),
                "wholesale_cost": wholesale, "list_price": lst,
                "coupon_amt": np.where(rng.random(n) < 0.2, (
                    ext * rng.uniform(0, 0.5, n)).astype(np.int64), 0),
                "ext_sales_price": ext}
        for name in money:
            v = vals[name]
            cols[f"{p}_{name}"] = v if v.dtype == np.int32 else \
                decimal_array(pa, v, *MONEY)
        t[f"{p}_table"] = pa.table(cols)

    sales("ss", sizes["store_sales"], ("customer_sk",),
          ("quantity", "wholesale_cost", "list_price", "coupon_amt",
           "ext_sales_price"))
    sales("cs", sizes["catalog_sales"],
          ("bill_customer_sk", "ship_customer_sk"), ("ext_sales_price",))
    sales("ws", sizes["web_sales"], ("bill_customer_sk",),
          ("ext_sales_price",))
    for p, name in (("ss", "store_sales"), ("cs", "catalog_sales"),
                    ("ws", "web_sales")):
        t[name] = t.pop(f"{p}_table")
    # the plan_nodes phase's store and category, from a generator of their
    # own, so every column above keeps its values
    extra = np.random.default_rng(seed + 1)
    t["store_sales"] = t["store_sales"].append_column(
        "ss_store_sk", pa.array(extra.integers(
            1, N_STORES + 1, sizes["store_sales"])))
    t["item"] = t["item"].append_column("i_category", pa.array(
        np.array(STAR_CATEGORIES)[extra.integers(
            0, len(STAR_CATEGORIES), n_item)]))
    return t


def join_namespace() -> SimpleNamespace:
    """The port's constructors that join_queries uses, and its DOUBLE and
    decimal(7,2) types."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    m = SimpleNamespace(**{n: getattr(E, n) for n in (
        "col", "lit", "Sum", "Count", "Average", "CaseWhen", "IsNull",
        "IsNotNull", "In")})
    m.double, m.money = T.DOUBLE, T.DecimalType(*MONEY)
    return m


def join_queries(sess, m, paths: dict) -> dict:
    """q97, q10, q58 and q28 as DataFrames of `sess` over the parquet files
    of join_tables, written once for either engine through the namespace
    `m` (join_namespace for the port), and q58's joins before their
    conditions (`q58_pairs`, the pairs counted). Departures from TPC-DS:
    q97's months span the sales' five years; q10 reads
    cs_ship_customer_sk and keeps its six counts; q58 takes the quarter
    (d_year 2000, d_qoy 1) for its week and compares the revenues cast to
    DOUBLE; q28 leaves out count(distinct)."""
    from decimal import Decimal
    from functools import reduce
    c, lit = m.col, m.lit

    def read(name, cols):
        return sess.read_parquet(paths[name], columns=cols)

    def dates(cond, key, cols):
        return read("date_dim", ["d_date_sk"] + cols).filter(cond) \
            .select(**{key: c("d_date_sk")})

    def flag(cond):
        return m.Sum(m.CaseWhen([(cond, lit(1))], lit(0)))

    months = (c("d_month_seq") >= lit(Q97_MONTHS[0])) & \
        (c("d_month_seq") <= lit(Q97_MONTHS[1]))

    def pairs(table, p, cust, tag):
        date = f"{p}_sold_date_sk"
        return read(table, [date, cust, f"{p}_item_sk"]) \
            .join(dates(months, date, ["d_month_seq"]), on=date) \
            .select(customer_sk=c(cust), item_sk=c(f"{p}_item_sk")) \
            .group_by("customer_sk", "item_sk").agg() \
            .select("customer_sk", "item_sk", **{tag: c("customer_sk")})

    s_cust, c_cust = c("s_cust"), c("c_cust")
    q97 = pairs("store_sales", "ss", "ss_customer_sk", "s_cust").join(
        pairs("catalog_sales", "cs", "cs_bill_customer_sk", "c_cust"),
        on=["customer_sk", "item_sk"], how="full").agg(
        store_only=flag(m.IsNotNull(s_cust) & m.IsNull(c_cust)),
        catalog_only=flag(m.IsNull(s_cust) & m.IsNotNull(c_cust)),
        store_and_catalog=flag(m.IsNotNull(s_cust) & m.IsNotNull(c_cust)))

    early_2002 = (c("d_year") == lit(2002)) & (c("d_moy") >= lit(1)) & \
        (c("d_moy") <= lit(4))

    def buyers(table, p, cust):
        date = f"{p}_sold_date_sk"
        return read(table, [date, cust]) \
            .join(dates(early_2002, date, ["d_year", "d_moy"]), on=date) \
            .select(c_customer_sk=c(cust))

    demo = [name for name, _ in CD_ATTRS]
    addresses = read("customer_address", ["ca_address_sk", "ca_county"]) \
        .filter(m.In(c("ca_county"), list(Q10_COUNTIES))) \
        .select(c_current_addr_sk=c("ca_address_sk"))
    demographics = read("customer_demographics", ["cd_demo_sk"] + demo) \
        .select(*demo, c_current_cdemo_sk=c("cd_demo_sk"))
    q10 = read("customer", ["c_customer_sk", "c_current_addr_sk",
                            "c_current_cdemo_sk"]) \
        .join(addresses, on="c_current_addr_sk") \
        .join(demographics, on="c_current_cdemo_sk") \
        .join(buyers("store_sales", "ss", "ss_customer_sk"),
              on="c_customer_sk", how="semi") \
        .join(buyers("web_sales", "ws", "ws_bill_customer_sk"),
              on="c_customer_sk", how="existence") \
        .select("c_customer_sk", *demo, exists_ws=c("exists")) \
        .join(buyers("catalog_sales", "cs", "cs_ship_customer_sk"),
              on="c_customer_sk", how="existence") \
        .filter(c("exists_ws") | c("exists")) \
        .group_by(*demo).agg(**{f"cnt{i}": m.Count(lit(1))
                                for i in range(1, 7)}) \
        .sort(*demo).limit(JOINS_LIMIT)

    q1_2000 = (c("d_year") == lit(2000)) & (c("d_qoy") == lit(1))

    def revenue(table, p, name):
        date, item = f"{p}_sold_date_sk", f"{p}_item_sk"
        items = read("item", ["i_item_sk", "i_item_id"]) \
            .select("i_item_id", **{item: c("i_item_sk")})
        return read(table, [date, item, f"{p}_ext_sales_price"]) \
            .join(dates(q1_2000, date, ["d_year", "d_qoy"]), on=date) \
            .join(items, on=item).group_by("i_item_id") \
            .agg(**{name: m.Sum(c(f"{p}_ext_sales_price"))})

    def d(name):
        return c(name).cast(m.double)

    def near(a, b):
        return (d(a) >= lit(1 - Q58_BAND) * d(b)) & \
            (d(a) <= lit(1 + Q58_BAND) * d(b))

    ss, cs, ws = (revenue("store_sales", "ss", "ss_item_rev"),
                  revenue("catalog_sales", "cs", "cs_item_rev"),
                  revenue("web_sales", "ws", "ws_item_rev"))
    q58_pairs = ss.join(cs, on="i_item_id").join(ws, on="i_item_id") \
        .agg(pairs=m.Count(lit(1)))
    total = d("ss_item_rev") + d("cs_item_rev") + d("ws_item_rev")
    q58 = ss.join(cs, on="i_item_id",
                  condition=near("ss_item_rev", "cs_item_rev")
                  & near("cs_item_rev", "ss_item_rev")) \
        .join(ws, on="i_item_id",
              condition=near("ss_item_rev", "ws_item_rev")
              & near("cs_item_rev", "ws_item_rev")
              & near("ws_item_rev", "ss_item_rev")
              & near("ws_item_rev", "cs_item_rev")) \
        .select("i_item_id", "ss_item_rev", "cs_item_rev", "ws_item_rev",
                ss_dev=d("ss_item_rev") / (total / lit(3.0)) * lit(100.0),
                cs_dev=d("cs_item_rev") / (total / lit(3.0)) * lit(100.0),
                ws_dev=d("ws_item_rev") / (total / lit(3.0)) * lit(100.0),
                average=total / lit(3.0)) \
        .sort("i_item_id", "ss_item_rev").limit(JOINS_LIMIT)

    def between(name, lo, width):
        return (c(name) >= lit(Decimal(lo), m.money)) & \
            (c(name) <= lit(Decimal(lo + width), m.money))

    buckets = [read("store_sales", ["ss_quantity", "ss_list_price",
                                    "ss_coupon_amt", "ss_wholesale_cost"])
               .filter((c("ss_quantity") >= lit(q_lo))
                       & (c("ss_quantity") <= lit(q_hi))
                       & (between("ss_list_price", lp, 10)
                          | between("ss_coupon_amt", cp, 1000)
                          | between("ss_wholesale_cost", wc, 20)))
               .agg(**{f"B{i}_LP": m.Average(c("ss_list_price")),
                       f"B{i}_CNT": m.Count(c("ss_list_price"))})
               for i, (q_lo, q_hi, lp, cp, wc) in enumerate(Q28_BUCKETS, 1)]
    q28 = reduce(lambda a, b: a.cross_join(b), buckets)
    return {"q97": q97, "q10": q10, "q58": q58, "q58_pairs": q58_pairs,
            "q28": q28}


def _money(t, name: str) -> np.ndarray:
    return unscaled(t.column(name))[0]


def join_oracle(pa, t: dict) -> dict:
    """numpy answers to join_queries over join_tables' tables: counts and
    decimals (as unscaled ints) exact, q28's averages by decimal_mean's
    HALF_UP, q58's doubles computed in the query's order."""
    dd = t["date_dim"]
    year, moy, qoy, mseq = (dd.column(n).to_numpy() for n in (
        "d_year", "d_moy", "d_qoy", "d_month_seq"))
    ss, cs, ws = t["store_sales"], t["catalog_sales"], t["web_sales"]

    def col(tab, name):
        return tab.column(name).to_numpy()

    first = col(dd, "d_date_sk")[0]

    def when(tab, p, ok):
        return ok[col(tab, f"{p}_sold_date_sk") - first]

    n_cust, n_item = t["customer"].num_rows, t["item"].num_rows
    out = {}

    window = (mseq >= Q97_MONTHS[0]) & (mseq <= Q97_MONTHS[1])
    pair = {}
    for tab, p, cust in ((ss, "ss", "ss_customer_sk"),
                         (cs, "cs", "cs_bill_customer_sk")):
        k = when(tab, p, window)
        pair[p] = np.unique(col(tab, cust)[k] * (n_item + 1)
                            + col(tab, f"{p}_item_sk")[k])
    both = len(np.intersect1d(pair["ss"], pair["cs"], assume_unique=True))
    out["q97"] = {"store_only": [len(pair["ss"]) - both],
                  "catalog_only": [len(pair["cs"]) - both],
                  "store_and_catalog": [both]}

    early_2002 = (year == 2002) & (moy >= 1) & (moy <= 4)
    bought = {}
    for tab, p, cust in ((ss, "ss", "ss_customer_sk"),
                         (ws, "ws", "ws_bill_customer_sk"),
                         (cs, "cs", "cs_ship_customer_sk")):
        b = np.zeros(n_cust + 1, bool)
        b[col(tab, cust)[when(tab, p, early_2002)]] = True
        bought[p] = b[1:]
    county = np.isin(np.array(t["customer_address"].column("ca_county")
                              .to_pylist()), Q10_COUNTIES)
    cust = t["customer"]
    keep = county[col(cust, "c_current_addr_sk") - 1] & bought["ss"] & \
        (bought["ws"] | bought["cs"])
    codes = _cd_codes(t["customer_demographics"].num_rows)
    demo_row = col(cust, "c_current_cdemo_sk")[keep] - 1
    keys = {}
    for (name, vals), cd in zip(CD_ATTRS, codes):
        vocab = sorted(vals)
        rank = np.array([vocab.index(v) for v in vals])
        keys[name] = (rank[cd[demo_row]], vocab)
    ones = np.ones(len(demo_row), bool)
    q10 = _grouped_exact(keys, {f"cnt{i}": ("count", ones, ones)
                                for i in range(1, 7)})
    out["q10"] = {k: v[:JOINS_LIMIT] for k, v in q10.items()}

    q1_2000 = (year == 2000) & (qoy == 1)
    n_ids = (n_item + 1) // 2
    rev, seen = {}, {}
    for tab, p in ((ss, "ss"), (cs, "cs"), (ws, "ws")):
        k = when(tab, p, q1_2000)
        ids = (col(tab, f"{p}_item_sk")[k] - 1) // 2
        r = np.zeros(n_ids, np.int64)
        np.add.at(r, ids, _money(tab, f"{p}_ext_sales_price")[k])
        rev[p], seen[p] = r, np.bincount(ids, minlength=n_ids) > 0
    present = seen["ss"] & seen["cs"] & seen["ws"]
    out["q58_pairs"] = {"pairs": [int(present.sum())]}
    dbl = {p: rev[p].astype(np.float64) / 100.0 for p in rev}

    def near(a, b):
        return (dbl[a] >= (1 - Q58_BAND) * dbl[b]) & \
            (dbl[a] <= (1 + Q58_BAND) * dbl[b])

    ok = present & near("ss", "cs") & near("cs", "ss") & \
        near("ss", "ws") & near("cs", "ws") & near("ws", "ss") & \
        near("ws", "cs")
    ids = np.flatnonzero(ok)[:JOINS_LIMIT]  # ids sort as their numbers
    total = dbl["ss"][ids] + dbl["cs"][ids] + dbl["ws"][ids]
    out["q58"] = {"i_item_id": list(_item_ids(2 * n_ids)[2 * ids]),
                  **{f"{p}_item_rev": rev[p][ids].tolist()
                     for p in ("ss", "cs", "ws")},
                  **{f"{p}_dev": (dbl[p][ids] / (total / 3.0)
                                  * 100.0).tolist()
                     for p in ("ss", "cs", "ws")},
                  "average": (total / 3.0).tolist()}

    qty = col(ss, "ss_quantity")
    lst, cpn, wc = (_money(ss, f"ss_{n}") for n in (
        "list_price", "coupon_amt", "wholesale_cost"))

    def between(v, lo, width):
        return (v >= lo * 100) & (v <= (lo + width) * 100)

    q28 = {}
    for i, (q_lo, q_hi, lp, cp, w) in enumerate(Q28_BUCKETS, 1):
        k = (qty >= q_lo) & (qty <= q_hi) & (
            between(lst, lp, 10) | between(cpn, cp, 1000)
            | between(wc, w, 20))
        n = int(k.sum())
        q28[f"B{i}_LP"] = [int(decimal_mean(np.array([lst[k].sum()]),
                                            np.array([n]))[0])
                           if n else None]
        q28[f"B{i}_CNT"] = [n]
    out["q28"] = q28
    return out


# every decimal result's (precision, scale): a Sum over decimal(7,2) is
# decimal(17,2), an Average decimal(11,6); doubles compare at rtol 1e-9
JOIN_DECIMALS = {"q58": {f"{p}_item_rev": (17, 2) for p in ("ss", "cs",
                                                             "ws")},
                 "q28": {f"B{i}_LP": (11, 6) for i in range(1, 7)}}
JOIN_APPROX = {"q58": ("ss_dev", "cs_dev", "ws_dev", "average")}


def check_join_query(pa, name: str, out, want: dict) -> None:
    """Raise unless `out` equals the oracle row for row, in the query's
    order: decimals (with their types) as unscaled ints, q58's doubles
    within rtol 1e-9, everything else exactly."""
    n = len(next(iter(want.values())))
    if out.num_rows != n or out.column_names != list(want):
        raise AssertionError(f"{name}: {out.num_rows} rows of "
                             f"{out.column_names}, oracle {n} of "
                             f"{list(want)}")
    for col, exp in want.items():
        c = out.column(col)
        if col in JOIN_DECIMALS.get(name, {}):
            if c.type != pa.decimal128(*JOIN_DECIMALS[name][col]):
                raise AssertionError(f"{name}: column {col} is {c.type}")
            vals, valid = unscaled(c)
            got = [int(v) if ok else None for v, ok in zip(vals, valid)]
        else:
            got = c.to_pylist()
        if col in JOIN_APPROX.get(name, ()):
            ok = np.allclose(got, exp, rtol=1e-9, atol=0.0)
        else:
            ok = got == exp
        if not ok:
            raise AssertionError(f"{name}: column {col} differs from the "
                                 "oracle")


# kernel launches of one collect of each query, as PERF.md predicts them
# for join_tables' files at JOIN_SIZES (store_sales 16 row groups: 4
# merged batches; catalog_sales 2; web_sales 1). A: 2 per fused join per
# merged batch of its stage's scan (one int64 key: the probe's and the
# build's hash), on the date joins of q97 (store and catalog) and q10
# (store, web, catalog) and on q58's date and item joins (both plans:
# every other join is shuffled or a nested loop). C: the distributed
# fused partial aggregates' int64 sums: q10's six counts over the 4 shard
# batches of its existence join, q58's decimal sums (2 a batch) over 7
# scan batches; none on one device
JOINS_LAUNCHES = {
    "one_device": {"q97": (12, 0), "q10": (14, 0), "q58": (28, 0),
                   "q58_pairs": (28, 0), "q28": (0, 0)},
    "distributed": {"q97": (12, 0), "q10": (14, 24), "q58": (28, 14),
                    "q58_pairs": (28, 14), "q28": (0, 0)},
}


def join_data(pa, d: str, sizes=JOIN_SIZES) -> dict:
    """join_tables, their oracle and their parquet files in directory d,
    with the seconds each took, and the plan_nodes phase's input
    (plan_nodes_data)."""
    import pyarrow.parquet as pq
    t0 = time.monotonic()
    tables = join_tables(pa, sizes)
    t1 = time.monotonic()
    want = join_oracle(pa, tables)
    t2 = time.monotonic()
    paths = write_parquet(pq, tables, d, tag="_joins")
    t3 = time.monotonic()
    return {"tables": tables, "oracle": want, "paths": paths,
            "plan_nodes": plan_nodes_data(pa, tables, d),
            "tables_s": t1 - t0, "oracle_s": t2 - t1, "write_s": t3 - t2,
            "plan_nodes_s": time.monotonic() - t3}


def joins_phases(torch, pa, mesh_conf: dict, counters, sizes=JOIN_SIZES,
                 conf=None, device=None, rounds=JOINS_ROUNDS, warmup=True,
                 want_launches=JOINS_LAUNCHES, data=None):
    """Phase tpcds_joins: q97, q10, q58 (and its joins before their
    conditions) and q28 over join_tables' parquet files, on one device and
    under the distributed plan (`mesh_conf`), fusion on and dynamic
    pruning off (JOINS_CONF). After a warm-up collect of each query (with
    `warmup`), each is collected `rounds` times, timed: every result is
    held against join_oracle row for row and every collect's launches of
    A and C against `want_launches`, and q97's one-device collects must
    take the sub-partition join (its build side, the catalog pairs, is
    over subPartition.rows). q97's device idle share comes from one
    traced collect. Returns the launch counts of each plan's run (one
    collect of each query) and the arguments of A's first call in a
    one-device q97 collect and of C's first in a distributed q58
    collect."""
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **JOINS_CONF,
                **{"spark.rapids.tpu.fusion.enabled": True})

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        J.COUNTERS.reset()
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counters}

    launches, record = {}, {}
    with (contextlib.nullcontext() if data is not None else
          tempfile.TemporaryDirectory(prefix="chip_smoke_joins_")) as d:
        if data is None:
            data = join_data(pa, d, sizes)
        want, paths = data["oracle"], data["paths"]
        m = join_namespace()
        for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
            qs = join_queries(TpuSession(dict(conf, **extra), dev), m, paths)
            shapes = {n: q.explain() for n, q in qs.items()}
            if warmup:
                for n, q in qs.items():
                    check_join_query(pa, n, q.collect(), want[n])
            per_query, run = {}, {}
            for n, q in qs.items():
                walls, a, c = [], *want_launches[plan][n]
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    out, run[n] = counted(q.collect)
                    walls.append(time.perf_counter() - t0)
                    check_join_query(pa, n, out, want[n])
                    del out
                    split = J.COUNTERS.snapshot()
                    if (run[n]["murmur3_rows"], run[n]["segment_sum_i64"],
                            run[n]["segment_sum_f64"]) != (a, c, 0):
                        raise AssertionError(f"{n} ({plan}) launched "
                                             f"{run[n]}, not A {a} and C {c}")
                    if n == "q97" and plan == "one_device" and \
                            split["sub_partition_builds"] != 1:
                        raise AssertionError("q97 on one device did not take "
                                             f"the sub-partition join: {split}")
                per_query[n] = {
                    "rows": len(next(iter(want[n].values()))),
                    "warm_collect_s": spread(walls),
                    "launches_per_collect": run[n], "join_counters": split,
                    "joins": re.findall(r"(\w+JoinExec\[\w+)", shapes[n])}
            path = "tpcds_joins" if plan == "one_device" else \
                "tpcds_joins_distributed"
            launches[path] = {k: sum(r[k] for r in run.values())
                              for k in run["q97"]}
            if plan == "one_device":
                a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                                         qs["q97"].collect)
                per_query["q97"]["device_idle_share"] = idle_share(
                    torch, qs["q97"].collect)
            else:
                c_args = first_call_args(torch, pallas_groupby,
                                         "segment_sum_i64", qs["q58"].collect)
            record[plan] = {"queries": per_query,
                            "launches_per_path_run": launches[path]}
    emit({"phase": "tpcds_joins", "sizes": sizes,
          "answers": {"q97": want["q97"], "q58_pairs": want["q58_pairs"],
                      "q58_rows": len(want["q58"]["i_item_id"])},
          "setup_s": {k: data[k] for k in ("tables_s", "oracle_s",
                                           "write_s")},
          "exact": "counts and decimals (unscaled ints) against the numpy "
          "oracle, row for row", "rtol_double": 1e-9, **record})
    return launches, a_args, c_args


# ---- tpcds_aggregates (slice 9): TPC-DS q65 (an average of revenue sums,
# a 128-bit decimal partial sum across the exchange) and q39a/q39b
# (stddev_samp over inventory, a self-join of the grouped result), and the
# sales price as Spark's decimal(38,18) from parquet (FIXED_LEN_BYTE_ARRAY
# of 16 bytes). TPC-DS v3.2.0 at SF10 (Table 3-2): store_sales cut from
# 28.8 M rows, inventory from 261 weeks to 33 (q39 reads January and
# February of 2001 alone), every dimension at full size
AGG_SIZES = {"store_sales": 16_777_216, "date_dim": 73_049, "item": 102_000,
             "store": 102, "warehouse": 10, "inventory_weeks": 33}
INV_FIRST_WEEK = "2001-01-01"  # the cut inventory's weeks start here
INV_NULL_SHARE = 0.05  # inv_quantity_on_hand
PRICE_NULL_SHARE = 0.03  # ss_sales_price
Q65_MONTHS = (1176, 1187)  # TPC-DS's d_month_seq window: 1998
Q65_BAND = 0.1  # sc.revenue <= 0.1 * sb.ave
Q39_YEAR = 2001
Q39_COVS = (1.0, 1.5)  # q39a's and q39b's cut-offs on cov
AGG_LIMIT = 100
AGG_ROUNDS = 1
DEC38 = (38, 18)  # Spark's SYSTEM_DEFAULT decimal
DEC38_SHIFT = DEC38[1] - MONEY[1]  # decimal(7,2) cents -> scale 18
WAREHOUSE_WORDS = ("Conventional", "Important", "Doors", "Bad", "Matters",
                   "Significant", "Just", "Hard", "Old", "New")
# the rows q39 keeps and q65's ORDER BY: a store name and an item
# description are unique, so both orders are total
ITEM_DESC_BYTES = (4, 200)


def _words(rng, n: int, lo: int, hi: int, prefix=None):
    """n random lowercase texts of lo..hi bytes (with spaces), built as one
    Arrow string array from numpy buffers; `prefix` (uint8[n, k]) opens
    each one."""
    import pyarrow as pa
    lens = rng.integers(lo, hi + 1, n)
    chars = rng.integers(ord("a"), ord("z") + 2, (n, hi)).astype(np.uint8)
    chars[chars > ord("z")] = ord(" ")
    if prefix is not None:
        chars[:, :prefix.shape[1]] = prefix
    keep = np.arange(hi)[None, :] < lens[:, None]
    offsets = np.concatenate(([0], np.cumsum(lens))).astype(np.int32)
    return pa.Array.from_buffers(pa.string(), n, [
        None, pa.py_buffer(offsets.tobytes()),
        pa.py_buffer(chars[keep].tobytes())])


def _item_codes(rng, n: int):
    """uint8[n, 4]: four letters unique to each item, in shuffled order."""
    code = rng.permutation(26 ** 4)[:n]
    return (ord("a") + (code[:, None] // 26 ** np.arange(3, -1, -1)) % 26) \
        .astype(np.uint8)


def dec38_array(pa, cents, valid=None):
    """decimal(7,2) cents -> the same values as an Arrow decimal(38,18)
    array (unscaled cents x 10^16, two 64-bit words a value), vectorised:
    the words of each distinct cents value are computed once."""
    vals, inv = np.unique(np.asarray(cents, np.int64), return_inverse=True)
    table = np.array([[(v * 10 ** DEC38_SHIFT) & (2 ** 64 - 1),
                       ((v * 10 ** DEC38_SHIFT) >> 64) & (2 ** 64 - 1)]
                      for v in vals.tolist()], np.uint64).reshape(-1, 2)
    words = table[inv.ravel()].view(np.int64)
    nulls = 0 if valid is None else int((~valid).sum())
    bitmap = pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()) \
        if nulls else None
    return pa.Array.from_buffers(pa.decimal128(*DEC38), len(words),
                                 [bitmap, pa.py_buffer(words.tobytes())],
                                 null_count=nulls)


def agg_tables(pa, sizes=AGG_SIZES, seed: int = 47) -> dict:
    """The tables of the tpcds_aggregates and strings phases from one
    seed: date_dim as join_tables builds it, with TPC-DS's d_date; item with i_item_desc (text of 4-200 bytes, its
    first four letters unique to the item), i_brand, and i_current_price
    and i_wholesale_cost as decimal(7,2); store with a unique
    s_store_name; warehouse with w_warehouse_name of up to 20 bytes;
    store_sales (sold dates uniform over 1998-01-02 .. 2003-01-02, items
    and stores uniform, ss_sales_price decimal(7,2) with 3 % null, and
    TPC-DS's ss_sold_time_sk, seconds of the day uniform over 0..86,399,
    drawn from a generator of its own) and the
    same prices as decimal(38,18) (`store_sales_dec38`); and inventory:
    `inventory_weeks` weekly dates of 2001, every second item in every
    warehouse, inv_quantity_on_hand uniform over 0..1000 with 5 % null."""
    rng = np.random.default_rng(seed)
    n_item, n_store = sizes["item"], sizes["store"]
    n_wh, n_ss = sizes["warehouse"], sizes["store_sales"]
    day = np.arange(sizes["date_dim"]) + _first_day(sizes)
    when = np.datetime64("1900-01-02") + day
    year = when.astype("datetime64[Y]").astype(np.int64) + 1970
    moy = when.astype("datetime64[M]").astype(np.int64) % 12 + 1
    t = {"date_dim": pa.table({  # join_tables' date_dim, and d_date
        "d_date_sk": FIRST_DATE_SK + day,
        "d_year": year.astype(np.int32), "d_moy": moy.astype(np.int32),
        "d_month_seq": ((year - 1900) * 12 + moy - 1).astype(np.int32),
        "d_date": pa.array(when.astype("datetime64[D]").astype(np.int64)
                           .astype(np.int32), pa.date32())})}
    wholesale = rng.integers(100, 10_001, n_item)  # 1.00 .. 100.00
    t["item"] = pa.table({
        "i_item_sk": np.arange(1, n_item + 1),
        "i_item_desc": _words(rng, n_item, *ITEM_DESC_BYTES,
                              _item_codes(rng, n_item)),
        "i_brand": pa.array(np.array([f"{w} #{k}" for w in STAR_SYLLABLES
                                      for k in range(1, 11)])[
            rng.integers(0, 10 * len(STAR_SYLLABLES), n_item)]),
        "i_current_price": decimal_array(
            pa, (wholesale * rng.uniform(1.0, 2.0, n_item)).astype(np.int64),
            *MONEY),
        "i_wholesale_cost": decimal_array(pa, wholesale, *MONEY)})
    t["store"] = pa.table({
        "s_store_sk": np.arange(1, n_store + 1),
        "s_store_name": pa.array([f"{STAR_SYLLABLES[k % 5]}{k // 5}"
                                  for k in rng.permutation(n_store)])})
    t["warehouse"] = pa.table({
        "w_warehouse_sk": np.arange(1, n_wh + 1),
        "w_warehouse_name": pa.array([
            f"{WAREHOUSE_WORDS[k % 10]} {k // 10} stock"[:20]
            for k in range(n_wh)])})
    item = rng.integers(1, n_item + 1, n_ss)
    lst = (wholesale[item - 1] * rng.uniform(1.0, 2.0, n_ss)).astype(np.int64)
    price = (lst * rng.uniform(0.2, 1.0, n_ss)).astype(np.int64)
    valid = rng.random(n_ss) >= PRICE_NULL_SHARE
    store = rng.integers(1, n_store + 1, n_ss)
    t["store_sales"] = pa.table({
        "ss_sold_date_sk": rng.integers(SOLD_DATE_SK[0], SOLD_DATE_SK[1] + 1,
                                        n_ss),
        "ss_item_sk": item, "ss_store_sk": store,
        "ss_sales_price": decimal_array(pa, price, *MONEY, valid),
        # its own generator: every other column stays as it was
        "ss_sold_time_sk": np.random.default_rng([seed, 86_400]).integers(
            0, 86_400, n_ss).astype(np.int32)})
    t["store_sales_dec38"] = pa.table({
        "ss_store_sk": store, "ss_sales_price": dec38_array(pa, price,
                                                             valid)})
    first = FIRST_DATE_SK + int((np.datetime64(INV_FIRST_WEEK)
                                 - np.datetime64("1900-01-02")).astype(int))
    weeks = first + 7 * np.arange(sizes["inventory_weeks"])
    items = np.arange(1, n_item + 1, 2)
    n_inv = len(weeks) * len(items) * n_wh
    date, it, wh = (a.ravel() for a in np.meshgrid(
        weeks, items, np.arange(1, n_wh + 1), indexing="ij"))
    t["inventory"] = pa.table({
        "inv_date_sk": date, "inv_item_sk": it, "inv_warehouse_sk": wh,
        "inv_quantity_on_hand": pa.array(
            rng.integers(0, 1001, n_inv).astype(np.int32),
            mask=rng.random(n_inv) < INV_NULL_SHARE)})
    return t


def agg_namespace() -> SimpleNamespace:
    """The port's constructors that agg_queries uses, and its types."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    m = SimpleNamespace(**{n: getattr(E, n) for n in (
        "col", "lit", "Sum", "Count", "Average", "Min", "Max", "StddevSamp",
        "CaseWhen")})
    m.double = T.DOUBLE
    return m


def agg_queries(sess, m, paths: dict) -> dict:
    """q65, q39a, q39b and the decimal(38,18) report (`dec38`) as
    DataFrames of `sess` over agg_tables' parquet files, written once for
    either engine through the namespace `m`. One departure from TPC-DS:
    q65's `sc.revenue <= 0.1 * sb.ave` needs a decimal Multiply, which
    neither engine has; it compares the two cast to DOUBLE."""
    c, lit = m.col, m.lit

    def read(name, cols):
        return sess.read_parquet(paths[name], columns=cols)

    months = (c("d_month_seq") >= lit(Q65_MONTHS[0])) & \
        (c("d_month_seq") <= lit(Q65_MONTHS[1]))
    dates = read("date_dim", ["d_date_sk", "d_month_seq"]).filter(months) \
        .select(ss_sold_date_sk=c("d_date_sk"))

    def revenue():
        return read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                    "ss_item_sk", "ss_sales_price"]) \
            .join(dates, on="ss_sold_date_sk") \
            .select("ss_store_sk", "ss_item_sk", "ss_sales_price") \
            .group_by("ss_store_sk", "ss_item_sk") \
            .agg(revenue=m.Sum(c("ss_sales_price")))

    sb = revenue().group_by("ss_store_sk").agg(ave=m.Average(c("revenue")))
    stores = read("store", ["s_store_sk", "s_store_name"]).select(
        "s_store_name", ss_store_sk=c("s_store_sk"))
    items = read("item", ["i_item_sk", "i_item_desc", "i_current_price",
                          "i_wholesale_cost", "i_brand"]).select(
        "i_item_desc", "i_current_price", "i_wholesale_cost", "i_brand",
        ss_item_sk=c("i_item_sk"))
    q65 = revenue().join(sb, on="ss_store_sk") \
        .filter(c("revenue").cast(m.double)
                <= lit(Q65_BAND) * c("ave").cast(m.double)) \
        .join(stores, on="ss_store_sk").join(items, on="ss_item_sk") \
        .select("s_store_name", "i_item_desc", "revenue", "i_current_price",
                "i_wholesale_cost", "i_brand") \
        .sort("s_store_name", "i_item_desc").limit(AGG_LIMIT)

    def inv(k: int):
        year = read("date_dim", ["d_date_sk", "d_year", "d_moy"]) \
            .filter(c("d_year") == lit(Q39_YEAR)) \
            .select("d_moy", inv_date_sk=c("d_date_sk"))
        whs = read("warehouse", ["w_warehouse_sk", "w_warehouse_name"]) \
            .select("w_warehouse_name", inv_warehouse_sk=c("w_warehouse_sk"))
        its = read("item", ["i_item_sk"]).select(inv_item_sk=c("i_item_sk"))
        mean = c("mean")
        cov = c("stdev") / mean
        foo = read("inventory", ["inv_date_sk", "inv_item_sk",
                                 "inv_warehouse_sk", "inv_quantity_on_hand"]) \
            .join(its, on="inv_item_sk").join(whs, on="inv_warehouse_sk") \
            .join(year, on="inv_date_sk") \
            .group_by("w_warehouse_name", "inv_warehouse_sk", "inv_item_sk",
                      "d_moy") \
            .agg(stdev=m.StddevSamp(c("inv_quantity_on_hand")),
                 mean=m.Average(c("inv_quantity_on_hand")))
        return foo.filter(m.CaseWhen([(mean == lit(0.0), lit(0.0))], cov)
                          > lit(Q39_COVS[0])) \
            .filter(c("d_moy") == lit(k)) \
            .select(w_warehouse_sk=c("inv_warehouse_sk"),
                    i_item_sk=c("inv_item_sk"), **{
                        f"d_moy{k}": c("d_moy"), f"mean{k}": mean,
                        f"cov{k}": m.CaseWhen([(mean == lit(0.0),
                                               lit(None, m.double))], cov)})

    def q39(b: bool):
        left = inv(1)
        if b:
            left = left.filter(c("cov1") > lit(Q39_COVS[1]))
        return left.join(inv(2), on=["w_warehouse_sk", "i_item_sk"]) \
            .select("w_warehouse_sk", "i_item_sk", "d_moy1", "mean1", "cov1",
                    "d_moy2", "mean2", "cov2") \
            .sort("w_warehouse_sk", "i_item_sk", "d_moy1", "mean1", "cov1",
                  "d_moy2", "mean2", "cov2")

    p = c("ss_sales_price")
    dec38 = read("store_sales_dec38", ["ss_store_sk", "ss_sales_price"]) \
        .select("ss_store_sk", "ss_sales_price").group_by("ss_store_sk") \
        .agg(total=m.Sum(p), mean=m.Average(p), lowest=m.Min(p),
             highest=m.Max(p)) \
        .sort("ss_store_sk")
    return {"q65": q65, "q39a": q39(False), "q39b": q39(True),
            "dec38": dec38}


def agg_oracle(pa, t: dict) -> dict:
    """numpy answers to agg_queries over agg_tables, column by column in
    the queries' order: decimals as unscaled ints (q65's revenue and the
    decimal(38,18) report's as Python ints), q65's average by the divmod
    HALF_UP of decimal_mean and compared with the revenues as the engine
    casts them to DOUBLE; q39's stddev_samp and mean by the JAX moment form
    over f64 sums of integers (exact in any order). Also returns q65's
    `ave` per store and the distance of the nearest q39 cov to each
    cut-off and of the nearest q65 revenue to its bound."""
    ss, dd = t["store_sales"], t["date_dim"]
    dsk = dd.column("d_date_sk").to_numpy()
    seq = np.zeros(dsk.max() + 1, np.int32)
    seq[dsk] = dd.column("d_month_seq").to_numpy()
    moy = np.zeros(dsk.max() + 1, np.int32)
    moy[dsk] = dd.column("d_moy").to_numpy()
    yr = np.zeros(dsk.max() + 1, np.int32)
    yr[dsk] = dd.column("d_year").to_numpy()
    # q65: revenue by (store, item) over TPC-DS's twelve months
    n_item = t["item"].num_rows
    date = ss.column("ss_sold_date_sk").to_numpy()
    store = ss.column("ss_store_sk").to_numpy()
    item = ss.column("ss_item_sk").to_numpy()
    cents, valid = unscaled(ss.column("ss_sales_price"))
    inm = (seq[date] >= Q65_MONTHS[0]) & (seq[date] <= Q65_MONTHS[1])
    key = store[inm] * (n_item + 1) + item[inm]
    groups, gid = np.unique(key, return_inverse=True)
    ok = valid[inm]
    rev = np.zeros(len(groups), np.int64)
    np.add.at(rev, gid[ok], cents[inm][ok])
    has = np.bincount(gid[ok], minlength=len(groups)) > 0
    g_store, g_item = groups // (n_item + 1), groups % (n_item + 1)
    q65_groups = len(groups)
    n_store = t["store"].num_rows
    s_sum = np.zeros(n_store + 1, np.int64)
    s_cnt = np.zeros(n_store + 1, np.int64)
    np.add.at(s_sum, g_store[has], rev[has])
    np.add.at(s_cnt, g_store[has], 1)
    ave = decimal_mean(s_sum, s_cnt)  # decimal(21,6), unscaled
    lhs = rev.astype(np.float64) / 10.0 ** MONEY[1]
    rhs = Q65_BAND * (ave[g_store].astype(np.float64)
                      / 10.0 ** (MONEY[1] + AVG_EXTRA_SCALE))
    keep = has & (lhs <= rhs)
    names = np.array(t["store"].column("s_store_name").to_pylist())
    st = t["store"].column("s_store_sk").to_numpy()
    name_of = np.empty(n_store + 1, object)
    name_of[st] = names
    descs = np.array(t["item"].column("i_item_desc").to_pylist(), object)
    rows = sorted(zip(name_of[g_store[keep]], descs[g_item[keep] - 1],
                      rev[keep], g_item[keep]))[:AGG_LIMIT]
    price, _ = unscaled(t["item"].column("i_current_price"))
    cost, _ = unscaled(t["item"].column("i_wholesale_cost"))
    brand = t["item"].column("i_brand").to_pylist()
    q65 = {"s_store_name": [r[0] for r in rows],
           "i_item_desc": [r[1] for r in rows],
           "revenue": [int(r[2]) for r in rows],
           "i_current_price": [int(price[r[3] - 1]) for r in rows],
           "i_wholesale_cost": [int(cost[r[3] - 1]) for r in rows],
           "i_brand": [brand[r[3] - 1] for r in rows]}
    # q39: stddev_samp and mean by (warehouse, item, month) of 2001
    inv = t["inventory"]
    idate = inv.column("inv_date_sk").to_numpy()
    iitem = inv.column("inv_item_sk").to_numpy()
    iwh = inv.column("inv_warehouse_sk").to_numpy()
    qty = inv.column("inv_quantity_on_hand")
    qv = ~qty.is_null().to_numpy(zero_copy_only=False)
    q = qty.fill_null(0).to_numpy().astype(np.float64)
    in_year = yr[idate] == Q39_YEAR
    key = ((iwh * (n_item + 1) + iitem) * 13 + moy[idate])[in_year]
    groups, gid = np.unique(key, return_inverse=True)
    ok = qv[in_year]
    x = q[in_year][ok]
    cnt = np.bincount(gid[ok], minlength=len(groups)).astype(np.float64)
    s1 = np.bincount(gid[ok], weights=x, minlength=len(groups))
    s2 = np.bincount(gid[ok], weights=x * x, minlength=len(groups))
    mean = s1 / np.maximum(cnt, 1.0)
    m2 = np.maximum(s2 - cnt * mean * mean, 0.0)
    stdev = np.sqrt(m2 / np.maximum(cnt - 1.0, 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        cov = stdev / mean
    defined = (cnt > 1) & (mean != 0)  # stdev null at n <= 1; cov at 0
    g_moy = groups % 13
    g_wi = groups // 13
    sel = defined & (cov > Q39_COVS[0])
    by_month = {k: {int(w): i for i, w in zip(np.flatnonzero(sel & (
        g_moy == k)), g_wi[sel & (g_moy == k)])} for k in (1, 2)}
    near = {cut: float(np.min(np.abs(cov[defined] - cut)))
            for cut in Q39_COVS}
    out = {}
    for name, cut in (("q39a", None), ("q39b", Q39_COVS[1])):
        pairs = sorted((wi, by_month[1][wi], j) for wi, j in
                       by_month[2].items() if wi in by_month[1]
                       and (cut is None or cov[by_month[1][wi]] > cut))
        cols = {k: [] for k in ("w_warehouse_sk", "i_item_sk", "d_moy1",
                                "mean1", "cov1", "d_moy2", "mean2", "cov2")}
        for wi, i1, i2 in pairs:
            cols["w_warehouse_sk"].append(int(wi // (n_item + 1)))
            cols["i_item_sk"].append(int(wi % (n_item + 1)))
            for k, ix in ((1, i1), (2, i2)):
                cols[f"d_moy{k}"].append(k)
                cols[f"mean{k}"].append(float(mean[ix]))
                cols[f"cov{k}"].append(float(cov[ix]))
        out[name] = cols
    # the decimal(38,18) report by store: Python ints from cents
    d38 = t["store_sales_dec38"]
    store = d38.column("ss_store_sk").to_numpy()
    tot = np.zeros(n_store + 1, np.int64)
    np.add.at(tot, store[valid], cents[valid])
    cnt = np.bincount(store[valid], minlength=n_store + 1)
    lo = np.full(n_store + 1, np.iinfo(np.int64).max)
    hi = np.full(n_store + 1, np.iinfo(np.int64).min)
    np.minimum.at(lo, store[valid], cents[valid])
    np.maximum.at(hi, store[valid], cents[valid])
    unit = 10 ** DEC38_SHIFT
    sks = [int(k) for k in np.unique(store)]

    def half_up(num: int, den: int) -> int:
        qq, r = divmod(abs(num), den)
        qq += 2 * r >= den
        return -qq if num < 0 else qq
    dec38 = {"ss_store_sk": sks,
             "total": [int(tot[k]) * unit if cnt[k] else None for k in sks],
             "mean": [half_up(int(tot[k]) * unit * 10 ** AVG_EXTRA_SCALE,
                              int(cnt[k])) if cnt[k] else None for k in sks],
             "lowest": [int(lo[k]) * unit if cnt[k] else None for k in sks],
             "highest": [int(hi[k]) * unit if cnt[k] else None for k in sks]}
    bound = np.abs(lhs - rhs)[has]
    return {"q65": q65, "q39a": out["q39a"], "q39b": out["q39b"],
            "dec38": dec38, "q65_ave": {int(k): int(ave[k]) for k in sks},
            "q39_groups": int(len(groups)), "q65_groups": int(q65_groups),
            "nearest_cov": near,
            "nearest_q65_bound": float(bound.min()) if len(bound) else None}


def unscaled128(col) -> list:
    """An Arrow decimal128 column -> its unscaled values as Python ints
    (None where null), from its 16-byte words."""
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    n = len(arr)
    words = np.frombuffer(arr.buffers()[1], np.int64,
                          count=2 * (arr.offset + n)).reshape(-1, 2)[
        arr.offset:]
    valid = np.asarray(arr.is_valid()) if arr.null_count else \
        np.ones(n, bool)
    return [((int(h) << 64) | (int(lo) & (2 ** 64 - 1))) if ok else None
            for (lo, h), ok in zip(words.tolist(), valid)]


AGG_DECIMALS = {"q65": {"revenue": (17, 2), "i_current_price": MONEY,
                        "i_wholesale_cost": MONEY},
                "dec38": {"total": DEC38, "mean": (38, 22),
                          "lowest": DEC38, "highest": DEC38}}
AGG_APPROX = ("mean1", "cov1", "mean2", "cov2")


def check_agg_query(pa, name: str, out, want: dict) -> None:
    """Raise unless `out` equals the oracle row for row, in the query's
    order: decimals (with their types) as unscaled ints, q39's means and
    covs within rtol 1e-12, everything else exactly."""
    n = len(next(iter(want.values())))
    if out.num_rows != n or out.column_names != list(want):
        raise AssertionError(f"{name}: {out.num_rows} rows of "
                             f"{out.column_names}, oracle {n} of "
                             f"{list(want)}")
    for col, exp in want.items():
        c = out.column(col)
        if col in AGG_DECIMALS.get(name, {}):
            if c.type != pa.decimal128(*AGG_DECIMALS[name][col]):
                raise AssertionError(f"{name}: column {col} is {c.type}")
            got = unscaled128(c)
        else:
            got = c.to_pylist()
        if col in AGG_APPROX:
            ok = n == 0 or np.allclose(got, exp, rtol=1e-12, atol=0.0)
        else:
            ok = got == exp
        if not ok:
            raise AssertionError(f"{name}: column {col} differs from the "
                                 "oracle")


def parity_table(pa, n: int, seed: int = 53):
    """One batch for the module parity check: 1,024 groups, nulls in every
    value column, NaN among the doubles, a column `u` with one valid value
    a group. The doubles hold integers of at most 1,000, so every power
    sum of the moments (below 2^53) is exact in any order: the card's
    atomic adds and the CPU's sequential ones give the same sums, and
    skewness and kurtosis, which cancel sums of x^3 and x^4, compare to
    rtol 1e-12."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1024, n).astype(np.int32)
    null = rng.random(n) < 0.1
    x = rng.integers(-1000, 1001, n).astype(np.float64)
    x[rng.random(n) < 0.001] = np.nan
    first = np.zeros(n, bool)
    first[np.unique(g, return_index=True)[1]] = True
    words = np.array(["", "a", "ab", "b", "zz", "é", "a\x00", "x" * 40,
                      "amalg", "edu pack"], object)
    return pa.table({
        "g": g, "x": pa.array(x, mask=null),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      mask=null),
        "b": pa.array(rng.random(n) < 0.7, mask=null),
        "l": pa.array(rng.integers(-2 ** 62, 2 ** 62, n), mask=null),
        "y": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=null),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16),
                      mask=null),
        "s": pa.array(list(words[rng.integers(0, len(words), n)]),
                      mask=null),
        "d": dec38_array(pa, rng.integers(-10 ** 7 + 1, 10 ** 7, n), ~null),
        "u": pa.array(rng.integers(0, 99, n), mask=~first)})


def parity_aggregates():
    """Every aggregate of slice 9, as the port's constructors."""
    from spark_rapids_tpu_torch import expr as E
    c = E.col
    return dict(
        vp=E.VariancePop(c("x")), vs=E.VarianceSamp(c("x")),
        sp=E.StddevPop(c("i")), ss=E.StddevSamp(c("x")),
        sk=E.Skewness(c("x")), ku=E.Kurtosis(c("i")),
        ci=E.CountIf(c("b")), ba=E.BoolAnd(c("b")), bo=E.BoolOr(c("b")),
        band=E.BitAndAgg(c("l")), bor=E.BitOrAgg(c("y")),
        bx=E.BitXorAgg(c("h")), f=E.First(c("s")), la=E.Last(c("x")),
        fi=E.First(c("u"), True), li=E.Last(c("d"), True),
        mins=E.Min(c("s")), maxs=E.Max(c("s")), mind=E.Min(c("d")),
        maxd=E.Max(c("d")), sd=E.Sum(c("d")), ad=E.Average(c("d")))


def module_parity(torch, pa, dev, n: int = ARROW_BATCH_ROWS) -> dict:
    """Every aggregate of the slice over one batch of n rows, through the
    same exec on `dev` and on the CPU: equal results (doubles within rtol
    1e-12, NaN equal to NaN; every other value exactly)."""
    from spark_rapids_tpu_torch.plugin import TpuSession
    t = parity_table(pa, n)
    conf = {"spark.rapids.sql.batchSizeRows": n}
    outs = {}
    for where in (dev, "cpu"):
        t0 = time.perf_counter()
        outs[str(where)] = (TpuSession(conf, device=where).from_arrow(t)
                            .group_by("g").agg(**parity_aggregates())
                            .collect().sort_by("g"),
                            time.perf_counter() - t0)
    (got, got_s), (want, want_s) = outs[str(dev)], outs["cpu"]
    if got.schema != want.schema or got.num_rows != want.num_rows:
        raise AssertionError("module parity: the results' shapes differ")
    for name in want.column_names:
        a, b = want.column(name), got.column(name)
        if not a.is_null().equals(b.is_null()):
            raise AssertionError(f"module parity: {name}'s nulls differ")
        if pa.types.is_floating(a.type):
            ok = np.allclose(b.drop_null().to_numpy(),
                             a.drop_null().to_numpy(), rtol=1e-12, atol=0.0,
                             equal_nan=True)
        else:
            ok = a.equals(b)
        if not ok:
            raise AssertionError(f"module parity: {name} differs between "
                                 f"{dev} and the CPU")
    return {"rows": n, "groups": got.num_rows,
            "aggregates": list(parity_aggregates()),
            "device_s": got_s, "cpu_s": want_s, "rtol_double": 1e-12}


# sold dates are uniform over every row group (as in tpcds_joins): the
# phase turns dynamic pruning off so that the date joins fuse and launch A
AGG_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False}
# kernel launches of one collect of each query, as PERF.md predicts them
# for agg_tables' files at AGG_SIZES (store_sales 16 row groups: 4 merged
# batches; inventory 17: 5). A: 2 per fused join per merged batch (one
# int64 key each), on q65's two date joins (2 x 4 x 2) and its sb, store
# and item joins (one batch on one device, 4 shard batches distributed:
# 3 x 2 or 3 x 4 x 2), and on q39's item, warehouse and date joins of each
# inventory scan (2 x 3 x 5 x 2); q39's self-join is shuffled. C: the
# distributed fused partial aggregates' int64 sums: q65's revenue Sum
# (its sum and its count) over 2 x 4 scan batches, q39's two counts
# (stddev_samp's and avg's; their sums are f64) over 2 x 5, and the
# decimal(38,18) report's 12 a batch over 4 (Sum and Average: four chunk
# sums and a count each; Min and Max: a count each); none on one device,
# and sb's Average (whose chunk sums are 128-bit) is not fused
AGG_LAUNCHES = {
    "one_device": {"q65": (22, 0), "q39a": (60, 0), "q39b": (60, 0),
                   "dec38": (0, 0)},
    "distributed": {"q65": (40, 16), "q39a": (60, 20), "q39b": (60, 20),
                    "dec38": (0, 48)},
}


def agg_data(pa, d: str, sizes=AGG_SIZES) -> dict:
    """agg_tables, their oracle and their parquet files in directory d,
    and the strings phase's oracle and file (strings_data), with the
    seconds each took."""
    import pyarrow.parquet as pq
    t0 = time.monotonic()
    tables = agg_tables(pa, sizes)
    t1 = time.monotonic()
    want = agg_oracle(pa, tables)
    t2 = time.monotonic()
    paths = write_parquet(pq, tables, d, tag="_aggs")
    t3 = time.monotonic()
    strings = strings_data(pa, tables, d, paths)
    t4 = time.monotonic()
    ext = strings_ext_data(pa, tables, d, paths)
    t5 = time.monotonic()
    dt = datetime_data(pa, tables, ext)
    return {"tables": tables, "oracle": want, "paths": paths,
            "strings": strings, "strings_ext": ext, "datetime": dt,
            "tables_s": t1 - t0, "oracle_s": t2 - t1, "write_s": t3 - t2,
            "strings_s": t4 - t3, "strings_ext_s": t5 - t4,
            "datetime_s": time.monotonic() - t5}


def aggregates_phases(torch, pa, mesh_conf: dict, counters, sizes=AGG_SIZES,
                      conf=None, device=None, rounds=AGG_ROUNDS, warmup=True,
                      want_launches=AGG_LAUNCHES, data=None,
                      parity_rows=ARROW_BATCH_ROWS):
    """Phase tpcds_aggregates: q65, q39a, q39b and the decimal(38,18)
    report over agg_tables' parquet files, on one device and under the
    distributed plan (`mesh_conf`), fusion on and dynamic pruning off
    (AGG_CONF). After a warm-up collect of each query (with `warmup`),
    each is collected `rounds` times, timed: every result is held against
    agg_oracle row for row and every collect's launches of A and C against
    `want_launches`. Then the decimal(38,18) file is decoded on the device
    and held against pq.read_table (both timed), and every aggregate of the
    slice runs over one batch on the device and on the CPU (module_parity).
    q39a's device idle share comes from one traced collect. Returns the
    launch counts of each plan's run (one collect of each query) and the
    arguments of A's first call in a one-device q39a collect and of C's
    first in a distributed q65 collect."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.io import parquet_device as P
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **AGG_CONF,
                **{"spark.rapids.tpu.fusion.enabled": True})

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counters}

    launches, record = {}, {}
    with (contextlib.nullcontext() if data is not None else
          tempfile.TemporaryDirectory(prefix="chip_smoke_aggs_")) as d:
        if data is None:
            data = agg_data(pa, d, sizes)
        want, paths = data["oracle"], data["paths"]
        m = agg_namespace()
        for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
            qs = agg_queries(TpuSession(dict(conf, **extra), dev), m, paths)
            shapes = {n: q.explain() for n, q in qs.items()}
            if warmup:
                for n, q in qs.items():
                    check_agg_query(pa, n, q.collect(), want[n])
            per_query, run = {}, {}
            for n, q in qs.items():
                walls, a, c = [], *want_launches[plan][n]
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    out, run[n] = counted(q.collect)
                    walls.append(time.perf_counter() - t0)
                    check_agg_query(pa, n, out, want[n])
                    del out
                    if (run[n]["murmur3_rows"], run[n]["segment_sum_i64"],
                            run[n]["segment_sum_f64"]) != (a, c, 0):
                        raise AssertionError(f"{n} ({plan}) launched "
                                             f"{run[n]}, not A {a} and C {c}")
                per_query[n] = {
                    "rows": len(next(iter(want[n].values()))),
                    "warm_collect_s": spread(walls),
                    "launches_per_collect": run[n],
                    "fused_joins": fused_joins(shapes[n]),
                    "exchanges": shapes[n].count("TpuShuffleExchangeExec")}
            path = "tpcds_aggregates" if plan == "one_device" else \
                "tpcds_aggregates_distributed"
            launches[path] = {k: sum(r[k] for r in run.values())
                              for k in run["q65"]}
            if plan == "one_device":
                a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                                         qs["q39a"].collect)
                per_query["q39a"]["device_idle_share"] = idle_share(
                    torch, qs["q39a"].collect)
            else:
                c_args = first_call_args(torch, pallas_groupby,
                                         "segment_sum_i64", qs["q65"].collect)
            record[plan] = {"queries": per_query,
                            "launches_per_path_run": launches[path]}
        # the decimal(38,18) column decoded on the device against pyarrow
        path38 = paths["store_sales_dec38"]
        schema = Schema.from_arrow(pq.read_schema(path38))
        decode_s, read_s = [], []
        for _ in range(max(rounds, 1)):
            t0 = time.perf_counter()
            batches = list(P.device_decode_file(
                pq.ParquetFile(path38), path38, schema, dev,
                CHUNKS_PER_DISPATCH))
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ref = pq.read_table(path38)
            read_s.append(time.perf_counter() - t0)
        check_decoded(pa, batches, ref, "decimal(38,18) decode")
        del batches, ref
        parity = module_parity(torch, pa, dev, parity_rows)
    emit({"phase": "tpcds_aggregates", "sizes": sizes,
          "reduced": {"store_sales": "16,777,216 of 28.8 M rows at SF10",
                      "inventory": f"{sizes['inventory_weeks']} weeks of "
                      "2001 of 261 (q39 reads January and February)"},
          "answers": {"q65_rows": len(want["q65"]["revenue"]),
                      "q39a_rows": len(want["q39a"]["i_item_sk"]),
                      "q39b_rows": len(want["q39b"]["i_item_sk"]),
                      "q39_groups": want["q39_groups"],
                      "q65_groups": want["q65_groups"],
                      "nearest_cov_to_cut": want["nearest_cov"],
                      "nearest_q65_revenue_to_bound":
                      want["nearest_q65_bound"]},
          "setup_s": {k: data[k] for k in ("tables_s", "oracle_s",
                                           "write_s")},
          "decode_dec38": {"rows": sizes["store_sales"],
                           "device_decode_s": spread(decode_s),
                           "pq_read_table_s": spread(read_s),
                           "equal_to_pq_read_table": True},
          "module_parity": parity,
          "exact": "decimals (unscaled ints) and keys against the numpy "
          "oracle, row for row", "rtol_q39": 1e-12, **record})
    return launches, a_args, c_args


# ---- parquet_files (slice 10): star_decimal's store_sales written again in
# seven file forms and read by Q3 and Q7: gzip and zstd through the Python
# page walk, columns, row groups and files the device decode declines
# through pyarrow, the multi-file reader strategies and `filters=`;
# FILES_ROUNDS warm collects timed after each checked one (which is not
# timed), and FILES_DECODE_ROUNDS decodes, all timed, the first checked
FILES_ROUNDS = 1
FILES_DECODE_ROUNDS = 2
# the forms hold the first FILES_SALES_ROWS sales (4 row groups, 1 merged
# batch), cut from all 16,777,216 in slice 15: the phase took 240-319 s of
# the script's 1,200 s limit, and the next phase needed the room
FILES_SALES_ROWS = 4 * (1 << 20)
FILES_SPLIT = 64  # many_files: the file count of a 64-task Spark write
FILES_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False}
FILES_QUERIES = ("q3", "q7")
# the 64 lz4 files under each reader strategy: Q3 alone (each is a host
# read of every file; tests/test_torch_parquet_files.py holds the
# strategies' order and batch counts against the JAX engine)
FILES_READER_QUERIES = ("q3",)
FILES_DIMS = {"q3": ("date_dim", "item"), "q7": ("item", "store")}
# per_column writes these as TINYINT, DELTA_BINARY_PACKED and
# BYTE_STREAM_SPLIT FIXED_LEN_BYTE_ARRAY(4): the footer check sends each
# to pyarrow, and its chunks merge into the device batches
FILES_HOST_COLS = ("ss_quantity", "ss_sold_date_sk", "ss_sales_price")
READER_TYPE = "spark.rapids.sql.format.parquet.reader.type"
SCAN_COUNTS = ("scan_chunks", "fused_dispatches", "declined_chunks",
               "host_columns", "host_row_groups", "host_files")


def files_head(pa, tables: dict, d: str) -> dict:
    """The first FILES_SALES_ROWS sales of star_decimal_tables written as
    the run's snappy file under d, and their int64 oracle: the forms of
    parquet_files are written from them."""
    import pyarrow.parquet as pq
    head = tables["store_sales"].slice(0, FILES_SALES_ROWS)
    return {"oracle": star_decimal_oracle(pa, dict(tables,
                                                   store_sales=head)),
            "store_sales": write_parquet(pq, {"store_sales": head}, d,
                                         tag="_files_head")["store_sales"]}


def files_forms(pa, pq, ss, d: str, snappy: str, dates: tuple) -> dict:
    """store_sales (an Arrow table) in the phase's forms, written under d
    in row groups of PARQUET_ROW_GROUP, all files at once on a thread pool
    (pyarrow writes without the interpreter lock) -> {form: (path or
    paths, read options, conf, how the port should read it)}. gzip is
    written at level 1 (level 6 takes 4x as long to write; a reader sees
    the same codec). `snappy` is the run's snappy file, `dates` the
    (first, last) ss_sold_date_sk of `filters`."""
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 4)

    def write(t, name, **kw):
        path = os.path.join(d, f"{name}.parquet")
        return pool.submit(lambda: pq.write_table(
            t, path, row_group_size=PARQUET_ROW_GROUP, **kw) or path)

    qty = ss.schema.get_field_index("ss_quantity")
    narrow = ss.set_column(qty, "ss_quantity",
                           ss.column(qty).cast(pa.int8()))
    per = -(-ss.num_rows // FILES_SPLIT)
    with pool:
        forms = {
            "zstd": (write(ss, "store_sales_zstd", compression="zstd"), {},
                     {}, "device"),
            "gzip": (write(ss, "store_sales_gzip", compression="gzip",
                           compression_level=1), {}, {}, "device"),
            "per_column": (write(
                narrow, "store_sales_per_column",
                use_dictionary=[n for n in ss.column_names
                                if n not in FILES_HOST_COLS[1:]],
                column_encoding={"ss_sold_date_sk": "DELTA_BINARY_PACKED",
                                 "ss_sales_price": "BYTE_STREAM_SPLIT"}),
                {}, {}, "device"),
            "v2_pages": (write(ss, "store_sales_v2",
                               data_page_version="2.0"), {}, {},
                         "row_groups"),
            "lz4": (write(ss, "store_sales_lz4", compression="lz4"), {}, {},
                    "files"),
        }
        split = {codec: [write(ss.slice(i * per, per),
                               f"part-{i:05d}-{codec}", compression=codec)
                         for i in range(FILES_SPLIT)]
                 for codec in ("snappy", "lz4")}
        forms["many_files"] = (split["snappy"], {}, {}, "device")
        for rt in ("PERFILE", "COALESCING", "MULTITHREADED"):
            forms[f"many_files_lz4_{rt.lower()}"] = (split["lz4"], {},
                                                     {READER_TYPE: rt},
                                                     "files")
    forms = {f: ((p.result() if not isinstance(p, list)
                  else [x.result() for x in p]), o, c, h)
             for f, (p, o, c, h) in forms.items()}
    forms["filters"] = (snappy, {"filters": [
        ("ss_sold_date_sk", ">=", dates[0]),
        ("ss_sold_date_sk", "<=", dates[1])]}, {}, "files")
    return forms


def expected_scan(pq, paths, how: str, batch_rows: int, host_cols: int = 0,
                  rows=None, coalesce: bool = False):
    """The scan counters and the batch count a scan of `paths` should give
    (ScanCounters' fields of SCAN_COUNTS): `how` is "device" (the device
    decode, `host_cols` columns of each row group merged from pyarrow),
    "row_groups" (every row group decoded whole by pyarrow) or "files"
    (every file by pyarrow, cut into batch_rows slices: of `rows` when a
    row filter leaves fewer, of all the files at once when `coalesce`)."""
    paths = [paths] if isinstance(paths, str) else list(paths)
    want = dict.fromkeys(SCAN_COUNTS, 0)
    metas = [pq.ParquetFile(p).metadata for p in paths]
    batches = 0
    if how == "files":
        want["host_files"] = len(paths)
        counts = [m.num_rows for m in metas] if rows is None else [rows]
        if coalesce:
            counts = [sum(counts)]
        batches = sum(max(-(-n // batch_rows), 1) for n in counts)
        return want, batches
    for p, m in zip(paths, metas):
        rgs = m.num_row_groups
        if how == "row_groups":
            want["host_row_groups"] += rgs
            batches += rgs
            continue
        want["scan_chunks"] += rgs
        want["fused_dispatches"] += packed_groups(pq, [p],
                                                  CHUNKS_PER_DISPATCH)
        want["host_columns"] += host_cols * rgs
        batches += -(-rgs // CHUNKS_PER_DISPATCH)
    return want, batches


def files_phases(torch, pa, mesh_conf: dict, counters, data: dict,
                 conf=None, device=None, rounds=FILES_ROUNDS,
                 decode_rounds=FILES_DECODE_ROUNDS):
    """Phase parquet_files: Q3 and Q7 of star_decimal_queries over
    store_sales in each form of files_forms (the run's star_decimal_data:
    its oracle, its snappy dimension files), on one device with dynamic
    pruning off, and Q7 under the distributed plan over per_column. Each
    collect is checked against the oracle (restricted to the filter's dates
    for `filters`), its scan counters against expected_scan, A against 2
    per fused join per store_sales batch and C against
    STAR_DECIMAL_C_PER_BATCH a batch (distributed only); `rounds` warm
    collects after each checked one are timed beside the snappy files', and
    the zstd and gzip decodes alone, `decode_rounds` times (the first
    checked after its timing), beside pq.read_table. The 64 lz4 files' reader strategies run Q3 alone
    (FILES_READER_QUERIES). Prints one line per form. Returns the launch
    counts of each path's run (one collect of each of its queries), the
    arguments of
    A's first call in a v2_pages Q7 collect (keys of a row group pyarrow
    decoded) and of C's first call in the distributed per_column Q7."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.io import parquet_device as P
    from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **FILES_CONF,
                **{"spark.rapids.tpu.fusion.enabled": True})
    batch_rows = TpuSession(conf, dev).conf.batch_size_rows
    ns = star_namespace()
    tables = data["tables"]
    ss = tables["store_sales"].slice(0, FILES_SALES_ROWS)
    want = data["files_head"]["oracle"]
    head_paths = dict(data["paths"],
                      store_sales=data["files_head"]["store_sales"])
    dd = tables["date_dim"]

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        P.COUNTERS.reset()
        out = fn()
        torch.cuda.synchronize()
        snap = P.COUNTERS.snapshot()
        return out, {k.__name__: k.launches for k in counters}, \
            {f: snap[f] for f in SCAN_COUNTS}

    # filters: the sales of one year of date_dim, the middle one
    years = dd.column("d_year").to_numpy()
    year = years[len(years) // 2]
    sks = dd.column("d_date_sk").to_numpy()[years == year]
    dates = (int(sks.min()), int(sks.max()))
    sold = ss.column("ss_sold_date_sk").to_numpy()
    keep = (sold >= dates[0]) & (sold <= dates[1])
    filtered = star_decimal_oracle(pa, dict(tables, store_sales=ss.filter(
        pa.array(keep))))

    def dims_scan(q):
        total = dict.fromkeys(SCAN_COUNTS, 0)
        for name in FILES_DIMS[q]:
            for k, v in expected_scan(pq, data["paths"][name], "device",
                                      batch_rows)[0].items():
                total[k] += v
        return total

    def run(form, q, df, oracle, sales_scan, batches, c_per_batch=0):
        """The checked collect of one query: its scan counters and
        launches against their predictions. Returns the launches."""
        shape = df.explain()
        out, launches, scan = counted(df.collect)
        check_star_decimal(pa, q, out, oracle[q])
        scan_want = {k: v + sales_scan[k] for k, v in dims_scan(q).items()}
        if scan != scan_want:
            raise AssertionError(f"parquet_files {form} {q}: scan counters "
                                 f"{scan}, predicted {scan_want}")
        a_want = 2 * fused_joins(shape) * batches
        c_want = c_per_batch * batches
        if launches["murmur3_rows"] != a_want or a_want == 0 or \
                launches["segment_sum_i64"] != c_want:
            raise AssertionError(f"parquet_files {form} {q} launched "
                                 f"{launches}, not A {a_want} and C "
                                 f"{c_want}")
        return launches, scan, shape

    def timed(df, q, oracle):
        """`rounds` warm collects, each checked."""
        walls = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            out = df.collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check_star_decimal(pa, q, out, oracle[q])
        return spread(walls)

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as d:
        forms = files_forms(pa, pq, ss, d, head_paths["store_sales"],
                            dates)
        write_s = time.monotonic() - t0
        snappy_q = star_decimal_queries(TpuSession(conf, dev), ns,
                                        head_paths)
        snappy_walls = {}
        for q in FILES_QUERIES:
            check_star_decimal(pa, q, snappy_q[q].collect(), want[q])
            snappy_walls[q] = timed(snappy_q[q], q, want)
        emit({"phase": "parquet_files", "form": "snappy",
              "sales_rows": ss.num_rows, "write_s": write_s,
              "filter_dates": list(dates), "filter_rows": int(keep.sum()),
              "collect_s": snappy_walls})
        launches, a_args, c_args = {}, None, None
        for form, (paths, options, extra, how) in forms.items():
            oracle = filtered if options.get("filters") else want
            sales_scan, batches = expected_scan(
                pq, paths, how, batch_rows,
                host_cols=len(FILES_HOST_COLS) if form == "per_column"
                else 0, rows=int(keep.sum()) if options else None,
                coalesce=extra.get(READER_TYPE) == "COALESCING")
            sq = star_decimal_queries(TpuSession(dict(conf, **extra), dev),
                                      ns, dict(data["paths"],
                                               store_sales=paths), **options)
            record, path_run = {}, Counter()
            for q in (FILES_READER_QUERIES if READER_TYPE in extra
                      else FILES_QUERIES):
                got, scan, shape = run(form, q, sq[q], oracle, sales_scan,
                                       batches)
                path_run.update(got)
                record[q] = {"launches": got, "scan_counters": scan,
                             "fused_joins": fused_joins(shape),
                             "collect_s": timed(sq[q], q, oracle)}
            launches[f"parquet_files_{form}"] = dict(path_run)
            if form == "v2_pages":
                a_args = first_call_args(torch, pallas_probe, "murmur3_rows",
                                         sq["q7"].collect)
            if form in ("zstd", "gzip"):
                pf = pq.ParquetFile(paths)
                schema = Schema.from_arrow(pf.schema_arrow)
                dec, rd = [], []
                for i in range(decode_rounds):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    out = list(P.device_decode_file(pf, paths, schema, dev,
                                                    CHUNKS_PER_DISPATCH))
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    ref = pq.read_table(paths)
                    dec.append(t2 - t1)
                    rd.append(time.perf_counter() - t2)
                    if i == 0:
                        check_decoded(pa, out, ref, f"the {form} file")
                    del out, ref
                record["decode"] = {"wall_s": spread(dec),
                                    "pq_read_table_s": spread(rd),
                                    "exact_vs_pyarrow": True}
            if form == "per_column":
                dq = star_decimal_queries(
                    TpuSession(dict(conf, **mesh_conf), dev), ns,
                    dict(data["paths"], store_sales=paths))["q7"]
                got, scan, shape = run(
                    "per_column distributed", "q7", dq, want, sales_scan,
                    batches, STAR_DECIMAL_C_PER_BATCH["q7"])
                launches["parquet_files_per_column_distributed"] = got
                c_args = first_call_args(torch, pallas_groupby,
                                         "segment_sum_i64", dq.collect)
                record["q7_distributed"] = {
                    "launches": got, "scan_counters": scan,
                    "collect_s": timed(dq, "q7", want)}
            emit({"phase": "parquet_files", "form": form, "how": how,
                  "files": 1 if isinstance(paths, str) else len(paths),
                  "sales_batches": batches, "exact": "every decimal "
                  "(int64 oracle), keys, counts", "predicted_scan":
                  sales_scan, **record})
    emit({"phase": "parquet_files", "form": "all",
          "seconds": time.monotonic() - t0})
    return launches, a_args, c_args


# ---- ansi (slice 11): Spark's ANSI mode (spark.sql.ansi.enabled, the
# default since Spark 4.0) over the decimal star's, the joins' and the
# aggregates' files: every query exact and launching A and C as without
# ANSI, three queries that must raise Spark's error, and their guarded twins
ANSI_CONF = {"spark.sql.ansi.enabled": True}
# (data set, query, plans); q58's joins are timed on one device only
ANSI_QUERIES = (("decimal", "q3", ("one_device", "distributed")),
                ("decimal", "q7", ("one_device", "distributed")),
                ("decimal", "q36", ("one_device", "distributed")),
                ("aggs", "q65", ("one_device", "distributed")),
                ("aggs", "q39a", ("one_device", "distributed")),
                ("joins", "q58", ("one_device",)))
# the date keys (< 2^22) times 2^41 fit a LONG, and every store's sum of
# them passes 2^63; times 2^20 every sum fits
ANSI_SHIFTS = (41, 20)
# the sales of the last four years: a filter, so that the distributed
# plan fuses it with the partial aggregate (kernel C)
ANSI_FROM_DATE = SOLD_DATE_SK[0] + 365
ANSI_MESSAGES = {
    "sum_overflow": "[ARITHMETIC_OVERFLOW] long overflow",
    "divide_by_zero": "[DIVIDE_BY_ZERO] Division by zero",
    "cast_overflow": "[CAST_OVERFLOW] value cannot be cast to byte due to "
                     "an overflow"}


def ansi_namespace() -> SimpleNamespace:
    """The port's constructors the ANSI violation queries use."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    m = SimpleNamespace(**{n: getattr(E, n) for n in (
        "col", "lit", "Sum", "Max", "Cast", "CaseWhen", "If",
        "IntegralDivide")})
    m.long, m.byte, m.money = T.LONG, T.BYTE, T.DecimalType(*MONEY)
    return m


def ansi_violations(sess, m, agg_paths: dict, join_paths: dict) -> dict:
    """The three ANSI violation queries and their guarded twins, as
    {name: (violation, twin)} DataFrames of `sess`:

      * sum_overflow, over the aggregates' store_sales: by store,
        sum(cast(ss_sold_date_sk as bigint) * 2^41); each row fits a LONG,
        each store's sum does not. The twin sums the keys times 2^20 and
        takes the max of the 2^41 products, which must not raise.
      * divide_by_zero, over the joins' store_sales (quantities 1..100):
        by quantity, sum(ss_sold_date_sk div (ss_quantity - 100)). The
        twin guards the division with CASE WHEN ss_quantity <> 100.
      * cast_overflow: by quantity, sum(cast(ss_list_price as tinyint)),
        the decimal(7,2) list price reaching 200.00. The twin is
        IF(ss_list_price < 100, cast(...), NULL).

    Each reads the last four years of sales (ANSI_FROM_DATE)."""
    from decimal import Decimal
    c, lit = m.col, m.lit
    recent = c("ss_sold_date_sk") >= lit(ANSI_FROM_DATE)
    dates = sess.read_parquet(agg_paths["store_sales"],
                              columns=["ss_sold_date_sk", "ss_store_sk"]) \
        .filter(recent)
    sales = sess.read_parquet(join_paths["store_sales"], columns=[
        "ss_sold_date_sk", "ss_quantity", "ss_list_price"]).filter(recent)
    key = m.Cast(c("ss_sold_date_sk"), m.long)

    def by_store(**aggs):
        return dates.group_by("ss_store_sk").agg(**aggs)

    def by_quantity(v):
        return sales.select("ss_quantity", v=v).group_by("ss_quantity") \
            .agg(s=m.Sum(c("v")))

    big, small = (lit(2 ** k) for k in ANSI_SHIFTS)
    div = m.IntegralDivide(c("ss_sold_date_sk"),
                           c("ss_quantity") - lit(100))
    price = c("ss_list_price")
    return {
        "sum_overflow": (by_store(s=m.Sum(key * big)),
                         by_store(s=m.Sum(key * small),
                                  top=m.Max(key * big))),
        "divide_by_zero": (by_quantity(div), by_quantity(m.CaseWhen(
            [(c("ss_quantity") != lit(100), div)]))),
        "cast_overflow": (by_quantity(m.Cast(price, m.byte)), by_quantity(
            m.If(price < lit(Decimal("100.00"), m.money),
                 m.Cast(price, m.byte),
                 lit(None, m.byte))))}


def _sorted_groups(keys: np.ndarray):
    """(the distinct keys, the row order that sorts by key, each key's
    first position in that order): for exact int64 reductions by
    np.*.reduceat."""
    order = np.argsort(keys, kind="stable")
    distinct, starts = np.unique(keys[order], return_index=True)
    return distinct, order, starts


def ansi_oracle(pa, agg_paths: dict, join_paths: dict) -> dict:
    """The guarded twins' answers from the parquet files, in numpy int64
    (every sum fits): {name: {column: values}}, sorted by key, a group
    whose every value is null summing to None."""
    import pyarrow.parquet as pq
    t = pq.read_table(agg_paths["store_sales"],
                      columns=["ss_sold_date_sk", "ss_store_sk"])
    date = t.column("ss_sold_date_sk").to_numpy()
    keep = date >= ANSI_FROM_DATE
    date = date[keep]
    stores, order, starts = _sorted_groups(
        t.column("ss_store_sk").to_numpy()[keep])
    date = date[order]
    out = {"sum_overflow": {
        "ss_store_sk": stores.tolist(),
        "s": np.add.reduceat(date << ANSI_SHIFTS[1], starts).tolist(),
        "top": (np.maximum.reduceat(date, starts)
                << ANSI_SHIFTS[0]).tolist()}}
    t = pq.read_table(join_paths["store_sales"], columns=[
        "ss_sold_date_sk", "ss_quantity", "ss_list_price"])
    date = t.column("ss_sold_date_sk").to_numpy()
    keep = date >= ANSI_FROM_DATE
    price, valid = unscaled(t.column("ss_list_price"))
    qtys, order, starts = _sorted_groups(
        t.column("ss_quantity").to_numpy()[keep].astype(np.int64))
    date, price, valid = (a[keep][order] for a in (date, price, valid))
    qty = np.repeat(qtys, np.diff(np.append(starts, len(order))))

    def sums(v, ok):
        total = np.add.reduceat(np.where(ok, v, 0), starts)
        has = np.logical_or.reduceat(ok, starts)
        return [int(x) if h else None for x, h in zip(total, has)]

    d = np.where(qty == 100, 1, 100 - qty)  # date div (qty - 100) < 0,
    out["divide_by_zero"] = {  # truncated toward zero as Java does
        "ss_quantity": qtys.tolist(), "s": sums(-(date // d), qty != 100)}
    out["cast_overflow"] = {"ss_quantity": qtys.tolist(), "s": sums(
        price // 100, valid & (price < 10_000))}
    return out


def c1_on_card(torch, dev) -> dict:
    """Queue C1's expressions (a DOUBLE converted into an INT or LONG
    result outside Cast: NaN, infinities and values out of range) on the
    card against the CPU, element for element: {name: True}."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.base import BoundReference, EvalContext
    from spark_rapids_tpu_torch.expr.base import Vec
    x = [1e300, float("inf"), -float("inf"), float("nan"), 3e9, -2.5]
    i, d, one = (BoundReference(0, T.INT), BoundReference(1, T.DOUBLE),
                 BoundReference(2, T.INT))
    cases = {"if": E.If(E.IsNotNull(i), E.lit(-3), d),
             "case_when": E.CaseWhen([(E.IsNotNull(i), E.lit(-3))], d),
             "coalesce": E.Coalesce(i, d), "greatest": E.Greatest(one, d),
             "least": E.Least(one, d),
             "integral_divide": E.IntegralDivide(d, E.lit(1.0))}
    n = len(x)

    def run(expr, where):
        vecs = [Vec(T.INT, torch.zeros(n, dtype=torch.int32, device=where),
                    torch.zeros(n, dtype=torch.bool, device=where)),
                Vec(T.DOUBLE, torch.tensor(x, dtype=torch.float64,
                                           device=where),
                    torch.ones(n, dtype=torch.bool, device=where)),
                Vec(T.INT, torch.ones(n, dtype=torch.int32, device=where),
                    torch.ones(n, dtype=torch.bool, device=where))]
        v = expr.eval(EvalContext(torch.ones(n, dtype=torch.bool,
                                             device=where)), vecs)
        return v.data.cpu().tolist(), v.validity.cpu().tolist()

    out = {}
    for name, expr in cases.items():
        card, cpu = run(expr, dev), run(expr, torch.device("cpu"))
        if card != cpu:
            raise AssertionError(f"C1 {name}: the card gives {card}, the "
                                 f"CPU {cpu}")
        out[name] = card[0]
    return out


def ansi_phases(torch, pa, mesh_conf: dict, counters, dec: dict,
                joins: dict, aggs: dict, conf=None, device=None):
    """Phase ansi: each of ANSI_QUERIES, over the files and oracles of the
    decimal star (`dec`), joins and aggregates data sets, collected once
    without ANSI and once with it (the sessions' only difference), each
    collect timed, launch-counted and checked against the set's oracle. The
    queries ran in their own phases earlier in this process, their warm-up.
    Both collects must be exact, launch A and C equally, and plan the same
    tree but for the join members' ansi flag. Then the three
    ansi_violations on both plans must raise Spark's error (ANSI_MESSAGES)
    and their twins equal ansi_oracle; and Queue C1's expressions must
    agree on the card and the CPU (c1_on_card). Prints one line a query
    and plan; returns them, and the launches of the ANSI collects of each
    plan's run (paths `ansi` and `ansi_distributed`: one collect of each
    query), where A must have launched, and C too when distributed."""
    from spark_rapids_tpu_torch.errors import AnsiViolation
    from spark_rapids_tpu_torch.exec import base as exec_base
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **{"spark.rapids.tpu.fusion.enabled": True})
    sets = {
        "decimal": (dec, {}, lambda s: star_decimal_queries(
            s, star_namespace(), dec["paths"]),
            lambda n, out: check_star_decimal(pa, n, out, dec["oracle"][n])),
        "aggs": (aggs, AGG_CONF, lambda s: agg_queries(
            s, agg_namespace(), aggs["paths"]),
            lambda n, out: check_agg_query(pa, n, out, aggs["oracle"][n])),
        "joins": (joins, JOINS_CONF, lambda s: join_queries(
            s, join_namespace(), joins["paths"]),
            lambda n, out: check_join_query(pa, n, out,
                                            joins["oracle"][n]))}
    plans = {"one_device": {}, "distributed": mesh_conf}

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        exec_base.COUNTERS.reset()
        t0 = time.perf_counter()
        try:
            out = fn()
        except AnsiViolation as e:
            out = e
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                {k.__name__: k.launches for k in counters},
                exec_base.COUNTERS.snapshot()["flag_reads"])

    t_phase = time.monotonic()
    lines, sessions = [], {}
    launches = {"ansi": Counter(), "ansi_distributed": Counter()}
    for i, (kind, name, on) in enumerate(ANSI_QUERIES):
        _, extra, build, check = sets[kind]
        for plan in on:
            qs = {}
            for mode, more in (("plain", {}), ("ansi", ANSI_CONF)):
                key = (kind, plan, mode)
                if key not in sessions:
                    sessions[key] = build(TpuSession(dict(
                        conf, **extra, **plans[plan], **more), dev))
                qs[mode] = sessions[key][name]
            trees = {mode: q.explain() for mode, q in qs.items()}
            if trees["ansi"] != trees["plain"].replace("ansi=False",
                                                       "ansi=True"):
                raise AssertionError(f"ansi {name} ({plan}): ANSI plans "
                                     f"another tree:\n{trees['ansi']}\n"
                                     f"without ANSI:\n{trees['plain']}")
            run = {}
            for mode in ("plain", "ansi") if i % 2 == 0 else \
                    ("ansi", "plain"):
                out, wall, launched, reads = counted(qs[mode].collect)
                if isinstance(out, Exception):
                    raise AssertionError(f"ansi {name} ({plan}, {mode}) "
                                         f"raised {out!r}")
                check(name, out)
                del out
                run[mode] = {"collect_s": wall, "launches": launched,
                             "flag_reads": reads}
            if run["plain"]["flag_reads"]:
                raise AssertionError(f"ansi {name} ({plan}) read flags "
                                     "without ANSI")
            if run["ansi"]["launches"] != run["plain"]["launches"]:
                raise AssertionError(f"ansi {name} ({plan}) launched "
                                     f"{run['ansi']['launches']}, without "
                                     f"ANSI {run['plain']['launches']}")
            if fused_joins(trees["ansi"]) and \
                    run["ansi"]["launches"]["murmur3_rows"] == 0:
                raise AssertionError(f"ansi {name} ({plan}) launched no A")
            launches["ansi" if plan == "one_device" else
                     "ansi_distributed"].update(run["ansi"]["launches"])
            line = {"phase": "ansi", "query": name, "plan": plan,
                    "collect_s": {m: r["collect_s"] for m, r in run.items()},
                    "launches": {m: r["launches"] for m, r in run.items()},
                    "flag_reads_added": run["ansi"]["flag_reads"],
                    "result": "exact"}
            emit(line)
            lines.append(line)
    sessions.clear()
    launches = {p: {k.__name__: n[k.__name__] for k in counters}
                for p, n in launches.items()}
    if launches["ansi"]["murmur3_rows"] == 0 or \
            0 in (launches["ansi_distributed"]["murmur3_rows"],
                  launches["ansi_distributed"]["segment_sum_i64"]):
        raise AssertionError(f"the ANSI paths launched {launches}")

    want = ansi_oracle(pa, aggs["paths"], joins["paths"])
    m = ansi_namespace()
    for plan, extra in plans.items():
        sess = TpuSession(dict(conf, **AGG_CONF, **extra, **ANSI_CONF), dev)
        for name, (bad, twin) in ansi_violations(
                sess, m, aggs["paths"], joins["paths"]).items():
            got, wall, launched, reads = counted(bad.collect)
            if not isinstance(got, AnsiViolation) or \
                    got.message != ANSI_MESSAGES[name]:
                raise AssertionError(f"ansi {name} ({plan}) gave {got!r}, "
                                     f"not {ANSI_MESSAGES[name]!r}")
            out, twin_wall, twin_launched, twin_reads = counted(twin.collect)
            if isinstance(out, Exception):
                raise AssertionError(f"ansi {name} twin ({plan}) raised "
                                     f"{out!r}")
            key = out.column_names[0]
            got_rows = out.sort_by(key).to_pydict()
            if got_rows != want[name]:
                raise AssertionError(f"ansi {name} twin ({plan}) differs "
                                     "from the oracle")
            line = {"phase": "ansi", "query": name, "plan": plan,
                    "raised": got.message, "collect_s": wall,
                    "launches": launched, "flag_reads_added": reads,
                    "twin": {"result": "exact", "groups": out.num_rows,
                             "collect_s": twin_wall,
                             "launches": twin_launched,
                             "flag_reads_added": twin_reads}}
            emit(line)
            lines.append(line)
    c1 = c1_on_card(torch, dev)
    lines.append({"phase": "ansi", "c1_card_equals_cpu": sorted(c1),
                  "c1_values": c1, "launches_per_path_run": launches,
                  "seconds": time.monotonic() - t_phase})
    emit(lines[-1])
    return lines, launches


# ---- memory (slice 12): the memory layer on the card: the spill catalog
# with each codec, then the paths that park under a tight budget (the
# running window's aggregate and in-core sort, the out-of-core sort, q97's
# sub-partition join, the distributed engine query) and injected OOMs
MEMORY_CODECS = ("none", "zstd", "lz4xla")
# copies of the engine query's fact table (512 MiB each on the card) that
# the catalog check parks: 1 GiB
MEMORY_CATALOG_COPIES = 2
# each tight budget: a share of the same query's peak budget use at the
# session's budget (the bytes the path itself parks and reserves), but at
# least the largest batch it parks (a budget under one batch cannot read
# that batch back); the host spill store
# (spark.rapids.memory.host.spillStorageSize) and the codec of the tight
# runs: uncompressed, so that any spill past 32 MiB goes on to disk (the
# catalog check times each codec; zstd took 5.3 s a GiB to spill, my chip
# run, PR 12)
MEMORY_BUDGET_SHARE = 0.6
MEMORY_HOST_LIMIT = 32 << 20
MEMORY_SPILL_CODEC = "none"
# the engine query with its fact table as one batch, so that its complete
# aggregate sees a single batch (the path that degrades to the merge
# passes)
ONE_BATCH = {"spark.rapids.sql.batchSizeRows": QUERY_FACT_ROWS}


def _bits(torch, t):
    """A float tensor's bit pattern, for comparisons that hold NaN."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def catalog_check(torch, batches, dev, codecs=MEMORY_CODECS) -> dict:
    """Park `batches` (host copies as (leaves, tree) of ColumnarBatch
    .flatten) on `dev` in a catalog of each codec, spill them all, and
    hold torch.cuda.memory_allocated's fall to at least their device
    bytes; read them back and hold every tensor bit for bit. The
    session's catalog and budget are restored; the budget's use must come
    back to where it was."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                       StorageTier)
    from spark_rapids_tpu_torch.memory.spillable import \
        SpillableColumnarBatch
    out = {}
    saved = BufferCatalog._instance
    used0 = MemoryBudget.get().used
    for codec in codecs:
        cat = BufferCatalog(host_limit=1 << 40, spill_codec=codec)
        BufferCatalog._instance = cat
        try:
            parked = [SpillableColumnarBatch(ColumnarBatch.unflatten(
                tree, [t.to(dev) for t in leaves]))
                for leaves, tree in batches]
            nbytes = sum(p.size_bytes for p in parked)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            freed = cat.synchronous_spill(nbytes)
            spill_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            after = torch.cuda.memory_allocated(dev)
            host = cat.host_used
            if freed != nbytes or any(cat.tier_of(p._handle) !=
                                      StorageTier.HOST for p in parked):
                raise AssertionError(f"catalog ({codec}) spilled {freed} of "
                                     f"{nbytes} bytes")
            if before - after < nbytes:
                raise AssertionError(
                    f"catalog ({codec}): memory_allocated fell by "
                    f"{before - after}, under the {nbytes} bytes spilled")
            t0 = time.perf_counter()
            back = [p.get_batch() for p in parked]
            torch.cuda.synchronize()
            unspill_s = time.perf_counter() - t0
            for b, (leaves, _) in zip(back, batches):
                for x, y in zip(b.flatten()[0], leaves):
                    if x.device != dev or not torch.equal(
                            _bits(torch, x.cpu()), _bits(torch, y)):
                        raise AssertionError(f"catalog ({codec}): a tensor "
                                             "came back changed")
            del back
            for p in parked:
                p.close()
        finally:
            BufferCatalog._instance = saved
        if MemoryBudget.get().used != used0:
            raise AssertionError(f"catalog ({codec}) left the budget at "
                                 f"{MemoryBudget.get().used}, not {used0}")
        out[codec] = {"device_bytes": nbytes, "host_bytes": host,
                      "allocated_fall": before - after, "spill_s": spill_s,
                      "unspill_s": unspill_s, "bit_identical": True}
    return out


def memory_collect(torch, q, counters, dev, budget=None, host_limit=None,
                   inject=(0, 0)):
    """One timed collect of DataFrame q: at the session's budget, or at
    `budget` bytes with a host spill store of `host_limit` bytes and the
    codec MEMORY_SPILL_CODEC (both restored after), with injection indexes
    (retry_at, split_at). Returns
    (the Arrow result, its record: wall, spill counts and bytes, retries
    and splits, the peak budget use, the largest batch parked,
    torch.cuda.max_memory_allocated and the kernels' launches)."""
    from spark_rapids_tpu_torch.memory import catalog as C
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    from spark_rapids_tpu_torch.utils.metrics import TaskMetrics
    saved = MemoryBudget._instance, C.BufferCatalog._instance
    parked, add = [0], C.BufferCatalog.add_batch

    def add_batch(cat, batch, *args, **kw):
        parked[0] = max(parked[0], batch.device_memory_size())
        return add(cat, batch, *args, **kw)
    if budget is not None:
        MemoryBudget.initialize(budget, saved[0].conf)
        C.BufferCatalog._instance = C.BufferCatalog(
            host_limit=host_limit, spill_codec=MEMORY_SPILL_CODEC)
    MemoryBudget.get().reset_injection(*inject)
    torch.cuda.synchronize()
    for k in counters:
        k.launches = 0
    C.COUNTERS.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    C.BufferCatalog.add_batch = add_batch
    t0 = time.perf_counter()
    try:
        out = q.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = MemoryBudget.get().peak_used
        total = MemoryBudget.get().total
    finally:
        C.BufferCatalog.add_batch = add
        MemoryBudget.get().reset_injection()
        MemoryBudget._instance, C.BufferCatalog._instance = saved
    tm = TaskMetrics.get()
    return out, {
        "wall_s": wall, "budget_bytes": total, "host_limit": host_limit,
        "peak_budget_bytes": peak, "largest_parked_bytes": parked[0],
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "spill": C.COUNTERS.snapshot(),
        "spill_s": {"to_host": tm.spill_to_host_ns / 1e9,
                    "to_disk": tm.spill_to_disk_ns / 1e9,
                    "read": tm.read_spill_ns / 1e9},
        "retries": tm.retry_count, "splits": tm.split_retry_count,
        "launches": {k.__name__: k.launches for k in counters}}


def _alloc_count_at(module, name: str):
    """`module.<name>` wrapped to record the budget's reservation count at
    each call; returns (the counts, a function restoring it)."""
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    real, seen = getattr(module, name), []

    def wrapper(*args, **kw):
        seen.append(MemoryBudget.get()._alloc_count)
        return real(*args, **kw)

    setattr(module, name, wrapper)
    return seen, lambda: setattr(module, name, real)


def memory_phases(torch, pa, mesh_conf: dict, counters, dec: dict,
                  joins: dict, fact, dim, conf=None, device=None,
                  catalog_copies=MEMORY_CATALOG_COPIES):
    """Phase memory, over the decimal star's and the joins' files and the
    engine query's tables of the same run (no new data set). First the
    catalog check (catalog_check over `catalog_copies` copies of `fact`,
    each codec). Then each path at the session's budget and at a tight
    one (MEMORY_BUDGET_SHARE of its own peak use there, at least the
    largest batch it parked, a host store of MEMORY_HOST_LIMIT bytes and
    the codec MEMORY_SPILL_CODEC): q51's running window on one device (its
    16.76 M-group aggregate's pending partials and its in-core sort), the
    out-of-core sort under the distributed plan, q97 on one device (the
    sub-partition join, A on the fused date probe) and the distributed
    engine query (A and C). Both results must be equal, exactly, with the
    same launches; the aggregate, sort and join paths must spill to host
    and to disk. Then at the session's budget: injectSplitAndRetryOOM at
    the running window's in-core sort (it degrades to the out-of-core
    merge) and at the engine query's single-batch complete aggregate (it
    degrades to the merge passes), and injectRetryOOM at q97's first probe
    step; each equal to the run without, with one split or retry. Prints
    one line a query and one for the phase; returns the launches of the
    tight runs (paths `memory` and `memory_distributed`)."""
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exec import aggregate as AG
    from spark_rapids_tpu_torch.exec import joins as J
    from spark_rapids_tpu_torch.exec import sort as S
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **{"spark.rapids.tpu.fusion.enabled": True})
    t_phase = time.monotonic()
    lines = []

    def session(*extra):
        return TpuSession(dict(conf, **{k: v for e in extra
                                        for k, v in e.items()}), dev)

    m = ordered_namespace()
    queries = {
        "running_window": (ordered_queries(session(), m, dec["paths"])[
            "running_window"], "one_device"),
        "ooc_sort": (ordered_queries(session(mesh_conf), m, dec["paths"])[
            "ooc_sort"], "distributed"),
        "q97": (join_queries(session(JOINS_CONF), join_namespace(),
                             joins["paths"])["q97"], "one_device"),
        "engine_distributed": (main_query(session(mesh_conf), fact, dim),
                               "distributed")}

    host = batch_from_arrow(fact, dev).flatten()
    host = ([t.cpu() for t in host[0]], host[1])
    cat = catalog_check(torch, [host] * catalog_copies, dev)
    del host
    line = {"phase": "memory", "check": "catalog",
            "session_budget_bytes": DeviceManager.budget_bytes,
            "device_total_bytes": DeviceManager.hbm_total, "codecs": cat}
    emit(line)
    lines.append(line)

    launches = {"memory": Counter(), "memory_distributed": Counter()}
    probes = {}
    for name, (q, plan) in queries.items():
        S.COUNTERS.reset()
        J.COUNTERS.reset()
        MemoryBudget.get().reset_injection()
        if name == "q97":
            seen, undo = _alloc_count_at(J.TpuShuffledHashJoinExec,
                                         "_probe_parts")
        else:
            seen, undo = [], (lambda: None)
        try:
            loose_out, loose = memory_collect(torch, q, counters, dev)
        finally:
            undo()
        if seen:
            probes[name] = seen[0] + 1  # the next reservation
        loose["sorts"] = S.COUNTERS.snapshot()
        loose["joins"] = J.COUNTERS.snapshot()
        budget = max(int(MEMORY_BUDGET_SHARE * loose["peak_budget_bytes"]),
                     loose["largest_parked_bytes"], 1)
        S.COUNTERS.reset()
        J.COUNTERS.reset()
        out, tight = memory_collect(torch, q, counters, dev, budget=budget,
                                    host_limit=MEMORY_HOST_LIMIT)
        tight["sorts"] = S.COUNTERS.snapshot()
        tight["joins"] = J.COUNTERS.snapshot()
        if not out.equals(loose_out):
            raise AssertionError(f"memory {name}: the tight budget's result "
                                 "differs from the session budget's")
        del out
        if tight["launches"] != loose["launches"]:
            raise AssertionError(f"memory {name}: launched {tight['launches']}"
                                 f" tight, {loose['launches']} loose")
        if name != "engine_distributed" and not (
                tight["spill"]["to_host_bytes"] and
                tight["spill"]["to_disk_bytes"]):
            raise AssertionError(f"memory {name}: spilled {tight['spill']} "
                                 f"at the tight budget: {tight}")
        if loose["spill"]["to_host"] or loose["retries"] or loose["splits"]:
            raise AssertionError(f"memory {name} spilled or retried at the "
                                 f"session's budget: {loose}")
        launches["memory" if plan == "one_device" else
                 "memory_distributed"].update(tight["launches"])
        line = {"phase": "memory", "query": name, "plan": plan,
                "rows": loose_out.num_rows, "result": "equal",
                "session_budget": loose, "tight_budget": tight}
        emit(line)
        lines.append(line)
        # q97's result is held for its injected run below
        queries[name] = (q, plan, loose_out if name == "q97" else None)
        del loose_out

    # injected OOMs at the session's budget, each at the reservation a run
    # without counted (the reservations are the same each run there). The
    # window sorts inside its own exec, so the in-core sort of the running
    # window's 16.76 M rows is their sort on one device: one batch
    q = ordered_queries(session(), m, dec["paths"])["ooc_sort"]
    seen, undo = _alloc_count_at(S, "with_retry_no_split_spillable")
    try:
        want, loose = memory_collect(torch, q, counters, dev)
    finally:
        undo()
    S.COUNTERS.reset()
    out, rec = memory_collect(torch, q, counters, dev,
                              inject=(0, seen[0] + 1))
    rec["sorts"] = S.COUNTERS.snapshot()
    if not out.equals(want) or (rec["retries"], rec["splits"]) != (0, 1) \
            or (rec["sorts"]["in_core"], rec["sorts"]["out_of_core"]) != \
            (0, 1):
        raise AssertionError(f"memory: the injected split of the in-core "
                             f"sort gave {rec}")
    inject = {"in_core_sort_split": dict(rec, at=seen[0] + 1,
                                         rows=want.num_rows,
                                         session_budget=loose)}
    del want, out
    q, _, want = queries["q97"]
    out, rec = memory_collect(torch, q, counters, dev,
                              inject=(probes["q97"], 0))
    if not out.equals(want) or (rec["retries"], rec["splits"]) != (1, 0):
        raise AssertionError(f"memory: the injected retry of q97's probe "
                             f"gave {rec}")
    inject["q97_probe_retry"] = dict(rec, at=probes["q97"])
    q = main_query(session(ONE_BATCH), fact, dim)
    want, loose = memory_collect(torch, q, counters, dev)
    merges, undo = _alloc_count_at(AG.TpuHashAggregateExec, "_multi_batch")
    try:
        out, rec = memory_collect(torch, q, counters, dev, inject=(0, 1))
    finally:
        undo()
    if not out.equals(want) or (rec["retries"], rec["splits"]) != (0, 1) \
            or len(merges) != 1 or rec["launches"] != loose["launches"]:
        raise AssertionError(f"memory: the injected split of the engine "
                             f"query's aggregate gave {rec}, merge passes "
                             f"{len(merges)}")
    inject["engine_aggregate_split"] = dict(rec, at=1, merge_passes=1,
                                            session_budget=loose)
    launches = {p: {k.__name__: n[k.__name__] for k in counters}
                for p, n in launches.items()}
    if launches["memory"]["murmur3_rows"] == 0 or 0 in (
            launches["memory_distributed"]["murmur3_rows"],
            launches["memory_distributed"]["segment_sum_i64"]):
        raise AssertionError(f"the memory paths launched {launches}")
    line = {"phase": "memory", "injected": inject,
            "launches_per_path_run": launches,
            "seconds": time.monotonic() - t_phase}
    emit(line)
    lines.append(line)
    return lines, launches


# ---- plan_nodes (slice 17): the plan nodes and planner passes of slice 17
# over the joins' store_sales, date_dim and item of the same run, and the
# first 4,194,304 sales rewritten sorted by sold date (the way Spark users
# cluster a fact table) in row groups of 262,144: q28 with its bucket
# predicates pushed into the parquet decode beside its unpushed twin, an
# aggregate-only report pushed whole, a year's window of the sorted file
# pruned by its footer, a sample, a range, and the cost-based optimizer
PLAN_SORTED_ROWS = 4 * (1 << 20)
PLAN_SORTED_GROUP = 1 << 18
PLAN_SORTED_COLS = ("ss_sold_date_sk", "ss_item_sk", "ss_store_sk",
                    "ss_quantity", "ss_ext_sales_price")
PLAN_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False,
             "spark.rapids.tpu.fusion.enabled": True}
PUSHDOWN = {"spark.rapids.tpu.scan.pushdown.enabled": True}
OPTIMIZER = {"spark.rapids.sql.optimizer.enabled": True}
# the JAX optimizer test's high transition cost: the whole plan stays on
# the host
OPT_HIGH = dict(OPTIMIZER,
                **{"spark.rapids.sql.optimizer.transitionCost": 1e6})
EXPLAIN_NOT_ON_GPU = {"spark.rapids.sql.explain": "NOT_ON_GPU"}
PLAN_QTY = (1, 20)  # the aggregate-only report: ss_quantity between
PLAN_YEAR = 2000  # the date window's year
PLAN_SAMPLE = (0.01, 17)  # fraction, seed
PLAN_RANGE = (16_777_216, 1024)  # range(0, n) by id % m
PLAN_ROUNDS = 1
# each query's rows compare in this key order; "q28" and "agg_report" are
# one row
PLAN_KEYS = {"date_window": ("i_category", "d_moy"),
             "sample": ("ss_store_sk",), "range": ("k",)}
# the optimizer's placement at its default costs (Q7: every node on the
# card) and at OPT_HIGH (the engine query: every node on the host), as the
# port's and the JAX planner place them from the footers' row counts; the
# `!` lines of each plan's explain, node names only
OPT_MARKS = {"opt_q7": (),
             "opt_engine": ("CpuHashAggregateExec", "CpuHashJoinExec",
                            "CpuFilterExec", "CpuScanExec", "CpuScanExec")}
# C a batch of each distributed fused partial aggregate, as the CPU run
# with counting stand-ins gives them: the date window's decimal sum (2:
# the sum and its count of values) and its count; the range's LONG sum
# (2) and count, fused with the projection of id % m above the range;
# decimal star Q7's. The sample's partial aggregate sits above the
# Sample, which ends fusion's chain, and q28's and the report's
# aggregates are global: none of them launches C
PLAN_C_PER_BATCH = {"date_window": 3, "date_window_pushed": 3, "range": 3,
                    "opt_q7": STAR_DECIMAL_C_PER_BATCH["q7"]}
_U64 = (1 << 64) - 1


def sample_mask_np(n: int, offset: int, fraction: float, seed: int):
    """The port's sample_mask in numpy uint64 (its own copy: the script
    imports no engine code for its oracles): splitmix64 of the row ordinal
    xor the premixed seed, the top 53 bits as a uniform in [0, 1), kept
    below `fraction`."""
    seed_mix = ((seed & _U64) * 0x9E3779B97F4A7C15) & _U64
    z = np.arange(n, dtype=np.uint64) + np.uint64(offset)
    z = (z ^ np.uint64(seed_mix)) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(11)).astype(np.float64) * (2.0 ** -53) < fraction


def plan_nodes_data(pa, tables: dict, d: str) -> dict:
    """The plan_nodes phase's sorted file in directory d and its oracles
    over join_tables' tables: the aggregate-only report and the sample
    over store_sales, and the date window over the sorted file."""
    import pyarrow.parquet as pq
    ss, dd, item = (tables[n] for n in ("store_sales", "date_dim", "item"))
    head = ss.slice(0, PLAN_SORTED_ROWS).select(list(PLAN_SORTED_COLS))
    head = head.take(np.argsort(head.column("ss_sold_date_sk").to_numpy(),
                                kind="stable"))
    sorted_path = os.path.join(d, "store_sales_by_date.parquet")
    pq.write_table(head, sorted_path, row_group_size=PLAN_SORTED_GROUP)
    date_sk = dd.column("d_date_sk").to_numpy()
    in_year = dd.column("d_year").to_numpy() == PLAN_YEAR
    window = (int(date_sk[in_year].min()), int(date_sk[in_year].max()))
    # the date window: year PLAN_YEAR of the sorted sales, by category and
    # month
    date = head.column("ss_sold_date_sk").to_numpy()
    k = (date >= window[0]) & (date <= window[1])
    moy = dd.column("d_moy").to_numpy()[date[k] - date_sk[0]]
    cats = _strings(item.column("i_category"))[
        head.column("ss_item_sk").to_numpy()[k] - 1]
    ext, _ = unscaled(head.column("ss_ext_sales_price"))
    ones = np.ones(int(k.sum()), bool)
    oracle = {"date_window": _grouped_exact(
        {"i_category": _codes(cats), "d_moy": _codes(moy)},
        {"sales": ("isum", ext[k], ones), "n": ("count", ext[k], ones)})}
    qty = ss.column("ss_quantity").to_numpy().astype(np.int64)
    sold = ss.column("ss_sold_date_sk").to_numpy()
    k = (qty >= PLAN_QTY[0]) & (qty <= PLAN_QTY[1])
    oracle["agg_report"] = {"n": [int(k.sum())], "lo": [int(sold[k].min())],
                            "hi": [int(sold[k].max())],
                            "qty": [int(qty[k].sum())]}
    keep = sample_mask_np(ss.num_rows, 0, *PLAN_SAMPLE)
    ones = np.ones(int(keep.sum()), bool)
    oracle["sample"] = _grouped_exact(
        {"ss_store_sk": _codes(ss.column("ss_store_sk").to_numpy()[keep])},
        {"qty": ("isum", qty[keep], ones), "n": ("count", qty[keep], ones)})
    return {"sorted": sorted_path, "window": window, "oracle": oracle,
            "sampled_rows": int(keep.sum())}


def range_oracle() -> dict:
    """range(0, n) by id % m: each group holds n / m ids, k + m * j."""
    n, m = PLAN_RANGE
    per = n // m
    k = np.arange(m, dtype=np.int64)
    return {"k": k.tolist(), "s": (k * per + m * per * (per - 1) // 2)
            .tolist(), "n": [per] * m}


def plan_namespace() -> SimpleNamespace:
    """join_namespace with Min, Max, the DataFrame of a session's range
    and of a sample."""
    from spark_rapids_tpu_torch import expr as E
    m = join_namespace()
    m.Min, m.Max = E.Min, E.Max
    return m


def plan_node_queries(sess, m, paths: dict, sorted_path: str,
                      window: tuple) -> dict:
    """The phase's queries as DataFrames of `sess`, written through the
    namespace `m` (plan_namespace for the port): q28 (join_queries'),
    the aggregate-only report over store_sales (count(*), min and max of
    ss_sold_date_sk and sum(ss_quantity) where ss_quantity between
    PLAN_QTY), the date window (the sorted file's sales between the first
    and last d_date_sk of PLAN_YEAR, joined to date_dim and item, summed
    and counted by i_category and d_moy), the sample
    (store_sales.sample(*PLAN_SAMPLE), quantity summed and rows counted by
    store) and the range (range(0, n) by id % m, summed and counted)."""
    c, lit = m.col, m.lit
    q28 = join_queries(sess, m, paths)["q28"]
    qty = c("ss_quantity")
    agg_report = sess.read_parquet(
        paths["store_sales"], columns=["ss_sold_date_sk", "ss_quantity"]) \
        .filter((qty >= lit(PLAN_QTY[0])) & (qty <= lit(PLAN_QTY[1]))) \
        .agg(n=m.Count(), lo=m.Min(c("ss_sold_date_sk")),
             hi=m.Max(c("ss_sold_date_sk")), qty=m.Sum(qty))
    date = c("ss_sold_date_sk")
    sales = sess.read_parquet(
        sorted_path, columns=["ss_sold_date_sk", "ss_item_sk",
                              "ss_ext_sales_price"]) \
        .filter((date >= lit(window[0])) & (date <= lit(window[1])))
    dates = sess.read_parquet(
        paths["date_dim"], columns=["d_date_sk", "d_year", "d_moy"]) \
        .filter(c("d_year") == lit(PLAN_YEAR)) \
        .select("d_moy", ss_sold_date_sk=c("d_date_sk"))
    items = sess.read_parquet(paths["item"],
                              columns=["i_item_sk", "i_category"]) \
        .select("i_category", ss_item_sk=c("i_item_sk"))
    date_window = sales.join(dates, on="ss_sold_date_sk") \
        .join(items, on="ss_item_sk").group_by("i_category", "d_moy") \
        .agg(sales=m.Sum(c("ss_ext_sales_price")), n=m.Count(lit(1)))
    sample = sess.read_parquet(paths["store_sales"],
                               columns=["ss_store_sk", "ss_quantity"]) \
        .sample(*PLAN_SAMPLE).group_by("ss_store_sk") \
        .agg(qty=m.Sum(qty), n=m.Count(lit(1)))
    n, mod = PLAN_RANGE
    rng = sess.range(0, n).select("id", k=c("id") % lit(mod)) \
        .group_by("k").agg(s=m.Sum(c("id")), n=m.Count(lit(1)))
    return {"q28": q28, "agg_report": agg_report, "date_window": date_window,
            "sample": sample, "range": rng}


def check_plan_query(pa, name: str, out, want: dict) -> None:
    """Raise unless `out` equals the oracle row for row in PLAN_KEYS order:
    decimals (decimal(17,2) sums) as unscaled ints, the rest exactly."""
    if name in PLAN_KEYS:
        out = out.sort_by([(k, "ascending") for k in PLAN_KEYS[name]])
    n = len(next(iter(want.values())))
    if out.num_rows != n:
        raise AssertionError(f"{name}: {out.num_rows} rows, oracle {n}")
    for col, exp in want.items():
        c = out.column(col)
        if pa.types.is_decimal(c.type):
            if c.type != pa.decimal128(17, 2):
                raise AssertionError(f"{name}: column {col} is {c.type}")
            vals, valid = unscaled(c)
            got = [int(v) if ok else None for v, ok in zip(vals, valid)]
        else:
            got = c.to_pylist()
        if got != exp:
            raise AssertionError(f"{name}: column {col} differs from the "
                                 "oracle")


def pruned_from_footer(pq, path: str, column: str, lo: int, hi: int) -> int:
    """The row groups whose footer min/max of `column` lie wholly outside
    [lo, hi]: those a pushed lo <= column <= hi skips."""
    meta = pq.ParquetFile(path).metadata
    ci = meta.schema.names.index(column)
    out = 0
    for rg in range(meta.num_row_groups):
        st = meta.row_group(rg).column(ci).statistics
        out += st.max < lo or st.min > hi
    return out


def _bang_lines(lines) -> tuple:
    """The node names of an explain log's `!` lines."""
    return tuple(ln.strip()[2:].split(" <- ")[0] for ln in lines
                 if ln.lstrip().startswith("!"))


def plan_nodes_phases(torch, pa, mesh_conf: dict, counters, data: dict,
                      joins: dict, dec: dict, fact, dim, conf=None,
                      device=None, rounds=PLAN_ROUNDS) -> dict:
    """Phase plan_nodes: each query on one device and under the
    distributed plan (`mesh_conf`), fusion on and dynamic pruning off
    (PLAN_CONF): q28 pushed (PUSHDOWN) beside its unpushed twin, and the
    date window pushed and unpushed, with the scan counters (rows pruned,
    bytes materialised, row groups pruned: those predicted from the
    footer); the aggregate-only report pushed (no row data
    materialised); the sample; the range; and the optimizer (OPTIMIZER)
    on decimal star Q7 (`dec`'s files) at its default costs and on the
    engine query over the first 4,194,304 rows of `fact` at OPT_HIGH,
    their explain logs' `!` lines held to OPT_MARKS. q28's distributed
    plan is its one-device plan (global aggregates and nested-loop joins:
    the distribution pass has nothing to split), held so and not run
    again. Every result is exact against its oracle; A launches twice per
    fused join per merged batch and C PLAN_C_PER_BATCH a batch of a
    distributed fused partial aggregate, nowhere else. Each query's
    checked, counted collect comes first and warms it up for `rounds`
    timed collects. Returns the launch counts of each plan's run (one
    collect of each query)."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    from spark_rapids_tpu_torch.utils.metrics import TaskMetrics
    dev = resolve_device(device)
    conf = dict(conf or {}, **PLAN_CONF)
    t_phase = time.monotonic()
    m = plan_namespace()
    window = data["window"]
    want = dict(data["oracle"], q28=joins["oracle"]["q28"],
                range=range_oracle())
    rgs = pq.ParquetFile(data["sorted"]).metadata.num_row_groups
    pruned = pruned_from_footer(pq, data["sorted"], "ss_sold_date_sk",
                                *window)
    store_batches = -(-pq.ParquetFile(joins["paths"]["store_sales"])
                      .metadata.num_row_groups // CHUNKS_PER_DISPATCH)
    dec_batches = -(-pq.ParquetFile(dec["paths"]["store_sales"])
                    .metadata.num_row_groups // CHUNKS_PER_DISPATCH)
    head = fact.slice(0, FILES_SALES_ROWS)
    want_engine = query_oracle(head, dim)

    def counted(fn):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        tm = TaskMetrics.get()
        return out, {k.__name__: k.launches for k in counters}, {
            "rows_pruned": tm.scan_rows_pruned,
            "bytes_materialized": tm.scan_bytes_materialized,
            "rowgroups_pruned": tm.scan_rowgroups_pruned}

    def check(name, out):
        if name == "opt_q7":
            check_star_decimal(pa, "q7", out, dec["oracle"]["q7"])
        elif name == "opt_engine":
            check_query(out, want_engine, "opt_engine")
        elif name.startswith("q28"):
            check_join_query(pa, "q28", out, want["q28"])
        else:
            check_plan_query(pa, name.replace("_pushed", ""), out,
                             want[name.replace("_pushed", "")])

    launches, record = {}, {}
    for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
        def session(*more):
            return TpuSession(dict(conf, **extra, **{
                k: v for e in more for k, v in e.items()}), dev)
        plain = plan_node_queries(session(), m, joins["paths"],
                                  data["sorted"], window)
        pushed = plan_node_queries(session(PUSHDOWN), m, joins["paths"],
                                   data["sorted"], window)
        qs = {"date_window": plain["date_window"],
              "date_window_pushed": pushed["date_window"],
              "agg_report_pushed": pushed["agg_report"],
              "sample": plain["sample"], "range": plain["range"]}
        if plan == "one_device":
            qs = dict(q28=plain["q28"], q28_pushed=pushed["q28"], **qs)
        else:
            for n, q in (("q28", plain["q28"]), ("q28_pushed",
                                                  pushed["q28"])):
                if q.explain() != record["one_device"]["queries"][n][
                        "plan"]:
                    raise AssertionError(f"{n}'s distributed plan is not "
                                         "its one-device plan")
        opt = {"opt_q7": session(OPTIMIZER, EXPLAIN_NOT_ON_GPU),
               "opt_engine": session(OPT_HIGH, EXPLAIN_NOT_ON_GPU)}
        qs["opt_q7"] = star_decimal_queries(opt["opt_q7"], star_namespace(),
                                            dec["paths"])["q7"]
        qs["opt_engine"] = main_query(opt["opt_engine"], head, dim)
        per_query, run = {}, {}
        for n, q in qs.items():
            shape = q.explain()
            bangs = None
            if n in opt:
                bangs = _bang_lines(opt[n]._last_explain.splitlines())
                if bangs != OPT_MARKS[n]:
                    raise AssertionError(f"{n} ({plan}): the optimizer "
                                         f"placed {bangs}, not "
                                         f"{OPT_MARKS[n]}")
            batches = {
                "date_window": -(-rgs // CHUNKS_PER_DISPATCH),
                "date_window_pushed": -(-(rgs - pruned)
                                        // CHUNKS_PER_DISPATCH),
                "opt_q7": dec_batches,
                "range": -(-PLAN_RANGE[0] // ARROW_BATCH_ROWS)}.get(
                    n, store_batches)
            want_a = 2 * fused_joins(shape) * batches
            want_c = 0
            if plan == "distributed" and "PartialAgg[" in shape:
                want_c = batches * PLAN_C_PER_BATCH[n]
            walls, seen, scans = [], set(), []
            for i in range(1 + rounds):
                t0 = time.perf_counter()
                out, c, scan = counted(q.collect)
                if i:
                    walls.append(time.perf_counter() - t0)
                check(n, out)
                del out
                seen.add(tuple(sorted(c.items())))
                scans.append(scan)
                if (c["murmur3_rows"], c["segment_sum_i64"],
                        c["segment_sum_f64"]) != (want_a, want_c, 0):
                    raise AssertionError(f"{n} ({plan}) launched {c}, not "
                                         f"A {want_a} and C {want_c}")
            if n.endswith("_pushed") and n != "agg_report_pushed" and \
                    scans[0]["rows_pruned"] == 0:
                raise AssertionError(f"{n} ({plan}) pruned no row: {scans}")
            if n == "agg_report_pushed" and \
                    scans[0]["bytes_materialized"] != 0:
                raise AssertionError(f"{n} materialised rows: {scans}")
            if n == "date_window_pushed" and \
                    scans[0]["rowgroups_pruned"] != pruned:
                raise AssertionError(f"{n} ({plan}) pruned "
                                     f"{scans[0]['rowgroups_pruned']} row "
                                     f"groups, the footer {pruned}")
            run[n] = dict(seen.pop())
            per_query[n] = {"warm_collect_s": spread(walls),
                            "launches_per_collect": run[n],
                            "fused_joins": fused_joins(shape),
                            "scan": scans[0], "plan": shape}
            if bangs is not None:
                per_query[n]["bang_lines"] = list(bangs)
        path = "plan_nodes" if plan == "one_device" else \
            "plan_nodes_distributed"
        launches[path] = {k: sum(r[k] for r in run.values())
                          for k in run["range"]}
        record[plan] = {"queries": per_query,
                        "launches_per_path_run": launches[path]}
    for rec in record.values():
        for q in rec["queries"].values():
            q["plan"] = q["plan"].splitlines()[0]
    emit({"phase": "plan_nodes", "sorted_file": {
              "rows": PLAN_SORTED_ROWS, "row_groups": rgs,
              "window": list(window), "rowgroups_pruned_predicted": pruned},
          "sampled_rows": data["sampled_rows"],
          "exact": "every column against the numpy oracles, decimals as "
          "unscaled ints", "seconds": time.monotonic() - t_phase, **record})
    return launches


# ---- cpu_engine: the host engine and per-operator fallback, over the
# decimal star's files and the engine query's tables of the same run
CPU_ENGINE_ROUNDS = 1
# the JAX rule's key of CpuParquetScanExec: every parquet scan on the host
HOST_SCAN = {"spark.rapids.sql.exec.TpuParquetScanExec": False}
SQL_OFF = {"spark.rapids.sql.enabled": False}
CAST_TYPE = (7, 2)  # avg(ss_quantity) as a report rounds it


def host_cast_q7(sess, m, paths: dict):
    """Path 2: ordered Q7 with its average quantity (a DOUBLE) cast to
    decimal(7,2), a cast the device rule refuses, between the device
    aggregate and the device top-k."""
    from spark_rapids_tpu_torch import types as T
    q7 = star_decimal_queries(sess, m, paths)["q7"]
    return q7.select("i_category", "agg2", "agg3", "agg4", "n",
                     agg1=m.Cast(m.col("agg1"), T.DecimalType(*CAST_TYPE))) \
        .sort(*ORDERED_KEYS["q7"]).limit(ORDERED_LIMIT)


def host_cast_q7_oracle(want: dict) -> dict:
    """The ordered Q7 oracle with agg1 by Spark's rule: the shortest digits
    of the oracle's double average, HALF_UP to 2 places, as unscaled
    ints."""
    from decimal import ROUND_HALF_UP, Decimal
    cols = dict(ordered_oracle(want)["q7"])
    quantum = Decimal(1).scaleb(-CAST_TYPE[1])
    cols["agg1"] = [None if a is None else int(
        Decimal(repr(a)).quantize(quantum, ROUND_HALF_UP).scaleb(CAST_TYPE[1]))
        for a in cols["agg1"]]
    return cols


def check_host_cast_q7(pa, out, want: dict) -> None:
    """agg1's type and unscaled values exactly; every other column as the
    ordered decimal star report's."""
    if out.schema.field("agg1").type != pa.decimal128(*CAST_TYPE):
        raise AssertionError(f"host cast q7: agg1 is "
                             f"{out.schema.field('agg1').type}")
    vals, valid = unscaled(out.column("agg1"))
    if [int(v) if ok else None for v, ok in zip(vals, valid)] != \
            want["agg1"]:
        raise AssertionError("host cast q7: agg1 differs from Spark's rule")
    check_star_decimal(pa, "q7", out,
                       {k: v for k, v in want.items() if k != "agg1"},
                       ordered=True)


def fallback_lines(sess, q, dev) -> list:
    """The `!` lines of q's plan under `sess`'s conf, without printing."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.plan.overrides import Overrides
    conf = TpuConf(dict(sess.conf._settings,
                        **{"spark.rapids.sql.explain": "ALL"}))
    ov = Overrides(conf, dev)
    ov.apply(q.plan)
    return [ln.strip() for ln in ov.explain_string().splitlines()
            if ln.lstrip().startswith("!")]


def host_decode_s(sess, q) -> float:
    """Seconds the host engine takes to read every parquet scan of q's
    plan alone, under sess's conf: pyarrow's decode and the Arrow -> torch
    conversion on the CPU, with no copy to the card."""
    from spark_rapids_tpu_torch.cpu.hostbatch import host_conf, \
        set_host_conf
    from spark_rapids_tpu_torch.io.scanbase import CpuFileScanExec
    scans, todo = {}, [q.plan]
    while todo:
        node = todo.pop()
        if isinstance(node, CpuFileScanExec):
            scans[id(node)] = node
        todo.extend(node.children)
    prev = host_conf()
    set_host_conf(sess.conf)
    try:
        t0 = time.perf_counter()
        for scan in scans.values():
            for _ in scan.execute_cpu():
                pass
        return time.perf_counter() - t0
    finally:
        set_host_conf(prev)


def cpu_engine_phases(torch, pa, mesh_conf: dict, counters, dec: dict,
                      fact, dim, conf=None, device=None, n_fact=N_FACT,
                      rounds=CPU_ENGINE_ROUNDS):
    """Phase cpu_engine, over the decimal star's files (`dec`:
    star_decimal_data's oracle and paths) and the engine query's tables of
    the same run (no new data set). Three paths, each beside the same
    query all on the device in the same phase:
      1. host_scan: decimal star Q7 with spark.rapids.sql.exec.
         TpuParquetScanExec=false (pyarrow reads every table on the host,
         TpuFromCpuExec lifts each batchSizeRows batch), on one device and
         distributed, exact against star_decimal_oracle; A twice per fused
         join per host batch of store_sales, and distributed C
         STAR_DECIMAL_C_PER_BATCH a host batch;
      2. host_cast: ordered Q7 with agg1 cast to decimal(7,2) on the host
         between the device aggregate and the device top-k, on both plans,
         agg1 against Spark's rule and the rest against the ordered
         oracle; A twice per fused join per merged batch, no C (the
         distribution pass stops at the host node, as in the JAX planner);
      3. sql_off: the engine query with spark.rapids.sql.enabled=false on
         the first `n_fact` fact rows, exact against query_oracle, with no
         launch, a budget peak of 0 and an empty spill catalog.
    Prints one line a path and plan with the walls (the checked, counted
    collect warms the query up), the transitions' rows, bytes, host
    seconds (pinning and enqueueing the copies to the card; waiting for
    the stream and copying to the host) and device seconds (CUDA events
    around the copies on the card's stream), for path 1 the seconds its
    parquet scans take alone on the host (`host_decode_s`),
    the launches against the explain tree's count, the `!` lines and
    torch.get_num_threads(); returns the launches of each path's run."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.expr import Cast
    from spark_rapids_tpu_torch.memory.budget import MemoryBudget
    from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    from spark_rapids_tpu_torch.utils.metrics import TaskMetrics
    dev = resolve_device(device)
    conf = dict(conf or {}, **{"spark.rapids.tpu.fusion.enabled": True})
    t_phase = time.monotonic()
    want, paths = dec["oracle"], dec["paths"]
    m = ordered_namespace()
    m.Cast = Cast

    def counted(q):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = q.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tm = TaskMetrics.get()
        to_device_s, to_host_s = tm.copy_seconds()
        moved = {"host_nodes_run": tm.host_nodes_run,
                 "to_device": {"rows": tm.to_device_rows,
                               "bytes": tm.to_device_bytes,
                               "host_s": tm.to_device_ns / 1e9,
                               "device_s": to_device_s},
                 "to_host": {"rows": tm.to_host_rows,
                             "bytes": tm.to_host_bytes,
                             "host_s": tm.to_host_ns / 1e9,
                             "device_s": to_host_s}}
        return out, wall, moved, {k.__name__: k.launches for k in counters}

    def walls(q):
        out = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q.collect()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return spread(out)

    sales = paths["store_sales"]
    batch_rows = TpuSession(conf, dev).conf.batch_size_rows
    host_batches = -(-pq.ParquetFile(sales).metadata.num_rows // batch_rows)
    merged = -(-pq.ParquetFile(sales).metadata.num_row_groups
               // CHUNKS_PER_DISPATCH)
    cast_want = host_cast_q7_oracle(want)
    lines, launches = [], {}
    for path, plan, extra in (
            ("host_scan", "one_device", HOST_SCAN),
            ("host_scan", "distributed", dict(HOST_SCAN, **mesh_conf)),
            ("host_cast", "one_device", {}),
            ("host_cast", "distributed", mesh_conf)):
        sess = TpuSession(dict(conf, **extra), dev)
        twin = TpuSession(dict(conf, **{k: v for k, v in extra.items()
                                        if k not in HOST_SCAN}), dev)
        if path == "host_scan":
            q = star_decimal_queries(sess, m, paths)["q7"]
            device_q = star_decimal_queries(twin, m, paths)["q7"]
            batches = host_batches
        else:
            q = host_cast_q7(sess, m, paths)
            device_q = ordered_queries(twin, m, paths)["q7"]
            batches = merged
        tree = q.explain()
        bang = fallback_lines(sess, q, dev)
        out, wall, moved, run = counted(q)
        if path == "host_scan":
            check_star_decimal(pa, "q7", out, want["q7"])
        else:
            check_host_cast_q7(pa, out, cast_want)
        partial = "PartialAgg[" in tree
        want_a = 2 * fused_joins(tree) * batches
        want_c = STAR_DECIMAL_C_PER_BATCH["q7"] * batches if partial else 0
        if (run["murmur3_rows"], run["segment_sum_i64"]) != (want_a, want_c) \
                or want_a == 0 or partial != (path == "host_scan"
                                              and plan == "distributed") \
                or "TpuFromCpuExec" not in tree or not bang:
            raise AssertionError(f"cpu_engine {path} ({plan}) launched "
                                 f"{run}, not A {want_a} and C {want_c}, "
                                 f"fallbacks {bang}:\n{tree}")
        if path == "host_cast" and (moved["to_host"]["rows"] !=
                                    len(cast_want["agg1"]) or
                                    moved["host_nodes_run"] != 1):
            raise AssertionError(f"cpu_engine host_cast moved {moved}")
        name = f"cpu_engine_{path}" + ("_distributed" if plan ==
                                       "distributed" else "")
        launches[name] = run
        if path == "host_scan":
            extra_s = {"host_decode_s": host_decode_s(sess, q)}
        else:
            extra_s = {}
        line = {"phase": "cpu_engine", "path": path, "plan": plan,
                "rows": out.num_rows, "exact": True, "fallbacks": bang,
                "fused_joins": fused_joins(tree), "batches": batches,
                "launches_per_collect": run,
                "predicted": {"murmur3_rows": want_a,
                              "segment_sum_i64": want_c},
                "transitions": moved, **extra_s, "counted_collect_s": wall,
                "warm_collect_s": walls(q),
                "device_plan_warm_collect_s": walls(device_q),
                "torch_threads": torch.get_num_threads()}
        emit(line)
        lines.append(line)

    # 3. the whole engine query on the host engine
    fact_n = fact.slice(0, n_fact)
    oracle = query_oracle(fact_n, dim)
    q = main_query(TpuSession(dict(conf, **SQL_OFF), dev), fact_n, dim)
    device_q = main_query(TpuSession(conf, dev), fact_n, dim)
    check_query(device_q.collect(), oracle, "cpu_engine device twin")
    out, wall, moved, run = counted(q)
    check_query(out, oracle, "cpu_engine sql_off")
    peak = MemoryBudget.get().peak_used
    parked = len(BufferCatalog.get()._entries)
    if any(run.values()) or peak or parked or moved["to_device"]["rows"] \
            or moved["host_nodes_run"] != 5:
        raise AssertionError(f"cpu_engine sql_off: launched {run}, budget "
                             f"peak {peak}, {parked} parked, moved {moved}")
    launches["cpu_engine_sql_off"] = run
    line = {"phase": "cpu_engine", "path": "sql_off", "plan": "host",
            "fact_rows": n_fact, "groups": int(len(oracle[0])),
            "exact": True, "launches_per_collect": run,
            "predicted": {k.__name__: 0 for k in counters},
            "peak_budget_bytes": peak, "parked": parked,
            "transitions": moved, "counted_collect_s": wall,
            "warm_collect_s": walls(q),
            "device_plan_warm_collect_s": walls(device_q),
            "torch_threads": torch.get_num_threads(),
            "seconds": time.monotonic() - t_phase}
    emit(line)
    lines.append(line)
    return lines, launches

# ---- strings (slice 14): TPC-DS q23's frequent_ss_items, a text report
# and LIKE/RLIKE over item's descriptions, and the long-string layout at
# spark.rapids.tpu.string.headWidth=64, over agg_tables' files (with
# date_dim's d_date). Each query is collected once, checked and counted.
STRINGS_YEARS = (2000, 2001, 2002, 2003)  # q23: d_year in (2000, .., +3)
STRINGS_HAVING = 4  # q23: having count(*) > 4
STRINGS_LIMIT = 100
STRINGS_MONTH = (2001, 1)  # 3(a): d_year = 2001 and d_moy = 1
STRINGS_LIKE = "ab%"
STRINGS_RLIKE = "^[a-c]b"
STRINGS_HEAD = 64  # 3: spark.rapids.tpu.string.headWidth
# 3(a): timed collects of each width after the checked one, in turns
STRINGS_CARRY_ROUNDS = 4
# 3(b): the host rerun reads the first 4 row groups of store_sales
STRINGS_HOST_ROWS = 4 * (1 << 20)
STRINGS_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False,
                "spark.rapids.tpu.fusion.enabled": True}
# kernel C a merged store_sales batch under the distributed plan: the
# fused partial aggregates' int64 sums and counts (q23's count(*); the
# report's five aggregates less the string max; the LIKE joins' price sum
# and count(*)), as tests/test_torch_smoke_strings.py counts them on the
# CPU; none on one device, and none in 3's month of sales (no aggregate).
# A is 2 a fused join a batch (fused_joins).
STRINGS_C_PER_BATCH = {"q23": 1, "q23_top": 1, "report": 7, "like": 3,
                       "rlike": 3, "carry": 0}


def strings_namespace() -> SimpleNamespace:
    """The port's constructors that strings_queries uses."""
    from spark_rapids_tpu_torch import expr as E
    return SimpleNamespace(**{n: getattr(E, n) for n in (
        "col", "lit", "In", "Sum", "Count", "Average", "Max", "If",
        "Substring", "Upper", "Length", "Contains", "Concat", "StringTrim",
        "Like", "RLike")})


def strings_queries(sess, m, paths: dict, sales: str = "store_sales"
                    ) -> dict:
    """The strings phase's queries as DataFrames of `sess` over agg_tables'
    files, written once for either engine through the namespace `m`:
    q23's frequent_ss_items (`q23`, with TPC-DS's HAVING, and `q23_top`,
    the same aggregate ordered by cnt DESC, itemdesc, i_item_sk, d_date
    LIMIT 100), the text report by upper(substr(i_item_desc, 1, 2)), the
    sales per item of the items whose description matches LIKE 'ab%' and
    RLIKE '^[a-c]b', and `carry` (3(a)): a month of sales with its items'
    descriptions, no byte read. `sales` names the store_sales file."""
    c, lit = m.col, m.lit

    def read(name, cols):
        return sess.read_parquet(paths[name], columns=cols)

    def joined(cols):
        dates = read("date_dim", ["d_date_sk", "d_year", "d_date"]).filter(
            m.In(c("d_year"), list(STRINGS_YEARS))).select(
            "d_date", ss_sold_date_sk=c("d_date_sk"))
        items = read("item", ["i_item_sk", "i_item_desc", "i_brand"]) \
            .select("i_item_desc", "i_brand", ss_item_sk=c("i_item_sk"))
        return read(sales, ["ss_sold_date_sk", "ss_item_sk"] + cols) \
            .join(dates, on="ss_sold_date_sk").join(items, on="ss_item_sk")

    fs = joined([]).select(
        itemdesc=m.Substring(c("i_item_desc"), lit(1), lit(30)),
        i_item_sk=c("ss_item_sk"), d_date=c("d_date")) \
        .group_by("itemdesc", "i_item_sk", "d_date") \
        .agg(cnt=m.Count(lit(1)))
    desc = c("i_item_desc")
    report = joined(["ss_sales_price"]).select(
        prefix=m.Upper(m.Substring(desc, lit(1), lit(2))),
        price=c("ss_sales_price"), dlen=m.Length(desc),
        qu=m.If(m.Contains(desc, lit(" qu")), lit(1), lit(0)),
        label=m.Concat(c("i_brand"), lit("/"), m.StringTrim(
            m.Substring(desc, lit(5), lit(12))))) \
        .group_by("prefix").agg(
            sales=m.Sum(c("price")), n=m.Count(lit(1)),
            avg_len=m.Average(c("dlen")), qu=m.Sum(c("qu")),
            label=m.Max(c("label"))).sort("prefix")

    def matched(pred):
        items = read("item", ["i_item_sk", "i_item_desc"]).filter(pred) \
            .select(ss_item_sk=c("i_item_sk"))
        return read(sales, ["ss_item_sk", "ss_sales_price"]) \
            .join(items, on="ss_item_sk").group_by("ss_item_sk") \
            .agg(sales=m.Sum(c("ss_sales_price")), n=m.Count(lit(1))) \
            .sort("ss_item_sk")

    month = read("date_dim", ["d_date_sk", "d_year", "d_moy"]).filter(
        (c("d_year") == lit(STRINGS_MONTH[0]))
        & (c("d_moy") == lit(STRINGS_MONTH[1]))).select(
        ss_sold_date_sk=c("d_date_sk"))
    carry = read(sales, ["ss_sold_date_sk", "ss_item_sk"]) \
        .join(month, on="ss_sold_date_sk") \
        .join(read("item", ["i_item_sk", "i_item_desc"]).select(
            "i_item_desc", ss_item_sk=c("i_item_sk")), on="ss_item_sk") \
        .select("ss_item_sk", "ss_sold_date_sk", "i_item_desc")
    return {"q23": fs.filter(c("cnt") > lit(STRINGS_HAVING)).sort(
                "itemdesc", "i_item_sk", "d_date"),
            "q23_top": fs.sort(("cnt", False, False), "itemdesc",
                               "i_item_sk", "d_date").limit(STRINGS_LIMIT),
            "report": report,
            "like": matched(m.Like(desc, lit(STRINGS_LIKE))),
            "rlike": matched(m.RLike(desc, lit(STRINGS_RLIKE))),
            "carry": carry}


def strings_oracle(pa, t: dict, n_sales: int = None) -> dict:
    """numpy answers to strings_queries over agg_tables (the first
    `n_sales` sales when given): columns in the queries' order, decimals
    as unscaled ints, dates as days since the epoch, strings as Python
    str; `carry`'s row count and `q23_groups`."""
    ss, dd, it = t["store_sales"], t["date_dim"], t["item"]
    if n_sales is not None:
        ss = ss.slice(0, n_sales)
    dsk = dd.column("d_date_sk").to_numpy()
    yr = np.zeros(dsk.max() + 1, np.int32)
    yr[dsk] = dd.column("d_year").to_numpy()
    moy = np.zeros(dsk.max() + 1, np.int32)
    moy[dsk] = dd.column("d_moy").to_numpy()
    day = np.zeros(dsk.max() + 1, np.int64)
    day[dsk] = dd.column("d_date").cast(pa.int32()).to_numpy()
    date = ss.column("ss_sold_date_sk").to_numpy()
    item = ss.column("ss_item_sk").to_numpy()
    cents, valid = unscaled(ss.column("ss_sales_price"))
    descs = [v.encode() for v in it.column("i_item_desc").to_pylist()]
    brands = [v.encode() for v in it.column("i_brand").to_pylist()]
    n_item = len(descs)
    keep = np.isin(yr[date], STRINGS_YEARS)
    # q23: count(*) by (item, d_date); itemdesc is unique to the item
    d0 = int(day.min())
    span = int(day.max()) - d0 + 1
    key = item[keep] * span + (day[date[keep]] - d0)
    groups, cnt = np.unique(key, return_counts=True)
    g_item, g_day = groups // span, groups % span + d0
    desc30 = [d[:30] for d in descs]
    rank = np.empty(n_item + 1, np.int64)
    rank[1 + np.array(sorted(range(n_item), key=desc30.__getitem__))] = \
        np.arange(n_item)

    def rows(sel, limit=None):
        ix = np.flatnonzero(sel)
        ix = ix[np.lexsort((g_day[ix], g_item[ix], rank[g_item[ix]],
                            -cnt[ix]) if limit else
                           (g_day[ix], g_item[ix], rank[g_item[ix]]))]
        ix = ix[:limit]
        return {"itemdesc": [desc30[i - 1].decode() for i in g_item[ix]],
                "i_item_sk": g_item[ix].tolist(),
                "d_date": g_day[ix].tolist(), "cnt": cnt[ix].tolist()}

    top_cut = np.partition(cnt, -STRINGS_LIMIT)[-STRINGS_LIMIT] \
        if len(cnt) >= STRINGS_LIMIT else 0
    out = {"q23": rows(cnt > STRINGS_HAVING),
           "q23_top": rows(cnt >= top_cut, STRINGS_LIMIT),
           "q23_groups": int(len(groups))}
    # the report by upper(substr(desc, 1, 2)), over the prefixes sold
    pcode, item_pid = np.unique(np.array([d[:2].upper() for d in descs],
                                         object), return_inverse=True)
    pid_of = np.concatenate(([0], item_pid))
    sold, pid = np.unique(pid_of[item[keep]], return_inverse=True)
    pcode = pcode[sold]
    ng = len(pcode)
    ok = valid[keep]
    sales = np.zeros(ng, np.int64)
    np.add.at(sales, pid[ok], cents[keep][ok])
    has = np.bincount(pid[ok], minlength=ng) > 0
    n = np.bincount(pid, minlength=ng)
    lens = np.array([0] + [len(d) for d in descs], np.int64)
    qu = np.array([0] + [b" qu" in d for d in descs], np.int64)
    label = [b""] + [brands[i] + b"/" + descs[i][4:16].strip(b" ")
                     for i in range(n_item)]
    best = [b""] * ng
    for gi in np.unique(pid * (n_item + 1) + item[keep]):
        g, i = divmod(int(gi), n_item + 1)
        best[g] = max(best[g], label[i])
    out["report"] = {
        "prefix": [p.decode() for p in pcode],
        "sales": [int(v) if h else None for v, h in zip(sales, has)],
        "n": n.tolist(),
        "avg_len": (np.bincount(pid, weights=lens[item[keep]], minlength=ng)
                    / n).tolist(),
        "qu": np.bincount(pid, weights=qu[item[keep]], minlength=ng)
        .astype(np.int64).tolist(),
        "label": [b.decode() for b in best]}
    for name, test in (("like", lambda d: d.startswith(b"ab")),
                       ("rlike", lambda d: d[:1] in (b"a", b"b", b"c")
                        and d[1:2] == b"b")):
        hit = np.array([False] + [test(d) for d in descs])
        sel = hit[item]
        ks, kid = np.unique(item[sel], return_inverse=True)
        ok = valid[sel]
        tot = np.zeros(len(ks), np.int64)
        np.add.at(tot, kid[ok], cents[sel][ok])
        hs = np.bincount(kid[ok], minlength=len(ks)) > 0
        out[name] = {"ss_item_sk": ks.tolist(),
                     "sales": [int(v) if h else None for v, h in
                               zip(tot, hs)],
                     "n": np.bincount(kid, minlength=len(ks)).tolist()}
        out[f"{name}_items"] = int(hit.sum())
    out["carry_rows"] = int(((yr[date] == STRINGS_MONTH[0])
                             & (moy[date] == STRINGS_MONTH[1])).sum())
    out["long_descs"] = int(sum(len(d) > STRINGS_HEAD for d in descs))
    return out


def strings_data(pa, tables: dict, d: str, paths: dict,
                 host_rows: int = STRINGS_HOST_ROWS) -> dict:
    """The strings phase's oracles (over all sales, and over the first
    `host_rows` that the host rerun reads) and the file of those first
    rows, beside agg_data's files in directory d."""
    import pyarrow.parquet as pq
    head = {"store_sales_head": tables["store_sales"].slice(0, host_rows)}
    return {"oracle": strings_oracle(pa, tables),
            "oracle_head": strings_oracle(pa, tables, host_rows),
            "paths": dict(paths, **write_parquet(pq, head, d,
                                                 tag="_strings"))}


def check_strings(pa, name: str, out, want: dict) -> None:
    """Raise unless a strings query's result equals the oracle: every
    column exact, the report's avg_len within rtol 1e-12."""
    if out.num_rows != len(next(iter(want.values()))):
        raise AssertionError(f"strings {name}: {out.num_rows} rows, the "
                             f"oracle {len(next(iter(want.values())))}")
    for col, w in want.items():
        got = out.column(col)
        if pa.types.is_decimal(got.type):
            got = [None if v is None else int(v.scaleb(-v.as_tuple()
                                                       .exponent))
                   for v in got.to_pylist()]
        elif pa.types.is_date32(got.type):
            got = got.cast(pa.int32()).to_pylist()
        else:
            got = got.to_pylist()
        if col == "avg_len":
            if not np.allclose(got, w, rtol=1e-12, atol=0):
                raise AssertionError(f"strings {name}: {col} differs")
        elif got != w:
            raise AssertionError(f"strings {name}: column {col} differs "
                                 "from the oracle")


def _string_bytes(batch, name: str) -> int:
    """Bytes of one string column of a batch: head or flat matrix,
    lengths, validity, and a long column's blob and tail offsets."""
    c = batch.columns[batch.schema.names.index(name)]
    return sum(t.numel() * t.element_size() for t in c.leaves())


def strings_phases(torch, pa, mesh_conf: dict, counters, data: dict,
                   conf=None, device=None, gather_rows: int = 1 << 20,
                   c_per_batch=STRINGS_C_PER_BATCH,
                   carry_rounds: int = STRINGS_CARRY_ROUNDS):
    """Phase strings over agg_tables' files (`data`: strings_data):
      1. q23's frequent_ss_items (HAVING and top 100) and 2. the text
         report and the LIKE/RLIKE item sales, on one device and under the
         distributed plan, exact against strings_oracle;
      3. at headWidth=64: (a) a month of sales carrying i_item_desc (no
         byte op: the plan stays on the card) against the same query at
         the default width, as sorted row sets, with the string column's
         bytes a batch at both widths, then `carry_rounds` timed collects
         of each width in turns; (b) q23 over the first
         STRINGS_HOST_ROWS sales, where Substring meets the long layout
         and the plan reruns on the host once, against the oracle of
         those rows and the same query at the default width; (c) (a)
         with autoBroadcastJoinThreshold=-1 under the distributed plan,
         item's tails crossing the exchange's byte plane.
    Every collect launches A 2 a fused join (explain tree) a merged
    store_sales batch, and C `c_per_batch` a batch under the distributed
    plan (`held`); 3(b)'s device attempt at headWidth=64 stops at its
    first batch's Substring, after that batch's probes, and the host
    rerun launches nothing. Then the device times of the regex machine on item's descriptions and
    of Substring on a `gather_rows`-row gather of them. Prints one line a
    query and plan, and one for the kernels of the expressions; returns
    the launches of each plan's run (one collect of each query)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.expr.base import EvalContext, Vec
    from spark_rapids_tpu_torch.expr import regex as RX
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    from spark_rapids_tpu_torch.utils.metrics import TaskMetrics
    dev = resolve_device(device)
    conf = dict(conf or {}, **STRINGS_CONF)
    paths, want = data["paths"], data["oracle"]
    def batches_of(name):
        rgs = pq.ParquetFile(paths[name]).metadata.num_row_groups
        return -(-rgs // CHUNKS_PER_DISPATCH)
    batches = batches_of("store_sales")
    m = strings_namespace()
    t_phase = time.monotonic()

    def collect(q):
        """One collect: (table, wall s, launches, reruns, peak bytes)."""
        torch.cuda.synchronize()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = q.collect()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        return out, wall, launched(), \
            TaskMetrics.get().cpu_fallback_reruns, peak

    def launched():
        return {k.__name__: k.launches for k in counters}

    def held(what, shape, ran, name, n_batches, distributed):
        """Raise unless a collect launched A and C as its explain tree
        says: (A, C) of `n_batches` store_sales batches."""
        a = 2 * fused_joins(shape) * n_batches
        c = c_per_batch[name] * n_batches if distributed else 0
        if (ran["murmur3_rows"], ran["segment_sum_i64"]) != (a, c):
            raise AssertionError(f"strings {what} launched {ran}, not A "
                                 f"{a} and C {c}")

    launches = {}
    for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
        qs = strings_queries(TpuSession(dict(conf, **extra), dev), m, paths)
        run = {}
        for n in ("q23", "q23_top", "report", "like", "rlike"):
            shape = qs[n].explain()
            out, wall, run[n], reruns, peak = collect(qs[n])
            check_strings(pa, n, out, want[n])
            held(f"{n} ({plan})", shape, run[n], n, batches,
                 plan == "distributed")
            if reruns:
                raise AssertionError(f"strings {n} ({plan}): {reruns} "
                                     "reruns")
            emit({"phase": "strings", "query": n, "plan": plan,
                  "rows": out.num_rows, "collect_s": wall,
                  "launches": run[n], "fused_joins": fused_joins(shape),
                  "store_sales_batches": batches,
                  "exchanges": shape.count("TpuShuffleExchangeExec"),
                  "cpu_fallback_reruns": reruns,
                  "max_memory_allocated": peak})
        path = "strings" if plan == "one_device" else "strings_distributed"
        launches[path] = {k: sum(r[k] for r in run.values())
                          for k in run["q23"]}
    # 3. the long-string layout at headWidth=64
    head = {"spark.rapids.tpu.string.headWidth": STRINGS_HEAD}
    carry, carry_bytes, carry_q = {}, {}, {}
    for width, extra in (("256", {}), ("64", head)):
        sess = TpuSession(dict(conf, **extra), dev)
        q = carry_q[width] = strings_queries(sess, m, paths)["carry"]
        shape = q.explain()
        out, wall, ran, reruns, peak = collect(q)
        held(f"3(a) at width {width}", shape, ran, "carry", batches, False)
        per_batch = [_string_bytes(b, "i_item_desc")
                     for b in sess.plan_device(q.plan).execute()]
        carry[width] = out.sort_by([(n, "ascending") for n in
                                    out.column_names])
        carry_bytes[width] = per_batch
        if out.num_rows != want["carry_rows"] or reruns:
            raise AssertionError(f"3(a) at width {width}: {out.num_rows} "
                                 f"rows, {reruns} reruns")
        emit({"phase": "strings", "query": "carry", "head_width": width,
              "rows": out.num_rows, "collect_s": wall, "launches": ran,
              "fused_joins": fused_joins(shape),
              "cpu_fallback_reruns": reruns, "max_memory_allocated": peak,
              "string_bytes_per_batch": per_batch})
    if not carry["64"].equals(carry["256"]):
        raise AssertionError("3(a): the row sets differ between widths")
    carry_walls = {"256": [], "64": []}
    for r in range(carry_rounds):
        for width in ("256", "64") if r % 2 == 0 else ("64", "256"):
            carry_walls[width].append(collect(carry_q[width])[1])
    # bytes of the column gathered to gather_rows rows, at both widths
    item = pq.read_table(paths["item"], columns=["i_item_desc"])
    idx = torch.from_numpy(np.random.default_rng(3).integers(
        0, item.num_rows, gather_rows)).to(dev)
    gathered = {}
    for width, hw in (("256", None), ("64", STRINGS_HEAD)):
        col = batch_from_arrow(item, dev, conf=None if hw is None else
                               TpuConf(head)).columns[0]
        v = Vec.from_column(col).gather(idx)
        gathered[width] = sum(t.numel() * t.element_size()
                              for t in v.to_column().leaves())
    # 3(b): q23 over the first rows: the host rerun
    head_want = data["oracle_head"]
    head_batches = batches_of("store_sales_head")
    twins = {}
    for width, extra in (("256", {}), ("64", head)):
        q = strings_queries(TpuSession(dict(conf, **extra), dev), m, paths,
                            sales="store_sales_head")["q23_top"]
        shape = q.explain()
        attempt = []  # the launches when the host rerun starts
        rerun = q.plan.execute_cpu
        q.plan.execute_cpu = lambda: (attempt.append(launched()),
                                      rerun())[1]
        out, wall, ran, reruns, peak = collect(q)
        check_strings(pa, "q23_top (first rows)", out, head_want["q23_top"])
        if reruns != (1 if width == "64" else 0) or \
                len(attempt) != reruns:
            raise AssertionError(f"3(b) at width {width}: {reruns} reruns")
        if attempt:  # the device attempt, then nothing on the host
            held("3(b)'s device attempt", shape, attempt[0], "q23_top", 1,
                 False)
            if ran != attempt[0]:
                raise AssertionError(f"3(b): the host rerun launched "
                                     f"{ran} after {attempt[0]}")
        else:
            held("3(b) at width 256", shape, ran, "q23_top", head_batches,
                 False)
        twins[width] = out
        emit({"phase": "strings", "query": "q23_top_host_rerun",
              "head_width": width, "sales_rows": STRINGS_HOST_ROWS,
              "rows": out.num_rows, "collect_s": wall, "launches": ran,
              "device_attempt_launches": attempt[0] if attempt else None,
              "fused_joins": fused_joins(shape),
              "store_sales_batches": head_batches,
              "cpu_fallback_reruns": reruns, "max_memory_allocated": peak})
    if not twins["64"].equals(twins["256"]):
        raise AssertionError("3(b): the rerun differs from the device run")
    # 3(c): (a) shuffled under the distributed plan at both widths
    shuffled = {}
    for width, extra in (("256", {}), ("64", head)):
        sess = TpuSession(dict(conf, **mesh_conf, **extra, **{
            "spark.rapids.sql.autoBroadcastJoinThreshold": -1}), dev)
        q = strings_queries(sess, m, paths)["carry"]
        shape = q.explain()
        out, wall, ran, reruns, peak = collect(q)
        held(f"3(c) at width {width}", shape, ran, "carry", batches, True)
        shuffled[width] = out.sort_by([(n, "ascending") for n in
                                       out.column_names])
        if reruns or shape.count("TpuShuffleExchangeExec") < 2:
            raise AssertionError(f"3(c) at width {width}: {reruns} reruns,"
                                 f" plan:\n{shape}")
        emit({"phase": "strings", "query": "carry_shuffled",
              "head_width": width, "rows": out.num_rows, "collect_s": wall,
              "launches": ran, "fused_joins": fused_joins(shape),
              "exchanges": shape.count("TpuShuffleExchangeExec"),
              "cpu_fallback_reruns": reruns, "max_memory_allocated": peak})
        if not shuffled[width].equals(carry["256"]):
            raise AssertionError(f"3(c) at width {width} differs from 3(a)")
    # the device times of the string expressions
    desc = batch_from_arrow(item, dev).columns[0]
    like = m.Like(m.col("s"), m.lit(STRINGS_LIKE))
    rlike = m.RLike(m.col("s"), m.lit(STRINGS_RLIKE))
    got = RX.match_plan(like._plan, desc.data, desc.lengths)
    n_like = int((got & desc.validity)[:item.num_rows].sum())
    if n_like != want["like_items"]:
        raise AssertionError(f"match_plan: {n_like} LIKE items, the oracle "
                             f"{want['like_items']}")
    big = Vec.from_column(desc).gather(idx)
    bctx = EvalContext(torch.ones(gather_rows, dtype=torch.bool,
                                  device=dev))
    sub = m.Substring(m.col("s"), m.lit(1), m.lit(30))
    one, thirty = (Vec.from_column(_lit_col(torch, v, gather_rows, dev))
                   for v in (1, 30))
    times = {
        "like_match_plan": time_ms(torch, lambda: RX.match_plan(
            like._plan, desc.data, desc.lengths), rounds=5, calls=3),
        "rlike_match_plan": time_ms(torch, lambda: RX.match_plan(
            rlike._plan, desc.data, desc.lengths), rounds=5, calls=3),
        "substring_1_30": time_ms(torch, lambda: sub._compute(
            bctx, big, one, thirty), rounds=5, calls=3)}
    emit({"phase": "strings", "check": "layout_and_expressions",
          "head_width": STRINGS_HEAD, "long_descs": want["long_descs"],
          "items": item.num_rows, "like_items": want["like_items"],
          "rlike_items": want["rlike_items"],
          "q23_groups": want["q23_groups"],
          "q23_having_rows": len(want["q23"]["cnt"]),
          "carry_bytes_per_batch": carry_bytes,
          "carry_collect_s": {w: spread(v) for w, v in carry_walls.items()},
          "gathered_bytes": {"rows": gather_rows, **gathered,
                             "ratio": gathered["256"] / gathered["64"]},
          "device_ms": times, "substring_shape": [gather_rows,
                                                  int(big.data.shape[1])],
          "seconds": time.monotonic() - t_phase})
    return launches


def _lit_col(torch, value: int, n: int, dev):
    """An INT column of n rows, all `value` (a Substring argument)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import Column
    return Column(T.INT, torch.full((n,), value, dtype=torch.int32,
                                    device=dev),
                  torch.ones(n, dtype=torch.bool, device=dev))


# ---- strings_ext (slice 15): the rest of the string functions and the
# casts from and to STRING, over agg_tables' files: TPC-DS q21 with its
# date window as TPC-DS writes it, `cast('2001-03-11' as date)` -/+ 30
# days (DateSub/DateAdd, slice 16), a formatted store report
# (concat_ws, lpad of keys cast to STRING, initcap, translate, replace,
# soundex, format_number, an average cast to STRING on the host engine),
# and store_sales staged as text, as a CSV load leaves it, parsed back by
# casts (under ANSI its malformed rows raise). One checked collect a query
# and plan.
EXT_PIVOT = "2001-03-11"  # q21: the pivot, and 30 days either side of it
EXT_DAYS = 30
EXT_WINDOW = tuple(str(np.datetime64(EXT_PIVOT) + k)
                   for k in (-EXT_DAYS, EXT_DAYS))
EXT_PRICE = ("0.99", "1.49")  # q21: i_current_price between
EXT_RATIO = (2.0 / 3.0, 3.0 / 2.0)  # q21: inv_after / inv_before between
EXT_LIMIT = 100
EXT_YEAR = 2001  # the report's year
EXT_TEXT_ROWS = 4 * (1 << 20)  # the first sales, staged as text
EXT_SPACED = 0.01  # texts with surrounding spaces (each column)
EXT_MALFORMED = 0.001  # prices that do not parse: "12.3.4" or "n/a"
EXT_MALFORMS = ("12.3.4", "n/a")
EXT_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False,
            "spark.rapids.tpu.fusion.enabled": True}
# kernel C a merged probe batch under the distributed plan, as
# tests/test_torch_smoke_strings_ext.py counts them on the CPU: q21's two
# int64 sums and their counts in the fused partial aggregate; none in the
# report (its host cast above the aggregate stops the distribution pass,
# so the aggregate runs complete) or in the text parse (a bare scan under
# the partial aggregate: no fused stage); the ANSI twin's filter fuses
# with its partial aggregate: the bigint sum, the double sum's count and
# count(...) with its own, 4. None on one device. A is 2 a fused join a
# batch (fused_joins).
EXT_C_PER_BATCH = {"q21": 4, "report": 0, "text": 0, "text_good": 4}


def strings_ext_namespace() -> SimpleNamespace:
    """The port's constructors that strings_ext_queries uses, and its
    types as `T`."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    m = SimpleNamespace(**{n: getattr(E, n) for n in (
        "col", "lit", "Cast", "CaseWhen", "Sum", "Count", "Average",
        "Concat", "ConcatWs", "StringLPad", "InitCap", "StringTranslate",
        "StringReplace", "SoundEx", "FormatNumber", "Like", "DateAdd",
        "DateSub")})
    m.T = T
    return m


def strings_ext_queries(sess, m, paths: dict) -> dict:
    """The phase's queries as DataFrames of `sess` over agg_tables' files
    and the text file (`store_sales_text`), written once for either engine
    through the namespace `m`: `q21`, `report` and the text parse by store
    (`text`), and `text_good`, the same over the rows whose price text is
    well formed (the ANSI twin)."""
    import decimal
    c, lit, T = m.col, m.lit, m.T

    def read(name, cols):
        return sess.read_parquet(paths[name], columns=cols)

    def day(text):
        return m.Cast(lit(text), T.DATE)

    low, high = (lit(decimal.Decimal(p), T.DecimalType(3, 2))
                 for p in EXT_PRICE)
    items = read("item", ["i_item_sk", "i_current_price"]).filter(
        (c("i_current_price") >= low) & (c("i_current_price") <= high)) \
        .select(inv_item_sk=c("i_item_sk"))
    pivot = day(EXT_PIVOT)
    dates = read("date_dim", ["d_date_sk", "d_date"]).filter(
        (c("d_date") >= m.DateSub(pivot, lit(EXT_DAYS)))
        & (c("d_date") <= m.DateAdd(pivot, lit(EXT_DAYS)))).select(
        "d_date", inv_date_sk=c("d_date_sk"))
    wh = read("warehouse", ["w_warehouse_sk", "w_warehouse_name"]).select(
        "w_warehouse_name", inv_warehouse_sk=c("w_warehouse_sk"))
    qty = c("inv_quantity_on_hand")
    x = read("inventory", ["inv_date_sk", "inv_item_sk", "inv_warehouse_sk",
                           "inv_quantity_on_hand"]) \
        .join(wh, on="inv_warehouse_sk").join(items, on="inv_item_sk") \
        .join(dates, on="inv_date_sk").select(
            "w_warehouse_name", i_item_sk=c("inv_item_sk"),
            before=m.CaseWhen([(c("d_date") < pivot, qty)], lit(0)),
            after=m.CaseWhen([(c("d_date") >= pivot, qty)], lit(0))) \
        .group_by("w_warehouse_name", "i_item_sk").agg(
            inv_before=m.Sum(c("before")), inv_after=m.Sum(c("after")))
    ratio = m.CaseWhen([(c("inv_before") > lit(0),
                         c("inv_after") / c("inv_before"))],
                       lit(None, T.DOUBLE))
    q21 = x.filter((ratio >= lit(EXT_RATIO[0]))
                   & (ratio <= lit(EXT_RATIO[1]))) \
        .sort("w_warehouse_name", "i_item_sk").limit(EXT_LIMIT)

    months = read("date_dim", ["d_date_sk", "d_year", "d_moy"]).filter(
        c("d_year") == lit(EXT_YEAR)).select(
        "d_year", "d_moy", ss_sold_date_sk=c("d_date_sk"))
    stores = read("store", ["s_store_sk", "s_store_name"]).select(
        "s_store_name", ss_store_sk=c("s_store_sk"))
    name = c("s_store_name")

    def text(e):
        return m.Cast(e, T.STRING)

    report = read("store_sales", ["ss_sold_date_sk", "ss_store_sk",
                                  "ss_sales_price"]) \
        .join(months, on="ss_sold_date_sk").join(stores, on="ss_store_sk") \
        .select("ss_store_sk", "s_store_name", "d_year", "d_moy",
                "ss_sales_price",
                price=m.Cast(c("ss_sales_price"), T.DOUBLE)) \
        .group_by("ss_store_sk", "s_store_name", "d_year", "d_moy").agg(
            total=m.Sum(c("ss_sales_price")),
            avg_price=m.Average(c("price")), n=m.Count(lit(1))) \
        .select("avg_price", "n",
                id=m.ConcatWs(lit("-"), lit("store"), m.StringLPad(
                    text(c("ss_store_sk")), lit(4), lit("0"))),
                month=m.Concat(text(c("d_year")), lit("-"), m.StringLPad(
                    text(c("d_moy")), lit(2), lit("0"))),
                title=m.InitCap(name),
                vowels=m.StringTranslate(name, lit("aeiou"), lit("AEIOU")),
                short=m.StringReplace(name, lit(" pack"), lit("-pk")),
                code=m.SoundEx(name),
                total=m.FormatNumber(m.Cast(c("total"), T.DOUBLE), lit(2))) \
        .select("id", "month", "title", "vowels", "short", "code", "total",
                "avg_price", "n", avg=text(c("avg_price"))) \
        .sort("id", "month")

    staged = read("store_sales_text", ["ss_store_sk", "item_text",
                                       "price_text"])

    def parsed(df):
        return df.group_by("ss_store_sk").agg(
            items=m.Sum(m.Cast(c("item_text"), T.LONG)),
            price=m.Sum(m.Cast(c("price_text"), T.DOUBLE)),
            n=m.Count(m.Cast(c("price_text"), T.DOUBLE))).sort("ss_store_sk")

    good = ~m.Like(c("price_text"), lit("%/%")) \
        & ~m.Like(c("price_text"), lit("%.%.%"))
    return {"q21": q21, "report": report, "text": parsed(staged),
            "text_good": parsed(staged.filter(good))}


def _days(text: str) -> int:
    return int(np.datetime64(text, "D").astype(np.int64))


def spark_soundex(s: str) -> str:
    """UTF8String.soundex: a first byte that is not a letter returns the
    string; H and W carry the last code, any other non-coded byte resets
    it (the phase's store names hold no case where the JAX kernel's
    carry-through of a non-letter differs)."""
    codes = "01230127022455012623017202"
    if not s or not s[0].isascii() or not s[0].isalpha():
        return s
    out, last = s[0].upper(), codes[ord(s[0].upper()) - 65]
    for ch in s[1:]:
        if not (ch.isascii() and ch.isalpha()):
            last = "0"
            continue
        code = codes[ord(ch.upper()) - 65]
        if code == "7":
            continue
        if code != "0" and code != last:
            out += code
            if len(out) == 4:
                break
        last = code
    return out.ljust(4, "0")


def spark_format_number(v: float, d: int) -> str:
    """format_number as the phase uses it: the double HALF_UP to d places,
    a comma every three integer digits."""
    from decimal import ROUND_HALF_UP, Decimal
    q = Decimal(v).quantize(Decimal(1).scaleb(-d), ROUND_HALF_UP)
    return format(q, f",.{d}f")


def java_plain_double(v: float) -> str:
    """Double.toString for 10^-3 <= |v| < 10^7, where Java writes the
    shortest digits plainly: Python's repr there."""
    if not 1e-3 <= abs(v) < 1e7:
        raise ValueError(f"{v!r} is outside the plain range")
    return repr(v)


def strings_ext_text(pa, ss, n: int = EXT_TEXT_ROWS, seed: int = 59):
    """store_sales' first n rows as a text load leaves them: ss_store_sk,
    item_text (ss_item_sk's digits) and price_text (ss_sales_price as
    "12.34"); EXT_SPACED of each text column wrapped in spaces, a share
    EXT_MALFORMED of the prices replaced by EXT_MALFORMS, the null prices
    null. Returns (table, bad mask)."""
    import pyarrow.compute as pc
    head = ss.slice(0, n)
    n = head.num_rows
    rng = np.random.default_rng(seed)
    cents, valid = unscaled(head.column("ss_sales_price"))

    def spaced(arr):
        return pc.if_else(pa.array(rng.random(n) < EXT_SPACED),
                          pc.binary_join_element_wise(" ", arr, " ", ""),
                          arr)

    price = pc.binary_join_element_wise(
        pc.cast(pa.array(cents // 100, mask=~valid), pa.string()),
        pc.utf8_lpad(pc.cast(pa.array(cents % 100), pa.string()), 2, "0"),
        ".")
    bad = (rng.random(n) < EXT_MALFORMED) & valid
    price = pc.if_else(pa.array(bad), pc.if_else(
        pa.array(rng.random(n) < 0.5), EXT_MALFORMS[0], EXT_MALFORMS[1]),
        spaced(price))
    item = spaced(pc.cast(head.column("ss_item_sk"), pa.string()))
    return pa.table({"ss_store_sk": head.column("ss_store_sk"),
                     "item_text": item, "price_text": price}), bad


def strings_ext_oracle(pa, t: dict, text_bad=None) -> dict:
    """numpy answers to strings_ext_queries over agg_tables and the text
    table (`t["store_sales_text"]`, its malformed rows `text_bad`):
    columns in the queries' order, decimals as unscaled ints, the
    report's formatted columns as Spark writes them (the average's text
    is checked against the port's own double, check_strings_ext)."""
    dd, it, inv = t["date_dim"], t["item"], t["inventory"]
    dsk = dd.column("d_date_sk").to_numpy()
    day = np.zeros(dsk.max() + 1, np.int64)
    day[dsk] = dd.column("d_date").cast(pa.int32()).to_numpy()
    yr = np.zeros(dsk.max() + 1, np.int64)
    yr[dsk] = dd.column("d_year").to_numpy()
    moy = np.zeros(dsk.max() + 1, np.int64)
    moy[dsk] = dd.column("d_moy").to_numpy()
    out = {}
    # q21
    price, _ = unscaled(it.column("i_current_price"))
    lo, hi = (int(round(float(p) * 100)) for p in EXT_PRICE)
    chosen = np.zeros(len(price) + 1, bool)
    chosen[it.column("i_item_sk").to_numpy()] = (price >= lo) & \
        (price <= hi)
    d = day[inv.column("inv_date_sk").to_numpy()]
    item = inv.column("inv_item_sk").to_numpy()
    wh = inv.column("inv_warehouse_sk").to_numpy()
    qcol = inv.column("inv_quantity_on_hand")
    q = qcol.fill_null(0).to_numpy().astype(np.int64)
    qv = np.asarray(qcol.is_valid())
    keep = chosen[item] & (d >= _days(EXT_WINDOW[0])) & \
        (d <= _days(EXT_WINDOW[1]))
    pv = _days(EXT_PIVOT)
    key = wh[keep] * (len(price) + 1) + item[keep]
    groups, gid = np.unique(key, return_inverse=True)
    sums = {}
    for name, side in (("inv_before", d[keep] < pv),
                       ("inv_after", d[keep] >= pv)):
        val = np.where(side, q[keep], 0)
        ok = np.where(side, qv[keep], True)
        tot = np.zeros(len(groups), np.int64)
        np.add.at(tot, gid[ok], val[ok])
        sums[name] = (tot, np.bincount(gid[ok], minlength=len(groups)) > 0)
    (b, bh), (a, ah) = sums["inv_before"], sums["inv_after"]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = a.astype(np.float64) / b
    sel = bh & ah & (b > 0) & (ratio >= EXT_RATIO[0]) & \
        (ratio <= EXT_RATIO[1])
    whn = np.array(t["warehouse"].column("w_warehouse_name").to_pylist(),
                   object)
    g_wh, g_item = groups // (len(price) + 1), groups % (len(price) + 1)
    names = whn[g_wh - 1]
    ix = np.flatnonzero(sel)
    ix = ix[np.lexsort((g_item[ix], names[ix].astype(str)))][:EXT_LIMIT]
    out["q21"] = {"w_warehouse_name": names[ix].tolist(),
                  "i_item_sk": g_item[ix].tolist(),
                  "inv_before": b[ix].tolist(), "inv_after": a[ix].tolist()}
    out["q21_groups"] = int(len(groups))
    out["q21_having"] = int(sel.sum())
    # the report
    ss = t["store_sales"]
    sdate = ss.column("ss_sold_date_sk").to_numpy()
    store = ss.column("ss_store_sk").to_numpy()
    cents, valid = unscaled(ss.column("ss_sales_price"))
    in_year = yr[sdate] == EXT_YEAR
    rkey = store[in_year] * 13 + moy[sdate[in_year]]
    rg, rid = np.unique(rkey, return_inverse=True)
    ok = valid[in_year]
    total = np.zeros(len(rg), np.int64)
    np.add.at(total, rid[ok], cents[in_year][ok])
    has = np.bincount(rid[ok], minlength=len(rg)) > 0
    psum = np.bincount(rid[ok], weights=cents[in_year][ok] / 100.0,
                       minlength=len(rg))
    cnt_ok = np.bincount(rid[ok], minlength=len(rg))
    names = dict(zip(t["store"].column("s_store_sk").to_pylist(),
                     t["store"].column("s_store_name").to_pylist()))
    sk, mo = rg // 13, rg % 13
    nm = [names[int(k)] for k in sk]
    out["report"] = {
        "id": [f"store-{int(k):04d}" for k in sk],
        "month": [f"{EXT_YEAR}-{int(v):02d}" for v in mo],
        "title": [" ".join(w[:1].upper() + w[1:].lower()
                           for w in v.split(" ")) for v in nm],
        "vowels": [v.translate(str.maketrans("aeiou", "AEIOU")) for v in nm],
        "short": [v.replace(" pack", "-pk") for v in nm],
        "code": [spark_soundex(v) for v in nm],
        "total": [spark_format_number(float(v) / 100.0, 2) if h else None
                  for v, h in zip(total, has)],
        "avg_price": [s / c if c else None for s, c in zip(psum, cnt_ok)],
        "n": np.bincount(rid, minlength=len(rg)).tolist()}
    # the text parse by store, and over the well-formed rows only
    tx = t.get("store_sales_text")
    if tx is not None:
        tstore = tx.column("ss_store_sk").to_numpy()
        titem = ss.column("ss_item_sk").to_numpy()[:tx.num_rows]
        tcents, tvalid = cents[:tx.num_rows], valid[:tx.num_rows]
        fine = tvalid & ~text_bad
        for name, rows in (("text", np.ones(tx.num_rows, bool)),
                           ("text_good", fine)):
            ks, kid = np.unique(tstore[rows], return_inverse=True)
            f = fine[rows]
            out[name] = {
                "ss_store_sk": ks.tolist(),
                "items": np.bincount(kid, weights=titem[rows],
                                     minlength=len(ks)).astype(np.int64)
                .tolist(),
                "price": np.bincount(kid[f], weights=tcents[rows][f] / 100.0,
                                     minlength=len(ks)).tolist(),
                "n": np.bincount(kid[f], minlength=len(ks)).tolist()}
        out["text_malformed"] = int(text_bad.sum())
    return out


def strings_ext_data(pa, tables: dict, d: str, paths: dict,
                     text_rows: int = EXT_TEXT_ROWS) -> dict:
    """The phase's text file (strings_ext_text over the first `text_rows`
    sales) beside agg_data's files in directory d, and its oracle."""
    import pyarrow.parquet as pq
    text, bad = strings_ext_text(pa, tables["store_sales"], text_rows)
    want = strings_ext_oracle(pa, dict(tables, store_sales_text=text), bad)
    return {"oracle": want, "text_bad": bad, "paths": dict(
        paths, **write_parquet(pq, {"store_sales_text": text}, d,
                               tag="_text"))}


def check_strings_ext(pa, name: str, out, want: dict) -> None:
    """Raise unless a strings_ext query's result equals the oracle: every
    column exact but the doubles (the report's average, the parsed price
    sums: rtol 1e-12); the report's average text equal to Java's
    Double.toString of the average the engine computed."""
    n = len(next(iter(want.values())))
    if out.num_rows != n:
        raise AssertionError(f"strings_ext {name}: {out.num_rows} rows, the "
                             f"oracle {n}")
    for col, w in want.items():
        got = out.column(col).to_pylist()
        if col in ("avg_price", "price"):
            if any((g is None) != (v is None) for g, v in zip(got, w)) or \
                    not np.allclose([g for g in got if g is not None],
                                    [v for v in w if v is not None],
                                    rtol=1e-12, atol=0):
                raise AssertionError(f"strings_ext {name}: {col} differs")
        elif got != w:
            raise AssertionError(f"strings_ext {name}: column {col} "
                                 "differs from the oracle")
    if name == "report":
        avg = out.column("avg_price").to_pylist()
        text = out.column("avg").to_pylist()
        if text != [None if v is None else java_plain_double(v)
                    for v in avg]:
            raise AssertionError("strings_ext report: the average's text "
                                 "is not Java's Double.toString")


def strings_ext_phases(torch, pa, mesh_conf: dict, counters, data: dict,
                       conf=None, device=None,
                       c_per_batch=EXT_C_PER_BATCH):
    """Phase strings_ext over agg_tables' files and the text file (`data`:
    strings_ext_data), dynamic pruning off, fusion on:
      1. q21 and 2. the formatted store report, on one device and under
         the distributed plan, exact against strings_ext_oracle; the
         report's average cast to STRING runs on the host engine between
         device stages (its `!` line);
      3. the text parse by store on both plans, exact (the double sums
         rtol 1e-12), and under ANSI: the collect raises
         [CAST_INVALID_INPUT], its twin over the well-formed rows is
         exact; the first row group's prices parsed on the device equal
         Python float() bit for bit;
      4. the device times of the float parse and of lpad(cast(... as
         string)) over one row group's rows, beside their byte bounds.
    Every collect launches A 2 a fused join (explain tree) a merged probe
    batch and C `c_per_batch` a batch under the distributed plan. Prints
    one line a query and plan and one for the expressions; returns the
    launches of each plan's run (one collect of each query)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.errors import AnsiViolation
    from spark_rapids_tpu_torch.expr.base import BoundReference, \
        EvalContext, Vec
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **EXT_CONF)
    paths, want = data["paths"], data["oracle"]
    rate = H100_BYTES_PER_S
    m = strings_ext_namespace()
    t_phase = time.monotonic()

    def batches_of(name):
        rgs = pq.ParquetFile(paths[name]).metadata.num_row_groups
        return -(-rgs // CHUNKS_PER_DISPATCH)

    probe = {"q21": batches_of("inventory"),
             "report": batches_of("store_sales"),
             "text": batches_of("store_sales_text"),
             "text_good": batches_of("store_sales_text")}

    def launched():
        return {k.__name__: k.launches for k in counters}

    def collect(q):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = q.collect()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launched()

    def held(what, shape, ran, name, distributed):
        a = 2 * fused_joins(shape) * probe[name]
        c = c_per_batch[name] * probe[name] if distributed else 0
        if (ran["murmur3_rows"], ran["segment_sum_i64"]) != (a, c):
            raise AssertionError(f"strings_ext {what} launched {ran}, not "
                                 f"A {a} and C {c}")

    launches = {}
    for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
        sess = TpuSession(dict(conf, **extra), dev)
        qs = strings_ext_queries(sess, m, paths)
        run = {}
        for n in ("q21", "report", "text"):
            shape = qs[n].explain()
            out, wall, run[n] = collect(qs[n])
            check_strings_ext(pa, n, out, want[n])
            held(f"{n} ({plan})", shape, run[n], n, plan == "distributed")
            bangs = fallback_lines(sess, qs[n], dev)
            if bangs != ([] if n != "report" else [
                    "! CpuProjectExec <- cast double -> string is not "
                    "supported on TPU"]):
                raise AssertionError(f"strings_ext {n} ({plan}): {bangs}")
            emit({"phase": "strings_ext", "query": n, "plan": plan,
                  "rows": out.num_rows, "collect_s": wall,
                  "launches": run[n], "fused_joins": fused_joins(shape),
                  "probe_batches": probe[n], "host_nodes": bangs,
                  "exchanges": shape.count("TpuShuffleExchangeExec")})
        # ANSI: the malformed prices raise; the twin over the well-formed
        # rows answers exactly
        asess = TpuSession(dict(conf, **extra, **ANSI_CONF), dev)
        aq = strings_ext_queries(asess, m, paths)
        try:
            aq["text"].collect()
        except AnsiViolation as e:
            message = str(e)
        else:
            raise AssertionError(f"strings_ext text ({plan}) did not raise "
                                 "under ANSI")
        # item_text always parses: the price's cast raises
        if message != ("[CAST_INVALID_INPUT] value cannot be cast to "
                       "double"):
            raise AssertionError(f"strings_ext ANSI: {message!r}")
        shape = aq["text_good"].explain()
        out, wall, ran = collect(aq["text_good"])
        check_strings_ext(pa, "text_good", out, want["text_good"])
        held(f"text_good ({plan}, ANSI)", shape, ran, "text_good",
             plan == "distributed")
        emit({"phase": "strings_ext", "query": "text_ansi", "plan": plan,
              "raised": message, "twin_rows": out.num_rows,
              "twin_collect_s": wall, "twin_launches": ran})
        path = "strings_ext" if plan == "one_device" else \
            "strings_ext_distributed"
        launches[path] = {k: sum(r[k] for r in run.values())
                          for k in run["q21"]}
    # the first row group's prices on the device against Python float()
    pf = pq.ParquetFile(paths["store_sales_text"])
    first = pf.read_row_group(0, columns=["ss_store_sk", "price_text"])
    rows = first.num_rows
    cols = batch_from_arrow(first, dev).columns
    store, price = (Vec.from_column(c) for c in cols)
    from spark_rapids_tpu_torch.expr import cast as CA
    got = CA._from_string(price, T.DOUBLE)
    bits = got.data[:rows].cpu().numpy().view(np.int64)
    ok = got.validity[:rows].cpu().numpy()

    def py_float(s):
        try:
            return float(s)
        except (TypeError, ValueError):
            return None

    ref = [py_float(s) for s in first.column("price_text").to_pylist()]
    ref_ok = np.array([v is not None for v in ref])
    ref_bits = np.array([0.0 if v is None else v for v in ref]) \
        .view(np.int64)
    if not (np.array_equal(ok, ref_ok) and
            np.array_equal(bits[ref_ok], ref_bits[ref_ok])):
        raise AssertionError("strings_ext: the device float parse differs "
                             "from Python float()")
    # device times over the row group, beside their byte bounds
    pctx = EvalContext(torch.ones(price.validity.shape[0], dtype=torch.bool,
                                  device=dev))
    lpad = m.StringLPad(m.Cast(BoundReference(0, T.LONG), T.STRING),
                        m.lit(8), m.lit("0"))
    padded = lpad.eval(pctx, [store])

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    times = {
        "float_parse": {
            "ms": time_ms(torch, lambda: CA._from_string(price, T.DOUBLE),
                          rounds=5, calls=3),
            "bound_ms": nbytes(price.data, price.lengths, price.validity,
                               got.data, got.validity) / rate * 1e3,
            "shape": list(price.data.shape)},
        "lpad_cast_string": {
            "ms": time_ms(torch, lambda: lpad.eval(pctx, [store]),
                          rounds=5, calls=3),
            "bound_ms": nbytes(store.data, store.validity, padded.data,
                               padded.lengths, padded.validity)
            / rate * 1e3,
            "shape": list(padded.data.shape)}}
    emit({"phase": "strings_ext", "check": "parse_and_expressions",
          "first_batch_rows": rows, "parsed": int(ok.sum()),
          "bit_identical_to_python_float": True,
          "malformed": want["text_malformed"],
          "q21_groups": want["q21_groups"],
          "q21_having": want["q21_having"], "device_ms": times,
          "seconds": time.monotonic() - t_phase})
    return launches


# ---- datetime (slice 16): dates, times, math and bitwise, and the casts
# between STRING and DECIMAL/TIMESTAMP, over agg_tables' files and the
# strings_ext text file: a calendar report by year, ISO week and weekday,
# TPC-DS q96's half hour on timestamps built from ss_sold_time_sk, an
# hourly report for January 2001 with a TIMESTAMP -> STRING cast on the
# host between device stages, and the sales' price text parsed as
# decimal(7,2) on the host (under ANSI its malformed rows raise). Dynamic
# pruning off, fusion on; one checked collect and one warm collect a query
# and plan.
DT_CONF = {"spark.rapids.sql.dynamicFilePruning.enabled": False,
           "spark.rapids.tpu.fusion.enabled": True}
DT_HOUR = (20, 30)  # q96: hour(ts) = 20 and minute(ts) >= 30
DT_MONTH = (2001, 1)  # the hourly report's month
DT_TS_PATTERN = "yyyy-MM-dd HH:mm:ss"
DT_ROUNDS = 1
# kernel C a merged probe batch under the distributed plan, as
# tests/test_torch_smoke_datetime.py counts them on the CPU (None on one
# device); A is 2 a fused join a batch (fused_joins)
DT_C_PER_BATCH = {"calendar": 12, "q96": 1, "hourly": 0, "parse": 0}


DT_NAMES = ("col", "lit", "Cast", "CaseWhen", "Sum", "Count", "Max", "Min",
            "Average", "Year", "WeekOfYear", "DayOfWeek", "DayName",
            "DateDiff", "LastDay", "AddMonths", "NextDay", "DateFormat",
            "TruncDate", "Round", "Sqrt", "Log10", "Floor", "Ceil",
            "ShiftRight", "BitwiseAnd", "BitwiseXor", "UnixDate",
            "TimestampSeconds", "Hour", "Minute", "TruncTimestamp",
            "UnixTimestamp", "UnixTimestampFromTs")


def datetime_namespace() -> SimpleNamespace:
    """The port's constructors that datetime_queries uses, and its types
    as `T`."""
    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    m = SimpleNamespace(**{n: getattr(E, n) for n in DT_NAMES})
    m.T = T
    return m


def datetime_queries(sess, m, paths: dict) -> dict:
    """The phase's queries as DataFrames of `sess` over agg_tables' files
    and the text file, written once for either engine through `m`:
    `calendar`, `q96`, `hourly` and `parse`."""
    c, lit, T = m.col, m.lit, m.T

    def read(name, cols):
        return sess.read_parquet(paths[name], columns=cols)

    sales = read("store_sales", ["ss_sold_date_sk", "ss_sold_time_sk",
                                 "ss_item_sk", "ss_store_sk",
                                 "ss_sales_price"])
    d = c("d_date")
    cal = sales.join(read("date_dim", ["d_date_sk", "d_date"]).select(
        "d_date", ss_sold_date_sk=c("d_date_sk")), on="ss_sold_date_sk") \
        .select("ss_sales_price", yr=m.Year(d), wk=m.WeekOfYear(d),
                dow=m.DayOfWeek(d), dname=m.DayName(d),
                left=m.DateDiff(m.LastDay(d), d),
                nxt_month=m.AddMonths(d, lit(1)),
                sunday=m.NextDay(d, "SU"),
                month=m.DateFormat(m.TruncDate(d, "MONTH"), "yyyy-MM"),
                price=m.Cast(c("ss_sales_price"), T.DOUBLE),
                bucket=m.BitwiseAnd(m.ShiftRight(c("ss_item_sk"), lit(10)),
                                    lit(7)),
                mix=m.BitwiseXor(c("ss_item_sk"), c("ss_store_sk"))) \
        .group_by("yr", "wk", "dow", "dname").agg(
            n=m.Count(lit(1)), total=m.Sum(c("ss_sales_price")),
            days_left=m.Sum(c("left")), last_next=m.Max(c("nxt_month")),
            first_sunday=m.Min(c("sunday")), month=m.Max(c("month")),
            avg_price=m.Average(c("price")), buckets=m.Sum(c("bucket")),
            mix=m.Max(c("mix"))) \
        .select("yr", "wk", "dow", "dname", "n", "total", "days_left",
                "last_next", "first_sunday", "month", "avg_price",
                "buckets", "mix", r2=m.Round(c("avg_price"), 2),
                root=m.Sqrt(c("avg_price")), lg=m.Log10(c("avg_price")),
                fl=m.Floor(c("avg_price")), ce=m.Ceil(c("avg_price"))) \
        .sort("yr", "wk", "dow")

    def with_ts(dates):
        secs = m.Cast(m.UnixDate(c("d_date")), T.LONG) * lit(86_400) + \
            m.Cast(c("ss_sold_time_sk"), T.LONG)
        return sales.join(dates.select(
            "d_date", ss_sold_date_sk=c("d_date_sk")),
            on="ss_sold_date_sk").select(
            "ss_store_sk", ts=m.TimestampSeconds(secs))

    ts = c("ts")
    q96 = with_ts(read("date_dim", ["d_date_sk", "d_date"])).filter(
        (m.Hour(ts) == lit(DT_HOUR[0])) & (m.Minute(ts) >= lit(DT_HOUR[1]))) \
        .group_by("ss_store_sk").agg(n=m.Count(lit(1))).sort("ss_store_sk")

    month = read("date_dim", ["d_date_sk", "d_date", "d_year", "d_moy"]) \
        .filter((c("d_year") == lit(DT_MONTH[0]))
                & (c("d_moy") == lit(DT_MONTH[1])))
    same = m.UnixTimestamp(m.DateFormat(ts, DT_TS_PATTERN),
                           DT_TS_PATTERN) == m.UnixTimestampFromTs(ts)
    hourly = with_ts(month).select(
        hour=m.TruncTimestamp("HOUR", ts),
        same=m.CaseWhen([(same, lit(1))], lit(0))) \
        .group_by("hour").agg(n=m.Count(lit(1)), same=m.Sum(c("same"))) \
        .select("hour", "n", "same",
                label=m.DateFormat(c("hour"), "yyyy-MM-dd HH:mm"),
                text=m.Cast(c("hour"), T.STRING)) \
        .sort("hour")

    parse = read("store_sales_text", ["ss_store_sk", "price_text"]) \
        .select("ss_store_sk", price=m.Cast(c("price_text"),
                                            T.DecimalType(*MONEY))) \
        .group_by("ss_store_sk").agg(total=m.Sum(c("price")),
                                     n=m.Count(c("price"))) \
        .sort("ss_store_sk")
    return {"calendar": cal, "q96": q96, "hourly": hourly, "parse": parse}


def _date_attrs(days: np.ndarray) -> dict:
    """Python's calendar of each day number (the oracle's, independent of
    the engine's arithmetic)."""
    import calendar
    import datetime
    epoch = datetime.date(1970, 1, 1)
    out = {k: [] for k in ("yr", "wk", "dow", "dname", "left", "nxt_month",
                           "sunday", "month")}
    for day in days.tolist():
        t = epoch + datetime.timedelta(days=day)
        iso = t.isocalendar()
        last = calendar.monthrange(t.year, t.month)[1]
        ny, nm = (t.year + 1, 1) if t.month == 12 else (t.year, t.month + 1)
        nxt = datetime.date(ny, nm, min(t.day, calendar.monthrange(ny,
                                                                 nm)[1]))
        ahead = (6 - t.weekday()) % 7 or 7  # the next Sunday, not today
        out["yr"].append(t.year)
        out["wk"].append(iso[1])
        out["dow"].append(t.isoweekday() % 7 + 1)  # 1 = Sunday
        out["dname"].append(t.strftime("%a"))
        out["left"].append(last - t.day)
        out["nxt_month"].append((nxt - epoch).days)
        out["sunday"].append(day + ahead)
        out["month"].append(f"{t.year:04d}-{t.month:02d}")
    return {k: np.array(v) for k, v in out.items()}


def datetime_oracle(pa, t: dict, text=None, text_bad=None) -> dict:
    """numpy/Python answers to datetime_queries over agg_tables (and the
    text table's first rows with their malformed mask): columns in the
    queries' order, decimals as unscaled ints, dates as day numbers,
    timestamps as microseconds."""
    ss, dd = t["store_sales"], t["date_dim"]
    dsk = dd.column("d_date_sk").to_numpy()
    dday = dd.column("d_date").cast(pa.int32()).to_numpy().astype(np.int64)
    sdate = ss.column("ss_sold_date_sk").to_numpy() - dsk[0]
    used = np.unique(sdate)
    attrs = _date_attrs(dday[used])
    pos = np.zeros(len(dsk), np.int64)
    pos[used] = np.arange(len(used))
    at = pos[sdate]
    cents, valid = unscaled(ss.column("ss_sales_price"))
    item = ss.column("ss_item_sk").to_numpy()
    store = ss.column("ss_store_sk").to_numpy()
    tod = ss.column("ss_sold_time_sk").to_numpy().astype(np.int64)
    out = {}
    # the calendar report
    yr, wk, dow = (attrs[k][at] for k in ("yr", "wk", "dow"))
    key = (yr * 54 + wk) * 8 + dow
    groups, gid = np.unique(key, return_inverse=True)
    g = len(groups)

    def per_group(op, vals, init):
        acc = np.full(g, init, vals.dtype)
        op.at(acc, gid, vals)
        return acc

    first = np.zeros(g, np.int64)
    first[gid[::-1]] = np.arange(len(gid))[::-1]
    n_valid = np.bincount(gid[valid], minlength=g)
    has = n_valid > 0
    tot = np.zeros(g, np.int64)
    np.add.at(tot, gid[valid], cents[valid])
    psum = np.bincount(gid[valid], weights=cents[valid] / 100.0,
                       minlength=g)
    avg = psum / np.maximum(n_valid, 1)
    mon = attrs["month"]
    mon_ix = np.searchsorted(np.unique(mon), mon)
    out["calendar"] = {
        "yr": (groups // (54 * 8)).tolist(),
        "wk": (groups // 8 % 54).tolist(), "dow": (groups % 8).tolist(),
        "dname": attrs["dname"][at][first].tolist(),
        "n": np.bincount(gid, minlength=g).tolist(),
        "total": [int(v) if h else None for v, h in zip(tot, has)],
        "days_left": per_group(np.add, attrs["left"][at], 0).tolist(),
        "last_next": per_group(np.maximum, attrs["nxt_month"][at],
                               -2 ** 62).tolist(),
        "first_sunday": per_group(np.minimum, attrs["sunday"][at],
                                  2 ** 62).tolist(),
        "month": np.unique(mon)[per_group(np.maximum, mon_ix[at],
                                          -1)].tolist(),
        "avg_price": [v if h else None for v, h in zip(avg, has)],
        "buckets": per_group(np.add, (item >> 10) & 7, 0).tolist(),
        "mix": per_group(np.maximum, item ^ store, -2 ** 62).tolist()}
    # q96 and the hourly report, on the sale's UTC second
    secs = dday[sdate] * 86_400 + tod
    half = (secs // 3600 % 24 == DT_HOUR[0]) & \
        (secs // 60 % 60 >= DT_HOUR[1])
    stores, counts = np.unique(store[half], return_counts=True)
    out["q96"] = {"ss_store_sk": stores.tolist(), "n": counts.tolist()}
    lo = int((np.datetime64(f"{DT_MONTH[0]}-{DT_MONTH[1]:02d}")
              .astype("datetime64[s]")).astype(np.int64))
    hi = int(((np.datetime64(f"{DT_MONTH[0]}-{DT_MONTH[1]:02d}") + 1)
              .astype("datetime64[s]")).astype(np.int64))
    inside = (secs >= lo) & (secs < hi)
    hours, hcount = np.unique(secs[inside] // 3600 * 3600,
                              return_counts=True)
    stamps = hours.astype("datetime64[s]")
    out["hourly"] = {
        "hour": (hours * 10 ** 6).tolist(), "n": hcount.tolist(),
        "same": hcount.tolist(),
        "label": [str(v)[:16].replace("T", " ") for v in stamps],
        "text": [str(v).replace("T", " ") for v in stamps]}
    # the price text as decimal(7,2) by store: the well-formed rows
    if text is not None:
        rows = text.num_rows
        fine = valid[:rows] & ~text_bad
        tstore = text.column("ss_store_sk").to_numpy()
        ks, kid = np.unique(tstore, return_inverse=True)
        tsum = np.zeros(len(ks), np.int64)
        np.add.at(tsum, kid[fine], cents[:rows][fine])
        n_ok = np.bincount(kid[fine], minlength=len(ks))
        out["parse"] = {"ss_store_sk": ks.tolist(),
                        "total": [int(v) if k else None
                                  for v, k in zip(tsum, n_ok)],
                        "n": n_ok.tolist()}
        out["parse_malformed"] = int(text_bad.sum())
    out["calendar_groups"] = g
    return out


def datetime_data(pa, tables: dict, ext: dict, text_rows=EXT_TEXT_ROWS
                  ) -> dict:
    """The phase's oracle over agg_tables and strings_ext's text file
    (`ext`, strings_ext_data's result); the files are theirs."""
    import pyarrow.parquet as pq
    text = pq.read_table(ext["paths"]["store_sales_text"],
                         columns=["ss_store_sk"])
    return {"oracle": datetime_oracle(pa, tables, text, ext["text_bad"]),
            "paths": ext["paths"]}


DT_DOUBLES = ("avg_price", "r2", "root", "lg", "fl", "ce")


def check_datetime(pa, name: str, out, want: dict) -> None:
    """Raise unless a datetime query's result equals the oracle: every
    column exact (dates as day numbers, timestamps as microseconds,
    decimals as unscaled ints) but the average, rtol 1e-12 (f64 sums in
    another order), and the functions of it, held to numpy's of the
    engine's own average: round (the JAX HALF_UP formula), floor, ceil and
    sqrt exactly, log10 within 4 ULP."""
    n = len(next(iter(want.values())))
    if out.num_rows != n:
        raise AssertionError(f"datetime {name}: {out.num_rows} rows, the "
                             f"oracle {n}")
    for col, w in want.items():
        arr = out.column(col)
        if pa.types.is_date(arr.type):
            arr = arr.cast(pa.int32())
        elif pa.types.is_timestamp(arr.type):
            arr = arr.cast(pa.int64())
        if pa.types.is_decimal(arr.type):
            got = unscaled(arr)[0].tolist()
            got = [v if ok else None
                   for v, ok in zip(got, np.asarray(arr.is_valid()))]
        else:
            got = arr.to_pylist()
        if col == "avg_price":
            ok = all((a is None) == (b is None) for a, b in zip(got, w)) \
                and np.allclose([a for a in got if a is not None],
                                [b for b in w if b is not None],
                                rtol=1e-12, atol=0)
        else:
            ok = got == w
        if not ok:
            raise AssertionError(f"datetime {name}: column {col} differs "
                                 "from the oracle")
    if name == "calendar":
        a = np.array([np.nan if v is None else v
                      for v in out.column("avg_price").to_pylist()])
        exact = {"r2": np.sign(a) * np.floor(np.abs(a) * 100 + 0.5) / 100,
                 "root": np.sqrt(a), "fl": np.floor(a), "ce": np.ceil(a)}
        for col, w in exact.items():
            got = np.array(out.column(col).to_pylist(), dtype=np.float64)
            if not np.array_equal(got, w, equal_nan=True):
                raise AssertionError(f"datetime calendar: {col} differs "
                                     "from numpy's")
        lg = np.array(out.column("lg").to_pylist(), dtype=np.float64)
        w = np.log10(a)
        if not np.all((np.abs(lg - w) <= 4 * np.spacing(np.abs(w)))
                      | (np.isnan(lg) & np.isnan(w))):
            raise AssertionError("datetime calendar: log10 past 4 ULP")


DT_EXACT = ("Sqrt", "Signum", "Rint", "ToDegrees", "ToRadians", "Floor",
            "Ceil", "Round", "BRound")
DT_ULPS = 4  # the transcendentals against numpy (glibc)


def math_on_card(torch, dev, n: int = 1 << 16, seed: int = 89) -> dict:
    """Every math function of slice 16 on the card against numpy on the
    same doubles (NaN, the infinities, both zeros, subnormals, the domain
    edges, and normal values over many magnitudes): sqrt, signum, rint,
    degrees, radians, floor, ceil, round and bround exact, the rest
    within DT_ULPS; the bitwise ops and shifts exact against numpy's
    int64. Returns each function's largest error in ULPs; raises past the
    bounds."""
    import math

    from spark_rapids_tpu_torch import expr as E
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expr.base import BoundReference, \
        EvalContext, Vec
    rng = np.random.default_rng(seed)
    special = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1.0, -1.0, 0.5,
               -0.5, 2.5, 5e-324, -2.2e-308, 1e300, 9.3e18, -1e19]
    x = rng.uniform(-1, 1, n) * 10.0 ** rng.integers(-30, 30, n)
    x[:len(special)] = special
    y = rng.permutation(x)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    ctx = EvalContext(ones)
    vecs = [Vec(T.DOUBLE, torch.from_numpy(v).to(dev), ones)
            for v in (x, y)]
    a, b = BoundReference(0, T.DOUBLE), BoundReference(1, T.DOUBLE)
    with np.errstate(all="ignore"):
        ref = {"Sqrt": np.sqrt(x), "Exp": np.exp(x),
               "Log": np.where(x > 0, np.log(x), np.nan),
               "Log10": np.where(x > 0, np.log10(x), np.nan),
               "Log2": np.where(x > 0, np.log2(x), np.nan),
               "Sin": np.sin(x), "Cos": np.cos(x), "Tan": np.tan(x),
               "Asin": np.arcsin(x), "Acos": np.arccos(x),
               "Atan": np.arctan(x), "Sinh": np.sinh(x), "Cosh": np.cosh(x),
               "Tanh": np.tanh(x), "Cbrt": np.cbrt(x),
               "ToDegrees": np.degrees(x), "ToRadians": np.radians(x),
               "Signum": np.sign(x), "Expm1": np.expm1(x),
               "Log1p": np.where(x > -1, np.log1p(x), np.nan),
               "Rint": np.rint(x), "Cot": 1.0 / np.tan(x),
               "Pow": np.power(x, y), "Atan2": np.arctan2(x, y),
               "Hypot": np.hypot(x, y),
               "Logarithm": np.where((x > 0) & (x != 1) & (y > 0),
                                     np.log(y) / np.log(x), np.nan),
               "Round": np.sign(x) * np.floor(np.abs(x) * 100 + 0.5) / 100,
               "BRound": np.round(x * 100) / 100}
    errs = {}
    for name, want in ref.items():
        args = (a, b) if name in ("Pow", "Atan2", "Hypot", "Logarithm") \
            else (a,)
        e = getattr(E, name)(*args, 2) if name in ("Round", "BRound") \
            else getattr(E, name)(*args)
        out = e.eval(ctx, vecs)
        got = np.where(out.validity.cpu().numpy(),
                       out.data.cpu().numpy(), np.nan)
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        with np.errstate(all="ignore"):
            ulp = np.abs(got - want) / np.spacing(np.abs(want))
        worst = float(np.max(np.where(same, 0.0, ulp)))
        errs[name] = worst
        if worst > (0 if name in DT_EXACT else DT_ULPS):
            raise AssertionError(f"{name} on the card is {worst} ULP from "
                                 "numpy")
    java = np.where(np.isnan(x), 0, np.clip(x, -2.0 ** 63, 2.0 ** 63))
    for name, fn in (("Floor", np.floor), ("Ceil", np.ceil)):
        out = getattr(E, name)(a).eval(ctx, vecs).data.cpu().numpy()
        with np.errstate(invalid="ignore"):
            want = np.where(fn(java) >= 2.0 ** 63, 2 ** 63 - 1,
                            fn(java).astype(np.int64))
        errs[name] = 0.0 if np.array_equal(out, want) else math.inf
        if errs[name]:
            raise AssertionError(f"{name} on the card is not Java's (long)")
    k = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    s = rng.integers(-70, 140, n).astype(np.int32)
    lv = [Vec(T.LONG, torch.from_numpy(k).to(dev), ones),
          Vec(T.INT, torch.from_numpy(s).to(dev), ones)]
    la, lb = BoundReference(0, T.LONG), BoundReference(1, T.INT)
    amt = (s & 63).astype(np.uint64)
    bits = {"ShiftLeft": (k.astype(np.uint64) << amt).view(np.int64),
            "ShiftRight": k >> amt.astype(np.int64),
            "ShiftRightUnsigned": (k.view(np.uint64) >> amt).view(np.int64),
            "BitwiseXor": k ^ s, "BitwiseAnd": k & s, "BitwiseOr": k | s}
    for name, want in bits.items():
        out = getattr(E, name)(la, lb).eval(ctx, lv).data.cpu().numpy()
        errs[name] = 0.0 if np.array_equal(out, want) else math.inf
        if errs[name]:
            raise AssertionError(f"{name} on the card differs from numpy")
    return errs


def datetime_phases(torch, pa, mesh_conf: dict, counters, data: dict,
                    conf=None, device=None, c_per_batch=DT_C_PER_BATCH,
                    rounds=DT_ROUNDS):
    """Phase datetime over agg_tables' files and the text file (`data`:
    datetime_data), dynamic pruning off, fusion on:
      1. the calendar report, 2. q96 on timestamps, 3. the hourly report
         (its cast to STRING on the host between device stages) and 4. the
         price text parsed as decimal(7,2) (the cast on the host), on one
         device and under the distributed plan, exact against
         datetime_oracle; under ANSI the parse raises
         [CAST_INVALID_INPUT];
      5. the device times of the calendar report's date parts and of
         date_format over one 1,048,576-row batch, beside their byte
         bounds.
    Every collect launches A 2 a fused join (explain tree) a merged probe
    batch and C `c_per_batch` a batch under the distributed plan. Prints
    one line a query and plan (the checked collect and `rounds` warm ones)
    and one for the expressions; returns the launches of each plan's run
    (one collect of each query)."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.errors import AnsiViolation
    from spark_rapids_tpu_torch.expr.base import BoundReference, \
        EvalContext, Vec
    from spark_rapids_tpu_torch.plugin import TpuSession, resolve_device
    dev = resolve_device(device)
    conf = dict(conf or {}, **DT_CONF)
    paths, want = data["paths"], data["oracle"]
    rate = H100_BYTES_PER_S
    m = datetime_namespace()
    t_phase = time.monotonic()

    def batches_of(name):
        rgs = pq.ParquetFile(paths[name]).metadata.num_row_groups
        return -(-rgs // CHUNKS_PER_DISPATCH)

    probe = {"calendar": batches_of("store_sales"),
             "q96": batches_of("store_sales"),
             "hourly": batches_of("store_sales"),
             "parse": batches_of("store_sales_text")}
    hosted = {"hourly": ["! CpuProjectExec <- cast timestamp -> string is "
                         "not supported on TPU"],
              "parse": ["! CpuProjectExec <- cast string -> decimal(7,2) "
                        "is not supported on TPU"]}

    def launched():
        return {k.__name__: k.launches for k in counters}

    def collect(q):
        torch.cuda.synchronize()
        for k in counters:
            k.launches = 0
        t0 = time.perf_counter()
        out = q.collect()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, launched()

    launches = {}
    for plan, extra in (("one_device", {}), ("distributed", mesh_conf)):
        sess = TpuSession(dict(conf, **extra), dev)
        qs = datetime_queries(sess, m, paths)
        run = {}
        for n in ("calendar", "q96", "hourly", "parse"):
            shape = qs[n].explain()
            out, wall, run[n] = collect(qs[n])
            check_datetime(pa, n, out, want[n])
            a = 2 * fused_joins(shape) * probe[n]
            c = c_per_batch[n] * probe[n] if plan == "distributed" else 0
            if (run[n]["murmur3_rows"], run[n]["segment_sum_i64"]) != (a, c):
                raise AssertionError(f"datetime {n} ({plan}) launched "
                                     f"{run[n]}, not A {a} and C {c}")
            bangs = fallback_lines(sess, qs[n], dev)
            if bangs != hosted.get(n, []):
                raise AssertionError(f"datetime {n} ({plan}): {bangs}")
            # the parse is host-bound (4-5 s a collect): its checked
            # collect only
            warm = [collect(qs[n])[1]
                    for _ in range(0 if n == "parse" else rounds)]
            emit({"phase": "datetime", "query": n, "plan": plan,
                  "rows": out.num_rows, "collect_s": wall,
                  "warm_collect_s": warm, "launches": run[n],
                  "fused_joins": fused_joins(shape),
                  "probe_batches": probe[n], "host_nodes": bangs,
                  "exchanges": shape.count("TpuShuffleExchangeExec")})
        launches["datetime" if plan == "one_device" else
                 "datetime_distributed"] = {
            k: sum(r[k] for r in run.values()) for k in run["calendar"]}
        asess = TpuSession(dict(conf, **extra, **ANSI_CONF), dev)
        try:
            datetime_queries(asess, m, paths)["parse"].collect()
        except AnsiViolation as e:
            message = str(e)
        else:
            raise AssertionError(f"datetime parse ({plan}) did not raise "
                                 "under ANSI")
        if message != ("[CAST_INVALID_INPUT] value cannot be cast to "
                       "decimal(7,2)"):
            raise AssertionError(f"datetime ANSI: {message!r}")
        emit({"phase": "datetime", "query": "parse_ansi", "plan": plan,
              "raised": message})
    # device times over one row group of sold dates, beside byte bounds
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    first = pq.ParquetFile(paths["date_dim"]).read(columns=["d_date"])
    dates = np.asarray(first.column("d_date").cast(pa.int32()))
    sold = pa.table({"d": pa.array(np.resize(dates, ARROW_BATCH_ROWS),
                                   pa.date32())})
    day = Vec.from_column(batch_from_arrow(sold, dev).columns[0])
    ctx = EvalContext(torch.ones(day.validity.shape[0], dtype=torch.bool,
                                 device=dev))
    ref = BoundReference(0, T.DATE)
    exprs = {"year": m.Year(ref), "weekofyear": m.WeekOfYear(ref),
             "dayofweek": m.DayOfWeek(ref), "dayname": m.DayName(ref),
             "date_format": m.DateFormat(m.TruncDate(ref, "MONTH"),
                                         "yyyy-MM")}

    def nbytes(*ts):
        return sum(x.numel() * x.element_size() for x in ts)

    times = {}
    for name, e in exprs.items():
        res = e.eval(ctx, [day])
        moved = nbytes(day.data, day.validity, res.data, res.validity) + (
            0 if res.lengths is None else nbytes(res.lengths))
        times[name] = {"ms": time_ms(torch, lambda e=e: e.eval(ctx, [day]),
                                     rounds=5, calls=5),
                       "bound_ms": moved / rate * 1e3,
                       "rows": int(day.data.shape[0])}
    ulps = math_on_card(torch, dev)
    emit({"phase": "datetime", "check": "expressions", "device_ms": times,
          "math_ulps_against_numpy": ulps,
          "calendar_groups": want["calendar_groups"],
          "parse_malformed": want["parse_malformed"],
          "seconds": time.monotonic() - t_phase})
    return launches


DATA_SETS = ("star", "decimal", "joins", "aggs")


def prepared(kind: str, d: str) -> dict:
    """One of the run's DATA_SETS, made in a worker process, its files in
    directory d: "star" (star_data), "decimal" (star_decimal_data),
    "joins" (join_data) or "aggs" (agg_data). The star tables go to Arrow
    IPC files named under "arrow" (a result crosses to the run's process
    through a pipe, and reading gigabytes there holds up its main thread:
    read them with loaded); the joins' and aggregates' tables, which their
    phases do not read, are dropped."""
    import pyarrow as pa
    data = star_data(pa) if kind == "star" else {
        "decimal": star_decimal_data, "joins": join_data,
        "aggs": agg_data}[kind](pa, d)
    tables = data.pop("tables")
    if kind in ("star", "decimal"):
        data["arrow"] = {}
        for name, t in tables.items():
            path = os.path.join(d, f"{name}.arrow")
            with pa.OSFile(path, "wb") as f, \
                    pa.ipc.new_file(f, t.schema) as w:
                w.write_table(t)
            data["arrow"][name] = path
    return data


def loaded(future) -> dict:
    """A data set from start_data, with its star tables read back."""
    import pyarrow as pa
    data = future.result()
    if "arrow" in data:
        data["tables"] = {n: pa.ipc.open_file(pa.OSFile(p)).read_all()
                          for n, p in data.pop("arrow").items()}
    return data


def start_data(stack: contextlib.ExitStack) -> dict:
    """Start making DATA_SETS in two worker processes at a lower priority
    (numpy and pyarrow on the host, no card), in the order the phases need
    them, while the card runs the phases before them; their files go to
    temporary directories. `stack` removes the directories and stops the
    workers (queued sets cancelled) when it closes. Returns {set:
    future}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    dirs = {k: stack.enter_context(tempfile.TemporaryDirectory(
        prefix=f"chip_smoke_{k}_")) for k in DATA_SETS}
    pool = stack.enter_context(ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"),
        initializer=os.nice, initargs=(10,)))
    stack.callback(pool.shutdown, cancel_futures=True)
    return {k: pool.submit(prepared, k, dirs[k]) for k in DATA_SETS}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import pyarrow  # noqa: F401

        import spark_rapids_tpu_torch.plugin  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}",
              file=sys.stderr)
        return 2
    with contextlib.ExitStack() as stack:
        return run_phases(torch, start_data(stack))


def run_phases(torch, ready: dict) -> int:
    """Every phase, in order; `ready` holds start_data's futures. Returns
    0, or raises at the first failure."""
    import pyarrow as pa

    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exec import exchange
    from spark_rapids_tpu_torch.exec.base import batch_vecs
    from spark_rapids_tpu_torch.exec.basic import TpuFilterExec, TpuScanExec
    from spark_rapids_tpu_torch.exec.joins import _probe_counts
    from spark_rapids_tpu_torch.expr import col
    from spark_rapids_tpu_torch.memory import catalog as spills
    from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops.pallas_probe import (
        candidate_counts, murmur3_rows, murmur3_rows_plain)
    from spark_rapids_tpu_torch.ops.pallas_groupby import (
        segment_sum_i64, segment_sum_i64_plain)
    from spark_rapids_tpu_torch.ops.pallas_segsum import (
        MAX_SEGMENTS, segment_sum_f64, segment_sum_f64_plain)
    from spark_rapids_tpu_torch.plugin import TpuSession

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    rate = hbm_rate(kind)

    # ---- 0. build every kernel of the path from the checkout's sources
    t0 = time.monotonic()
    spills.COUNTERS.reset()  # no phase before `memory` may spill
    logs = cuda_build.build()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "compiled": sorted(logs), "sources": list(cuda_build.SOURCES)})

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. kernel A (murmur3_rows) against its plain twin
    gen = np.random.default_rng(7)
    n = 1 << 20
    a_err = 0
    for dt, lo, hi in ((torch.int32, -2 ** 31, 2 ** 31),
                       (torch.int64, -2 ** 63, 2 ** 63 - 1)):
        keys = torch.from_numpy(gen.integers(lo, hi, n, dtype=np.int64)
                                ).to(dt).to(dev)
        valid = torch.from_numpy(gen.random(n) > 0.1).to(dev)
        seed = torch.from_numpy(gen.integers(-2 ** 31, 2 ** 31, n)
                                .astype(np.int32)).to(dev)
        got = murmur3_rows(keys, valid, seed)
        want = murmur3_rows_plain(keys, valid, seed)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if err != 0:
            raise AssertionError(f"murmur3_rows differs from its plain twin "
                                 f"on {dt} keys by up to {err}")
        a_err = max(a_err, err)
    fact, dim = query_tables(pa, QUERY_FACT_ROWS, N_DIM, KEY_SPACE, N_GROUPS)
    probe = TpuFilterExec(col("v") > 0.6, TpuScanExec(fact, dev)).filter(
        batch_from_arrow(fact.slice(0, 1 << 20), dev))[0]
    build = batch_from_arrow(dim, dev)
    pk, bk = [batch_vecs(probe)[0]], [batch_vecs(build)[0]]
    counts_k = candidate_counts(pk, bk, probe.row_mask(), build.row_mask())
    counts_p = _probe_counts(probe, build, (0,), (0,))[0]
    if not torch.equal(counts_k, counts_p):
        raise AssertionError("candidate_counts differs from _probe_counts")
    # timing at the main path's probe shape: an int64 key column of one
    # batch (capacity 1,048,576) hashed from the initial seed
    seed42 = torch.full((probe.capacity,), 42, dtype=torch.int32, device=dev)
    pkey = pk[0]
    a_ms = time_ms(torch, lambda: murmur3_rows(pkey.data, pkey.validity,
                                               seed42))
    a_plain = time_ms(torch, lambda: murmur3_rows_plain(
        pkey.data, pkey.validity, seed42))
    a_bound = probe.capacity * (8 + 1 + 4 + 4) / rate * 1e3
    emit({"phase": "kernel_murmur3_rows", "max_abs_err_int32_int64": a_err,
          "candidate_counts_exact": True, "rows": probe.capacity,
          "live_probe_rows": probe.row_count(), "ms": a_ms,
          "plain_ms": a_plain, "bound_ms": a_bound})

    # ---- 3. kernel B (segment_sum_f64) against its plain twin and numpy,
    # at the bench step's shape and at the seams of its row split
    nb, g = N_FACT, N_GROUPS
    vals_np, ids_np = segsum_inputs(gen, nb, g)
    vals = torch.from_numpy(vals_np).to(dev)
    ids = torch.from_numpy(ids_np).to(dev)
    b_err = 0.0

    def check_b(case, v, i, gg):
        """B on one input, twice: bit-identical, and within 1e-9 x each
        segment's L1 mass of numpy and of the plain twin (a non-finite sum
        must be the same non-finite value). Returns B's result."""
        nonlocal b_err
        v = torch.as_tensor(v, dtype=torch.float64).to(dev)
        i = torch.as_tensor(i).to(dev)
        got = segment_sum_f64(v, i, gg)
        again = segment_sum_f64(v, i, gg)
        plain = segment_sum_f64_plain(v, i, gg)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int64), again.view(torch.int64)):
            raise AssertionError(f"segment_sum_f64 is not bit-identical on "
                                 f"repeat ({case})")
        v_np, i_np = v.cpu().numpy(), i.cpu().numpy()
        keep = (i_np >= 0) & (i_np < gg)
        exact = np.bincount(i_np[keep], weights=v_np[keep], minlength=gg)
        mass = np.bincount(i_np[keep], weights=np.abs(v_np[keep]),
                           minlength=gg)
        got = got.cpu().numpy()
        for ref, what in ((exact, "numpy"), (plain.cpu().numpy(), "twin")):
            fin = np.isfinite(ref)
            with np.errstate(invalid="ignore"):  # inf - inf where not fin
                diff = np.abs(got - ref)
            ok = np.where(fin, diff <= 1e-9 * mass,
                          (got == ref) | (np.isnan(got) & np.isnan(ref)))
            if not ok.all():
                raise AssertionError(
                    f"segment_sum_f64 ({case}) differs from {what} beyond "
                    f"1e-9 x L1 mass in {int((~ok).sum())} segments")
            if what == "twin" and fin.any():
                b_err = max(b_err, float(diff[fin].max()))
        return got

    check_b("bench_shape", vals, ids, g)
    n_odd = nb + 7
    odd_v, odd_i = segsum_inputs(gen, n_odd, g)
    signed = gen.normal(0, 100, 100_000)
    signed[gen.random(100_000) < 0.2] = -0.0
    signed_ids = gen.integers(0, 64, 100_000).astype(np.int32)
    signed_ids[:6] = [3, 5, 7, 7, 9, 9]
    signed[:6] = [np.inf, -np.inf, np.inf, -np.inf, -0.0, -0.0]
    signed[signed_ids == 9] = -0.0  # segment 9 holds -0.0 alone
    ids64 = gen.integers(-2 ** 40, 2 ** 40, nb)
    ids64[::3] = gen.integers(0, g, len(ids64[::3]))
    ids64[:4] = [2 ** 31, 2 ** 32 + 2, -1, g]
    seams = {
        "g_1": (vals, torch.zeros_like(ids), 1),
        "g_4096": (vals, torch.from_numpy(
            gen.integers(0, MAX_SEGMENTS, nb).astype(np.int32)),
            MAX_SEGMENTS),
        f"n_{n_odd}": (odd_v, odd_i, g),
        "all_rows_one_id": (vals, torch.full_like(ids, 517), g),
        "sorted_ids": (vals, torch.sort(ids).values, g),
        "int64_ids": (vals, torch.from_numpy(ids64), g),
        "signed_zero_inf": (signed, signed_ids, 64),
        "unaligned_view": (vals[1:], ids[1:], g),
    }
    for n_small in (1, 2, 3, 63, 65, 255, 257):
        seams[f"n_{n_small}"] = (odd_v[:n_small], odd_i[:n_small], g)
    seam_out = {case: check_b(case, v, i, gg)
                for case, (v, i, gg) in seams.items()}
    zeros_out = seam_out["signed_zero_inf"]

    def seg(v, i, gg):
        return check_b("small", np.array(v, np.float64), np.array(i),
                       gg).tolist()

    edge = {
        "beyond_f32": seg([1e300, 1.0, 2.0, 3.0], [0, 1, 1, 2], 4)
        == [1e300, 3.0, 3.0, 0.0],
        "ids_out_of_range": seg([1.0, 2.0, 99.0, 77.0], [0, 1, -1, 5], 4)
        == [1.0, 2.0, 0.0, 0.0],
        "int64_ids_beyond_int32": seg([5.0, 1.0], [2 ** 32 + 2, 0], 4)
        == [1.0, 0.0, 0.0, 0.0],
        "inf_and_nan_sums": bool(zeros_out[3] == np.inf
                                 and zeros_out[5] == -np.inf
                                 and np.isnan(zeros_out[7])
                                 and zeros_out[9] == 0.0),
    }
    nan_out = seg([float("nan"), 1.0, 2.0], [0, 1, 2], 3)
    edge["nan_confined"] = bool(np.isnan(nan_out[0])) and \
        nan_out[1:] == [1.0, 2.0]
    try:
        segment_sum_f64(vals[:8], ids[:8], MAX_SEGMENTS + 1)
        edge["rejects_oversized"] = False
    except ValueError:
        edge["rejects_oversized"] = True
    if not all(edge.values()):
        raise AssertionError(f"segment_sum_f64 edge cases failed: {edge}")
    # timing at the bench step's shape: warm (back to back on one input)
    # and cold (over 4 copies, 201 MB, 4x the L2 cache, in turns)
    b_copies = [(vals, ids, g)] + [
        tuple(torch.from_numpy(a).to(dev) for a in segsum_inputs(gen, nb, g))
        + (g,) for _ in range(3)]
    b_cold = rotating(segment_sum_f64, b_copies)
    b_ms = time_ms(torch, lambda: segment_sum_f64(vals, ids, g))
    b_cold_ms = time_ms(torch, b_cold)
    b_split = cuda_kernel_ms(torch, b_cold)
    b_plain = time_ms(torch, lambda: segment_sum_f64_plain(vals, ids, g))
    ids64 = ids.to(torch.int64)
    b_lib = time_ms(torch, lambda: torch.zeros(
        g, dtype=torch.float64, device=dev).index_add_(0, ids64, vals))
    b_bound = (nb * (8 + 4) + g * 8) / rate * 1e3
    del b_copies, b_cold
    emit({"phase": "kernel_segment_sum_f64", "rows": nb, "groups": g,
          "repeat_bit_identical": True, "max_abs_err_vs_plain": b_err,
          "seams": sorted(seams), "edge_cases": edge, "ms": b_ms,
          "cold_ms": b_cold_ms, "cuda_kernels_cold_ms": b_split,
          "plain_ms": b_plain, "library_ms": b_lib, "bound_ms": b_bound,
          "bound_share": b_bound / b_cold_ms})

    # ---- 4. the engine query through a session, fusion on, on the card;
    # the join is sized through kernel A (pallas.mode auto) and through its
    # plain twin (off), timed in turns
    want = query_oracle(fact, dim)

    dfs = {}
    for mode in ("auto", "off"):
        sess = TpuSession({"spark.rapids.tpu.fusion.enabled": True,
                           "spark.rapids.tpu.fusion.pallas.mode": mode})
        if sess.device.type != "cuda":
            raise AssertionError(f"session resolved to {sess.device}")
        dfs[mode] = main_query(sess, fact, dim)
        plan = dfs[mode].explain()
        if "TpuFusedStageExec" not in plan:
            raise AssertionError(f"filter and probe did not fuse:\n{plan}")
        # warm-up
        check_query(dfs[mode].collect(), want, f"pallas.mode={mode}")
    walls = {"auto": [], "off": []}
    counts = {"auto": set(), "off": set()}
    for i in range(WALL_ROUNDS):
        for mode in ("auto", "off") if i % 2 == 0 else ("off", "auto"):
            torch.cuda.synchronize()
            murmur3_rows.launches = segment_sum_f64.launches = 0
            t0 = time.perf_counter()
            out = dfs[mode].collect()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            counts[mode].add((murmur3_rows.launches,
                              segment_sum_f64.launches))
            check_query(out, want, f"pallas.mode={mode}")
    if len(counts["auto"]) != 1 or min(counts["auto"])[0] == 0:
        raise AssertionError(f"the fused query launched murmur3_rows "
                             f"{sorted(counts['auto'])} times per collect")
    if counts["off"] != {(0, 0)}:
        raise AssertionError(f"pallas.mode=off launched kernels "
                             f"{sorted(counts['off'])}")
    (a_launches, b_query_launches), = counts["auto"]
    launches = {"murmur3_rows": a_launches,
                "segment_sum_f64": b_query_launches}
    emit({"phase": "engine_query", "fact_rows": QUERY_FACT_ROWS,
          "dim_rows": N_DIM, "groups": int(len(want[0])),
          "matched_rows": int(want[2].sum()), "exact": True,
          "warm_collect_s": spread(walls["auto"]),
          "warm_collect_s_plain_sizing": spread(walls["off"]),
          "pairs_auto_faster": sum(a < o for a, o in zip(walls["auto"],
                                                         walls["off"])),
          "launches_per_collect": launches})

    # ---- 5. the bench step at bench.py's shapes
    step_ms, bench_counts, rows = bench_step_runs(
        torch, dev, (murmur3_rows, segment_sum_f64))
    if bench_counts != {(0, K_STEPS)}:
        raise AssertionError(f"bench step launches {sorted(bench_counts)}")
    bench_launches = {"murmur3_rows": 0, "segment_sum_f64": K_STEPS}
    emit({"phase": "bench_step", "fact_rows": N_FACT, "k_steps": K_STEPS,
          "step_ms": spread(step_ms), "matched_rows": rows,
          "rtol": 1e-9, "repeat_bit_identical": True,
          "launches_per_call": bench_launches})

    # ---- 6. kernel C (segment_sum_i64) against its plain twin, bit for bit
    cap = 1 << 20
    vals_np, ids_np = segsum_path_inputs(fact, dim, cap)
    c_vals = torch.from_numpy(vals_np).to(dev)
    c_ids = torch.from_numpy(ids_np).to(dev)
    c_cases = {
        "path": (c_vals, c_ids, cap),
        "unsorted_g1024": (
            torch.from_numpy(gen.integers(-2 ** 62, 2 ** 62, cap)).to(dev),
            torch.from_numpy(gen.integers(0, N_GROUPS, cap).astype(np.int32)
                             ).to(dev), N_GROUPS),
    }
    c_err = 0.0

    for name, (v, i, gg) in c_cases.items():
        got = segment_sum_i64(v, i, gg)
        again = segment_sum_i64(v, i, gg)
        plain = segment_sum_i64_plain(v, i, gg)
        torch.cuda.synchronize()
        err = i64_err(torch, got, plain)
        if err != 0:
            raise AssertionError(f"segment_sum_i64 differs from its plain "
                                 f"twin ({name}) by up to {err}")
        c_err = max(c_err, err)
        if not torch.equal(got, again):
            raise AssertionError(f"segment_sum_i64 is not bit-identical on "
                                 f"repeat ({name})")

    def seg64(v, i, gg):
        nonlocal c_err
        v = torch.tensor(v, dtype=torch.int64, device=dev)
        i = torch.as_tensor(i, device=dev)
        got = segment_sum_i64(v, i, gg)
        err = i64_err(torch, got, segment_sum_i64_plain(v, i, gg))
        if err != 0:
            raise AssertionError("segment_sum_i64 differs from its plain twin "
                                 f"on an edge case by up to {err}: "
                                 f"{got.tolist()}")
        c_err = max(c_err, err)
        return got.tolist()

    rand = gen.integers(-2 ** 40, 2 ** 40, 200_000)
    rand_ids = gen.integers(-3, 4_100, 200_000)
    ok = (rand_ids >= 0) & (rand_ids < 4_097)
    want_4097 = np.zeros(4_097, np.int64)
    np.add.at(want_4097, rand_ids[ok], rand[ok])
    c_edge = {
        "wrap_past_2_63": seg64([2 ** 62, 2 ** 62, 2 ** 62, 5], [0, 0, 0, 1],
                                2) == [-(2 ** 62), 5],
        "ids_out_of_range": seg64([1, 2, 99, 77], [0, 1, -1, 5], 4)
        == [1, 2, 0, 0],
        "int64_id_2_32_plus_2": seg64(
            [5, 1], torch.tensor([2 ** 32 + 2, 0], dtype=torch.int64), 4)
        == [1, 0, 0, 0],
        "n_0": seg64([], torch.zeros(0, dtype=torch.int32), 3) == [0, 0, 0],
        "g_1": seg64([3, -7, 11], [0, 0, 0], 1) == [7],
        "g_4097": seg64(rand.tolist(), rand_ids, 4_097) == want_4097.tolist(),
    }
    if not all(c_edge.values()):
        raise AssertionError(f"segment_sum_i64 edge cases failed: {c_edge}")
    c_ids64 = c_ids.to(torch.int64)
    c_ms = time_ms(torch, lambda: segment_sum_i64(c_vals, c_ids, cap))
    c_plain = time_ms(torch, lambda: segment_sum_i64_plain(c_vals, c_ids, cap))
    c_lib = time_ms(torch, lambda: torch.zeros(
        cap, dtype=torch.int64, device=dev).index_add_(0, c_ids64, c_vals))
    c_bound = (cap * (8 + 4) + cap * 8) / rate * 1e3
    emit({"phase": "kernel_segment_sum_i64", "rows": cap, "groups": cap,
          "live_rows": int((ids_np < cap - 1).sum()),
          "live_groups": int(ids_np[ids_np < cap - 1].max()) + 1,
          "max_abs_err_vs_plain": c_err, "repeat_bit_identical": True,
          "edge_cases": c_edge, "ms": c_ms, "plain_ms": c_plain,
          "library_ms": c_lib, "bound_ms": c_bound})

    # ---- 7. the engine query under the distributed plan: fused [filter,
    # broadcast probe, partial aggregate] -> key exchange over the mesh ->
    # per-shard final aggregate, with pallas.mode auto and off in turns
    mesh_conf = {"spark.rapids.shuffle.mode": "ICI",
                 "spark.rapids.tpu.mesh.shape": f"shuffle={MESH_POSITIONS}",
                 "spark.rapids.tpu.fusion.enabled": True}
    ddfs = {}
    for mode in ("auto", "off"):
        sess = TpuSession(dict(mesh_conf, **{
            "spark.rapids.tpu.fusion.pallas.mode": mode}))
        ddfs[mode] = main_query(sess, fact, dim)
        plan = ddfs[mode].explain()
        fused = [ln for ln in plan.splitlines() if "TpuFusedStageExec" in ln]
        if not (fused and "PartialAgg[" in fused[0]
                and "TpuShuffleExchangeExec" in plan
                and plan.startswith("TpuHashAggregateExec[final")):
            raise AssertionError(f"not the distributed plan:\n{plan}")
        # warm-up
        check_query(ddfs[mode].collect(), want, f"pallas.mode={mode}")
    dwalls = {"auto": [], "off": []}
    dcounts = {"auto": set(), "off": set()}
    for i in range(WALL_ROUNDS):
        for mode in ("auto", "off") if i % 2 == 0 else ("off", "auto"):
            torch.cuda.synchronize()
            murmur3_rows.launches = segment_sum_f64.launches = 0
            segment_sum_i64.launches = 0
            before = exchange.MESH_EXCHANGES
            t0 = time.perf_counter()
            out = ddfs[mode].collect()
            torch.cuda.synchronize()
            dwalls[mode].append(time.perf_counter() - t0)
            if exchange.MESH_EXCHANGES <= before:
                raise AssertionError("a distributed collect ran no mesh "
                                     "exchange")
            dcounts[mode].add((segment_sum_i64.launches,
                               murmur3_rows.launches,
                               segment_sum_f64.launches))
            check_query(out, want, f"pallas.mode={mode}")
    if len(dcounts["auto"]) != 1 or 0 in min(dcounts["auto"])[:2]:
        raise AssertionError(f"the distributed query launched (C, A, B) "
                             f"{sorted(dcounts['auto'])} times per collect")
    if dcounts["off"] != {(0, 0, 0)}:
        raise AssertionError(f"pallas.mode=off launched kernels "
                             f"{sorted(dcounts['off'])}")
    (c_launches, a_dist_launches, _), = dcounts["auto"]
    emit({"phase": "distributed_query", "fact_rows": QUERY_FACT_ROWS,
          "dim_rows": N_DIM, "groups": int(len(want[0])),
          "mesh_positions": MESH_POSITIONS,
          "cuda_devices": torch.cuda.device_count(), "exact": True,
          "warm_collect_s": spread(dwalls["auto"]),
          "warm_collect_s_plain": spread(dwalls["off"]),
          "pairs_auto_faster": sum(a < o for a, o in zip(dwalls["auto"],
                                                         dwalls["off"])),
          "launches_per_collect": {"segment_sum_i64": c_launches,
                                   "murmur3_rows": a_dist_launches}})

    # ---- 8, 9. the star-schema reports, one device and distributed
    star = loaded(ready.pop("star"))
    star_launches, dstar_launches, a_args, c_args = star_phases(
        torch, pa, mesh_conf, (murmur3_rows, segment_sum_f64, segment_sum_i64),
        data=star)

    # ---- parquet_decode, parquet_query, parquet_star_q7: the parquet scan
    pq_launches, pq_a_args, pq_c_args = parquet_phases(
        torch, pa, mesh_conf, (murmur3_rows, segment_sum_f64, segment_sum_i64),
        fact, dim, star=star)
    del star

    # ---- star_decimal: the star reports over decimal(7,2) money columns
    # from parquet, one device and distributed; then ordered_reports over
    # the same files: their ORDER BY ... LIMIT 100, Q36's rank, a running
    # window and an out-of-core sort
    kernels3 = (murmur3_rows, segment_sum_f64, segment_sum_i64)
    dec_data = loaded(ready.pop("decimal"))
    dec_launches, dec_a_args, dec_c_args = star_decimal_phases(
        torch, pa, mesh_conf, kernels3, data=dec_data)
    ord_launches, ord_a_args, ord_c_args = ordered_phases(
        torch, pa, mesh_conf, kernels3, data=dec_data)
    # ---- parquet_files: the same store_sales in seven file forms (zstd,
    # gzip, per-column host decodes, v2 pages, lz4, 64 files under each
    # reader strategy, filters=), Q3 and Q7
    files_launches, files_a_args, files_c_args = files_phases(
        torch, pa, mesh_conf, kernels3, dec_data)
    dec_files = {k: dec_data[k] for k in ("oracle", "paths")}
    del dec_data

    # ---- tpcds_joins: q97 (full outer join, the sub-partition join), q10
    # (existence joins), q58 (string keys with conditions) and q28 (cross
    # joins) over TPC-DS tables from parquet, one device and distributed
    join_data = loaded(ready.pop("joins"))
    join_launches, join_a_args, join_c_args = joins_phases(
        torch, pa, mesh_conf, kernels3, data=join_data)

    # ---- tpcds_aggregates: q65 (an average of revenue sums, 128-bit
    # partial sums), q39a/q39b (stddev_samp over inventory) and the
    # decimal(38,18) report from parquet, one device and distributed; the
    # decimal(38,18) decode; every aggregate of slice 9 on the card and the
    # CPU
    agg_data = loaded(ready.pop("aggs"))
    agg_launches, agg_a_args, agg_c_args = aggregates_phases(
        torch, pa, mesh_conf, kernels3, data=agg_data)

    # ---- ansi: the decimal star, q65, q39a and q58 under ANSI mode, exact
    # and launching A and C as without it; three queries that must raise
    # Spark's errors on both plans, their guarded twins exact; Queue C1's
    # conversions on the card against the CPU
    _, ansi_launches = ansi_phases(torch, pa, mesh_conf, kernels3,
                                   dec=dec_files, joins=join_data,
                                   aggs=agg_data)
    strings_in = agg_data["strings"]
    strings_ext_in = agg_data["strings_ext"]
    datetime_in = agg_data["datetime"]
    del agg_data

    # ---- memory: at the session's budget no phase above spilled; the
    # catalog with each codec on 1 GiB, then the running window, the
    # out-of-core sort, q97 and the distributed engine query at tight
    # budgets (host and disk spills), and injected OOMs
    earlier = spills.COUNTERS.snapshot()
    if earlier["to_host"] or earlier["unspills"]:
        raise AssertionError(f"the phases before memory spilled at the "
                             f"session's budget: {earlier}")
    emit({"phase": "memory", "check": "session_budget",
          "budget_bytes": DeviceManager.budget_bytes,
          "device_total_bytes": DeviceManager.hbm_total,
          "nvidia_smi": smi, "spills_before": earlier})
    _, memory_launches = memory_phases(torch, pa, mesh_conf, kernels3,
                                       dec=dec_files, joins=join_data,
                                       fact=fact, dim=dim)
    # ---- plan_nodes: q28 with its predicates pushed into the parquet
    # decode beside its unpushed twin, an aggregate-only report pushed
    # whole, a year's window of the date-sorted sales pruned by the
    # footer, a sample, a range and the cost-based optimizer, both plans
    plan_launches = plan_nodes_phases(torch, pa, mesh_conf, kernels3,
                                      join_data["plan_nodes"], join_data,
                                      dec_files, fact, dim)
    del join_data

    # ---- cpu_engine: decimal star Q7 with every parquet scan on the host,
    # ordered Q7 with a host cast between device stages, and the engine
    # query with spark.rapids.sql.enabled=false
    _, cpu_launches = cpu_engine_phases(torch, pa, mesh_conf, kernels3,
                                        dec=dec_files, fact=fact, dim=dim)
    del dec_files

    # ---- strings: q23's frequent items, a text report and LIKE/RLIKE over
    # item's descriptions on both plans, and the long-string layout at
    # headWidth=64 (a month of sales carrying the descriptions, q23's host
    # rerun, the exchange's tail-byte plane)
    strings_launches = strings_phases(torch, pa, mesh_conf, kernels3,
                                      strings_in)

    # ---- strings_ext: q21 with its dates cast from strings, a formatted
    # store report (a double cast to STRING on the host) and a parse of
    # sales staged as text (under ANSI the malformed rows raise), both
    # plans
    ext_launches = strings_ext_phases(torch, pa, mesh_conf, kernels3,
                                      strings_ext_in)

    # ---- datetime: a calendar report, q96 on timestamps, an hourly report
    # with a TIMESTAMP -> STRING cast on the host and the price text parsed
    # as decimal(7,2) on the host (under ANSI it raises), both plans
    dt_launches = datetime_phases(torch, pa, mesh_conf, kernels3,
                                  datetime_in)

    # ---- 10. A and C on the inputs their paths gave them, bit for bit
    # against their twins and timed there: A on the first fused probe's keys
    # of a one-device Q7 collect, from Arrow tables and from parquet (a
    # merged batch of 4 row groups, and a row group pyarrow decoded); C on
    # the first fused partial count of a distributed Q7 collect and the
    # first fused partial aggregate of a distributed parquet query without
    # pruning
    a_on = {"star_query": murmur3_on_path(
                torch, a_args, rate, path="star_query", query="q7"),
            "parquet_star_q7": murmur3_on_path(
                torch, pq_a_args, rate, path="parquet_star_q7", query="q7"),
            "star_decimal": murmur3_on_path(
                torch, dec_a_args, rate, path="star_decimal", query="q7"),
            "ordered_reports": murmur3_on_path(
                torch, ord_a_args, rate, path="ordered_reports",
                query="q7"),
            "tpcds_joins": murmur3_on_path(
                torch, join_a_args, rate, path="tpcds_joins", query="q97"),
            "tpcds_aggregates": murmur3_on_path(
                torch, agg_a_args, rate, path="tpcds_aggregates",
                query="q39a"),
            "parquet_files_v2_pages": murmur3_on_path(
                torch, files_a_args, rate, path="parquet_files_v2_pages",
                query="q7")}
    c_on = {"star_query_distributed": segsum_i64_on_path(
                torch, c_args, rate, path="star_query_distributed",
                query="q7"),
            "parquet_query_distributed_no_dpp": segsum_i64_on_path(
                torch, pq_c_args, rate,
                path="parquet_query_distributed_no_dpp", query="engine"),
            "star_decimal_distributed": segsum_i64_on_path(
                torch, dec_c_args, rate, path="star_decimal_distributed",
                query="q3"),
            "ordered_reports_distributed": segsum_i64_on_path(
                torch, ord_c_args, rate, path="ordered_reports_distributed",
                query="q3"),
            "tpcds_joins_distributed": segsum_i64_on_path(
                torch, join_c_args, rate, path="tpcds_joins_distributed",
                query="q58"),
            "tpcds_aggregates_distributed": segsum_i64_on_path(
                torch, agg_c_args, rate,
                path="tpcds_aggregates_distributed", query="q39a"),
            "parquet_files_per_column_distributed": segsum_i64_on_path(
                torch, files_c_args, rate,
                path="parquet_files_per_column_distributed", query="q7")}
    a_err = max([a_err] + [r["max_abs_err"] for r in a_on.values()])
    c_err = max([c_err] + [r["max_abs_err"] for r in c_on.values()])
    emit({"phase": "kernels_on_paths", "murmur3_rows": a_on,
          "segment_sum_i64": c_on})

    def on_path(name, measured):
        """A kernel's launches on each path's run, with its times on the
        inputs of the paths where they were taken."""
        runs = dict({"star_query": star_launches[name],
                     "star_query_distributed": dstar_launches[name]},
                    **{p: n[name] for p, n in pq_launches.items()},
                    **{p: n[name] for p, n in dec_launches.items()},
                    **{p: n[name] for p, n in ord_launches.items()},
                    **{p: n[name] for p, n in join_launches.items()},
                    **{p: n[name] for p, n in agg_launches.items()},
                    **{p: n[name] for p, n in files_launches.items()},
                    **{p: n[name] for p, n in ansi_launches.items()},
                    **{p: n[name] for p, n in memory_launches.items()},
                    **{p: n[name] for p, n in plan_launches.items()},
                    **{p: n[name] for p, n in cpu_launches.items()},
                    **{p: n[name] for p, n in strings_launches.items()},
                    **{p: n[name] for p, n in ext_launches.items()},
                    **{p: n[name] for p, n in dt_launches.items()})
        keys = ("rows", "ms", "plain_ms", "bound_ms", "library_ms",
                "max_abs_err")
        return {p: dict({"launches": n},
                        **{k: measured[p][k] for k in keys
                           if k in measured.get(p, {})})
                for p, n in runs.items()}

    # ---- 11. every kernel the run launched. A's and C's rows name the
    # TPC-DS aggregates' paths (slice 9's) whose launches and inputs they
    # give; by_path holds every path's launches (one run of it: one collect
    # of each star query, one collect of each parquet query, one
    # distributed Q7 collect, one collect of each decimal, ordered, join
    # and aggregate query) and, where measured, the times on that path's
    # inputs
    a_main = a_on["tpcds_aggregates"]
    c_main = c_on["tpcds_aggregates_distributed"]
    emit({"kernels": [
        {"name": "murmur3_rows", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/murmur3_rows.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_probe.py:152",
         "path": "tpcds_aggregates",
         "launches": agg_launches["tpcds_aggregates"]["murmur3_rows"],
         "rows": a_main["rows"], "by_path": on_path("murmur3_rows", a_on),
         "max_abs_err": a_err, "ms": a_main["ms"],
         "plain_ms": a_main["plain_ms"], "bound_ms": a_main["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "segment_sum_f64", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/segment_sum_f64.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_segsum.py:162",
         "path": "bench_step",
         "launches": bench_launches["segment_sum_f64"],
         "cuda_kernels_per_launch": 2,
         "max_abs_err": b_err, "ms": b_ms, "cold_ms": b_cold_ms,
         "bound_share": b_bound / b_cold_ms,
         "cuda_kernels_cold_ms": b_split, "plain_ms": b_plain,
         "bound_ms": b_bound, "bound_by": "bytes", "library_ms": b_lib},
        {"name": "segment_sum_i64", "route": "cuda",
         "source": "spark_rapids_tpu_torch/csrc/segment_sum_i64.cu",
         "replaces": "spark_rapids_tpu/ops/pallas_groupby.py:140",
         "path": "tpcds_aggregates_distributed",
         "launches": agg_launches["tpcds_aggregates_distributed"][
             "segment_sum_i64"],
         "rows": c_main["rows"], "by_path": on_path("segment_sum_i64", c_on),
         "max_abs_err": c_err, "ms": c_main["ms"],
         "plain_ms": c_main["plain_ms"], "bound_ms": c_main["bound_ms"],
         "bound_by": "bytes", "library_ms": c_main["library_ms"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
