"""Hash and nested-loop join execs (`spark_rapids_tpu/exec/joins.py`).

Equi-joins run as a hash-sorted probe:
  1. hash the build keys (Spark murmur3), sort build rows by hash;
  2. per probe row, find the candidate range with searchsorted left/right;
  3. expand the ranges into (probe, build) pairs at a host-chosen output
     capacity: counts are computed on the device, summed, and read once per
     probe batch to pick the bucket;
  4. gather both sides, check true key equality (hash collisions, null
     keys) and the optional join condition over the combined row (a
     condition that reads null is no match), compact away the rest.
Left and full outer rows come from the per-probe matched flags. Right and
full outer rows come from the build side's matched flags, carried across
the probe stream and emitted once after it with the left columns null.
Semi/anti reduce the matches instead of expanding; existence keeps every
probe row and appends a never-null BOOLEAN `exists`. The build side is the
right child. Under the distribution pass (exec/requirements.py) both
children are co-partitioned key-exchanges and the join zips them: batch p
against batch p.

A build side (or a build shard) of more than
`spark.rapids.sql.join.subPartition.rows` rows hash-splits into P
key-aligned sub-partitions that join pairwise. Keyless joins (cross joins
and pure-condition joins of every type) run in `TpuNestedLoopJoinExec` as
bounded all-pairs tiles.

Memory seams, as in the JAX engine: the hash join's build side (whole, or
its sub-partitions) waits parked as a `SpillableColumnarBatch` between
probe batches, and each probe batch joins under `with_retry` with
`split_batch_halves`; the zipped sub-partition join parks every probe and
build part; the nested-loop join parks its build chunks. Two departures:
each probe batch's retried step starts with a pre-flight `reserve(0)` (the
sort's and the aggregate's injection point; the JAX join step has none),
and the streamed sub-partition join runs its probe batches under the same
retry (the JAX one calls them directly).

Keys: the int and long families (boolean, byte, short, int, date, long,
timestamp, decimal of up to 18 digits), float, double and string. Floats
match NaN to NaN and -0.0 to 0.0; strings compare bytes and lengths.
Payload columns of any carried type ride the gathers.

ANSI: a join condition reports errors only for candidate pairs that
exist (the key-equal pairs of the expand, every live pair of a
nested-loop tile); a gathered pair that no key match made never raises.
The hash join reads a pair's flags with its output row count, the
nested-loop join once a tile.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema, empty_batch, \
    empty_column, join_output_schema
from ..columnar.column import to_arrow as col_to_arrow
from ..columnar.padding import row_bucket
from ..expr.base import BoundReference, EvalContext, Expression, Vec, \
    bind_references
from ..expr.hashing import hash_vecs
from ..expr.predicates import string_equal
from ..memory.budget import MemoryBudget
from ..memory.retry import split_batch_halves, with_retry
from ..memory.spillable import SpillableColumnarBatch
from ..ops.rowops import compact_vecs, gather_vecs
from .base import (Counters, TpuExec, batch_vecs, check_errors,
                   vecs_to_batch)
from .coalesce import concat_batches

__all__ = ["TpuShuffledHashJoinExec", "TpuBroadcastHashJoinExec",
           "TpuNestedLoopJoinExec", "SUPPORTED_JOIN_TYPES", "COUNTERS"]

SUPPORTED_JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti",
                        "existence")
# probe rows without a match still emit one row (build side null)
_PROBE_OUTER = ("left", "full")
# build rows no probe row matched are emitted after the stream
_BUILD_OUTER = ("right", "full")
# an empty build side gives no rows at all
_NEEDS_BUILD = ("inner", "right", "semi")


class JoinCounters(Counters):
    """Since the last reset(): build sides (or shards) split into
    sub-partitions (`sub_partition_builds`), the sub-partition pairs joined
    (`sub_partition_pairs`), and the all-pairs tiles of the nested-loop
    join (`nested_loop_tiles`)."""

    _FIELDS = ("sub_partition_builds", "sub_partition_pairs",
               "nested_loop_tiles")


COUNTERS = JoinCounters()


def _keys_valid(keys: List[Vec]):
    ok = None
    for k in keys:
        ok = k.validity if ok is None else (ok & k.validity)
    return ok


def _keys_equal(a: List[Vec], b: List[Vec]):
    eq = None
    for ka, kb in zip(a, b):
        if ka.is_string:
            e = string_equal(ka, kb)
        elif T.is_floating(ka.dtype):
            e = (ka.data == kb.data) | (torch.isnan(ka.data) &
                                        torch.isnan(kb.data))
        else:
            e = ka.data == kb.data
        eq = e if eq is None else (eq & e)
    return eq


def _any_by(idx: torch.Tensor, flags: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n]: True at each index some True flag points to."""
    hits = torch.zeros(n, dtype=torch.int32, device=flags.device)
    return hits.index_add_(0, idx, flags.to(torch.int32)) > 0


def _condition_holds(condition: Expression, vecs: List[Vec],
                     mask: torch.Tensor, ansi: bool):
    """(the bound join condition over combined rows, true and not null;
    its ANSI errors over the rows of `mask`)."""
    ctx = EvalContext(mask, ansi)
    c = condition.eval(ctx, vecs)
    return c.data.to(torch.bool) & c.validity, ctx.errors


def _probe_counts(probe: ColumnarBatch, build: ColumnarBatch,
                  probe_key_ix: Tuple[int, ...],
                  build_key_ix: Tuple[int, ...]):
    """Phase 1: per-probe candidate counts (by hash range) and the sorted
    build order."""
    pvecs = batch_vecs(probe)
    bvecs = batch_vecs(build)
    pkeys = [pvecs[i] for i in probe_key_ix]
    bkeys = [bvecs[i] for i in build_key_ix]
    pvalid = _keys_valid(pkeys) & probe.row_mask()
    bvalid = _keys_valid(bkeys) & build.row_mask()
    ph = hash_vecs(pkeys).to(torch.int64)
    bh = hash_vecs(bkeys).to(torch.int64)
    # exile invalid build rows to a hash bucket no valid probe can hit
    bh = torch.where(bvalid, bh, 2 ** 62)
    bh_sorted, order = torch.sort(bh, stable=True)
    lo = torch.searchsorted(bh_sorted, ph, right=False)
    hi = torch.searchsorted(bh_sorted, ph, right=True)
    counts = torch.where(pvalid, hi - lo, 0).to(torch.int32)
    return counts, lo, order, pvalid, bvalid


def _expand_join(probe: ColumnarBatch, build: ColumnarBatch,
                 probe_key_ix: Tuple[int, ...],
                 build_key_ix: Tuple[int, ...], out_cap: int,
                 join_type: str, condition: Expression = None,
                 ansi: bool = False):
    """Phase 2: expand candidate ranges to pairs, check equality and the
    condition, compact, attach left-outer rows. Recomputes phase 1 (the
    plain hash) like the JAX engine, whatever computed the sizing. Returns
    (out_vecs, n, bmatched, errors): bmatched flags the build rows that met
    a match (all False unless the join is right or full), errors are the
    condition's ANSI errors."""
    counts, lo, order, pvalid, bvalid = _probe_counts(
        probe, build, probe_key_ix, build_key_ix)
    pvecs = batch_vecs(probe)
    bvecs = batch_vecs(build)
    pkeys = [pvecs[i] for i in probe_key_ix]
    bkeys = [bvecs[i] for i in build_key_ix]
    pmask = probe.row_mask()
    pcap, bcap = probe.capacity, build.capacity
    device = pmask.device

    outer_left = join_type in _PROBE_OUTER
    slot_counts = torch.clamp(counts, min=1) if outer_left else counts
    slot_counts = torch.where(pmask, slot_counts, 0)
    offsets = torch.cumsum(slot_counts, dim=0, dtype=torch.int64)
    total = offsets[-1]
    j = torch.arange(out_cap, dtype=torch.int64, device=device)
    live = j < total
    # probe row for output slot j
    pi = torch.searchsorted(offsets, j, right=True).clamp(0, pcap - 1)
    base = torch.where(pi > 0, offsets[(pi - 1).clamp(min=0)], 0)
    k = j - base
    bi = order[(lo[pi] + k).clamp(0, bcap - 1)]

    # true equality check (hash collision + sentinel guard)
    eq = _keys_equal(gather_vecs(pkeys, pi), gather_vecs(bkeys, bi)) & \
        pvalid[pi] & bvalid[bi] & (k < counts[pi])
    wide = join_type not in ("semi", "anti", "existence")
    if wide or condition is not None:
        left_out = gather_vecs(pvecs, pi)
        right_out = gather_vecs(bvecs, bi)
    errors = []
    if condition is not None:
        # applied before the per-probe "any match", so a condition that
        # reads null (or false) leaves the probe row unmatched
        holds, errors = _condition_holds(condition, left_out + right_out,
                                         eq & live, ansi)
        eq = eq & holds
    matched = eq & live
    # per-probe-row "any true match": candidate ranges can be pure hash
    # collisions, so counts[pi] > 0 alone must not suppress the outer row
    pmatched = _any_by(pi, matched, pcap)
    bmatched = _any_by(bi, matched, bcap) if join_type in _BUILD_OUTER \
        else torch.zeros(bcap, dtype=torch.bool, device=device)

    if join_type == "existence":
        exists = Vec(T.BOOLEAN, pmatched,
                     torch.ones(pcap, dtype=torch.bool, device=device))
        return (*compact_vecs(pvecs + [exists], pmask), bmatched, errors)
    if join_type in ("semi", "anti"):
        want = pmatched if join_type == "semi" else ~pmatched
        return (*compact_vecs(pvecs, want & pmask), bmatched, errors)

    keep = live & (matched | (outer_left & ~pmatched[pi] & (k == 0)))
    if outer_left:  # null out the right side where no match
        right_out = [v.with_validity(v.validity & matched)
                     for v in right_out]
    return (*compact_vecs(left_out + right_out, keep), bmatched, errors)


def _null_vecs(schema: Schema, cap: int, device) -> List[Vec]:
    """All-null columns for one side of an outer join."""
    return [Vec.from_column(empty_column(dt, cap, device))
            for dt in schema.types]


def _sub_partitions(n_build: int, threshold: int) -> int:
    """P, the power of two (at most 64) that brings the build side's rows
    per sub-partition to the threshold or under."""
    p = 1
    while n_build // p > threshold and p < 64:
        p *= 2
    return p


# the sub-partition hash's seed. The JAX engine's `_hash_pid` uses 42, the
# exchange's seed: a zipped shard's rows all share pmod(murmur3_42, n), so
# whenever P divides the mesh size n they all land in one sub-partition
# and the split bounds nothing. Another seed spreads them.
SUB_PARTITION_SEED = 100


def _hash_split(batch: ColumnarBatch, key_ix: Tuple[int, ...],
                p: int) -> List[ColumnarBatch]:
    """The batch's rows in P key-aligned sub-partitions, sub-partition q
    holding the rows whose uint32 murmur3 of the keys is q mod P (the JAX
    `_hash_pid` form, with SUB_PARTITION_SEED). One stable sort by
    sub-partition and one host read of the P counts; each part is cut to
    its own row bucket (padding contents unspecified)."""
    vecs = batch_vecs(batch)
    h = hash_vecs([vecs[i] for i in key_ix], SUB_PARTITION_SEED) \
        .to(torch.int64) & 0xFFFFFFFF
    pid = torch.where(batch.row_mask(), h % p, p)  # padding sorts last
    order = torch.sort(pid, stable=True).indices
    counts = torch.bincount(pid, minlength=p + 1)[:p].tolist()
    parts, start = [], 0
    last = batch.capacity - 1
    for n in counts:
        cap = row_bucket(max(n, 1))
        at = torch.arange(start, start + cap, device=order.device)
        parts.append(vecs_to_batch(batch.schema, gather_vecs(
            vecs, order[at.clamp(max=last)]), n))
        start += n
    return parts


def _slice_rows(batch: ColumnarBatch, lo: int, hi: int,
                n: int) -> ColumnarBatch:
    """Rows [lo, hi) of a compacted batch of n rows; the count clamps."""
    vecs = [v.gather(slice(lo, hi)) for v in batch_vecs(batch)]
    return vecs_to_batch(batch.schema, vecs, max(0, min(n - lo, hi - lo)))


def _combined(left: Schema, right: Schema) -> Schema:
    return Schema(left.names + right.names, left.types + right.types)


class TpuShuffledHashJoinExec(TpuExec):
    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner", conf=None,
                 condition: Expression = None):
        super().__init__([left, right], conf)
        if join_type not in SUPPORTED_JOIN_TYPES:
            raise NotImplementedError(
                f"join type {join_type} is not supported by "
                f"spark_rapids_tpu_torch yet ({SUPPORTED_JOIN_TYPES})")
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        # set by the distribution pass when both children are
        # co-partitioned key-exchanges: join batch p with batch p instead
        # of concatenating the build stream (per-shard join)
        self.zip_partitions = False
        self._schema = join_output_schema(left.output, right.output,
                                          join_type)
        # optional non-equi condition over the combined (left ++ right) row
        self.condition = condition
        self._bcond = None if condition is None else bind_references(
            condition, _combined(left.output, right.output))
        self._lk_ix = tuple(self._key_ordinal(e, left.output)
                            for e in self.left_keys)
        self._rk_ix = tuple(self._key_ordinal(e, right.output)
                            for e in self.right_keys)
        # (build key ordinal, DynamicKeyFilter) pairs the planner wires for
        # probe-side scan pruning; filled with the build side's distinct
        # keys after the build, strictly before the probe stream is pulled
        self.dpp_filters: list = []

    @staticmethod
    def _key_ordinal(e: Expression, schema: Schema) -> int:
        b = bind_references(e, schema)
        if isinstance(b, BoundReference):
            return b.ordinal
        raise ValueError("join keys must be column references after planning")

    @property
    def output(self) -> Schema:
        return self._schema

    def build_batch(self):
        """The whole build side as one batch; None when it is empty."""
        batches = list(self.children[1].execute())
        return concat_batches(batches) if batches else None

    def empty_build(self) -> ColumnarBatch:
        return empty_batch(self.children[1].output, self.device, 1)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        if self.zip_partitions:
            yield from self._zipped_execute()
            return
        build = self.build_batch()
        if build is None:
            if self.join_type in _NEEDS_BUILD:
                return
            build = self.empty_build()
        if self.dpp_filters:
            self._fill_dpp_filters(build)
        threshold = self.conf.get("spark.rapids.sql.join.subPartition.rows")
        # hand the build over: the callee parks it and holds the only
        # reference, so a spill frees it
        held = [build]
        del build
        if held[0].row_count() > threshold:
            yield from self._streamed_sub_partition(held.pop(), threshold)
        else:
            yield from self._streamed_join(held.pop())

    def _fill_dpp_filters(self, build: ColumnarBatch) -> None:
        """The build side's key values (nulls dropped) into each filter: one
        copy of each key column to the host."""
        n = build.row_count()
        for ordinal, filt in self.dpp_filters:
            arr = col_to_arrow(build.columns[ordinal], n).drop_null()
            filt.set_values(arr.to_pylist() if isinstance(
                build.schema.types[ordinal], T.StringType)
                else arr.to_numpy())

    def _probe_stream(self) -> Iterator[ColumnarBatch]:
        for probe in self.children[0].execute():
            if probe.row_count() > 0:
                yield probe

    def _probe_parts(self, probe: ColumnarBatch, run
                     ) -> Iterator[tuple]:
        """`run(probe)`'s results for one probe batch, under the retry seam:
        the batch parked, a pre-flight reserve, halves on
        SplitAndRetryOOM."""
        def step(sp):
            MemoryBudget.get().reserve(0)  # pre-flight / injection point
            out = run(sp.get_batch())
            sp.close()
            return out

        sp = SpillableColumnarBatch(probe)
        del probe
        try:
            yield from with_retry(sp, step, split_batch_halves)
        finally:
            sp.close()  # a no-op when step() closed it

    def _streamed_join(self, build: ColumnarBatch
                       ) -> Iterator[ColumnarBatch]:
        """Each probe batch against the whole build table, which waits
        parked between them; right and full joins emit the build rows no
        batch matched after the stream."""
        sp_build = SpillableColumnarBatch(build)
        del build
        bmatched = None
        try:
            for probe in self._probe_stream():
                for out, n, bm in self._probe_parts(
                        probe, lambda p: self._join_pair_core(
                            p, sp_build.get_batch())):
                    if bm is not None:
                        bmatched = bm if bmatched is None else (bmatched | bm)
                    if n > 0:
                        yield out
            if self.join_type in _BUILD_OUTER:
                extra = self._unmatched_batch(sp_build.get_batch(), bmatched)
                if extra is not None:
                    yield extra
        finally:
            sp_build.close()

    def _streamed_sub_partition(self, build: ColumnarBatch, threshold: int
                                ) -> Iterator[ColumnarBatch]:
        """An oversized build side with a streamed probe: the build splits
        once into P key-aligned sub-partitions, parked, each probe batch the
        same way, and part joins part. Matching keys share a part, so the
        part joins compose exactly; right/full matched flags accumulate per
        part across the whole probe stream."""
        p = _sub_partitions(build.row_count(), threshold)
        COUNTERS.add(sub_partition_builds=1)
        build_parts = [SpillableColumnarBatch(bb)
                       for bb in _hash_split(build, self._rk_ix, p)]
        del build
        bmatched = [None] * p

        def join_parts(probe):
            # unmatched build rows surface at the end, so empty parts skip
            return [(i,) + self._join_pair_core(
                        pp, build_parts[i].get_batch())
                    for i, pp in enumerate(_hash_split(probe, self._lk_ix, p))
                    if pp.row_count() > 0]

        try:
            for probe in self._probe_stream():
                for results in self._probe_parts(probe, join_parts):
                    for i, out, n, bm in results:
                        COUNTERS.add(sub_partition_pairs=1)
                        if bm is not None:
                            bmatched[i] = bm if bmatched[i] is None \
                                else (bmatched[i] | bm)
                        if n > 0:
                            yield out
            if self.join_type in _BUILD_OUTER:
                for part, bm in zip(build_parts, bmatched):
                    extra = self._unmatched_batch(part.get_batch(), bm)
                    if extra is not None:
                        yield extra
        finally:
            for sp in build_parts:
                sp.close()

    def _zipped_execute(self) -> Iterator[ColumnarBatch]:
        """Co-partitioned per-shard join: matching keys land in the same
        positional batch of the two exchanges, so batch p joins batch p,
        one probe and one build batch at a time."""
        _end = object()
        threshold = self.conf.get("spark.rapids.sql.join.subPartition.rows")
        for probe, build in itertools.zip_longest(
                self.children[0].execute(), self.children[1].execute(),
                fillvalue=_end):
            if probe is _end or build is _end:
                raise RuntimeError(
                    "zip_partitions requires positionally-aligned exchange "
                    "outputs (one stream ended early)")
            n_probe, n_build = probe.row_count(), build.row_count()
            if n_build == 0 and self.join_type in _NEEDS_BUILD:
                continue
            if n_probe == 0:
                if n_build and self.join_type in _BUILD_OUTER:
                    yield self._right_only(build)
                continue
            if n_build > threshold:
                yield from self._sub_partition_join(probe, build, threshold)
            else:
                yield from self._join_pair(probe, build)

    def _join_pair_core(self, probe: ColumnarBatch, build: ColumnarBatch):
        """One probe batch against a build table: size (one host sync for
        the slot total), then expand, and read the output row count with
        the condition's ANSI flags (a second sync). Returns (out_batch,
        its row count, bmatched), bmatched the build rows' matched flags
        for right/full joins, else None."""
        counts = _probe_counts(probe, build, self._lk_ix, self._rk_ix)[0]
        slot = torch.clamp(counts, min=1) \
            if self.join_type in _PROBE_OUTER else counts
        total = int(torch.where(probe.row_mask(), slot, 0).sum())
        out_cap = row_bucket(max(total, 1))
        if self.join_type in ("semi", "anti", "existence"):
            out_cap = max(out_cap, probe.capacity)
        out_vecs, n, bmatched, errors = _expand_join(
            probe, build, self._lk_ix, self._rk_ix, out_cap, self.join_type,
            self._bcond, self.conf.is_ansi)
        out = vecs_to_batch(self._schema, out_vecs, n)
        n_out, = check_errors(errors, [out.num_rows])
        return out, n_out, \
            (bmatched if self.join_type in _BUILD_OUTER else None)

    def _join_pair(self, probe: ColumnarBatch,
                   build: ColumnarBatch) -> Iterator[ColumnarBatch]:
        """Join one disjoint (probe, build) pair and emit its unmatched
        build rows at once: right only where this build slice meets no
        other probe rows (a zipped shard, a sub-partition pair)."""
        out, n, bmatched = self._join_pair_core(probe, build)
        if n > 0:
            yield out
        if self.join_type in _BUILD_OUTER:
            extra = self._unmatched_batch(build, bmatched)
            if extra is not None:
                yield extra

    def _sub_partition_join(self, probe: ColumnarBatch, build: ColumnarBatch,
                            threshold: int) -> Iterator[ColumnarBatch]:
        """An oversized build shard: both sides split into P key-aligned
        sub-partitions that join pairwise (outer, semi, anti and existence
        too, since each is decided per key)."""
        p = _sub_partitions(build.row_count(), threshold)
        COUNTERS.add(sub_partition_builds=1)
        pairs = [(SpillableColumnarBatch(pb), SpillableColumnarBatch(bb))
                 for pb, bb in zip(_hash_split(probe, self._lk_ix, p),
                                   _hash_split(build, self._rk_ix, p))]
        del probe, build
        try:
            for sp_probe, sp_build in pairs:
                pb, bb = sp_probe.get_batch(), sp_build.get_batch()
                if pb.row_count() or bb.row_count():
                    COUNTERS.add(sub_partition_pairs=1)
                    yield from self._join_pair(pb, bb)
                del pb, bb
                sp_probe.close()
                sp_build.close()
        finally:
            for sp_probe, sp_build in pairs:
                sp_probe.close()
                sp_build.close()

    def _unmatched_batch(self, build: ColumnarBatch, bmatched):
        """Right/full: the build rows never matched, left columns null;
        None when there are none."""
        if bmatched is None:  # no probe batch ever met this build slice
            bmatched = torch.zeros(build.capacity, dtype=torch.bool,
                                   device=build.device)
        rvecs, n = compact_vecs(batch_vecs(build),
                                build.row_mask() & ~bmatched)
        if int(n) == 0:
            return None
        return self._null_left_batch(rvecs, n, build.capacity)

    def _right_only(self, build: ColumnarBatch) -> ColumnarBatch:
        return self._null_left_batch(batch_vecs(build), build.num_rows,
                                     build.capacity)

    def _null_left_batch(self, rvecs: List[Vec], n, cap: int
                         ) -> ColumnarBatch:
        lvecs = _null_vecs(self.children[0].output, cap, rvecs[0].data.device)
        return vecs_to_batch(self._schema, lvecs + rvecs, n)

    def _arg_string(self):
        return f"[{self.join_type}, keys={[repr(e) for e in self.left_keys]}]"


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """Broadcast variant: the same device join, with a broadcast exchange as
    the build child."""


def _tile_pairs(pcap: int, ccap: int, device):
    """Probe and build row of each pair of a pcap x ccap tile, row-major."""
    pi = torch.arange(pcap, device=device).repeat_interleave(ccap)
    bi = torch.arange(ccap, device=device).repeat(pcap)
    return pi, bi


def _nl_matched(probe: ColumnarBatch, bchunk: ColumnarBatch, cond,
                ansi: bool = False):
    """All-pairs tile: the matched mask over the P x C grid (flattened
    row-major), with per-probe-row and per-build-row any-match, and the
    condition's ANSI errors over the tile's live pairs."""
    pcap, ccap = probe.capacity, bchunk.capacity
    pi, bi = _tile_pairs(pcap, ccap, probe.device)
    m = probe.row_mask()[pi] & bchunk.row_mask()[bi]
    errors = []
    if cond is not None:
        holds, errors = _condition_holds(
            cond, gather_vecs(batch_vecs(probe), pi) +
            gather_vecs(batch_vecs(bchunk), bi), m, ansi)
        m = m & holds
    grid = m.reshape(pcap, ccap)
    return m, grid.any(dim=1), grid.any(dim=0), errors


def _nl_expand(probe: ColumnarBatch, bchunk: ColumnarBatch,
               matched: torch.Tensor, n: int) -> List[Vec]:
    """The surviving pairs of an all-pairs tile as output columns, at the
    row bucket of their count."""
    pi, bi = _tile_pairs(probe.capacity, bchunk.capacity, probe.device)
    order = torch.sort((~matched).to(torch.int8), stable=True).indices
    order = order[:min(row_bucket(n), order.shape[0])]
    return gather_vecs(batch_vecs(probe), pi[order]) + \
        gather_vecs(batch_vecs(bchunk), bi[order])


class TpuNestedLoopJoinExec(TpuExec):
    """Nested-loop and cartesian join (the JAX `TpuNestedLoopJoinExec`):
    every probe row meets every build row, filtered by an optional
    condition. The build (right) side is materialised once and sliced into
    chunks of C rows; each probe batch is sliced into tiles of
    PROBE_TILE_ROWS, and each tile meets each chunk as one bounded P x C
    all-pairs grid, within TILE_BUDGET pairs however large the probe batch.
    Matched flags accumulate per probe tile (left/semi/anti/existence) and
    per build chunk across the stream (right/full)."""

    TILE_BUDGET = 1 << 20   # max pairs per tile
    PROBE_TILE_ROWS = 4096  # probe rows per tile; C = TILE_BUDGET / this

    def __init__(self, left: TpuExec, right: TpuExec,
                 condition: Expression = None, join_type: str = "inner",
                 conf=None):
        super().__init__([left, right], conf)
        self.join_type = "inner" if join_type == "cross" else join_type
        if self.join_type not in SUPPORTED_JOIN_TYPES:
            raise NotImplementedError(
                f"join type {join_type} is not supported by "
                f"spark_rapids_tpu_torch yet ({SUPPORTED_JOIN_TYPES})")
        self.condition = condition
        lo, ro = left.output, right.output
        self._schema = join_output_schema(lo, ro, self.join_type)
        self._bcond = None if condition is None else bind_references(
            condition, _combined(lo, ro))

    @property
    def output(self) -> Schema:
        return self._schema

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.children[1].execute())
        if not batches and self.join_type in _NEEDS_BUILD:
            return
        build = concat_batches(batches) if batches else \
            empty_batch(self.children[1].output, self.device, 1)
        # each chunk owns its rows (a slice would pin the whole build), so
        # a spilled chunk frees its memory
        chunks = [SpillableColumnarBatch(c.owned())
                  for c in self._slice_build(build)]
        del build, batches
        try:
            yield from self._probe_chunks(chunks)
        finally:
            for sp in chunks:
                sp.close()

    def _probe_chunks(self, chunks: List[SpillableColumnarBatch]
                      ) -> Iterator[ColumnarBatch]:
        bmatched = [None] * len(chunks)
        jt, pt = self.join_type, self.PROBE_TILE_ROWS
        ansi = self.conf.is_ansi
        for whole in self.children[0].execute():
            n_whole = whole.row_count()
            if n_whole == 0:
                continue
            # each row-slice of live rows is an independent probe unit
            # (tails are per row, rows are disjoint)
            pcap = whole.capacity
            tiles = [whole] if pcap <= pt else \
                [_slice_rows(whole, lo, min(lo + pt, pcap), n_whole)
                 for lo in range(0, n_whole, pt)]
            for probe in tiles:
                pmatched = None
                for ci, sp in enumerate(chunks):
                    bchunk = sp.get_batch()
                    COUNTERS.add(nested_loop_tiles=1)
                    m, pm, bm, errors = _nl_matched(probe, bchunk,
                                                    self._bcond, ansi)
                    pmatched = pm if pmatched is None else (pmatched | pm)
                    if jt in _BUILD_OUTER:
                        bmatched[ci] = bm if bmatched[ci] is None \
                            else (bmatched[ci] | bm)
                    if jt in ("semi", "anti", "existence"):
                        check_errors(errors)
                        continue  # only the flags are needed
                    n, = check_errors(errors, [m.sum()])
                    if n:
                        yield vecs_to_batch(self._schema, _nl_expand(
                            probe, bchunk, m, n), n)
                yield from self._emit_probe_tail(probe, pmatched)
        if jt in _BUILD_OUTER:
            for sp, bm in zip(chunks, bmatched):
                extra = self._unmatched_chunk(sp.get_batch(), bm)
                if extra is not None:
                    yield extra

    def _slice_build(self, build: ColumnarBatch) -> List[ColumnarBatch]:
        """Capacity-C chunks of the build table's live rows; C is sized so
        that a PROBE_TILE_ROWS x C tile stays within TILE_BUDGET pairs."""
        bcap, n = build.capacity, build.row_count()
        c = max(1, min(bcap, self.TILE_BUDGET // self.PROBE_TILE_ROWS))
        return [_slice_rows(build, lo, min(lo + c, bcap), n)
                for lo in range(0, n, c)]

    def _emit_probe_tail(self, probe: ColumnarBatch,
                         pmatched) -> Iterator[ColumnarBatch]:
        """Per-probe-tile epilogue once every build chunk was seen."""
        jt = self.join_type
        pcap, dev = probe.capacity, probe.device
        if pmatched is None:
            pmatched = torch.zeros(pcap, dtype=torch.bool, device=dev)
        pvecs, pmask = batch_vecs(probe), probe.row_mask()
        if jt in _PROBE_OUTER:
            vecs, n = compact_vecs(pvecs, pmask & ~pmatched)
            if int(n):
                yield vecs_to_batch(self._schema, vecs + _null_vecs(
                    self.children[1].output, pcap, dev), n)
        elif jt in ("semi", "anti"):
            want = pmatched if jt == "semi" else ~pmatched
            vecs, n = compact_vecs(pvecs, pmask & want)
            if int(n):
                yield vecs_to_batch(self._schema, vecs, n)
        elif jt == "existence":
            exists = Vec(T.BOOLEAN, pmatched,
                         torch.ones(pcap, dtype=torch.bool, device=dev))
            vecs, n = compact_vecs(pvecs + [exists], pmask)
            yield vecs_to_batch(self._schema, vecs, n)

    def _unmatched_chunk(self, bchunk: ColumnarBatch, bmatched):
        if bmatched is None:
            bmatched = torch.zeros(bchunk.capacity, dtype=torch.bool,
                                   device=bchunk.device)
        vecs, n = compact_vecs(batch_vecs(bchunk),
                               bchunk.row_mask() & ~bmatched)
        if int(n) == 0:
            return None
        return vecs_to_batch(self._schema, _null_vecs(
            self.children[0].output, bchunk.capacity, bchunk.device) + vecs,
            n)

    def _arg_string(self):
        cond = "" if self.condition is None else f", cond={self.condition!r}"
        return f"[{self.join_type}{cond}]"
