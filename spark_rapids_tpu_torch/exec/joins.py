"""Hash join exec (`spark_rapids_tpu/exec/joins.py`, inner/left/semi/anti).

Equi-joins run as a hash-sorted probe:
  1. hash the build keys (Spark murmur3), sort build rows by hash;
  2. per probe row, find the candidate range with searchsorted left/right;
  3. expand the ranges into (probe, build) pairs at a host-chosen output
     capacity: counts are computed on the device, summed, and read once per
     probe batch to pick the bucket;
  4. gather both sides, check true key equality (hash collisions, null
     keys), compact away false positives.
Left-outer rows come from the unmatched masks; semi/anti reduce the
matches instead of expanding. The build side is the right child. Under the
distribution pass (exec/requirements.py) both children are co-partitioned
key-exchanges and the join zips them: batch p against batch p.
Payload columns of any carried type, strings included, ride the gathers.
Join keys are the int and long families. Right/full outer joins, join
conditions and the sub-partition path for oversized builds wait for a
later slice.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema, empty_batch, \
    join_output_schema
from ..columnar.column import to_arrow as col_to_arrow
from ..columnar.padding import row_bucket
from ..expr.base import BoundReference, Expression, Vec, bind_references
from ..expr.hashing import hash_vecs
from ..ops.rowops import compact_vecs, gather_vecs
from .base import TpuExec, batch_vecs, vecs_to_batch
from .coalesce import concat_batches

__all__ = ["TpuShuffledHashJoinExec", "TpuBroadcastHashJoinExec",
           "SUPPORTED_JOIN_TYPES"]

SUPPORTED_JOIN_TYPES = ("inner", "left", "semi", "anti")


def _keys_valid(keys: List[Vec]):
    ok = None
    for k in keys:
        ok = k.validity if ok is None else (ok & k.validity)
    return ok


def _keys_equal(a: List[Vec], b: List[Vec]):
    eq = None
    for ka, kb in zip(a, b):
        if T.is_floating(ka.dtype):
            e = (ka.data == kb.data) | (torch.isnan(ka.data) &
                                        torch.isnan(kb.data))
        else:
            e = ka.data == kb.data
        eq = e if eq is None else (eq & e)
    return eq


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
                 join_type: str):
    """Phase 2: expand candidate ranges to pairs, equality-check, compact,
    attach left-outer rows. Recomputes phase 1 (the plain hash) like the
    JAX engine, whatever computed the sizing. Returns (out_vecs, n)."""
    counts, lo, order, pvalid, bvalid = _probe_counts(
        probe, build, probe_key_ix, build_key_ix)
    pvecs = batch_vecs(probe)
    bvecs = batch_vecs(build)
    pkeys = [pvecs[i] for i in probe_key_ix]
    bkeys = [bvecs[i] for i in build_key_ix]
    pmask = probe.row_mask()
    pcap, bcap = probe.capacity, build.capacity
    device = pmask.device

    outer_left = join_type == "left"
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
    matched = eq & live
    # per-probe-row "any true match": candidate ranges can be pure hash
    # collisions, so counts[pi] > 0 alone must not suppress the outer row
    hits = torch.zeros(pcap, dtype=torch.int32, device=device)
    pmatched = hits.index_add_(0, pi, matched.to(torch.int32)) > 0

    if join_type in ("semi", "anti"):
        want = pmatched if join_type == "semi" else ~pmatched
        return compact_vecs(pvecs, want & pmask)

    keep = live & (matched | (outer_left & ~pmatched[pi] & (k == 0)))
    left_out = gather_vecs(pvecs, pi)
    right_out = gather_vecs(bvecs, bi)
    if outer_left:  # null out the right side where no match
        right_out = [v.with_validity(v.validity & matched)
                     for v in right_out]
    return compact_vecs(left_out + right_out, keep)


class TpuShuffledHashJoinExec(TpuExec):
    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner", conf=None):
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
        if not batches:
            return None
        build = concat_batches(batches)
        threshold = self.conf.get("spark.rapids.sql.join.subPartition.rows")
        if build.row_count() > threshold:
            raise NotImplementedError(
                f"build side of {build.row_count()} rows exceeds "
                "spark.rapids.sql.join.subPartition.rows; the sub-partition "
                "join is not in spark_rapids_tpu_torch yet")
        return build

    def empty_build(self) -> ColumnarBatch:
        return empty_batch(self.children[1].output, self.device, 1)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        if self.zip_partitions:
            yield from self._zipped_execute()
            return
        build = self.build_batch()
        if build is None:
            if self.join_type in ("inner", "semi"):
                return
            build = self.empty_build()
        if self.dpp_filters:
            self._fill_dpp_filters(build)
        for probe in self.children[0].execute():
            if probe.row_count() == 0:
                continue
            out = self.join_pair(probe, build)
            if out.row_count() > 0:
                yield out

    def _fill_dpp_filters(self, build: ColumnarBatch) -> None:
        """The build side's key values (nulls dropped) into each filter: one
        copy of each key column to the host."""
        n = build.row_count()
        for ordinal, filt in self.dpp_filters:
            arr = col_to_arrow(build.columns[ordinal], n).drop_null()
            filt.set_values(arr.to_pylist() if isinstance(
                build.schema.types[ordinal], T.StringType)
                else arr.to_numpy())

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
            if n_build == 0 and self.join_type in ("inner", "semi"):
                continue
            if n_probe == 0:
                continue
            if n_build > threshold:
                raise NotImplementedError(
                    f"a build shard of {n_build} rows exceeds "
                    "spark.rapids.sql.join.subPartition.rows; the "
                    "sub-partition join is not in spark_rapids_tpu_torch yet")
            out = self.join_pair(probe, build)
            if out.row_count() > 0:
                yield out

    def join_pair(self, probe: ColumnarBatch,
                  build: ColumnarBatch) -> ColumnarBatch:
        """One probe batch against the built table: size (one host sync for
        the slot total), then expand."""
        counts = _probe_counts(probe, build, self._lk_ix, self._rk_ix)[0]
        slot = torch.clamp(counts, min=1) if self.join_type == "left" \
            else counts
        total = int(torch.where(probe.row_mask(), slot, 0).sum())
        out_cap = row_bucket(max(total, 1))
        if self.join_type in ("semi", "anti"):
            out_cap = max(out_cap, probe.capacity)
        out_vecs, n = _expand_join(probe, build, self._lk_ix, self._rk_ix,
                                   out_cap, self.join_type)
        return vecs_to_batch(self._schema, out_vecs, n)

    def _arg_string(self):
        return f"[{self.join_type}, keys={[repr(e) for e in self.left_keys]}]"


class TpuBroadcastHashJoinExec(TpuShuffledHashJoinExec):
    """Broadcast variant: the same device join, with a broadcast exchange as
    the build child."""
