"""Sort and top-k execs (`spark_rapids_tpu/exec/sort.py`; reference
`GpuSortExec.scala:83`, out-of-core iterator `:239`,
`GpuTakeOrderedAndProject`).

`TpuSortExec` has the reference's three modes:

  * each batch: every input batch sorted on its own (`each_batch`);
  * in core: all input concatenated into one batch and sorted on the
    device, when it is one batch or at most `batchSizeRows` rows;
  * out of core: each input batch sorted on the device into a run; the
    runs' SORT KEYS alone come to the host, one `np.lexsort` over (keys,
    run, row) merges them, and the device assembles each output chunk of
    `batchSizeRows` rows by gathering the chunk's rows from the runs and
    ordering them by their position in the chunk (the `__pos__` column
    of the JAX exec). Payloads never leave the device.

The memory seams are the JAX exec's: the in-core sort runs under
`with_retry_no_split_spillable` and degrades to the out-of-core merge on
SplitAndRetryOOM; out of core, each batch sorts under `with_retry` with
`split_batch_halves` (a split only makes more, smaller runs), its keys go
to the host at once, and the run waits parked as a
`SpillableColumnarBatch` through the merge and the chunk assembly, so a
tight budget spills runs to the host and reads each back when a chunk
needs it. Unlike the JAX exec, a run is parked cut to its live rows'
bucket (a shard batch of the distributed plan has the capacity of the
whole input), so its spills move live rows only.

`COUNTERS` counts the in-core and out-of-core sorts since its last reset,
and the host merge's seconds (the key copies and the lexsort).
"""

from __future__ import annotations

import time
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch, Schema
from ..columnar.padding import row_bucket
from ..errors import SplitAndRetryOOM
from ..expr.base import Expression, bind_references
from ..memory.budget import MemoryBudget
from ..memory.retry import (split_batch_halves, with_retry,
                            with_retry_no_split_spillable)
from ..memory.spillable import SpillableColumnarBatch
from ..ops.rowops import gather_vecs, lexsort_indices, sort_keys_for
from .base import (Counters, TpuExec, UnaryTpuExec, batch_vecs, check_errors,
                   device_ctx, vecs_to_batch)
from .coalesce import concat_batches

__all__ = ["TpuSortExec", "TpuTopKExec", "COUNTERS", "SortCounters"]


class SortCounters(Counters):
    """Full sorts since the last reset(): in core (`in_core`), out of core
    (`out_of_core`), and the out-of-core sorts' host merge seconds
    (`host_merge_s`: the sort keys' device-to-host copies and the
    lexsort)."""

    _FIELDS = ("in_core", "out_of_core", "host_merge_s")


COUNTERS = SortCounters()


def _bind_orders(orders, schema):
    return [(bind_references(e, schema), a, nf) for e, a, nf in orders]


def _sort_order(bound, batch: ColumnarBatch, ansi: bool = False):
    """(the stable permutation that sorts a batch by `bound` (expr,
    ascending, nulls_first) orders, padding rows last; the ANSI errors of
    the key expressions)."""
    ctx = device_ctx(batch, ansi)
    vecs = batch_vecs(batch)
    groups = [[(~ctx.row_mask).to(torch.int8)]]  # padding rows last
    for e, asc, nf in bound:
        groups.append(sort_keys_for(e.eval(ctx, vecs), asc, nf))
    return lexsort_indices(groups), ctx.errors


class TpuSortExec(UnaryTpuExec):
    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 child: TpuExec, conf=None, each_batch: bool = False):
        """orders: (expr, ascending, nulls_first). each_batch: sort within
        each batch only (reference sortEachBatch, used below windows)."""
        super().__init__([child], conf)
        self.orders = list(orders)
        self.each_batch = each_batch
        self._bound = _bind_orders(self.orders, child.output)

    def sort_single_batch(self, batch: ColumnarBatch):
        """(the batch sorted, the ANSI errors of its sort keys)."""
        order, errors = _sort_order(self._bound, batch, self.conf.is_ansi)
        return vecs_to_batch(batch.schema,
                             gather_vecs(batch_vecs(batch), order),
                             batch.num_rows), errors

    def _sorted(self, batch: ColumnarBatch) -> ColumnarBatch:
        out, errors = self.sort_single_batch(batch)
        check_errors(errors)
        return out

    def do_execute(self) -> Iterator[ColumnarBatch]:
        if self.each_batch:
            for b in self.child.execute():
                yield self._sorted(b)
            return
        batches = list(self.child.execute())
        if not batches:
            return
        total = sum(b.row_count() for b in batches)
        if len(batches) > 1 and total > self.conf.batch_size_rows:
            COUNTERS.add(out_of_core=1)
            yield from self._out_of_core(batches)
            return
        try:
            # the merged copy is passed as a temporary: the spillable
            # wrapper holds the only reference to it
            out = with_retry_no_split_spillable(concat_batches(batches),
                                                self._sorted)
        except SplitAndRetryOOM:
            # too big to sort in one pass: the out-of-core merge sorts
            # sub-batches into runs and merges them, so a split degrades
            # instead of failing
            COUNTERS.add(out_of_core=1)
            yield from self._out_of_core(batches)
            return
        COUNTERS.add(in_core=1)
        yield out

    # -- out-of-core merge path (GpuOutOfCoreSortIterator analog) ----------
    def _host_keys(self, run: ColumnarBatch) -> List[np.ndarray]:
        """The sort keys of a sorted run, computed on the device, its live
        rows copied to the host (most significant first). Their ANSI
        errors were read when the run was sorted."""
        ctx = device_ctx(run)
        vecs = batch_vecs(run)
        n = run.row_count()
        return [k[:n].cpu().numpy() for e, asc, nf in self._bound
                for k in sort_keys_for(e.eval(ctx, vecs), asc, nf)]

    def _out_of_core(self, batches: List[ColumnarBatch]
                     ) -> Iterator[ColumnarBatch]:
        def run_sort(sp: SpillableColumnarBatch):
            MemoryBudget.get().reserve(0)  # pre-flight / injection point
            out = self.sort_single_batch(sp.get_batch())
            sp.close()
            return out

        # phase 1: device-sort each batch into a run under the retry seam
        # (a split only makes more, smaller runs), copy its keys to the
        # host, and park it; the runs' key errors are read once, in run
        # order, before the merge
        runs: List[SpillableColumnarBatch] = []
        host_keys, errors, merge_s = [], [], 0.0
        try:
            while batches:
                sp0 = SpillableColumnarBatch(batches.pop(0))
                try:
                    for run, errs in with_retry(sp0, run_sort,
                                                split_batch_halves):
                        errors += errs
                        t0 = time.perf_counter()
                        keys = self._host_keys(run)
                        host_keys.append(keys)
                        merge_s += time.perf_counter() - t0
                        # a shard batch of the distributed plan has the
                        # whole input's capacity: park the live rows only
                        cap = row_bucket(max(len(keys[0]), 1))
                        runs.append(SpillableColumnarBatch(
                            run.owned(cap) if cap < run.capacity else run))
                        del run
                finally:
                    sp0.close()  # a no-op when run_sort closed it
            check_errors(errors)
            # phase 2: host merge of the key streams (keys only; the
            # payload stays in the catalog)
            t0 = time.perf_counter()
            run_id = np.concatenate([np.full(len(k[0]), i, np.int32)
                                     for i, k in enumerate(host_keys)])
            row_id = np.concatenate([np.arange(len(k[0]), dtype=np.int32)
                                     for k in host_keys])
            merged = [np.concatenate([k[g] for k in host_keys])
                      for g in range(len(host_keys[0]))]
            del host_keys
            order = _merge_order(merged, run_id, row_id)
            del merged
            COUNTERS.add(host_merge_s=merge_s + time.perf_counter() - t0)

            chunk_rows = self.conf.batch_size_rows
            for at in range(0, len(order), chunk_rows):
                yield self._assemble_chunk(runs, run_id, row_id,
                                           order[at:at + chunk_rows])
        finally:
            for r in runs:
                r.close()

    def _assemble_chunk(self, runs, run_id, row_id, chunk) -> ColumnarBatch:
        """Gather the chunk's rows from each run (read back if it spilled),
        then order them by their position in the chunk."""
        rid, rows = run_id[chunk], row_id[chunk]
        pieces, where = [], []
        for i, run in enumerate(runs):
            sel = np.flatnonzero(rid == i)
            if not len(sel):
                continue
            batch = run.get_batch()
            idx = torch.from_numpy(rows[sel].astype(np.int64)).to(
                batch.device)
            pieces.append(vecs_to_batch(batch.schema, gather_vecs(
                batch_vecs(batch), idx), len(sel)))
            where.append(sel)
            del batch
        merged = concat_batches(pieces)
        # merged row j sits at position pos[j] of the chunk: sorting by the
        # position is the inverse permutation
        pos = np.concatenate(where)
        by_pos = np.zeros(row_bucket(len(chunk)), np.int64)
        by_pos[pos] = np.arange(len(pos))
        return vecs_to_batch(merged.schema, gather_vecs(
            batch_vecs(merged), torch.from_numpy(by_pos).to(merged.device)),
            merged.num_rows)

    def _arg_string(self):
        return f"[{[(repr(e), a, nf) for e, a, nf in self.orders]}]"


def _merge_order(keys: List[np.ndarray], run_id: np.ndarray,
                 row_id: np.ndarray) -> np.ndarray:
    """The global order of the runs' rows: np.lexsort over the keys (most
    significant first), then run, then row, so the merge is stable across
    runs. A key equal on every row orders nothing and is left out, and
    (run, row) sort as one int64."""
    keys = [k for k in keys if len(k) and k.min() != k.max()]
    tie = (run_id.astype(np.int64) << 32) | row_id.astype(np.int64)
    return np.lexsort(tuple([tie] + keys[::-1]))


class TpuTopKExec(UnaryTpuExec):
    """TakeOrderedAndProjectExec analog (`GpuOverrides.scala:3705`): ORDER
    BY + LIMIT k without a full sort. Each input batch sorts on the device
    and keeps its first k rows; a running candidate batch of <= k rows
    merges with every batch's winners, so the device holds one input batch
    plus O(k) rows and the host sees nothing. Offset slices the final
    candidates."""

    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 limit: int, child: TpuExec, conf=None, offset: int = 0):
        super().__init__([child], conf)
        self.orders = list(orders)
        self.limit = limit
        self.offset = offset
        self._k = limit + offset
        self._kcap = row_bucket(max(self._k, 1))
        self._bound = _bind_orders(self.orders, child.output)

    def _topk(self, batch: ColumnarBatch, ansi: bool = False):
        """(the batch's first k rows in order, at capacity kcap (a shorter
        permutation is padded with row 0, past the row count); the ANSI
        errors of its sort keys)."""
        order, errors = _sort_order(self._bound, batch, ansi)
        if self._kcap <= batch.capacity:
            take = order[:self._kcap]
        else:
            take = torch.nn.functional.pad(order,
                                           (0, self._kcap - batch.capacity))
        return vecs_to_batch(batch.schema,
                             gather_vecs(batch_vecs(batch), take),
                             torch.clamp(batch.num_rows, max=self._k)), errors

    @property
    def output(self) -> Schema:
        return self.child.output

    def do_execute(self) -> Iterator[ColumnarBatch]:
        run = None
        for b in self.child.execute():
            top, errors = self._topk(b, self.conf.is_ansi)
            check_errors(errors)
            # the candidates' keys were checked in their own batches
            run = top if run is None else \
                self._topk(concat_batches([run, top]))[0]
        if run is None:
            return
        if self.offset:
            n = run.row_count()
            start = min(self.offset, n)
            take = max(min(self.limit, n - start), 0)
            run = vecs_to_batch(run.schema, [v.gather(slice(start, None))
                                             for v in batch_vecs(run)], take)
        yield run

    def _arg_string(self):
        return f"[k={self.limit}, offset={self.offset}, " \
               f"orders={len(self.orders)}]"
