"""Scan, range, project, filter, expand, union, limit and sample execs
(`spark_rapids_tpu/exec/basic.py`). Project and filter return each batch
with the ANSI errors of its expressions; run alone, they read those once
a batch (exec/base.py `check_errors`), and in a fused stage the stage
reads them (exec/fused.py). Expand reads its projections' errors once an
input batch. Fusion ends its chains at Expand and Sample (plan/fusion.py
takes neither as a member)."""

from __future__ import annotations

from typing import Sequence

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema, batch_from_arrow
from ..columnar.padding import row_bucket
from ..expr.base import Expression, Vec, bind_references, output_name
from ..ops.rowops import compact_vecs, sample_mask
from .base import (TpuExec, UnaryTpuExec, batch_vecs, check_errors,
                   device_ctx, vecs_to_batch)

__all__ = ["TpuScanExec", "TpuRangeExec", "TpuProjectExec", "TpuFilterExec",
           "TpuExpandExec", "TpuUnionExec", "TpuLimitExec", "TpuSampleExec"]


class TpuScanExec(TpuExec):
    """Host Arrow table -> device batches of at most batchSizeRows rows."""

    def __init__(self, table, device: torch.device, conf=None,
                 batch_rows: int = None):
        super().__init__([], conf, device)
        self.table = table
        self._schema = Schema.from_arrow(table.schema)
        self.batch_rows = batch_rows or self.conf.batch_size_rows

    @property
    def output(self) -> Schema:
        return self._schema

    def do_execute(self):
        from ..cpu.hostbatch import on_host
        n = self.table.num_rows
        step = self.batch_rows
        for off in range(0, max(n, 1), step):
            chunk = self.table.slice(off, min(step, n - off)) if n else \
                self.table
            yield batch_from_arrow(chunk, self.device, conf=self.conf,
                                   flat=on_host())
            if n == 0:
                break

    def _arg_string(self):
        return f"[{self.table.num_rows} rows, {self.device}]"


class TpuRangeExec(TpuExec):
    """The LONG column `id` from `start` towards `end` by `step` (either
    sign): batches of at most batchSizeRows rows, each at its row bucket,
    and one empty batch for an empty range (JAX `TpuRangeExec`)."""

    def __init__(self, start: int, end: int, step: int, device: torch.device,
                 conf=None, batch_rows: int = None):
        super().__init__([], conf, device)
        self.start, self.end, self.step = start, end, step
        self._schema = Schema(("id",), (T.LONG,))
        self.batch_rows = batch_rows or self.conf.batch_size_rows

    @property
    def output(self) -> Schema:
        return self._schema

    def do_execute(self):
        total = max(0, -(-(self.end - self.start) // self.step))
        done = 0
        while True:
            count = min(self.batch_rows, total - done)
            cap = row_bucket(count)
            data = torch.arange(cap, dtype=torch.int64, device=self.device) \
                * self.step + (self.start + done * self.step)
            yield vecs_to_batch(self._schema, [Vec(T.LONG, data, torch.ones(
                cap, dtype=torch.bool, device=self.device))], count)
            done += count
            if done >= total:
                return

    def _arg_string(self):
        return f"[{self.start}, {self.end}, {self.step}]"


class TpuProjectExec(UnaryTpuExec):
    def __init__(self, exprs: Sequence[Expression], child: TpuExec, conf=None):
        super().__init__([child], conf)
        self.exprs = list(exprs)
        self._bound = [bind_references(e, child.output) for e in self.exprs]
        names = tuple(output_name(e, f"col{i}")
                      for i, e in enumerate(self.exprs))
        self._schema = Schema(names, tuple(e.data_type for e in self._bound))

    @property
    def output(self) -> Schema:
        return self._schema

    def project(self, batch: ColumnarBatch):
        """(the projected batch, its ANSI errors)."""
        ctx = device_ctx(batch, self.conf.is_ansi)
        vecs = batch_vecs(batch)
        return vecs_to_batch(self._schema,
                             [e.eval(ctx, vecs) for e in self._bound],
                             batch.num_rows), ctx.errors

    def do_execute(self):
        for b in self.child.execute():
            out, errors = self.project(b)
            check_errors(errors)
            yield out

    def _arg_string(self):
        return f"[{', '.join(map(repr, self.exprs))}]"


class TpuFilterExec(UnaryTpuExec):
    def __init__(self, condition: Expression, child: TpuExec, conf=None):
        super().__init__([child], conf)
        self.condition = condition
        self._bound = bind_references(condition, child.output)

    def filter(self, batch: ColumnarBatch):
        """(the batch's rows that pass, its ANSI errors)."""
        ctx = device_ctx(batch, self.conf.is_ansi)
        vecs = batch_vecs(batch)
        pred = self._bound.eval(ctx, vecs)
        keep = pred.data & pred.validity & ctx.row_mask
        out_vecs, new_n = compact_vecs(vecs, keep)
        return vecs_to_batch(batch.schema, out_vecs, new_n), ctx.errors

    def do_execute(self):
        for b in self.child.execute():
            out, errors = self.filter(b)
            check_errors(errors)
            yield out

    def _arg_string(self):
        return f"[{self.condition!r}]"


class TpuExpandExec(UnaryTpuExec):
    """Several projections of each input row (the building block of
    ROLLUP and CUBE): one output batch per projection per input batch, at
    the input's capacity. The projections share one evaluation context,
    whose ANSI errors are read once per input batch before any of its
    outputs leaves (JAX `TpuExpandExec`)."""

    def __init__(self, projections, names, child: TpuExec, conf=None):
        super().__init__([child], conf)
        self.projections = [list(p) for p in projections]
        self._bound = [[bind_references(e, child.output) for e in p]
                       for p in self.projections]
        self._schema = Schema(tuple(names),
                              tuple(e.data_type for e in self._bound[0]))

    @property
    def output(self) -> Schema:
        return self._schema

    def expand(self, batch: ColumnarBatch):
        """(one batch per projection, their ANSI errors)."""
        ctx = device_ctx(batch, self.conf.is_ansi)
        vecs = batch_vecs(batch)
        return [vecs_to_batch(self._schema, [e.eval(ctx, vecs) for e in p],
                              batch.num_rows)
                for p in self._bound], ctx.errors

    def do_execute(self):
        for b in self.child.execute():
            outs, errors = self.expand(b)
            check_errors(errors)
            yield from outs

    def _arg_string(self):
        return f"[{len(self.projections)} projections, " \
            f"{list(self._schema.names)}]"


class TpuUnionExec(TpuExec):
    """Every child's batches, child after child."""

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def do_execute(self):
        for c in self.children:
            yield from c.execute()


class TpuLimitExec(UnaryTpuExec):
    """Local+global limit with offset (reference `limit.scala`): the first
    `limit` rows after `offset`, batch by batch. It reads each batch's row
    count on the host, and stops pulling once the limit is met."""

    def __init__(self, limit: int, child: TpuExec, offset: int = 0, conf=None):
        super().__init__([child], conf)
        self.limit = limit
        self.offset = offset

    def do_execute(self):
        remaining = self.limit
        skip = self.offset
        for b in self.child.execute():
            if remaining <= 0:
                break
            n = b.row_count()
            start = min(skip, n)
            skip -= start
            take = min(remaining, n - start)
            if take <= 0:
                continue
            if start == 0:
                out = ColumnarBatch(b.schema, b.columns, torch.as_tensor(
                    take, dtype=torch.int32, device=b.device))
            else:
                out = vecs_to_batch(b.schema, [v.gather(slice(start, None))
                                               for v in batch_vecs(b)], take)
            remaining -= take
            yield out

    def _arg_string(self):
        return f"[{self.limit}]"


class TpuSampleExec(UnaryTpuExec):
    """Bernoulli sample without replacement (JAX `TpuSampleExec`): row i
    of the stream is kept by `sample_mask` of its global ordinal, which
    rides across batches as a device scalar, so no batch is read back."""

    def __init__(self, fraction: float, seed: int, child: TpuExec, conf=None):
        super().__init__([child], conf)
        self.fraction = float(fraction)
        self.seed = int(seed)

    def do_execute(self):
        offset = None
        for b in self.child.execute():
            if offset is None:
                offset = torch.zeros((), dtype=torch.int64, device=b.device)
            keep = sample_mask(b.capacity, offset, self.fraction, self.seed,
                               b.device) & b.row_mask()
            offset = offset + b.num_rows.to(torch.int64)
            out_vecs, n = compact_vecs(batch_vecs(b), keep)
            yield vecs_to_batch(b.schema, out_vecs, n)

    def _arg_string(self):
        return f"[fraction={self.fraction}, seed={self.seed}]"
