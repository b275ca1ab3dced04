"""Scan, project, filter, union and limit execs
(`spark_rapids_tpu/exec/basic.py`). Project and filter return each batch
with the ANSI errors of its expressions; run alone, they read those once
a batch (exec/base.py `check_errors`), and in a fused stage the stage
reads them (exec/fused.py)."""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.batch import ColumnarBatch, Schema, batch_from_arrow
from ..expr.base import Expression, bind_references, output_name
from ..ops.rowops import compact_vecs
from .base import (TpuExec, UnaryTpuExec, batch_vecs, check_errors,
                   device_ctx, vecs_to_batch)

__all__ = ["TpuScanExec", "TpuProjectExec", "TpuFilterExec", "TpuUnionExec",
           "TpuLimitExec"]


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
