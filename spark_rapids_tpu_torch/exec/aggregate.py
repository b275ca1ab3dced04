"""Hash aggregate exec (`spark_rapids_tpu/exec/aggregate.py`).

Grouping is sort-by-keys + boundary detection + segmented reductions. One
input batch aggregates in one pass; several are aggregated per batch into
partial buffers, merged pairwise, and finalised, which is the JAX engine's
merge-pass structure (without its spill and OOM-retry machinery). Sum,
Count, Min and Max carry one partial buffer each; Average carries two, a
sum and a LONG count. Over a decimal both sums are exact int64 sums of the
unscaled values (so under fusion they run through the int64 kernel of
ops/pallas_groupby.py), and the average is the exact mean rounded HALF_UP
at scale s + 4 (`_decimal_mean`). Min and Max over DOUBLE and FLOAT follow
Spark's order: NaN is the greatest value (ops/rowops.segment_reduce).
Group keys may be strings: they sort by their packed words
(ops/rowops.sort_keys_for). MIN and MAX over strings wait for a later
slice and raise at plan time.

Modes, as in the JAX engine: complete (raw rows -> final values), partial
(raw rows -> partial buffers, one output per input batch, no merge across
batches) and final (partial buffers -> final values). The distribution pass
(exec/requirements.py) splits a grouped aggregate into partial ->
key-exchange -> final; that final side has `partitioned_input`, so groups
are disjoint across its input batches and it finalises each shard alone.
A final side over input that is not key-partitioned has no caller yet and
raises.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema, empty_batch
from ..columnar.column import torch_dtype
from ..expr.aggregates import AggregateFunction, Average, Count, Max, Min, \
    Sum
from ..expr.base import Expression, Vec, bind_references, output_name
from ..ops.rowops import (compact_vecs, gather_vecs, group_ids_from_sorted,
                          lexsort_indices, segment_reduce, sort_keys_for)
from ..plan.nodes import AggExpr
from .base import UnaryTpuExec, TpuExec, batch_vecs, device_ctx, vecs_to_batch
from .coalesce import concat_batches

__all__ = ["TpuHashAggregateExec", "SUPPORTED_AGGREGATES"]

SUPPORTED_AGGREGATES = (Sum, Count, Min, Max, Average)


# the digits an Average over a decimal adds to the scale (Spark: s + 4)
_AVG_EXTRA_SCALE = 4


def _decimal_mean(s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Exact mean of unscaled int64 sums `s` over counts `c`, rounded
    HALF_UP (on the magnitude) at 4 more digits of scale, in int64 without
    overflow: q, r = divmod(|s|, n), then q * 10^4 + round(r * 10^4 / n).
    r * 10^4 * 2 < 2 * n * 10^4 stays far inside int64."""
    n = torch.clamp(c, min=1)
    m = s.abs()
    q = torch.div(m, n, rounding_mode="floor")
    r = m - q * n
    unit = 10 ** _AVG_EXTRA_SCALE
    frac = torch.div(2 * r * unit + n, 2 * n, rounding_mode="floor")
    out = q * unit + frac
    return torch.where(s < 0, -out, out)


def _sorted_by_keys(key_vecs: List[Vec], all_vecs: List[Vec], row_mask):
    groups = [[(~row_mask).to(torch.int8)]]  # padding after every live row
    for kv in key_vecs:
        groups.append(sort_keys_for(kv))
    order = lexsort_indices(groups)
    return gather_vecs(all_vecs, order), row_mask[order]


class TpuHashAggregateExec(UnaryTpuExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 aggs: Sequence[AggExpr], child: TpuExec, conf=None,
                 mode: str = "complete", agg_bind_schema: Schema = None,
                 partitioned_input: bool = False):
        super().__init__([child], conf)
        if mode not in ("complete", "partial", "final"):
            raise ValueError(f"unknown aggregate mode {mode}")
        if mode == "final" and not (partitioned_input and group_exprs):
            raise NotImplementedError(
                "a final aggregate over input that is not key-partitioned "
                "is not supported by spark_rapids_tpu_torch yet")
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        # a final side reads partial buffers positionally; its expressions
        # bind against the schema below the partial side
        bind_schema = agg_bind_schema or child.output
        self.partitioned_input = partitioned_input
        self._bound_groups = [bind_references(e, bind_schema)
                              for e in self.group_exprs]
        self._bound_aggs = []
        for a in self.aggs:
            if not isinstance(a.func, SUPPORTED_AGGREGATES):
                raise NotImplementedError(
                    f"aggregate {type(a.func).__name__} is not supported by "
                    "spark_rapids_tpu_torch yet (sum, count, min, max, "
                    "average)")
            f = a.func
            if f.child is not None:
                f = f.with_children([bind_references(f.child, bind_schema)])
            self._bound_aggs.append(AggExpr(f, a.name))
        knames = [output_name(e, f"k{i}")
                  for i, e in enumerate(self.group_exprs)]
        ktypes = [e.data_type for e in self._bound_groups]
        self._final_schema = Schema(
            tuple(knames + [a.name for a in self._bound_aggs]),
            tuple(ktypes + [a.func.data_type for a in self._bound_aggs]))
        # the partial-buffer layout carried between merge passes and over
        # the exchange
        pnames, ptps = list(knames), list(ktypes)
        for a in self._bound_aggs:
            for j, pt in enumerate(a.func.partial_types()):
                pnames.append(f"{a.name}__p{j}")
                ptps.append(pt)
        self._partial_schema = Schema(tuple(pnames), tuple(ptps))
        self._schema = self._partial_schema if mode == "partial" else \
            self._final_schema

    @property
    def output(self) -> Schema:
        return self._schema

    def aggregate(self, batch: ColumnarBatch, input_partial: bool = False,
                  output_partial: bool = False) -> ColumnarBatch:
        """One aggregation pass over one batch: raw rows or partial buffers
        in, final values or partial buffers out."""
        ctx = device_ctx(batch)
        vecs = batch_vecs(batch)
        mask = ctx.row_mask
        cap = batch.capacity
        nk = len(self._bound_groups)
        if input_partial:  # keys, then each aggregate's partial buffers
            keys = list(vecs[:nk])
            buf_vecs = list(vecs[nk:])
        else:  # one value per aggregate (count(*) counts live rows)
            keys = [e.eval(ctx, vecs) for e in self._bound_groups]
            buf_vecs = [Vec(T.LONG, torch.ones(cap, dtype=torch.int64,
                                               device=mask.device), mask)
                        if a.func.child is None else
                        a.func.child.eval(ctx, vecs)
                        for a in self._bound_aggs]
        if keys:
            sorted_vecs, sorted_mask = _sorted_by_keys(keys, keys + buf_vecs,
                                                       mask)
            skeys, sbufs = sorted_vecs[:nk], sorted_vecs[nk:]
            gid, ng, starts = group_ids_from_sorted(skeys, sorted_mask)
        else:
            skeys, sbufs, sorted_mask = [], buf_vecs, mask
            gid = torch.zeros(cap, dtype=torch.int32, device=mask.device)
            ng = 1
            starts = torch.arange(cap, device=mask.device) == 0
        out_vecs: List[Vec] = []
        if skeys:  # representative key rows: group starts to the front
            out_vecs.extend(compact_vecs(skeys, starts)[0])
        bi = 0
        for a in self._bound_aggs:
            k = len(a.func.partial_types()) if input_partial else 1
            out_vecs.extend(self._agg_one(a.func, sbufs[bi:bi + k], gid, cap,
                                          sorted_mask, input_partial,
                                          output_partial))
            bi += k
        schema = self._partial_schema if output_partial else \
            self._final_schema
        return vecs_to_batch(schema, out_vecs, ng)

    @staticmethod
    def _agg_one(func: AggregateFunction, bufs: List[Vec], gid, cap: int,
                 row_mask, merging: bool, output_partial: bool) -> List[Vec]:
        """One aggregate's output: its partial buffers when output_partial,
        else its final value. `bufs` holds its partial buffers when
        merging, else its one input value."""
        def reduce(op, v: Vec, acc_dtype=None):
            data = v.data if acc_dtype is None else v.data.to(acc_dtype)
            return segment_reduce(op, data, gid, cap, v.validity & row_mask)

        def has(v: Vec):  # the group holds a valid row
            return reduce("count", v) > 0

        ones = torch.ones(cap, dtype=torch.bool, device=row_mask.device)
        v = bufs[0]
        if isinstance(func, Count):
            data = reduce("sum", v, torch.int64) if merging else \
                reduce("count", v)
            return [Vec(T.LONG, data, ones)]
        if isinstance(func, Average):
            decimal = isinstance(func.data_type, T.DecimalType)
            s = reduce("sum", v, torch.int64 if decimal else torch.float64)
            c = reduce("sum", bufs[1], torch.int64) if merging else \
                reduce("count", v)
            if output_partial:
                return [Vec(func.partial_types()[0], s, c > 0),
                        Vec(T.LONG, c, ones)]
            if decimal:
                return [Vec(func.data_type, _decimal_mean(s, c), c > 0)]
            return [Vec(T.DOUBLE, s / torch.clamp(c, min=1), c > 0)]
        if isinstance(func, Sum):
            out_t = func.data_type
            acc = torch.float64 if T.is_floating(out_t) else torch.int64
            data = reduce("sum", v, acc)
            return [Vec(out_t, data.to(torch_dtype(out_t)), has(v))]
        data = reduce("min" if isinstance(func, Min) else "max", v)
        return [Vec(v.dtype, data.to(torch_dtype(v.dtype)), has(v))]

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute())
        if not batches:
            if self.group_exprs or self.mode == "partial":
                # a partial side may emit nothing: the final side makes the
                # global aggregate's one row
                return
            # a global aggregate over no input still emits its one row
            batches = [empty_batch(self.child.output, self.device)]
        if self.mode == "partial":
            # map-side aggregation: one partial batch per input batch, no
            # merge across batches (that is the final side's work)
            for b in batches:
                if len(batches) > 1 and b.row_count() == 0:
                    continue
                yield self.aggregate(b, output_partial=True)
            return
        if self.mode == "final":
            # key-partitioned input: each shard finalises on its own
            for b in batches:
                if b.row_count() == 0:
                    continue
                yield self.aggregate(b, input_partial=True)
            return
        if len(batches) == 1:
            yield self.aggregate(batches[0])
            return
        pending = [self.aggregate(b, output_partial=True) for b in batches]
        while len(pending) > 1:
            pair = concat_batches([pending.pop(0), pending.pop(0)])
            pending.append(self.aggregate(pair, input_partial=True,
                                          output_partial=True))
        yield self.aggregate(pending[0], input_partial=True)

    def _arg_string(self):
        return (f"[{self.mode}, keys={[repr(e) for e in self.group_exprs]}, "
                f"aggs={[a.name for a in self.aggs]}]")
