"""Hash aggregate exec (`spark_rapids_tpu/exec/aggregate.py`).

Grouping is sort-by-keys + boundary detection + segmented reductions. One
input batch aggregates in one pass; several are aggregated per batch into
partial buffers, merged pairwise, and finalised, which is the JAX engine's
merge-pass structure, with its memory seams: one batch runs under
`with_retry_no_split_spillable` and goes to the merge passes on
SplitAndRetryOOM; the first pass runs under `with_retry` with
`split_batch_halves`, the pending partials wait parked spillable, and each
pairwise merge reserves the pair's bytes. Two departures from the JAX
exec: every parked input and pair is closed once its pass is done (the
JAX merge passes leave them in the spill catalog), and merge passes that
can no longer shrink the pending partials (each pair split under the
budget) raise SplitAndRetryOOM where the JAX loop runs forever. Every
aggregate of the JAX `_agg_one` is carried: Sum, Count, Min, Max, Average,
First/Last, the variance family, CountIf, BoolAnd/BoolOr, the bit
aggregates and Skewness/Kurtosis; the single-pass ones (CollectList,
CollectSet, ApproximatePercentile) are refused at plan time.

Decimals: a Sum whose result or input passes 18 digits is a 128-bit sum of
four 32-bit chunks (`_sum_decimal`); Min and Max over limbs take two
ordered passes (`_minmax_dec128`); the Average's sum is exact in int64 or
limbs and its mean is rounded HALF_UP at scale s + 4 (`_decimal_mean`,
`_decimal_mean128`). Every int64 sum goes through ops.rowops, so under
fusion the int64 kernel of ops/pallas_groupby.py serves it. Min and Max
over DOUBLE and FLOAT follow Spark's order: NaN is the greatest value
(ops/rowops.segment_reduce). Min and Max over strings take each group's
first row in string order (`_minmax_string`). Group keys may be strings or
128-bit decimals: they sort by packed words or limbs
(ops/rowops.sort_keys_for).

Modes, as in the JAX engine: complete (raw rows -> final values), partial
(raw rows -> partial buffers, one output per input batch, no merge across
batches) and final (partial buffers -> final values). The distribution pass
(exec/requirements.py) splits a grouped aggregate into partial ->
key-exchange -> final; that final side has `partitioned_input`, so groups
are disjoint across its input batches and it finalises each shard alone.
A final side over input that is not key-partitioned has no caller yet and
raises.

ANSI: the group keys and aggregate inputs report their errors, and an
integral Sum (raw rows, merge passes and the final side alike) checks its
int64 accumulator: a plain f64 sum beside it tracks the true magnitude,
and a gap over 2^62 means the int64 sum wrapped (JAX `_agg_one`). The f64
shadow takes `segment_sum` itself, never the fused int64 kernel, so the
kernel's launches are those of the same query without ANSI. A complete
aggregate yields only after its last pass, so it reads the flags of all
its passes once, in pass order; the partial and final sides read them once
a batch.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema, empty_batch
from ..columnar.column import torch_dtype
from ..expr import decimal128 as D
from ..expr.aggregates import (AggregateFunction, Average, BoolAnd, BoolOr,
                               Count, CountIf, First, Last, Max, Min,
                               Skewness, Sum, _BitAgg, _MomentFamily,
                               _VarianceFamily)
from ..errors import SplitAndRetryOOM
from ..expr.base import (EvalContext, Expression, Vec, ansi_raise,
                         bind_references, output_name)
from ..memory.budget import MemoryBudget
from ..memory.retry import (split_batch_halves, with_retry,
                            with_retry_no_split_spillable)
from ..memory.spillable import SpillableColumnarBatch
from ..ops.rowops import (compact_vecs, gather_vecs, group_ids_from_sorted,
                          lexsort_indices, segment_reduce, segment_sum,
                          sort_keys_for)
from ..plan.nodes import AggExpr
from .base import (UnaryTpuExec, TpuExec, batch_vecs, check_errors,
                   device_ctx, vecs_to_batch)
from .coalesce import concat_batches

__all__ = ["TpuHashAggregateExec", "SUPPORTED_AGGREGATES"]

SUPPORTED_AGGREGATES = (Sum, Count, Min, Max, Average, First, Last,
                        _VarianceFamily, CountIf, BoolAnd, BoolOr, _BitAgg,
                        _MomentFamily)


def _decimal_mean(s: torch.Tensor, c: torch.Tensor, extra: int
                  ) -> torch.Tensor:
    """Exact mean of unscaled int64 sums `s` over counts `c`, rounded
    HALF_UP (on the magnitude) at `extra` more digits of scale, in int64:
    q, r = divmod(|s|, n), then q * 10^extra + round(r * 10^extra / n).
    With r < n, 2 * r * 10^extra + n stays inside int64 for any count
    below 4.6 * 10^14 (extra <= 4)."""
    n = torch.clamp(c, min=1)
    m = s.abs()
    q = torch.div(m, n, rounding_mode="floor")
    r = m - q * n
    unit = 10 ** extra
    frac = torch.div(2 * r * unit + n, 2 * n, rounding_mode="floor")
    out = q * unit + frac
    return torch.where(s < 0, -out, out)


# a count below this divides a 128-bit sum in four 32-bit limb steps
_SMALL_DIVISOR = 1 << 31


def _decimal_mean128(hi, lo, c, extra: int, precision: int):
    """Exact mean of 128-bit unscaled sums over int64 counts, rounded
    HALF_UP on the magnitude at `extra` more digits of scale: q, r =
    divmod(|s|, n), then q * 10^extra + round(r * 10^extra / n), the
    product in the 256-bit chain. Returns (hi, lo, ok), ok False where the
    mean passes `precision` digits. The JAX engine sums in f64 here
    (ROADMAP "Known differences")."""
    n = torch.clamp(c, min=1)
    small = not bool((n >= _SMALL_DIVISOR).any())  # one host read
    mhi, mlo, neg = D.abs128(hi, lo)
    qhi, qlo, r = D.divmod_rows(mhi, mlo, n, small)
    rhi, rlo = D.mul_pow10(torch.zeros_like(r), r, extra)
    _, fq, fr = D.divmod_rows(rhi, rlo, n, small)
    frac = fq + (fr >= n - fr).to(torch.int64)  # 2 * fr >= n, no overflow
    w = D.wide_add(D.wide_mul_pow10(D.wide_from128(qhi, qlo), extra),
                   D.wide_from128(torch.zeros_like(frac), frac))
    ohi, olo, fits = D.wide_to128(w)
    nhi, nlo = D.neg128(ohi, olo)
    ohi, olo = torch.where(neg, nhi, ohi), torch.where(neg, nlo, olo)
    return ohi, olo, fits & D.in_bounds(ohi, olo, precision)


def _seg_extreme_2d(op: str, data: torch.Tensor, gid: torch.Tensor,
                    cap: int, neutral: int) -> torch.Tensor:
    """Per-group column-wise min/max of a [cap, k] matrix (rows outside
    [0, cap) to a spare slot that is cut off)."""
    idx = torch.where((gid >= 0) & (gid < cap), gid, cap).to(torch.int64)
    out = torch.full((cap + 1, data.shape[1]), neutral, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, idx[:, None].expand(-1, data.shape[1]),
                               data, "amin" if op == "min" else "amax")[:cap]


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
                    "spark_rapids_tpu_torch yet")
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
                  output_partial: bool = False):
        """One aggregation pass over one batch: raw rows or partial buffers
        in, final values or partial buffers out. Returns (the output batch,
        the pass's ANSI errors)."""
        ctx = device_ctx(batch, self.conf.is_ansi)
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
            out_vecs.extend(self._agg_one(ctx, a.func, sbufs[bi:bi + k], gid,
                                          cap, sorted_mask, input_partial,
                                          output_partial))
            bi += k
        schema = self._partial_schema if output_partial else \
            self._final_schema
        return vecs_to_batch(schema, out_vecs, ng), ctx.errors

    @staticmethod
    def _agg_one(ctx: EvalContext, func: AggregateFunction, bufs: List[Vec],
                 gid, cap: int, row_mask, merging: bool,
                 output_partial: bool) -> List[Vec]:
        """One aggregate's output: its partial buffers when output_partial,
        else its final value. `bufs` holds its partial buffers when
        merging, else its one input value (JAX `_agg_one`). Under ANSI an
        integral Sum reports its accumulator's wrap through `ctx`."""
        dev = row_mask.device

        def reduce(op, v: Vec, acc_dtype=None):
            data = v.data if acc_dtype is None else v.data.to(acc_dtype)
            return segment_reduce(op, data, gid, cap, v.validity & row_mask)

        def count(valid):  # int64 count of the rows where `valid`
            return segment_reduce("count", valid, gid, cap, valid & row_mask)

        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        v = bufs[0]
        if isinstance(func, Count):
            data = reduce("sum", v, torch.int64) if merging else \
                count(v.validity)
            return [Vec(T.LONG, data, ones)]
        if isinstance(func, Average):
            c = reduce("sum", bufs[1], torch.int64) if merging else \
                count(v.validity)
            if not isinstance(func.data_type, T.DecimalType):
                s = reduce("sum", v, torch.float64)
                if output_partial:
                    return [Vec(T.DOUBLE, s, c > 0), Vec(T.LONG, c, ones)]
                return [Vec(T.DOUBLE, s / torch.clamp(c, min=1), c > 0)]
            psum_t = func.partial_types()[0]
            total = _sum_decimal(v, psum_t, gid, cap, row_mask, c > 0)
            if output_partial:
                return [total, Vec(T.LONG, c, ones)]
            out_t = func.data_type
            extra = out_t.scale - psum_t.scale
            if total.data.dim() == 1:
                return [Vec(out_t, _decimal_mean(total.data, c, extra),
                            total.validity)]
            hi, lo, ok = _decimal_mean128(total.data[:, 0], total.data[:, 1],
                                          c, extra, out_t.precision)
            data = D.pack_limbs(hi, lo) if D.is_dec128(out_t) else lo
            return [Vec(out_t, data, total.validity & ok)]
        if isinstance(func, Sum):
            out_t = func.data_type
            if isinstance(out_t, T.DecimalType):
                return [_sum_decimal(v, out_t, gid, cap, row_mask)]
            acc = torch.float64 if T.is_floating(out_t) else torch.int64
            data, has = reduce("sum", v, acc), count(v.validity) > 0
            if ctx.ansi and T.is_integral(out_t):
                # a wrap is off by k * 2^64; the f64 sum's rounding stays
                # near 2^10 ulp, far under the 2^62 line
                valid = v.validity & row_mask
                fsum = segment_sum(torch.where(valid, v.data.to(
                    torch.float64), 0.0), gid, cap)
                wrapped = (fsum - data.to(torch.float64)).abs() > 2.0 ** 62
                ansi_raise(ctx, wrapped & has,
                           "[ARITHMETIC_OVERFLOW] long overflow",
                           masked=False)
            return [Vec(out_t, data, has)]
        if isinstance(func, (Min, Max)):
            op = "min" if isinstance(func, Min) else "max"
            if v.is_string:
                return [_minmax_string(op, v, gid, cap, row_mask)]
            if v.data.dim() == 2:
                return [_minmax_dec128(op, v, gid, cap, row_mask)]
            data = reduce(op, v)
            return [Vec(v.dtype, data.to(torch_dtype(v.dtype)),
                        count(v.validity) > 0)]
        if isinstance(func, (First, Last)):
            is_first = not isinstance(func, Last)
            valid = row_mask & (v.validity if func.ignore_nulls else ones)
            idx = torch.arange(cap, dtype=torch.int64, device=dev)
            sentinel = cap if is_first else -1
            pick = segment_reduce("min" if is_first else "max",
                                  torch.where(valid, idx, sentinel), gid, cap,
                                  row_mask)
            got = (pick != sentinel) & (pick >= 0)
            out = v.gather(torch.clamp(pick, 0, cap - 1))
            return [out.with_validity(out.validity & got)]
        if isinstance(func, _VarianceFamily):
            if merging:
                s = reduce("sum", v, torch.float64)
                s2 = reduce("sum", bufs[1], torch.float64)
                c = reduce("sum", bufs[2], torch.int64)
            else:
                x = v.data.to(torch.float64)
                s = reduce("sum", Vec(T.DOUBLE, x, v.validity))
                s2 = reduce("sum", Vec(T.DOUBLE, x * x, v.validity))
                c = count(v.validity)
            if output_partial:
                return [Vec(T.DOUBLE, s, c > 0), Vec(T.DOUBLE, s2, c > 0),
                        Vec(T.LONG, c, ones)]
            cf = c.to(torch.float64)
            mean = s / torch.clamp(cf, min=1.0)
            m2 = torch.clamp(s2 - cf * mean * mean, min=0.0)
            if func.sample:
                var, has = m2 / torch.clamp(cf - 1.0, min=1.0), c > 1
            else:
                var, has = m2 / torch.clamp(cf, min=1.0), c > 0
            return [Vec(T.DOUBLE, torch.sqrt(var) if func.sqrt else var,
                        has)]
        if isinstance(func, CountIf):
            if merging:
                return [Vec(T.LONG, reduce("sum", v, torch.int64), ones)]
            return [Vec(T.LONG, count(v.validity & v.data.to(torch.bool)),
                        ones)]
        if isinstance(func, (BoolAnd, BoolOr)):
            is_and = isinstance(func, BoolAnd)
            valid = v.validity & row_mask
            contrib = torch.where(valid, v.data.to(torch.int8),
                                  1 if is_and else 0).to(torch.int8)
            out = segment_reduce("min" if is_and else "max", contrib, gid,
                                 cap, row_mask)
            return [Vec(T.BOOLEAN, out.to(torch.bool), count(v.validity) > 0)]
        if isinstance(func, _BitAgg):
            return [_bit_agg(func, v, gid, cap, row_mask,
                             count(v.validity) > 0)]
        if isinstance(func, _MomentFamily):
            if merging:
                sums = [reduce("sum", b, torch.float64) for b in bufs[:4]]
                c = reduce("sum", bufs[4], torch.int64)
            else:
                x = v.data.to(torch.float64)
                sums = [reduce("sum", Vec(T.DOUBLE, x ** p, v.validity))
                        for p in (1, 2, 3, 4)]
                c = count(v.validity)
            if output_partial:
                return [Vec(T.DOUBLE, t, c > 0) for t in sums] + \
                    [Vec(T.LONG, c, ones)]
            return [Vec(T.DOUBLE, _moment(func, *sums, c), c > 0)]
        raise NotImplementedError(type(func).__name__)

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
                yield self._checked(self.aggregate(b, output_partial=True))
            return
        if self.mode == "final":
            # key-partitioned input: each shard finalises on its own
            for b in batches:
                if b.row_count() == 0:
                    continue
                yield self._checked(self.aggregate(b, input_partial=True))
            return
        if len(batches) == 1:
            try:
                out = with_retry_no_split_spillable(
                    batches[0], lambda b: self._checked(self.aggregate(b)))
            except SplitAndRetryOOM:
                # one batch too big for a single pass: the merge passes
                # split it
                yield self._multi_batch(batches)
                return
            yield out
            return
        yield self._multi_batch(batches)

    def _multi_batch(self, batches: List[ColumnarBatch]) -> ColumnarBatch:
        """Each batch into partial buffers (split under pressure), parked
        spillable, merged pairwise under the retry seam, then finalised
        (GpuHashAggregateIterator's merge passes). The ANSI flags of every
        pass are read once, in pass order, at the end."""
        errors = []
        pending: List[SpillableColumnarBatch] = []

        def first_pass(sp: SpillableColumnarBatch):
            b = sp.get_batch()
            MemoryBudget.get().reserve(0)  # pre-flight / injection point
            out = self.aggregate(b, output_partial=True)
            del b
            sp.close()
            return out

        def merge_pair(sp: SpillableColumnarBatch):
            b = sp.get_batch()
            nbytes = b.device_memory_size()
            MemoryBudget.get().reserve(nbytes)
            try:
                out = self.aggregate(b, input_partial=True,
                                     output_partial=True)
            finally:
                MemoryBudget.get().release(nbytes)
            del b
            sp.close()
            return out

        def passes(sp, fn):
            for out, errs in with_retry(sp, fn, split_batch_halves):
                errors.extend(errs)
                pending.append(SpillableColumnarBatch(out))

        try:
            while batches:
                passes(SpillableColumnarBatch(batches.pop(0)), first_pass)
            stalled = 0
            while len(pending) > 1:
                before = len(pending)
                a, c = pending.pop(0), pending.pop(0)
                try:
                    sp = SpillableColumnarBatch(concat_batches(
                        [a.get_batch(), c.get_batch()]))
                finally:
                    a.close()
                    c.close()
                passes(sp, merge_pair)
                # a merge split into halves leaves as many partials as it
                # took; once every partial has been through such a merge
                # the passes cannot finish under this budget (the JAX
                # loop would run forever)
                stalled = stalled + 1 if len(pending) >= before else 0
                if stalled > len(pending):
                    raise SplitAndRetryOOM(
                        "the aggregate's merge passes cannot shrink its "
                        f"{len(pending)} partial batches under the budget")
            last = pending.pop()
            result = last.get_batch()
            last.close()
        finally:
            for sp in pending:
                sp.close()
        out, errs = self.aggregate(result, input_partial=True)
        return self._checked((out, errors + errs))

    @staticmethod
    def _checked(result) -> ColumnarBatch:
        out, errors = result
        check_errors(errors)
        return out

    def _arg_string(self):
        return (f"[{self.mode}, keys={[repr(e) for e in self.group_exprs]}, "
                f"aggs={[a.name for a in self.aggs]}]")


def _sum_decimal(v: Vec, out_t: T.DecimalType, gid, cap: int,
                 row_mask, has=None) -> Vec:
    """Decimal Sum by group, null where a group has no valid row or its sum
    passes out_t's precision. A 64-bit result is an int64 sum; a 128-bit
    one (or a 128-bit input) sums four 32-bit chunks of each value as
    int64 sums (decimal128.sum_chunks, JAX `_sum_dec128` with its three
    43-bit chunks) and recombines them. Every chunk sum goes through
    ops.rowops.segment_reduce, so under a fused partial aggregate the
    int64 kernel serves it like any other int64 sum. `has` (the groups
    holding a valid row) is counted here unless the caller has it."""
    valid = v.validity & row_mask
    if has is None:
        has = segment_reduce("count", valid, gid, cap, valid) > 0
    if not D.is_dec128(out_t) and v.data.dim() == 1:
        data = segment_reduce("sum", v.data.to(torch.int64), gid, cap, valid)
        return Vec(out_t, data, has)
    hi, lo = D.widen_operand(v.data)
    sums = [segment_reduce("sum", chunk, gid, cap, valid)
            for chunk in D.sum_chunks(hi, lo)]
    shi, slo = D.sum_recombine(sums)
    ok = D.in_bounds(shi, slo, out_t.precision)
    data = D.pack_limbs(shi, slo) if D.is_dec128(out_t) else slo
    return Vec(out_t, data, has & ok)


def _minmax_dec128(op: str, v: Vec, gid, cap: int, row_mask) -> Vec:
    """128-bit extremum in two ordered passes (JAX `_minmax_dec128`): the
    group extreme of the high limb, then of the unsigned low limb among the
    rows holding that high limb."""
    valid = v.validity & row_mask
    hi, lo_key = D.cmp_keys(v.data[:, 0], v.data[:, 1])
    info = torch.iinfo(torch.int64)
    neutral = info.max if op == "min" else info.min
    h_ext = segment_reduce(op, torch.where(valid, hi, neutral), gid, cap,
                           row_mask)
    cand = valid & (hi == h_ext[gid.to(torch.int64).clamp(0, cap - 1)])
    l_ext = segment_reduce(op, torch.where(cand, lo_key, neutral), gid, cap,
                           row_mask)
    has = segment_reduce("count", valid, gid, cap, valid) > 0
    return Vec(v.dtype, D.pack_limbs(*D.cmp_keys(h_ext, l_ext)), has)


def _minmax_string(op: str, v: Vec, gid, cap: int, row_mask) -> Vec:
    """MIN/MAX over strings (JAX `_minmax_string`): order the rows by
    (group, null last, string ascending for MIN, descending for MAX) and
    take each group's first row."""
    valid = v.validity & row_mask
    order = lexsort_indices([[gid.to(torch.int32)],
                             [(~valid).to(torch.int8)],
                             sort_keys_for(v, op == "min", False)[1:]])
    sv = v.gather(order)
    sgid = gid[order]
    n = torch.arange(cap, dtype=torch.int64, device=gid.device)
    first = torch.ones(cap, dtype=torch.bool, device=gid.device)
    first[1:] = sgid[1:] != sgid[:-1]
    pick = segment_reduce("max", torch.where(first, n, -1), sgid, cap,
                          torch.ones_like(first))
    has = segment_reduce("count", valid[order], sgid, cap, valid[order]) > 0
    out = sv.gather(torch.clamp(pick, 0, cap - 1))
    return out.with_validity(has)


def _bit_agg(func, v: Vec, gid, cap: int, row_mask, has) -> Vec:
    """bit_and/bit_or/bit_xor by group: each value's bits as an int8
    matrix, reduced column-wise (min for AND, max for OR, sum mod 2 for
    XOR), then packed back (JAX `_BitAgg`)."""
    valid = (v.validity & row_mask)[:, None]
    nbits = v.data.element_size() * 8
    shifts = torch.arange(nbits, dtype=torch.int64, device=v.data.device)
    bits = ((v.data.to(torch.int64)[:, None] >> shifts) & 1).to(torch.int8)
    if func.op == "and":
        red = _seg_extreme_2d("min", torch.where(valid, bits, 1).to(
            torch.int8), gid, cap, 1)
    elif func.op == "or":
        red = _seg_extreme_2d("max", torch.where(valid, bits, 0).to(
            torch.int8), gid, cap, 0)
    else:
        red = segment_reduce("sum", bits.to(torch.int64), gid, cap,
                             valid[:, 0]) & 1
    val = (red.to(torch.int64) << shifts).sum(dim=1)
    return Vec(func.data_type, val.to(torch_dtype(func.data_type)), has)


def _moment(func, s1, s2, s3, s4, c):
    """Skewness or kurtosis from the power sums (JAX `_MomentFamily`): NaN
    where the second central moment is not positive."""
    cf = torch.clamp(c.to(torch.float64), min=1.0)
    mu = s1 / cf
    m2 = s2 - cf * mu * mu
    m3 = s3 - 3 * mu * s2 + 2 * cf * mu ** 3
    m4 = s4 - 4 * mu * s3 + 6 * mu * mu * s2 - 3 * cf * mu ** 4
    zero_var = m2 <= 0
    safe_m2 = torch.where(zero_var, 1.0, m2)
    if isinstance(func, Skewness):
        out = torch.sqrt(cf) * m3 / safe_m2 ** 1.5
    else:
        out = cf * m4 / (safe_m2 * safe_m2) - 3.0
    return torch.where(zero_var, float("nan"), out)
