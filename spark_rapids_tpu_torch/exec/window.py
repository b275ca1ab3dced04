"""Window exec (`spark_rapids_tpu/exec/window.py`; reference
`GpuWindowExec.scala`, `GpuWindowExpression.scala`).

Sort + flat segmented scans over one batch, as in the JAX exec:

  * all input is concatenated into one batch (a frame may span a whole
    partition) and its rows sorted by (partition keys, order keys),
    padding rows last;
  * partition and peer boundaries become flag vectors; every rank-family
    function is arithmetic over `cumsum`/`cummax` of those flags;
  * running frames (UNBOUNDED PRECEDING..CURRENT ROW) are segmented prefix
    scans: sum and count a global `cumsum` re-based at each segment start,
    min and max a segmented scan (`_seg_scan`, by doubling: the JAX exec's
    flagged `associative_scan`);
  * the Spark-default RANGE..CURRENT ROW frame gathers the running value at
    the row's last order peer;
  * bounded ROW frames and value-offset RANGE frames find each row's
    [lo, hi] index window (value offsets by a binary search inside the
    partition, `_search_value_range`), then take prefix-sum differences for
    sum/count/avg and a sparse table for min/max (`_range_minmax`).

The window runs under `with_retry_no_split_spillable`, as in the JAX exec:
memory pressure spills and reruns it, never splits it, since a row split
would sever partitions.

Every `jax.ops.segment_*` over `num_segments=cap` maps onto a scatter into
`cap` slots; padding rows carry the id `cap - 1`, which no live partition
reaches while a batch has padding.

Differences from the JAX exec:
  * MIN and MAX over DOUBLE and FLOAT follow Spark's order, as the port's
    aggregates do (ops/rowops.py): NaN is the greatest value, so a frame's
    max is NaN if it holds one and its min only if it holds nothing else.
    The JAX exec propagates NaN through both.
  * String MIN/MAX (running and whole-partition frames) reduce each row's
    rank among the batch's distinct strings, and gather the winning row's
    bytes, where the JAX exec scans byte matrices with a lexicographic
    combine. The results are the same strings.
  * First/Last frames pick each row's first/last index of its frame (its
    first/last valid index for IGNORE NULLS, by a search over the prefix
    count of valid rows) and gather it, as the JAX exec does; limbs and
    string rows gather whole, as in Lead, Lag and NthValue.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Iterator, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema
from ..expr.base import Expression, Literal, Vec, bind_references
from ..expr.conditional import _select
from ..expr.windowexprs import (CumeDist, DenseRank, Lag, Lead, NthValue,
                                NTile, PercentRank, RangeFrame, Rank,
                                RowFrame, RowNumber, WindowAggregate,
                                WindowFunction, bind_window_fn,
                                default_frame, is_value_range_frame)
from ..memory.retry import with_retry_no_split_spillable
from ..ops.rowops import (gather_vecs, key_change_flags, lexsort_indices,
                          segment_sum, sort_keys_for)
from .base import (TpuExec, UnaryTpuExec, batch_vecs, check_errors,
                   device_ctx, vecs_to_batch)
from .coalesce import concat_batches

__all__ = ["TpuWindowExec"]

# the sorted batch and its partition and peer structure
_WinEnv = SimpleNamespace

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def _changes(vecs: Sequence[Vec], mask: torch.Tensor) -> torch.Tensor:
    """Rows whose key differs from the previous row's (none without keys)."""
    if not vecs:
        return torch.zeros_like(mask)
    return key_change_flags(vecs, mask.shape[0])


def _seg_extreme(op: str, w: torch.Tensor, gid: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Per-row min/max of `w` over its whole segment (ids in [0, cap))."""
    neutral = _neutral(op, w.dtype)
    out = torch.full((cap,), neutral, dtype=w.dtype, device=w.device)
    out.scatter_reduce_(0, gid.to(torch.int64), w,
                        "amin" if op == "min" else "amax")
    return out[gid]


def _seg_scan(op: Callable, seg_start_idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive scan by doubling (Hillis-Steele): after the
    step of shift d, row i holds op over rows [max(seg_start, i-2d+1), i]."""
    cap = vals.shape[0]
    n = torch.arange(cap, device=vals.device)
    out = vals
    d = 1
    while d < cap:
        prev = torch.cat([out[:d], out[:-d]])
        out = torch.where(n - d >= seg_start_idx, op(out, prev), out)
        d <<= 1
    return out


def _running_sum(contrib: torch.Tensor,
                 seg_start_idx: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive prefix sum: a global cumsum re-based per
    segment."""
    c = torch.cumsum(contrib, dim=0)
    base = c[seg_start_idx] - contrib[seg_start_idx]
    return c - base


def _range_minmax(op: Callable, acc: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-row extremum over inclusive index windows [lo, hi] by a sparse
    table (range-minimum query): levels m[k][i] = op over acc[i ..
    i+2^k-1], then two gathers a row. The caller masks rows with hi < lo."""
    levels = [acc]
    k = 1
    while (1 << k) <= cap:
        prev = levels[-1]
        half = 1 << (k - 1)
        idx2 = torch.clamp(torch.arange(cap, device=acc.device) + half,
                           max=cap - 1)
        levels.append(op(prev, prev[idx2]))
        k += 1
    m = torch.stack(levels).reshape(-1)  # [L * cap]
    ln = torch.clamp(hi - lo + 1, min=1).to(torch.int64)
    # floor(log2(ln)), exactly: the count of powers of two <= ln, less one
    j = sum((ln >= (1 << b)).to(torch.int64) for b in range(len(levels))) - 1
    right = torch.clamp(hi.to(torch.int64) - torch.bitwise_left_shift(
        torch.ones_like(j), j) + 1, 0, cap - 1)
    lo_s = torch.clamp(lo.to(torch.int64), 0, cap - 1)
    return op(m[j * cap + lo_s], m[j * cap + right])


def _neutral(op: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _extreme(op: str, data: torch.Tensor, valid: torch.Tensor,
             reduce: Callable) -> torch.Tensor:
    """MIN/MAX through `reduce` (which maps per-row values, invalid rows
    already neutral, to per-row results). Booleans reduce as int32. Floats
    reduce NaN as +inf, and a second reduce of NaN flags marks the results
    that are NaN (Spark's order: NaN greatest)."""
    if data.dtype == torch.bool:
        return _extreme(op, data.to(torch.int32), valid, reduce).to(
            torch.bool)
    fill = torch.full((), _neutral(op, data.dtype), dtype=data.dtype,
                      device=data.device)
    if not data.is_floating_point():
        return reduce(torch.where(valid, data, fill))
    nan = torch.isnan(data)
    out = reduce(torch.where(valid, torch.where(nan, float("inf"), data),
                             fill))
    flag = reduce(torch.where(valid, nan.to(torch.int32),
                              1 if op == "min" else 0))
    return torch.where(flag == 1, float("nan"), out)


def _string_codes(v: Vec, n32: torch.Tensor) -> torch.Tensor:
    """int64 rank * cap + row of each row's string: ranks order the
    batch's distinct strings, so min/max over codes picks a row holding the
    min/max string."""
    cap = n32.shape[0]
    order = lexsort_indices([sort_keys_for(v)[1:]])
    s = v.gather(order)
    ones = torch.ones_like(v.validity)
    change = key_change_flags([Vec(v.dtype, s.data, ones, s.lengths)], cap)
    rank = torch.empty(cap, dtype=torch.int64, device=n32.device)
    rank[order] = torch.cumsum(change, dim=0, dtype=torch.int64)
    return rank * cap + n32.to(torch.int64)


def _search_value_range(env: _WinEnv, frame, key: Vec, ascending: bool,
                        nulls_first: bool):
    """Per-row inclusive [lo, hi] row indices of a value-offset RANGE frame.

    Rows are sorted by (partition, order key); on the sort axis the frame of
    row i is the run of rows whose key lies in [key_i+lower, key_i+upper]
    (descending order negates the key, which reduces to the same formula),
    found by a vectorized binary search over (partition id, key) that stays
    inside the row's partition. NULL-key rows never enter a value interval;
    a NULL current row frames exactly its null peer group."""
    cap = env.cap
    valid = key.validity & env.mask
    # widen BEFORE negating: negating in a narrow dtype wraps at its minimum
    kd = key.data
    kd = kd.to(torch.float64) if kd.is_floating_point() else \
        kd.to(torch.int64)
    if not ascending:
        kd = -kd
    # null rows hold garbage: replace them with the extreme matching their
    # sorted position so (gid, kd) stays monotone for the search; the
    # [first_valid, last_valid] clamp then drops them from every frame
    nulls_at_end = not nulls_first
    in_frame = valid
    if not kd.is_floating_point():
        kd = torch.where(valid, kd, _I64_MAX if nulls_at_end else _I64_MIN)
        lo_t = kd + frame.lower if frame.lower is not None else \
            torch.full_like(kd, _I64_MIN)
        hi_t = kd + frame.upper if frame.upper is not None else \
            torch.full_like(kd, _I64_MAX)
    else:
        inf = float("inf")
        kd = torch.where(valid, kd, inf if nulls_at_end else -inf)
        # targets first, from the unpinned key: a NaN current row gets an
        # empty frame ([+inf, -inf])
        lo_t = kd + frame.lower if frame.lower is not None else \
            torch.full_like(kd, -inf)
        hi_t = kd + frame.upper if frame.upper is not None else \
            torch.full_like(kd, inf)
        lo_t = torch.where(torch.isnan(lo_t), inf, lo_t)
        hi_t = torch.where(torch.isnan(hi_t), -inf, hi_t)
        # NaN keys sort to one end (greatest ascending, first descending)
        # and never satisfy a value interval: pin them to that end's
        # infinity and exclude them
        isnan = torch.isnan(kd)
        kd = torch.where(isnan, inf if ascending else -inf, kd)
        in_frame = in_frame & ~isnan
    gid, n32 = env.gid, env.n32
    first_valid = _seg_extreme("min", torch.where(in_frame, n32, cap), gid,
                               cap)
    last_valid = _seg_extreme("max", torch.where(in_frame, n32, -1), gid, cap)

    def search(target, strict: bool):
        """First index with (gid, key) at or after (gid_i, target): >= for
        strict=False, > for strict=True."""
        lo_b = torch.zeros(cap, dtype=torch.int32, device=gid.device)
        hi_b = torch.full((cap,), cap, dtype=torch.int32, device=gid.device)
        for _ in range(int(cap).bit_length()):
            mid = torch.div(lo_b + hi_b, 2, rounding_mode="floor")
            ms = torch.clamp(mid, 0, cap - 1)
            g, v = gid[ms], kd[ms]
            past = (v > target) if strict else (v >= target)
            after = ((g > gid) | ((g == gid) & past)) & (mid < cap)
            hi_b = torch.where(after, mid, hi_b)
            lo_b = torch.where(after, lo_b, mid + 1)
        return lo_b

    flo = torch.maximum(search(lo_t, strict=False), first_valid)
    fhi = torch.minimum(search(hi_t, strict=True) - 1, last_valid)
    # NULL current row: frame = its null peer group
    flo = torch.where(valid, flo, env.peer_start_idx)
    fhi = torch.where(valid, fhi, env.peer_end_idx)
    return flo, fhi


class TpuWindowExec(UnaryTpuExec):
    def __init__(self, window_exprs: Sequence[Tuple[WindowFunction, str]],
                 partition_spec: Sequence[Expression],
                 order_spec: Sequence[Tuple[Expression, bool, bool]],
                 child: TpuExec, conf=None):
        super().__init__([child], conf)
        self.window_exprs = list(window_exprs)
        self.partition_spec = list(partition_spec)
        self.order_spec = list(order_spec)
        schema = child.output
        self._bound_part = [bind_references(e, schema)
                            for e in self.partition_spec]
        self._bound_order = [(bind_references(e, schema), a, nf)
                             for e, a, nf in self.order_spec]
        self._bound_fns = [(bind_window_fn(f, schema), name)
                           for f, name in self.window_exprs]
        names = schema.names + tuple(n for _, n in self.window_exprs)
        tps = schema.types + tuple(f.data_type for f, _ in self._bound_fns)
        self._schema = Schema(names, tps)

    @property
    def output(self) -> Schema:
        return self._schema

    def window(self, batch: ColumnarBatch):
        """(the batch with its window columns, the ANSI errors of the
        partition and order keys and the functions' inputs)."""
        ctx = device_ctx(batch, self.conf.is_ansi)
        vecs = batch_vecs(batch)
        mask = ctx.row_mask
        cap = mask.shape[0]
        n32 = torch.arange(cap, dtype=torch.int32, device=mask.device)

        part_vecs = [e.eval(ctx, vecs) for e in self._bound_part]
        order_vecs = [(e.eval(ctx, vecs), a, nf)
                      for e, a, nf in self._bound_order]
        groups = [[(~mask).to(torch.int8)]]
        groups += [sort_keys_for(v, True, True) for v in part_vecs]
        groups += [sort_keys_for(v, a, nf) for v, a, nf in order_vecs]
        perm = lexsort_indices(groups)
        svecs = gather_vecs(vecs, perm)
        spart = gather_vecs(part_vecs, perm)
        sorder = gather_vecs([v for v, _, _ in order_vecs], perm)
        # padding sorted last: the mask keeps its first-n form

        part_start = (_changes(spart, mask) & mask) | ((n32 == 0) & mask)
        gid = torch.cumsum(part_start, dim=0, dtype=torch.int32) - 1
        gid = torch.where(mask, gid, cap - 1)
        seg_start_idx = _cummax(torch.where(part_start, n32, 0))
        seg_end_idx = _seg_extreme("max", n32, gid, cap)
        cnt = segment_sum(mask.to(torch.int64), gid, cap)[gid]

        peer_start = part_start | (_changes(sorder, mask) & mask)
        pgid = torch.cumsum(peer_start, dim=0, dtype=torch.int32) - 1
        pgid = torch.where(mask, pgid, cap - 1)
        peer_start_idx = _cummax(torch.where(peer_start, n32, 0))
        peer_end_idx = _seg_extreme("max", n32, pgid, cap)

        env = _WinEnv(
            ctx=ctx, svecs=svecs, mask=mask, cap=cap, n32=n32, gid=gid,
            seg_start_idx=seg_start_idx, seg_end_idx=seg_end_idx, cnt=cnt,
            pgid=pgid, peer_start_idx=peer_start_idx,
            peer_end_idx=peer_end_idx, has_order=bool(self.order_spec),
            sorder_keyvecs=sorder,  # the sorted order-key Vecs
            order_spec=[(a, nf) for _, a, nf in self._bound_order])
        out = list(svecs)
        for fn, _ in self._bound_fns:
            out.append(_eval_device(fn, env))
        return vecs_to_batch(self._schema, out, batch.num_rows), ctx.errors

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute())
        if not batches:
            return

        def run(b: ColumnarBatch) -> ColumnarBatch:
            out, errors = self.window(b)
            check_errors(errors)
            return out

        # the merged temporary is owned by the spillable wrapper alone
        holder = [batches]
        del batches
        yield with_retry_no_split_spillable(concat_batches(holder.pop()),
                                            run)

    def _arg_string(self):
        return (f"[{[n for _, n in self.window_exprs]}, "
                f"part={[repr(e) for e in self.partition_spec]}]")


def _eval_device(fn: WindowFunction, env: _WinEnv) -> Vec:
    ones = torch.ones_like(env.mask)
    rn = env.n32 - env.seg_start_idx + 1  # 1-based row_number
    if isinstance(fn, RowNumber):
        return Vec(T.INT, rn.to(torch.int32), ones)
    if isinstance(fn, Rank):
        rank = env.peer_start_idx - env.seg_start_idx + 1
        return Vec(T.INT, rank.to(torch.int32), ones)
    if isinstance(fn, DenseRank):
        dense = env.pgid - env.pgid[env.seg_start_idx] + 1
        return Vec(T.INT, dense.to(torch.int32), ones)
    if isinstance(fn, PercentRank):
        rank = (env.peer_start_idx - env.seg_start_idx + 1).to(torch.float64)
        denom = torch.clamp(env.cnt - 1, min=1).to(torch.float64)
        out = torch.where(env.cnt > 1, (rank - 1.0) / denom, 0.0)
        return Vec(T.DOUBLE, out, ones)
    if isinstance(fn, CumeDist):
        through = (env.peer_end_idx - env.seg_start_idx + 1) \
            .to(torch.float64)
        out = through / torch.clamp(env.cnt, min=1).to(torch.float64)
        return Vec(T.DOUBLE, out, ones)
    if isinstance(fn, NTile):
        nt = fn.buckets
        c = env.cnt
        q = torch.div(c, nt, rounding_mode="floor")
        r = c % nt
        rn0 = (rn - 1).to(torch.int64)
        small = r * (q + 1)
        bucket = torch.where(
            q == 0, rn0 + 1,
            torch.where(rn0 < small,
                        torch.div(rn0, torch.clamp(q + 1, min=1),
                                  rounding_mode="floor") + 1,
                        r + torch.div(rn0 - small, torch.clamp(q, min=1),
                                      rounding_mode="floor") + 1))
        return Vec(T.INT, bucket.to(torch.int32), ones)
    if isinstance(fn, (Lead, Lag)):
        v = fn.children[0].eval(env.ctx, env.svecs)
        off = fn.offset if isinstance(fn, Lead) else -fn.offset
        idx = env.n32 + off
        in_range = (idx >= 0) & (idx < env.cap)
        safe = torch.clamp(idx, 0, env.cap - 1)
        same = in_range & (env.gid[safe] == env.gid) & env.mask[safe]
        got = v.gather(safe)
        got = got.with_validity(got.validity & same)
        if fn.default is not None:
            dflt = Literal(fn.default, v.dtype).eval(env.ctx, env.svecs)
            got = _select(same, got, dflt)
        return got
    if isinstance(fn, NthValue):
        return _eval_device_nth(fn, env)
    if isinstance(fn, WindowAggregate):
        return _eval_device_agg(fn, env)
    raise NotImplementedError(type(fn).__name__)


def _eval_device_nth(fn: NthValue, env: _WinEnv) -> Vec:
    """nth_value: frame bounds + (for IGNORE NULLS) a searchsorted over the
    global prefix count of valid rows: the n-th valid index in [lo, hi] is
    where cumsum(valid) first reaches count_before(lo) + n."""
    v = fn.children[0].eval(env.ctx, env.svecs)
    frame = fn.frame or default_frame(env.has_order)
    lo, hi = _frame_bounds(frame, env)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    valid_rows = v.validity & env.mask
    if fn.ignore_nulls:
        p = torch.cumsum(valid_rows, dim=0, dtype=torch.int64)  # inclusive
        before = torch.where(lo > 0, p[torch.clamp(lo - 1, min=0)], 0)
        target = before + fn.n
        j = torch.searchsorted(p, target)
        got = (j < env.cap) & (j <= hi) & \
            (p[torch.clamp(j, 0, env.cap - 1)] == target)
    else:
        j = lo + fn.n - 1
        got = (j <= hi) & (j >= lo)
    out = v.gather(torch.clamp(j, 0, env.cap - 1))
    return out.with_validity(out.validity & got & (hi >= lo))


def _eval_device_agg(fn: WindowAggregate, env: _WinEnv) -> Vec:
    func = fn.func
    frame = fn.frame or default_frame(env.has_order)
    name = type(func).__name__
    v = func.child.eval(env.ctx, env.svecs) if func.child is not None \
        else None
    valid = (v.validity if v is not None else torch.ones_like(env.mask)) \
        & env.mask
    out_t = func.data_type
    gid, cap = env.gid, env.cap

    unbounded = frame.lower is None and frame.upper is None
    running_rows = isinstance(frame, RowFrame) and frame.lower is None and \
        frame.upper == 0
    running_range = isinstance(frame, RangeFrame) and \
        frame.lower is None and frame.upper == 0
    if name in ("First", "Last"):
        return _first_last(name, func, v, frame, env)
    is_string = v is not None and v.is_string
    vcount_all = segment_sum(valid.to(torch.int64), gid, cap)[gid]

    if name in ("Min", "Max"):
        op = name.lower()
        if unbounded:
            def reduce(w):
                return _seg_extreme(op, w, gid, cap)
            cnt = vcount_all
        elif running_rows or running_range:
            tfn = torch.minimum if op == "min" else torch.maximum
            at = env.peer_end_idx if running_range else None

            def reduce(w):
                run = _seg_scan(tfn, env.seg_start_idx, w)
                return run if at is None else run[at]
            cnt = _running_sum(valid.to(torch.int64), env.seg_start_idx)
            if at is not None:
                cnt = cnt[at]
        else:  # bounded frame (not over strings: the planner refuses it)
            lo, hi = _frame_bounds(frame, env)
            empty = hi < lo
            lo_s = torch.clamp(lo, 0, cap - 1)
            hi_s = torch.clamp(hi, 0, cap - 1)
            tfn = torch.minimum if op == "min" else torch.maximum

            def reduce(w):
                return _range_minmax(tfn, w, lo_s, hi_s, cap)
            cnt = _window_count(valid, lo_s, hi_s, empty)
        if is_string:
            code = _extreme(op, _string_codes(v, env.n32), valid, reduce)
            out = v.gather(torch.remainder(code, cap))
            return out.with_validity(cnt > 0)
        return Vec(v.dtype, _extreme(op, v.data, valid, reduce), cnt > 0)

    # Count, Sum, Average: the accumulated contribution of each row
    if name == "Count":
        acc = valid.to(torch.int64)
    elif name == "Sum":
        zero = torch.zeros((), dtype=v.data.dtype, device=v.data.device)
        acc = torch.where(valid, v.data, zero).to(
            torch.float64 if isinstance(out_t, T.DoubleType)
            else torch.int64)
    elif name == "Average":
        zero = torch.zeros((), dtype=v.data.dtype, device=v.data.device)
        acc = torch.where(valid, v.data, zero).to(torch.float64)
    else:
        raise NotImplementedError(f"{name} over a window")

    if unbounded:
        if name == "Count":
            return Vec(T.LONG, vcount_all, torch.ones_like(env.mask))
        total = segment_sum(acc, gid, cap)[gid]
        return _finish(name, out_t, total, vcount_all)
    if running_rows or running_range:
        run_cnt = _running_sum(valid.to(torch.int64), env.seg_start_idx)
        run = run_cnt if name == "Count" else \
            _running_sum(acc, env.seg_start_idx)
        if running_range:
            # the value through the last peer of the current row
            run = run[env.peer_end_idx]
            run_cnt = run_cnt[env.peer_end_idx]
        if name == "Count":
            return Vec(T.LONG, run, torch.ones_like(env.mask))
        return _finish(name, out_t, run, run_cnt)
    # bounded ROW frame or value-offset RANGE frame: prefix differences
    lo, hi = _frame_bounds(frame, env)
    empty = hi < lo
    lo_s = torch.clamp(lo, 0, cap - 1)
    hi_s = torch.clamp(hi, 0, cap - 1)
    wcnt = _window_count(valid, lo_s, hi_s, empty)
    if name == "Count":
        return Vec(T.LONG, wcnt, torch.ones_like(env.mask))
    p_acc = torch.cumsum(acc, dim=0)
    wsum = p_acc[hi_s] - p_acc[lo_s] + acc[lo_s]
    wsum = torch.where(empty, torch.zeros_like(wsum), wsum)
    return _finish(name, out_t, wsum, wcnt)


def _first_last(name: str, func, v: Vec, frame, env: _WinEnv) -> Vec:
    """First/Last over each row's frame [lo, hi] (JAX `_eval_device_agg`):
    the bound itself, or with IGNORE NULLS the first/last valid index in
    the frame, where the prefix count of valid rows first reaches its
    target."""
    lo, hi = _frame_bounds(frame, env)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    empty = hi < lo
    cap = env.cap
    if func.ignore_nulls:
        p = torch.cumsum(v.validity & env.mask, dim=0, dtype=torch.int64)
        before = torch.where(lo > 0, p[torch.clamp(lo - 1, min=0)], 0)
        in_frame = p[torch.clamp(hi, 0, cap - 1)] - before
        target = before + 1 if name == "First" else before + in_frame
        j = torch.searchsorted(p, target)
        got = (in_frame > 0) & ~empty
    else:
        j = lo if name == "First" else hi
        got = ~empty
    safe = torch.clamp(j, 0, cap - 1)
    out = v.gather(safe)
    return out.with_validity(out.validity & got & env.mask[safe])


def _window_count(valid, lo_s, hi_s, empty) -> torch.Tensor:
    """Valid rows in each [lo, hi] window (0 where it is empty)."""
    p_cnt = torch.cumsum(valid, dim=0, dtype=torch.int64)
    wcnt = p_cnt[hi_s] - p_cnt[lo_s] + valid[lo_s].to(torch.int64)
    return torch.where(empty, 0, wcnt)


def _finish(name: str, out_t, total: torch.Tensor, cnt: torch.Tensor) -> Vec:
    """A Sum (null over no valid row) or an Average (sum / count)."""
    if name == "Average":
        out = total / torch.clamp(cnt, min=1).to(torch.float64)
        return Vec(T.DOUBLE, out, cnt > 0)
    return Vec(out_t, total, cnt > 0)


def _frame_bounds(frame, env: _WinEnv):
    """Inclusive (lo, hi) row indices of the frame per row."""
    if isinstance(frame, RowFrame):
        lo = env.seg_start_idx if frame.lower is None else \
            torch.maximum(env.seg_start_idx, env.n32 + frame.lower)
        hi = env.seg_end_idx if frame.upper is None else \
            torch.minimum(env.seg_end_idx, env.n32 + frame.upper)
        return lo, hi
    assert isinstance(frame, RangeFrame)
    if not is_value_range_frame(frame):
        if frame.lower is None and frame.upper is None:
            return env.seg_start_idx, env.seg_end_idx
        return env.seg_start_idx, env.peer_end_idx  # UNBOUNDED..CURRENT ROW
    # value-offset RANGE frame (the planner guarantees one order column)
    ascending, nulls_first = env.order_spec[0]
    return _search_value_range(env, frame, env.sorder_keyvecs[0],
                               ascending, nulls_first)
