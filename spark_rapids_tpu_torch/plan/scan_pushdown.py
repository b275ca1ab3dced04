"""Scan pushdown (`spark_rapids_tpu/plan/scan_pushdown.py`): compute on
the compressed data.

A planner pass over the converted device plan, behind
`spark.rapids.tpu.scan.pushdown.enabled`, folds
`TpuFileScanExec -> TpuFilterExec (-> TpuProjectExec ->
TpuHashAggregateExec)` chains into the scan:

  * the filter's conjuncts within the grammar (comparisons, IN and null
    tests of a scan column against literals, under AND/OR) move into the
    scan; the rest stay behind in a residual TpuFilterExec;
  * a projection of columns, renamed or not, becomes the scan's output
    mapping, so a column read only by the predicate is never
    materialised;
  * a global count/min/max/sum aggregate over scan columns becomes
    per-dispatch partials made in the decode, merged by a rewritten
    aggregate: exactly mergeable shapes only (integral sums; integral,
    boolean, date and timestamp min/max; any count), and never under ANSI.

The device parquet decode (io/parquet_device.py
`decode_row_groups_pushdown`) tests each pushed leaf once per dictionary
value and maps the verdict over the expanded indices and PLAIN streams,
then gathers only the surviving rows of the projected columns. Every
other decode path applies the same spec to its decoded batch through
`PushdownApplier`, which evaluates the pushed tree with the port's own
expression classes: a path that cannot evaluate on the compressed form is
never silently wrong. `prune_row_groups` drops row groups whose footer
statistics prove no row can pass, before any page is read.

Off, the pass is one conf read and no scan carries any pushdown state
(`TpuFileScanExec.pushed` is a class attribute, None).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch, Schema
from ..columnar.column import Column, torch_dtype
from ..columnar.padding import row_bucket
from ..expr import base as EB
from ..expr import nullexprs as EN
from ..expr import predicates as EP

__all__ = ["ScanPushdown", "PushedAgg", "PushdownApplier", "DevicePushdown",
           "apply_scan_pushdown", "install_pushdown", "prune_row_groups",
           "reduce_partial", "KEY_ENABLED", "KEY_AGG", "KEY_ROWGROUP"]

KEY_ENABLED = "spark.rapids.tpu.scan.pushdown.enabled"
KEY_AGG = "spark.rapids.tpu.scan.pushdown.aggregate.enabled"
KEY_ROWGROUP = "spark.rapids.tpu.scan.pushdown.rowgroup.enabled"


@dataclasses.dataclass(frozen=True)
class PushedAgg:
    """One pushed global aggregate: `op` count, min, max or sum over
    `column` (None for count(*)); `name` is its partial column's name in
    the scan output."""
    op: str
    column: Optional[str]
    name: str


@dataclasses.dataclass
class ScanPushdown:
    """What the planner pushed into one file scan. `predicate` is over the
    scan's raw column names (unbound AttributeReferences); `columns` maps
    (output name, source column) for a pushed projection (None: the raw
    schema); non-empty `aggs` makes the scan a producer of partial
    aggregates. The repr names every parameter, so two scans that differ
    only in what they pushed never print alike."""
    predicate: Optional[EB.Expression]
    columns: Optional[Tuple[Tuple[str, str], ...]] = None
    aggs: Tuple[PushedAgg, ...] = ()

    def output_schema(self, scan_schema: Schema) -> Schema:
        if self.aggs:
            return Schema(tuple(a.name for a in self.aggs),
                          tuple(_partial_type(a, scan_schema)
                                for a in self.aggs))
        if self.columns is not None:
            return Schema(tuple(o for o, _ in self.columns),
                          tuple(scan_schema.types[scan_schema.index_of(s)]
                                for _, s in self.columns))
        return scan_schema


def _partial_type(a: PushedAgg, schema: Schema) -> T.DataType:
    if a.op in ("count", "sum"):  # integral sums widen to LONG
        return T.LONG
    return schema.types[schema.index_of(a.column)]


# -- the predicate grammar ----------------------------------------------------

_CMP_CLASSES = (EP.EqualTo, EP.LessThan, EP.LessThanOrEqual, EP.GreaterThan,
                EP.GreaterThanOrEqual)


def split_conjuncts(e: EB.Expression) -> List[EB.Expression]:
    if isinstance(e, EP.And):
        return split_conjuncts(e.children[0]) + split_conjuncts(e.children[1])
    return [e]


def _and_combine(conjs: Sequence[EB.Expression]) -> EB.Expression:
    out = conjs[0]
    for c in conjs[1:]:
        out = EP.And(out, c)
    return out


def _leaf_column(e: EB.Expression, schema: Schema) -> Optional[str]:
    """The scan column a supported leaf tests, or None."""
    if isinstance(e, (EN.IsNull, EN.IsNotNull)):
        c = e.children[0]
        if isinstance(c, EB.AttributeReference) and \
                c.col_name in schema.names:
            return c.col_name
        return None
    if isinstance(e, EP.In):
        c = e.children[0]
        if not (isinstance(c, EB.AttributeReference)
                and c.col_name in schema.names):
            return None
        if not all(i is None or isinstance(i, (bool, int, float, str))
                   or type(i).__name__ == "Decimal" for i in e.items):
            return None
        return c.col_name
    if isinstance(e, _CMP_CLASSES):
        lhs, rhs = e.children
        attr, lit = (lhs, rhs) if isinstance(lhs, EB.AttributeReference) \
            else (rhs, lhs)
        if not (isinstance(attr, EB.AttributeReference)
                and isinstance(lit, EB.Literal)
                and attr.col_name in schema.names):
            return None
        if lit.value is None:
            # a comparison with a null literal is null on every row: the
            # filter keeps nothing, which the engine computes as it is
            return None
        return attr.col_name
    return None


def _pushable_pred(e: EB.Expression, schema: Schema) -> bool:
    """The whole subtree is in the grammar over scan columns."""
    if isinstance(e, (EP.And, EP.Or)):
        return _pushable_pred(e.children[0], schema) and \
            _pushable_pred(e.children[1], schema)
    return _leaf_column(e, schema) is not None


def _remap_attrs(e: EB.Expression, mapping) -> EB.Expression:
    """Rename columns through a pushed projection's (out, src) mapping:
    a filter above a folded projection names the projection's outputs,
    the scan's predicate its sources."""
    by_out = {}
    for o, s in mapping:
        by_out.setdefault(o, s)  # a repeated output: the first, as index_of

    def fn(node):
        if isinstance(node, EB.AttributeReference) and \
                node.col_name in by_out:
            return EB.AttributeReference(by_out[node.col_name],
                                         node._dtype, node._nullable)
        return node

    return e.transform_up(fn)


# -- the planner pass ---------------------------------------------------------

def apply_scan_pushdown(root, conf):
    """Overrides.apply's hook, after conversion and before the
    distribution and fusion passes. Off it returns the tree untouched."""
    if root is None or not conf.get(KEY_ENABLED):
        return root
    return _walk(root, conf)


def _walk(node, conf):
    """Rewrite every device subtree, bottom up: under a host root and
    inside both bridges too."""
    from ..exec.aggregate import TpuHashAggregateExec
    from ..exec.basic import TpuFilterExec, TpuProjectExec
    from ..exec.transitions import CpuFromTpuExec, TpuFromCpuExec
    if isinstance(node, CpuFromTpuExec):
        node.tpu_exec = _walk(node.tpu_exec, conf)
        return node
    if isinstance(node, TpuFromCpuExec):
        node.cpu_plan = _walk(node.cpu_plan, conf)
        return node
    if node.children:
        node.children = [_walk(c, conf) for c in node.children]
    out = None
    if isinstance(node, TpuFilterExec):
        out = _try_filter_pushdown(node)
    elif isinstance(node, TpuProjectExec):
        out = _try_project_pushdown(node)
    elif isinstance(node, TpuHashAggregateExec):
        out = _try_agg_pushdown(node, conf)
    return node if out is None else out


def _file_scan(node):
    from ..io.scanbase import TpuFileScanExec
    return node if isinstance(node, TpuFileScanExec) and \
        node.cpu_scan.format_name == "parquet" else None


def install_pushdown(scan, spec: ScanPushdown) -> None:
    """Give a scan its (new) pushed spec and, the first time, its pushdown
    metrics (JAX rowsPruned, bytesMaterialized, rowgroupsPruned)."""
    scan.pushed = spec
    scan._pushed_schema = spec.output_schema(scan.cpu_scan.output)
    scan._pd_applier = None
    scan._pd_device = None
    if not hasattr(scan, "rows_pruned"):
        scan.rows_pruned = 0
        scan.bytes_materialized = 0
        scan.rowgroups_pruned = 0


def _try_filter_pushdown(f):
    scan = _file_scan(f.children[0])
    if scan is None:
        return None
    cur = scan.pushed
    if cur is not None and cur.aggs:
        return None
    raw = scan.cpu_scan.output
    conjs = split_conjuncts(f.condition)
    # a folded projection renamed the scan's output: the pushed part runs
    # before it, over source names; the residual keeps its own names
    remapped = conjs if cur is None or cur.columns is None else \
        [_remap_attrs(c, cur.columns) for c in conjs]
    ok = [_pushable_pred(rc, raw) for rc in remapped]
    if not any(ok):
        return None
    pred = _and_combine([rc for rc, k in zip(remapped, ok) if k])
    if cur is not None and cur.predicate is not None:
        pred = EP.And(cur.predicate, pred)
    install_pushdown(scan, ScanPushdown(
        pred, cur.columns if cur is not None else None))
    residual = [c for c, k in zip(conjs, ok) if not k]
    if residual:
        from ..exec.basic import TpuFilterExec
        return TpuFilterExec(_and_combine(residual), scan, f.conf)
    return scan


def _try_project_pushdown(p):
    scan = _file_scan(p.children[0])
    if scan is None:
        return None
    cur = scan.pushed
    if cur is not None and (cur.columns is not None or cur.aggs):
        return None
    raw = scan.cpu_scan.output
    mapping = []
    for e in p.exprs:
        src = e.children[0] if isinstance(e, EB.Alias) else e
        if not isinstance(src, EB.AttributeReference) or \
                src.col_name not in raw.names:
            return None
        mapping.append((EB.output_name(e, src.col_name), src.col_name))
    install_pushdown(scan, ScanPushdown(
        cur.predicate if cur is not None else None, tuple(mapping)))
    return scan


_AGG_MINMAX_OK = (T.IntegralType, T.BooleanType, T.DateType, T.TimestampType)


def _try_agg_pushdown(agg, conf):
    from ..expr.aggregates import Count, Max, Min, Sum
    if agg.mode != "complete" or agg.group_exprs:
        return None
    if not conf.get(KEY_AGG) or conf.is_ansi:
        return None  # an ANSI sum must raise where a partial would wrap
    scan = _file_scan(agg.children[0])
    if scan is None:
        return None
    cur = scan.pushed
    if cur is not None and cur.aggs:
        return None
    raw = scan.cpu_scan.output
    out_names = scan.output.names
    mapping = None
    if cur is not None and cur.columns is not None:
        mapping = {}
        for o, s in cur.columns:
            mapping.setdefault(o, s)
    pushed: List[PushedAgg] = []
    for i, a in enumerate(agg.aggs):
        fn = a.func
        if type(fn) not in (Count, Min, Max, Sum):
            return None
        if fn.child is None:
            if not isinstance(fn, Count):
                return None
            pushed.append(PushedAgg("count", None, f"{a.name}__sp{i}"))
            continue
        if not isinstance(fn.child, EB.AttributeReference) or \
                fn.child.col_name not in out_names:
            return None
        src = fn.child.col_name if mapping is None else \
            mapping[fn.child.col_name]
        dt = raw.types[raw.index_of(src)]
        if isinstance(fn, Count):
            op = "count"
        elif isinstance(fn, Sum):
            if not T.is_integral(dt):
                return None  # floating and decimal sums stay unpushed
            op = "sum"
        else:
            if not isinstance(dt, _AGG_MINMAX_OK):
                return None
            op = "min" if isinstance(fn, Min) else "max"
        pushed.append(PushedAgg(op, src, f"{a.name}__sp{i}"))
    install_pushdown(scan, ScanPushdown(
        cur.predicate if cur is not None else None, None, tuple(pushed)))
    # the merge: counts and sums add (integers: exactly), min/max of the
    # partials; the output's names and types are the original aggregate's
    from ..exec.aggregate import TpuHashAggregateExec
    from .nodes import AggExpr
    merged = [AggExpr({"count": Sum, "sum": Sum, "min": Min,
                       "max": Max}[p.op](EB.AttributeReference(p.name)),
                      a.name) for a, p in zip(agg.aggs, pushed)]
    return TpuHashAggregateExec([], merged, scan, agg.conf, mode="complete")


# -- the exact batch applier --------------------------------------------------

class PushdownApplier:
    """A pushed spec applied to a decoded batch with the port's own
    expression classes: the unpushed filter, projection and aggregate by
    construction. `apply` reads the kept row count (and any ANSI flags)
    in one host copy, as the JAX applier reads its count."""

    def __init__(self, scan_schema: Schema, spec: ScanPushdown, conf):
        self.scan_schema = scan_schema
        self.spec = spec
        self.conf = conf
        self.out_schema = spec.output_schema(scan_schema)
        self._bound = None if spec.predicate is None else \
            EB.bind_references(spec.predicate, scan_schema)
        self._src = [scan_schema.index_of(s) for _, s in spec.columns] \
            if spec.columns is not None else list(range(len(scan_schema)))

    def keep_mask(self, batch: ColumnarBatch):
        """(bool[cap] rows that pass, the evaluation's ANSI errors)."""
        from ..exec.base import batch_vecs, device_ctx
        ctx = device_ctx(batch, self.conf.is_ansi)
        keep = batch.row_mask()
        if self._bound is not None:
            pred = self._bound.eval(ctx, batch_vecs(batch))
            keep = pred.data & pred.validity & keep
        return keep, ctx.errors

    def apply(self, batch: ColumnarBatch):
        """-> (the pushed output batch, the kept row count)."""
        from ..exec.base import batch_vecs, check_errors, vecs_to_batch
        from ..ops.rowops import compact_vecs
        keep, errors = self.keep_mask(batch)
        vecs = batch_vecs(batch)
        kept_t = keep.sum(dtype=torch.int64)
        if self.spec.aggs:
            out = self.partials(
                [_agg_partial(a, self.scan_schema, vecs, keep)
                 for a in self.spec.aggs], batch.device)
        else:
            sel, n = compact_vecs([vecs[i] for i in self._src], keep)
            out = vecs_to_batch(self.out_schema, sel, n)
        kept, = check_errors(errors, [kept_t])
        return out, kept

    def partials(self, values, device) -> ColumnarBatch:
        """The one-row batch of the partials' (value, valid) pairs."""
        cap1 = row_bucket(1)
        cols = []
        for (val, valid), dt in zip(values, self.out_schema.types):
            data = torch.zeros(cap1, dtype=torch_dtype(dt), device=device)
            data[0] = val.to(data.dtype)
            validity = torch.zeros(cap1, dtype=torch.bool, device=device)
            validity[0] = valid
            cols.append(Column(dt, data, validity))
        return ColumnarBatch(self.out_schema, tuple(cols), torch.ones(
            (), dtype=torch.int32, device=device))

    def empty_partials(self, device) -> ColumnarBatch:
        """The partial row of a scan that decoded nothing (an empty file,
        every row group pruned): counts 0, min/max/sum null, the unpushed
        plan's answer over no rows."""
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return self.partials([(zero, a.op == "count")
                              for a in self.spec.aggs], device)


def _minmax_sentinel(dtype: torch.dtype, op: str):
    if dtype == torch.bool:
        return op == "min"  # min never below True, max never above False
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _agg_partial(a: PushedAgg, schema: Schema, vecs, keep):
    """One pushed aggregate over a decoded batch: (value, any valid)."""
    if a.column is None:
        return keep.sum(dtype=torch.int64), True
    v = vecs[schema.index_of(a.column)]
    return reduce_partial(a.op, v.data, keep & v.validity)


def reduce_partial(op: str, data: torch.Tensor, m: torch.Tensor):
    """count/sum/min/max of `data` over the rows of mask `m`, as a device
    scalar, and whether any row counted (a device bool; count's True)."""
    if op == "count":
        return m.sum(dtype=torch.int64), True
    if op == "sum":
        return torch.where(m, data.to(torch.int64), 0).sum(), m.any()
    work = data.to(torch.int32) if data.dtype == torch.bool else data
    sent = _minmax_sentinel(work.dtype, op)
    masked = torch.where(m, work, torch.full((), sent, dtype=work.dtype,
                                             device=work.device))
    val = masked.amin() if op == "min" else masked.amax()
    return val, m.any()


# -- the device form ----------------------------------------------------------

class DevicePushdown:
    """The pushed spec as the parquet device decode reads it: the
    predicate's tree of leaves (each leaf rebuilt over BoundReference(0),
    evaluated over a column's values), the (out, src) columns to gather,
    the pushed aggregates, and the applier for every batch the
    compressed-form path declines."""

    def __init__(self, spec: ScanPushdown, scan_schema: Schema,
                 applier: PushdownApplier):
        self.applier = applier
        self.aggs = spec.aggs
        if spec.aggs:
            self.columns: Tuple[Tuple[str, str], ...] = ()
        elif spec.columns is not None:
            self.columns = spec.columns
        else:
            self.columns = tuple((n, n) for n in scan_schema.names)
        self.tree, self.leaves = _device_pred(spec.predicate, scan_schema)
        self.out_schema = applier.out_schema


def _one_column(e, schema: Schema) -> Optional[str]:
    """The column every leaf of `e` compares, when there is one and no
    leaf is a null test: such a subtree is one leaf of the device form."""
    if isinstance(e, (EP.And, EP.Or)):
        a, b = (_one_column(c, schema) for c in e.children)
        return a if a is not None and a == b else None
    if isinstance(e, (EN.IsNull, EN.IsNotNull)):
        return None
    return _leaf_column(e, schema)


def _device_pred(pred, schema: Schema):
    """(tree, leaves): tree is ("and"|"or", l, r) | ("leaf", i) |
    ("isnull", col) | ("notnull", col); leaves[i] = (column, the leaf
    over BoundReference(0)). A subtree over one column is one leaf: over
    a column's values (never null there) its AND/OR is the AND/OR of its
    leaves' verdicts, in one evaluation. (None, ()) without a
    predicate."""
    if pred is None:
        return None, ()
    leaves: List[Tuple[str, EB.Expression]] = []

    def conv(e):
        col = _one_column(e, schema)
        if col is None and isinstance(e, (EP.And, EP.Or)):
            return ("and" if isinstance(e, EP.And) else "or",
                    conv(e.children[0]), conv(e.children[1]))
        if isinstance(e, EN.IsNull):
            return ("isnull", _leaf_column(e, schema))
        if isinstance(e, EN.IsNotNull):
            return ("notnull", _leaf_column(e, schema))
        ref = EB.BoundReference(0, schema.types[schema.index_of(col)], True)
        leaves.append((col, e.transform_up(
            lambda n: ref if isinstance(n, EB.AttributeReference) else n)))
        return ("leaf", len(leaves) - 1)

    return conv(pred), tuple(leaves)


# -- footer-statistics row-group pruning --------------------------------------

def _stat_comparable(dt, value) -> bool:
    """Footer min/max compare with the literal without a domain decode:
    plain integers, floats and booleans. Strings (a writer may truncate
    their statistics), decimals (unscaled), dates and timestamps (units)
    never prune: a wrong prune drops rows."""
    if isinstance(dt, T.BooleanType):
        return isinstance(value, bool)
    if T.is_integral(dt):
        return isinstance(value, int) and not isinstance(value, bool)
    if T.is_floating(dt):
        return isinstance(value, (int, float)) and \
            not isinstance(value, bool)
    return False


def prune_row_groups(meta, col_index, schema: Schema, pred) -> set:
    """The row groups the pushed predicate provably eliminates by the
    footer's min/max/null-count statistics, before any page is read.
    Conservative: missing statistics, another domain or a possible NaN
    keep the row group."""
    pruned = set()
    for rg in range(meta.num_row_groups):
        rgm = meta.row_group(rg)

        def stats_of(colname, rgm=rgm):
            ci = col_index.get(colname)
            if ci is None:
                return None
            try:
                st = rgm.column(ci).statistics
            except Exception:  # noqa: BLE001 -- an estimate, never a gate
                return None
            if st is None:
                return None
            mn = mx = None
            if st.has_min_max:
                mn, mx = st.min, st.max
            nulls = st.null_count if st.has_null_count else None
            return mn, mx, nulls, rgm.num_rows

        if not _rg_maybe_match(pred, schema, stats_of):
            pruned.add(rg)
    return pruned


def _isnan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _rg_maybe_match(e, schema: Schema, stats_of) -> bool:
    """Could any row of the row group pass `e`? True when unsure."""
    if isinstance(e, EP.And):
        return _rg_maybe_match(e.children[0], schema, stats_of) and \
            _rg_maybe_match(e.children[1], schema, stats_of)
    if isinstance(e, EP.Or):
        return _rg_maybe_match(e.children[0], schema, stats_of) or \
            _rg_maybe_match(e.children[1], schema, stats_of)
    col = _leaf_column(e, schema)
    if col is None:
        return True
    st = stats_of(col)
    if st is None:
        return True
    mn, mx, nulls, nrows = st
    if isinstance(e, EN.IsNull):
        return nulls is None or nulls > 0
    if isinstance(e, EN.IsNotNull):
        return nulls is None or nulls < nrows
    dt = schema.types[schema.index_of(col)]
    if mn is None or mx is None:
        return True
    if T.is_floating(dt) and (_isnan(mn) or _isnan(mx)):
        return True  # NaN statistics are no evidence of order
    if isinstance(e, EP.In):
        vals = [v for v in e.items if v is not None]
        if T.is_floating(dt) and any(_isnan(v) for v in vals):
            # the port's IN matches NaN IN (NaN), Spark's rule, and NaN
            # rows are invisible to min/max: keep the row group
            return True
        return any(not _stat_comparable(dt, v) or mn <= v <= mx
                   for v in vals)
    lhs, rhs = e.children
    flipped = not isinstance(lhs, EB.AttributeReference)
    v = (lhs if flipped else rhs).value
    if not _stat_comparable(dt, v):
        return True
    if _isnan(v):
        # Spark orders NaN greatest and equal to itself: NaN rows, which
        # min/max do not show, can pass these tests
        return True
    if T.is_floating(dt) and isinstance(
            e, (EP.GreaterThan, EP.GreaterThanOrEqual) if not flipped
            else (EP.LessThan, EP.LessThanOrEqual)):
        return True  # a NaN row is greater than any number
    cls = type(e)
    if flipped:  # lit OP col -> col flipped-OP lit
        cls = {EP.LessThan: EP.GreaterThan,
               EP.LessThanOrEqual: EP.GreaterThanOrEqual,
               EP.GreaterThan: EP.LessThan,
               EP.GreaterThanOrEqual: EP.LessThanOrEqual}.get(cls, cls)
    if cls is EP.EqualTo:
        return mn <= v <= mx
    if cls is EP.LessThan:
        return mn < v
    if cls is EP.LessThanOrEqual:
        return mn <= v
    if cls is EP.GreaterThan:
        return mx > v
    if cls is EP.GreaterThanOrEqual:
        return mx >= v
    return True
