"""Plan rewrite: plan nodes -> device execs (`spark_rapids_tpu/plan/overrides.py`
rules `_c_scan` ... `_c_join`, with the broadcast choice by estimated
build size, and `_c_sort`, `_c_limit` with its top-k rewrite, `_c_union`
and `_c_window` with the checks of `_tag_window` and `_tag_window_agg`).
After conversion the distribution pass (exec/requirements.py) and then
fusion (plan/fusion.py) rewrite the device plan, in the JAX package's
order; neither touches a sort, top-k, limit, union or window.

This slice has no CPU engine to fall back to, so the JAX engine's per-node
"will not work" tags become errors: every type, expression, aggregate, join
type or mode outside the slice raises NotImplementedError here, before any
data moves, and nothing silently computes something else. ANSI mode
(`spark.sql.ansi.enabled` or `spark.rapids.sql.ansi.enabled`) runs, with
the JAX `_tag_cast` rule for casts: under it only numeric <-> numeric and
decimal casts are admitted.
"""

from __future__ import annotations

from typing import List

import torch

from .. import types as T
from ..columnar.column import check_string_length, check_string_widths, \
    check_supported
from ..config import TpuConf
from ..expr import arithmetic as A
from ..expr import cast as CA
from ..expr import conditional as C
from ..expr import nullexprs as NE
from ..expr import predicates as P
from ..expr import aggregates as AG
from ..expr.decimal128 import is_dec128
from ..expr.base import Alias, AttributeReference, BoundReference, \
    Expression, Literal
from ..expr.hashing import INT_FAMILY, LONG_FAMILY
from ..io.scanbase import CpuFileScanExec, TpuFileScanExec
from . import nodes as N

__all__ = ["Overrides"]

_SUPPORTED_EXPRS = (Literal, BoundReference, AttributeReference, Alias,
                    A.Add, A.Subtract, A.Multiply, A.Divide,
                    A.IntegralDivide, A.Remainder, A.Pmod, A.UnaryMinus,
                    A.Abs, CA.Cast, P.EqualTo, P.LessThan,
                    P.LessThanOrEqual, P.GreaterThan, P.GreaterThanOrEqual,
                    P.And, P.Or, P.Not, P.In, NE.IsNull, NE.IsNotNull,
                    NE.IsNaN, NE.Coalesce, C.If, C.CaseWhen, C.Least,
                    C.Greatest)
_ARITH_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                T.FloatType, T.DoubleType, T.DecimalType)
_COMPARISONS = (P.EqualTo, P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                P.GreaterThanOrEqual)
# join types whose build (right) side may be broadcast: no output depends
# on the build side's matched flags being global (right and full would
# emit unmatched build rows once per consumer), so those stay shuffled
_BROADCASTABLE = ("inner", "cross", "left", "semi", "anti", "existence")


def _unsupported(what: str):
    raise NotImplementedError(f"{what} is not supported by "
                              "spark_rapids_tpu_torch yet")


def _value_children(node: Expression):
    """The children whose values a node compares or merges: both sides of
    a comparison, every argument of Coalesce/Least/Greatest, the branches
    (not the predicates) of If and CaseWhen."""
    ch = node.children
    if isinstance(node, C.If):
        return ch[1:]
    if isinstance(node, C.CaseWhen):
        return ch[1::2] + [ch[-1]]
    if isinstance(node, (P.EqualTo, P.LessThan, P.LessThanOrEqual,
                         P.GreaterThan, P.GreaterThanOrEqual, NE.Coalesce,
                         C.Least, C.Greatest)):
        return ch
    return []


def _check_expr(e: Expression, ansi: bool) -> None:
    for node in e.collect(lambda _: True):
        if not isinstance(node, _SUPPORTED_EXPRS):
            _unsupported(f"expression {type(node).__name__}")
        if isinstance(node, (A.BinaryArithmetic, A.Divide, A.IntegralDivide,
                             A.UnaryMinus, A.Abs)):
            _check_arithmetic(node)
        check_supported(node.data_type, f"{type(node).__name__} result")
        if isinstance(node, Literal) and isinstance(node.value, str):
            check_string_length(len(node.value.encode("utf-8")))
        if isinstance(node, CA.Cast):
            src = node.children[0].data_type
            if not CA.device_supported(src, node.to):
                _unsupported(f"cast from {src.simple_string()} to "
                             f"{node.to.simple_string()}")
            if ansi and not CA.ansi_supported(src, node.to):
                _unsupported(f"ANSI-mode cast from {src.simple_string()} to "
                             f"{node.to.simple_string()}")
        decimals = [c.data_type for c in _value_children(node)
                    if not isinstance(c.data_type, T.NullType)]
        if any(isinstance(t, T.DecimalType) for t in decimals):
            if isinstance(node, _COMPARISONS):
                if not all(isinstance(t, T.DecimalType) for t in decimals):
                    _unsupported("a decimal compared with another type "
                                 "without a cast")
            elif len(set(decimals)) > 1:
                _unsupported(f"{type(node).__name__} over "
                             + ", ".join(t.simple_string() for t in decimals)
                             + " without a cast")
        strings = [isinstance(c.data_type, T.StringType)
                   for c in _value_children(node)]
        if any(strings) and not all(strings):
            _unsupported(f"{type(node).__name__} over a string and another "
                         "type")
        if any(strings) and isinstance(node, (C.Least, C.Greatest)):
            _unsupported(f"{type(node).__name__} over strings")
        if isinstance(node, (C.Least, C.Greatest)) and \
                any(is_dec128(c.data_type) for c in node.children):
            _unsupported(f"{type(node).__name__} over a decimal of more "
                         "than 18 digits")
        if isinstance(node, P.In):
            if is_dec128(node.children[0].data_type):
                # the JAX In broadcasts one value a row against the limbs
                _unsupported("In over a decimal of more than 18 digits")
            _check_in_items(node)


def _check_in_items(node: "P.In") -> None:
    """IN's items are literals of the value's kind: strings for a string
    value (each within the flat layout), numbers otherwise (a decimal
    value's as Decimal or int)."""
    import decimal
    vt = node.children[0].data_type
    for item in node.items:
        if item is None:
            continue
        if isinstance(vt, T.StringType):
            ok = isinstance(item, str)
            if ok:
                check_string_length(len(item.encode("utf-8")))
        elif isinstance(vt, T.DecimalType):
            ok = isinstance(item, (int, decimal.Decimal)) and \
                not isinstance(item, bool)
        elif isinstance(vt, T.BooleanType):
            ok = isinstance(item, bool)
        else:
            ok = isinstance(item, (int, float)) and \
                not isinstance(item, bool)
        if not ok:
            _unsupported(f"In over {vt.simple_string()} with the item "
                         f"{item!r}")


def _check_arithmetic(node: Expression) -> None:
    """Numeric operands, before the node's type is read (numeric_promote
    has no answer for others). Decimal Multiply, Remainder and Pmod, and a
    decimal mixed with another type in +/-, raise from the node's type (the
    JAX package has neither decimal Multiply nor Spark's decimal
    promotion); IntegralDivide has a LONG type, so its decimal operands are
    refused here, as is Divide over a decimal of more than 18 digits (the
    JAX Divide reads one int64 a row)."""
    types = [c.data_type for c in node.children]
    if not all(isinstance(t, _ARITH_TYPES) for t in types) or (
            isinstance(node, A.IntegralDivide)
            and any(isinstance(t, T.DecimalType) for t in types)) or (
            isinstance(node, A.Divide) and any(map(is_dec128, types))):
        _unsupported(f"{type(node).__name__} over " + ", ".join(
            t.simple_string() for t in types))


def _selectivity(cond, stats: dict) -> float:
    """Predicate selectivity from footer column min/max, uniform between
    them as Spark's FilterEstimation assumes; 0.5 when it cannot be known
    (`plan/cbo.py` `_selectivity`)."""
    def attr_lit(e):
        a, b = e.children
        if isinstance(a, AttributeReference) and isinstance(b, Literal):
            return a, b.value, False
        if isinstance(b, AttributeReference) and isinstance(a, Literal):
            return b, a.value, True
        return None

    if isinstance(cond, P.And):
        return _selectivity(cond.children[0], stats) * \
            _selectivity(cond.children[1], stats)
    if isinstance(cond, P.Or):
        s1 = _selectivity(cond.children[0], stats)
        s2 = _selectivity(cond.children[1], stats)
        return s1 + s2 - s1 * s2
    if isinstance(cond, P.Not):
        return 1.0 - _selectivity(cond.children[0], stats)
    if isinstance(cond, (P.LessThan, P.LessThanOrEqual, P.GreaterThan,
                         P.GreaterThanOrEqual, P.EqualTo)):
        al = attr_lit(cond)
        if al is None:
            return 0.5
        attr, v, flipped = al
        rng = stats.get(attr.col_name)
        try:
            if rng is None:
                return 0.5
            mn, mx = float(rng[0]), float(rng[1])
            v = float(v)
        except (TypeError, ValueError):
            return 0.5
        if isinstance(cond, P.EqualTo):
            return 0.05 if mn <= v <= mx else 0.0
        frac_below = 1.0 if v >= mx else 0.0 if v <= mn else \
            (v - mn) / (mx - mn)
        less = isinstance(cond, (P.LessThan, P.LessThanOrEqual))
        if flipped:  # lit OP attr reverses the direction
            less = not less
        return frac_below if less else 1.0 - frac_below
    return 0.5


def _estimated_rows(plan: N.PhysicalPlan) -> float:
    """Heuristic output cardinality (`plan/cbo.py` `_estimate_from` without
    the runtime-statistics feedback): exact at in-memory and file scans
    (the footer row count), a filter straight over a file scan by its
    footer statistics, else the fixed factors."""
    kids = [_estimated_rows(c) for c in plan.children]
    if isinstance(plan, N.CpuScanExec):
        return float(plan.table.num_rows)
    if isinstance(plan, CpuFileScanExec):
        return float(plan.footer_row_count())
    if isinstance(plan, N.CpuFilterExec):
        child = plan.children[0]
        if isinstance(child, CpuFileScanExec):
            sel = _selectivity(plan.condition, child.column_stats())
            return kids[0] * max(min(sel, 1.0), 0.0)
        return kids[0] * 0.5
    if isinstance(plan, N.CpuLimitExec):
        return float(min(plan.limit, kids[0]))
    if isinstance(plan, N.CpuUnionExec):
        return float(sum(kids))
    if isinstance(plan, N.CpuHashAggregateExec):
        return max(kids[0] / 8.0, 1.0) if plan.group_exprs else 1.0
    if isinstance(plan, N.CpuHashJoinExec):
        return float(max(kids))
    return kids[0]


def _estimated_bytes(plan: N.PhysicalPlan) -> float:
    """Cardinality x row width: data bytes + one validity byte a column,
    and 20 bytes for a column without a fixed width (a string), as the JAX
    package counts."""
    width = sum(20 if dt.np_dtype is None else dt.np_dtype.itemsize + 1
                for dt in plan.output.types)
    return _estimated_rows(plan) * max(width, 1)


class Overrides:
    """Entry point (reference GpuOverrides.apply): check, convert,
    distribute over the mesh, fuse."""

    def __init__(self, conf: TpuConf, device: torch.device):
        self.conf = conf
        self.device = torch.device(device)
        self.explain_log: List[str] = []

    def apply(self, plan: N.PhysicalPlan):
        if not self.conf.is_sql_enabled:
            _unsupported("spark.rapids.sql.enabled=false (the CPU engine)")
        if self.conf.get("spark.rapids.tpu.mesh.enabled"):
            _unsupported("spark.rapids.tpu.mesh.enabled=true (the sharded "
                         "plan)")
        if self.conf.get("spark.rapids.tpu.sched.enabled"):
            _unsupported("spark.rapids.tpu.sched.enabled=true (the query "
                         "scheduler)")
        if (self.conf.get("spark.rapids.tpu.sched.tenant.quotas") or
                "").strip():
            _unsupported("spark.rapids.tpu.sched.tenant.quotas (tenant "
                         "memory sub-quotas)")
        if self.conf.get("spark.rapids.tpu.mesh.hbmPerChip") > 0:
            _unsupported("spark.rapids.tpu.mesh.hbmPerChip (per-chip memory "
                         "ledgers)")
        result = self._convert(plan)
        # the distribution pass first (partial -> key-exchange -> final,
        # zipped joins), then fusion, which takes the partial aggregate as
        # its stage-terminal member
        from ..exec.requirements import ensure_distribution
        result = ensure_distribution(result, self.conf)
        from .fusion import apply_fusion
        return apply_fusion(result, self.conf)

    def explain_string(self) -> str:
        return "\n".join(self.explain_log)

    def _convert(self, plan: N.PhysicalPlan):
        children = [self._convert(c) for c in plan.children]
        conf = self.conf
        if isinstance(plan, N.CpuScanExec):
            for dt in plan.output.types:
                check_supported(dt, "scan column")
            check_string_widths(plan.table)
            from ..exec.basic import TpuScanExec
            out = TpuScanExec(plan.table, self.device, conf)
        elif isinstance(plan, CpuFileScanExec):
            out = self._convert_file_scan(plan)
        elif isinstance(plan, N.CpuProjectExec):
            for e in plan._bound:
                _check_expr(e, conf.is_ansi)
            from ..exec.basic import TpuProjectExec
            out = TpuProjectExec(plan.exprs, children[0], conf)
        elif isinstance(plan, N.CpuFilterExec):
            _check_expr(plan._bound, conf.is_ansi)
            if not isinstance(plan._bound.data_type, T.BooleanType):
                _unsupported("a non-boolean filter condition")
            from ..exec.basic import TpuFilterExec
            out = TpuFilterExec(plan.condition, children[0], conf)
        elif isinstance(plan, N.CpuHashAggregateExec):
            out = self._convert_agg(plan, children)
        elif isinstance(plan, N.CpuHashJoinExec):
            out = self._convert_join(plan, children)
        elif isinstance(plan, N.CpuSortExec):
            _check_orders(plan._bound, conf.is_ansi)
            from ..exec.sort import TpuSortExec
            out = TpuSortExec(plan.orders, children[0], conf)
        elif isinstance(plan, N.CpuLimitExec):
            out = _convert_limit(plan, children, conf)
        elif isinstance(plan, N.CpuUnionExec):
            types = {tuple(c.output.types) for c in plan.children}
            if len(types) > 1:
                _unsupported("a union of children with different column "
                             "types")
            from ..exec.basic import TpuUnionExec
            out = TpuUnionExec(children, conf)
        elif isinstance(plan, N.CpuWindowExec):
            _check_window(plan, conf.is_ansi)
            from ..exec.window import TpuWindowExec
            out = TpuWindowExec(plan.window_exprs, plan.partition_spec,
                                plan.order_spec, children[0], conf)
        else:
            _unsupported(f"plan node {plan.name}")
        if self.conf.explain == "ALL":
            self.explain_log.append(f"*{plan.name} will run on "
                                    f"{self.device} as {out.name}")
        return out

    def _convert_file_scan(self, plan):
        """A parquet scan of columns of engine types. What the device
        decode declines -- a column (the footer check), a row group (its
        pages) or a file -- the scan decodes on the host, so only what no
        path of the port holds is refused here: nested and binary columns
        (`schema_from_arrow`, `check_supported`)."""
        if plan.format_name != "parquet":
            _unsupported(f"the {plan.format_name} scan")
        for dt in plan.output.types:
            check_supported(dt, "scan column")
        return TpuFileScanExec(plan, self.conf, self.device)

    def _convert_agg(self, plan: N.CpuHashAggregateExec, children):
        from ..exec.aggregate import TpuHashAggregateExec
        ansi = self.conf.is_ansi
        for e in plan._bound_groups:
            _check_expr(e, ansi)
        for a in plan._bound_aggs:
            _check_aggregate(a.func, ansi)
        return TpuHashAggregateExec(plan.group_exprs, plan.aggs, children[0],
                                    self.conf)

    def _convert_join(self, plan: N.CpuHashJoinExec, children):
        """JAX `_tag_join` as errors, then `_c_join`: a keyless join is the
        nested-loop exec (its build broadcast when small), a small build of
        a broadcastable type a broadcast hash join, the rest (right and
        full always) a shuffled hash join."""
        from ..exec.broadcast import TpuBroadcastExchangeExec
        from ..exec.joins import (SUPPORTED_JOIN_TYPES,
                                  TpuBroadcastHashJoinExec,
                                  TpuNestedLoopJoinExec,
                                  TpuShuffledHashJoinExec)
        for e in plan.left_keys + plan.right_keys:
            if not isinstance(e, AttributeReference):
                _unsupported("a join key that is not a column reference "
                             "(join keys must be column references: project "
                             "them first)")
        if plan.join_type not in SUPPORTED_JOIN_TYPES:
            _unsupported(f"join type {plan.join_type}")
        for e in plan._bl + plan._br:
            check_supported(e.data_type, "join key")
            if is_dec128(e.data_type):  # the JAX murmur3 stops at 18 digits
                _unsupported(f"a {e.data_type.simple_string()} join key")
        ints = INT_FAMILY + LONG_FAMILY
        for lk, rk in zip(plan._bl, plan._br):
            # keys hash by their stored values, so both sides must share one
            # type (Spark casts them to one; a decimal also shares its scale
            # and precision); only the int and long families mix, as before
            if lk.data_type != rk.data_type and not (
                    isinstance(lk.data_type, ints)
                    and isinstance(rk.data_type, ints)
                    and T.DecimalType not in (type(lk.data_type),
                                              type(rk.data_type))):
                _unsupported(f"join keys {lk.data_type.simple_string()} and "
                             f"{rk.data_type.simple_string()}")
        if plan._bcond is not None:
            _check_expr(plan._bcond, self.conf.is_ansi)
            if not isinstance(plan._bcond.data_type, T.BooleanType):
                _unsupported("a non-boolean join condition")
        threshold = self.conf.get("spark.rapids.sql.autoBroadcastJoinThreshold")
        small_build = (threshold >= 0 and plan.join_type in _BROADCASTABLE
                       and _estimated_bytes(plan.children[1]) <= threshold)
        if not plan.left_keys:
            build = TpuBroadcastExchangeExec(children[1], self.conf) \
                if small_build else children[1]
            return TpuNestedLoopJoinExec(children[0], build, plan.condition,
                                         plan.join_type, self.conf)
        if small_build:
            join = TpuBroadcastHashJoinExec(
                children[0], TpuBroadcastExchangeExec(children[1], self.conf),
                plan.left_keys, plan.right_keys, plan.join_type, self.conf,
                condition=plan.condition)
            _wire_dynamic_pruning(join, plan, self.conf)
            return join
        return TpuShuffledHashJoinExec(children[0], children[1],
                                       plan.left_keys, plan.right_keys,
                                       plan.join_type, self.conf,
                                       condition=plan.condition)


# the aggregates over values of the numeric types only (their moments are
# computed in DOUBLE): the JAX exec reads a decimal's unscaled value there
_DOUBLE_MOMENTS = (AG._VarianceFamily, AG._MomentFamily)
_NUMERIC_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
                  T.FloatType, T.DoubleType)
_INTEGRAL_TYPES = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


def _check_aggregate(func, ansi: bool) -> None:
    """A grouped aggregate of the slice over a child of a type it takes:
    every aggregate of the JAX `_agg_one`; CollectList, CollectSet and
    ApproximatePercentile (array results and the single-pass path) and
    CountDistinct (no JAX exec computes it) raise."""
    from ..exec.aggregate import SUPPORTED_AGGREGATES
    name = type(func).__name__
    if func.single_pass or not isinstance(func, SUPPORTED_AGGREGATES):
        _unsupported(f"aggregate {name}")
    if func.child is None:
        return
    ct = func.child.data_type
    what = f"{name.lower()} over {ct.simple_string()}"
    if isinstance(func, (AG.Sum, AG.Average)):
        ok = isinstance(ct, _ARITH_TYPES)
    elif isinstance(func, _DOUBLE_MOMENTS):
        ok = isinstance(ct, _NUMERIC_TYPES)
    elif isinstance(func, (AG.CountIf, AG.BoolAnd, AG.BoolOr)):
        ok = isinstance(ct, T.BooleanType)
    elif isinstance(func, AG._BitAgg):
        ok = isinstance(ct, _INTEGRAL_TYPES)
    else:
        ok = True
    if not ok:
        _unsupported(what)
    for pt in func.partial_types():
        check_supported(pt, f"{what}: its partial buffer")
    _check_expr(func.child, ansi)
    check_supported(func.data_type, f"{name} result")


def _check_orders(bound_orders, ansi: bool) -> None:
    """Sort keys: expressions of the slice, each of a carried type."""
    for e, _, _ in bound_orders:
        _check_expr(e, ansi)
        check_supported(e.data_type, "sort key")


def _convert_limit(plan: N.CpuLimitExec, children, conf):
    """LIMIT over ORDER BY becomes a top-k (TakeOrderedAndProjectExec
    analog, GpuOverrides.scala:3705): a per-batch k-select and a running
    merge replace the full sort, when spark.rapids.sql.topK.enabled and
    limit + offset <= spark.rapids.sql.topK.threshold."""
    from ..exec.basic import TpuLimitExec
    from ..exec.sort import TpuSortExec, TpuTopKExec
    child = children[0]
    if conf.get("spark.rapids.sql.topK.enabled") and \
            isinstance(child, TpuSortExec) and not child.each_batch and \
            plan.limit + plan.offset <= \
            conf.get("spark.rapids.sql.topK.threshold"):
        return TpuTopKExec(child.orders, plan.limit, child.child, conf,
                           plan.offset)
    return TpuLimitExec(plan.limit, child, plan.offset, conf)


_WINDOW_AGGREGATES = ("Sum", "Count", "Min", "Max", "Average", "First",
                      "Last")


def _check_window(plan: N.CpuWindowExec, ansi: bool) -> None:
    """`_tag_window` and `_tag_window_agg` of the JAX package, as errors:
    every function needing an ORDER BY has one; value-offset RANGE frames
    have one order column of a numeric, date or timestamp type; window
    aggregates are Sum, Count, Min, Max, Average, First or Last, with no
    bounded frame over a string MIN/MAX. Beyond the JAX checks, these
    raise: an Average over a decimal, a value-offset RANGE frame over a
    decimal order key, a Sum whose result passes 18 digits (the JAX window
    accumulates it in one 1-D buffer under a 128-bit type, and its result
    fails to convert) and a Min or Max over a decimal of more than 18
    digits (the JAX window's neutral fill does not broadcast over limbs)."""
    from ..expr import windowexprs as WX
    for e in plan._bound_part:
        _check_expr(e, ansi)
        check_supported(e.data_type, "window partition key")
    _check_orders(plan._bound_order, ansi)
    has_order = bool(plan.order_spec)
    for f, name in plan._bound_fns:
        what = f"window column {name}"
        if f.requires_order and not has_order:
            _unsupported(f"{what}: {type(f).__name__} without an ORDER BY "
                         "(window function requires an ORDER BY)")
        frame = getattr(f, "frame", None)
        if isinstance(f, (WX.WindowAggregate, WX.NthValue)) and \
                WX.is_value_range_frame(frame):
            if len(plan.order_spec) != 1:
                _unsupported(f"{what}: a value-offset RANGE frame without "
                             "exactly one order column")
            key_t = plan._bound_order[0][0].data_type
            if not (T.is_numeric(key_t) or
                    isinstance(key_t, (T.DateType, T.TimestampType))) or \
                    isinstance(key_t, T.DecimalType):
                _unsupported(f"{what}: a value-offset RANGE frame over a "
                             f"{key_t.simple_string()} order column")
        for c in f.children:
            _check_expr(c, ansi)
        if isinstance(f, WX.WindowAggregate):
            _check_window_agg(f, what)
        elif isinstance(f, (WX.Lead, WX.Lag)) and \
                isinstance(f.default, str):
            check_string_length(len(f.default.encode("utf-8")))
        check_supported(f.data_type, f"{what} result")


def _check_window_agg(f, what: str) -> None:
    from ..expr import windowexprs as WX
    name = type(f.func).__name__
    if name not in _WINDOW_AGGREGATES:
        _unsupported(f"{what}: {name} over a window")
    child = f.func.child
    if child is None:
        return
    ct = child.data_type
    if name in ("Sum", "Average") and not isinstance(ct, _ARITH_TYPES):
        _unsupported(f"{what}: {name.lower()} over {ct.simple_string()}")
    if name == "Average" and isinstance(ct, T.DecimalType):
        _unsupported(f"{what}: a window average over {ct.simple_string()}")
    if name == "Sum" and is_dec128(f.func.data_type):
        _unsupported(f"{what}: a window sum of "
                     f"{f.func.data_type.simple_string()}")
    if name in ("Min", "Max") and is_dec128(ct):
        _unsupported(f"{what}: a window {name} over {ct.simple_string()}")
    frame = f.frame
    bounded = WX.is_value_range_frame(frame) or (
        isinstance(frame, WX.RowFrame) and not (
            frame.lower is None and frame.upper in (0, None)))
    if name in ("Min", "Max") and bounded and isinstance(ct, T.StringType):
        _unsupported(f"{what}: a bounded-frame window {name} over STRING")


# join types in which a probe row without a build match never reaches the
# output, so pruning probe row groups by the build keys cannot change a
# result (left and anti emit unmatched probe rows)
_DPP_SAFE = ("inner", "semi")


def _dpp_scan_for_column(node, colname):
    """Descend column-preserving execs from the probe root to a parquet
    scan that provides `colname` unchanged: (scan, its column) or None."""
    from ..exec.basic import TpuFilterExec, TpuProjectExec
    if isinstance(node, TpuFileScanExec):
        return (node, colname) if (node.cpu_scan.format_name == "parquet"
                                   and colname in node.output.names) \
            else None
    if isinstance(node, TpuFilterExec):
        return _dpp_scan_for_column(node.children[0], colname)
    if isinstance(node, TpuProjectExec):
        for e in node.exprs:
            src = e.children[0] if isinstance(e, Alias) else e
            name = e.alias if isinstance(e, Alias) else \
                getattr(e, "col_name", None)
            if name == colname and isinstance(src, AttributeReference):
                return _dpp_scan_for_column(node.children[0], src.col_name)
    return None


def _wire_dynamic_pruning(join, plan, conf) -> None:
    """Attach DynamicKeyFilters between a broadcast hash join and the probe
    parquet scans its keys are columns of (`plan/overrides.py`
    `_wire_dynamic_pruning`). Only integer, floating and string keys, whose
    footer min/max compare in the value domain."""
    if not conf.get("spark.rapids.sql.dynamicFilePruning.enabled") or \
            plan.join_type not in _DPP_SAFE:
        return
    from ..io.dynamic_pruning import DynamicKeyFilter
    for i, lk in enumerate(plan.left_keys):
        if not isinstance(lk, AttributeReference):
            continue
        res = _dpp_scan_for_column(join.children[0], lk.col_name)
        if res is None:
            continue
        scan, scan_col = res
        dt = scan.output.types[scan.output.names.index(scan_col)]
        if not (T.is_integral(dt) or T.is_floating(dt) or dt == T.STRING):
            continue
        filt = DynamicKeyFilter(scan_col)
        scan.dynamic_filters.append(filt)
        join.dpp_filters.append((join._rk_ix[i], filt))
