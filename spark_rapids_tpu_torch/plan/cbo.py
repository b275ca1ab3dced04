"""Cost-based optimizer and the planner's row estimates
(`spark_rapids_tpu/plan/cbo.py`; reference `CostBasedOptimizer.scala`:
CostBasedOptimizer `:54`, CpuCostModel `:284`, GpuCostModel `:334`).

Over the tagged meta tree, `optimize` decides whether sections that could
run on the device stay on the host engine because the transitions would
cost more than the device saves, the case being a cheap tail stranded
between a host-only node and the host collect. The model: per-row operator
costs (`optimizer.cpuExecCost`, `gpuExecCost`) and a per-row host <->
device boundary cost (`transitionCost`) over static row estimates. Each
node's best cost is worked out for both placements bottom up, then a walk
from the root fixes the cheaper side; a device-capable node placed on the
host gets the reason `_COST_REASON`, which `explain` prints after a `!`,
and runs on the port's host engine.

`row_estimate` is the estimate the optimizer and the broadcast choice
(plan/overrides.py `_c_join`, through `estimated_bytes`) both read: exact
at in-memory scans, ranges and parquet footers, a filter straight over a
file scan by its footer min/max, fixed factors elsewhere, and a keyless
join the product of its sides. The JAX engine's runtime-statistics
history (`stats/`) is not ported, so its lookups are absent and the
`spark.rapids.tpu.stats.*` keys raise at plan time.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Tuple

from ..config import TpuConf
from . import nodes as N
from .meta import PlanMeta

__all__ = ["optimize", "row_estimate", "estimated_bytes", "estimate_pass"]

# one planning pass's estimates, keyed by id(plan node): within a pass no
# estimate can change, so the optimizer and the convert walk share them.
# Thread-local: concurrent queries plan on their own threads.
_tls = threading.local()

_COST_REASON = ("the cost-based optimizer kept this on CPU "
                "(transition cost dominates the device speedup)")


def _pass_memo() -> Optional[Dict]:
    return getattr(_tls, "memo", None)


@contextlib.contextmanager
def estimate_pass():
    """Scope one planning pass (Overrides.apply) with a fresh memo."""
    prev = _pass_memo()
    _tls.memo = {}
    try:
        yield
    finally:
        _tls.memo = prev


def _selectivity(cond, stats: dict) -> float:
    """Predicate selectivity from footer column min/max, uniform between
    them as Spark's FilterEstimation assumes; 0.5 when it cannot be
    known."""
    from ..expr import predicates as P
    from ..expr.base import AttributeReference, Literal

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


def _estimate_from(plan, kids) -> float:
    """Cardinality of one node given its children's estimates (JAX
    `_estimate_from` without the history lookups)."""
    from ..io.scanbase import CpuFileScanExec
    if isinstance(plan, N.CpuScanExec):
        return float(plan.table.num_rows)
    if isinstance(plan, N.CpuRangeExec):
        return float(max(0, (plan.end - plan.start) // max(plan.step, 1)))
    if isinstance(plan, CpuFileScanExec):
        nrows = plan.footer_row_count()
        if nrows is not None:
            return float(nrows)
        return 1000.0 * max(len(plan.paths), 1)
    if not kids:
        return 1000.0
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
        if not plan.left_keys:  # cartesian / nested loop
            return kids[0] * kids[1]
        return float(max(kids))
    return kids[0]


def row_estimate(plan) -> float:
    """Heuristic output cardinality of a plan node, memoized per node
    inside an `estimate_pass`."""
    memo = _pass_memo()
    if memo is None:
        return _estimate_from(plan, [row_estimate(c) for c in plan.children])
    v = memo.get(id(plan))
    if v is None:
        v = memo[id(plan)] = _estimate_from(
            plan, [row_estimate(c) for c in plan.children])
    return v


def estimated_bytes(plan) -> float:
    """Cardinality x row width: data bytes and one validity byte a column,
    and 20 bytes for a column without a fixed width (a string), as the
    JAX package counts."""
    width = sum(20 if dt.np_dtype is None else dt.np_dtype.itemsize + 1
                for dt in plan.output.types)
    return row_estimate(plan) * max(width, 1)


def optimize(root: PlanMeta, conf: TpuConf) -> None:
    """Mark device-capable nodes as cost-prevented where the host is
    cheaper. The root's parent is the host (results are collected)."""
    cpu_w = conf.get("spark.rapids.sql.optimizer.cpuExecCost")
    tpu_w = conf.get("spark.rapids.sql.optimizer.gpuExecCost")
    trans_w = conf.get("spark.rapids.sql.optimizer.transitionCost")
    memo: Dict[int, Tuple[float, float, float]] = {}

    def costs(m: PlanMeta) -> Tuple[float, float]:
        """(best cost with this node on the host, on the device)."""
        if id(m) in memo:
            return memo[id(m)][:2]
        kids = [(costs(c), memo[id(c)][2]) for c in m.child_metas]
        rows = _estimate_from(m.plan, [r for _, r in kids])
        pm = _pass_memo()
        if pm is not None:
            pm.setdefault(id(m.plan), rows)
        cpu = cpu_w * rows + sum(
            min(cc, tc + trans_w * cr) for (cc, tc), cr in kids)
        tpu = tpu_w * rows + sum(
            min(tc, cc + trans_w * cr) for (cc, tc), cr in kids) \
            if m.can_run_on_device else math.inf
        memo[id(m)] = (cpu, tpu, rows)
        return cpu, tpu

    def place(m: PlanMeta, parent_on_tpu: bool) -> None:
        cpu, tpu, rows = memo[id(m)]
        boundary = trans_w * rows
        on_tpu = tpu + (0.0 if parent_on_tpu else boundary) < \
            cpu + (boundary if parent_on_tpu else 0.0)
        if not on_tpu and m.can_run_on_device:
            m.will_not_work(_COST_REASON)
        for c in m.child_metas:
            place(c, on_tpu)

    costs(root)
    place(root, parent_on_tpu=False)
