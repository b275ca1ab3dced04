"""DataFrame frontend (`spark_rapids_tpu/frontend.py`: select, filter,
join, cross_join, group_by, agg, sort/order_by, sample, limit, union,
window, collect, collect_cpu). It builds plan nodes; the session rewrites and runs them."""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .expr.aggregates import AggregateFunction
from .expr.base import Alias, AttributeReference, Expression
from .plan import nodes as N

__all__ = ["DataFrame", "GroupedData"]


def _as_expr(e: Union[str, Expression]) -> Expression:
    return AttributeReference(e) if isinstance(e, str) else e


def _order_spec(o, ascending: bool = True,
                nulls_first: Optional[bool] = None):
    """(expr, ascending, nulls_first) from a tuple, or from a bare key
    with the given direction (nulls first when ascending unless
    `nulls_first` says otherwise: Spark's default)."""
    if isinstance(o, tuple):
        e, asc, nf = o
        return _as_expr(e), asc, nf
    return _as_expr(o), ascending, \
        ascending if nulls_first is None else nulls_first


class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[Expression]):
        self.df = df
        self.keys = [_as_expr(k) for k in keys]

    def agg(self, **named_aggs: AggregateFunction) -> "DataFrame":
        aggs = [N.AggExpr(f, name) for name, f in named_aggs.items()]
        return DataFrame(self.df.session,
                         N.CpuHashAggregateExec(self.keys, aggs, self.df.plan))


class DataFrame:
    def __init__(self, session, plan: N.PhysicalPlan):
        self.session = session
        self.plan = plan

    @property
    def schema(self):
        return self.plan.output

    def select(self, *exprs: Union[str, Expression],
               **named: Expression) -> "DataFrame":
        projs = [_as_expr(e) for e in exprs]
        projs.extend(Alias(_as_expr(e), nm) for nm, e in named.items())
        return DataFrame(self.session, N.CpuProjectExec(projs, self.plan))

    def filter(self, condition: Expression) -> "DataFrame":
        return DataFrame(self.session, N.CpuFilterExec(condition, self.plan))

    def group_by(self, *keys: Union[str, Expression]) -> GroupedData:
        return GroupedData(self, keys)

    def agg(self, **named_aggs: AggregateFunction) -> "DataFrame":
        return GroupedData(self, []).agg(**named_aggs)

    def join(self, other: "DataFrame", on: Union[str, Sequence[str]] = None,
             how: str = "inner", condition: Expression = None) -> "DataFrame":
        """Equi join on `on` keys (optionally with an extra `condition`
        predicate over the combined row), or, with no keys, a cartesian /
        pure-condition nested loop join. `how` is inner, left, right, full,
        semi, anti, and also "cross" and "existence" (left rows + bool
        `exists` column)."""
        keys = [] if on is None else ([on] if isinstance(on, str)
                                      else list(on))
        return DataFrame(self.session, N.CpuHashJoinExec(
            self.plan, other.plan, [_as_expr(k) for k in keys],
            [_as_expr(k) for k in keys], how, condition=condition))

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        return self.join(other, how="cross")

    def sort(self, *orders, ascending: bool = True,
             nulls_first: Optional[bool] = None) -> "DataFrame":
        """Order by columns or expressions, or (expr, ascending,
        nulls_first) tuples."""
        specs = [_order_spec(o, ascending, nulls_first) for o in orders]
        return DataFrame(self.session, N.CpuSortExec(specs, self.plan))

    order_by = sort

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """Bernoulli sample without replacement; both engines keep the
        same rows for a seed."""
        return DataFrame(self.session,
                         N.CpuSampleExec(fraction, seed, self.plan))

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return DataFrame(self.session, N.CpuLimitExec(n, self.plan, offset))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self.session, N.CpuUnionExec([self.plan, other.plan]))

    def window(self, partition_by=(), order_by=(),
               **named_fns) -> "DataFrame":
        """Append window-function columns. `partition_by`: columns/exprs;
        `order_by`: columns or (expr, ascending, nulls_first) tuples; named
        values are WindowFunction instances or AggregateFunctions (wrapped in
        the Spark-default frame). Output rows come back sorted by
        (partition, order)."""
        from .expr.windowexprs import WindowAggregate, WindowFunction
        part = [_as_expr(p) for p in partition_by]
        orders = [_order_spec(o) for o in order_by]
        fns = []
        for name, f in named_fns.items():
            if isinstance(f, AggregateFunction):
                f = WindowAggregate(f)
            if not isinstance(f, WindowFunction):
                raise TypeError(f"{name}: expected a window/aggregate "
                                f"function, got {type(f).__name__}")
            fns.append((f, name))
        return DataFrame(self.session,
                         N.CpuWindowExec(fns, part, orders, self.plan))

    def collect(self):
        """Execute and return a pyarrow Table."""
        return self.session.execute_plan(self.plan)

    def collect_cpu(self):
        """Execute on the host engine only (the whole plan by
        `execute_cpu`) and return a pyarrow Table."""
        return self.session.execute_plan(self.plan, use_device=False)

    def explain(self) -> str:
        return self.session.explain_plan(self.plan)

    def __repr__(self):
        return f"DataFrame({self.schema})\n{self.plan.tree_string()}"
