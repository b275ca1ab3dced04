"""Logical-physical plan nodes the DataFrame frontend builds
(`spark_rapids_tpu/plan/nodes.py`: scan, range, project, filter, expand,
hash aggregate, hash join, sort, limit, sample, union, window, and the
hash partition spec of the distributed plan's exchanges).

The planner (plan/overrides.py) turns each node into its device exec, or
leaves it a host node. A host node's `execute_cpu()` yields host batches:
it builds the port's own exec for its kind on the CPU over its children's
host batches (cpu/hostbatch.py), where the JAX package runs a numpy
interpreter. Host execs read the thread's `host_conf()`, and plan no
broadcast, exchange, top-k or fusion, as the JAX CPU nodes have none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

from .. import types as T
from ..columnar.batch import Schema, join_output_schema
from ..expr.aggregates import AggregateFunction
from ..expr.base import Expression, bind_references, output_name

__all__ = ["PhysicalPlan", "CpuScanExec", "CpuRangeExec", "CpuProjectExec",
           "CpuFilterExec", "CpuExpandExec", "AggExpr",
           "CpuHashAggregateExec", "CpuHashJoinExec", "CpuSortExec",
           "CpuLimitExec", "CpuSampleExec", "CpuUnionExec", "CpuWindowExec",
           "HashPartitionSpec"]


class PhysicalPlan:
    def __init__(self, children: Sequence["PhysicalPlan"]):
        self.children = list(children)

    @property
    def output(self) -> Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def execute_cpu(self):
        """Host batches of this node, run by the host engine."""
        from ..cpu.hostbatch import run_host
        return run_host(self._host_exec())

    def _host_exec(self):
        """The port's exec for this node on the CPU, over `_host_inputs`."""
        raise NotImplementedError

    def _host_inputs(self):
        from ..cpu.hostbatch import HostStreamExec, host_conf
        return [HostStreamExec(c, host_conf()) for c in self.children]

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + f"{self.name}{self._arg_string()}\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def _arg_string(self) -> str:
        return ""


class CpuScanExec(PhysicalPlan):
    """In-memory Arrow table scan."""

    def __init__(self, table, label: str = "memory"):
        super().__init__([])
        self.table = table
        self.label = label
        self._schema = Schema.from_arrow(table.schema)

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        return f"[{self.label}, {self.table.num_rows} rows]"

    def _host_exec(self):
        from ..cpu.hostbatch import HOST, host_conf
        from ..exec.basic import TpuScanExec
        return TpuScanExec(self.table, HOST, host_conf())


class CpuRangeExec(PhysicalPlan):
    """The LONG column `id`: start, start + step, ... short of end."""

    def __init__(self, start: int, end: int, step: int = 1):
        super().__init__([])
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start, self.end, self.step = int(start), int(end), int(step)
        self._schema = Schema(("id",), (T.LONG,))

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        return f"[{self.start}, {self.end}, {self.step}]"

    def _host_exec(self):
        from ..cpu.hostbatch import HOST, host_conf
        from ..exec.basic import TpuRangeExec
        return TpuRangeExec(self.start, self.end, self.step, HOST,
                            host_conf())


class CpuProjectExec(PhysicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: PhysicalPlan):
        super().__init__([child])
        self.exprs = list(exprs)
        self._bound = [bind_references(e, child.output) for e in self.exprs]
        names = tuple(output_name(e, f"col{i}")
                      for i, e in enumerate(self.exprs))
        self._schema = Schema(names, tuple(e.data_type for e in self._bound))

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        return f"[{', '.join(map(repr, self.exprs))}]"

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.basic import TpuProjectExec
        return TpuProjectExec(self.exprs, *self._host_inputs(), host_conf())


class CpuFilterExec(PhysicalPlan):
    def __init__(self, condition: Expression, child: PhysicalPlan):
        super().__init__([child])
        self.condition = condition
        self._bound = bind_references(condition, child.output)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def _arg_string(self):
        return f"[{self.condition!r}]"

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.basic import TpuFilterExec
        return TpuFilterExec(self.condition, *self._host_inputs(),
                             host_conf())


class CpuExpandExec(PhysicalPlan):
    """Several projections of each input row (ROLLUP, CUBE and grouping
    sets build on it); every projection gives the columns `names`, of the
    first projection's types."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 names: Sequence[str], child: PhysicalPlan):
        super().__init__([child])
        self.projections = [list(p) for p in projections]
        self.names = tuple(names)
        self._bound = [[bind_references(e, child.output) for e in p]
                       for p in self.projections]
        self._schema = Schema(self.names,
                              tuple(e.data_type for e in self._bound[0]))

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        return f"[{[[repr(e) for e in p] for p in self.projections]}]"

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.basic import TpuExpandExec
        return TpuExpandExec(self.projections, self.names,
                             *self._host_inputs(), host_conf())


@dataclasses.dataclass
class AggExpr:
    func: AggregateFunction
    name: str


class CpuHashAggregateExec(PhysicalPlan):
    def __init__(self, group_exprs: Sequence[Expression],
                 aggs: Sequence[AggExpr], child: PhysicalPlan):
        super().__init__([child])
        self.group_exprs = list(group_exprs)
        self.aggs = list(aggs)
        self._bound_groups = [bind_references(e, child.output)
                              for e in self.group_exprs]
        self._bound_aggs = []
        for a in self.aggs:
            f = a.func
            if f.child is not None:
                f = f.with_children([bind_references(f.child, child.output)])
            self._bound_aggs.append(AggExpr(f, a.name))
        names = tuple([output_name(e, f"k{i}")
                       for i, e in enumerate(self.group_exprs)] +
                      [a.name for a in self.aggs])
        tps = tuple([e.data_type for e in self._bound_groups] +
                    [a.func.data_type for a in self._bound_aggs])
        self._schema = Schema(names, tps)

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        return (f"[keys={[repr(e) for e in self.group_exprs]}, "
                f"aggs={[a.name for a in self.aggs]}]")

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.aggregate import TpuHashAggregateExec
        return TpuHashAggregateExec(self.group_exprs, self.aggs,
                                    *self._host_inputs(), host_conf())


class CpuHashJoinExec(PhysicalPlan):
    def __init__(self, left: PhysicalPlan, right: PhysicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression],
                 join_type: str = "inner", condition: Expression = None):
        super().__init__([left, right])
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.join_type = "inner" if join_type == "cross" else join_type
        self.condition = condition
        self._bl = [bind_references(e, left.output) for e in self.left_keys]
        self._br = [bind_references(e, right.output) for e in self.right_keys]
        lo, ro = left.output, right.output
        # the condition reads the combined (left ++ right) row
        self._bcond = None if condition is None else bind_references(
            condition, Schema(lo.names + ro.names, lo.types + ro.types))
        self._schema = join_output_schema(lo, ro, self.join_type)

    @property
    def output(self) -> Schema:
        return self._schema

    def _arg_string(self):
        cond = "" if self.condition is None else f", cond={self.condition!r}"
        return f"[{self.join_type}, keys={[repr(e) for e in self.left_keys]}" \
               f"{cond}]"

    def _host_exec(self):
        """A keyless join is the nested-loop exec, the rest a hash join of
        both whole sides: no broadcast and no pruning on the host."""
        from ..cpu.hostbatch import host_conf
        from ..exec.joins import TpuNestedLoopJoinExec, \
            TpuShuffledHashJoinExec
        left, right = self._host_inputs()
        if not self.left_keys:
            return TpuNestedLoopJoinExec(left, right, self.condition,
                                         self.join_type, host_conf())
        return TpuShuffledHashJoinExec(left, right, self.left_keys,
                                       self.right_keys, self.join_type,
                                       host_conf(), condition=self.condition)


class CpuSortExec(PhysicalPlan):
    def __init__(self, orders: Sequence[Tuple[Expression, bool, bool]],
                 child: PhysicalPlan):
        """orders: (expr, ascending, nulls_first)."""
        super().__init__([child])
        self.orders = list(orders)
        self._bound = [(bind_references(e, child.output), a, nf)
                       for e, a, nf in self.orders]

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def _arg_string(self):
        return f"[{[(repr(e), a, nf) for e, a, nf in self.orders]}]"

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.sort import TpuSortExec
        return TpuSortExec(self.orders, *self._host_inputs(), host_conf())


class CpuLimitExec(PhysicalPlan):
    def __init__(self, limit: int, child: PhysicalPlan, offset: int = 0):
        super().__init__([child])
        self.limit = limit
        self.offset = offset

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def _arg_string(self):
        return f"[{self.limit}]"

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.basic import TpuLimitExec
        return TpuLimitExec(self.limit, *self._host_inputs(), self.offset,
                            host_conf())


class CpuSampleExec(PhysicalPlan):
    """Bernoulli sample without replacement: a splitmix64 hash of each
    row's global ordinal decides it (ops/rowops.py `sample_mask`), so both
    engines keep the same rows for a seed."""

    def __init__(self, fraction: float, seed: int, child: PhysicalPlan):
        super().__init__([child])
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction must be in [0, 1]: {fraction}")
        self.fraction = float(fraction)
        self.seed = int(seed)

    @property
    def output(self) -> Schema:
        return self.children[0].output

    def _arg_string(self):
        return f"[fraction={self.fraction}, seed={self.seed}]"

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.basic import TpuSampleExec
        return TpuSampleExec(self.fraction, self.seed, *self._host_inputs(),
                             host_conf())


class CpuUnionExec(PhysicalPlan):
    @property
    def output(self) -> Schema:
        return self.children[0].output

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.basic import TpuUnionExec
        return TpuUnionExec(self._host_inputs(), host_conf())


class CpuWindowExec(PhysicalPlan):
    """Window functions over (partition, order): the child's columns, then
    one column per function. Output rows come back sorted by (partition,
    order)."""

    def __init__(self, window_exprs: Sequence[Tuple[Any, str]],
                 partition_spec: Sequence[Expression],
                 order_spec: Sequence[Tuple[Expression, bool, bool]],
                 child: PhysicalPlan):
        from ..expr.windowexprs import WindowAggregate, bind_window_fn
        super().__init__([child])
        self.window_exprs = list(window_exprs)
        self.partition_spec = list(partition_spec)
        self.order_spec = list(order_spec)
        co = child.output
        self._bound_part = [bind_references(e, co)
                            for e in self.partition_spec]
        self._bound_order = [(bind_references(e, co), a, nf)
                             for e, a, nf in self.order_spec]
        self._bound_fns = [(bind_window_fn(f, co), name)
                           for f, name in self.window_exprs]
        for f, name in self._bound_fns:
            if isinstance(f, WindowAggregate) and f.func.child is not None \
                    and type(f.func).__name__ in ("Sum", "Average") \
                    and isinstance(f.func.child.data_type, T.StringType):
                raise TypeError(
                    f"window column {name}: {type(f.func).__name__} over "
                    "STRING is invalid")
        names = co.names + tuple(n for _, n in self.window_exprs)
        tps = co.types + tuple(f.data_type for f, _ in self._bound_fns)
        self._schema = Schema(names, tps)

    @property
    def output(self) -> Schema:
        return self._schema

    def _host_exec(self):
        from ..cpu.hostbatch import host_conf
        from ..exec.window import TpuWindowExec
        return TpuWindowExec(self.window_exprs, self.partition_spec,
                             self.order_spec, *self._host_inputs(),
                             host_conf())


@dataclasses.dataclass
class HashPartitionSpec:
    """Plan-level hash partitioning; lowered to a device partitioner by
    exec/exchange.make_partitioner."""
    keys: List[Any]
    num_partitions: int

    def __repr__(self):
        return f"hashpartitioning({self.keys}, {self.num_partitions})"
