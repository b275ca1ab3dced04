"""Aggregate function descriptors (`spark_rapids_tpu/expr/aggregates.py`).

Each aggregate declares its partial-buffer types; the hash-aggregate exec
lowers them to sort-based segmented reductions. `Sum` over integrals widens
to LONG, over FLOAT and DOUBLE to DOUBLE, over decimal(p, s) to
decimal(p + 10, s). `Average` carries two partial buffers, a sum and a LONG
count, and divides at the end: a DOUBLE sum for the numeric types, and for
decimal(p, s) the exact int64 sum, decimal(p + 10, s), whose mean is
rounded HALF_UP to decimal(p + 4, s + 4) (Spark's result type). The JAX
package keeps a DOUBLE sum there and returns a double of the unscaled mean.

Over a decimal the Average's sum may pass 18 digits (p >= 9): it is then a
128-bit limb sum, and its mean is rounded HALF_UP in limbs.

The rest of the JAX `_agg_one` family: `First`/`Last` (optionally
ignoring nulls), the variance family (VariancePop, VarianceSamp,
StddevPop, StddevSamp: DOUBLE sum, sum of squares and LONG count
partials), `CountIf`, `BoolAnd`/`BoolOr`, the bitwise `BitAndAgg`/
`BitOrAgg`/`BitXorAgg`, and `Skewness`/`Kurtosis` (four power sums and a
count). `CountDistinct`, `CollectList`, `CollectSet` and
`ApproximatePercentile` are descriptors only, with the JAX signatures: the
JAX exec computes the single-pass ones over array columns, which the port
does not carry, and no JAX exec computes CountDistinct, so the planner
refuses all four.
"""

from __future__ import annotations

from typing import List, Optional

from .. import types as T
from .base import Expression

__all__ = ["AggregateFunction", "Sum", "Count", "Min", "Max", "Average",
           "First", "Last", "CountDistinct", "VariancePop", "VarianceSamp",
           "StddevPop", "StddevSamp", "CollectList", "CollectSet",
           "ApproximatePercentile", "CountIf", "BoolAnd", "BoolOr",
           "BitAndAgg", "BitOrAgg", "BitXorAgg", "Skewness", "Kurtosis"]


class AggregateFunction(Expression):
    # data-dependent output fanout (the JAX single-pass path)
    single_pass = False

    def __init__(self, child: Optional[Expression] = None):
        super().__init__([] if child is None else [child])

    @property
    def child(self) -> Optional[Expression]:
        return self.children[0] if self.children else None

    def partial_types(self) -> List[T.DataType]:
        return [self.data_type]

    @property
    def nullable(self):
        return True


class Sum(AggregateFunction):
    @property
    def data_type(self):
        ct = self.child.data_type
        if T.is_integral(ct):
            return T.LONG
        if isinstance(ct, T.DecimalType):
            return T.DecimalType.bounded(ct.precision + 10, ct.scale)
        return T.DOUBLE


class Count(AggregateFunction):
    """count(expr), or count(*) when the child is None."""

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self):
        return False


class Min(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type


class Max(AggregateFunction):
    @property
    def data_type(self):
        return self.child.data_type


class Average(AggregateFunction):
    @property
    def data_type(self):
        ct = self.child.data_type
        if isinstance(ct, T.DecimalType):
            return T.DecimalType.bounded(ct.precision + 4, ct.scale + 4)
        return T.DOUBLE

    def partial_types(self) -> List[T.DataType]:
        ct = self.child.data_type
        if isinstance(ct, T.DecimalType):
            return [T.DecimalType.bounded(ct.precision + 10, ct.scale),
                    T.LONG]
        return [T.DOUBLE, T.LONG]


class First(AggregateFunction):
    def __init__(self, child, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def __repr__(self):
        extra = ", ignore_nulls" if self.ignore_nulls else ""
        return f"{self.name}({self.children[0]!r}{extra})"

    @property
    def data_type(self):
        return self.child.data_type


class Last(First):
    pass


class CountDistinct(AggregateFunction):
    """count(distinct x): a descriptor only (no JAX exec computes it)."""

    @property
    def data_type(self):
        return T.LONG


class _VarianceFamily(AggregateFunction):
    """var_pop/var_samp/stddev_pop/stddev_samp from (sum, sum of squares,
    count) partials, the JAX moment form."""
    sample = False
    sqrt = False

    @property
    def data_type(self):
        return T.DOUBLE

    def partial_types(self) -> List[T.DataType]:
        return [T.DOUBLE, T.DOUBLE, T.LONG]


class VariancePop(_VarianceFamily):
    pass


class VarianceSamp(_VarianceFamily):
    sample = True


class StddevPop(_VarianceFamily):
    sqrt = True


class StddevSamp(_VarianceFamily):
    sample = True
    sqrt = True


class CollectList(AggregateFunction):
    """collect_list: a descriptor only (array results are not carried)."""
    single_pass = True

    @property
    def data_type(self):
        return T.ArrayType(self.child.data_type)


class CollectSet(CollectList):
    """collect_set: a descriptor only."""


class ApproximatePercentile(AggregateFunction):
    """approx_percentile(col, percentage[, accuracy]): a descriptor only."""
    single_pass = True

    def __init__(self, child, percentages, accuracy: int = 10000):
        super().__init__(child)
        self.scalar = not isinstance(percentages, (list, tuple))
        self.percentages = [percentages] if self.scalar else \
            list(percentages)
        self.accuracy = accuracy

    def __repr__(self):
        return (f"{self.name}({self.children[0]!r}, "
                f"{self.percentages}, {self.accuracy})")

    @property
    def data_type(self):
        return T.DOUBLE if self.scalar else T.ArrayType(T.DOUBLE)


class CountIf(AggregateFunction):
    """count_if(predicate): rows where the predicate is true."""

    @property
    def data_type(self):
        return T.LONG


class BoolAnd(AggregateFunction):
    """bool_and / every."""

    @property
    def data_type(self):
        return T.BOOLEAN


class BoolOr(AggregateFunction):
    """bool_or / any / some."""

    @property
    def data_type(self):
        return T.BOOLEAN


class _BitAgg(AggregateFunction):
    """bit_and/bit_or/bit_xor over integral inputs."""
    op = "and"

    @property
    def data_type(self):
        return self.child.data_type


class BitAndAgg(_BitAgg):
    op = "and"


class BitOrAgg(_BitAgg):
    op = "or"


class BitXorAgg(_BitAgg):
    op = "xor"


class _MomentFamily(AggregateFunction):
    """skewness / kurtosis from the power sums s1..s4 and a count."""

    @property
    def data_type(self):
        return T.DOUBLE

    def partial_types(self) -> List[T.DataType]:
        return [T.DOUBLE] * 4 + [T.LONG]


class Skewness(_MomentFamily):
    pass


class Kurtosis(_MomentFamily):
    pass
