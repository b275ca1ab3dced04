"""Aggregate function descriptors (`spark_rapids_tpu/expr/aggregates.py`:
Sum, Count, Min, Max, Average).

Each aggregate declares its partial-buffer types; the hash-aggregate exec
lowers them to sort-based segmented reductions. `Sum` over integrals widens
to LONG, over FLOAT and DOUBLE to DOUBLE, over decimal(p, s) to
decimal(p + 10, s). `Average` carries two partial buffers, a sum and a LONG
count, and divides at the end: a DOUBLE sum for the numeric types, and for
decimal(p, s) the exact int64 sum, decimal(p + 10, s), whose mean is
rounded HALF_UP to decimal(p + 4, s + 4) (Spark's result type). The JAX
package keeps a DOUBLE sum there and returns a double of the unscaled mean.

`First` and `Last` are descriptors only, with the JAX signature: no exec
carries them yet, so a grouped aggregate or a window frame over them
raises at plan time.
"""

from __future__ import annotations

from typing import List, Optional

from .. import types as T
from .base import Expression

__all__ = ["AggregateFunction", "Sum", "Count", "Min", "Max", "Average",
           "First", "Last"]


class AggregateFunction(Expression):
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
