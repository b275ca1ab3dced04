"""Window function expressions (`spark_rapids_tpu/expr/windowexprs.py`).

A `WindowFunction` is a descriptor the window exec (exec/window.py)
consumes; it is never evaluated through the normal `_compute` path. Frames
follow Spark:

  * `RowFrame(lower, upper)`: offsets in rows relative to the current row;
    `None` means UNBOUNDED on that side, 0 is CURRENT ROW.
  * `RangeFrame(lower, upper)`: (None, 0) is UNBOUNDED PRECEDING..CURRENT
    ROW (the current row's order peers included), (None, None) the whole
    partition, and any other bounds a value-offset frame over the single
    numeric, date or timestamp order column.

Default frame (Spark semantics): with an ORDER BY, RangeFrame(None, 0);
without one, the whole partition.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .. import types as T
from .aggregates import AggregateFunction
from .base import Expression

__all__ = ["RowFrame", "RangeFrame", "default_frame", "is_value_range_frame",
           "WindowFunction", "NthValue", "RowNumber", "Rank", "DenseRank",
           "PercentRank", "CumeDist", "NTile", "Lead", "Lag",
           "WindowAggregate", "bind_window_fn"]


@dataclasses.dataclass(frozen=True)
class RowFrame:
    lower: Optional[int]  # None = UNBOUNDED PRECEDING; negative = preceding
    upper: Optional[int]  # None = UNBOUNDED FOLLOWING; positive = following

    def __repr__(self):
        lo = "unbounded" if self.lower is None else self.lower
        hi = "unbounded" if self.upper is None else self.upper
        return f"rows({lo}, {hi})"


@dataclasses.dataclass(frozen=True)
class RangeFrame:
    lower: Optional[int]
    upper: Optional[int]

    def __repr__(self):
        lo = "unbounded" if self.lower is None else self.lower
        hi = "unbounded" if self.upper is None else self.upper
        return f"range({lo}, {hi})"


def default_frame(has_order: bool):
    return RangeFrame(None, 0) if has_order else RangeFrame(None, None)


def is_value_range_frame(frame) -> bool:
    """True for RANGE frames with value offsets: anything beyond the
    positional UNBOUNDED..CURRENT ROW and UNBOUNDED..UNBOUNDED forms. The
    planner's checks and the exec's frame dispatch both key off this one
    predicate."""
    return isinstance(frame, RangeFrame) and not (
        frame.lower is None and frame.upper in (0, None))


class WindowFunction(Expression):
    """Marker base: evaluated by the window exec, not by expression eval."""

    requires_order = False

    def _compute(self, ctx, *children):
        raise RuntimeError(
            f"{self.name} is a window function; it can only appear in a "
            "window")


class RowNumber(WindowFunction):
    requires_order = True

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self):
        return False


class Rank(WindowFunction):
    requires_order = True

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self):
        return False


class DenseRank(WindowFunction):
    requires_order = True

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self):
        return False


class PercentRank(WindowFunction):
    requires_order = True

    @property
    def data_type(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False


class CumeDist(WindowFunction):
    requires_order = True

    @property
    def data_type(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False


class NTile(WindowFunction):
    requires_order = True

    def __init__(self, buckets: int):
        super().__init__()
        if buckets < 1:
            raise ValueError(f"ntile buckets must be positive, got {buckets}")
        self.buckets = buckets

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self):
        return False

    def __repr__(self):
        return f"NTile({self.buckets})"


class _OffsetFunction(WindowFunction):
    """lead/lag: value at a fixed row offset within the partition."""

    requires_order = True

    def __init__(self, child: Expression, offset: int = 1, default=None):
        super().__init__([child])
        self.offset = offset
        self.default = default

    @property
    def data_type(self):
        return self.children[0].data_type

    @property
    def nullable(self):
        return True

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.offset}, " \
               f"{self.default!r})"


class Lead(_OffsetFunction):
    pass


class Lag(_OffsetFunction):
    pass


class NthValue(WindowFunction):
    """nth_value(col, n[, ignore_nulls]) over the window frame (1-based);
    null when the frame has fewer than n (valid) rows."""

    requires_order = True

    def __init__(self, child, n: int, ignore_nulls: bool = False,
                 frame=None):
        super().__init__([child])
        if not isinstance(n, int) or n < 1:
            raise ValueError("nth_value offset must be a positive int")
        self.n = n
        self.ignore_nulls = ignore_nulls
        self.frame = frame

    @property
    def data_type(self):
        return self.children[0].data_type

    def __repr__(self):
        extra = ", ignore_nulls" if self.ignore_nulls else ""
        if self.frame is not None:
            extra += f" FRAME {self.frame!r}"
        return f"nth_value({self.children[0]!r}, {self.n}{extra})"


class WindowAggregate(WindowFunction):
    """An aggregate function evaluated over a window frame."""

    def __init__(self, func: AggregateFunction,
                 frame: Optional[object] = None):
        super().__init__(list(func.children))
        self.func = func
        self.frame = frame  # None -> default frame for the window's order spec

    @property
    def data_type(self):
        return self.func.data_type

    @property
    def nullable(self):
        return True

    def with_children(self, children):
        import copy
        node = copy.copy(self)
        node.children = list(children)
        node.func = self.func.with_children(children) if children \
            else self.func
        return node

    def __repr__(self):
        return f"{self.func!r} OVER {self.frame!r}"


def bind_window_fn(fn: WindowFunction, schema) -> WindowFunction:
    """Bind a window function's child expressions against the input schema
    (shared by the plan node and the device exec)."""
    from .base import bind_references
    if isinstance(fn, WindowAggregate):
        f = fn.func
        if f.child is not None:
            f = f.with_children([bind_references(f.child, schema)])
        out = fn.with_children([])
        out.func = f
        out.children = list(f.children)
        return out
    if fn.children:
        return fn.with_children([bind_references(c, schema)
                                 for c in fn.children])
    return fn
