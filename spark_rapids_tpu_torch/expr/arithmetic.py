"""Arithmetic expressions with Spark/Java semantics
(`spark_rapids_tpu/expr/arithmetic.py`: Add, Subtract, Multiply).

Integral +, -, * wrap (Java two's complement), which is what torch's fixed
width integer ops do. This slice is non-ANSI only: the planner rejects
ANSI mode before any of this runs. Decimal arithmetic waits for a later
slice.
"""

from __future__ import annotations

from .. import types as T
from ..columnar.column import torch_dtype
from .base import EvalContext, Expression, Vec, and_validity

__all__ = ["Add", "Subtract", "Multiply", "cast_data", "promote_args"]


def cast_data(vec: Vec, dt: T.DataType) -> Vec:
    """Numeric dtype change for implicit widening only."""
    if vec.dtype == dt:
        return vec
    return Vec(dt, vec.data.to(torch_dtype(dt)), vec.validity)


def promote_args(left: Vec, right: Vec):
    dt = T.numeric_promote(left.dtype, right.dtype)
    return cast_data(left, dt), cast_data(right, dt), dt


class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]


class BinaryArithmetic(BinaryExpression):
    @property
    def data_type(self) -> T.DataType:
        return T.numeric_promote(self.left.data_type, self.right.data_type)

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        l, r, dt = promote_args(l, r)
        data = self._op(l.data, r.data).to(torch_dtype(dt))
        return Vec(dt, data, and_validity(l.validity, r.validity))

    def _op(self, a, b):
        raise NotImplementedError


class Add(BinaryArithmetic):
    def _op(self, a, b):
        return a + b


class Subtract(BinaryArithmetic):
    def _op(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    def _op(self, a, b):
        return a * b
