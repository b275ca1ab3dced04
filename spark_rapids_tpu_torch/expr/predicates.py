"""Comparison and boolean predicates with Spark semantics
(`spark_rapids_tpu/expr/predicates.py`, numeric and boolean operands).

NaN equals NaN and sorts greater than everything; And/Or use Kleene
three-valued logic (false AND null = false, true OR null = true).
"""

from __future__ import annotations

import torch

from .. import types as T
from .arithmetic import BinaryExpression, promote_args
from .base import EvalContext, Expression, Vec, and_validity

__all__ = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
           "GreaterThanOrEqual", "And", "Or", "Not"]


class BinaryComparison(BinaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        validity = and_validity(l.validity, r.validity)
        if T.is_numeric(l.dtype) or T.is_numeric(r.dtype):
            l2, r2, dt = promote_args(l, r)
            if T.is_floating(dt):
                data = self._cmp_float(l2.data, r2.data)
            else:
                data = self._cmp(l2.data, r2.data)
        else:
            data = self._cmp(l.data, r.data)
        return Vec(T.BOOLEAN, data, validity)

    def _cmp(self, a, b):
        raise NotImplementedError

    def _cmp_float(self, a, b):
        return self._cmp(a, b)


class EqualTo(BinaryComparison):
    def _cmp(self, a, b):
        return a == b

    def _cmp_float(self, a, b):
        return (a == b) | (torch.isnan(a) & torch.isnan(b))


class LessThan(BinaryComparison):
    def _cmp(self, a, b):
        return a < b

    def _cmp_float(self, a, b):
        return (a < b) | (~torch.isnan(a) & torch.isnan(b))


class LessThanOrEqual(BinaryComparison):
    def _cmp(self, a, b):
        return a <= b

    def _cmp_float(self, a, b):
        return (a <= b) | torch.isnan(b)


class GreaterThan(BinaryComparison):
    def _cmp(self, a, b):
        return a > b

    def _cmp_float(self, a, b):
        return (a > b) | (torch.isnan(a) & ~torch.isnan(b))


class GreaterThanOrEqual(BinaryComparison):
    def _cmp(self, a, b):
        return a >= b

    def _cmp_float(self, a, b):
        return (a >= b) | torch.isnan(a)


class And(BinaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        known_false = (l.validity & ~l.data) | (r.validity & ~r.data)
        validity = (l.validity & r.validity) | known_false
        return Vec(T.BOOLEAN, l.data & r.data & ~known_false, validity)


class Or(BinaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        known_true = (l.validity & l.data) | (r.validity & r.data)
        validity = (l.validity & r.validity) | known_true
        return Vec(T.BOOLEAN, l.data | r.data | known_true, validity)


class Not(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(T.BOOLEAN, ~c.data, c.validity)
