"""Comparison and boolean predicates with Spark semantics
(`spark_rapids_tpu/expr/predicates.py`: numeric, boolean and string
operands, and IN over a list of literals).

NaN equals NaN and sorts greater than everything (DOUBLE and FLOAT); And/Or
use Kleene three-valued logic (false AND null = false, true OR null =
true). Decimals compare by value: both sides rescale to the larger scale
in 128-bit limbs, or in the 256-bit chain past 38 digits
(expr/decimal128.py), so decimal(38,0) against decimal(38,10) is exact; a
decimal against a non-decimal needs a cast and is refused at plan time. Strings
compare bytewise on the zero-padded byte matrix, so a prefix sorts before
its extensions, which is UTF-8 byte order; equal byte images tie-break on
length (UTF8String.compareTo).
"""

from __future__ import annotations

import torch

from .. import types as T
from .arithmetic import BinaryExpression, promote_args
from .base import EvalContext, Expression, Vec, and_validity, \
    pad_common_width

__all__ = ["EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
           "GreaterThanOrEqual", "And", "Or", "Not", "In", "string_equal",
           "string_compare"]


def string_equal(a: Vec, b: Vec) -> torch.Tensor:
    da, db = pad_common_width(a, b)
    return (da == db).all(dim=1) & (a.lengths == b.lengths)


def string_compare(a: Vec, b: Vec) -> torch.Tensor:
    """int32 -1/0/1 per row: the first differing byte decides (zero-padded
    tails make a prefix smaller than its extensions); equal byte images
    tie-break on length, so a trailing NUL byte still orders after its
    prefix."""
    da, db = pad_common_width(a, b)
    diff = da != db
    first = diff.to(torch.uint8).argmax(dim=1, keepdim=True)
    a_byte = da.gather(1, first).squeeze(1)
    b_byte = db.gather(1, first).squeeze(1)
    one = torch.ones((), dtype=torch.int32, device=da.device)
    by_byte = torch.where(a_byte < b_byte, -one, one)
    by_len = torch.sign(a.lengths.to(torch.int32) - b.lengths.to(torch.int32))
    return torch.where(diff.any(dim=1), by_byte, by_len.to(torch.int32))


class BinaryComparison(BinaryExpression):
    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        validity = and_validity(l.validity, r.validity)
        if isinstance(l.dtype, T.DecimalType) or \
                isinstance(r.dtype, T.DecimalType):
            return Vec(T.BOOLEAN, self._cmp_decimal(l, r), validity)
        if l.is_string:
            data = self._cmp_string(l, r)
        elif T.is_numeric(l.dtype) or T.is_numeric(r.dtype):
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

    def _cmp_decimal(self, l: Vec, r: Vec):
        """Both sides rescaled to the common scale, then a signed order
        (JAX `_cmp_decimal`): in 128-bit limbs while the rescaled operands
        stay within 38 digits, else exactly in the 256-bit chain (a
        128-bit rescale of a 38-digit operand would wrap)."""
        from . import decimal128 as D
        if not (isinstance(l.dtype, T.DecimalType) and
                isinstance(r.dtype, T.DecimalType)):
            raise NotImplementedError(
                "decimal vs non-decimal comparison needs an explicit cast")
        s = max(l.dtype.scale, r.dtype.scale)
        k_l, k_r = s - l.dtype.scale, s - r.dtype.scale
        lhi, llo = D.widen_operand(l.data)
        rhi, rlo = D.widen_operand(r.data)
        if l.dtype.precision + k_l <= 38 and r.dtype.precision + k_r <= 38:
            lhi, llo = D.mul_pow10(lhi, llo, k_l)
            rhi, rlo = D.mul_pow10(rhi, rlo, k_r)
            lt = D.lt128(lhi, llo, rhi, rlo)
            eq = D.eq128(lhi, llo, rhi, rlo)
        else:
            lt, eq = D.wide_cmp(D.wide_mul_pow10(D.wide_from128(lhi, llo),
                                                 k_l),
                                D.wide_mul_pow10(D.wide_from128(rhi, rlo),
                                                 k_r))
        gt = ~(lt | eq)
        # -1/0/1 as string_compare gives, compared with 0
        return self._cmp(gt.to(torch.int8) - lt.to(torch.int8), 0)

    def _cmp_string(self, l: Vec, r: Vec):
        return self._cmp(string_compare(l, r), 0)


class EqualTo(BinaryComparison):
    def _cmp(self, a, b):
        return a == b

    def _cmp_float(self, a, b):
        return (a == b) | (torch.isnan(a) & torch.isnan(b))

    def _cmp_string(self, l: Vec, r: Vec):
        return string_equal(l, r)


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


class In(Expression):
    """value IN (literals...). Null where the value is null, and where
    nothing matched and the list holds a null (the JAX rule). Each item
    compares as EqualTo does, so NaN IN (NaN) is true (Spark's order; the
    JAX engine compares with ==)."""

    def __init__(self, value: Expression, items):
        super().__init__([value])
        self.items = list(items)

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.items!r})"

    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, v: Vec) -> Vec:
        from .base import Literal
        eq = EqualTo(self.children[0], self.children[0])  # its typed compare
        matched = torch.zeros_like(v.validity)
        for item in self.items:
            if item is not None:
                lv = Literal(item, v.dtype)._compute(ctx)
                matched = matched | eq._compute(ctx, v, lv).data
        has_null_item = any(i is None for i in self.items)
        return Vec(T.BOOLEAN, matched,
                   v.validity & (matched | (not has_null_item)))
