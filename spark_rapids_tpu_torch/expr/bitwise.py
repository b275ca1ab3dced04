"""Bitwise expressions (`spark_rapids_tpu/expr/bitwise.py`): &, |, ^ over
the integral types (promoted as arithmetic is), ~, and Java's shifts. A
shift amount is masked to its low 5 bits, or 6 for a LONG value; a
narrower value shifts as an int and wraps back to its type, as the JAX
kernel does. No ANSI error: these cannot overflow in Spark.

torch has no unsigned 64-bit shift worth the name on CUDA, so `>>>`
shifts arithmetically and masks off the copied sign bits: for a LONG,
`(1 << (64 - s)) - 1` with s == 0 its own case; a narrower value shifts
its low 32 bits as a non-negative int64.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..columnar.column import torch_dtype
from .arithmetic import BinaryArithmetic
from .base import EvalContext, Expression, Vec, and_validity

__all__ = ["BitwiseAnd", "BitwiseOr", "BitwiseXor", "BitwiseNot",
           "ShiftLeft", "ShiftRight", "ShiftRightUnsigned"]


class _Bitwise(BinaryArithmetic):
    def _overflowed(self, a, b, res):
        return torch.zeros_like(res, dtype=torch.bool)


class BitwiseAnd(_Bitwise):
    def _op(self, a, b):
        return a & b


class BitwiseOr(_Bitwise):
    def _op(self, a, b):
        return a | b


class BitwiseXor(_Bitwise):
    def _op(self, a, b):
        return a ^ b


class BitwiseNot(Expression):
    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        return self.children[0].data_type

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(c.dtype, ~c.data, c.validity)


class _Shift(Expression):
    def __init__(self, value, amount):
        super().__init__([value, amount])

    @property
    def data_type(self):
        return self.children[0].data_type

    def _compute(self, ctx: EvalContext, v: Vec, s: Vec) -> Vec:
        long = isinstance(v.dtype, T.LongType)
        amt = s.data.to(torch.int64) & (63 if long else 31)
        a = v.data.to(torch.int64) if long else v.data.to(torch.int32)
        out = self._op(a, amt if long else amt.to(torch.int32), long)
        return Vec(v.dtype, out.to(torch_dtype(v.dtype)),
                   and_validity(v.validity, s.validity))


class ShiftLeft(_Shift):
    def _op(self, a, amt, long):
        return a << amt


class ShiftRight(_Shift):
    def _op(self, a, amt, long):
        return a >> amt


class ShiftRightUnsigned(_Shift):
    def _op(self, a, amt, long):
        if long:
            one = torch.ones_like(a)
            kept = (one << (64 - amt)) - 1
            return torch.where(amt == 0, a, (a >> amt) & kept)
        low = a.to(torch.int64) & 0xFFFFFFFF
        return low >> amt.to(torch.int64)
