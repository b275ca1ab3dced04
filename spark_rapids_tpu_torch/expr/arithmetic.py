"""Arithmetic expressions with Spark/Java semantics
(`spark_rapids_tpu/expr/arithmetic.py`: Add, Subtract, Multiply, Divide,
IntegralDivide, Remainder, Pmod, UnaryMinus, Abs).

Integral +, -, * wrap (Java two's complement), which is what torch's fixed
width integer ops do; the narrow ints and FLOAT promote as Spark widens
(byte < short < int < long < float < double). Divide yields DOUBLE,
IntegralDivide LONG; IntegralDivide, Remainder and Pmod truncate toward
zero as Java does, and x / 0 is null.

ANSI mode (`ctx.ansi`) raises instead, with the JAX messages: integral
+, -, * out of range (sign tests for + and -, and the product divided
back through `trunc_div` for *), a decimal +/- past its precision,
division by zero in the whole division family, IntegralDivide's
MIN div -1, and UnaryMinus or Abs of an integral MIN.

Decimals: Add and Subtract rescale both sides to the larger scale in
128-bit limbs, or in the 256-bit chain where a rescaled operand passes 38
digits or the result scale drops (expr/decimal128.py), and a result past
its precision is null (JAX `_decimal_addsub`); UnaryMinus and Abs negate
limbs (-2^127 stays itself, as in the JAX package). Divide with a decimal operand
divides the operands' values, the unscaled integers times 10^-scale, which
is Spark's rule; the JAX engine divides the unscaled integers and is off by
the scales' difference. Decimal Multiply, decimal operands of the integral
division family, and decimal against non-decimal arithmetic without a cast
are refused at plan time (plan/overrides.py).
"""

from __future__ import annotations

import torch

from .. import types as T
from ..columnar.column import torch_dtype
from .base import EvalContext, Expression, Vec, and_validity, ansi_raise
from .cast import convert

__all__ = ["Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
           "Remainder", "Pmod", "UnaryMinus", "Abs", "cast_data",
           "promote_args", "trunc_div"]


def _overflow_msg(dt: T.DataType) -> str:
    if isinstance(dt, T.DecimalType):
        return f"[ARITHMETIC_OVERFLOW] {dt.simple_string()} overflow"
    name = {T.ByteType: "tinyint", T.ShortType: "smallint",
            T.IntegerType: "integer", T.LongType: "long"}.get(type(dt))
    return f"[ARITHMETIC_OVERFLOW] {name or dt.simple_string()} overflow"


_DIV_ZERO = "[DIVIDE_BY_ZERO] Division by zero"


def cast_data(vec: Vec, dt: T.DataType) -> Vec:
    """Numeric dtype change for implicit widening only."""
    if vec.dtype == dt:
        return vec
    return Vec(dt, vec.data.to(torch_dtype(dt)), vec.validity)


def promote_args(left: Vec, right: Vec):
    dt = T.numeric_promote(left.dtype, right.dtype)
    return cast_data(left, dt), cast_data(right, dt), dt


def trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java integer division, truncating toward zero, for b != 0; MIN / -1
    wraps to MIN. The -1 divisor never reaches torch's division, where
    MIN / -1 traps."""
    minus_one = b == -1
    q = torch.div(a, torch.where(minus_one, torch.ones_like(b), b),
                  rounding_mode="trunc")
    return torch.where(minus_one, -a, q)


def _nonzero_divisor(b: torch.Tensor):
    """(b with every 0 replaced by 1, the mask of the zeros)."""
    zero = b == 0
    return torch.where(zero, torch.ones_like(b), b), zero


def _checked_divisor(ctx: EvalContext, l: Vec, r: Vec, zero: torch.Tensor):
    """The result's validity, null where the divisor is 0; under ANSI such a
    row raises instead."""
    both = and_validity(l.validity, r.validity)
    if ctx.ansi:
        ansi_raise(ctx, zero & both, _DIV_ZERO)
    return both & ~zero


def _check_min_negation(ctx: EvalContext, c: Vec) -> None:
    """ANSI: negating an integral MIN overflows (UnaryMinus, Abs)."""
    if ctx.ansi and T.is_integral(c.dtype):
        ansi_raise(ctx, (c.data == torch.iinfo(c.data.dtype).min)
                   & c.validity, _overflow_msg(c.dtype))


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
        lt, rt = self.left.data_type, self.right.data_type
        dec = isinstance(lt, T.DecimalType), isinstance(rt, T.DecimalType)
        if all(dec) and type(self) in (Add, Subtract):
            from .decimal128 import add_result_type
            return add_result_type(lt, rt)
        if any(dec):  # Spark's decimal promotion is not ported
            raise NotImplementedError(
                f"{type(self).__name__} over {lt.simple_string()}, "
                f"{rt.simple_string()} is not supported by "
                "spark_rapids_tpu_torch yet")
        return T.numeric_promote(lt, rt)

    def _decimal_addsub(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        """Exact decimal +/- (JAX `_decimal_addsub`): both sides rescaled
        to the larger input scale, added, rounded HALF_UP to the result
        scale, and a result past the result precision null. While the
        rescaled operands stay within 38 digits and the scale is kept, in
        128-bit limbs (a sum that wraps lands out of bounds); otherwise in
        the 256-bit chain, where nothing wraps."""
        from . import decimal128 as D
        out_t = self.data_type
        s = max(l.dtype.scale, r.dtype.scale)
        k_l, k_r = s - l.dtype.scale, s - r.dtype.scale
        lhi, llo = D.widen_operand(l.data)
        rhi, rlo = D.widen_operand(r.data)
        if out_t.scale == s and l.dtype.precision + k_l <= 38 and \
                r.dtype.precision + k_r <= 38:
            lhi, llo = D.mul_pow10(lhi, llo, k_l)
            rhi, rlo = D.mul_pow10(rhi, rlo, k_r)
            if isinstance(self, Subtract):
                rhi, rlo = D.neg128(rhi, rlo)
            hi, lo = D.add128(lhi, llo, rhi, rlo)
            ok = D.in_bounds(hi, lo, out_t.precision)
        else:
            wl = D.wide_mul_pow10(D.wide_from128(lhi, llo), k_l)
            wr = D.wide_mul_pow10(D.wide_from128(rhi, rlo), k_r)
            if isinstance(self, Subtract):
                wr = D.wide_neg(wr)
            ws = D.wide_div_pow10_half_up(D.wide_add(wl, wr),
                                          s - out_t.scale)
            hi, lo, fits = D.wide_to128(ws)
            ok = fits & D.in_bounds(hi, lo, out_t.precision)
        validity = and_validity(l.validity, r.validity)
        if ctx.ansi:
            ansi_raise(ctx, ~ok & validity, _overflow_msg(out_t))
        validity = validity & ok
        if D.is_dec128(out_t):
            return Vec(out_t, D.pack_limbs(hi, lo), validity)
        return Vec(out_t, lo, validity)

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        if isinstance(l.dtype, T.DecimalType) and \
                isinstance(r.dtype, T.DecimalType) and \
                type(self) in (Add, Subtract):
            return self._decimal_addsub(ctx, l, r)
        l, r, dt = promote_args(l, r)
        validity = and_validity(l.validity, r.validity)
        data = self._op(l.data, r.data).to(torch_dtype(dt))
        if ctx.ansi and T.is_integral(dt):
            ansi_raise(ctx, self._overflowed(l.data, r.data, data) & validity,
                       _overflow_msg(dt))
        return Vec(dt, data, validity)

    def _op(self, a, b):
        raise NotImplementedError

    def _overflowed(self, a, b, res):
        raise NotImplementedError


class Add(BinaryArithmetic):
    def _op(self, a, b):
        return a + b

    def _overflowed(self, a, b, res):
        # operands of one sign whose wrapped sum has the other
        return ((a ^ res) & (b ^ res)) < 0


class Subtract(BinaryArithmetic):
    def _op(self, a, b):
        return a - b

    def _overflowed(self, a, b, res):
        return ((a ^ b) & (a ^ res)) < 0


class Multiply(BinaryArithmetic):
    def _op(self, a, b):
        return a * b

    def _overflowed(self, a, b, res):
        # divide the wrapped product back: a mismatch means the true
        # product left the type's range; MIN * -1 wraps onto itself
        mn = torch.iinfo(res.dtype).min
        q = trunc_div(res, torch.where(b == 0, torch.ones_like(b), b))
        return ((b != 0) & (q != a)) | ((a == mn) & (b == -1)) | \
            ((b == mn) & (a == -1))


def _scale(v: Vec) -> int:
    return v.dtype.scale if isinstance(v.dtype, T.DecimalType) else 0


class Divide(BinaryExpression):
    """Spark Divide, DOUBLE result, x / 0 -> null. A decimal operand counts
    as its value: a / b = (ua / ub) * 10^(sb - sa) for unscaled ua, ub and
    scales sa, sb (0 for a non-decimal), two roundings of a double."""

    @property
    def data_type(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return True

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        b, zero = _nonzero_divisor(r.data.to(torch.float64))
        validity = _checked_divisor(ctx, l, r, zero)
        data = l.data.to(torch.float64) / b
        shift = _scale(r) - _scale(l)
        if shift > 0:
            data = data * float(10 ** shift)
        elif shift < 0:
            data = data / float(10 ** -shift)
        return Vec(T.DOUBLE, torch.where(zero, 0.0, data), validity)


class IntegralDivide(BinaryExpression):
    """`div`: LONG result, truncation toward zero, x div 0 -> null."""

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self):
        return True

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        a, b = convert(l.data, torch.int64), convert(r.data, torch.int64)
        b, zero = _nonzero_divisor(b)
        validity = _checked_divisor(ctx, l, r, zero)
        if ctx.ansi:
            ansi_raise(ctx, (a == -2 ** 63) & (b == -1) & validity,
                       _overflow_msg(T.LONG))
        return Vec(T.LONG, torch.where(zero, 0, trunc_div(a, b)), validity)


class Remainder(BinaryArithmetic):
    """Java %: the sign follows the dividend; x % 0 -> null."""

    @property
    def nullable(self):
        return True

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        l, r, dt = promote_args(l, r)
        b, zero = _nonzero_divisor(r.data)
        validity = _checked_divisor(ctx, l, r, zero)
        if T.is_floating(dt):
            data = torch.fmod(l.data, b)
        else:
            data = l.data - b * trunc_div(l.data, b)
        return Vec(dt, torch.where(zero, torch.zeros_like(data), data)
                   .to(torch_dtype(dt)), validity)


class Pmod(BinaryArithmetic):
    """Spark's positive modulus: r = a % n; r < 0 ? (r + n) % n : r. For a
    negative n the result keeps n's sign (pmod(-7, -3) = -1); the JAX
    engine adds |n| to integral operands there (2)."""

    @property
    def nullable(self):
        return True

    def _compute(self, ctx: EvalContext, l: Vec, r: Vec) -> Vec:
        l, r, dt = promote_args(l, r)
        b, zero = _nonzero_divisor(r.data)
        validity = _checked_divisor(ctx, l, r, zero)
        if T.is_floating(dt):
            m = torch.fmod(l.data, b)
            data = torch.where(m < 0, torch.fmod(m + b, b), m)
        else:
            m = l.data - b * trunc_div(l.data, b)
            s = m + b
            data = torch.where(m < 0, s - b * trunc_div(s, b), m)
        return Vec(dt, torch.where(zero, torch.zeros_like(data), data)
                   .to(torch_dtype(dt)), validity)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return self.children[0].data_type

    def _compute(self, ctx, c: Vec) -> Vec:
        if c.data.dim() == 2:  # decimal128 limbs
            from .decimal128 import neg128, pack_limbs
            return Vec(c.dtype, pack_limbs(*neg128(c.data[:, 0],
                                                   c.data[:, 1])),
                       c.validity)
        _check_min_negation(ctx, c)
        return Vec(c.dtype, (-c.data).to(c.data.dtype), c.validity)


class Abs(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return self.children[0].data_type

    def _compute(self, ctx, c: Vec) -> Vec:
        if c.data.dim() == 2:  # decimal128 limbs
            from .decimal128 import abs128, pack_limbs
            hi, lo, _ = abs128(c.data[:, 0], c.data[:, 1])
            return Vec(c.dtype, pack_limbs(hi, lo), c.validity)
        _check_min_negation(ctx, c)
        return Vec(c.dtype, torch.abs(c.data), c.validity)
