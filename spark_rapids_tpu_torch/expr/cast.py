"""Cast, the numeric part (`spark_rapids_tpu/expr/cast.py`:
`device_supported`, `_numeric_cast`, `_decimal_cast` and the date and
timestamp casts).

Java semantics: integral narrowing wraps; float -> integral truncates
toward zero, clamps to the target's range and maps NaN to 0 (`convert`,
which the If/CaseWhen/Coalesce merges, Least/Greatest and IntegralDivide
share); -> BOOLEAN is `!= 0`. Decimal casts rescale the unscaled value,
HALF_UP when the scale drops, and a value past the target precision or
integral range is null; a decimal of more than 18 digits on either side
rescales in limbs (`_decimal128_cast`).
DATE -> TIMESTAMP is midnight UTC, TIMESTAMP -> DATE and -> LONG
floor-divide (days, seconds), LONG -> TIMESTAMP multiplies seconds.
Casts from and to strings are not ported: the planner refuses them.

The casts that `device_supported` (the JAX device rule) refuses run on the
host engine only (`host_only`; a CUDA tensor raises). Two follow Spark's
rule where the JAX CPU engine departs from it (ROADMAP.md "Known
differences"): FLOAT/DOUBLE -> DECIMAL takes the shortest decimal digits
that give the double back (Python's `repr`, Java's `Double.toString` from
JDK 19 on) rounded HALF_UP to the scale, null for NaN, infinities and
values past the precision; BYTE/SHORT/INT -> TIMESTAMP reads seconds, as
LONG -> TIMESTAMP does. The rest (DATE -> numeric, numeric -> DATE,
TIMESTAMP -> numeric other than LONG, BOOLEAN/FLOAT/DOUBLE/DECIMAL ->
TIMESTAMP) give the JAX CPU engine's values through the paths below; their
Spark rule waits for confirmation (ROADMAP.md Queue C).

ANSI mode (`ctx.ansi`) raises where the non-ANSI cast clamps, wraps or
makes null: float -> integral out of range or NaN and integral narrowing
out of range raise `[CAST_OVERFLOW]`; a decimal cast that makes null from
a non-null value raises `[CAST_OVERFLOW]` to an integral type and
`[NUMERIC_VALUE_OUT_OF_RANGE]` to a decimal (JAX messages). Under ANSI
the planner keeps only numeric <-> numeric and decimal casts on the
device (`ansi_supported`, JAX `_tag_cast`); the others run on the host.
"""

from __future__ import annotations

import math

import torch

from .. import types as T
from ..columnar.column import torch_dtype
from .base import EvalContext, Expression, Vec, ansi_raise

__all__ = ["Cast", "device_supported", "host_supported", "ansi_supported",
           "convert"]

_US_PER_DAY = 86_400_000_000
_INT_BOUNDS = {
    torch.int8: (-128, 127),
    torch.int16: (-32768, 32767),
    torch.int32: (-2 ** 31, 2 ** 31 - 1),
    torch.int64: (-2 ** 63, 2 ** 63 - 1),
}
_NUMERIC = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
            T.LongType, T.FloatType, T.DoubleType)


def device_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts this engine computes (the JAX rule without strings)."""
    if src == dst:
        return True
    if isinstance(src, _NUMERIC) and isinstance(dst, _NUMERIC):
        return True
    if isinstance(src, T.DateType):
        return isinstance(dst, (T.TimestampType, T.IntegerType))
    if isinstance(src, T.TimestampType):
        return isinstance(dst, (T.DateType, T.LongType))
    if isinstance(src, T.LongType) and isinstance(dst, T.TimestampType):
        return True
    if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
        return True
    if isinstance(src, _NUMERIC) and isinstance(dst, T.DecimalType):
        return not T.is_floating(src)
    if isinstance(src, T.DecimalType) and isinstance(dst, _NUMERIC):
        return True
    return False


_CARRIED = _NUMERIC + (T.DecimalType, T.DateType, T.TimestampType)


def host_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts this engine computes: the device ones, and on the host
    every other pair of the carried types but strings."""
    return device_supported(src, dst) or (isinstance(src, _CARRIED)
                                          and isinstance(dst, _CARRIED))


def ansi_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts the device runs under ANSI (JAX `_tag_cast`): numeric
    <-> numeric and any cast from or to a decimal. The date and timestamp
    casts go to the host engine, as in the JAX planner."""
    plain = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
             T.LongType, T.FloatType, T.DoubleType)
    return (isinstance(src, plain) and isinstance(dst, plain)) or \
        isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType)


def _float_to_int(a: torch.Tensor, want: torch.dtype):
    """Java `(long)(double)` into `want`: NaN -> 0, clamp to the bounds,
    truncate. Returns (values, overflow), overflow True where the value was
    NaN or out of range. The bound 2^(bits-1) is exact in a double;
    float(2^63 - 1) would round up to it and wrap."""
    lo, hi = _INT_BOUNDS[want]
    t = torch.trunc(a.to(torch.float64))
    nan = torch.isnan(t)
    t = torch.where(nan, 0.0, t)
    upper = float(hi) + 1.0
    pos, neg = t >= upper, t < -upper
    i = torch.where(pos | neg, 0.0, t).to(torch.int64)
    i = torch.where(pos, hi, torch.where(neg, lo, i))
    return i.to(want), pos | neg | nan


def convert(data: torch.Tensor, want: torch.dtype) -> torch.Tensor:
    """`data` as `want` by Java's primitive conversion: a floating value
    into an integer type by `_float_to_int`, every other pair as
    `Tensor.to` (integral narrowing wraps). `Tensor.to` alone maps NaN,
    infinities and values out of range to the type's minimum on the CPU."""
    if data.is_floating_point() and want in _INT_BOUNDS:
        return _float_to_int(data, want)[0]
    return data.to(want)


class Cast(Expression):
    def __init__(self, child: Expression, to: T.DataType,
                 ansi: bool = False):
        super().__init__([child])
        self.to = to
        self.ansi = ansi

    @property
    def data_type(self):
        return self.to

    @property
    def nullable(self):
        return True  # a cast can make null from non-null input

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        src, dst = c.dtype, self.to
        if src == dst:
            return c
        if not device_supported(src, dst):
            if c.data.device.type != "cpu":
                raise RuntimeError(
                    f"cast {src.simple_string()} -> {dst.simple_string()} "
                    "runs on the host engine only")
            if T.is_floating(src) and isinstance(dst, T.DecimalType):
                return _float_to_decimal(ctx, c, dst)
            if T.is_integral(src) and isinstance(dst, T.TimestampType):
                return Vec(dst, c.data.to(torch.int64) * 1_000_000,
                           c.validity)
        if isinstance(src, T.DateType) and isinstance(dst, T.TimestampType):
            return Vec(dst, c.data.to(torch.int64) * _US_PER_DAY, c.validity)
        if isinstance(src, T.TimestampType) and isinstance(dst, T.DateType):
            return Vec(dst, torch.div(c.data, _US_PER_DAY,
                                      rounding_mode="floor").to(torch.int32),
                       c.validity)
        if isinstance(src, T.TimestampType) and isinstance(dst, T.LongType):
            return Vec(dst, torch.div(c.data, 1_000_000,
                                      rounding_mode="floor"), c.validity)
        if isinstance(src, T.LongType) and isinstance(dst, T.TimestampType):
            return Vec(dst, c.data * 1_000_000, c.validity)
        if isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType):
            out = _decimal_cast(c, dst)
            if ctx.ansi:
                # every null a decimal cast makes from a non-null value is
                # an overflow (rescale, precision, integral range)
                msg = ("[CAST_OVERFLOW] value cannot be cast to "
                       f"{dst.simple_string()} due to an overflow"
                       if T.is_integral(dst) else
                       "[NUMERIC_VALUE_OUT_OF_RANGE] value out of "
                       f"range for {dst.simple_string()}")
                ansi_raise(ctx, c.validity & ~out.validity, msg)
            return out
        if isinstance(src, T.DateType) and isinstance(dst, T.IntegerType):
            return Vec(dst, c.data, c.validity)
        return _numeric_cast(ctx, c, dst)

    def __repr__(self):
        extra = ", ansi" if self.ansi else ""
        return f"cast({self.children[0]!r} as " \
               f"{self.to.simple_string()}{extra})"


def _numeric_cast(ctx: EvalContext, c: Vec, dst: T.DataType) -> Vec:
    a, want = c.data, torch_dtype(dst)
    if isinstance(dst, T.BooleanType):
        return Vec(dst, a != 0, c.validity)
    msg = (f"[CAST_OVERFLOW] casting {c.dtype.simple_string()} to "
           f"{dst.simple_string()} causes overflow")
    if T.is_floating(c.dtype) and T.is_integral(dst):
        out, overflow = _float_to_int(a, want)
        if ctx.ansi:
            ansi_raise(ctx, overflow & c.validity, msg)
        return Vec(dst, out, c.validity)
    if ctx.ansi and T.is_integral(c.dtype) and T.is_integral(dst) and \
            dst.np_dtype.itemsize < c.dtype.np_dtype.itemsize:
        lo, hi = _INT_BOUNDS[want]
        ansi_raise(ctx, ((a < lo) | (a > hi)) & c.validity, msg)
    # integral narrowing wraps; widening and int <-> float convert
    return Vec(dst, a.to(want), c.validity)


def _decimal_cast(c: Vec, dst: T.DataType) -> Vec:
    from .decimal128 import is_dec128
    src = c.dtype
    if is_dec128(src) or is_dec128(dst):
        return _decimal128_cast(c, dst)
    a = c.data.to(torch.int64)
    if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
        shift = dst.scale - src.scale
        if shift >= 0:
            # bound-check before the multiply, so no int64 wrap can alias
            # back under the limit
            ok = a.abs() < 10 ** max(dst.precision - shift, 0)
            return Vec(dst, torch.where(ok, a, 0) * 10 ** shift,
                       c.validity & ok)
        p = 10 ** -shift
        q = _half_up_div(a, p)
        return Vec(dst, q, c.validity & (q.abs() < 10 ** dst.precision))
    if isinstance(dst, T.DecimalType):  # integral -> decimal
        ok = (a.abs() < 10 ** max(dst.precision - dst.scale, 0)) & \
            (a != -2 ** 63)  # abs(MIN) wraps negative
        return Vec(dst, torch.where(ok, a, 0) * 10 ** dst.scale,
                   c.validity & ok)
    # decimal -> numeric
    if isinstance(dst, T.BooleanType):
        return Vec(dst, a != 0, c.validity)
    if T.is_floating(dst):
        return Vec(dst, (a.to(torch.float64) / 10 ** src.scale)
                   .to(torch_dtype(dst)), c.validity)
    # integral targets truncate exactly in int64 (a double cannot hold
    # every 18-digit value)
    q = torch.div(a, 10 ** src.scale, rounding_mode="trunc")
    lo, hi = _INT_BOUNDS[torch_dtype(dst)]
    ok = (q >= lo) & (q <= hi)
    return Vec(dst, torch.where(ok, q, 0).to(torch_dtype(dst)),
               c.validity & ok)


def _half_up_div(a: torch.Tensor, p: int) -> torch.Tensor:
    """a / p rounded HALF_UP on the magnitude (p > 0, a int64)."""
    m = a.abs()
    q = torch.div(m, p, rounding_mode="floor")
    q = q + ((m - q * p) * 2 >= p).to(torch.int64)
    return torch.where(a < 0, -q, q)


def _decimal128_cast(c: Vec, dst: T.DataType) -> Vec:
    """Casts touching a decimal of more than 18 digits (JAX
    `_decimal128_cast`): a rescale up is exact in the 256-bit chain, a
    rescale down rounds HALF_UP in limbs, and a value past the target
    precision is null; integral sources widen through limbs; to an
    integral type the value truncates exactly through the limbs (null past
    the type's range), to a floating type it goes through the JAX engine's
    double formula (decimal128.to_float64)."""
    from . import decimal128 as D
    src = c.dtype
    if isinstance(dst, T.DecimalType):
        hi, lo = D.widen_operand(c.data)
        shift = dst.scale - src.scale if isinstance(src, T.DecimalType) \
            else dst.scale
        if shift >= 0:
            hi, lo, ok = D.wide_to128(D.wide_mul_pow10(
                D.wide_from128(hi, lo), shift))
        else:
            hi, lo = D.div_pow10_half_up(hi, lo, -shift)
            ok = torch.ones_like(c.validity)
        ok = ok & D.in_bounds(hi, lo, dst.precision)
        data = D.pack_limbs(hi, lo) if D.is_dec128(dst) else lo
        return Vec(dst, data, c.validity & ok)
    # decimal128 -> numeric
    hi, lo = D.widen_operand(c.data)
    if isinstance(dst, T.BooleanType):
        return Vec(dst, (hi != 0) | (lo != 0), c.validity)
    if T.is_floating(dst):
        return Vec(dst, D.to_float64(hi, lo, src.scale).to(torch_dtype(dst)),
                   c.validity)
    qhi, qlo = D.div_pow10_trunc(hi, lo, src.scale)
    lo_b, hi_b = _INT_BOUNDS[torch_dtype(dst)]
    ok = (qhi == (qlo >> 63)) & (qlo >= lo_b) & (qlo <= hi_b)
    return Vec(dst, torch.where(ok, qlo, 0).to(torch_dtype(dst)),
               c.validity & ok)


def _float_to_decimal(ctx: EvalContext, c: Vec, dst: T.DecimalType) -> Vec:
    """Spark's FLOAT/DOUBLE -> DECIMAL, a row at a time on the host: the
    shortest digits of the double (a FLOAT widened first), HALF_UP to the
    scale; NaN, the infinities and a value past the precision are null,
    and raise under ANSI (the JAX decimal message)."""
    import decimal
    from .decimal128 import is_dec128, split_int
    context = decimal.Context(prec=80, rounding=decimal.ROUND_HALF_UP)
    quantum = decimal.Decimal(1).scaleb(-dst.scale)
    limit = 10 ** dst.precision
    valid = c.validity.tolist()
    out, ok = [], []
    for v, live in zip(c.data.to(torch.float64).tolist(), valid):
        u = None
        d = decimal.Decimal(repr(v)) if live and math.isfinite(v) else None
        # past 10^(p - s) before rounding: too wide to quantize, and null
        if d is not None and (d == 0 or
                              d.adjusted() < dst.precision - dst.scale):
            q = d.quantize(quantum, context=context)
            u = int(q.scaleb(dst.scale, context=context))
            if abs(u) >= limit:
                u = None
        out.append(0 if u is None else u)
        ok.append(u is not None)
    ok_t = torch.tensor(ok, dtype=torch.bool)
    if ctx.ansi:
        ansi_raise(ctx, c.validity & ~ok_t,
                   "[NUMERIC_VALUE_OUT_OF_RANGE] value out of range for "
                   f"{dst.simple_string()}")
    if is_dec128(dst):
        data = torch.tensor([list(split_int(u)) for u in out],
                            dtype=torch.int64).reshape(-1, 2)
    else:
        data = torch.tensor(out, dtype=torch.int64)
    return Vec(dst, data, c.validity & ok_t)
