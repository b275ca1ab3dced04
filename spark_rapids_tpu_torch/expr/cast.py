"""Cast (`spark_rapids_tpu/expr/cast.py`: `device_supported`,
`_numeric_cast`, `_decimal_cast`, the date and timestamp casts, and the
casts from and to STRING).

Java semantics: integral narrowing wraps; float -> integral truncates
toward zero, clamps to the target's range and maps NaN to 0 (`convert`,
which the If/CaseWhen/Coalesce merges, Least/Greatest and IntegralDivide
share); -> BOOLEAN is `!= 0`. Decimal casts rescale the unscaled value,
HALF_UP when the scale drops, and a value past the target precision or
integral range is null; a decimal of more than 18 digits on either side
rescales in limbs (`_decimal128_cast`).
DATE -> TIMESTAMP is midnight UTC, TIMESTAMP -> DATE and -> LONG
floor-divide (days, seconds), LONG -> TIMESTAMP multiplies seconds.

To STRING (`_to_string`): BOOLEAN as true/false, the integral types as
their decimal digits (INT64_MIN too: the digits come from the value's
non-positive form), DATE as yyyy-MM-dd for years 0-9999. From STRING
(`_from_string`), after trimming ASCII whitespace: the integral types by
`Long.parseLong`'s rule (overflow and anything else are null, never a
wrapped value), BOOLEAN by Spark's true/false words, DATE by
`stringToDate`'s grammar, FLOAT/DOUBLE exactly to the bit through
expr/floatparse.py (a FLOAT rounds through the double). Under ANSI a
non-null string that parses to null raises `[CAST_INVALID_INPUT]`.

The casts that `device_supported` (the JAX device rule) refuses run on the
host engine only (`host_only`; a CUDA tensor raises). Three follow Spark's
rule where the JAX CPU engine departs from it (ROADMAP.md "Known
differences"): FLOAT/DOUBLE -> DECIMAL takes the shortest decimal digits
that give the double back (Python's `repr`, Java's `Double.toString` from
JDK 19 on) rounded HALF_UP to the scale, null for NaN, infinities and
values past the precision; FLOAT/DOUBLE -> STRING lays those shortest
digits out as `Double.toString`/`Float.toString` does (`java_float_str`);
BYTE/SHORT/INT -> TIMESTAMP reads seconds, as LONG -> TIMESTAMP does. The
rest (DATE -> numeric, numeric -> DATE, TIMESTAMP -> numeric other than
LONG, BOOLEAN/FLOAT/DOUBLE/DECIMAL -> TIMESTAMP) give the JAX CPU engine's
values through the paths below; their Spark rule waits for confirmation
(ROADMAP.md Queue C). STRING -> DECIMAL/TIMESTAMP and DECIMAL/TIMESTAMP
-> STRING follow Spark's rule in expr/textcasts.py, where the JAX CPU
engine computes another value or fails.

ANSI mode (`ctx.ansi`) raises where the non-ANSI cast clamps, wraps or
makes null: float -> integral out of range or NaN and integral narrowing
out of range raise `[CAST_OVERFLOW]`; a decimal cast that makes null from
a non-null value raises `[CAST_OVERFLOW]` to an integral type and
`[NUMERIC_VALUE_OUT_OF_RANGE]` to a decimal (JAX messages). Under ANSI
the planner keeps numeric <-> numeric, decimal and string-parse casts on
the device (`ansi_supported`, JAX `_tag_cast`); the others run on the
host.
"""

from __future__ import annotations

import decimal
import math

import numpy as np
import torch

from .. import types as T
from ..columnar.column import torch_dtype
from .base import EvalContext, Expression, Vec, ansi_raise
from .datetime_ import civil_from_days, days_from_civil
from .floatparse import compose_float64, mul10_add

__all__ = ["Cast", "device_supported", "host_supported", "ansi_supported",
           "convert", "java_float_str"]

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
    """The casts the device computes (the JAX rule)."""
    if src == dst:
        return True
    if isinstance(src, _NUMERIC) and isinstance(dst, _NUMERIC):
        return True
    if isinstance(src, _NUMERIC) and isinstance(dst, T.StringType):
        return not T.is_floating(src)  # float -> string is host-only
    if isinstance(src, T.StringType):
        return isinstance(dst, (T.ByteType, T.ShortType, T.IntegerType,
                                T.LongType, T.BooleanType, T.DateType,
                                T.FloatType, T.DoubleType))
    if isinstance(src, T.DateType):
        return isinstance(dst, (T.StringType, T.TimestampType,
                                T.IntegerType))
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


def _text_cast(src: T.DataType, dst: T.DataType) -> bool:
    """STRING -> DECIMAL/TIMESTAMP and DECIMAL/TIMESTAMP -> STRING
    (expr/textcasts.py)."""
    timeish = (T.DecimalType, T.TimestampType)
    return (isinstance(src, T.StringType) and isinstance(dst, timeish)) or \
        (isinstance(src, timeish) and isinstance(dst, T.StringType))


def host_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts this engine computes: the device ones, and on the host
    every other pair of the carried types, FLOAT/DOUBLE -> STRING and the
    four casts between STRING and DECIMAL/TIMESTAMP."""
    return device_supported(src, dst) or (
        isinstance(src, _CARRIED) and isinstance(dst, _CARRIED)) or (
        T.is_floating(src) and isinstance(dst, T.StringType)) or \
        _text_cast(src, dst)


def ansi_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts the device runs under ANSI (JAX `_tag_cast`): numeric
    <-> numeric, any cast from or to a decimal, and the string parses to
    the integral, floating, BOOLEAN and DATE types. The other date and
    timestamp casts go to the host engine, as in the JAX planner."""
    plain = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
             T.LongType, T.FloatType, T.DoubleType)
    return (isinstance(src, plain) and isinstance(dst, plain)) or \
        isinstance(src, T.DecimalType) or isinstance(dst, T.DecimalType) \
        or (isinstance(src, T.StringType) and
            isinstance(dst, plain + (T.DateType,)))


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
            if T.is_floating(src) and isinstance(dst, T.StringType):
                return _float_to_string(c)
            if T.is_floating(src) and isinstance(dst, T.DecimalType):
                return _float_to_decimal(ctx, c, dst)
            if T.is_integral(src) and isinstance(dst, T.TimestampType):
                return Vec(dst, c.data.to(torch.int64) * 1_000_000,
                           c.validity)
            if _text_cast(src, dst):
                from . import textcasts as TC
                if isinstance(dst, T.DecimalType):
                    return TC.string_to_decimal(ctx, c, dst)
                if isinstance(dst, T.TimestampType):
                    return TC.string_to_timestamp(ctx, c)
                if isinstance(src, T.DecimalType):
                    return TC.decimal_to_string(c)
                return TC.timestamp_to_string(c)
        if isinstance(dst, T.StringType):
            return _to_string(c)
        if isinstance(src, T.StringType):
            out = _from_string(c, dst)
            if ctx.ansi:
                # a non-null string that parsed to null: malformed or out
                # of range
                ansi_raise(ctx, c.validity & ~out.validity,
                           "[CAST_INVALID_INPUT] value cannot be cast to "
                           f"{dst.simple_string()}")
            return out
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


# ---------------------------------------------------------------------------
# To STRING
# ---------------------------------------------------------------------------

def _cols(w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int64, device=device)[None, :]


def _digits_to_matrix(value: torch.Tensor, width: int):
    """Signed int64 -> (uint8[n, width] digits, left-aligned with a '-' for
    a negative value, zero past the length; int32 lengths). The digits
    come from -|value|, which INT64_MIN has, by truncating division."""
    neg = value < 0
    nonpos = torch.where(neg, value, -value)
    digs, rem = [], nonpos
    for _ in range(width):
        digs.append(-torch.fmod(rem, 10))
        rem = torch.div(rem, 10, rounding_mode="trunc")
    mat = torch.stack(digs[::-1], dim=1)  # most significant first
    ndig = torch.ones_like(value)
    for k in range(1, 19):  # 10^19 is past int64: 19 digits at most
        ndig = ndig + (nonpos <= -10 ** k).to(torch.int64)
    ineg = neg.to(torch.int64)
    total = ndig + ineg
    j = _cols(width, value.device)
    src = torch.clamp(width - ndig[:, None] + j - ineg[:, None], 0,
                      width - 1)
    out = torch.gather(mat, 1, src) + ord("0")
    out = torch.where((j == 0) & neg[:, None], ord("-"), out)
    out = torch.where(j < total[:, None], out, 0)
    return out.to(torch.uint8), total.to(torch.int32)


def _word_rows(words, w: int, device) -> torch.Tensor:
    rows = torch.zeros((len(words), w), dtype=torch.uint8)
    for i, word in enumerate(words):
        rows[i, :len(word)] = torch.tensor(list(word), dtype=torch.uint8)
    return rows.to(device)


def _to_string(c: Vec) -> Vec:
    """BOOLEAN, the integral types and DATE on either device (JAX
    `_to_string`)."""
    sd, dev = c.dtype, c.data.device
    if isinstance(sd, T.BooleanType):
        rows = _word_rows((b"false", b"true"), 8, dev)
        pick = c.data.to(torch.int64)
        return Vec(T.STRING, rows[pick], c.validity,
                   torch.where(c.data, 4, 5).to(torch.int32))
    if T.is_integral(sd):
        out, total = _digits_to_matrix(c.data.to(torch.int64), 24)
        return Vec(T.STRING, out, c.validity, total)
    if isinstance(sd, T.DateType):
        # yyyy-MM-dd for years 0..9999 (the JAX layout)
        y, m, d = (v.to(torch.int64) for v in civil_from_days(c.data))
        n = c.data.shape[0]
        dash = torch.full((n,), ord("-"), dtype=torch.int64, device=dev)

        def digit(v, p):
            return torch.remainder(torch.div(v, p, rounding_mode="floor"),
                                   10) + ord("0")

        cols = [digit(y, 1000), digit(y, 100), digit(y, 10), digit(y, 1),
                dash, digit(m, 10), digit(m, 1), dash, digit(d, 10),
                digit(d, 1)]
        data = torch.nn.functional.pad(torch.stack(cols, dim=1), (0, 6))
        return Vec(T.STRING, data.to(torch.uint8), c.validity,
                   torch.full((n,), 10, dtype=torch.int32, device=dev))
    raise TypeError(f"cast {sd.simple_string()} -> string is not computed "
                    "by this engine")


def java_float_str(v: float, is_float: bool) -> str:
    """Java's `Double.toString` (`Float.toString` for a FLOAT), from JDK
    19 on: the shortest decimal digits that give the value back (Python's
    `repr` for a double, numpy's shortest form for a float32), or, where
    one digit is enough, the closest of the one- and two-digit decimals
    that do (4.9E-324, not 5E-324); written plain when 10^-3 <= |v| <
    10^7 and as d.dddEn otherwise, with at least one digit after the
    point. Spark's cast to STRING prints this."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == 0:
        return "-0.0" if math.copysign(1.0, v) < 0 else "0.0"
    if is_float:
        v = float(np.float32(v))
    d = decimal.Decimal(str(np.float32(v)) if is_float else repr(v))
    if len(d.as_tuple().digits) == 1:
        exact = decimal.Decimal(v)
        two = decimal.Context(prec=2).plus(exact)
        back = float(np.float32(float(two))) if is_float else float(two)
        if back == v and abs(two - exact) < abs(d - exact):
            d = two
    digits = "".join(map(str, d.as_tuple().digits)).lstrip("0").rstrip("0")
    e = d.adjusted()  # the exponent of the leading digit
    sign = "-" if v < 0 else ""
    if 1e-3 <= abs(v) < 1e7:
        if e >= 0:
            whole = digits[:e + 1].ljust(e + 1, "0")
            frac = digits[e + 1:] or "0"
        else:
            whole, frac = "0", "0" * (-e - 1) + digits
        return f"{sign}{whole}.{frac}"
    return f"{sign}{digits[0]}.{digits[1:] or '0'}E{e}"


def _float_to_string(c: Vec) -> Vec:
    """FLOAT/DOUBLE -> STRING on the host, a row at a time
    (`java_float_str`), at the bucket of the longest row."""
    from .strings import strings_to_vec
    is_float = isinstance(c.dtype, T.FloatType)
    return strings_to_vec([java_float_str(v, is_float) if live else None
                           for v, live in zip(c.data.to(torch.float64)
                                              .tolist(),
                                              c.validity.tolist())],
                          c.validity)


# ---------------------------------------------------------------------------
# From STRING
# ---------------------------------------------------------------------------

def _byte_at(chars: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """chars[i, pos[i]] with pos clamped into the row."""
    pos = torch.clamp(pos, 0, chars.shape[1] - 1).to(torch.int64)
    return torch.gather(chars, 1, pos[:, None])[:, 0]


def _trimmed(chars: torch.Tensor, lengths: torch.Tensor):
    """(first, last, any): the token between the bytes <= 0x20 at either
    end of each row (Java's String.trim)."""
    w = chars.shape[1]
    content = (_cols(w, chars.device) < lengths[:, None]) & (chars > 0x20)
    first = content.to(torch.uint8).argmax(dim=1).to(torch.int64)
    last = w - 1 - content.flip(1).to(torch.uint8).argmax(dim=1) \
        .to(torch.int64)
    return first, last, content.any(dim=1)


def _from_string(c: Vec, dst: T.DataType) -> Vec:
    """JAX `_from_string`: trim ASCII whitespace (bytes <= 0x20), then
    parse by the target type."""
    first, last, any_c = _trimmed(c.data, c.lengths)
    j = _cols(c.data.shape[1], c.data.device)
    if isinstance(dst, T.BooleanType):
        return _parse_bool(c, first, last, any_c)
    if isinstance(dst, T.DateType):
        return _parse_date(c, first, last, any_c)
    if T.is_floating(dst):
        return _parse_float(c, first, last, any_c, dst)
    return _parse_integral(c, j, first, last, any_c, dst)


def _parse_integral(c: Vec, j, first, last, any_c, dst) -> Vec:
    """[+-]?digits with `Long.parseLong`'s overflow rule: accumulate the
    negative value (so Long.MIN_VALUE parses); overflow is null."""
    chars = c.data
    ch0 = _byte_at(chars, first)
    neg = ch0 == ord("-")
    dstart = first + (neg | (ch0 == ord("+"))).to(torch.int64)
    in_num = (j >= dstart[:, None]) & (j <= last[:, None])
    digit = (chars.to(torch.int64) - ord("0"))
    is_digit = (digit >= 0) & (digit <= 9) & in_num
    valid_num = any_c & (~in_num | is_digit).all(dim=1) & (last >= dstart)
    limit = torch.where(neg, -2 ** 63, -(2 ** 63 - 1))
    multmin = -922337203685477580  # trunc(limit / 10), either sign
    acc = torch.zeros_like(first)
    ovf = torch.zeros_like(any_c)
    for k in range(chars.shape[1]):
        active = in_num[:, k] & valid_num
        d = torch.where(active, digit[:, k], 0)
        ovf = ovf | (active & (acc < multmin))
        # clamped: a row past multmin has overflowed, and no product
        # leaves int64
        acc10 = torch.clamp(acc, min=multmin) * 10
        ovf = ovf | (active & (acc10 < limit + d))
        acc = torch.where(active & ~ovf, acc10 - d, acc)
    signed = torch.where(neg, acc, -acc)
    lo, hi = _INT_BOUNDS[torch_dtype(dst)]
    in_range = (signed >= lo) & (signed <= hi) & ~ovf
    return Vec(dst, torch.where(in_range, signed, 0).to(torch_dtype(dst)),
               c.validity & valid_num & in_range)


def _parse_float(c: Vec, first, last, any_c, dst) -> Vec:
    """JAX `_parse_float_device`, on either device: a per-row phase (sign /
    integer / fraction / exponent sign / exponent digits) advances down
    the byte columns, the mantissa accumulates exactly in 128 bits (up to
    38 significant digits; a dropped nonzero tail sets a sticky bit), and
    compose_float64 rounds M x 10^E to float64 with integer arithmetic.
    NaN, Infinity and Inf (any case, signed) are words. A FLOAT rounds
    through the correctly rounded double (double rounding can differ from
    `Float.parseFloat` by 1 ulp at rare boundaries, as in JAX)."""
    chars = c.data
    n, w = chars.shape
    jcol = _cols(w, chars.device)
    inside = (jcol >= first[:, None]) & (jcol <= last[:, None])
    lower = torch.where((chars >= 65) & (chars <= 90), chars + 32, chars)
    ln = last - first + 1

    def word_eq(word: bytes, off):
        m = ln == (len(word) + off)
        for i, by in enumerate(word):
            m = m & (_byte_at(lower, first + off + i) == by)
        return m

    lead = _byte_at(lower, first)
    signed_minus = lead == ord("-")
    off0 = (signed_minus | (lead == ord("+"))).to(torch.int64)
    is_nan = word_eq(b"nan", 0) | word_eq(b"nan", off0)
    is_inf = torch.zeros_like(any_c)
    for word in (b"infinity", b"inf"):
        is_inf = is_inf | word_eq(word, 0) | word_eq(word, off0)

    ph_sign, ph_int, ph_frac, ph_esign, ph_exp = 0, 1, 2, 3, 4
    zi = torch.zeros_like(first)
    zb = torch.zeros_like(any_c)
    phase = zi.clone()
    mhi, mlo = zi.clone(), zi.clone()   # the mantissa, 128-bit exact
    msticky = zb.clone()                # a nonzero digit dropped past 38
    mdigits = zi.clone()                # significant digits kept
    idigits = zi.clone()                # integer digits past the kept 38
    fdigits = zi.clone()                # fraction digits kept
    any_digit, neg, seen_sign, seen_esign, eneg = (zb.clone()
                                                   for _ in range(5))
    eval_ = zi.clone()
    any_edigit, bad = zb.clone(), zb.clone()
    for j in range(w):
        ch = lower[:, j]
        act = inside[:, j]
        d = ch.to(torch.int64) - ord("0")
        is_digit = (d >= 0) & (d <= 9) & act
        is_dot = (ch == ord(".")) & act
        is_e = (ch == ord("e")) & act
        is_minus = (ch == ord("-")) & act
        is_plus = (ch == ord("+")) & act
        other = act & ~(is_digit | is_dot | is_e | is_minus | is_plus)
        sign_ok = (is_minus | is_plus) & (phase == ph_sign) & ~seen_sign
        seen_sign = seen_sign | sign_ok
        neg = neg | (is_minus & sign_ok)
        esign_ok = (is_minus | is_plus) & (phase == ph_esign) & ~seen_esign
        seen_esign = seen_esign | esign_ok
        eneg = eneg | (is_minus & esign_ok)
        in_mant = is_digit & (phase <= ph_frac)
        # leading zeros are not significant: they use none of the 38-digit
        # budget, though fraction ones still shift the exponent
        lead_zero = in_mant & (d == 0) & (mhi == 0) & (mlo == 0)
        keep = in_mant & ~lead_zero & (mdigits < 38)
        thi, tlo = mul10_add(mhi, mlo, torch.where(keep, d, 0))
        mhi = torch.where(keep, thi, mhi)
        mlo = torch.where(keep, tlo, mlo)
        dropped = in_mant & ~lead_zero & ~keep
        msticky = msticky | (dropped & (d > 0))
        mdigits = mdigits + keep.to(torch.int64)
        idigits = idigits + (dropped & (phase <= ph_int)).to(torch.int64)
        fdigits = fdigits + ((keep | lead_zero) &
                             (phase == ph_frac)).to(torch.int64)
        any_digit = any_digit | in_mant
        in_exp = is_digit & ((phase == ph_esign) | (phase == ph_exp))
        eval_ = torch.where(in_exp, torch.clamp(eval_ * 10 + d, max=9999),
                            eval_)
        any_edigit = any_edigit | in_exp
        bad = bad | other | (is_dot & (phase >= ph_frac)) | \
            (is_e & ((phase > ph_frac) | ~any_digit)) | \
            ((is_minus | is_plus) & ~sign_ok & ~esign_ok)
        phase = torch.where(is_digit & (phase == ph_sign), ph_int, phase)
        phase = torch.where(is_dot & (phase <= ph_int), ph_frac, phase)
        phase = torch.where(is_e & (phase <= ph_frac), ph_esign, phase)
        phase = torch.where(in_exp, ph_exp, phase)
    bad = bad | ~any_digit | \
        (((phase == ph_esign) | (phase == ph_exp)) & ~any_edigit)
    dexp = torch.where(eneg, -eval_, eval_) + idigits - fdigits
    val = compose_float64(mhi, mlo, msticky, dexp, neg)
    val = torch.where(is_nan, math.nan, val)
    val = torch.where(is_inf, torch.where(signed_minus, -math.inf, math.inf),
                      val)
    ok = c.validity & any_c & (is_nan | is_inf | ~bad)
    out = val.to(torch_dtype(dst))
    return Vec(dst, torch.where(ok, out, 0), ok)


def _parse_bool(c: Vec, first, last, any_c) -> Vec:
    """Spark's `StringUtils.isTrueString`/`isFalseString`: t, true, y, yes,
    1 and f, false, n, no, 0, any case."""
    chars = c.data
    ln = last - first + 1

    def word_is(word: bytes):
        m = ln == len(word)
        for i, b in enumerate(word):
            ch = _byte_at(chars, first + i)
            m = m & (torch.where((ch >= 65) & (ch <= 90), ch + 32, ch) == b)
        return m

    t = word_is(b"true") | word_is(b"t") | word_is(b"yes") | \
        word_is(b"y") | word_is(b"1")
    f = word_is(b"false") | word_is(b"f") | word_is(b"no") | \
        word_is(b"n") | word_is(b"0")
    return Vec(T.BOOLEAN, t, c.validity & any_c & (t | f))


def _parse_date(c: Vec, first, last, any_c) -> Vec:
    """Spark `DateTimeUtils.stringToDate`'s grammar: yyyy | yyyy-[m]m |
    yyyy-[m]m-[d]d, the full form optionally followed by a 'T' or space
    segment (ignored); the year 4-7 digits, in 1..9999, the day within its
    month; anything else is null."""
    chars = c.data
    w = chars.shape[1]
    j = _cols(w, chars.device)
    in_tok = (j >= first[:, None]) & (j <= last[:, None])
    sep = ((chars == ord("T")) | (chars == ord(" "))) & in_tok
    has_sep = sep.any(dim=1)
    sep_at = torch.where(has_sep, sep.to(torch.uint8).argmax(dim=1), w)
    last = torch.minimum(last, sep_at - 1)
    in_tok = (j >= first[:, None]) & (j <= last[:, None])
    dash = (chars == ord("-")) & in_tok & (j != first[:, None])
    ndash = dash.sum(dim=1)
    d1 = dash.to(torch.uint8).argmax(dim=1)
    d2 = (dash & (j > d1[:, None])).to(torch.uint8).argmax(dim=1)
    digit = chars.to(torch.int64) - ord("0")
    is_digit = (digit >= 0) & (digit <= 9)

    def parse_num(lo, hi):
        good = hi >= lo
        acc = torch.zeros_like(lo)
        for k in range(w):
            inside = (k >= lo) & (k <= hi)
            good = good & (~inside | is_digit[:, k])
            # capped: no valid segment passes 7 digits, and no product
            # leaves int64
            acc = torch.where(inside & good,
                              torch.clamp(acc, max=10 ** 12) * 10
                              + digit[:, k], acc)
        return acc, good

    one = torch.ones_like(first)
    y_end = torch.where(ndash >= 1, d1 - 1, last)
    m_end = torch.where(ndash == 2, d2 - 1, last)
    y, gy = parse_num(first, y_end)
    m_p, gm_p = parse_num(d1 + 1, m_end)
    d_p, gd_p = parse_num(d2 + 1, last)
    m = torch.where(ndash >= 1, m_p, one)
    gm = torch.where(ndash >= 1, gm_p, True)
    d = torch.where(ndash == 2, d_p, one)
    gd = torch.where(ndash == 2, gd_p, True)
    y_len = y_end - first + 1
    m_len = torch.where(ndash >= 1, m_end - d1, 1)
    d_len = torch.where(ndash == 2, last - d2, 1)
    digits_ok = (y_len >= 4) & (y_len <= 7) & (m_len >= 1) & \
        (m_len <= 2) & (d_len >= 1) & (d_len <= 2)
    ok = any_c & (ndash <= 2) & (~has_sep | (ndash == 2)) & gy & gm & gd & \
        digits_ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31) & \
        (y >= 1) & (y <= 9999)
    days = days_from_civil(torch.where(ok, y, 1970), torch.where(ok, m, 1),
                           torch.where(ok, d, 1))
    # a day past its month's end does not round-trip
    y2, m2, dd2 = civil_from_days(days)
    ok = ok & (y2.to(torch.int64) == y) & (m2.to(torch.int64) == m) & \
        (dd2.to(torch.int64) == d)
    return Vec(T.DATE, days.to(torch.int32), c.validity & ok)
