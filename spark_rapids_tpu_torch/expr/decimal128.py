"""Decimal128 limb arithmetic (`spark_rapids_tpu/expr/decimal128.py`).

A decimal of precision <= 18 is its int64 unscaled value. A wider one is
its 128-bit two's-complement unscaled value as two int64 limbs in
`data[cap, 2]`: column 0 the signed high limb (bits 64..127), column 1 the
low limb's bit pattern (bits 0..63), as in the JAX package. The rank-2
shape is the one string byte matrices have, so gathers, compaction,
concatenation and the exchange move limb columns unchanged; value
semantics (adds, compares, rescales, reductions) live here.

Every limb stays int64: torch's uint64 has few kernels, on CUDA fewest.
So, where the JAX package reinterprets as uint64:
  * an unsigned compare flips the sign bit of both sides first (`ult`),
    and carries come from such compares;
  * `>>` on int64 is arithmetic, so a logical shift masks after it;
  * a multiply or a division splits a value into 32-bit limbs, each held
    in an int64, and multiplies or divides by at most 10^9 (< 2^30) a
    step, so every partial product, carry and remainder fits in 63 bits.
    The JAX package multiplies by up to 10^19 and divides by 10 a step in
    uint64; the results are the same integers.

Adding, subtracting and comparing at a common scale can need more than
128 bits (a 38-digit value rescaled by 10 digits): those paths take the
256-bit `wide_*` chain, eight 32-bit limbs, least significant first.

Sum aggregation splits each value into four 32-bit chunks (`sum_chunks`),
sums each by group as an ordinary int64 sum, and recombines the sums in
limb arithmetic (`sum_recombine`). The JAX package splits into three
43-bit chunks, whose sums overflow int64 once a group of one batch holds
more than 2^20 rows (ROADMAP "Known differences"); 32-bit chunks stay
exact up to 2^31 rows a group, more than a batch holds.
"""

from __future__ import annotations

import decimal as _decimal
from typing import List, Tuple

import torch

from .. import types as T

__all__ = ["is_dec128", "split_int", "join_int", "to_decimal",
           "unscaled_int", "literal_type", "adjust_precision_scale",
           "add_result_type", "ult", "widen_operand", "pack_limbs",
           "limbs_of", "add128", "neg128", "abs128", "lt128", "eq128",
           "cmp_keys", "mul_pow10", "div_pow10_half_up",
           "div_pow10_trunc", "divmod_rows", "in_bounds", "wide_from128",
           "wide_add", "wide_neg", "wide_is_neg", "wide_mul_pow10",
           "wide_div_pow10_half_up", "wide_to128", "wide_cmp",
           "sum_chunks", "sum_recombine", "SUM_CHUNK_BITS", "to_float64"]

_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
# the largest power of ten a multiply or division step takes (< 2^30)
_STEP_DIGITS = 9
SUM_CHUNK_BITS = 32
# exact context for the host-side Decimal <-> unscaled int conversion
_EXACT_CTX = _decimal.Context(prec=80)


is_dec128 = T.is_dec128


def split_int(v: int) -> Tuple[int, int]:
    """Python int -> (hi signed, lo bit pattern as a signed int64)."""
    u = v & ((1 << 128) - 1)

    def s64(x):
        return x - (1 << 64) if x >= (1 << 63) else x
    return s64(u >> 64), s64(u & ((1 << 64) - 1))


def join_int(hi: int, lo: int) -> int:
    """(hi signed, lo bit pattern) -> Python int."""
    u = ((hi & ((1 << 64) - 1)) << 64) | (lo & ((1 << 64) - 1))
    return u - (1 << 128) if u >= (1 << 127) else u


def unscaled_int(d: _decimal.Decimal, scale: int) -> int:
    """Decimal value -> exact unscaled int at `scale`."""
    return int(_EXACT_CTX.scaleb(d, scale))


def to_decimal(unscaled: int, scale: int) -> _decimal.Decimal:
    """Exact unscaled int at `scale` -> Decimal."""
    return _EXACT_CTX.scaleb(_decimal.Decimal(unscaled), -scale)


def literal_type(d: _decimal.Decimal) -> T.DecimalType:
    """Spark's type of a decimal literal: its digits and its scale
    (`Literal(BigDecimal)`: decimal(max(precision, scale), scale))."""
    sign, digits, exp = d.as_tuple()
    scale = max(-exp, 0)
    precision = len(digits) + max(exp, 0)
    return T.DecimalType(max(precision, scale, 1), scale)


def adjust_precision_scale(p: int, s: int) -> T.DecimalType:
    """Spark DecimalType.adjustPrecisionScale (allowPrecisionLoss=true):
    past 38 digits keep the integral digits and give the fraction what is
    left, but never fewer than min(s, 6) digits."""
    if p <= T.DecimalType.MAX_PRECISION:
        return T.DecimalType(p, s)
    int_digits = p - s
    min_scale = min(s, 6)
    adjusted = max(T.DecimalType.MAX_PRECISION - int_digits, min_scale)
    return T.DecimalType(T.DecimalType.MAX_PRECISION, adjusted)


def add_result_type(a: T.DecimalType, b: T.DecimalType) -> T.DecimalType:
    """Spark decimal +/- result: scale max(s1, s2), precision
    max(p1 - s1, p2 - s2) + scale + 1, then adjustPrecisionScale."""
    s = max(a.scale, b.scale)
    p = max(a.precision - a.scale, b.precision - b.scale) + s + 1
    return adjust_precision_scale(p, s)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b with both int64 read as unsigned 64-bit."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def widen_operand(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decimal's data -> (hi, lo): the limbs of a [cap, 2] buffer, or a
    64-bit decimal's int64 values sign-extended."""
    if data.dim() == 2:
        return data[:, 0], data[:, 1]
    lo = data.to(torch.int64)
    return lo >> 63, lo


def pack_limbs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=1)


def limbs_of(value: int, like: torch.Tensor):
    """A Python int's (hi, lo) as tensors shaped like `like`."""
    hi, lo = split_int(value)
    return torch.full_like(like, hi), torch.full_like(like, lo)


def add128(ahi, alo, bhi, blo):
    """(ahi, alo) + (bhi, blo), wrapping at 128 bits."""
    lo = alo + blo
    carry = ult(lo, alo).to(torch.int64)
    return ahi + bhi + carry, lo


def neg128(hi, lo):
    nlo = ~lo + 1
    carry = (nlo == 0).to(torch.int64)
    return ~hi + carry, nlo


def abs128(hi, lo):
    """(|value| hi, lo, value < 0); -2^127 stays -2^127."""
    neg = hi < 0
    nhi, nlo = neg128(hi, lo)
    return torch.where(neg, nhi, hi), torch.where(neg, nlo, lo), neg


def lt128(ahi, alo, bhi, blo):
    """Signed (ahi, alo) < (bhi, blo)."""
    return (ahi < bhi) | ((ahi == bhi) & ult(alo, blo))


def eq128(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def cmp_keys(hi, lo):
    """Sort keys (hi, lo with its sign bit flipped): an ascending two-key
    signed sort is the signed 128-bit order."""
    return hi, lo ^ _SIGN


def _split32(hi, lo) -> List[torch.Tensor]:
    """128-bit -> four 32-bit limbs in int64, least significant first."""
    return [lo & _MASK32, (lo >> 32) & _MASK32, hi & _MASK32,
            (hi >> 32) & _MASK32]


def _join32(l0, l1, l2, l3):
    return (l2 & _MASK32) | (l3 << 32), (l0 & _MASK32) | (l1 << 32)


def _mul_small(limbs: List[torch.Tensor], m: int) -> List[torch.Tensor]:
    """32-bit limbs * m (0 < m < 2^31), wrapping at their width: every
    product plus carry stays below 2^63."""
    out, carry = [], None
    for limb in limbs:
        acc = limb * m if carry is None else limb * m + carry
        out.append(acc & _MASK32)
        carry = acc >> 32
    return out


def mul_pow10(hi, lo, k: int):
    """(hi, lo) * 10^k (k >= 0), wrapping at 128 bits (the caller checks
    bounds, or takes the wide chain)."""
    if k <= 0:
        return hi, lo
    limbs = _split32(hi, lo)
    while k > 0:
        step = min(k, _STEP_DIGITS)
        limbs = _mul_small(limbs, 10 ** step)
        k -= step
    return _join32(*limbs)


def _divmod_small(limbs: List[torch.Tensor], d):
    """Unsigned 32-bit limbs (least significant first) // d, for d (an int
    or an int64 tensor a row) in (0, 2^31): long division from the top
    limb; each partial dividend is below d * 2^32 < 2^63."""
    q = [None] * len(limbs)
    rem = torch.zeros_like(limbs[0])
    for k in range(len(limbs) - 1, -1, -1):
        acc = (rem << 32) | limbs[k]
        q[k] = torch.div(acc, d, rounding_mode="floor")
        rem = acc - q[k] * d
    return q, rem


def _div_pow10_limbs(limbs, k: int):
    """limbs // 10^k in steps of at most 10^9."""
    while k > 0:
        step = min(k, _STEP_DIGITS)
        limbs, _ = _divmod_small(limbs, 10 ** step)
        k -= step
    return limbs


def div_pow10_half_up(hi, lo, k: int):
    """(hi, lo) / 10^k rounded HALF_UP on the magnitude (Spark's decimal
    rescale): drop k-1 digits, then the last one, which decides."""
    if k <= 0:
        return hi, lo
    mhi, mlo, neg = abs128(hi, lo)
    limbs = _div_pow10_limbs(_split32(mhi, mlo), k - 1)
    limbs, last = _divmod_small(limbs, 10)
    qhi, qlo = _join32(*limbs)
    ihi, ilo = add128(qhi, qlo, torch.zeros_like(qhi), torch.ones_like(qlo))
    up = last >= 5
    qhi, qlo = torch.where(up, ihi, qhi), torch.where(up, ilo, qlo)
    nhi, nlo = neg128(qhi, qlo)
    return torch.where(neg, nhi, qhi), torch.where(neg, nlo, qlo)


def div_pow10_trunc(hi, lo, k: int):
    """(hi, lo) / 10^k truncated toward zero (Spark's Decimal.toLong, for
    casts to integral types)."""
    if k <= 0:
        return hi, lo
    mhi, mlo, neg = abs128(hi, lo)
    qhi, qlo = _join32(*_div_pow10_limbs(_split32(mhi, mlo), k))
    nhi, nlo = neg128(qhi, qlo)
    return torch.where(neg, nhi, qhi), torch.where(neg, nlo, qlo)


def divmod_rows(hi, lo, d, small: bool):
    """Unsigned 128-bit (hi, lo) divided by d (int64, 1 <= d < 2^63), per
    row: (quotient hi, lo, remainder). With `small` (every d below 2^31)
    by 32-bit limbs; else restoring division, one bit a step from the top:
    the remainder stays below d, so twice it plus a bit is below 2^64 and
    compares unsigned. JAX's `_divmod_u32` takes only a constant divisor
    below 2^32; a group's row count can be larger."""
    if small:
        q, rem = _divmod_small(_split32(hi, lo), d)
        return _join32(*q) + (rem,)
    rem = torch.zeros_like(lo)
    q = [torch.zeros_like(hi), torch.zeros_like(lo)]
    for w, word in enumerate((hi, lo)):
        for b in range(63, -1, -1):
            rem = (rem << 1) | ((word >> b) & 1)
            take = ~ult(rem, d)
            rem = torch.where(take, rem - d, rem)
            q[w] = q[w] | (take.to(torch.int64) << b)
    return q[0], q[1], rem


def in_bounds(hi, lo, precision: int) -> torch.Tensor:
    """|value| <= 10^precision - 1 (Spark's overflow check)."""
    bhi, blo = limbs_of(10 ** precision - 1, hi)
    mhi, mlo, _ = abs128(hi, lo)
    # -2^127 is its own negation: its magnitude stays negative
    return ~(lt128(bhi, blo, mhi, mlo) | (mhi < 0))


def to_float64(hi, lo, scale: int) -> torch.Tensor:
    """The JAX engine's decimal128 -> double: (hi * 2^64 + u(lo)) / 10^s,
    each step rounded once as a double. u(lo), the low limb read unsigned,
    is its two 32-bit halves, each exact in a double, added with one
    rounding, as a uint64 -> double conversion rounds."""
    ulo = ((lo >> 32) & _MASK32).to(torch.float64) * 2.0 ** 32 + \
        (lo & _MASK32).to(torch.float64)
    return (hi.to(torch.float64) * 2.0 ** 64 + ulo) / float(10 ** scale)


# ---------------------------------------------------------------------------
# 256-bit "wide" arithmetic: 8 x 32-bit limbs, least significant first, each
# in an int64. Rescaling a 38-digit value by up to 38 more digits needs
# about 10^76 < 2^253, so a 256-bit intermediate makes +/-, casts and
# compares exact, with overflow found on the narrowing back to 128 bits.
# ---------------------------------------------------------------------------

_WIDE_N = 8


def wide_from128(hi, lo) -> List[torch.Tensor]:
    """Sign-extend a 128-bit (hi, lo) into eight 32-bit limbs."""
    ext = torch.where(hi < 0, _MASK32, 0)
    return _split32(hi, lo) + [ext] * 4


def wide_add(a, b):
    out, carry = [], None
    for k in range(_WIDE_N):
        acc = a[k] + b[k] if carry is None else a[k] + b[k] + carry
        out.append(acc & _MASK32)
        carry = acc >> 32
    return out


def wide_neg(a):
    out, carry = [], 1
    for k in range(_WIDE_N):
        acc = (~a[k] & _MASK32) + carry
        out.append(acc & _MASK32)
        carry = acc >> 32
    return out


def wide_is_neg(a):
    return ((a[_WIDE_N - 1] >> 31) & 1) != 0


def wide_mul_pow10(a, k: int):
    """a * 10^k, wrapping at 256 bits."""
    while k > 0:
        step = min(k, _STEP_DIGITS)
        a = _mul_small(a, 10 ** step)
        k -= step
    return a


def wide_div_pow10_half_up(a, k: int):
    """a / 10^k rounded HALF_UP on the magnitude (Spark's rescale)."""
    if k <= 0:
        return a
    neg = wide_is_neg(a)
    mag = [torch.where(neg, m, v) for m, v in zip(wide_neg(a), a)]
    mag = _div_pow10_limbs(mag, k - 1)
    mag, last = _divmod_small(mag, 10)
    one = [(last >= 5).to(torch.int64)] + \
        [torch.zeros_like(mag[0])] * (_WIDE_N - 1)
    mag = wide_add(mag, one)
    return [torch.where(neg, n, m) for n, m in zip(wide_neg(mag), mag)]


def wide_to128(a):
    """Narrow to 128 bits: (hi, lo, fits), fits False on rows whose value
    needs more than a signed 128-bit integer."""
    hi, lo = _join32(a[0], a[1], a[2], a[3])
    ext = torch.where(hi < 0, _MASK32, 0)
    fits = (a[4] == ext) & (a[5] == ext) & (a[6] == ext) & (a[7] == ext)
    return hi, lo, fits


def wide_cmp(a, b):
    """(lt, eq) of signed 256-bit operands."""
    diff = wide_add(a, wide_neg(b))
    eq = a[0] == b[0]
    for k in range(1, _WIDE_N):
        eq = eq & (a[k] == b[k])
    return wide_is_neg(diff), eq


# ---------------------------------------------------------------------------
# carry-free sums
# ---------------------------------------------------------------------------

def sum_chunks(hi, lo) -> List[torch.Tensor]:
    """128-bit -> four int64 chunks: bits 0:32, 32:64, 64:96 (unsigned)
    and 96:128 (signed), whose sums by group recombine to the total."""
    return [lo & _MASK32, (lo >> 32) & _MASK32, hi & _MASK32, hi >> 32]


def sum_recombine(sums: List[torch.Tensor]):
    """Inverse of sum_chunks after summation: s0 + (s1 << 32) +
    (s2 << 64) + (s3 << 96), wrapping at 128 bits (each s fits int64)."""
    s0, s1, s2, s3 = sums
    hi, lo = s0 >> 63, s0
    # s1 << 32 spans bits 32..95; the arithmetic shift sign-extends it
    hi, lo = add128(hi, lo, s1 >> 32, s1 << 32)
    return hi + s2 + (s3 << 32), lo
