"""Decimal arithmetic helpers (`spark_rapids_tpu/expr/decimal128.py`, the
part that 64-bit decimals need).

A decimal of precision <= 18 is its int64 unscaled value. Adding,
subtracting and comparing two of them at a common scale can need more than
64 bits: decimal(18,0) rescaled to scale 18 has 36 digits. So those paths
run in 128-bit two's complement held as two int64 limbs, hi (signed, bits
64..127) and lo (the bit pattern of bits 0..63), as in the JAX package.
Every limb stays int64: torch's uint64 has few kernels, on CUDA fewest. An
unsigned compare flips the sign bit of both sides first, and carries come
from such compares. The multiply by a power of ten splits a value into
four 32-bit limbs, each held in an int64, so every partial product and
carry fits.

The 128-bit limb column layout (precision > 18) and the 256-bit `wide_*`
chain are not ported: no case within 18 digits needs them.
"""

from __future__ import annotations

import decimal as _decimal
from typing import Tuple

import torch

from .. import types as T

__all__ = ["adjust_precision_scale", "add_result_type", "widen_operand",
           "rescale_up", "add128", "neg128", "lt128", "eq128", "in_bounds",
           "ult", "unscaled_int", "literal_type"]

_MASK32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
# exact context for the host-side Decimal -> unscaled int conversion
_EXACT_CTX = _decimal.Context(prec=80)


def unscaled_int(d: _decimal.Decimal, scale: int) -> int:
    """Decimal value -> exact unscaled int at `scale`."""
    return int(_EXACT_CTX.scaleb(d, scale))


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
    """A 64-bit decimal's int64 values -> (hi, lo), sign-extended."""
    lo = data.to(torch.int64)
    return lo >> 63, lo


def add128(ahi, alo, bhi, blo):
    """(ahi, alo) + (bhi, blo), wrapping at 128 bits."""
    lo = alo + blo
    carry = ult(lo, alo).to(torch.int64)
    return ahi + bhi + carry, lo


def neg128(hi, lo):
    nlo = ~lo + 1
    carry = (nlo == 0).to(torch.int64)
    return ~hi + carry, nlo


def lt128(ahi, alo, bhi, blo):
    """Signed (ahi, alo) < (bhi, blo)."""
    return (ahi < bhi) | ((ahi == bhi) & ult(alo, blo))


def eq128(ahi, alo, bhi, blo):
    return (ahi == bhi) & (alo == blo)


def _mul_small(hi, lo, m: int):
    """(hi, lo) * m for 0 < m < 2^31, wrapping at 128 bits: four 32-bit
    limbs, least significant first, each product and carry below 2^63."""
    limbs = (lo & _MASK32, (lo >> 32) & _MASK32, hi & _MASK32,
             (hi >> 32) & _MASK32)
    out, carry = [], None
    for limb in limbs:
        acc = limb * m if carry is None else limb * m + carry
        out.append(acc & _MASK32)
        carry = acc >> 32
    return out[2] | (out[3] << 32), out[0] | (out[1] << 32)


def rescale_up(hi, lo, k: int):
    """Multiply by 10^k (k >= 0), wrapping at 128 bits. The callers keep
    precision + k <= 38, so no value wraps."""
    while k > 0:
        step = min(k, 9)
        hi, lo = _mul_small(hi, lo, 10 ** step)
        k -= step
    return hi, lo


def in_bounds(hi, lo, precision: int) -> torch.Tensor:
    """|value| <= 10^precision - 1 (Spark's overflow check)."""
    bound = 10 ** precision - 1
    bhi = torch.full_like(hi, bound >> 64)
    blo = torch.full_like(lo, (bound & ((1 << 64) - 1)) - (
        1 << 64 if bound & (1 << 63) else 0))
    neg = hi < 0
    nhi, nlo = neg128(hi, lo)
    mhi, mlo = torch.where(neg, nhi, hi), torch.where(neg, nlo, lo)
    # -2^127 is its own negation: its magnitude stays negative
    return ~(lt128(bhi, blo, mhi, mlo) | (mhi < 0))
