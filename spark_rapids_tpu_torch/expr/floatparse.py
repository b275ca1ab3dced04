"""Bit-exact decimal -> float64 composition for the string cast
(`spark_rapids_tpu/expr/floatparse.py`; reference `GpuCast.scala`
castStringToFloat).

The parse loop (cast.py `_parse_float`) accumulates the mantissa as a
128-bit integer M (up to 38 significant digits exact, a sticky bit for any
dropped nonzero tail) and a decimal exponent E. `compose_float64` rounds
M x 10^E to the nearest float64 with integer arithmetic only, as the JAX
module does:

  * 10^E is a TRUNCATED 192-bit normalized significand P with binary
    exponent B (10^E = P x 2^(B-191), 2^191 <= P < 2^192) for E in
    [POW10_MIN_E, POW10_MAX_E], plus a sticky bit for the truncation;
    the table is built once on the host and copied to each device once;
  * M is normalized to [2^127, 2^128) and the 320-bit product M x P is
    exact, so the only error is the power's truncation (< 2^-191
    relative) and the >38-digit mantissa sticky (< 2^-126);
  * the top bits round with guard and sticky; a subnormal keeps fewer
    bits (integer shifts: no flush-to-zero applies); overflow is +/-inf;
    the bits assemble with the carry-into-exponent trick and one
    `Tensor.view(torch.float64)`.

Every limb stays int64, as in expr/decimal128.py: the (hi, lo) halves of
M are the two 64-bit words' bit patterns, M x P is computed from M's four
32-bit limbs times P's twelve 16-bit limbs (each partial product below
2^48, each column sum below 2^51), and the rounding reads a 62-bit window
of the product, so no multiply leaves 63 bits and no shift reaches 64.

Exactness: correctly rounded for every input not within 2^-125 relative
of a rounding boundary, and for the exact ties between two doubles written
with a fraction (E from -41 to -1, such as "9007199254740993.0" or
"4503599627370496.5"), which round half even; the JAX module rounds those
down, since its power of ten is truncated (ROADMAP.md Queue C). Left as in
the JAX module: exact ties with more than 38 significant digits, or with
E below -41, round as the truncated product says.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["compose_float64", "mul10_add", "POW10_MIN_E", "POW10_MAX_E"]

# M carries up to 38 digits, so the smallest e10 that can still reach the
# subnormal range is ~-(324+38); everything below composes to zero
POW10_MIN_E = -365
POW10_MAX_E = 310

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF
_P_LIMBS = 12  # 16-bit limbs of the 192-bit power
# a decimal M x 10^E with -E at most this that is not a halfway point lies
# more than 2^-191 (relative) from every one: |M 2^j - h 10^-E| >= 1
_TIE_MAX_NEG_E = 41
_R_LIMBS = 20  # 16-bit limbs of the 320-bit product

_HOST_TABLE = None
_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]] = {}


def _build_table():
    """Python ints, JAX `_build_table`: per e10, the 192-bit significand
    as 16-bit limbs (least significant first), B and the sticky bit."""
    limbs, bexp, sticky = [], [], []
    for e in range(POW10_MIN_E, POW10_MAX_E + 1):
        if e >= 0:
            v = 10 ** e
            bl = v.bit_length()
            if bl <= 192:
                p, st = v << (192 - bl), False
            else:
                p = v >> (bl - 192)
                st = (v & ((1 << (bl - 192)) - 1)) != 0
            be = bl - 1
        else:
            den = 10 ** (-e)
            bl = den.bit_length()
            num = 1 << (191 + bl)
            p, st = num // den, (num % den) != 0
            be = -bl
        assert (1 << 191) <= p < (1 << 192), e
        limbs.append([(p >> (16 * i)) & _M16 for i in range(_P_LIMBS)])
        bexp.append(be)
        sticky.append(st)
    return limbs, bexp, sticky


def _table(device: torch.device):
    """(limbs int64[n, 12], B int64[n], sticky bool[n]) on `device`."""
    global _HOST_TABLE
    t = _TABLES.get(device)
    if t is None:
        if _HOST_TABLE is None:
            limbs, bexp, sticky = _build_table()
            _HOST_TABLE = (torch.tensor(limbs, dtype=torch.int64),
                           torch.tensor(bexp, dtype=torch.int64),
                           torch.tensor(sticky, dtype=torch.bool))
        t = _TABLES[device] = tuple(a.to(device) for a in _HOST_TABLE)
    return t


def _limbs32(hi: torch.Tensor, lo: torch.Tensor):
    """(hi, lo) 64-bit patterns -> four 32-bit limbs, least first."""
    return [lo & _M32, (lo >> 32) & _M32, hi & _M32, (hi >> 32) & _M32]


def _join32(limbs):
    l0, l1, l2, l3 = limbs
    return l2 | (l3 << 32), l0 | (l1 << 32)


def mul10_add(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor):
    """(hi, lo) * 10 + d in 128 bits (d: int64 digit), wrapping."""
    out, carry = [], d
    for limb in _limbs32(hi, lo):
        acc = limb * 10 + carry
        out.append(acc & _M32)
        carry = acc >> 32
    return _join32(out)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of x in [0, 2^32) as a 32-bit value (0 -> 32)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = (x >> s) != 0
        n = torch.where(big, n, n + s)
        x = torch.where(big, x >> s, x)
    return torch.where(x == 0, n + 1, n)


def _clz128(limbs) -> torch.Tensor:
    """Leading zeros of the 128-bit value (0 -> 128)."""
    n = torch.full_like(limbs[0], 128)
    seen = torch.zeros_like(limbs[0], dtype=torch.bool)
    for i in (3, 2, 1, 0):
        here = ~seen & (limbs[i] != 0)
        n = torch.where(here, 32 * (3 - i) + _clz32(limbs[i]), n)
        seen = seen | here
    return n


def _shl128(limbs, k: torch.Tensor):
    """Four 32-bit limbs << k (0 <= k < 128), each limb kept to 32 bits:
    a gather by whole limbs, then a bit shift under 32."""
    zero = torch.zeros_like(limbs[0])
    padded = torch.stack([zero] * 4 + list(limbs), dim=1)
    q, b = k // 32, k % 32
    out = []
    for i in range(4):
        cur = torch.gather(padded, 1, (4 + i - q)[:, None])[:, 0]
        prev = torch.gather(padded, 1, (3 + i - q)[:, None])[:, 0]
        # prev >> 32 is 0 for b == 0: limbs are below 2^32
        out.append(((cur << b) | (prev >> (32 - b))) & _M32)
    return out


def compose_float64(mhi: torch.Tensor, mlo: torch.Tensor,
                    sticky_digits: torch.Tensor, e10: torch.Tensor,
                    neg: torch.Tensor) -> torch.Tensor:
    """Round M x 10^E to float64 (see the module docstring). mhi/mlo: the
    int64 bit patterns of M's high and low 64 bits; sticky_digits: bool,
    nonzero digits were dropped past 38; e10: the decimal exponent; neg:
    bool sign. M == 0 composes a signed zero; the caller layers NaN, the
    infinities and validity."""
    dev = mlo.device
    e10 = e10.to(torch.int64)
    m = _limbs32(mhi, mlo)
    zero = (mhi == 0) & (mlo == 0)
    under = e10 < POW10_MIN_E
    over = e10 > POW10_MAX_E
    idx = torch.clamp(e10 - POW10_MIN_E, 0, POW10_MAX_E - POW10_MIN_E)
    p_tab, b_tab, st_tab = _table(dev)
    p = p_tab[idx]                       # [n, 12] 16-bit limbs of P
    pb = b_tab[idx]
    psticky = st_tab[idx]

    # normalize M to [2^127, 2^128)
    lz = torch.where(zero, 0, _clz128(m))
    a = _shl128(m, lz)

    # exact 128 x 192 product in 16-bit columns: M's 32-bit limb i sits at
    # column 2i, P's 16-bit limb j at column j
    cols = [torch.zeros_like(mlo) for _ in range(_R_LIMBS)]
    for i in range(4):
        for j in range(_P_LIMBS):
            cols[2 * i + j] = cols[2 * i + j] + a[i] * p[:, j]
    carry = torch.zeros_like(mlo)
    for k in range(_R_LIMBS):
        v = cols[k] + carry
        cols[k] = v & _M16
        carry = v >> 16

    # R in [2^318, 2^320): s = 1 when bit 319 is clear; t = 319 - s is
    # the top bit. T = R >> (t - 61) holds R's top 62 bits.
    s = 1 - (cols[19] >> 15)
    t_lo = (cols[16] >> (2 - s)) + (cols[17] << (14 + s)) + \
        (cols[18] << (30 + s)) + (cols[19] << (46 + s))
    below = cols[16] & torch.where(s == 1, 1, 3)  # R's bits under T
    for k in range(16):
        below = below | cols[k]
    sticky_low = (below != 0) | psticky | sticky_digits

    # binary exponent: value = 1.xxx x 2^e2
    e2 = 128 + pb - lz - s
    biased = e2 + 1023
    # subnormal: k more bits dropped (0 for a normal number)
    k = torch.clamp(1 - biased, 0, 120)
    fits_m = 9 + k <= 61
    mant = torch.where(fits_m, t_lo >> torch.clamp(9 + k, max=61), 0)
    g = torch.clamp(8 + k, max=61)
    fits_g = 8 + k <= 61
    guard = torch.where(fits_g, (t_lo >> g) & 1, 0)
    low_bits = torch.where(
        fits_g, t_lo & (torch.bitwise_left_shift(torch.ones_like(g), g) - 1),
        t_lo)
    sticky = sticky_low | (low_bits != 0)
    # an exact tie through a truncated power: P is 10^E rounded down, so R
    # is M x 10^E less under 2^128. With guard 0 and every bit from 2^128
    # up to it set, the exact value is at or past the halfway point; for
    # 1 <= -E <= 41 and no dropped digit, a decimal that is not a tie
    # lies further than 2^128 from it, so it is the tie: half even. (The
    # JAX module rounds such ties down.)
    ones = ((cols[16] & torch.where(s == 1, 1, 3))
            == torch.where(s == 1, 1, 3)) & \
        ((t_lo & ((1 << 8) - 1)) == (1 << 8) - 1)
    for k_ in range(8, 16):
        ones = ones & (cols[k_] == _M16)
    tie = ones & (guard == 0) & (e10 < 0) & (e10 >= -_TIE_MAX_NEG_E) & \
        ~sticky_digits & (k == 0)
    mant = mant + (guard & (sticky.to(torch.int64) | (mant & 1))) + \
        (tie.to(torch.int64) & mant & 1)

    # normal numbers carry the implicit leading 1 in mant (53 bits); a
    # rounding carry to 2^53 lands in the exponent field by itself, and a
    # subnormal mant (< 2^52) adds onto exponent field 0 the same way
    biased_c = torch.clamp(biased, 0, 2047)
    adj = torch.where(biased > 0, mant - (1 << 52), mant)
    bits = (biased_c << 52) + adj
    inf_bits = 0x7FF0000000000000
    bits = torch.where((biased >= 2047) | (bits >= inf_bits), inf_bits, bits)
    bits = torch.where(zero | under, 0, bits)
    bits = torch.where(over & ~zero, inf_bits, bits)
    bits = torch.where(neg, bits | -(1 << 63), bits)
    return bits.view(torch.float64)
