"""Spark-exact Murmur3 hashing for the int and long families, doubles and
strings (`spark_rapids_tpu/expr/hashing.py`).

Spark's murmur3_x86_32 is uint32 arithmetic with wraparound. torch's
uint32 lacks most operations, so every value here is an int32 holding the
same 32 bits: multiplication and addition wrap identically, and a logical
right shift is an arithmetic shift followed by a mask (torch `>>` on int32
keeps the sign), the same translation `ops/pallas_probe.py` of the JAX
package uses. This is also the plain version that the hand-written CUDA
kernel in ops/pallas_probe.py is held against, bit for bit.

BYTE, SHORT, INT, DATE and BOOLEAN hash as an int; LONG, TIMESTAMP and
a decimal of up to 18 digits (its unscaled value) as a long. A double
hashes as the long of its IEEE bits (Java doubleToLongBits: -0.0 as 0.0,
every NaN as the canonical NaN), a float as the int of its bits
(floatToIntBits, the same two rules). A string hashes its bytes as Spark's
variant does: whole little-endian 4-byte words, then each byte of the
tail as its own sign-extended block, then the length.
"""

from __future__ import annotations

import torch

from .. import types as T
from .base import Vec, require_flat_strings

__all__ = ["hash_vec", "hash_vecs", "hash_int", "hash_long", "hash_double",
           "hash_float", "hash_string", "INT_FAMILY", "LONG_FAMILY"]

INT_FAMILY = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
              T.DateType)
# a decimal of <= 18 digits hashes its int64 unscaled value; a wider one
# is refused (hash_vec)
LONG_FAMILY = (T.LongType, T.TimestampType, T.DecimalType)


def _i32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


_C1 = _i32(0xcc9e2d51)
_C2 = _i32(0x1b873593)
_M5 = _i32(0xe6546b64)
_F1 = _i32(0x85ebca6b)
_F2 = _i32(0xc2b2ae35)


def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x >> r) & ((1 << (32 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _srl(x, 32 - r)


def _mix_k1(k1):
    return _rotl(k1 * _C1, 15) * _C2


def _mix_h1(h1, k1):
    return _rotl(h1 ^ k1, 13) * 5 + _M5


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ _srl(h1, 16)
    h1 = h1 * _F1
    h1 = h1 ^ _srl(h1, 13)
    h1 = h1 * _F2
    return h1 ^ _srl(h1, 16)


def hash_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of one 4-byte block per row (int32 v, int32 running seed)."""
    return _fmix(_mix_h1(seed, _mix_k1(v)), 4)


def hash_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of one int64 per row as two 4-byte blocks, low word first."""
    low = (v & 0xFFFFFFFF).to(torch.int32)
    high = (v >> 32).to(torch.int32)
    return _fmix(_mix_h1(_mix_h1(seed, _mix_k1(low)), _mix_k1(high)), 8)


_CANONICAL_NAN = 0x7FF8000000000000


def hash_double(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of one float64 per row, through its doubleToLongBits."""
    v = torch.where(v == 0.0, torch.zeros_like(v), v)  # -0.0 -> 0.0
    bits = torch.where(torch.isnan(v), _CANONICAL_NAN, v.view(torch.int64))
    return hash_long(bits, seed)


_CANONICAL_FLOAT_NAN = 0x7FC00000


def hash_float(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of one float32 per row, through its floatToIntBits."""
    v = torch.where(v == 0.0, torch.zeros_like(v), v)  # -0.0 -> 0.0
    bits = torch.where(torch.isnan(v), _CANONICAL_FLOAT_NAN,
                       v.view(torch.int32))
    return hash_int(bits, seed)


def hash_string(chars: torch.Tensor, lengths: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of one zero-tailed uint8[n, w] row per string (w a multiple
    of 4), Spark's tail variant."""
    w = chars.shape[1]
    lens = lengths.to(torch.int32)
    aligned = lens - lens % 4
    words = chars.contiguous().view(torch.int32)  # little-endian words
    h1 = seed
    for i in range(w // 4):
        h1 = torch.where(4 * i + 4 <= aligned,
                         _mix_h1(h1, _mix_k1(words[:, i])), h1)
    # the tail: at most 3 bytes, each a sign-extended int block
    for t in range(3):
        pos = aligned + t
        byte = chars.gather(1, pos.clamp(max=w - 1).to(torch.int64)[:, None])
        block = byte[:, 0].view(torch.int8).to(torch.int32)
        h1 = torch.where(pos < lens, _mix_h1(h1, _mix_k1(block)), h1)
    return _fmix(h1, lens)


def hash_vec(v: Vec, seed: torch.Tensor) -> torch.Tensor:
    """Hash one column into the int32 running hash; null rows pass the seed
    through (Spark)."""
    if v.data.dim() == 2 and not v.is_string:
        # the JAX murmur3 stops at 18 digits; the planner refuses 128-bit
        # join and partition keys before any row gets here
        raise NotImplementedError(
            f"murmur3 over {v.dtype.simple_string()} (a 128-bit decimal) is "
            "not supported by spark_rapids_tpu_torch")
    if isinstance(v.dtype, INT_FAMILY):
        h = hash_int(v.data.to(torch.int32), seed)
    elif isinstance(v.dtype, LONG_FAMILY):
        h = hash_long(v.data.to(torch.int64), seed)
    elif isinstance(v.dtype, T.DoubleType):
        h = hash_double(v.data, seed)
    elif isinstance(v.dtype, T.FloatType):
        h = hash_float(v.data, seed)
    elif isinstance(v.dtype, T.StringType):
        require_flat_strings(v, "murmur3")
        h = hash_string(v.data, v.lengths, seed)
    else:
        raise NotImplementedError(
            f"murmur3 over {v.dtype.simple_string()} is not supported by "
            "spark_rapids_tpu_torch yet (int and long families, float, "
            "double and string)")
    return torch.where(v.validity, h, seed)


def hash_vecs(vecs, seed: int = 42) -> torch.Tensor:
    """Row hash across columns: int32 result (Spark Murmur3Hash)."""
    n = vecs[0].validity.shape[0]
    h = torch.full((n,), seed, dtype=torch.int32,
                   device=vecs[0].validity.device)
    for v in vecs:
        h = hash_vec(v, h)
    return h
