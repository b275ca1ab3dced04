"""String expressions over the flat byte-matrix layout
(`spark_rapids_tpu/expr/strings.py`; reference `stringFunctions.scala`
GpuLength, GpuUpper/GpuLower, GpuSubstring, GpuConcat,
GpuStartsWith/GpuEndsWith/GpuContains, GpuStringTrim*).

Every operation is a rank-2 torch op over `uint8[n, w]` and int32
lengths:

  * character (code point) positions come from the UTF-8 continuation-byte
    mask ((b & 0xC0) != 0x80), so Length and Substring count characters
    over all of UTF-8, with Spark's 1-based positions and negative `pos`
    counted from the end (`substring('Spark SQL', -10, 5)` is 'Spar');
  * a per-row variable slice (substring, trim, concat) is a gather along
    the byte axis with a computed index matrix;
  * Upper and Lower map ASCII only; the planner marks them incompat.

A long-string input never reaches a kernel here: `Expression.eval` sends
it to the host first (expr/base.py `require_flat_strings`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import types as T
from ..columnar.padding import width_bucket
from .base import EvalContext, Expression, Literal, Vec, and_validity, \
    pad_common_width, pad_width

__all__ = ["Length", "Upper", "Lower", "Substring", "Concat", "StartsWith",
           "EndsWith", "Contains", "StringTrim", "StringTrimLeft",
           "StringTrimRight"]


def _is_char_start(chars: torch.Tensor) -> torch.Tensor:
    return (chars & 0xC0) != 0x80


def _cols(w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int32, device=device)[None, :]


def _pos_mask(chars: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """bool[n, w]: the byte lies within the row's length."""
    return _cols(chars.shape[1], chars.device) < lengths[:, None]


def _shift_rows(chars: torch.Tensor, start: torch.Tensor, out_len, ow: int
                ) -> torch.Tensor:
    """uint8[n, ow]: row i's bytes from `start[i]`, zero from `out_len[i]`
    on (the take_along_axis of the JAX kernels)."""
    w = chars.shape[1]
    j = _cols(ow, chars.device)
    idx = torch.clamp(start[:, None].to(torch.int64) + j, max=w - 1)
    data = torch.gather(chars.expand(start.shape[0], -1), 1, idx)
    return torch.where(j < out_len[:, None], data, 0).to(torch.uint8)


def decode_rows(v: Vec) -> List[Optional[str]]:
    """Host: the byte matrix as Python strings (None for a null)."""
    chars = v.data.cpu().numpy()
    lens = v.lengths.cpu().numpy()
    valid = v.validity.cpu().numpy()
    return [bytes(chars[i, :lens[i]]).decode("utf-8", "replace")
            if valid[i] else None for i in range(len(valid))]


def strings_to_vec(rows: List[Optional[str]], validity: torch.Tensor
                   ) -> Vec:
    """Python strings -> a flat string value on validity's device."""
    enc = [r.encode("utf-8") if r is not None else b"" for r in rows]
    w = width_bucket(max((len(b) for b in enc), default=1) or 1)
    data = np.zeros((len(enc), w), np.uint8)
    lens = np.zeros(len(enc), np.int32)
    for i, b in enumerate(enc):
        data[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    dev = validity.device
    return Vec(T.STRING, torch.from_numpy(data).to(dev), validity,
               torch.from_numpy(lens).to(dev))


class StringUnary(Expression):
    def __init__(self, child):
        super().__init__([child])


class Length(StringUnary):
    """Character (code point) count."""

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        starts = _is_char_start(c.data) & _pos_mask(c.data, c.lengths)
        return Vec(T.INT, starts.sum(dim=1, dtype=torch.int32), c.validity)


class _AsciiCase(StringUnary):
    """ASCII letters in [lo, hi] flip their case bit (0x20)."""
    lo, hi = 0, 0

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        conv = (c.data >= self.lo) & (c.data <= self.hi)
        return Vec(T.STRING, torch.where(conv, c.data ^ 0x20, c.data),
                   c.validity, c.lengths)


class Upper(_AsciiCase):
    lo, hi = ord("a"), ord("z")


class Lower(_AsciiCase):
    lo, hi = ord("A"), ord("Z")


def _int_literal(e: Expression) -> Optional[int]:
    if isinstance(e, Literal) and isinstance(e.value, int) and \
            not isinstance(e.value, bool):
        return e.value
    return None


class Substring(Expression):
    """substring(str, pos, len): 1-based, in characters; a negative pos
    counts from the end (Spark)."""

    def __init__(self, child, pos: Expression, length: Expression):
        pos = self._wrap(pos)
        length = self._wrap(length)
        super().__init__([child, pos, length])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec, pos_v: Vec, len_v: Vec
                 ) -> Vec:
        return substring(c, pos_v, len_v, _int_literal(self.children[2]))


def substring(c: Vec, pos_v: Vec, len_v: Vec, lit_len: Optional[int]
              ) -> Vec:
    """Substring's kernel (Left and Right call it too); `lit_len`, a
    literal length, bounds the output width."""
    chars, lengths = c.data, c.lengths
    w = chars.shape[1]
    in_row = _pos_mask(chars, lengths)
    starts = _is_char_start(chars) & in_row
    nchars = starts.sum(dim=1, dtype=torch.int32)
    # char index of each byte (0-based)
    char_id = torch.cumsum(starts, dim=1, dtype=torch.int32) - 1
    pos = pos_v.data.to(torch.int32)
    slen = torch.clamp(len_v.data.to(torch.int32), min=0)
    # end = start + len before start is clamped: a window that begins
    # before the string is shortened, not shifted
    raw_start = torch.where(pos > 0, pos - 1,
                            torch.where(pos < 0, nchars + pos, 0))
    end_char = torch.minimum(torch.clamp(raw_start + slen, min=0), nchars)
    start_char = torch.minimum(torch.clamp(raw_start, min=0), nchars)

    def byte_offset(k):
        # bytes of the row before its character k
        return (in_row & (char_id < k[:, None])).sum(dim=1,
                                                     dtype=torch.int32)

    b0 = byte_offset(start_char)
    out_len = torch.clamp(byte_offset(end_char) - b0, min=0)
    # a literal length bounds the output: at most 4 bytes a character
    ow = w if lit_len is None else \
        min(w, width_bucket(max(4 * max(lit_len, 0), 1)))
    validity = and_validity(c.validity, pos_v.validity, len_v.validity)
    return Vec(T.STRING, _shift_rows(chars, b0, out_len, ow), validity,
               out_len)


class Concat(Expression):
    """concat(s1, s2, ...): null if any input is null."""

    def __init__(self, *children):
        super().__init__([self._wrap(c) for c in children])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, *vecs: Vec) -> Vec:
        out = vecs[0]
        n = out.validity.shape[0]
        for v in vecs[1:]:
            w1, w2 = out.data.shape[1], v.data.shape[1]
            w = width_bucket(w1 + w2)
            both = pad_width(torch.cat([out.data.expand(n, -1),
                                        v.data.expand(n, -1)], dim=1), w)
            j = _cols(w, both.device)
            l1 = out.lengths[:, None]
            idx = torch.where(j < l1, torch.clamp(j, max=w1 - 1),
                              torch.clamp(w1 + (j - l1), max=w1 + w2 - 1))
            data = torch.gather(both, 1, idx.to(torch.int64))
            new_len = out.lengths + v.lengths
            data = torch.where(j < new_len[:, None], data, 0) \
                .to(torch.uint8)
            out = Vec(T.STRING, data, out.validity & v.validity, new_len)
        return out


def _pattern_bytes(e: Expression) -> Optional[bytes]:
    if isinstance(e, Literal) and isinstance(e.value, str):
        return e.value.encode("utf-8")
    return None


class _PatternPredicate(Expression):
    """A binary string predicate; the right side is usually a literal,
    whose bytes the kernel reads from the plan, and may be a column."""

    def __init__(self, left, right):
        super().__init__([left, self._wrap(right)])

    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, s: Vec, p: Vec) -> Vec:
        pat = _pattern_bytes(self.children[1])
        ok = self._match_literal(s, pat) if pat is not None else \
            self._match_column(s, p)
        return Vec(T.BOOLEAN, ok, and_validity(s.validity, p.validity))

    @staticmethod
    def _window_equals(s: Vec, at: torch.Tensor, pat: bytes
                       ) -> torch.Tensor:
        """bool[n]: the pattern's bytes sit at byte `at` of each row."""
        w = s.data.shape[1]
        ok = torch.ones_like(s.lengths, dtype=torch.bool)
        for t, b in enumerate(pat):
            col = torch.clamp(at + t, 0, w - 1).to(torch.int64)
            ok = ok & (torch.gather(s.data, 1, col[:, None])[:, 0] == b)
        return ok & (s.lengths >= len(pat))


class StartsWith(_PatternPredicate):
    def _match_literal(self, s: Vec, pat: bytes) -> torch.Tensor:
        return self._window_equals(s, torch.zeros_like(s.lengths), pat)

    def _match_column(self, s: Vec, p: Vec) -> torch.Tensor:
        ds, dp = pad_common_width(s, p)
        in_p = _cols(ds.shape[1], ds.device) < p.lengths[:, None]
        return (~in_p | (ds == dp)).all(dim=1) & (s.lengths >= p.lengths)


class EndsWith(_PatternPredicate):
    def _match_literal(self, s: Vec, pat: bytes) -> torch.Tensor:
        return self._window_equals(s, s.lengths - len(pat), pat)

    def _match_column(self, s: Vec, p: Vec) -> torch.Tensor:
        ds, dp = pad_common_width(s, p)
        w = ds.shape[1]
        j = _cols(w, ds.device)
        idx = torch.clamp(j + (s.lengths - p.lengths)[:, None], 0, w - 1)
        tail = torch.gather(ds, 1, idx.to(torch.int64))
        in_p = j < p.lengths[:, None]
        return (~in_p | (tail == dp.expand_as(tail))).all(dim=1) & \
            (s.lengths >= p.lengths)


class Contains(_PatternPredicate):
    def _match_literal(self, s: Vec, pat: bytes) -> torch.Tensor:
        """One shifted compare per pattern byte over every start."""
        n, w = s.data.shape
        m = len(pat)
        if m == 0:
            return torch.ones(n, dtype=torch.bool, device=s.data.device)
        if m > w:
            return torch.zeros(n, dtype=torch.bool, device=s.data.device)
        span = w - m + 1
        hit = s.data[:, :span] == pat[0]
        for t in range(1, m):
            hit = hit & (s.data[:, t:t + span] == pat[t])
        fits = _cols(span, s.data.device) + m <= s.lengths[:, None]
        return (hit & fits).any(dim=1)

    def _match_column(self, s: Vec, p: Vec) -> torch.Tensor:
        """Every shift of the string against the pattern's own width."""
        n, ws = s.data.shape
        wp = p.data.shape[1]
        ds = pad_width(s.data, ws + wp)
        in_p = _cols(wp, ds.device) < p.lengths[:, None]
        ok = torch.zeros(n, dtype=torch.bool, device=ds.device)
        for k in range(ws):
            m = (~in_p | (ds[:, k:k + wp] == p.data)).all(dim=1)
            ok = ok | (m & (p.lengths + k <= s.lengths))
        # an empty pattern is contained in every string, even an empty one
        return ok | (p.lengths == 0)


class _Trim(StringUnary):
    trim_left = True
    trim_right = True

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        chars, lengths = c.data, c.lengths
        w = chars.shape[1]
        in_row = _pos_mask(chars, lengths)
        nonspace = in_row & (chars != 0x20)
        any_ns = nonspace.any(dim=1)
        first_ns = nonspace.to(torch.uint8).argmax(dim=1).to(torch.int32)
        last_ns = (w - 1 - nonspace.flip(1).to(torch.uint8).argmax(dim=1)) \
            .to(torch.int32)
        zero = torch.zeros_like(lengths)
        start = torch.where(any_ns, first_ns, zero) if self.trim_left \
            else zero
        end = torch.where(any_ns, last_ns + 1 if self.trim_right
                          else lengths, zero)
        out_len = torch.clamp(end - start, min=0)
        return Vec(T.STRING, _shift_rows(chars, start, out_len, w),
                   c.validity, out_len)


class StringTrim(_Trim):
    pass


class StringTrimLeft(_Trim):
    trim_right = False


class StringTrimRight(_Trim):
    trim_left = False
