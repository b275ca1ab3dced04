"""More string functions over the flat byte-matrix layout
(`spark_rapids_tpu/expr/strings_more.py`; reference `stringFunctions.scala`
GpuOverlay, GpuLevenshtein, GpuSoundex, GpuFormatNumber, GpuConv,
Empty2Null).

Levenshtein runs the DP row by row with the prefix-min linearization of
the JAX module: for each byte i of the left string, e[j] = min(prev[j] + 1,
prev[j-1] + cost) and dp[j] = j + cummin(e[j] - j), one `torch.cummin`
(JAX `lax.associative_scan(minimum)`) a row.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..columnar.padding import width_bucket
from .base import EvalContext, Expression, Literal, Vec, and_validity, \
    pad_width
from .strings import _cols

__all__ = ["Overlay", "Levenshtein", "SoundEx", "FormatNumber",
           "Empty2Null", "Conv"]


class Overlay(Expression):
    """overlay(input, replace, pos[, len]): `replace` spliced into `input`
    at 1-based pos, consuming len bytes of input (default the length of
    replace). Byte positions, as in the JAX module."""

    def __init__(self, child, replace, pos, length=None):
        kids = [child, replace, pos] + ([length] if length is not None
                                        else [])
        super().__init__(kids)

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, s: Vec, r: Vec, pos: Vec,
                 *rest: Vec) -> Vec:
        n, w_in = s.data.shape
        w_rep = r.data.shape[1]
        ow = width_bucket(w_in + w_rep)
        dev = s.data.device
        sl = s.lengths.to(torch.int64)
        rl = r.lengths.to(torch.int64)
        p0 = torch.minimum(torch.clamp(pos.data.to(torch.int64) - 1, min=0),
                           sl)
        consumed = rest[0].data.to(torch.int64) if rest else rl
        consumed = torch.minimum(torch.clamp(consumed, min=0), sl - p0)
        tail_start = p0 + consumed
        out_len = p0 + rl + (sl - tail_start)
        j = _cols(ow, dev).to(torch.int64)
        in_head = j < p0[:, None]
        in_rep = ~in_head & (j < (p0 + rl)[:, None])
        pad_s = pad_width(s.data, ow)
        pad_r = pad_width(r.data, ow)
        rep = torch.gather(pad_r, 1, torch.clamp(j - p0[:, None], 0, ow - 1))
        tail = torch.gather(pad_s, 1, torch.clamp(
            j - (p0 + rl)[:, None] + tail_start[:, None], 0, ow - 1))
        data = torch.where(in_head, pad_s, torch.where(in_rep, rep, tail))
        data = torch.where(j < out_len[:, None], data, 0)
        valid = s.validity & r.validity & pos.validity
        if rest:
            valid = valid & rest[0].validity
        return Vec(T.STRING, data, valid,
                   torch.clamp(out_len, 0, ow).to(torch.int32))


class Levenshtein(Expression):
    """levenshtein(a, b): the byte-level edit distance."""

    def __init__(self, left, right):
        super().__init__([left, right])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, a: Vec, b: Vec) -> Vec:
        n, wa = a.data.shape
        wb = b.data.shape[1]
        dev = a.data.device
        la = a.lengths.to(torch.int64)
        lb = b.lengths.to(torch.int64)
        jj = torch.arange(wb + 1, dtype=torch.int64, device=dev)[None, :]
        # dp over the b-prefix length j; past lb pinned high, so the
        # gather at j = lb never reads them
        dp = torch.where(jj <= lb[:, None], jj, 1 << 20).expand(n, wb + 1)
        live_b = jj[:, 1:] <= lb[:, None]
        for i in range(wa):
            cost = torch.where(live_b & (a.data[:, i:i + 1] == b.data), 0, 1)
            e = torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + cost)
            em = torch.cat([dp[:, :1] + 1, e], dim=1) - jj
            new_dp = torch.cummin(em, dim=1).values + jj
            # a row whose string ended keeps its dp
            dp = torch.where((i < la)[:, None], new_dp, dp)
        out = torch.gather(dp, 1, lb[:, None])[:, 0]
        return Vec(T.INT, out.to(torch.int32),
                   and_validity(a.validity, b.validity))


def _lut(pairs, dtype=torch.uint8) -> torch.Tensor:
    t = torch.zeros(256, dtype=dtype)
    for chars, v in pairs:
        for ch in chars:
            t[ord(ch)] = v
            t[ord(ch.lower())] = v
    return t


class SoundEx(Expression):
    """soundex(str): the classic 4-character code (a letter and three
    digits); a string whose first byte is not a letter comes back as it
    is (Spark)."""

    _CODE = _lut((("BFPV", 1), ("CGJKQSXZ", 2), ("DT", 3), ("L", 4),
                  ("MN", 5), ("R", 6)))
    _HW = _lut((("HW", True),), torch.bool)
    _ALPHA = _lut((("ABCDEFGHIJKLMNOPQRSTUVWXYZ", True),), torch.bool)

    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, s: Vec) -> Vec:
        n, w = s.data.shape
        dev = s.data.device
        idx = s.data.to(torch.int64)
        live = _cols(w, dev) < s.lengths[:, None]
        code = self._CODE.to(dev)[idx]
        is_hw = self._HW.to(dev)[idx]
        alpha = self._ALPHA.to(dev)[idx] & live
        digits = []
        prev = code[:, 0]
        for i in range(1, w):
            c = code[:, i]
            ok = alpha[:, i] & (c > 0) & (c != prev)
            digits.append(torch.where(ok, c, 0))
            # the code carries through H and W, resets on a vowel
            prev = torch.where(is_hw[:, i] | ~alpha[:, i], prev, c)
        packed = torch.zeros((n, 3), dtype=torch.uint8, device=dev)
        if digits:
            dmat = torch.stack(digits, dim=1)
            order = torch.argsort((dmat == 0).to(torch.uint8), dim=1,
                                  stable=True)
            got = torch.gather(dmat, 1, order[:, :3])
            packed[:, :got.shape[1]] = got
        first = s.data[:, 0]
        upper_first = torch.where((first >= 97) & (first <= 122),
                                  first - 32, first)
        out = torch.cat([upper_first[:, None], packed + ord("0")], dim=1)
        ow = width_bucket(max(4, w))
        out = pad_width(out, ow)
        starts_alpha = alpha[:, 0]
        data = torch.where(starts_alpha[:, None], out, pad_width(s.data, ow))
        lens = torch.where(starts_alpha, 4, s.lengths).to(torch.int32)
        return Vec(T.STRING, data, s.validity, lens)


class Empty2Null(Expression):
    """empty2null(str): '' -> NULL (file writers' partition values)."""

    def __init__(self, child):
        super().__init__([child])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, s: Vec) -> Vec:
        return Vec(T.STRING, s.data, s.validity & (s.lengths > 0), s.lengths)


def _digit_matrix(v: torch.Tensor, base: int, k: int) -> torch.Tensor:
    """int64[n, k]: the k lowest base-`base` digits of v, most significant
    first (floor division, as numpy's)."""
    digs, rem = [], v
    for _ in range(k):
        digs.append(torch.remainder(rem, base))
        rem = torch.div(rem, base, rounding_mode="floor")
    return torch.stack(digs[::-1], dim=1)


def _leading_zeros(dmat: torch.Tensor, k: int) -> torch.Tensor:
    nz = dmat > 0
    return torch.where(nz.any(dim=1), nz.to(torch.uint8).argmax(dim=1),
                       k - 1)


class FormatNumber(Expression):
    """format_number(x, d literal): d decimals, HALF_UP on |x| as
    floor(|x| 10^d + 0.5) in doubles, thousands separators; NaN, the
    infinities and |x| >= 10^18 are null (as in the JAX module)."""

    MAX_DIGITS = 19

    def __init__(self, child, decimals):
        super().__init__([child, decimals])
        if not isinstance(decimals, Literal) or decimals.value is None:
            raise ValueError("format_number requires a literal decimal "
                             "count (static output width on both engines)")
        self.d = decimals.value

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, v: Vec, _d: Vec) -> Vec:
        d = max(int(self.d or 0), 0)
        k = self.MAX_DIGITS
        dev = v.data.device
        x = v.data.to(torch.float64)
        neg = x < 0
        ax = x.abs()
        bad = torch.isnan(x) | torch.isinf(x) | (ax >= 10.0 ** (k - 1))
        p = 10.0 ** d
        scaled = torch.floor(torch.where(bad, 0.0, ax) * p + 0.5)
        int_part = torch.floor(scaled / p).to(torch.int64)
        frac_part = (scaled - int_part.to(torch.float64) * p) \
            .to(torch.int64)
        dmat = _digit_matrix(int_part, 10, k)
        ndig = torch.clamp(k - _leading_zeros(dmat, k), min=1)
        # [sign][integer digits with a comma every 3][.][d digits]
        int_w = ndig + torch.clamp(torch.div(ndig - 1, 3,
                                             rounding_mode="floor"), min=0)
        ineg = neg.to(torch.int64)
        total = ineg + int_w + ((1 + d) if d else 0)
        ow = width_bucket(1 + k + (k + 2) // 3 - 1 + 1 + d)
        j = _cols(ow, dev).to(torch.int64)
        start = ineg[:, None]
        kk = j - start
        in_int = (kk >= 0) & (kk < int_w[:, None])
        # within the integer zone from the right: r = int_w - 1 - kk;
        # a comma at r % 4 == 3
        r = int_w[:, None] - 1 - kk
        is_comma = in_int & (torch.remainder(r, 4) == 3)
        digit_ord = torch.where(is_comma, 0,
                                r - torch.div(r, 4, rounding_mode="floor"))
        src = torch.clamp(k - 1 - digit_ord, 0, k - 1)
        ch = torch.where(is_comma, ord(","), torch.gather(dmat, 1, src)
                         + ord("0"))
        data = torch.where(in_int, ch, 0)
        data = torch.where(neg[:, None] & (j == 0), ord("-"), data)
        if d:
            fmat = _digit_matrix(frac_part, 10, d)
            dot = start + int_w[:, None]
            fsrc = torch.clamp(j - dot - 1, 0, d - 1)
            data = torch.where(j == dot, ord("."), data)
            data = torch.where((j > dot) & (j <= dot + d),
                               torch.gather(fmat, 1, fsrc) + ord("0"), data)
        data = torch.where(j < total[:, None], data, 0).to(torch.uint8)
        return Vec(T.STRING, data, v.validity & ~bad, total.to(torch.int32))


def _pow_table(base: int, k: int) -> list:
    """base^0 .. base^(k-1) wrapped to int64, as numpy's int64 power."""
    out = []
    for e in range(k):
        v = base ** e % (1 << 64)
        out.append(v - (1 << 64) if v >= 1 << 63 else v)
    return out


class Conv(Expression):
    """conv(num_str, from_base, to_base), literal bases in 2..36: the
    leading digits valid in from_base (none is null), formatted in to_base
    with upper-case digits. Values past 2^63 wrap, as in the JAX module."""

    def __init__(self, child, from_base, to_base):
        super().__init__([child, from_base, to_base])
        fb = from_base.value if isinstance(from_base, Literal) else None
        tb = to_base.value if isinstance(to_base, Literal) else None
        if fb is None or tb is None or not (2 <= fb <= 36 and 2 <= tb <= 36):
            raise ValueError("conv requires literal bases in 2..36")
        self.fb = fb
        self.tb = tb

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, s: Vec, _f: Vec, _t: Vec) -> Vec:
        fb, tb = int(self.fb), int(self.tb)
        n, w = s.data.shape
        dev = s.data.device
        lut = torch.full((256,), 255, dtype=torch.int64)
        for i in range(10):
            lut[ord("0") + i] = i
        for i in range(26):
            lut[ord("A") + i] = 10 + i
            lut[ord("a") + i] = 10 + i
        dv = lut.to(dev)[s.data.to(torch.int64)]
        live = _cols(w, dev) < s.lengths[:, None]
        ok_digit = (dv < fb) & live
        # Spark stops at the first invalid digit
        bad_seen = torch.cumsum(~ok_digit & live, dim=1) > 0
        use = ok_digit & ~bad_seen
        n_used = use.sum(dim=1)
        power = n_used[:, None] - torch.cumsum(use, dim=1)
        pows = torch.tensor(_pow_table(fb, 64), dtype=torch.int64,
                            device=dev)
        wgt = torch.where(use, pows[torch.clamp(power, 0, 63)], 0)
        val = (torch.where(use, dv, 0) * wgt).sum(dim=1)
        k = 64  # base 2 of a 64-bit value
        dmat = _digit_matrix(val, tb, k)
        nd = torch.clamp(k - _leading_zeros(dmat, k), min=1)
        ow = width_bucket(k)
        j = _cols(ow, dev).to(torch.int64)
        src = torch.clamp(k - nd[:, None] + j, 0, k - 1)
        digit = torch.gather(dmat, 1, src)
        ch = torch.where(digit < 10, digit + ord("0"),
                         digit - 10 + ord("A"))
        data = torch.where(j < nd[:, None], ch, 0).to(torch.uint8)
        return Vec(T.STRING, data, s.validity & (n_used > 0),
                   nd.to(torch.int32))
