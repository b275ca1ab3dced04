"""More string functions over the flat byte-matrix layout
(`spark_rapids_tpu/expr/strings_ext.py`; reference `stringFunctions.scala`
GpuStringRepeat, GpuStringLPad/RPad, GpuStringLocate, GpuStringReplace,
GpuStringTranslate, GpuStringReverse, GpuConcatWs, GpuSubstringIndex,
GpuInitCap, GpuAscii, GpuChr, GpuLeft/Right, BitLength, OctetLength,
GpuFindInSet).

Output widths are static from the literals, as in the JAX package: repeat,
lpad/rpad, space and replace take their sizes from literal arguments, and
translate and lpad/rpad's pad are ASCII there (a byte is a character).
Where an argument is not such a literal the planner tags the node to the
host engine (`device_reason`, the JAX tag's wording), and there the
function computes Spark's rule a row at a time on Python strings
(`_host_rows`); a CUDA tensor never reaches that path. The JAX CPU engine
computes another value in those forms, or fails (ROADMAP.md Queue C).

Each function reads its string inputs through `Expression.eval`, which
sends a long-string value to the host first (expr/base.py
`require_flat_strings`): BitLength and OctetLength too, as in JAX.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .. import types as T
from ..columnar.padding import width_bucket
from .base import EvalContext, Expression, Literal, Vec, and_validity, \
    pad_common_width, pad_width
from .strings import _cols, _int_literal, _is_char_start, _pos_mask, \
    decode_rows, strings_to_vec, substring

__all__ = ["StringRepeat", "StringLPad", "StringRPad", "StringLocate",
           "StringInstr", "StringReplace", "StringTranslate",
           "StringReverse", "ConcatWs", "SubstringIndex", "InitCap",
           "Ascii", "Chr", "Left", "Right", "StringSpace", "BitLength",
           "OctetLength", "FindInSet"]


def _lit_int(e: Expression):
    return e.value if isinstance(e, Literal) and e.value is not None else None


def _lit_str(e: Expression):
    return e.value if isinstance(e, Literal) and isinstance(e.value, str) \
        else None


def _non_ascii(*texts) -> bool:
    return any(ord(ch) > 127 for t in texts for ch in t)


def _host_rows(name: str, fn: Callable, vecs: List[Vec]) -> Vec:
    """Spark's rule a row at a time on the host: fn(*row values) -> a
    string or None (null). A tagged node runs on the host engine, so a
    CUDA tensor here is a planner fault."""
    if any(v.data.device.type != "cpu" for v in vecs):
        raise RuntimeError(f"{name} with these arguments runs on the host "
                           "engine only")
    cols = [decode_rows(v) if v.is_string else
            [x if ok else None for x, ok in zip(v.data.tolist(),
                                                v.validity.tolist())]
            for v in vecs]
    out = [fn(*row) for row in zip(*cols)]
    return strings_to_vec(out, torch.tensor([o is not None for o in out],
                                            dtype=torch.bool))


def _nulls_in(fn: Callable) -> Callable:
    """fn over non-null arguments; null if any argument is null."""
    return lambda *a: None if any(x is None for x in a) else fn(*a)


def _byte_row(b: bytes, device) -> torch.Tensor:
    return torch.tensor(list(b), dtype=torch.uint8, device=device)


def _match_at(chars: torch.Tensor, lengths: torch.Tensor, pat: bytes
              ) -> torch.Tensor:
    """bool[n, w]: the pattern's bytes start at byte j of the row (matches
    may overlap)."""
    w = chars.shape[1]
    j = _cols(w, chars.device)
    m = torch.ones(chars.shape, dtype=torch.bool, device=chars.device)
    for t, b in enumerate(pat):
        idx = torch.clamp(j + t, max=w - 1).to(torch.int64)
        m = m & (torch.gather(chars, 1, idx.expand_as(chars)) == b)
    return m & ((j + len(pat)) <= lengths[:, None])


def _greedy(m: torch.Tensor, plen: int) -> torch.Tensor:
    """The non-overlapping matches of m, left to right."""
    cols, nxt = [], torch.zeros(m.shape[0], dtype=torch.int64,
                                device=m.device)
    for k in range(m.shape[1]):
        ok = m[:, k] & (k >= nxt)
        cols.append(ok)
        nxt = torch.where(ok, k + plen, nxt)
    return torch.stack(cols, dim=1)


class StringRepeat(Expression):
    """repeat(str, n); n a literal on the device (static width)."""

    def __init__(self, child: Expression, times: Expression):
        super().__init__([child, times])
        self.times = _lit_int(times)

    @property
    def data_type(self):
        return T.STRING

    def device_reason(self) -> Optional[str]:
        if self.times is None:
            return (f"{self.name} requires a literal repeat count on TPU "
                    "(static output width)")
        return None

    def _compute(self, ctx: EvalContext, c: Vec, tv: Vec) -> Vec:
        if self.device_reason() is not None:
            return _host_rows(self.name, _nulls_in(
                lambda s, k: s * max(int(k), 0)), [c, tv])
        times = max(int(self.times), 0)
        n, w = c.data.shape
        validity = and_validity(c.validity, tv.validity)
        if times == 0:
            return Vec(T.STRING, torch.zeros((n, 8), dtype=torch.uint8,
                                             device=c.data.device),
                       validity, torch.zeros_like(c.lengths))
        ow = width_bucket(w * times)
        j = _cols(ow, c.data.device)
        lens = c.lengths[:, None]
        src = torch.where(lens > 0, j % torch.clamp(lens, min=1), 0)
        out_len = c.lengths * times
        idx = torch.clamp(src, max=w - 1).to(torch.int64).expand(n, ow)
        data = torch.gather(c.data, 1, idx)
        data = torch.where(j < out_len[:, None], data, 0)
        return Vec(T.STRING, data, validity, out_len)


def _spark_pad(s: str, n, pad: str, left: bool):
    """UTF8String.lpad/rpad: the string cut to n characters, or padded to
    n by the pad cycled (nothing with an empty pad)."""
    n = int(n)
    if n <= len(s) or not pad:
        return s[:max(n, 0)]
    fill = (pad * (n // len(pad) + 1))[:n - len(s)]
    return fill + s if left else s + fill


class _Pad(Expression):
    """lpad/rpad(str, len, pad): len and pad literals and the pad ASCII on
    the device, so a pad byte is a pad character."""
    left = True

    def __init__(self, child: Expression, length: Expression,
                 pad: Expression = None):
        pad = pad if pad is not None else Literal(" ")
        super().__init__([child, length, pad])
        self.target = _lit_int(length)
        self.pad = _lit_str(pad)

    @property
    def data_type(self):
        return T.STRING

    def device_reason(self) -> Optional[str]:
        if self.target is None:
            return "lpad/rpad requires a literal length on TPU"
        if self.pad is None:
            return "lpad/rpad requires a literal pad string on TPU"
        if _non_ascii(self.pad):
            return "non-ASCII pad strings are not supported on TPU"
        return None

    def _compute(self, ctx: EvalContext, c: Vec, lv: Vec, pv: Vec) -> Vec:
        if self.device_reason() is not None:
            return _host_rows(self.name, _nulls_in(
                lambda s, k, p: _spark_pad(s, k, p, self.left)), [c, lv, pv])
        tgt = max(int(self.target), 0)
        pad = self.pad.encode("utf-8")
        n, w = c.data.shape
        dev = c.data.device
        ow = width_bucket(max(tgt * 4, w, 1))  # a character is <= 4 bytes
        in_row = _pos_mask(c.data, c.lengths)
        starts = _is_char_start(c.data) & in_row
        nchars = starts.sum(dim=1, dtype=torch.int32)
        char_id = torch.cumsum(starts, dim=1, dtype=torch.int32) - 1
        keep_bytes = (in_row & (char_id < tgt)).sum(dim=1,
                                                     dtype=torch.int32)
        str_bytes = torch.where(nchars > tgt, keep_bytes, c.lengths)
        pad_chars = torch.clamp(tgt - torch.clamp(nchars, max=tgt), min=0)
        pad_bytes = pad_chars if pad else torch.zeros_like(pad_chars)
        out_len = str_bytes + pad_bytes
        j = _cols(ow, dev)
        spad = pad_width(c.data, ow)
        if self.left:
            # the first pad_bytes slots from the cycled pad, then the string
            src = torch.clamp(j - pad_bytes[:, None], 0, ow - 1)
            data = torch.gather(spad, 1, src.to(torch.int64))
            if pad:
                fill = _byte_row(pad, dev)[(j % len(pad))[0].to(torch.int64)]
                data = torch.where(j < pad_bytes[:, None], fill[None, :],
                                   data)
        else:
            data = spad
            if pad:
                rel = torch.clamp(j - str_bytes[:, None], 0, ow - 1)
                fill = _byte_row(pad, dev)[(rel % len(pad)).to(torch.int64)]
                data = torch.where(j >= str_bytes[:, None], fill, data)
        data = torch.where(j < out_len[:, None], data, 0)
        return Vec(T.STRING, data,
                   and_validity(c.validity, lv.validity, pv.validity),
                   out_len)


class StringLPad(_Pad):
    left = True


class StringRPad(_Pad):
    left = False


def _find_first(s: Vec, p: Vec, from_byte: torch.Tensor) -> torch.Tensor:
    """Byte index of the first occurrence of p in s at or after from_byte
    per row; -1 if absent."""
    ds, dp = pad_common_width(s, p)
    n, w = ds.shape
    j = _cols(w, ds.device)
    in_p = j < p.lengths[:, None]
    best = torch.full((n,), -1, dtype=torch.int64, device=ds.device)
    for k in range(w - 1, -1, -1):
        window = pad_width(ds[:, k:], w)
        m = (~in_p | (window == dp)).all(dim=1)
        m = m & ((p.lengths + k) <= s.lengths) & (k >= from_byte)
        best = torch.where(m, k, best)
    return best


def _char_to_byte(s: Vec, char_pos: torch.Tensor) -> torch.Tensor:
    in_row = _pos_mask(s.data, s.lengths)
    char_id = torch.cumsum(_is_char_start(s.data) & in_row, dim=1) - 1
    return (in_row & (char_id < char_pos[:, None])).sum(dim=1)


def _byte_to_char(s: Vec, byte_pos: torch.Tensor) -> torch.Tensor:
    """Character index of a byte position (past the end clamps)."""
    starts = _is_char_start(s.data) & _pos_mask(s.data, s.lengths)
    j = _cols(s.data.shape[1], s.data.device)
    return (starts & (j < byte_pos[:, None])).sum(dim=1)


class StringLocate(Expression):
    """locate(substr, str[, start]): 1-based character position, 0 if
    absent or start <= 0; null if substr or str is null."""

    def __init__(self, substr: Expression, string: Expression,
                 start: Expression = None):
        super().__init__([substr, string,
                          start if start is not None else Literal(1)])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, p: Vec, s: Vec, st: Vec) -> Vec:
        start = st.data.to(torch.int64)
        from_byte = _char_to_byte(s, torch.clamp(start - 1, min=0))
        pos = _find_first(s, p, from_byte)
        char_pos = _byte_to_char(s, torch.clamp(pos, min=0)) + 1
        out = torch.where((pos >= 0) & (start > 0), char_pos, 0)
        return Vec(T.INT, out.to(torch.int32),
                   and_validity(p.validity, s.validity, st.validity))


class StringInstr(StringLocate):
    """instr(str, substr) = locate(substr, str, 1)."""

    def __init__(self, string: Expression, substr: Expression):
        super().__init__(substr, string, Literal(1))


class StringReplace(Expression):
    """replace(str, search, replace): greedy non-overlapping replacement,
    left to right; an empty search leaves the string. search and replace
    literals on the device."""

    def __init__(self, child: Expression, search: Expression,
                 replacement: Expression = None):
        replacement = replacement if replacement is not None \
            else Literal("")
        super().__init__([child, search, replacement])
        self.search = _lit_str(search)
        self.replacement = _lit_str(replacement)

    @property
    def data_type(self):
        return T.STRING

    def device_reason(self) -> Optional[str]:
        if self.search is None or self.replacement is None:
            return ("replace requires literal search/replacement strings "
                    "on TPU")
        return None

    def _compute(self, ctx: EvalContext, c: Vec, sv: Vec, rv: Vec) -> Vec:
        if self.device_reason() is not None:
            return _host_rows(self.name, _nulls_in(
                lambda s, a, b: s.replace(a, b) if a else s), [c, sv, rv])
        sb = self.search.encode("utf-8")
        rb = self.replacement.encode("utf-8")
        n, w = c.data.shape
        dev = c.data.device
        validity = and_validity(c.validity, sv.validity, rv.validity)
        if not sb:
            return Vec(T.STRING, c.data, validity, c.lengths)
        slen, rlen = len(sb), len(rb)
        grow = max(1, -(-rlen // slen))
        ow = width_bucket(min(w * grow, max(w, 8) * grow))
        j = _cols(w, dev)
        sel = _greedy(_match_at(c.data, c.lengths, sb), slen)
        seli = sel.to(torch.int64)
        csel = torch.cumsum(seli, dim=1)
        before = csel - seli  # selected matches starting before j
        consumed = torch.zeros_like(sel)
        for t in range(slen):
            idx = torch.clamp(j - t, 0, w - 1).to(torch.int64).expand(n, w)
            consumed = consumed | (torch.gather(sel, 1, idx) & (j - t >= 0))
        keep = _pos_mask(c.data, c.lengths) & ~consumed
        out_len = c.lengths + (csel[:, -1] * (rlen - slen)).to(torch.int32)
        dest = j + before * (rlen - slen)
        out = torch.zeros((n, ow), dtype=torch.int32, device=dev)
        dk = torch.clamp(torch.where(keep, dest, ow - 1), 0, ow - 1)
        out = out.scatter_reduce(1, dk, torch.where(keep, c.data, 0)
                                 .to(torch.int32), "amax")
        for t, b in enumerate(rb):
            dm = torch.clamp(torch.where(sel, dest + t, ow - 1), 0, ow - 1)
            out = out.scatter_reduce(
                1, dm, torch.where(sel, b, 0).to(torch.int32), "amax")
        jo = _cols(ow, dev)
        out = torch.where(jo < out_len[:, None], out, 0).to(torch.uint8)
        return Vec(T.STRING, out, validity, out_len)


def _spark_translate(s: str, frm: str, to: str) -> str:
    """StringTranslate.buildDict: the first mapping of a character wins,
    characters of `from` past the end of `to` are deleted."""
    table = {}
    for i, ch in enumerate(frm):
        table.setdefault(ch, to[i] if i < len(to) else "")
    return "".join(table.get(ch, ch) for ch in s)


class StringTranslate(Expression):
    """translate(str, from, to): literal ASCII from/to on the device;
    characters of `from` past the end of `to` are deleted."""

    def __init__(self, child: Expression, matching: Expression,
                 replace: Expression):
        super().__init__([child, matching, replace])
        self.matching = _lit_str(matching)
        self.replace = _lit_str(replace)

    @property
    def data_type(self):
        return T.STRING

    def device_reason(self) -> Optional[str]:
        if self.matching is None or self.replace is None:
            return "translate requires literal from/to strings on TPU"
        if _non_ascii(self.matching, self.replace):
            return "non-ASCII translate arguments are not supported on TPU"
        return None

    def _compute(self, ctx: EvalContext, c: Vec, mv: Vec, rv: Vec) -> Vec:
        validity = and_validity(c.validity, mv.validity, rv.validity)
        if self.device_reason() is not None:
            return _host_rows(self.name, _nulls_in(_spark_translate),
                              [c, mv, rv])
        frm = self.matching.encode("utf-8")
        to = self.replace.encode("utf-8")
        lut = list(range(256))  # identity; -1 deletes
        seen = set()
        for i, b in enumerate(frm):
            if b not in seen:
                seen.add(b)
                lut[b] = to[i] if i < len(to) else -1
        n, w = c.data.shape
        mapped = torch.tensor(lut, dtype=torch.int32,
                              device=c.data.device)[c.data.to(torch.int64)]
        keep = _pos_mask(c.data, c.lengths) & (mapped >= 0)
        # a stable compaction of the kept bytes, row by row
        j = _cols(w, c.data.device)
        order = torch.argsort(torch.where(keep, j, w + j), dim=1,
                              stable=True)
        data = torch.gather(torch.where(keep, mapped, 0).to(torch.uint8), 1,
                            order)
        out_len = keep.sum(dim=1, dtype=torch.int32)
        data = torch.where(j < out_len[:, None], data, 0)
        return Vec(T.STRING, data, validity, out_len)


class StringReverse(Expression):
    """reverse(str), by character (a UTF-8 sequence stays whole)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        n, w = c.data.shape
        in_row = _pos_mask(c.data, c.lengths)
        starts = _is_char_start(c.data) & in_row
        nchars = starts.sum(dim=1)
        char_id = torch.cumsum(starts, dim=1) - 1
        j = _cols(w, c.data.device)
        # a byte's offset in its character: j - the last start at or
        # before j (a running max of the start marks)
        char_start = torch.cummax(torch.where(starts, j, -1), dim=1).values
        new_char = torch.where(in_row, nchars[:, None] - 1 - char_id, w)
        key = torch.where(in_row, new_char * w + (j - char_start),
                          w * w + j)
        order = torch.argsort(key, dim=1, stable=True)
        data = torch.gather(c.data, 1, order)
        data = torch.where(j < c.lengths[:, None], data, 0)
        return Vec(T.STRING, data, c.validity, c.lengths)


def _append(out: Vec, sep_row: Optional[torch.Tensor], sep_len, v: Vec,
            v_len) -> Vec:
    """out ++ sep[:sep_len] ++ v[:v_len], row by row."""
    w1 = out.data.shape[1]
    w2 = 0 if sep_row is None else sep_row.shape[0]
    w3 = v.data.shape[1]
    ow = width_bucket(w1 + w2 + w3)
    n = out.data.shape[0]
    j = _cols(ow, out.data.device)
    l1 = out.lengths[:, None]
    l2 = sep_len[:, None]
    new_len = out.lengths + sep_len + v_len
    in1 = j < l1
    in2 = ~in1 & (j < l1 + l2)
    data = pad_width(out.data, ow)
    if sep_row is not None:
        sidx = torch.clamp(j - l1, 0, w2 - 1).to(torch.int64)
        data = torch.where(in2, sep_row[sidx], data)
    vidx = torch.clamp(j - l1 - l2, 0, ow - 1).to(torch.int64)
    vpart = torch.gather(pad_width(v.data, ow), 1, vidx.expand(n, ow))
    data = torch.where(~in1 & ~in2, vpart, data)
    data = torch.where(j < new_len[:, None], data, 0)
    return Vec(T.STRING, data, out.validity, new_len)


class ConcatWs(Expression):
    """concat_ws(sep, s1, s2, ...): null inputs are skipped; a null sep is
    null. A literal sep on the device."""

    def __init__(self, sep: Expression, *children: Expression):
        super().__init__([sep, *children])
        self.sep = _lit_str(sep)

    @property
    def data_type(self):
        return T.STRING

    @property
    def nullable(self):
        return self.children[0].nullable

    def device_reason(self) -> Optional[str]:
        if self.sep is None:
            return (f"{self.name} requires a literal separator on TPU "
                    "(static output width)")
        return None

    def _compute(self, ctx: EvalContext, sep: Vec, *vecs: Vec) -> Vec:
        if self.device_reason() is not None:
            return _host_rows(self.name, lambda s, *a: None if s is None
                              else s.join(x for x in a if x is not None),
                              [sep, *vecs])
        sb = self.sep.encode("utf-8")
        n = sep.validity.shape[0]
        dev = sep.validity.device
        out = Vec(T.STRING, torch.zeros((n, 8), dtype=torch.uint8,
                                        device=dev),
                  torch.ones(n, dtype=torch.bool, device=dev),
                  torch.zeros(n, dtype=torch.int32, device=dev))
        started = torch.zeros(n, dtype=torch.bool, device=dev)
        srow = _byte_row(sb, dev) if sb else None
        for v in vecs:
            eff = torch.where(v.validity, v.lengths, 0)
            sep_eff = torch.where(started & v.validity, len(sb), 0) \
                .to(torch.int32)
            out = _append(out, srow, sep_eff, v, eff)
            started = started | v.validity
        return Vec(T.STRING, out.data, sep.validity, out.lengths)


def _spark_substring_index(s: str, delim: str, count) -> str:
    """substring_index as the device computes it: the non-overlapping
    occurrences of delim, left to right (JAX `SubstringIndex`)."""
    count = int(count)
    if not delim or count == 0:
        return ""
    parts = s.split(delim)
    if count > 0:
        return delim.join(parts[:count])
    return delim.join(parts[count:])


class SubstringIndex(Expression):
    """substring_index(str, delim, count): literal delim and count on the
    device."""

    def __init__(self, child: Expression, delim: Expression,
                 count: Expression):
        super().__init__([child, delim, count])
        self.delim = _lit_str(delim)
        self.count = _lit_int(count)

    @property
    def data_type(self):
        return T.STRING

    def device_reason(self) -> Optional[str]:
        if self.delim is None or self.count is None:
            return ("substring_index requires literal delimiter/count on "
                    "TPU")
        return None

    def _compute(self, ctx: EvalContext, c: Vec, dv: Vec, cv: Vec) -> Vec:
        validity = and_validity(c.validity, dv.validity, cv.validity)
        if self.device_reason() is not None:
            return _host_rows(self.name, _nulls_in(_spark_substring_index),
                              [c, dv, cv])
        db = self.delim.encode("utf-8")
        cnt = int(self.count)
        n, w = c.data.shape
        dev = c.data.device
        if not db or cnt == 0:
            return Vec(T.STRING, torch.zeros((n, 8), dtype=torch.uint8,
                                             device=dev),
                       validity, torch.zeros_like(c.lengths))
        dlen = len(db)
        j = _cols(w, dev)
        sel = _greedy(_match_at(c.data, c.lengths, db), dlen)
        occ = torch.cumsum(sel, dim=1)
        total = occ[:, -1]
        if cnt > 0:
            # the bytes before the cnt-th occurrence (all with fewer)
            kth = sel & (occ == cnt)
            cut = kth.to(torch.uint8).argmax(dim=1)
            out_len = torch.where(kth.any(dim=1), cut, c.lengths) \
                .to(torch.int32)
            data = torch.where(j < out_len[:, None], c.data, 0)
            return Vec(T.STRING, data, validity, out_len)
        # cnt < 0: the bytes after occurrence (total + cnt + 1) from the
        # left, the |cnt|-th from the right
        want = total + cnt + 1
        kth = sel & (occ == torch.clamp(want, min=0)[:, None])
        start = torch.where(want >= 1, kth.to(torch.uint8).argmax(dim=1)
                            + dlen, 0)
        out_len = torch.clamp(c.lengths - start, min=0).to(torch.int32)
        idx = torch.clamp(start[:, None] + j, max=w - 1)
        data = torch.gather(c.data, 1, idx.expand(n, w))
        data = torch.where(j < out_len[:, None], data, 0)
        return Vec(T.STRING, data, validity, out_len)


class InitCap(Expression):
    """initcap: the first letter of each space-separated word upper case,
    the rest lower case (ASCII, like Upper/Lower)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        prev = torch.nn.functional.pad(c.data[:, :-1], (1, 0), value=0x20)
        word_start = prev == 0x20
        lower = (c.data >= ord("a")) & (c.data <= ord("z"))
        upper = (c.data >= ord("A")) & (c.data <= ord("Z"))
        flip = (word_start & lower) | (~word_start & upper)
        return Vec(T.STRING, torch.where(flip, c.data ^ 0x20, c.data),
                   c.validity, c.lengths)


class Ascii(Expression):
    """ascii(str): the code point of the first character (0 if empty)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        w = c.data.shape[1]
        b0 = c.data[:, 0].to(torch.int32)

        def byte(i):
            return c.data[:, min(i, w - 1)].to(torch.int32) & 0x3F

        two = ((b0 & 0x1F) << 6) | byte(1)
        three = ((b0 & 0x0F) << 12) | (byte(1) << 6) | byte(2)
        four = ((b0 & 0x07) << 18) | (byte(1) << 12) | (byte(2) << 6) | \
            byte(3)
        cp = torch.where(b0 < 0x80, b0, torch.where(
            b0 < 0xE0, two, torch.where(b0 < 0xF0, three, four)))
        return Vec(T.INT, torch.where(c.lengths > 0, cp, 0), c.validity)


class Chr(Expression):
    """chr(n): the character of code point n % 256 (empty for n < 0 and
    for code 0); 128..255 are two UTF-8 bytes, as on the JVM."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        v = c.data.to(torch.int64)
        code = torch.where(v < 0, 0, torch.remainder(v, 256))
        two = code >= 0x80
        b0 = torch.where(two, 0xC0 | (code >> 6), code)
        b1 = torch.where(two, 0x80 | (code & 0x3F), 0)
        lens = torch.where(code == 0, 0, torch.where(two, 2, 1))
        data = torch.nn.functional.pad(torch.stack([b0, b1], dim=1), (0, 6))
        data = torch.where(_cols(8, v.device) < lens[:, None], data, 0)
        return Vec(T.STRING, data.to(torch.uint8), c.validity,
                   lens.to(torch.int32))


class Left(Expression):
    """left(str, n) = substring(str, 1, n)."""

    def __init__(self, child: Expression, length: Expression):
        super().__init__([child, length])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec, lv: Vec) -> Vec:
        n = c.validity.shape[0]
        dev = c.validity.device
        ones = Vec(T.INT, torch.ones(n, dtype=torch.int32, device=dev),
                   torch.ones(n, dtype=torch.bool, device=dev))
        return substring(c, ones, lv, _int_literal(self.children[1]))


class Right(Expression):
    """right(str, n) = substring(str, -n, n); n <= 0 is empty."""

    def __init__(self, child: Expression, length: Expression):
        super().__init__([child, length])

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, c: Vec, lv: Vec) -> Vec:
        nlen = torch.clamp(lv.data.to(torch.int32), min=0)
        return substring(c, Vec(T.INT, -nlen, lv.validity),
                         Vec(T.INT, nlen, lv.validity),
                         _int_literal(self.children[1]))


class StringSpace(Expression):
    """space(n): n a literal on the device (static width)."""

    def __init__(self, child: Expression):
        super().__init__([child])
        self.count = _lit_int(child)

    @property
    def data_type(self):
        return T.STRING

    def device_reason(self) -> Optional[str]:
        if self.count is None:
            return (f"{self.name} requires a literal count on TPU "
                    "(static output width)")
        return None

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        if self.device_reason() is not None:
            return _host_rows(self.name, _nulls_in(
                lambda k: " " * max(int(k), 0)), [c])
        n = c.validity.shape[0]
        dev = c.validity.device
        cnt = max(int(self.count), 0)
        w = width_bucket(max(cnt, 1))
        lens = torch.full((n,), cnt, dtype=torch.int32, device=dev)
        data = torch.where(_cols(w, dev) < lens[:, None], 0x20, 0) \
            .to(torch.uint8)
        return Vec(T.STRING, data, c.validity, lens)


class BitLength(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        return Vec(T.INT, c.lengths * 8, c.validity)


class OctetLength(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        return Vec(T.INT, c.lengths, c.validity)


class FindInSet(Expression):
    """find_in_set(str, strlist): the 1-based index of str among the
    comma-separated items of strlist; 0 if absent or str holds a comma."""

    def __init__(self, child: Expression, str_list: Expression):
        super().__init__([child, str_list])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, s: Vec, lst: Vec) -> Vec:
        ds, dl = pad_common_width(s, lst)
        n, w = dl.shape
        dev = dl.device
        j = _cols(w, dev)
        llen = lst.lengths.to(torch.int64)
        is_comma = (dl == ord(",")) & (j < llen[:, None])
        commas = is_comma.to(torch.int64)
        elem_id = torch.cumsum(commas, dim=1) - commas
        prev_comma = torch.nn.functional.pad(is_comma[:, :-1], (1, 0),
                                             value=True)
        has_comma = ((ds == ord(",")) & (j < s.lengths[:, None])).any(dim=1)
        found = torch.zeros(n, dtype=torch.int64, device=dev)
        slen = s.lengths.to(torch.int64)
        in_s = j < slen[:, None]
        for k in range(w):
            start_here = prev_comma[:, k] & (k <= llen)
            window = pad_width(dl[:, k:], w)
            eq = (~in_s | (window == ds)).all(dim=1)
            end = k + slen
            nxt = torch.gather(dl, 1, torch.clamp(end, 0, w - 1)[:, None]
                               )[:, 0] == ord(",")
            ok = start_here & eq & ((end == llen) | (nxt & (end < llen)))
            found = torch.where(ok & (found == 0), elem_id[:, k] + 1, found)
        found = torch.where(has_comma, 0, found)
        return Vec(T.INT, found.to(torch.int32),
                   and_validity(s.validity, lst.validity))
