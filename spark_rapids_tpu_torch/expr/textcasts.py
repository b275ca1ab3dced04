"""The four casts between STRING and DECIMAL/TIMESTAMP, by Spark's rule,
on the host engine (`expr/cast.py` sends them here; the JAX device rule
refuses them, and its CPU engine computes another value or fails).
Vectorised over the byte matrix in torch:

  * STRING -> DECIMAL(p, s): `Decimal.fromString`, Java `BigDecimal`'s
    grammar after String.trim (bytes <= 0x20): a sign, digits with at
    most one point and at least one digit, then an optional e/E, sign and
    digits (the exponent an int). Java's BigDecimal takes any Unicode
    decimal digit of the Basic Multilingual Plane; those rows are mapped
    to ASCII digits first. The value is cut to the scale HALF_UP; past
    the precision it is null. Python's own forms (NaN, Infinity, 1_000,
    spaces inside) are null. Under ANSI malformed text raises
    `[CAST_INVALID_INPUT]` and a value past the precision
    `[NUMERIC_VALUE_OUT_OF_RANGE]`.
  * DECIMAL -> STRING: `BigDecimal.toPlainString`, which keeps the scale
    (12.30 stays "12.30").
  * TIMESTAMP -> STRING: `yyyy-MM-dd HH:mm:ss`, then a point and the
    microseconds with their trailing zeros dropped when they are not 0.
    A year outside 1..9999 raises: Java's padding and era rules there
    are not reproduced.
  * STRING -> TIMESTAMP: `DateTimeUtils.stringToTimestamp` under the UTC
    session: [+-]yyyy[yy][-[m]m[-[d]d]], then ' ' or 'T' and
    [h]h[:[m]m[:[s]s[.f...]]] (a fraction past 6 digits truncated), then a
    zone (Z, an offset, UTC/GMT/UT with or without an offset, one of
    Java's SHORT_IDS, or a region id through `zoneinfo`); a string with a
    time alone, or that does not parse, is null. A region id that
    `zoneinfo` does not hold on this machine raises, as does a region's
    date outside Python's years 1..9999: the port does not guess. Under
    ANSI a string that gives null raises `[CAST_INVALID_INPUT]`.
"""

from __future__ import annotations

import re
import unicodedata

import torch

from .. import types as T
from .base import EvalContext, Vec, ansi_raise
from .cast import _byte_at, _cols, _trimmed
from .datetime_ import (civil_from_days, compile_dt_pattern,
                        days_from_civil, format_micros)

__all__ = ["string_to_decimal", "decimal_to_string", "timestamp_to_string",
           "string_to_timestamp"]

_US_PER_DAY = 86_400_000_000
_INT32_MAX = 2 ** 31 - 1


def _digit_run(chars: torch.Tensor, mask: torch.Tensor, cap: int):
    """The value of the digits under `mask`, read left to right, clamped
    at `cap` (a run past it is out of every range that reads it)."""
    acc = torch.zeros(chars.shape[0], dtype=torch.int64, device=chars.device)
    d = chars.to(torch.int64) - ord("0")
    for k in range(chars.shape[1]):
        acc = torch.where(mask[:, k], torch.clamp(acc * 10 + d[:, k],
                                                  max=cap), acc)
    return acc


# ---------------------------------------------------------------------------
# STRING -> DECIMAL
# ---------------------------------------------------------------------------

def _ascii_digits(c: Vec):
    """(chars, lengths) with each BMP Unicode decimal digit of a row that
    holds a byte past 0x7F written as its ASCII digit (Java's
    Character.isDigit reads those); the other rows as they are."""
    chars, lengths = c.data, c.lengths
    j = _cols(chars.shape[1], chars.device)
    wide = ((chars >= 0x80) & (j < lengths[:, None].to(torch.int64))) \
        .any(dim=1) & c.validity
    rows = torch.nonzero(wide).flatten().tolist()
    if not rows:
        return chars, lengths
    chars, lengths = chars.clone(), lengths.clone()
    for r in rows:
        text = bytes(chars[r, :int(lengths[r])].tolist()).decode(
            "utf-8", "replace")
        text = "".join(str(unicodedata.decimal(ch))
                       if ord(ch) >= 0x80 and ord(ch) < 0x10000
                       and ch.isdecimal() else ch for ch in text)
        b = text.encode("utf-8")
        chars[r] = 0
        chars[r, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
        lengths[r] = len(b)
    return chars, lengths


def string_to_decimal(ctx: EvalContext, c: Vec, dst: T.DecimalType) -> Vec:
    from . import decimal128 as D
    from .floatparse import mul10_add
    chars, lengths = _ascii_digits(c)
    n, w = chars.shape
    dev = chars.device
    j = _cols(w, dev)
    first, last, any_c = _trimmed(chars, lengths)
    inside = (j >= first[:, None]) & (j <= last[:, None])
    d = chars.to(torch.int64) - ord("0")
    is_dig = (d >= 0) & (d <= 9)
    lead = _byte_at(chars, first)
    neg = lead == ord("-")
    mstart = first + (neg | (lead == ord("+"))).to(torch.int64)
    is_e = inside & ((chars == ord("e")) | (chars == ord("E")))
    has_e = is_e.any(dim=1)
    e_pos = torch.where(has_e, is_e.to(torch.uint8).argmax(dim=1)
                        .to(torch.int64), last + 1)
    mant = (j >= mstart[:, None]) & (j < e_pos[:, None])
    dot = mant & (chars == ord("."))
    mdig = mant & is_dig
    ok = any_c & (~mant | is_dig | dot).all(dim=1) & \
        (dot.sum(dim=1) <= 1) & mdig.any(dim=1)
    # the exponent: a sign, then one or more digits, an int
    esign = _byte_at(chars, e_pos + 1)
    eneg = esign == ord("-")
    estart = e_pos + 1 + (eneg | (esign == ord("+"))).to(torch.int64)
    edig = (j >= estart[:, None]) & (j <= last[:, None])
    ok = ok & (~has_e | ((~edig | is_dig).all(dim=1) & edig.any(dim=1)))
    eval_ = _digit_run(chars, edig & is_dig, 10 ** 11)
    ok = ok & (eval_ <= _INT32_MAX + eneg.to(torch.int64))
    exp = torch.where(eneg, -eval_, eval_)
    dot_at = torch.where(dot.any(dim=1), dot.to(torch.uint8).argmax(dim=1)
                         .to(torch.int64), e_pos)
    fdigits = (mdig & (j > dot_at[:, None])).sum(dim=1)
    # BigDecimal's scale, fraction digits less the exponent, is an int
    scale = fdigits - exp
    ok = ok & (scale >= -_INT32_MAX - 1) & (scale <= _INT32_MAX)
    # the significant digits D (from the first nonzero one): the result
    # is D's first `keep` digits, plus one if the next is 5 or more
    sig = mdig & (torch.cumsum((mdig & (d != 0)).to(torch.int64), dim=1) > 0)
    sig_ix = torch.cumsum(sig.to(torch.int64), dim=1) - 1
    n_sig = sig.sum(dim=1)
    keep = n_sig + dst.scale - scale
    big = (n_sig > 0) & (keep > dst.precision)
    keep = torch.clamp(keep, -1, dst.precision + 1)
    take = sig & (sig_ix < keep[:, None])
    round_up = (sig & (sig_ix == keep[:, None]) & (d >= 5)).any(dim=1)
    # digits kept beyond D's own are zeros: multiply by 10^(keep - n_sig)
    zeros = torch.clamp(keep - n_sig, 0, dst.precision)
    if dst.precision <= 18:
        acc = torch.zeros(n, dtype=torch.int64, device=dev)
        for k in range(w):
            acc = torch.where(take[:, k], acc * 10 + d[:, k], acc)
        pow10 = torch.tensor([10 ** e for e in range(19)], dtype=torch.int64,
                             device=dev)
        acc = acc * pow10[zeros] + round_up.to(torch.int64)
        fits = ~big & (acc < 10 ** dst.precision)
        data = torch.where(neg, -acc, acc)
    else:
        hi = torch.zeros(n, dtype=torch.int64, device=dev)
        lo = torch.zeros_like(hi)
        for k in range(w):
            nhi, nlo = mul10_add(hi, lo, torch.where(take[:, k], d[:, k], 0))
            hi = torch.where(take[:, k], nhi, hi)
            lo = torch.where(take[:, k], nlo, lo)
        for e in range(dst.precision):
            more = zeros > e
            nhi, nlo = mul10_add(hi, lo, torch.zeros_like(lo))
            hi, lo = torch.where(more, nhi, hi), torch.where(more, nlo, lo)
        hi, lo = D.add128(hi, lo, torch.zeros_like(hi),
                          round_up.to(torch.int64))
        fits = ~big & D.in_bounds(hi, lo, dst.precision)
        nhi, nlo = D.neg128(hi, lo)
        data = D.pack_limbs(torch.where(neg, nhi, hi),
                            torch.where(neg, nlo, lo))
    parsed = c.validity & ok
    if ctx.ansi:
        ansi_raise(ctx, c.validity & ~ok,
                   "[CAST_INVALID_INPUT] value cannot be cast to "
                   f"{dst.simple_string()}")
        ansi_raise(ctx, parsed & ~fits,
                   "[NUMERIC_VALUE_OUT_OF_RANGE] value out of range for "
                   f"{dst.simple_string()}")
    valid = parsed & fits
    zero = torch.zeros_like(data)
    mask = valid if data.dim() == 1 else valid[:, None]
    return Vec(dst, torch.where(mask, data, zero), valid)


# ---------------------------------------------------------------------------
# DECIMAL -> STRING
# ---------------------------------------------------------------------------

def _magnitude_digits(data: torch.Tensor):
    """A decimal's unscaled values -> (digits int64[n, W], units first;
    the count of digits, at least 1; negative)."""
    from . import decimal128 as D
    if data.dim() == 1:
        neg = data < 0
        # from the non-positive value, so INT64_MIN has its digits
        rem = torch.where(neg, data, -data)
        digs = []
        for _ in range(19):
            digs.append(-torch.fmod(rem, 10))
            rem = torch.div(rem, 10, rounding_mode="trunc")
    else:
        hi, lo, neg = D.abs128(data[:, 0], data[:, 1])
        limbs = D._split32(hi, lo)
        digs = []
        for _ in range(5):  # 10^45 > 2^127
            limbs, rem = D._divmod_small(limbs, 10 ** 9)
            for _ in range(9):
                digs.append(rem % 10)
                rem = torch.div(rem, 10, rounding_mode="floor")
    digs = torch.stack(digs, dim=1)
    nz = digs != 0
    place = torch.arange(digs.shape[1], device=digs.device)
    count = torch.where(nz, place + 1, 0).amax(dim=1)
    return digs, torch.clamp(count, min=1), neg


def decimal_to_string(c: Vec) -> Vec:
    """toPlainString: [-]int.frac, the integer part at least "0", exactly
    `scale` fraction digits."""
    from ..columnar.padding import width_bucket
    s = c.dtype.scale
    digs, count, neg = _magnitude_digits(c.data)
    ndig = torch.clamp(count, min=s + 1)
    ineg = neg.to(torch.int64)
    total = ineg + ndig + (1 if s > 0 else 0)
    width = width_bucket(digs.shape[1] + s + 2)
    j = _cols(width, digs.device)
    pos = j - ineg[:, None]                   # the place in the number
    int_len = (ndig - s)[:, None]
    q = torch.where(pos < int_len, pos, pos - (1 if s > 0 else 0))
    place = torch.clamp(ndig[:, None] - 1 - q, 0, digs.shape[1] - 1)
    out = torch.gather(digs, 1, place) + ord("0")
    if s > 0:
        out = torch.where(pos == int_len, ord("."), out)
    out = torch.where((j == 0) & neg[:, None], ord("-"), out)
    out = torch.where(j < total[:, None], out, 0)
    return Vec(T.STRING, out.to(torch.uint8), c.validity,
               total.to(torch.int32))


# ---------------------------------------------------------------------------
# TIMESTAMP -> STRING
# ---------------------------------------------------------------------------

_TS_TEXT = compile_dt_pattern("yyyy-MM-dd HH:mm:ss")


def timestamp_to_string(c: Vec) -> Vec:
    """date_format's yyyy-MM-dd HH:mm:ss, then '.' and the microseconds up
    to their last nonzero digit, if any."""
    us = c.data
    year = civil_from_days(torch.div(us, _US_PER_DAY,
                                     rounding_mode="floor"))[0]
    if bool((c.validity & ((year < 1) | (year > 9999))).any()):
        raise NotImplementedError(
            "cast timestamp -> string of a year outside 1..9999 is not "
            "supported by spark_rapids_tpu_torch yet")
    head = format_micros(us, c.validity, *_TS_TEXT).data[:, :19]
    frac = us % 1_000_000
    digits = torch.stack([torch.div(frac, 10 ** p, rounding_mode="floor")
                          % 10 for p in range(5, -1, -1)], dim=1)
    place = torch.arange(1, 7, device=us.device)
    nfrac = torch.where(digits != 0, place, 0).amax(dim=1)
    out = torch.cat([head.to(torch.int64), torch.full_like(digits[:, :1],
                                                           ord(".")),
                     digits + ord("0")], dim=1)
    length = 19 + torch.where(nfrac > 0, nfrac + 1, 0)
    out = torch.nn.functional.pad(out, (0, 32 - out.shape[1]))
    out = torch.where(_cols(32, us.device) < length[:, None], out, 0)
    return Vec(T.STRING, out.to(torch.uint8), c.validity,
               length.to(torch.int32))


# ---------------------------------------------------------------------------
# STRING -> TIMESTAMP
# ---------------------------------------------------------------------------

# java.time.ZoneId.SHORT_IDS
_SHORT_IDS = {
    "ACT": "Australia/Darwin", "AET": "Australia/Sydney",
    "AGT": "America/Argentina/Buenos_Aires", "ART": "Africa/Cairo",
    "AST": "America/Anchorage", "BET": "America/Sao_Paulo",
    "BST": "Asia/Dhaka", "CAT": "Africa/Harare", "CNT": "America/St_Johns",
    "CST": "America/Chicago", "CTT": "Asia/Shanghai",
    "EAT": "Africa/Addis_Ababa", "ECT": "Europe/Paris",
    "IET": "America/Indiana/Indianapolis", "IST": "Asia/Kolkata",
    "JST": "Asia/Tokyo", "MIT": "Pacific/Apia", "NET": "Asia/Yerevan",
    "NST": "Pacific/Auckland", "PLT": "Asia/Karachi",
    "PNT": "America/Phoenix", "PRT": "America/Puerto_Rico",
    "PST": "America/Los_Angeles", "SST": "Pacific/Guadalcanal",
    "VST": "Asia/Ho_Chi_Minh", "EST": "-05:00", "MST": "-07:00",
    "HST": "-10:00"}
_REGION = re.compile(r"[A-Za-z][A-Za-z0-9~/._+-]+")
_TRIM = "".join(map(chr, range(0x21)))
# ZoneOffset.of's forms by length: (position, preceded by a colon) of
# each two-digit field
_OFFSET_FIELDS = {3: ((1, False),), 5: ((1, False), (3, False)),
                  6: ((1, False), (4, True)),
                  7: ((1, False), (3, False), (5, False)),
                  9: ((1, False), (4, True), (7, True))}


def _offset_seconds(text: str):
    """java.time.ZoneOffset.of: Z, +h, +hh, +hhmm, +hh:mm, +hhmmss,
    +hh:mm:ss (either sign), at most 18:00; None where Java throws."""
    if text == "Z":
        return 0
    if len(text) == 2:
        text = text[0] + "0" + text[1]
    fields = _OFFSET_FIELDS.get(len(text))
    if fields is None or text[0] not in "+-":
        return None
    vals = []
    for pos, colon in fields:
        pair = text[pos:pos + 2]
        if (colon and text[pos - 1] != ":") or not (
                pair.isascii() and pair.isdigit()):
            return None
        vals.append(int(pair))
    h, m, s = vals + [0] * (3 - len(vals))
    total = h * 3600 + m * 60 + s
    if m > 59 or s > 59 or total > 18 * 3600:
        return None
    return -total if text[0] == "-" else total


def _zone(text: str):
    """Spark's `getZoneId` (after String.trim), then Java's
    ZoneId.of(id, SHORT_IDS): an offset in seconds, a zoneinfo.ZoneInfo,
    or None where Java throws (the cast is null). Raises where Java would
    look up a region that zoneinfo does not hold."""
    text = text.strip(_TRIM)
    if text == "":
        return 0
    # the (+|-)h: and (+|-)hh:m forms Spark accepted before 3.0
    text = re.sub(r"([+-])([0-9]):", r"\g<1>0\g<2>:", text, count=1)
    text = re.sub(r"([+-])([0-9][0-9]):([0-9])$", r"\g<1>\g<2>:0\g<3>",
                  text, count=1)
    text = _SHORT_IDS.get(text, text)
    if len(text) <= 1 or text[0] in "+-":
        return _offset_seconds(text)
    for prefix in ("UTC", "GMT", "UT"):
        if text.startswith(prefix):
            rest = text[len(prefix):]
            if rest == "":
                return 0
            if rest[0] in "+-":
                return _offset_seconds(rest)
            break
    if _REGION.fullmatch(text) is None:
        return None
    import zoneinfo
    try:
        return zoneinfo.ZoneInfo(text)
    except (zoneinfo.ZoneInfoNotFoundError, ValueError, OSError):
        raise NotImplementedError(
            f"cast string -> timestamp with the zone {text!r}: this "
            "machine's zoneinfo does not hold it") from None


def _valid_digits(seg: torch.Tensor, ndig: torch.Tensor) -> torch.Tensor:
    """Spark's isValidDigits(segment, digits)."""
    return torch.where(
        seg == 0, (ndig >= 4) & (ndig <= 6),
        torch.where(seg == 6, torch.ones_like(ndig, dtype=torch.bool),
                    torch.where(seg == 7, ndig <= 2,
                                (ndig > 0) & (ndig <= 2))))


def string_to_timestamp(ctx: EvalContext, c: Vec) -> Vec:
    chars = c.data
    n, w = chars.shape
    dev = chars.device
    first, last, any_c = _trimmed(chars, c.lengths)
    lead = _byte_at(chars, first)
    ysign = (lead == ord("-")) | (lead == ord("+"))
    start = first + ysign.to(torch.int64)
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    seg = [zi + 1, zi + 1, zi + 1, zi, zi, zi, zi]
    i, cur, ndig, milli = zi.clone(), zi.clone(), zi.clone(), zi.clone()
    fail = ~any_c
    tz_at = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for k in range(w):
        act = (k >= start) & (k <= last) & ~fail & (tz_at < 0)
        b = chars[:, k].to(torch.int64)
        dval = b - ord("0")
        dig = act & (dval >= 0) & (dval <= 9)
        milli = milli + (dig & (i == 6)).to(torch.int64)
        grow = dig & ((i != 6) | (ndig < 6))
        cur = torch.where(grow, torch.clamp(cur * 10 + dval, max=10 ** 12),
                          cur)
        ndig = ndig + dig.to(torch.int64)
        other = act & ~dig
        # the separator each segment takes; at the seconds or fraction any
        # other byte opens the zone
        sep = torch.where(i < 2, b == ord("-"), torch.where(
            i == 2, (b == ord(" ")) | (b == ord("T")), torch.where(
                i < 5, b == ord(":"), (i == 5) & (b == ord(".")))))
        zone = other & ~sep & ((i == 5) | (i == 6))
        step = other & (sep | zone)
        # a time alone ('T' first, or ':' after the first digits) is null
        fail = fail | (other & ~step) | \
            (step & ~_valid_digits(i, ndig))
        for s_ix in range(7):
            seg[s_ix] = torch.where(step & (i == s_ix), cur, seg[s_ix])
        tz_at = torch.where(zone, k, tz_at)
        i = torch.where(zone, 7, torch.where(step, i + 1, i))
        cur = torch.where(step, 0, cur)
        ndig = torch.where(step, 0, ndig)
    fail = fail | ((tz_at < 0) & ~_valid_digits(i, ndig))
    for s_ix in range(7):
        seg[s_ix] = torch.where((tz_at < 0) & (i == s_ix), cur, seg[s_ix])
    scale = torch.tensor([10 ** e for e in range(7)], dtype=torch.int64,
                         device=dev)
    frac = seg[6] * scale[torch.clamp(6 - milli, 0, 6)]
    year = torch.where(lead == ord("-"), -seg[0], seg[0])
    mo, d, hh, mi, ss = seg[1:6]
    ok = ~fail & (mo >= 1) & (mo <= 12) & (d >= 1) & (hh <= 23) & \
        (mi <= 59) & (ss <= 59)
    ym = torch.where(ok, mo, 1)
    one = torch.ones_like(ym)
    nxt = days_from_civil(torch.where(ym == 12, year + 1, year),
                          torch.where(ym == 12, one, ym + 1), one)
    days = days_from_civil(year, ym, one)
    ok = ok & (d <= nxt - days)
    days = days + d - 1
    local = days * 86400 + hh * 3600 + mi * 60 + ss
    offset = _zone_offsets(chars, c.lengths, tz_at, last, ok & c.validity,
                           year, mo, d, hh, mi, ss)
    ok = ok & (offset.abs() <= 18 * 3600)  # an invalid zone is 10^9
    secs = local - torch.where(ok, offset, 0)
    # Spark's instantToMicros: multiplyExact/addExact, else null
    fits = ((secs > -9223372036855) & (secs < 9223372036854)) | \
        ((secs == 9223372036854) & (frac <= 775807)) | \
        ((secs == -9223372036855) & (frac >= 224192))
    ok = ok & fits
    us = torch.where(ok, secs, 0) * 1_000_000 + torch.where(ok, frac, 0)
    valid = c.validity & ok
    if ctx.ansi:
        ansi_raise(ctx, c.validity & ~ok,
                   "[CAST_INVALID_INPUT] value cannot be cast to timestamp")
    return Vec(T.TIMESTAMP, us, valid)


_BAD_ZONE = 10 ** 9


def _zone_offsets(chars, lengths, tz_at, last, live, year, mo, d, hh, mi,
                  ss) -> torch.Tensor:
    """Seconds east of UTC a row: 0 without a zone, _BAD_ZONE where the
    zone is invalid. The distinct zone texts are read once each; a region
    zone's offset is looked up a row at a time."""
    n = chars.shape[0]
    out = torch.zeros(n, dtype=torch.int64, device=chars.device)
    rows = torch.nonzero(live & (tz_at >= 0)).flatten()
    if rows.numel() == 0:
        return out
    width = int((last[rows] - tz_at[rows]).max()) + 1
    j = torch.arange(width, dtype=torch.int64, device=chars.device)[None, :]
    pos = tz_at[rows][:, None] + j
    text = torch.where(pos <= last[rows][:, None],
                       torch.gather(chars[rows], 1,
                                    torch.clamp(pos, max=chars.shape[1] - 1)
                                    .to(torch.int64)), 0)
    uniq, inverse = torch.unique(text, dim=0, return_inverse=True)
    zones = [_zone(bytes(u.tolist()).rstrip(b"\x00").decode("utf-8",
                                                            "replace"))
             for u in uniq]
    fixed = torch.tensor([z if isinstance(z, int) else
                          (_BAD_ZONE if z is None else 0) for z in zones],
                         dtype=torch.int64, device=chars.device)
    got = fixed[inverse]
    regions = [k for k, z in enumerate(zones)
               if not isinstance(z, int) and z is not None]
    if regions:
        import datetime
        for k, (z, row) in enumerate(zip(inverse.tolist(), rows.tolist())):
            if z not in regions:
                continue
            y = int(year[row])
            if not 1 <= y <= 9999:
                raise NotImplementedError(
                    "cast string -> timestamp in a region zone for the "
                    f"year {y} is not supported by spark_rapids_tpu_torch "
                    "yet")
            local = datetime.datetime(y, int(mo[row]), int(d[row]),
                                      int(hh[row]), int(mi[row]),
                                      int(ss[row]), tzinfo=zones[z])
            got[k] = int(local.utcoffset().total_seconds())
    out[rows] = got
    return out
