"""Date and time expressions (`spark_rapids_tpu/expr/datetime_.py`).

A DATE is int32 days since 1970-01-01 and a TIMESTAMP int64 microseconds
since the epoch, UTC (the session's zone, as in the JAX package). The
calendar is Howard Hinnant's proleptic-Gregorian conversion over int
tensors (`civil_from_days`/`days_from_civil`). Every division of a day
or time count is a floor division and every modulo a floor modulo (`%`
on tensors), so dates and times before 1970 land in the right day:
Hour(-1 us) is 23. Products with a day's microseconds are taken in
int64.

The classes follow the JAX rules, with Spark's results where the JAX
engine computes them: an invalid trunc unit or next_day name is a null
column, make_date out of range is null (no ANSI error, as in JAX), the
pattern expressions take fixed-width `yyyy/MM/dd/HH/mm/ss` patterns with
literals (`compile_dt_pattern`) and write or read their bytes at fixed
offsets of the byte matrix; a year outside 0..9999 formats to null.
"""

from __future__ import annotations

import torch

from .. import types as T
from ..columnar.padding import width_bucket
from .base import EvalContext, Expression, Vec, and_validity, ieee_div

__all__ = ["civil_from_days", "days_from_civil", "Year", "Month",
           "DayOfMonth", "Quarter", "DayOfWeek", "WeekDay", "DayOfYear",
           "WeekOfYear", "Hour", "Minute", "Second", "DateAdd", "DateSub",
           "DateDiff", "UnixTimestampFromTs", "LastDay", "AddMonths",
           "MonthsBetween", "TruncDate", "NextDay", "DayName", "MonthName",
           "TimestampSeconds", "TimestampMillis", "TimestampMicros",
           "DateFromUnixDate", "UnixDate", "MakeDate", "TruncTimestamp",
           "compile_dt_pattern", "DateFormat", "FromUnixTime",
           "ToUnixTimestamp", "UnixTimestamp"]

_US_PER_DAY = 86_400_000_000
_US_PER_HOUR = 3_600_000_000
_US_PER_MIN = 60_000_000
_US_PER_SEC = 1_000_000


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(z: torch.Tensor):
    """Days since 1970-01-01 -> (year, month [1-12], day [1-31]), int32."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097                                    # [0, 146096]
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))  # [0, 365]
    mp = _fdiv(5 * doy + 2, 153)                              # [0, 11]
    d = doy - _fdiv(153 * mp + 2, 5) + 1                      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)                  # [1, 12]
    year = y + (m <= 2).to(torch.int64)
    return year.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    """(year, month, day) -> days since the epoch, int64 (the inverse of
    civil_from_days)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _days_in_month(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """int64 days of month m of year y (m in 1..12)."""
    m = m.to(torch.int64)
    y = y.to(torch.int64)
    one = torch.ones_like(m)
    nxt = days_from_civil(torch.where(m == 12, y + 1, y),
                          torch.where(m == 12, one, m + 1), one)
    return nxt - days_from_civil(y, m, one)


def _days_of(v: Vec) -> torch.Tensor:
    """int64 days of a DATE or TIMESTAMP value."""
    if isinstance(v.dtype, T.DateType):
        return v.data.to(torch.int64)
    return _fdiv(v.data, _US_PER_DAY)


def _monday_dow(days: torch.Tensor) -> torch.Tensor:
    """0 = Monday .. 6 = Sunday (1970-01-01 was a Thursday)."""
    return (days + 3) % 7


def _null_like(dt: T.DataType, like: torch.Tensor) -> Vec:
    """A null column of like's shape."""
    return Vec(dt, torch.zeros_like(like),
               torch.zeros(like.shape[0], dtype=torch.bool,
                           device=like.device))


class _Unary(Expression):
    def __init__(self, child):
        super().__init__([child])


# ---------------------------------------------------------------------------
# Calendar parts
# ---------------------------------------------------------------------------

class _DatePart(_Unary):
    """An INT part of a DATE or TIMESTAMP (its UTC day)."""

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        out = self._part(_days_of(c))
        return Vec(T.INT, out.to(torch.int32), c.validity)

    def _part(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Year(_DatePart):
    def _part(self, days):
        return civil_from_days(days)[0]


class Month(_DatePart):
    def _part(self, days):
        return civil_from_days(days)[1]


class DayOfMonth(_DatePart):
    def _part(self, days):
        return civil_from_days(days)[2]


class Quarter(_DatePart):
    def _part(self, days):
        return _fdiv(civil_from_days(days)[1].to(torch.int64) - 1, 3) + 1


class DayOfWeek(_DatePart):
    """Spark dayofweek: 1 = Sunday .. 7 = Saturday."""

    def _part(self, days):
        return (days + 4) % 7 + 1


class WeekDay(_DatePart):
    """Spark weekday: 0 = Monday .. 6 = Sunday."""

    def _part(self, days):
        return _monday_dow(days)


class DayOfYear(_DatePart):
    def _part(self, days):
        y = civil_from_days(days)[0]
        one = torch.ones_like(y)
        return days - days_from_civil(y, one, one) + 1


class WeekOfYear(_DatePart):
    """ISO-8601 week number (1..53): the week's Thursday decides its
    year."""

    def _part(self, days):
        thursday = days - _monday_dow(days) + 3
        y = civil_from_days(thursday)[0]
        one = torch.ones_like(y)
        return _fdiv(thursday - days_from_civil(y, one, one), 7) + 1


class _TimePart(_Unary):
    divisor, modulus = _US_PER_HOUR, 24

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx: EvalContext, c: Vec) -> Vec:
        within_day = c.data % _US_PER_DAY
        out = _fdiv(within_day, self.divisor) % self.modulus
        return Vec(T.INT, out.to(torch.int32), c.validity)


class Hour(_TimePart):
    divisor, modulus = _US_PER_HOUR, 24


class Minute(_TimePart):
    divisor, modulus = _US_PER_MIN, 60


class Second(_TimePart):
    divisor, modulus = _US_PER_SEC, 60


# ---------------------------------------------------------------------------
# Date arithmetic
# ---------------------------------------------------------------------------

class DateAdd(Expression):
    """date_add(date, n): the day count wraps as the JAX int32 cast does."""
    sign = 1

    def __init__(self, date, delta):
        super().__init__([date, delta])

    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, d: Vec, k: Vec) -> Vec:
        out = d.data.to(torch.int64) + self.sign * k.data.to(torch.int64)
        return Vec(T.DATE, out.to(torch.int32),
                   and_validity(d.validity, k.validity))


class DateSub(DateAdd):
    sign = -1


class DateDiff(Expression):
    def __init__(self, end, start):
        super().__init__([end, start])

    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx, e: Vec, s: Vec) -> Vec:
        return Vec(T.INT, (e.data.to(torch.int64) - s.data.to(torch.int64))
                   .to(torch.int32), and_validity(e.validity, s.validity))


class UnixTimestampFromTs(_Unary):
    """unix_timestamp(timestamp): seconds, floored."""

    @property
    def data_type(self):
        return T.LONG

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(T.LONG, _fdiv(c.data, _US_PER_SEC), c.validity)


class LastDay(_Unary):
    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, c: Vec) -> Vec:
        y, m, d = civil_from_days(c.data)
        last = c.data.to(torch.int64) - d.to(torch.int64) + \
            _days_in_month(y, m)
        return Vec(T.DATE, last.to(torch.int32), c.validity)


class AddMonths(Expression):
    """add_months(date, n): the day clamps to the target month's last."""

    def __init__(self, date, months):
        super().__init__([date, months])

    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, d: Vec, n: Vec) -> Vec:
        y, m, day = civil_from_days(d.data)
        total = y.to(torch.int64) * 12 + (m.to(torch.int64) - 1) + \
            n.data.to(torch.int64)
        ny, nm = _fdiv(total, 12), total % 12 + 1
        nd = torch.minimum(day.to(torch.int64), _days_in_month(ny, nm))
        return Vec(T.DATE, days_from_civil(ny, nm, nd).to(torch.int32),
                   and_validity(d.validity, n.validity))


class MonthsBetween(Expression):
    """months_between(a, b[, roundOff]): whole months when both are the
    same day of the month or both last days, else the months plus the
    difference in seconds over 31 days; rounded to 8 digits half even
    (the JAX `xp.round`) when round_off."""

    def __init__(self, end, start, round_off: bool = True):
        super().__init__([end, start])
        self.round_off = round_off

    def __repr__(self):
        return (f"{self.name}({self.children[0]!r}, {self.children[1]!r}, "
                f"{self.round_off})")

    @property
    def data_type(self):
        return T.DOUBLE

    def _compute(self, ctx, a: Vec, b: Vec) -> Vec:
        def parts(v: Vec):
            days = _days_of(v)
            tod = torch.zeros_like(days) if isinstance(v.dtype, T.DateType) \
                else v.data - days * _US_PER_DAY
            y, m, d = (x.to(torch.int64) for x in civil_from_days(days))
            return y, m, d, tod

        y1, m1, d1, t1 = parts(a)
        y2, m2, d2, t2 = parts(b)
        months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
        whole = (d1 == d2) | ((d1 == _days_in_month(y1, m1))
                              & (d2 == _days_in_month(y2, m2)))
        sec1 = d1 * 86400 + _fdiv(t1, _US_PER_SEC)
        sec2 = d2 * 86400 + _fdiv(t2, _US_PER_SEC)
        frac = ieee_div((sec1 - sec2).to(torch.float64), 31.0 * 86400.0)
        out = torch.where(whole, months, months + frac)
        if self.round_off:
            out = ieee_div(torch.round(out * 1e8), 1e8)
        return Vec(T.DOUBLE, out, and_validity(a.validity, b.validity))


_TRUNC_YEAR = ("YEAR", "YYYY", "YY")
_TRUNC_MONTH = ("MONTH", "MM", "MON")


def _trunc_days(days: torch.Tensor, fmt: str):
    """int64 days truncated to the unit, or None for an unknown unit."""
    if fmt == "WEEK":  # Monday
        return days - _monday_dow(days)
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(m)
    if fmt in _TRUNC_YEAR:
        return days_from_civil(y, one, one)
    if fmt in _TRUNC_MONTH:
        return days_from_civil(y, m, one)
    if fmt == "QUARTER":
        return days_from_civil(y, _fdiv(m.to(torch.int64) - 1, 3) * 3 + 1,
                               one)
    return None


class TruncDate(_Unary):
    """trunc(date, fmt) with a literal unit: YEAR/YYYY/YY, QUARTER,
    MONTH/MM/MON, WEEK (Monday); another unit is a null column."""

    def __init__(self, date, fmt: str):
        super().__init__(date)
        self.fmt = fmt.upper()

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.fmt!r})"

    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, c: Vec) -> Vec:
        out = _trunc_days(c.data.to(torch.int64), self.fmt)
        if out is None:
            return _null_like(T.DATE, c.data)
        return Vec(T.DATE, out.to(torch.int32), c.validity)


class NextDay(_Unary):
    """next_day(date, literal day name): the first later date on that
    weekday; the name's first two letters, any case (JAX); an unknown
    name is a null column."""

    _DOW = {"MO": 0, "TU": 1, "WE": 2, "TH": 3, "FR": 4, "SA": 5, "SU": 6}

    def __init__(self, date, day_name: str):
        super().__init__(date)
        self.day_name = day_name
        self.target = self._DOW.get(day_name.strip().upper()[:2])

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.day_name!r})"

    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, c: Vec) -> Vec:
        if self.target is None:
            return _null_like(T.DATE, c.data)
        days = c.data.to(torch.int64)
        delta = (self.target - _monday_dow(days)) % 7
        delta = torch.where(delta == 0, 7, delta)
        return Vec(T.DATE, (days + delta).to(torch.int32), c.validity)


class _NameLookup(_Unary):
    """DATE -> its 3-letter English name, gathered from a [k, 8] byte
    table (a string of width 8, length 3)."""
    names: tuple = ()

    @property
    def data_type(self):
        return T.STRING

    def _index(self, days: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _compute(self, ctx, c: Vec) -> Vec:
        table = torch.zeros((len(self.names), 8), dtype=torch.uint8)
        for i, name in enumerate(self.names):
            table[i, :3] = torch.tensor(list(name.encode()),
                                        dtype=torch.uint8)
        dev = c.data.device
        ix = self._index(c.data.to(torch.int64))
        n = c.data.shape[0]
        return Vec(T.STRING, table.to(dev)[ix], c.validity,
                   torch.full((n,), 3, dtype=torch.int32, device=dev))


class DayName(_NameLookup):
    names = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")

    def _index(self, days):
        return _monday_dow(days)


class MonthName(_NameLookup):
    names = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
             "Oct", "Nov", "Dec")

    def _index(self, days):
        return civil_from_days(days)[1].to(torch.int64) - 1


# ---------------------------------------------------------------------------
# Epoch conversions
# ---------------------------------------------------------------------------

class _EpochToTimestamp(_Unary):
    """timestamp_seconds/millis/micros(n): n times the unit's
    microseconds, wrapping in int64 as the JAX product does."""
    scale = 1

    @property
    def data_type(self):
        return T.TIMESTAMP

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(T.TIMESTAMP, c.data.to(torch.int64) * self.scale,
                   c.validity)


class TimestampSeconds(_EpochToTimestamp):
    scale = _US_PER_SEC


class TimestampMillis(_EpochToTimestamp):
    scale = 1_000


class TimestampMicros(_EpochToTimestamp):
    scale = 1


class DateFromUnixDate(_Unary):
    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(T.DATE, c.data.to(torch.int32), c.validity)


class UnixDate(_Unary):
    @property
    def data_type(self):
        return T.INT

    def _compute(self, ctx, c: Vec) -> Vec:
        return Vec(T.INT, c.data.to(torch.int32), c.validity)


class MakeDate(Expression):
    """make_date(y, m, d): null where a part is out of range (years
    1..9999), also under ANSI (the JAX rule)."""

    def __init__(self, year, month, day):
        super().__init__([year, month, day])

    @property
    def data_type(self):
        return T.DATE

    def _compute(self, ctx, y: Vec, m: Vec, d: Vec) -> Vec:
        yy, mm, dd = (v.data.to(torch.int64) for v in (y, m, d))
        ok = (mm >= 1) & (mm <= 12) & (yy >= 1) & (yy <= 9999) & (dd >= 1)
        yy = torch.where(ok, yy, 2000)
        mm = torch.where(ok, mm, 1)
        ok = ok & (dd <= _days_in_month(yy, mm))
        days = days_from_civil(yy, mm, torch.where(ok, dd, 1))
        return Vec(T.DATE, days.to(torch.int32),
                   y.validity & m.validity & d.validity & ok)


class TruncTimestamp(_Unary):
    """date_trunc(fmt, ts) with a literal unit: MICROSECOND .. DAY/DD by
    floor division, YEAR .. WEEK through the date's truncation; another
    unit is a null column."""

    _US = {"MICROSECOND": 1, "MILLISECOND": 1_000, "SECOND": _US_PER_SEC,
           "MINUTE": _US_PER_MIN, "HOUR": _US_PER_HOUR, "DAY": _US_PER_DAY,
           "DD": _US_PER_DAY}

    def __init__(self, fmt: str, child):
        super().__init__(child)
        self.fmt = fmt.upper()

    def __repr__(self):
        return f"{self.name}({self.fmt!r}, {self.children[0]!r})"

    @property
    def data_type(self):
        return T.TIMESTAMP

    def _compute(self, ctx, c: Vec) -> Vec:
        step = self._US.get(self.fmt)
        if step is not None:
            return Vec(T.TIMESTAMP, _fdiv(c.data, step) * step, c.validity)
        days = _trunc_days(_fdiv(c.data, _US_PER_DAY), self.fmt)
        if days is None:
            return _null_like(T.TIMESTAMP, c.data)
        return Vec(T.TIMESTAMP, days * _US_PER_DAY, c.validity)


# ---------------------------------------------------------------------------
# Fixed-width patterns: date_format, from_unixtime, unix_timestamp
# ---------------------------------------------------------------------------

_PAT_TOKENS = ("yyyy", "MM", "dd", "HH", "mm", "ss")


def compile_dt_pattern(fmt: str):
    """A pattern -> ([(token or 'lit', byte offset, text)], width). Java's
    quoting: '...' is a literal run and '' a quote, inside a run too.
    Raises ValueError on a letter outside yyyy/MM/dd/HH/mm/ss (a variable
    width) and on an open quote."""
    out, pos, off = [], 0, 0

    def lit(ch):
        nonlocal off
        out.append(("lit", off, ch))
        off += len(ch.encode("utf-8"))

    while pos < len(fmt):
        if fmt.startswith("''", pos):
            lit("'")
            pos += 2
            continue
        if fmt[pos] == "'":
            pos += 1
            while True:
                if pos >= len(fmt):
                    raise ValueError(f"unterminated quote in pattern {fmt!r}")
                if fmt.startswith("''", pos):
                    lit("'")
                    pos += 2
                elif fmt[pos] == "'":
                    pos += 1
                    break
                else:
                    lit(fmt[pos])
                    pos += 1
            continue
        tok = next((t for t in _PAT_TOKENS if fmt.startswith(t, pos)), None)
        if tok is not None:
            out.append((tok, off, tok))
            off += len(tok)
            pos += len(tok)
        elif fmt[pos].isalpha():
            raise ValueError(
                f"unsupported datetime pattern token at {fmt[pos:]!r} "
                "(fixed-width yyyy/MM/dd/HH/mm/ss + literals only)")
        else:
            lit(fmt[pos])
            pos += 1
    return out, off


class _PatternExpr(_Unary):
    def __init__(self, child, fmt: str):
        super().__init__(child)
        self.fmt = fmt
        self.parts, self.width = compile_dt_pattern(fmt)

    def __repr__(self):
        return f"{self.name}({self.children[0]!r}, {self.fmt!r})"


def format_micros(us: torch.Tensor, validity: torch.Tensor, parts,
                  width: int) -> Vec:
    """UTC microseconds -> the pattern's bytes, a string of width
    width_bucket(max(width, 8)) and length `width`; null where the year
    is outside 0..9999."""
    days = _fdiv(us, _US_PER_DAY)
    y, mo, d = (x.to(torch.int64) for x in civil_from_days(days))
    secs = _fdiv(us - days * _US_PER_DAY, _US_PER_SEC)
    comp = {"yyyy": y, "MM": mo, "dd": d, "HH": _fdiv(secs, 3600),
            "mm": _fdiv(secs, 60) % 60, "ss": secs % 60}
    n = us.shape[0]
    data = torch.zeros((n, width_bucket(max(width, 8))), dtype=torch.uint8,
                       device=us.device)
    for tok, off, text in parts:
        if tok == "lit":
            for k, byte in enumerate(text.encode("utf-8")):
                data[:, off + k] = byte
            continue
        v = comp[tok]
        for k in range(len(tok) - 1, -1, -1):
            data[:, off + k] = (v % 10 + ord("0")).to(torch.uint8)
            v = _fdiv(v, 10)
    return Vec(T.STRING, data, validity & (y >= 0) & (y <= 9999),
               torch.full((n,), width, dtype=torch.int32, device=us.device))


class DateFormat(_PatternExpr):
    """date_format(timestamp or date, literal fixed-width pattern)."""

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx, c: Vec) -> Vec:
        us = c.data.to(torch.int64)
        if isinstance(c.dtype, T.DateType):
            us = us * _US_PER_DAY
        return format_micros(us, c.validity, self.parts, self.width)


class FromUnixTime(_PatternExpr):
    """from_unixtime(seconds[, pattern]), UTC."""

    def __init__(self, child, fmt: str = "yyyy-MM-dd HH:mm:ss"):
        super().__init__(child, fmt)

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx, c: Vec) -> Vec:
        return format_micros(c.data.to(torch.int64) * _US_PER_SEC,
                             c.validity, self.parts, self.width)


class ToUnixTimestamp(_PatternExpr):
    """to_unix_timestamp(string[, pattern]) -> seconds since the epoch: a
    string of exactly the pattern's width whose literals match and whose
    fields are digits of a valid date and time; anything else is null
    (under ANSI too, the JAX rule). A field the pattern lacks is year
    1970, month and day 1, time 0."""

    def __init__(self, child, fmt: str = "yyyy-MM-dd HH:mm:ss"):
        super().__init__(child, fmt)

    @property
    def data_type(self):
        return T.LONG

    def _compute(self, ctx, c: Vec) -> Vec:
        b = c.data
        n, w = b.shape
        ok = c.validity & (c.lengths == self.width)
        zero = torch.zeros(n, dtype=torch.int64, device=b.device)
        comp = {"yyyy": zero + 1970, "MM": zero + 1, "dd": zero + 1,
                "HH": zero, "mm": zero, "ss": zero}
        for tok, off, text in self.parts:
            if off >= w:
                ok = torch.zeros_like(ok)
                continue
            if tok == "lit":
                for k, byte in enumerate(text.encode("utf-8")):
                    if off + k < w:
                        ok = ok & (b[:, off + k] == byte)
                continue
            acc = zero
            for k in range(len(tok)):
                if off + k < w:
                    digit = b[:, off + k].to(torch.int64) - ord("0")
                    ok = ok & (digit >= 0) & (digit <= 9)
                    acc = acc * 10 + digit
            comp[tok] = acc
        y, mo, d = comp["yyyy"], comp["MM"], comp["dd"]
        ok = ok & (mo >= 1) & (mo <= 12) & (d >= 1)
        ok = ok & (d <= _days_in_month(y, torch.clamp(mo, 1, 12)))
        days = days_from_civil(torch.where(ok, y, 2000),
                               torch.where(ok, mo, 1), torch.where(ok, d, 1))
        ok = ok & (comp["HH"] < 24) & (comp["mm"] < 60) & (comp["ss"] < 60)
        secs = days * 86400 + comp["HH"] * 3600 + comp["mm"] * 60 + \
            comp["ss"]
        return Vec(T.LONG, secs, ok)


class UnixTimestamp(ToUnixTimestamp):
    """unix_timestamp(string[, pattern]): to_unix_timestamp."""
