"""The casts between STRING and DECIMAL/TIMESTAMP (`expr/textcasts.py`) on
the port's host engine, held to Python `decimal`/`datetime` oracles of
Spark's rule (the JAX CPU engine computes another value or fails there).

  * STRING -> DECIMAL(p, s): `Decimal.fromString` (Java BigDecimal's
    grammar after String.trim; Unicode digits; an int exponent), HALF_UP
    to the scale, null past the precision; under ANSI the two messages;
  * DECIMAL -> STRING: `toPlainString`, to 38 digits;
  * TIMESTAMP -> STRING: `yyyy-MM-dd HH:mm:ss[.f]`, before 1970 too;
  * STRING -> TIMESTAMP: `stringToTimestamp`'s forms under UTC, zones by
    offset, name and region (zoneinfo), pre-1970 and fractional values.
The strings are seeded corpora of well and badly formed text. Every
comparison is exact."""

import datetime
import decimal
import re

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.errors import AnsiViolation
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
ANSI = dict(BASE, **{"spark.sql.ansi.enabled": True})
JAVA_TRIM = "".join(map(chr, range(0x21)))
EPOCH = datetime.datetime(1970, 1, 1)

DECIMAL_TEXT = [
    "12.34", " 1234 ", "12.345", "-12.345", "-0.005", "0.005", "1e-3",
    "1E2", "+.5", "5.", ".", "", " ", "+", "-", "e5", "1e", "1e+", "1e-",
    "1.2.3", "NaN", "nan", "Infinity", "-Infinity", "inf", "1_000",
    "1 000", "0x10", "12.3d", "99999.995", "99999.994", "-99999.995",
    "100000", "0e5", "00012.30", "1.5e-2147483648", "1e2147483648",
    "1e-2147483649", "1e2147483647", "\t7.25\n", "١٢٣.٤٥", "１２", " 12",
    "12 ", "+-1", "--1", "1e+-2", "0.000000000000000000000000000001",
    "123456789012345678901234567890.123456789", "-0", "-0.00",
    "9223372036854775807", "1.23456789012345678901234567890123456789e5",
    "4.9999999999999999999999", "5E-3", "  -1.005e1  "]


def _text_corpus(n=240, seed=71):
    rng = np.random.default_rng(seed)
    out = list(DECIMAL_TEXT)
    while len(out) < n:
        kind = rng.integers(0, 4)
        digits = "".join(rng.choice(list("0123456789"),
                                    rng.integers(1, 12)))
        if kind == 0:
            out.append(digits)
        elif kind == 1:
            k = rng.integers(0, len(digits) + 1)
            out.append(rng.choice(["", "-", "+"]) + digits[:k] + "."
                       + digits[k:])
        elif kind == 2:
            out.append(f"{digits[:3]}.{digits[3:]}e{rng.integers(-9, 9)}")
        else:
            out.append(" " * rng.integers(0, 3) + digits
                       + rng.choice(["", "x", " ", ".5", "e"]))
    return out


_BIGDEC = re.compile(r"[+-]?([0-9]+\.?[0-9]*|\.[0-9]+)([eE][+-]?[0-9]+)?")


def spark_decimal(text, p, s):
    """Spark's cast of one string to decimal(p, s): (unscaled int or None,
    'invalid' | 'range' | None)."""
    if text is None:
        return None, None
    t = text.strip(JAVA_TRIM)
    t = "".join(str(int(ch)) if ch.isdecimal() and ord(ch) < 0x10000
                else ch for ch in t)
    m = _BIGDEC.fullmatch(t)
    if m is None:
        return None, "invalid"
    mant, exp = m.group(1), m.group(2)
    e = int(exp[1:]) if exp else 0
    frac = len(mant.split(".")[1]) if "." in mant else 0
    if not -2 ** 31 <= e < 2 ** 31 or not -2 ** 31 <= frac - e < 2 ** 31:
        return None, "invalid"
    d = decimal.Decimal(t)
    if d != 0 and d.adjusted() >= p - s:
        return None, "range"
    q = d.quantize(decimal.Decimal(1).scaleb(-s),
                   context=decimal.Context(prec=200,
                                           rounding=decimal.ROUND_HALF_UP))
    u = int(q.scaleb(s))
    if abs(u) >= 10 ** p:
        return None, "range"
    return u, None


def _unscaled(col, s):
    return [None if v is None else int(v.scaleb(s)) for v in col.to_pylist()]


@pytest.mark.parametrize("p,s", [(7, 2), (18, 0), (18, 6), (38, 10),
                                 (5, 5), (38, 0)])
def test_string_to_decimal_follows_spark(p, s):
    text = _text_corpus() + [None]
    t = pa.table({"s": pa.array(text, pa.string())})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("s"), T.DecimalType(p, s)))
    want = [spark_decimal(v, p, s)[0] for v in text]
    for got in (q.collect(), q.collect_cpu()):
        assert got.column("o").type == pa.decimal128(p, s)
        assert _unscaled(got.column("o"), s) == want


@pytest.mark.parametrize("bad,message", [
    ("12.3.4", "[CAST_INVALID_INPUT] value cannot be cast to decimal(7,2)"),
    ("NaN", "[CAST_INVALID_INPUT] value cannot be cast to decimal(7,2)"),
    ("123456", "[NUMERIC_VALUE_OUT_OF_RANGE] value out of range for "
               "decimal(7,2)"),
    ("99999.995", "[NUMERIC_VALUE_OUT_OF_RANGE] value out of range for "
                  "decimal(7,2)")])
def test_string_to_decimal_ansi(bad, message):
    t = pa.table({"s": ["12.34", None, bad]})
    sess = TpuSession(ANSI, device="cpu")
    with pytest.raises(AnsiViolation) as err:
        sess.from_arrow(t).select(
            o=PE.Cast(PE.col("s"), T.DecimalType(7, 2))).collect()
    assert str(err.value) == message
    ok = sess.from_arrow(t.slice(0, 2)).select(
        o=PE.Cast(PE.col("s"), T.DecimalType(7, 2))).collect()
    assert _unscaled(ok.column("o"), 2) == [1234, None]


def _decimals(p, s, n=200, seed=73):
    rng = np.random.default_rng(seed)
    top = 10 ** p - 1
    vals = [0, 1, -1, top, -top, 10 ** min(s, p - 1), -(10 ** s) + 1, 5,
            None]
    while len(vals) < n:
        digits = int(rng.integers(1, p + 1))
        v = int("".join(rng.choice(list("0123456789"), digits)))
        vals.append(-v if rng.random() < 0.5 else v)
    wide = decimal.Context(prec=80)
    return [None if v is None else decimal.Decimal(v).scaleb(-s, wide)
            for v in vals]


@pytest.mark.parametrize("p,s", [(7, 2), (18, 0), (18, 9), (38, 18),
                                 (38, 0), (3, 3)])
def test_decimal_to_string_is_plain(p, s):
    vals = _decimals(p, s)
    t = pa.table({"d": pa.array(vals, pa.decimal128(p, s))})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("d"), T.STRING))
    want = [None if v is None else format(v, "f") for v in vals]
    for got in (q.collect(), q.collect_cpu()):
        assert got.column("o").to_pylist() == want
    # and back: the text parses to the same decimal
    back = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.Cast(PE.col("d"), T.STRING), T.DecimalType(p, s)))
    assert back.collect().column("o").equals(t.column("d"))


def _timestamps(n=200, seed=79):
    rng = np.random.default_rng(seed)
    us = rng.integers(-62135596800 * 10 ** 6, 253402300800 * 10 ** 6, n)
    us[:8] = [0, -1, 1, -500_000, 86_400_000_000 - 1,
              -62135596800 * 10 ** 6, 253402300799 * 10 ** 6 + 999_999,
              984313845_120_000]
    us[8::5] = us[8::5] // 10 ** 6 * 10 ** 6   # whole seconds
    us[9::5] = us[9::5] // 1000 * 1000         # whole milliseconds
    return us


def python_ts_string(us: int) -> str:
    t = EPOCH + datetime.timedelta(microseconds=int(us))
    frac = f"{t.microsecond:06d}".rstrip("0")
    return (f"{t.year:04d}-{t.month:02d}-{t.day:02d} {t.hour:02d}:"
            f"{t.minute:02d}:{t.second:02d}" + (f".{frac}" if frac else ""))


def test_timestamp_to_string_follows_spark():
    us = _timestamps()
    valid = np.arange(len(us)) % 17 != 11
    t = pa.table({"ts": pa.array(us, pa.timestamp("us", tz="UTC"),
                                 mask=~valid)})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("ts"), T.STRING))
    want = [python_ts_string(v) if ok else None for v, ok in zip(us, valid)]
    for got in (q.collect(), q.collect_cpu()):
        assert got.column("o").to_pylist() == want
    assert want[2] == "1970-01-01 00:00:00.000001"
    assert want[3] == "1969-12-31 23:59:59.5"
    assert want[1] == "1969-12-31 23:59:59.999999"
    # and back through STRING -> TIMESTAMP
    back = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.Cast(PE.col("ts"), T.STRING), T.TIMESTAMP))
    assert back.collect().column("o").equals(t.column("ts"))


def test_timestamp_to_string_outside_years_1_to_9999_raises():
    t = pa.table({"ts": pa.array([253402300800 * 10 ** 6],
                                 pa.timestamp("us", tz="UTC"))})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("ts"), T.STRING))
    with pytest.raises(NotImplementedError, match="outside 1..9999"):
        q.collect()


_TS = re.compile(r"([+-]?)([0-9]{4,6})(?:-([0-9]{1,2})(?:-([0-9]{1,2})"
                 r"(?:[ T]([0-9]{1,2})(?::([0-9]{1,2})(?::([0-9]{1,2})"
                 r"(?:\.([0-9]*))?)?)?)?)?)?")


def spark_timestamp(text):
    """stringToTimestamp under UTC for a string with no zone: micros or
    None."""
    if text is None:
        return None
    m = _TS.fullmatch(text.strip(JAVA_TRIM))
    if m is None:
        return None
    sign, y, mo, d, h, mi, s, f = m.groups()
    year = -int(y) if sign == "-" else int(y)
    mo, d, h, mi, s = (int(v) if v else dflt for v, dflt in
                       ((mo, 1), (d, 1), (h, 0), (mi, 0), (s, 0)))
    frac = int((f or "")[:6].ljust(6, "0"))
    if not (1 <= mo <= 12 and h <= 23 and mi <= 59 and s <= 59):
        return None
    days = int(np.datetime64(f"{year:04d}-{mo:02d}-01", "D")
               .astype(np.int64)) if 1 <= year <= 9999 else None
    if days is None:
        return "year"
    nxt = int((np.datetime64(f"{year:04d}-{mo:02d}-01", "M") + 1)
              .astype("datetime64[D]").astype(np.int64))
    if not 1 <= d <= nxt - days:
        return None
    return ((days + d - 1) * 86400 + h * 3600 + mi * 60 + s) * 10 ** 6 + frac


TS_TEXT = [
    "2001-03-11", "2001-03-11 12:30:45", "2001-03-11T12:30:45.123456789",
    "1969-12-31 23:59:59.5", "1969-12-31 23:59:59.999999", "2001",
    "2001-3", "2001-3-1", "2001-03-11 1:2:3", "2001-03-11 12",
    "2001-03-11 12:30", "2001-03-11 12:30:45.", "0001-01-01 00:00:00",
    "9999-12-31 23:59:59.999999", "2000-02-29", "2001-02-29", "2001-13-01",
    "2001-00-10", "2001-03-00", "2001-03-11 24:00:00", "2001-03-11 12:60",
    "2001-03-11 12:30:60", "12:30:45", "T12:30", "2001-03-11T", "201-03-11",
    "+2001-03-11", "  2001-03-11 12:00:00  ", "2001-03-11 12:00:00.1234567",
    "2001/03/11", "abc", "", " ", None, "2001-03-11 12:30:4", "01234-01-01",
    "2001-03-11  12:00"]


def test_string_to_timestamp_follows_spark():
    rng = np.random.default_rng(83)
    extra = [f"{rng.integers(1, 10000):04d}-{rng.integers(0, 14)}-"
             f"{rng.integers(0, 33)}{rng.choice([' ', 'T'])}"
             f"{rng.integers(0, 25)}:{rng.integers(0, 61):02d}:"
             f"{rng.integers(0, 61):02d}.{rng.integers(0, 10 ** 6)}"
             for _ in range(160)]
    text = TS_TEXT + extra
    t = pa.table({"s": pa.array(text, pa.string())})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("s"), T.TIMESTAMP))
    want = [spark_timestamp(v) for v in text]
    assert "year" not in want
    for got in (q.collect(), q.collect_cpu()):
        assert got.column("o").cast(pa.int64()).to_pylist() == want
    assert want[3] == -500_000 and want[2] == 984313845123456


ZONES = {  # text after "2001-03-11 12:00:00": seconds east of UTC, or None
    "Z": 0, "+08:00": 8 * 3600, "-0530": -(5 * 3600 + 30 * 60),
    "+1": 3600, "+1:3": 3600 + 180, "-08:3": -(8 * 3600 + 180),
    " UTC": 0, "UTC+01:00": 3600, "GMT-8": -8 * 3600, "UT": 0,
    " EST": -5 * 3600, "+18:00": 18 * 3600, "+18:01": None, "+19": None,
    "z": None, "+08:00:30": 8 * 3600 + 30, "+083000": 8.5 * 3600,
    " PST": -8 * 3600, "Europe/Paris": 3600, "America/New_York": -5 * 3600,
    "!zone": None, "+08-00": None}


def test_zones_follow_java():
    base = "2001-03-11 12:00:00"
    names = list(ZONES)
    t = pa.table({"s": [base + z for z in names] + [base + ".25+02:00",
                                                     "1960-07-01 00:00:00 "
                                                     "Europe/Paris"]})
    got = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("s"), T.TIMESTAMP)).collect_cpu()
    local = spark_timestamp(base)
    want = [None if ZONES[z] is None else local - int(ZONES[z]) * 10 ** 6
            for z in names]
    # Paris kept CET (+1) all summer in 1960
    want += [local - 2 * 3600 * 10 ** 6 + 250_000,
             spark_timestamp("1960-07-01 00:00:00") - 3600 * 10 ** 6]
    assert got.column("o").cast(pa.int64()).to_pylist() == want


def test_unknown_region_raises():
    """A region id Java might know but this machine's zoneinfo does not:
    the port raises rather than guess null or a time."""
    t = pa.table({"s": ["2001-03-11 12:00:00 Mars/Olympus_Mons"]})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col("s"), T.TIMESTAMP))
    with pytest.raises(NotImplementedError, match="zoneinfo"):
        q.collect()


def test_string_to_timestamp_ansi():
    t = pa.table({"s": ["2001-03-11 12:00:00", None, "2001-02-29"]})
    sess = TpuSession(ANSI, device="cpu")
    with pytest.raises(AnsiViolation) as err:
        sess.from_arrow(t).select(
            o=PE.Cast(PE.col("s"), T.TIMESTAMP)).collect()
    assert str(err.value) == \
        "[CAST_INVALID_INPUT] value cannot be cast to timestamp"
    ok = sess.from_arrow(t.slice(0, 2)).select(
        o=PE.Cast(PE.col("s"), T.TIMESTAMP)).collect()
    assert ok.column("o").cast(pa.int64()).to_pylist() == [
        spark_timestamp("2001-03-11 12:00:00"), None]
