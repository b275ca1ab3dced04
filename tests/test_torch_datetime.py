"""The port's date and time expressions (`expr/datetime_.py`) against the
JAX package on the CPU.

Every class of the JAX `expr/datetime_.py` runs on seeded dates,
timestamps, numbers and strings: the edge days (year 1, 1969-12-31, the
epoch, leap days, month ends, year 9999), timestamps before 1970 down to
one microsecond below the epoch, day and month counts of both signs,
and well and badly formed date strings. Each query runs through the
port's device plan (`device="cpu"`) and its host engine and is held to
the JAX engine's device path (`collect()`) and its CPU engine
(`collect_cpu()`). Tolerance: exact, every date, time, count, string and
double, but MonthsBetween's rounded doubles against the JAX device path:
XLA divides by 10^8 as a product with its reciprocal, 1 ULP off numpy's
division in some rows, so there rtol 2.3e-16 (1 ULP); the port equals
the JAX CPU engine's numpy to the bit.

The planner: the JAX rule keys send a class to the host with the JAX
reason, and the port refuses a class over an operand type it does not
compute (a timestamp read as days, a decimal's unscaled value)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.expr import datetime_ as JD
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.expr import datetime_ as PD
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
N = 96
US_DAY = 86_400_000_000
# year 1, 1969-12-31, the epoch, 1900-02-28, 2000-01-31, 2000-02-29,
# 2000-03-31, 2004-02-29, 2100-02-28, 9999-12-31
EDGE_DAYS = [-719162, -1, 0, -25508, 10987, 11016, 11047, 12477, 47540,
             2932896]
EDGE_US = [-1, 0, 1, -US_DAY, -US_DAY - 1, -62135596800 * 10 ** 6,
           253402300799 * 10 ** 6 + 999_999, 984313845123456,
           -3_600_000_001, 951782400 * 10 ** 6]
DATE_TEXT = ["2001-03-11 12:30:45", "2000-02-29 00:00:00",
             "2001-02-29 00:00:00", "2001-13-01 00:00:00",
             "2001-03-11 24:00:00", "2001-03-11 12:60:00",
             "2001-03-11T12:30:45", "2001-3-11 12:30:45",
             "abcd-03-11 12:30:45",
             "0001-01-01 00:00:00", "9999-12-31 23:59:59", "", None,
             "1969-12-31 23:59:59", "2001-03-11 12:30:45 "]


def _table(n=N, seed=61):
    rng = np.random.default_rng(seed)
    days = rng.integers(-719162, 2932897, n).astype(np.int32)
    days[:len(EDGE_DAYS)] = EDGE_DAYS
    days2 = rng.integers(-5000, 25000, n).astype(np.int32)
    us = rng.integers(-62135596800 * 10 ** 6, 253402300800 * 10 ** 6, n)
    us[:len(EDGE_US)] = EDGE_US
    us2 = rng.integers(-10 ** 15, 2 * 10 ** 15, n)
    valid = rng.random(n) >= 0.08
    text = DATE_TEXT + [
        f"{rng.integers(1, 10000):04d}-{rng.integers(1, 14):02d}-"
        f"{rng.integers(1, 32):02d} {rng.integers(0, 25):02d}:"
        f"{rng.integers(0, 61):02d}:{rng.integers(0, 61):02d}"
        for _ in range(n - len(DATE_TEXT))]
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "d": pa.array(days, pa.date32(), mask=~valid),
        "d2": pa.array(days2, pa.date32()),
        "ts": pa.array(us, pa.timestamp("us", tz="UTC"), mask=~valid),
        "ts2": pa.array(us2, pa.timestamp("us", tz="UTC")),
        "k": pa.array(rng.integers(-400, 400, n).astype(np.int32)),
        "months": pa.array(rng.integers(-300, 300, n).astype(np.int32)),
        "secs": pa.array(rng.integers(-62135596800, 253402300800, n)),
        "big": pa.array(rng.integers(-2 ** 40, 2 ** 40, n)),
        "y": pa.array(rng.integers(-2, 10003, n).astype(np.int32)),
        "mo": pa.array(rng.integers(-1, 14, n).astype(np.int32)),
        "dd": pa.array(rng.integers(-1, 33, n).astype(np.int32)),
        "s": pa.array(text, pa.string()),
        "dmy": pa.array([f"{rng.integers(1, 32):02d}/{rng.integers(1, 13):02d}"
                         f"/{rng.integers(1900, 2100)}" for _ in range(n)]),
    })


PARTS = ("Year", "Month", "DayOfMonth", "Quarter", "DayOfWeek", "WeekDay",
         "DayOfYear", "WeekOfYear")
PATTERNS = ("yyyy-MM-dd HH:mm:ss", "yyyy-MM-dd'T'HH:mm", "dd/MM/yyyy",
            "HH''mm''ss", "yyyyMMdd")


def _case(name):
    """The case's expression as a function of a namespace m (the JAX
    package's or the port's)."""
    kind, _, arg = name.partition(":")
    if kind in PARTS:
        return lambda m: getattr(m, kind)(m.col(arg))
    if kind in ("Hour", "Minute", "Second", "UnixTimestampFromTs"):
        return lambda m: getattr(m, kind)(m.col("ts"))
    if kind in ("DateAdd", "DateSub"):
        return lambda m: getattr(m, kind)(m.col("d"), m.col("k"))
    if kind == "DateDiff":
        return lambda m: m.DateDiff(m.col("d"), m.col("d2"))
    if kind in ("LastDay", "DayName", "MonthName", "UnixDate"):
        return lambda m: getattr(m, kind)(m.col("d"))
    if kind == "AddMonths":
        return lambda m: m.AddMonths(m.col("d"), m.col("months"))
    if kind == "MonthsBetween":
        a, b, r = arg.split(",")
        return lambda m: m.MonthsBetween(m.col(a), m.col(b), r == "round")
    if kind == "TruncDate":
        return lambda m: m.TruncDate(m.col("d"), arg)
    if kind == "NextDay":
        return lambda m: m.NextDay(m.col("d"), arg)
    if kind in ("TimestampSeconds", "TimestampMillis", "TimestampMicros"):
        return lambda m: getattr(m, kind)(m.col("big"))
    if kind == "DateFromUnixDate":
        return lambda m: m.DateFromUnixDate(m.col("k"))
    if kind == "MakeDate":
        return lambda m: m.MakeDate(m.col("y"), m.col("mo"), m.col("dd"))
    if kind == "TruncTimestamp":
        return lambda m: m.TruncTimestamp(arg, m.col("ts"))
    if kind == "DateFormat":
        col, pat = arg.split("|")
        return lambda m: m.DateFormat(m.col(col), pat)
    if kind == "FromUnixTime":
        return lambda m: m.FromUnixTime(m.col("secs"), arg)
    if kind in ("ToUnixTimestamp", "UnixTimestamp"):
        col, pat = arg.split("|")
        return lambda m: getattr(m, kind)(m.col(col), pat)
    raise KeyError(name)


CASES = (
    [f"{p}:{c}" for p in PARTS for c in ("d", "ts")]
    + ["Hour", "Minute", "Second", "UnixTimestampFromTs", "DateAdd",
       "DateSub", "DateDiff", "LastDay", "AddMonths", "DayName",
       "MonthName", "UnixDate", "MonthsBetween:ts,ts2,round",
       "MonthsBetween:d,d2,round", "MonthsBetween:ts,d,exact",
       "TruncDate:YEAR", "TruncDate:mm", "TruncDate:QUARTER",
       "TruncDate:WEEK", "TruncDate:DAY", "NextDay:SU", "NextDay:mon",
       "NextDay:MOXX", "NextDay:XX", "TimestampSeconds", "TimestampMillis",
       "TimestampMicros", "DateFromUnixDate", "MakeDate",
       "TruncTimestamp:YEAR", "TruncTimestamp:QUARTER",
       "TruncTimestamp:MONTH", "TruncTimestamp:WEEK", "TruncTimestamp:DD",
       "TruncTimestamp:HOUR", "TruncTimestamp:MINUTE",
       "TruncTimestamp:SECOND", "TruncTimestamp:MILLISECOND",
       "TruncTimestamp:DECADE"]
    + [f"DateFormat:ts|{p}" for p in PATTERNS]
    + ["DateFormat:d|yyyy-MM-dd", "FromUnixTime:yyyy-MM-dd HH:mm:ss",
       "FromUnixTime:dd/MM/yyyy", "ToUnixTimestamp:s|yyyy-MM-dd HH:mm:ss",
       "UnixTimestamp:s|yyyy-MM-dd HH:mm:ss",
       "ToUnixTimestamp:dmy|dd/MM/yyyy",
       "ToUnixTimestamp:s|yyyy-MM-dd'T'HH:mm:ss"])


class _JaxNS:
    col = staticmethod(JE.col)

    def __getattr__(self, name):
        return getattr(JD, name)


class _PortNS:
    col = staticmethod(PE.col)

    def __getattr__(self, name):
        return getattr(PE, name)


@pytest.fixture(scope="module")
def table():
    return _table()


def _equal(a: pa.Table, b: pa.Table, what: str, rtol: float = 0.0):
    assert a.schema == b.schema, (what, a.schema, b.schema)
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        if pa.types.is_floating(x.type):
            xn, yn = x.to_numpy(zero_copy_only=False), \
                y.to_numpy(zero_copy_only=False)
            assert np.array_equal(np.asarray(x.is_null()),
                                  np.asarray(y.is_null())), what
            assert np.allclose(xn, yn, rtol=rtol, atol=0, equal_nan=True) \
                and np.array_equal(np.isnan(xn), np.isnan(yn)), \
                (what, xn, yn)
        else:
            assert x.equals(y), f"{what}: {name}\n{x}\n{y}"


@pytest.mark.parametrize("name", CASES)
def test_matches_jax(table, name):
    build = _case(name)
    want = JaxSession(BASE).from_arrow(table).select(
        "i", o=build(_JaxNS())).collect()
    want_cpu = JaxSession(BASE).from_arrow(table).select(
        "i", o=build(_JaxNS())).collect_cpu().sort_by("i")
    rtol = 2.3e-16 if name.endswith(",round") else 0.0
    q = TpuSession(BASE, device="cpu").from_arrow(table).select(
        "i", o=build(_PortNS()))
    assert "Cpu" not in q.explain()
    for got, how in ((q.collect(), "device"), (q.collect_cpu(), "host")):
        got = got.sort_by("i")
        _equal(got, want_cpu, f"{name}: {how} against JAX collect_cpu()")
        _equal(got, want.sort_by("i"), f"{name}: {how} against JAX "
               "collect()", rtol)


def test_negative_times_floor():
    """Hour of one microsecond before the epoch is 23, its second 59, its
    day 1969-12-31; date_trunc('DAY') of it is the day before."""
    t = pa.table({"ts": pa.array([-1, -US_DAY - 1], pa.timestamp("us",
                                                                tz="UTC"))})
    out = TpuSession(BASE, device="cpu").from_arrow(t).select(
        h=PE.Hour(PE.col("ts")), m=PE.Minute(PE.col("ts")),
        s=PE.Second(PE.col("ts")), y=PE.DayOfMonth(PE.col("ts")),
        t=PE.TruncTimestamp("DAY", PE.col("ts"))).collect()
    assert out.column("h").to_pylist() == [23, 23]
    assert out.column("m").to_pylist() == [59, 59]
    assert out.column("s").to_pylist() == [59, 59]
    assert out.column("y").to_pylist() == [31, 30]
    assert out.column("t").cast(pa.int64()).to_pylist() == [-US_DAY,
                                                           -2 * US_DAY]


def test_add_months_clamps_to_month_end():
    """2000-02-29 + 12 months is 2001-02-28; 2001-01-31 + 1 is 02-28;
    9999-12-31 - 1 is 9999-11-30 (numpy datetime64 oracle)."""
    days = [11016, 11353, 2932896, -719162]
    months = [12, 1, -1, 13]
    t = pa.table({"d": pa.array(days, pa.date32()),
                  "n": pa.array(months, pa.int32())})
    out = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.AddMonths(PE.col("d"), PE.col("n"))).collect()
    got = out.column("o").cast(pa.int32()).to_numpy()
    want = ["2001-02-28", "2001-02-28", "9999-11-30", "0002-02-01"]
    assert [str(np.datetime64(int(g), "D")) for g in got] == want


def test_compile_dt_pattern_matches_jax():
    for pat in PATTERNS + ("'at' HH", "yyyy''MM", "'it''s' yyyy",
                           "'é'-yyyy", "yyyy.MM"):
        assert PD.compile_dt_pattern(pat) == JD.compile_dt_pattern(pat), pat
    for bad in ("yyyy-MMM", "'open", "EEE"):
        with pytest.raises(ValueError):
            PD.compile_dt_pattern(bad)


def _bang(conf, make, t):
    """The `!` lines of both engines' explain for one query."""
    conf = dict(conf, **{"spark.rapids.sql.explain": "NOT_ON_GPU"})
    jov = JaxOverrides(JaxConf(conf))
    jov.apply(make(JaxSession(conf), _JaxNS(), t).plan)
    pov = Overrides(TpuConf(conf), torch.device("cpu"))
    pov.apply(make(TpuSession(conf, device="cpu"), _PortNS(), t).plan)
    return ([ln.strip() for ln in jov.explain_string().splitlines()
             if "!" in ln],
            [ln.strip() for ln in pov.explain_string().splitlines()
             if "!" in ln])


@pytest.mark.parametrize("cls", ["Year", "DateAdd", "DateFormat",
                                 "TruncTimestamp"])
def test_rule_key_sends_to_host_with_jax_reason(table, cls):
    name = {"Year": "Year:d", "DateAdd": "DateAdd",
            "DateFormat": "DateFormat:ts|yyyy-MM-dd HH:mm:ss",
            "TruncTimestamp": "TruncTimestamp:HOUR"}[cls]
    conf = dict(BASE, **{f"spark.rapids.sql.expression.{cls}": False})
    jl, pl = _bang(conf, lambda s, m, t: s.from_arrow(t).select(
        "i", o=_case(name)(m)), table)
    assert pl == jl and pl, (jl, pl)
    q = TpuSession(conf, device="cpu").from_arrow(table).select(
        "i", o=_case(name)(_PortNS()))
    want = JaxSession(BASE).from_arrow(table).select(
        "i", o=_case(name)(_JaxNS())).collect_cpu()
    _equal(q.collect().sort_by("i"), want.sort_by("i"), cls)


@pytest.mark.parametrize("expr", ["year_of_string", "hour_of_date",
                                  "last_day_of_timestamp",
                                  "date_add_double"])
def test_operand_types_refused(expr):
    t = pa.table({"s": ["2001-03-11"], "d": pa.array([1], pa.date32()),
                  "ts": pa.array([1], pa.timestamp("us", tz="UTC")),
                  "x": [1.5]})
    e = {"year_of_string": PE.Year(PE.col("s")),
         "hour_of_date": PE.Hour(PE.col("d")),
         "last_day_of_timestamp": PE.LastDay(PE.col("ts")),
         "date_add_double": PE.DateAdd(PE.col("d"), PE.col("x"))}[expr]
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(o=e)
    with pytest.raises(NotImplementedError, match="is not supported"):
        q.explain()
