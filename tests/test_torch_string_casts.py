"""The port's casts from and to STRING (`expr/cast.py`) and its exact float
parse (`expr/floatparse.py`) against the JAX package on the CPU.

  * STRING <-> BOOLEAN, the integral types and DATE: the port's device
    plan and host engine equal the JAX engine's host run on seeded
    strings (signs, spaces, overflow, bad text, every date form);
  * the float parse equals Python `float()` bit for bit on a seeded
    corpus of 3,000 strings (the port alone: the JAX jit path over such a
    corpus takes many minutes), and the JAX device parse run by numpy
    (`_parse_float_device` with xp=np) on the same byte matrix, the forms
    Java's parseDouble adds (d/f suffixes, hex) included;
  * `compose_float64` equals the JAX `compose_float64(np, ...)` on the
    same limbs;
  * FLOAT/DOUBLE -> STRING runs on the host engine with the JAX tag's
    reason: it equals JAX `_java_double_str` where that follows Java's
    `Double.toString`, and an oracle of Java's rule where it does not
    (ROADMAP.md "Known differences");
  * the four casts between STRING and DECIMAL/TIMESTAMP run on the host
    engine by Spark's rule (`test_c5_casts_follow_spark`); the ANSI
    messages and the explain tags equal the JAX engine's.
Every comparison is exact."""

import decimal
import math
import struct

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.expr import cast as JC
from spark_rapids_tpu.expr import floatparse as JF
from spark_rapids_tpu.expr.base import Vec as JVec
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.errors import AnsiViolation
from spark_rapids_tpu_torch.expr import cast as PC
from spark_rapids_tpu_torch.expr import floatparse as PF
from spark_rapids_tpu_torch.expr.base import Vec
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
ANSI = dict(BASE, **{"spark.sql.ansi.enabled": True})

TEXT = ["12", " -34 ", "+5", "007", "9223372036854775807",
        "-9223372036854775808", "9223372036854775808", "-129", "128",
        "32768", "2147483648", "1.5", "abc", "", "  ", "+", "-", "1 2",
        "true", "FALSE", " yes", "n", "T", "0", "1", "maybe",
        "2001-03-11", "2001-3-1", "2001-02-29", "2000-02-29",
        "2000-02-29 10:00", "2001-03-11T1", "2001-13-01", "12345-01-01",
        "99", "2001", "2001-07", "0001-01-01", "9999-12-31", "2001-03-11x",
        "-2001-01-01", "é中", None]


def _text_table(n=160, seed=3):
    rng = np.random.default_rng(seed)
    extra = []
    for _ in range(n - len(TEXT)):
        kind = rng.integers(0, 3)
        if kind == 0:
            extra.append(" " * rng.integers(0, 2) + str(int(rng.integers(
                -10 ** 12, 10 ** 12))) + " " * rng.integers(0, 2))
        elif kind == 1:
            extra.append(f"{rng.integers(1, 10000):04d}-"
                         f"{rng.integers(1, 13)}-{rng.integers(1, 32)}")
        else:
            extra.append(str(rng.choice(["t", "f", "Y", "no", "1", "x"])))
    return pa.table({"i": pa.array(np.arange(n), pa.int64()),
                     "s": pa.array(TEXT + extra, pa.string())})


FROM_TYPES = ["BYTE", "SHORT", "INT", "LONG", "BOOLEAN", "DATE"]


@pytest.mark.parametrize("to", FROM_TYPES)
def test_from_string_equals_jax(to):
    t = _text_table()
    want = JaxSession(BASE).from_arrow(t).select(
        "i", o=JE.Cast(JE.col("s"), getattr(JT, to))).collect_cpu()
    df = TpuSession(BASE, device="cpu").from_arrow(t).select(
        "i", o=PE.Cast(PE.col("s"), getattr(T, to)))
    assert df.collect().sort_by("i").equals(want.sort_by("i"))
    assert df.collect_cpu().sort_by("i").equals(want.sort_by("i"))


def _typed_table(n=64, seed=4):
    rng = np.random.default_rng(seed)
    big = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    big[:4] = [0, -1, 2 ** 63 - 1, -2 ** 63]
    days = rng.integers(-719162, 2932896, n).astype(np.int32)
    days[:3] = [0, -719162, 2932896]  # 1970-01-01, 0001-01-01, 9999-12-31
    valid = rng.random(n) >= 0.1
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "l": pa.array(big, mask=~valid),
        "b8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        "n": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
        "z": pa.array(rng.random(n) < 0.5, mask=~valid),
        "d": pa.array(days, pa.date32(), mask=~valid)})


@pytest.mark.parametrize("src", ["l", "b8", "h", "n", "z", "d"])
def test_to_string_equals_jax(src):
    t = _typed_table()
    want = JaxSession(BASE).from_arrow(t).select(
        "i", o=JE.Cast(JE.col(src), JT.STRING)).collect_cpu()
    df = TpuSession(BASE, device="cpu").from_arrow(t).select(
        "i", o=PE.Cast(PE.col(src), T.STRING))
    assert df.collect().sort_by("i").equals(want.sort_by("i"))
    # the round trip of the integral and date texts
    if src not in ("z",):
        back = TpuSession(BASE, device="cpu").from_arrow(t).select(
            "i", o=PE.Cast(PE.Cast(PE.col(src), T.STRING),
                           {"l": T.LONG, "b8": T.BYTE, "h": T.SHORT,
                            "n": T.INT, "d": T.DATE}[src]))
        assert back.collect().column("o").equals(t.column(src))


def test_literal_date_casts_on_the_device_plan():
    """q21's window, `cast('2001-02-09' as date)` over a date column
    (2001-02-09 is day 11,362 and 2001-04-10 day 11,422)."""
    t = pa.table({"d": pa.array([11361, 11362, 11422, 11423, None],
                                pa.date32())})
    q = TpuSession(BASE, device="cpu").from_arrow(t).filter(
        (PE.col("d") >= PE.Cast(PE.lit("2001-02-09"), T.DATE))
        & (PE.col("d") <= PE.Cast(PE.lit("2001-04-10"), T.DATE)))
    assert "Cpu" not in q.explain()
    assert q.collect().column("d").cast(pa.int32()).to_pylist() == \
        [11362, 11422]


# --- the exact float parse ---------------------------------------------------

# exact ties between two doubles written with a fraction: half even
TIES = ["9007199254740993.0", "4503599627370496.5", "14.1427265629188790e15",
        "-9007199254740995.00", "90071992547409930e-1", "123456789012345678.5"]


def _float_corpus(n=3000, seed=11):
    """Decimal spellings Python's float() and the JVM read alike: signs,
    leading zeros, fractions, exponents, 1-45 significant digits, spaces,
    subnormals, the edges of the range, words."""
    rng = np.random.default_rng(seed)
    out = ["0", "-0.0", "1", "0.1", "4.9e-324", "2.4703282292062327e-324",
           "2.4703282292062328e-324", "2.2250738585072011e-308",
           "2.2250738585072014e-308", "1.7976931348623157e308",
           "1.7976931348623158e308", "1.7976931348623159e308", "1e309",
           "1e-400", ".5", "5.", "+.5e-3", "NaN", "-Infinity", "inf",
           "  3.25  ", "9007199254740993", "0.000000000000000000001234",
           "123456789012345678901234567890123456789012",
           "1" + "0" * 60 + "e-60", "0." + "0" * 330 + "49"] + TIES
    while len(out) < n:
        nd = int(rng.integers(1, 46))
        digits = "".join(rng.choice(list("0123456789"), nd))
        dot = int(rng.integers(0, nd + 1))
        s = digits[:dot] + "." + digits[dot:] if rng.random() < 0.7 \
            else digits
        if rng.random() < 0.6:
            s += rng.choice(["e", "E"]) + rng.choice(["", "+", "-"]) + \
                str(int(rng.integers(0, 340)))
        if rng.random() < 0.4:
            s = rng.choice(["-", "+"]) + s
        if rng.random() < 0.05:
            s = " " + s + "\t"
        out.append(s)
    return out


def _string_vec(strs, w=None):
    raw = [s.encode() for s in strs]
    w = w or max(8, max(len(b) for b in raw))
    mat = np.zeros((len(raw), w), np.uint8)
    for i, b in enumerate(raw):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
    lens = np.array([len(b) for b in raw], np.int32)
    return mat, lens


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def test_float_parse_bit_identical_to_python_float():
    strs = _float_corpus()
    mat, lens = _string_vec(strs)
    v = Vec(T.STRING, torch.from_numpy(mat),
            torch.ones(len(strs), dtype=torch.bool), torch.from_numpy(lens))
    for dt, np_t in ((T.DOUBLE, np.float64), (T.FLOAT, np.float32)):
        out = PC._from_string(v, dt)
        assert out.validity.all()
        want = np.array([float(s) for s in strs]).astype(np_t)
        got = out.data.numpy()
        same = (_bits(got) == _bits(want)) | (np.isnan(got) &
                                              np.isnan(want))
        assert same.all(), [strs[i] for i in np.flatnonzero(~same)[:5]]


JAVA_FORMS = ["1.5d", "2D", "3.0f", "7F", "0x1p3", "-0x1.8p1", "1_000",
              "1e", "e5", "--1", "1.2.3", "-nan", "+Inf", "Infinity",
              "infinityx", "", " ", "1e+", ".", "+.e1", "0.5e-1.5"]


def test_float_parse_equals_jax_device_parse():
    """The JAX device parse (its jnp code run by numpy) on the corpus and on
    the forms only Java's parseDouble reads: the d/f suffixes and hex
    floats are null in both, where the JAX CPU engine and Spark read them
    (ROADMAP.md Queue C)."""
    strs = [s for s in _float_corpus(600, seed=12) if s not in TIES] + \
        JAVA_FORMS
    mat, lens = _string_vec(strs)
    n, w = mat.shape
    valid = np.ones(n, bool)
    j = np.arange(w)[None]
    content = (j < lens[:, None]) & (mat > 0x20)
    first = content.argmax(1).astype(np.int32)
    last = (w - 1 - content[:, ::-1].argmax(1)).astype(np.int32)
    v = Vec(T.STRING, torch.from_numpy(mat), torch.from_numpy(valid),
            torch.from_numpy(lens))
    for jt, pt in ((JT.DOUBLE, T.DOUBLE), (JT.FLOAT, T.FLOAT)):
        jo = JC._parse_float_device(np, JVec(JT.STRING, mat, valid, lens),
                                    first, last, content.any(1), jt)
        po = PC._from_string(v, pt)
        np.testing.assert_array_equal(po.validity.numpy(), jo.validity)
        ok = jo.validity
        np.testing.assert_array_equal(_bits(po.data.numpy())[ok],
                                      _bits(jo.data)[ok])
    tail = PC._from_string(v, T.DOUBLE).validity.numpy()[-len(JAVA_FORMS):]
    assert dict(zip(JAVA_FORMS, tail)) == {
        s: s in ("-nan", "+Inf", "Infinity") for s in JAVA_FORMS}


def test_ties_through_a_truncated_power_round_half_even():
    """The JAX parse multiplies by 10^E rounded down, so an exact tie
    written with a fraction lands below the halfway point and rounds
    down; the port rounds it half even, as float() and the JVM do
    (ROADMAP.md Queue C9)."""
    mat, lens = _string_vec(TIES)
    n, w = mat.shape
    valid = np.ones(n, bool)
    j = np.arange(w)[None]
    content = (j < lens[:, None]) & (mat > 0x20)
    jo = JC._parse_float_device(
        np, JVec(JT.STRING, mat, valid, lens),
        content.argmax(1).astype(np.int32),
        (w - 1 - content[:, ::-1].argmax(1)).astype(np.int32),
        content.any(1), JT.DOUBLE)
    po = PC._from_string(Vec(T.STRING, torch.from_numpy(mat),
                             torch.from_numpy(valid),
                             torch.from_numpy(lens)), T.DOUBLE)
    want = np.array([float(s) for s in TIES])
    np.testing.assert_array_equal(_bits(po.data.numpy()), _bits(want))
    # JAX: toward zero, which half even is for some of them
    assert (np.abs(jo.data) <= np.abs(want)).all()
    assert (np.abs(jo.data) < np.abs(want)).any()


def test_compose_float64_equals_jax():
    rng = np.random.default_rng(7)
    n = 4000
    mant = [int(rng.integers(0, 2 ** 62)) * int(rng.integers(1, 2 ** 62))
            % 10 ** int(rng.integers(1, 39)) for _ in range(n)]
    mant[:4] = [0, 1, 10 ** 38 - 1, 2 ** 127]
    e10 = rng.integers(-420, 340, n).astype(np.int32)
    mhi = np.array([m >> 64 for m in mant], np.uint64)
    mlo = np.array([m & (2 ** 64 - 1) for m in mant], np.uint64)
    sticky = rng.random(n) < 0.2
    neg = rng.random(n) < 0.5
    want = JF.compose_float64(np, mhi, mlo, sticky, e10, neg)
    got = PF.compose_float64(
        torch.from_numpy(mhi.view(np.int64)),
        torch.from_numpy(mlo.view(np.int64)), torch.from_numpy(sticky),
        torch.from_numpy(e10), torch.from_numpy(neg)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    small = np.array([m < 10 ** 37 for m in mant])
    d = rng.integers(0, 10, n)
    jh, jl = JF.mul10_add(np, mhi, mlo, d.astype(np.uint64))
    ph, pl = PF.mul10_add(torch.from_numpy(mhi.view(np.int64)),
                          torch.from_numpy(mlo.view(np.int64)),
                          torch.from_numpy(d))
    np.testing.assert_array_equal(ph.numpy()[small], jh.view(np.int64)[small])
    np.testing.assert_array_equal(pl.numpy()[small], jl.view(np.int64)[small])


# --- FLOAT/DOUBLE -> STRING on the host -------------------------------------

def _java_agrees(v: float, is_float: bool) -> bool:
    """Where JAX `_java_double_str` follows Java's rule: a double outside
    [1e-4, 1e-3) and [1e7, 1e16), or an integral value under 1e7 but
    -0.0 (JAX "0.0"), that needs more than one digit or is that digit
    exactly (Java prints 5e-324 as 4.9E-324, JAX as 5.0E-324)."""
    if not math.isfinite(v):
        return True
    if v == int(v) and abs(v) < 1e7:
        return math.copysign(1.0, v) > 0 or v != 0
    d = decimal.Decimal(repr(v))
    if len(d.as_tuple().digits) == 1 and d != decimal.Decimal(v):
        return False
    return not is_float and not (1e-4 <= abs(v) < 1e-3 or
                                 1e7 <= abs(v) < 1e16)


# Double.toString / Float.toString from JDK 19 on (the shortest digits;
# earlier JDKs print 123456789f as 1.23456792E8)
JAVA_STRINGS = {
    (1e7, False): "1.0E7", (12345678.9, False): "1.23456789E7",
    (1e-4, False): "1.0E-4", (-0.00012, False): "-1.2E-4",
    (123456789012.0, False): "1.23456789012E11", (1.1, True): "1.1",
    (1e-5, True): "1.0E-5", (123456789.0, True): "1.2345679E8",
    (0.1, True): "0.1", (3.4028234663852886e38, True): "3.4028235E38",
    (1.0E-45, True): "1.4E-45", (-0.0, False): "-0.0", (100.0, True): "100.0",
    (0.001, False): "0.001", (9999999.0, False): "9999999.0",
}


def test_float_to_string_on_the_host():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.normal(0, 1, 200) * 10.0 ** rng.integers(
        -12, 20, 200), [0.0, -0.0, np.inf, -np.inf, np.nan, 1e16, 5e-324,
                        1.7976931348623157e308, 0.001, 1234567.0]])
    t = pa.table({"i": pa.array(np.arange(len(x)), pa.int64()),
                  "x": pa.array(x), "f": pa.array(x.astype(np.float32))})
    for col, is_float in (("x", False), ("f", True)):
        got = TpuSession(BASE, device="cpu").from_arrow(t).select(
            "i", o=PE.Cast(PE.col(col), T.STRING)).collect().sort_by("i") \
            .column("o").to_pylist()
        vals = t.column(col).to_pylist()
        for v, s in zip(vals, got):
            assert s == PC.java_float_str(v, is_float)
            if _java_agrees(v, is_float):
                assert s == JC._java_double_str(v, is_float), (v, s)
            if math.isfinite(v):  # the shortest digits read back
                back = np.float32(float(s)) if is_float else float(s)
                assert struct.pack("<d", float(back)) == \
                    struct.pack("<d", float(np.float32(v) if is_float
                                            else v)), (v, s)
    for (v, is_float), want in JAVA_STRINGS.items():
        assert PC.java_float_str(v, is_float) == want, (v, want)


def _bang(conf, make, t):
    """The `!` lines of both engines' explain for one query."""
    conf = dict(conf, **{"spark.rapids.sql.explain": "NOT_ON_GPU"})
    jov = JaxOverrides(JaxConf(conf))
    jov.apply(make(JaxSession(conf), JE, JT, t).plan)
    pov = Overrides(TpuConf(conf), torch.device("cpu"))
    pov.apply(make(TpuSession(conf, device="cpu"), PE, T, t).plan)
    return ([ln.strip() for ln in jov.explain_string().splitlines()
             if "!" in ln],
            [ln.strip() for ln in pov.explain_string().splitlines()
             if "!" in ln])


TAGS = {  # query: (conf, the column, the target type name)
    "double_to_string": (BASE, "x", "STRING"),
    "float_to_string": (BASE, "f", "STRING"),
    "string_to_long_ansi": (ANSI, "s", "LONG"),
    "string_to_double_ansi": (ANSI, "s", "DOUBLE"),
    "string_to_date_ansi": (ANSI, "s", "DATE"),
    "string_to_boolean_ansi": (ANSI, "s", "BOOLEAN"),
    "long_to_string_ansi": (ANSI, "k", "STRING"),
    "date_to_string_ansi": (ANSI, "d", "STRING"),
    "date_to_string": (BASE, "d", "STRING"),
    "long_to_string": (BASE, "k", "STRING"),
}


@pytest.mark.parametrize("case", list(TAGS))
def test_explain_tags_match_jax(case):
    conf, col, to = TAGS[case]
    t = pa.table({"s": ["1", "2"], "x": [1.5, 2.0], "k": [1, 2],
                  "d": pa.array([1, 2], pa.date32()),
                  "f": pa.array([1.5, 2.0], pa.float32())})
    jl, pl = _bang(conf, lambda s, m, tp, tb: s.from_arrow(tb).select(
        o=m.Cast(m.col(col), getattr(tp, to))), t)
    assert pl == jl
    assert bool(jl) == (case in ("double_to_string", "float_to_string",
                                 "long_to_string_ansi",
                                 "date_to_string_ansi")), jl


C5 = {  # case: (column, target, the port's values by Spark's rule)
    "string_to_decimal": ("s", "decimal(7,2)",
                          [decimal.Decimal("12.34"),
                           decimal.Decimal("1234.00")]),
    "string_to_timestamp": ("t", "timestamp", [984268800000000,
                                               -23225875200000000]),
    "decimal_to_string": ("dec", "string", ["0.01", "12.30"]),
    "timestamp_to_string": ("ts", "string", ["1970-01-01 00:00:00",
                                             "1969-12-31 23:59:59.5"]),
}


@pytest.mark.parametrize("case", list(C5))
def test_c5_casts_follow_spark(case):
    """The four casts the JAX device rule refuses run on the port's host
    engine with the JAX tag's reason, by Spark's rule: '12.34' and ' 1234 '
    are 12.34 and 1234.00 in decimal(7,2) (the JAX CPU engine: null and
    12.34); '2001-03-11' is its midnight and '1234' the year 1234 (JAX:
    null and 1234 us); a decimal keeps its scale and a timestamp drops its
    fraction's trailing zeros as text (JAX: a TypeError). The full
    grammars are tests/test_torch_timestamp_casts.py's."""
    src, to, want = C5[case]
    t = pa.table({"s": ["12.34", " 1234 "], "t": ["2001-03-11", "1234"],
                  "dec": pa.array([decimal.Decimal("0.01"),
                                   decimal.Decimal("12.30")],
                                  pa.decimal128(9, 2)),
                  "ts": pa.array([0, -500_000],
                                 pa.timestamp("us", tz="UTC"))})
    jl, pl = _bang(BASE, lambda sess, m, tp, tb: sess.from_arrow(tb).select(
        o=m.Cast(m.col(src), tp.parse_type(to))), t)
    assert pl == jl and len(pl) == 1, (jl, pl)
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.Cast(PE.col(src), T.parse_type(to)))
    for got in (q.collect(), q.collect_cpu()):
        col = got.column("o")
        if to == "timestamp":
            col = col.cast(pa.int64())
        assert col.to_pylist() == want


@pytest.mark.parametrize("to", ["INT", "DOUBLE", "BOOLEAN", "DATE"])
def test_ansi_parse_error_matches_jax(to):
    """A malformed string raises `[CAST_INVALID_INPUT]` with the JAX
    message on both plans; a null string and good text do not."""
    good = {"INT": "12", "DOUBLE": "1.5", "BOOLEAN": "yes",
            "DATE": "2001-03-11"}[to]
    bad = pa.table({"s": [good, None, "n/a"]})
    want = None
    try:
        JaxSession(ANSI).from_arrow(bad).select(
            o=JE.Cast(JE.col("s"), getattr(JT, to))).collect_cpu()
    except Exception as e:  # noqa: BLE001 -- its message is compared
        want = str(e)
    assert want == ("[CAST_INVALID_INPUT] value cannot be cast to "
                    f"{getattr(T, to).simple_string()}")
    for mesh in ({}, {"spark.rapids.shuffle.mode": "ICI",
                      "spark.rapids.tpu.mesh.shape": "shuffle=4",
                      "spark.rapids.tpu.fusion.enabled": True}):
        sess = TpuSession(dict(ANSI, **mesh), device="cpu")
        with pytest.raises(AnsiViolation) as err:
            sess.from_arrow(bad).select(
                o=PE.Cast(PE.col("s"), getattr(T, to))).collect()
        assert str(err.value) == want
        ok = sess.from_arrow(bad.slice(0, 2)).select(
            o=PE.Cast(PE.col("s"), getattr(T, to))).collect()
        plain = TpuSession(BASE, device="cpu").from_arrow(
            bad.slice(0, 2)).select(
            o=PE.Cast(PE.col("s"), getattr(T, to))).collect()
        assert ok.equals(plain)
