"""The port's math and bitwise expressions (`expr/math_.py`,
`expr/bitwise.py`) against the JAX package on the CPU.

Seeded doubles and floats with NaN, the infinities, both zeros, the
domain edges (0, -1, 1) and values past the LONG range; integers of every
width, with shift amounts past the masks and negative.

Tolerances:
  * exact: sqrt (numpy's on the host), signum, rint, degrees/radians,
    floor, ceil, round, bround, every bitwise op and every null, against
    the JAX CPU engine's numpy;
  * the transcendentals (exp, the logs, the trigonometric and hyperbolic
    functions, cbrt, pow, atan2, hypot, expm1, log1p, cot): within 4 ULP
    of the JAX CPU engine's numpy (glibc) on every row, and rtol 1e-13
    of the JAX device path, whose XLA cbrt, log10, sinh and cosh are
    further off (cbrt(1e300) 1.3e-14 relative, sinh(710) 5.5e-14);
  * against the JAX device path, round and bround of a double at a
    nonzero scale rtol 2.3e-16 (1 ULP): XLA divides by 10^d as a product
    with the reciprocal (numpy and torch divide); the device path is not
    compared on rows with a subnormal input or result, which XLA's CPU
    flushes to 0 (JVM doubles keep them: ceil(4.9E-324) is 1, exp(-710.3)
    3.3E-309), nor on rounds of a LONG
    at a negative scale (the reciprocal's product moves them by
    thousands);
  * Floor and Ceil of a double: the JAX device path and an oracle of
    Java's `(long)` rule exactly; the JAX CPU engine's INT64_MIN for NaN,
    the infinities and values past the LONG range is a known difference,
    asserted as such.
Round and BRound over a decimal are refused at plan time (the JAX engine
rounds the unscaled value and keeps the type: round(12.34, 0) is 12.34
as decimal(7,2), where Spark gives 12 as decimal(6,0))."""

import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.expr import bitwise as JB
from spark_rapids_tpu.expr import math_ as JM
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
ANSI = dict(BASE, **{"spark.sql.ansi.enabled": True})
SPECIAL = [math.nan, math.inf, -math.inf, 0.0, -0.0, 1.0, -1.0, 0.5, -0.5,
           1.5, -2.5, 2.675, 1e-300, 5e-324, 1e300, -1e19, 9.3e18,
           9.2233720368547758e18, -9.2233720368547758e18, 27.0, -8.0,
           1e10, 0.1, -1e-7, 710.0, -710.3, 709.9]
N = 128


def _table(n=N, seed=67):
    rng = np.random.default_rng(seed)
    x = np.concatenate([SPECIAL, rng.normal(0, 50, n - len(SPECIAL))])
    x[len(SPECIAL):][::7] = rng.uniform(-1.0, 1.0, len(x[len(SPECIAL)::7]))
    y = rng.permutation(x)
    valid = rng.random(n) >= 0.06
    l = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    l[:6] = [0, -1, 2 ** 63 - 1, -2 ** 63, 1, 1 << 40]
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "x": pa.array(x, mask=~valid), "y": pa.array(y),
        "f": pa.array(x.astype(np.float32)),
        "l": pa.array(l), "l2": pa.array(rng.permutation(l)),
        "n": pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                      mask=~valid),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        "b": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "amt": pa.array(rng.integers(-70, 140, n).astype(np.int32)),
    })


@pytest.fixture(scope="module")
def table():
    return _table()


UNARY = ("Sqrt", "Exp", "Log", "Log10", "Log2", "Sin", "Cos", "Tan", "Asin",
         "Acos", "Atan", "Sinh", "Cosh", "Tanh", "Cbrt", "ToDegrees",
         "ToRadians", "Signum", "Expm1", "Log1p", "Rint", "Cot")
EXACT = ("Sqrt", "Signum", "Rint", "ToDegrees", "ToRadians", "Floor", "Ceil",
         "Round", "BRound")
BINARY = ("Pow", "Atan2", "Hypot", "Logarithm")


def _run(table, make_jax, make_port, conf=BASE):
    """(JAX collect(), JAX collect_cpu(), port device plan, port host
    engine), each sorted by i."""
    jq = JaxSession(conf).from_arrow(table).select("i", o=make_jax())
    pq = TpuSession(conf, device="cpu").from_arrow(table).select(
        "i", o=make_port())
    assert "Cpu" not in pq.explain()
    return [t.sort_by("i") for t in (jq.collect(), JaxSession(conf)
                                     .from_arrow(table).select(
                                         "i", o=make_jax()).collect_cpu(),
                                     pq.collect(), pq.collect_cpu())]


def _values(t):
    col = t.column("o")
    return col.to_numpy(zero_copy_only=False), np.asarray(col.is_null())


def _normal_rows(table, cols):
    """Rows whose inputs are not subnormal doubles (XLA's CPU flushes
    those to zero)."""
    ok = np.ones(table.num_rows, bool)
    for c in cols:
        v = table.column(c).to_numpy(zero_copy_only=False)
        if v.dtype.kind == "f":
            v = v.astype(np.float64)
            ok &= ~((v != 0) & (np.abs(v) < np.finfo(np.float64).tiny))
    return ok


def _within_ulps(got, want, ulps):
    both = np.isfinite(want) & np.isfinite(got)
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    close = both & (np.abs(got - want) <= ulps * np.spacing(np.abs(want)))
    return bool(np.all(same | close))


@pytest.mark.parametrize("name", UNARY + BINARY)
def test_double_functions_match_jax(table, name):
    if name in BINARY:
        args = ("x", "y")
    else:
        args = ("x",)
    jax_dev, jax_cpu, dev, host = _run(
        table, lambda: getattr(JM, name)(*map(JE.col, args)),
        lambda: getattr(PE, name)(*map(PE.col, args)))
    want, want_null = _values(jax_cpu)
    ref, ref_null = _values(jax_dev)
    normal = _normal_rows(table, args) & ~(
        (want != 0) & (np.abs(want) < np.finfo(np.float64).tiny))
    for got_t in (dev, host):
        got, null = _values(got_t)
        assert np.array_equal(null, want_null), name
        assert np.array_equal(null[normal], ref_null[normal]), name
        live = ~null & normal
        if name in EXACT:
            assert np.array_equal(got, want, equal_nan=True), name
            assert np.array_equal(got[live], ref[live], equal_nan=True), name
        else:
            assert _within_ulps(got[~null], want[~null], 4), name
            assert np.allclose(got[live], ref[live], rtol=1e-13, atol=0,
                               equal_nan=True), name


def java_long(v: float) -> int:
    """Java's `(long) v`."""
    if math.isnan(v):
        return 0
    if v >= 2.0 ** 63:
        return 2 ** 63 - 1
    if v < -2.0 ** 63:
        return -2 ** 63
    return int(v)


@pytest.mark.parametrize("name", ["Floor", "Ceil"])
@pytest.mark.parametrize("col", ["x", "f", "n", "l"])
def test_floor_ceil(table, name, col):
    jax_dev, jax_cpu, dev, host = _run(
        table, lambda: getattr(JM, name)(JE.col(col)),
        lambda: getattr(PE, name)(PE.col(col)))
    normal = _normal_rows(table, [col])
    for got in (dev, host):
        assert got.filter(pa.array(normal)).equals(
            jax_dev.filter(pa.array(normal))), (name, col)
    if col in ("n", "l"):
        assert dev.equals(jax_cpu) and host.equals(jax_dev)
        return
    src = table.column(col).to_numpy(zero_copy_only=False).astype(np.float64)
    fn = math.floor if name == "Floor" else math.ceil
    oracle = [None if v is None else
              java_long(fn(s) if math.isfinite(s) else s)
              for s, v in zip(src, table.column(col).to_pylist())]
    assert dev.column("o").to_pylist() == oracle
    assert host.column("o").to_pylist() == oracle
    # the JAX CPU engine departs from Java where the double is NaN, an
    # infinity or past the LONG range (ROADMAP.md "Known differences"):
    # INT64_MIN, x86's answer to an invalid conversion
    differ = [i for i, (a, b) in enumerate(zip(
        jax_cpu.column("o").to_pylist(), oracle)) if a != b]
    assert differ and all(not abs(src[i]) < 2.0 ** 63 for i in differ)
    assert all(jax_cpu.column("o")[i].as_py() == -2 ** 63 for i in differ)


@pytest.mark.parametrize("name", ["Round", "BRound"])
@pytest.mark.parametrize("col,scale", [("x", 0), ("x", 2), ("x", -1),
                                       ("f", 1), ("n", 0), ("n", -2),
                                       ("l", -3), ("h", 1)])
def test_round_matches_jax(table, name, col, scale):
    jax_dev, jax_cpu, dev, host = _run(
        table, lambda: getattr(JM, name)(JE.col(col), scale),
        lambda: getattr(PE, name)(PE.col(col), scale))
    normal = _normal_rows(table, [col])
    float_col = col in ("x", "f")
    for got in (dev, host):
        a, an = _values(got)
        b, bn = _values(jax_cpu)
        assert np.array_equal(an, bn)
        same = (a == b) | (np.isnan(a) & np.isnan(b)) | an
        # a LONG rounded past its range: Java's (long) clamps, numpy's
        # cast gives x86's INT64_MIN
        assert np.all(same | (~an & (b == -2 ** 63)
                              & (np.abs(a) == 2 ** 63 - 1))), (name, col)
        if col == "l":
            continue
        c, cn = _values(jax_dev)
        live = ~an & normal
        if float_col:
            assert np.allclose(a[live], c[live], rtol=2.3e-16, atol=0,
                               equal_nan=True), (name, col, scale)
        else:
            assert np.array_equal(a[~an], c[~an]), (name, col, scale)


def test_round_half_up_and_half_even():
    t = pa.table({"x": [0.5, 1.5, 2.5, -0.5, -2.5, 0.125, 1.005]})
    out = TpuSession(BASE, device="cpu").from_arrow(t).select(
        r=PE.Round(PE.col("x"), 0), b=PE.BRound(PE.col("x"), 0),
        r2=PE.Round(PE.col("x"), 2), b2=PE.BRound(PE.col("x"), 2)).collect()
    assert out.column("r").to_pylist()[:5] == [1.0, 2.0, 3.0, -1.0, -3.0]
    assert out.column("b").to_pylist()[:5] == [0.0, 2.0, 2.0, -0.0, -2.0]
    assert out.column("r2").to_pylist()[5] == 0.13
    assert out.column("b2").to_pylist()[5] == 0.12


BITWISE = [("BitwiseAnd", "l", "n"), ("BitwiseOr", "n", "h"),
           ("BitwiseXor", "l", "l2"), ("BitwiseAnd", "b", "h"),
           ("BitwiseNot", "l", None), ("BitwiseNot", "b", None)] + [
    (s, c, "amt") for s in ("ShiftLeft", "ShiftRight", "ShiftRightUnsigned")
    for c in ("l", "n", "h", "b")]


@pytest.mark.parametrize("name,a,b", BITWISE)
def test_bitwise_matches_jax(table, name, a, b):
    cols = (a,) if b is None else (a, b)
    jax_dev, jax_cpu, dev, host = _run(
        table, lambda: getattr(JB, name)(*map(JE.col, cols)),
        lambda: getattr(PE, name)(*map(PE.col, cols)))
    for got in (dev, host):
        assert got.equals(jax_dev) and got.equals(jax_cpu), (name, a, b)


def test_shift_masks_follow_java():
    """Java masks the amount: 1 << 65 is 2 for a LONG, 1 << 33 is 2 for
    an INT; -1 >>> 60 is 15 for a LONG and -1 >>> 28 is 15 for an INT;
    >>> 0 is the value."""
    t = pa.table({"l": pa.array([1, 1, -1, -1, -8], pa.int64()),
                  "n": pa.array([1, 1, -1, -1, -8], pa.int32()),
                  "s": pa.array([65, 33, 60, 28, 0], pa.int32())})
    out = TpuSession(BASE, device="cpu").from_arrow(t).select(
        ll=PE.ShiftLeft(PE.col("l"), PE.col("s")),
        nl=PE.ShiftLeft(PE.col("n"), PE.col("s")),
        lu=PE.ShiftRightUnsigned(PE.col("l"), PE.col("s")),
        nu=PE.ShiftRightUnsigned(PE.col("n"), PE.col("s"))).collect()
    assert out.column("ll").to_pylist() == [2, 2 ** 33, -2 ** 60, -2 ** 28,
                                            -8]
    assert out.column("nl").to_pylist() == [2, 2, -2 ** 28, -2 ** 28, -8]
    assert out.column("lu").to_pylist() == [0, 0, 15, 2 ** 36 - 1, -8]
    assert out.column("nu").to_pylist() == [0, 0, 2 ** 4 - 1, 15, -8]


def test_bitwise_under_ansi_raises_nothing(table):
    q = TpuSession(ANSI, device="cpu").from_arrow(table).select(
        "i", o=PE.BitwiseXor(PE.col("l"), PE.col("l2")),
        p=PE.ShiftLeft(PE.col("l"), PE.col("amt")))
    plain = TpuSession(BASE, device="cpu").from_arrow(table).select(
        "i", o=PE.BitwiseXor(PE.col("l"), PE.col("l2")),
        p=PE.ShiftLeft(PE.col("l"), PE.col("amt")))
    assert q.collect().equals(plain.collect())


@pytest.mark.parametrize("name", ["Round", "BRound", "Floor", "Sqrt"])
def test_decimal_operand_refused(name):
    """The JAX engine reads a decimal's unscaled value: round(12.34, 0)
    over decimal(7,2) is 12.34 typed decimal(7,2) in both its engines
    (Spark: 12, decimal(6,0)). The port refuses it at plan time (ROADMAP.md
    "Port-only refusals", Queue C)."""
    t = pa.table({"d": pa.array([decimal.Decimal("12.34")],
                                pa.decimal128(7, 2))})
    if name == "Round":
        from spark_rapids_tpu import types as JT
        got = JaxSession(BASE).from_arrow(t).select(
            o=JM.Round(JE.col("d"), 0)).collect_cpu()
        assert got.column("o").type == pa.decimal128(7, 2)
        assert got.column("o").to_pylist() == [decimal.Decimal("12.34")]
        assert JT.DecimalType(7, 2).simple_string() == "decimal(7,2)"
    args = (PE.col("d"), 0) if name in ("Round", "BRound") else (PE.col("d"),)
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=getattr(PE, name)(*args))
    with pytest.raises(NotImplementedError, match=f"{name} over decimal"):
        q.explain()


def _bang(conf, make_j, make_p, t):
    conf = dict(conf, **{"spark.rapids.sql.explain": "NOT_ON_GPU"})
    jov = JaxOverrides(JaxConf(conf))
    jov.apply(JaxSession(conf).from_arrow(t).select(o=make_j()).plan)
    pov = Overrides(TpuConf(conf), torch.device("cpu"))
    pov.apply(TpuSession(conf, device="cpu").from_arrow(t).select(
        o=make_p()).plan)
    return ([ln.strip() for ln in jov.explain_string().splitlines()
             if "!" in ln],
            [ln.strip() for ln in pov.explain_string().splitlines()
             if "!" in ln])


@pytest.mark.parametrize("conf,name", [
    ({"spark.rapids.sql.incompatibleOps.enabled": False}, "Exp"),
    ({"spark.rapids.sql.incompatibleOps.enabled": False}, "Sqrt"),
    ({"spark.rapids.sql.incompatibleOps.enabled": False}, "Floor"),
    ({"spark.rapids.sql.expression.ShiftLeft": False}, "ShiftLeft"),
    ({"spark.rapids.sql.expression.Round": False}, "Round")])
def test_explain_tags_match_jax(table, conf, name):
    args = {"ShiftLeft": ("l", "amt")}.get(name, ("x",))
    jl, pl = _bang(dict(BASE, **conf),
                   lambda: getattr(JM if name != "ShiftLeft" else JB, name)(
                       *map(JE.col, args)),
                   lambda: getattr(PE, name)(*map(PE.col, args)), table)
    assert pl == jl, (jl, pl)
    assert bool(pl) == (name != "Floor")
