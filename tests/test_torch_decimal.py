"""The 64-bit decimal, FLOAT, BYTE/SHORT and TIMESTAMP types of
spark_rapids_tpu_torch against the JAX package on the CPU: column round
trips, expressions (decimal +/- at the precision bounds, comparisons across
scales, casts, murmur3, arithmetic), aggregates, joins and the plan-time
boundary.

Expressions run in both engines on the same numpy-seeded buffers (the JAX
side on jax.numpy, eagerly); queries run through both sessions.

Tolerances: exact everywhere (values and validity, decimals as their
unscaled ints, hashes bit for bit), except FLOAT and DOUBLE sums, held to
rtol 1e-12 because the engines may add in another order. Where the JAX
engine is wrong (Spark's rule differs) the port is held to an exact oracle
of Spark's rule instead, and one case asserts that the JAX engine differs:
Average over a decimal (Python `decimal`, HALF_UP at scale s + 4), Divide
with a decimal operand (the quotient of the values, to 1 ulp), Pmod with a
negative divisor, and MIN/MAX over NaN (Spark's order: NaN greatest)."""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.columnar import batch_to_arrow as jax_batch_to_arrow
from spark_rapids_tpu.expr import arithmetic as JA
from spark_rapids_tpu.expr import cast as JC
from spark_rapids_tpu.expr import predicates as JP
from spark_rapids_tpu.expr.base import BoundReference as JBound, \
    EvalContext as JCtx, Vec as JVec
from spark_rapids_tpu.expr.hashing import hash_vecs as jax_hash_vecs
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow, \
    batch_to_arrow
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import cast as C
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr.base import BoundReference, EvalContext, Vec
from spark_rapids_tpu_torch.expr.hashing import hash_vecs
from spark_rapids_tpu_torch.plugin import TpuSession
from torch_port import port_batch, positional

N = 256  # one shape for every expression test: the JAX side compiles once
FU = "spark.rapids.tpu.fusion.enabled"
BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 512}
D = decimal.Decimal


def dec_array(unscaled, p, s, valid=None):
    """int64 unscaled values -> Arrow decimal128(p, s), through Python
    Decimals (independent of both engines' vectorised conversions)."""
    valid = np.ones(len(unscaled), bool) if valid is None else valid
    return pa.array([D(int(u)).scaleb(-s) if ok else None
                     for u, ok in zip(unscaled, valid)], pa.decimal128(p, s))


def _both(type_str, data, valid):
    dt = T.parse_type(type_str)
    return ((JT.parse_type(type_str), dt),
            (np.asarray(data, dt.np_dtype), np.asarray(valid, bool)))


def evaluate(make, args):
    """make(engine_module, [bound refs]) -> an expression of either engine;
    args: [(type string, data, valid)]. Returns ((JAX data, validity),
    (port data, validity)) as numpy arrays."""
    jrefs, prefs, jvecs, pvecs = [], [], [], []
    for i, (ts, data, valid) in enumerate(args):
        (jt, pt), (d, v) = _both(ts, data, valid)
        jrefs.append(JBound(i, jt))
        prefs.append(BoundReference(i, pt))
        jvecs.append(JVec(jt, jnp.asarray(d), jnp.asarray(v)))
        pvecs.append(Vec(pt, torch.from_numpy(d.copy()),
                         torch.from_numpy(v.copy())))
    n = len(args[0][1])
    jout = make("jax", jrefs).eval(JCtx(jnp, row_mask=jnp.ones(n, bool)),
                                   jvecs)
    pout = make("port", prefs).eval(EvalContext(torch.ones(n, dtype=bool)),
                                    pvecs)
    return ((np.asarray(jout.data), np.asarray(jout.validity)),
            (pout.data.numpy(), pout.validity.numpy()))


def assert_same(jax_out, port_out, rtol=None):
    (jd, jv), (pd, pv) = jax_out, port_out
    np.testing.assert_array_equal(pv, jv)
    if rtol is None:
        np.testing.assert_array_equal(pd[pv], jd[jv])
    else:
        np.testing.assert_allclose(pd[pv], jd[jv], rtol=rtol)


def same_column(a, b) -> bool:
    """Arrow equality with NaN equal to NaN (Arrow's equals is not)."""
    if a.type != b.type or not a.is_null().equals(b.is_null()):
        return False
    if pa.types.is_floating(a.type):
        return np.array_equal(a.drop_null().to_numpy(),
                              b.drop_null().to_numpy(), equal_nan=True)
    return a.equals(b)


def _unscaled(rng, p, n=N, edge=True):
    """Random unscaled values of a decimal(p, _), with both bounds
    +-(10^p - 1) and 0 among them when `edge`."""
    lim = 10 ** p
    u = rng.integers(-lim + 1, lim, n)
    if edge:
        u[:4] = [lim - 1, -(lim - 1), 0, 1]
    return u


# --------------------------------------------------------------------------
ROUND_TRIP = {
    "decimal(7,2)": lambda rng, n: dec_array(_unscaled(rng, 7, n), 7, 2,
                                             rng.random(n) > 0.2),
    "decimal(18,4)": lambda rng, n: dec_array(_unscaled(rng, 18, n), 18, 4,
                                              rng.random(n) > 0.2),
    "float": lambda rng, n: pa.array(
        np.r_[np.nan, -0.0, np.inf, rng.normal(0, 1e3, n - 3)]
        .astype(np.float32), mask=rng.random(n) < 0.2),
    "byte": lambda rng, n: pa.array(rng.integers(-128, 128, n)
                                    .astype(np.int8), mask=rng.random(n) < .2),
    "short": lambda rng, n: pa.array(rng.integers(-2 ** 15, 2 ** 15, n)
                                     .astype(np.int16),
                                     mask=rng.random(n) < 0.2),
    "timestamp": lambda rng, n: pa.array(
        rng.integers(-10 ** 15, 10 ** 15, n), pa.timestamp("us"),
        mask=rng.random(n) < 0.2),
}


class TestColumns:
    @pytest.mark.parametrize("kind", sorted(ROUND_TRIP))
    def test_arrow_round_trip_matches_jax(self, kind):
        """Arrow -> device -> Arrow: the same buffers as the JAX package
        (its per-row Decimal conversion against the vectorised one) and
        the same table back, nulls included."""
        rng = np.random.default_rng(1)
        t = pa.table({"x": ROUND_TRIP[kind](rng, 300)})
        jb = jax_batch_from_arrow(t)
        pb = batch_from_arrow(t, torch.device("cpu"))
        assert pb.schema.types[0] == T.parse_type(kind)
        valid = np.asarray(jb.columns[0].validity)
        np.testing.assert_array_equal(pb.columns[0].validity.numpy(), valid)
        np.testing.assert_array_equal(
            pb.columns[0].data.numpy()[valid],
            np.asarray(jb.columns[0].data)[valid])
        back = batch_to_arrow(pb).column("x")
        assert same_column(back, jax_batch_to_arrow(jb).column("x"))
        want = t.column("x")
        if kind == "timestamp":  # the engines return UTC microseconds
            want = want.cast(pa.timestamp("us", tz="UTC"))
        assert same_column(back, want)

    def test_timestamp_units_convert_to_microseconds(self):
        ns = np.array([1_999, -1, 0, 1_000_000], np.int64)
        t = pa.table({"ms": pa.array(ns, pa.timestamp("ms")),
                      "ns": pa.array(ns, pa.timestamp("ns")),
                      "s": pa.array(ns, pa.timestamp("s"))})
        b = batch_from_arrow(t, torch.device("cpu"))
        got = [c.data[:4].tolist() for c in b.columns]
        assert got == [(ns * 1000).tolist(), (ns // 1000).tolist(),
                       (ns * 1_000_000).tolist()]

    def test_jax_batch_rebuilds_in_the_port(self):
        """interop.batch_from_numpy takes the JAX batch's padded buffers of
        every new type unchanged."""
        rng = np.random.default_rng(2)
        t = pa.table({k: f(rng, 100) for k, f in sorted(ROUND_TRIP.items())})
        jb = jax_batch_from_arrow(t)
        got, want = batch_to_arrow(port_batch(jb)), jax_batch_to_arrow(jb)
        assert got.schema == want.schema
        for name in want.column_names:
            assert same_column(got.column(name), want.column(name)), name


# --------------------------------------------------------------------------
# (the result of each pair has at most 18 digits: the planner's limit)
DEC_PAIRS = [("decimal(7,2)", "decimal(7,2)"),
             ("decimal(9,2)", "decimal(5,4)"),
             ("decimal(16,0)", "decimal(1,1)"),
             ("decimal(3,0)", "decimal(14,14)")]


class TestExpressions:
    @pytest.mark.parametrize("op", ["Add", "Subtract"])
    @pytest.mark.parametrize("pair", DEC_PAIRS, ids=lambda p: "_".join(p))
    def test_decimal_add_subtract_at_the_bounds(self, pair, op):
        """Both operands at +-(10^p - 1), random, and on row 4 a left
        operand past its precision (a buffer may hold one) that rescales
        to exactly 10^P, P the result precision: a result past P is null
        in both engines."""
        rng = np.random.default_rng(3)
        lt, rt = (T.parse_type(ts) for ts in pair)
        out_t = T.DecimalType(max(lt.precision - lt.scale,
                                  rt.precision - rt.scale)
                              + max(lt.scale, rt.scale) + 1,
                              max(lt.scale, rt.scale))
        args = []
        for dt, ts in zip((lt, rt), pair):
            args.append((ts, _unscaled(rng, dt.precision),
                         rng.random(N) > 0.1))
        args[0][1][4] = 10 ** (out_t.precision - out_t.scale + lt.scale)
        args[1][1][4] = 0
        args[0][2][4] = args[1][2][4] = True
        out = evaluate(lambda m, r: getattr(JA if m == "jax" else A, op)(*r),
                       args)
        assert_same(*out)
        assert not out[1][1][4]  # past the result precision: null

    @pytest.mark.parametrize("pair", [("decimal(18,0)", "decimal(18,18)"),
                                      ("decimal(7,2)", "decimal(9,4)"),
                                      ("decimal(7,2)", "decimal(7,2)")],
                             ids=lambda p: "_".join(p))
    def test_decimal_comparisons_across_scales(self, pair):
        rng = np.random.default_rng(4)
        (lt, ls), (rt, rs) = [(t, T.parse_type(t).scale) for t in pair]
        lu = _unscaled(rng, T.parse_type(lt).precision)
        ru = _unscaled(rng, T.parse_type(rt).precision)
        # equal values across the scales on every fourth row
        shift = rs - ls
        eq = np.arange(N) % 4 == 0
        if shift >= 0:
            lu[eq] = lu[eq] // 10 ** (T.parse_type(lt).precision - 1)
            ru[eq] = lu[eq] * 10 ** shift
        valid = rng.random(N) > 0.1
        for name in ("EqualTo", "LessThan", "LessThanOrEqual", "GreaterThan",
                     "GreaterThanOrEqual"):
            out = evaluate(lambda m, r: getattr(JP if m == "jax" else P,
                                                name)(*r),
                           [(lt, lu, valid), (rt, ru, np.ones(N, bool))])
            assert_same(*out)

    CASTS = [("decimal(7,2)", "decimal(9,4)"),
             ("decimal(9,4)", "decimal(7,2)"),
             ("decimal(18,2)", "decimal(5,0)"), ("decimal(7,2)", "integer"),
             ("decimal(18,0)", "byte"), ("decimal(7,2)", "double"),
             ("decimal(7,2)", "float"), ("decimal(7,2)", "boolean"),
             ("long", "decimal(18,0)"), ("integer", "decimal(7,2)"),
             ("short", "decimal(3,0)"), ("double", "long"), ("double", "byte"),
             ("float", "integer"), ("double", "float"), ("long", "short"),
             ("integer", "byte"), ("byte", "double"), ("short", "long"),
             ("boolean", "short"), ("float", "boolean"), ("long", "timestamp"),
             ("timestamp", "long"), ("timestamp", "date"),
             ("date", "timestamp")]

    @pytest.mark.parametrize("pair", CASTS, ids=lambda p: "_to_".join(p))
    def test_numeric_casts_match_jax(self, pair):
        src, dst = pair
        rng = np.random.default_rng(5)
        st = T.parse_type(src)
        if isinstance(st, T.DecimalType):
            data = _unscaled(rng, st.precision)
        elif T.is_floating(st):
            data = np.r_[np.nan, np.inf, -np.inf, -0.0, 3e9, -3e9, 2.0 ** 63,
                         -2.0 ** 63, rng.normal(0, 1e4, N - 8)]
        elif isinstance(st, T.BooleanType):
            data = rng.random(N) > 0.5
        elif isinstance(st, T.DateType):
            data = rng.integers(-100_000, 100_000, N)
        else:
            info = np.iinfo(st.np_dtype)
            data = rng.integers(info.min, info.max, N, endpoint=True)
            data[:2] = [info.min, info.max]
            if isinstance(st, T.TimestampType):
                data = rng.integers(-10 ** 15, 10 ** 15, N)
            if dst == "timestamp":
                data = rng.integers(-10 ** 12, 10 ** 12, N)
        dt = T.parse_type(dst)
        out = evaluate(lambda m, r: (JC.Cast(r[0], JT.parse_type(dst))
                                     if m == "jax" else C.Cast(r[0], dt)),
                       [(src, data, rng.random(N) > 0.1)])
        assert_same(*out)

    @pytest.mark.parametrize("kind", ["byte", "short", "float", "timestamp",
                                      "decimal(7,2)", "decimal(18,2)"])
    def test_murmur3_matches_jax(self, kind):
        """Bit for bit: BYTE/SHORT as int, TIMESTAMP and decimals as long,
        FLOAT by its bits with -0.0 as 0.0 (and NaN, numpy's canonical)."""
        rng = np.random.default_rng(6)
        dt = T.parse_type(kind)
        if isinstance(dt, T.DecimalType):
            data = _unscaled(rng, dt.precision)
        elif isinstance(dt, T.FloatType):
            data = np.r_[np.float32(np.nan), -0.0, 0.0, np.inf,
                         rng.normal(0, 1e3, N - 4)].astype(np.float32)
        elif isinstance(dt, T.TimestampType):
            data = rng.integers(-10 ** 15, 10 ** 15, N)
        else:
            info = np.iinfo(dt.np_dtype)
            data = rng.integers(info.min, info.max, N, endpoint=True)
        (jt, pt), (d, v) = _both(kind, data, rng.random(N) > 0.1)
        jh = np.asarray(jax_hash_vecs(jnp, [JVec(jt, jnp.asarray(d),
                                                 jnp.asarray(v))]))
        ph = hash_vecs([Vec(pt, torch.from_numpy(d), torch.from_numpy(v))])
        np.testing.assert_array_equal(ph.numpy().view(np.uint32),
                                      jh.astype(np.uint32))
        if kind == "float":  # -0.0 hashes as 0.0
            assert ph[1] == ph[2] or not (v[1] and v[2])

    @pytest.mark.parametrize("op", ["IntegralDivide", "Remainder", "Divide",
                                    "Pmod_float"])
    @pytest.mark.parametrize("types", [("long", "long"),
                                       ("integer", "byte"),
                                       ("short", "short"),
                                       ("double", "float")],
                             ids=lambda t: "_".join(t))
    def test_division_family_matches_jax(self, op, types):
        """Java truncation, x / 0 -> null, MIN / -1 wrapping; Pmod over
        floating operands (the integral Pmod is a known difference)."""
        rng = np.random.default_rng(7)
        if op == "Pmod_float" and not T.is_floating(T.parse_type(types[0])):
            types = ("double", "double")
        args = []
        for ts in types:
            dt = T.parse_type(ts)
            if T.is_floating(dt):
                d = rng.normal(0, 50, N)
            else:
                info = np.iinfo(dt.np_dtype)
                d = rng.integers(max(info.min, -1000), min(info.max, 1000), N)
                d[:3] = [info.min, info.min, 7]
            args.append((ts, d, rng.random(N) > 0.1))
        args[1][1][:4] = [-1, 0, 0, -3]  # MIN / -1, x / 0
        name = op.split("_")[0]
        out = evaluate(lambda m, r: getattr(JA if m == "jax" else A,
                                            name)(*r), args)
        assert_same(*out)

    def test_literals_of_the_new_types(self):
        """A decimal literal takes Spark's type of its digits and is one
        broadcast row; FLOAT and TIMESTAMP literals take their types."""
        ctx = EvalContext(torch.ones(5, dtype=torch.bool))
        lit = PE.lit(D("150.00"))
        assert lit.data_type == T.DecimalType(5, 2)
        v = lit.eval(ctx, [])
        assert v.data.tolist() == [15000] * 5 and v.data.stride(0) == 0
        assert PE.lit(D("-0.5")).data_type == T.DecimalType(1, 1)
        assert PE.lit(1234, T.DecimalType(7, 2)).eval(ctx, []).data[0] == 1234
        f = PE.lit(1.5, T.FLOAT).eval(ctx, [])
        assert f.data.dtype == torch.float32 and f.data[0] == 1.5
        ts = PE.lit(-1, T.TIMESTAMP).eval(ctx, [])
        assert ts.data.dtype == torch.int64 and ts.dtype == T.TIMESTAMP

    @pytest.mark.parametrize("kind", ["byte", "integer", "float",
                                      "decimal(7,2)"])
    def test_unary_minus_and_abs_match_jax(self, kind):
        rng = np.random.default_rng(8)
        dt = T.parse_type(kind)
        data = _unscaled(rng, 7) if isinstance(dt, T.DecimalType) else \
            rng.normal(0, 100, N) if T.is_floating(dt) else \
            rng.integers(np.iinfo(dt.np_dtype).min, np.iinfo(dt.np_dtype).max,
                         N)
        for name in ("UnaryMinus", "Abs"):
            out = evaluate(lambda m, r: getattr(JA if m == "jax" else A,
                                                name)(*r),
                           [(kind, data, rng.random(N) > 0.1)])
            assert_same(*out)


# --------------------------------------------------------------------------
def _spark_pmod(a: int, n: int) -> int:
    """Spark's Pmod on Java ints: r = a % n (sign of a); r < 0 ? (r + n) %
    n : r."""
    def jmod(x, y):
        return int(np.fmod(x, y))
    r = jmod(a, n)
    return jmod(r + n, n) if r < 0 else r


class TestKnownDifferences:
    def test_decimal_divide_divides_the_values(self):
        """Divide(decimal(7,2) 150.25, int 2) = 75.125 (the JAX engine:
        7512.5), and decimal / decimal across scales, against Python's
        decimal quotient to 1 ulp."""
        rng = np.random.default_rng(9)
        a = _unscaled(rng, 7)
        b = _unscaled(rng, 9)
        a[0], b[0] = 15025, 2
        for bt in ("integer", "decimal(9,4)", "decimal(9,0)"):
            bb = b if bt != "integer" else b % 100_000 - 50_000
            bb[0] = 2
            bs = T.parse_type(bt).scale if bt != "integer" else 0
            (jd, _), (pd, pv) = evaluate(
                lambda m, r: (JA if m == "jax" else A).Divide(*r),
                [("decimal(7,2)", a, np.ones(N, bool)),
                 (bt, bb, np.ones(N, bool))])
            want = [float(D(int(x)).scaleb(-2) / D(int(y)).scaleb(-bs))
                    if y else None for x, y in zip(a, bb)]
            got = np.array([v for v, ok in zip(pd, pv) if ok])
            exp = np.array([w for w in want if w is not None])
            np.testing.assert_array_equal(pv, [w is not None for w in want])
            np.testing.assert_allclose(got, exp, rtol=2.3e-16, atol=0)
            if bt == "integer":
                assert pd[0] == 75.125
                assert jd[0] == 7512.5  # the JAX engine's unscaled quotient

    def test_decimal_average_is_the_half_up_mean(self):
        """avg(decimal(7,2)) is decimal(11,6): the exact mean rounded
        HALF_UP at scale 6, one device and distributed, against Python's
        decimal; the JAX engine returns a double of the unscaled mean."""
        rng = np.random.default_rng(0)
        n = 1000
        u = rng.integers(-10 ** 7 + 1, 10 ** 7, n)
        g = rng.integers(0, 5, n).astype(np.int32)
        valid = rng.random(n) > 0.05
        t = pa.table({"g": g, "d": dec_array(u, 7, 2, valid)})
        exact = {}
        for k in range(5):
            vals = [D(int(x)).scaleb(-2) for x, gg, ok in zip(u, g, valid)
                    if gg == k and ok]
            exact[k] = (sum(vals) / len(vals)).quantize(
                D("0.000001"), rounding=decimal.ROUND_HALF_UP)
        mesh = {"spark.rapids.shuffle.mode": "ICI",
                "spark.rapids.tpu.mesh.shape": "shuffle=4", FU: True,
                "spark.rapids.tpu.fusion.pallas.mode": "force"}
        for conf in (BASE, dict(BASE, **mesh)):
            out = TpuSession(conf, device="cpu").from_arrow(t).group_by("g") \
                .agg(a=PE.Average(PE.col("d"))).collect().sort_by("g")
            assert out.schema.field("a").type == pa.decimal128(11, 6)
            assert out.column("a").to_pylist() == [exact[k] for k in range(5)]
        jdf = JaxSession(BASE).from_arrow(t).group_by("g").agg(
            a=JE.Average(JE.col("d")))
        try:
            jout = jdf.collect().sort_by("g")
            assert jout.column("a").to_pylist()[0] != exact[0]
        except pa.ArrowInvalid:
            pass  # its double of the unscaled mean overflows decimal(11,6)

    def test_pmod_follows_spark_for_negative_divisors(self):
        rng = np.random.default_rng(10)
        a = rng.integers(-50, 50, N)
        b = rng.integers(-9, 10, N)
        a[0], b[0] = -7, -3
        (jd, _), (pd, pv) = evaluate(
            lambda m, r: (JA if m == "jax" else A).Pmod(*r),
            [("integer", a, np.ones(N, bool)),
             ("integer", b, np.ones(N, bool))])
        want = [_spark_pmod(x, y) if y else None for x, y in zip(a, b)]
        assert [int(v) if ok else None for v, ok in zip(pd, pv)] == want
        assert pd[0] == -1 and jd[0] == 2  # the JAX engine adds |n|

    @pytest.mark.parametrize("kind", ["double", "float"])
    def test_min_max_follow_spark_nan_order(self, kind):
        """NaN is the greatest value and equal to NaN: min([NaN, 0.0]) is
        0.0, max is NaN, a global min over NaN and -inf is -inf; random
        groups with NaN against a numpy oracle of the rule."""
        npt = np.float64 if kind == "double" else np.float32
        sess = TpuSession(BASE, device="cpu")

        def minmax(vals, groups=None):
            t = pa.table({"g": np.zeros(len(vals), np.int32)
                          if groups is None else groups,
                          "x": pa.array(np.asarray(vals, npt))})
            df = sess.from_arrow(t)
            df = df.group_by("g") if groups is not None else df
            return df.agg(lo=PE.Min(PE.col("x")),
                          hi=PE.Max(PE.col("x"))).collect()

        out = minmax([np.nan, 0.0])
        assert out.column("lo").to_pylist() == [0.0]
        assert np.isnan(out.column("hi").to_pylist()[0])
        out = minmax([np.nan, -np.inf, 3.0])
        assert out.column("lo").to_pylist() == [-np.inf]
        assert np.isnan(minmax([np.nan, np.nan]).column("lo")[0].as_py())
        rng = np.random.default_rng(11)
        vals = rng.normal(0, 1, 400)
        vals[rng.random(400) < 0.1] = np.nan
        groups = rng.integers(0, 30, 400).astype(np.int32)
        vals[groups == 3] = np.nan  # one group all NaN
        out = minmax(vals, groups).sort_by("g")
        for g, lo, hi in zip(*(out.column(c).to_pylist()
                               for c in ("g", "lo", "hi"))):
            v = np.asarray(vals[groups == g], npt)
            fin = v[~np.isnan(v)]
            want_lo = fin.min() if len(fin) else np.nan
            want_hi = np.nan if np.isnan(v).any() else v.max()
            np.testing.assert_array_equal([lo, hi], [want_lo, want_hi])


# --------------------------------------------------------------------------
def _types_table(n=1500, seed=12):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.1
    return pa.table({
        "g": rng.integers(0, 9, n).astype(np.int16),
        "d": dec_array(_unscaled(rng, 7, n), 7, 2, ~mask),
        "e": dec_array(_unscaled(rng, 9, n), 9, 4),
        "f": pa.array(rng.normal(0, 10, n).astype(np.float32), mask=mask),
        "b": pa.array(rng.integers(-128, 128, n).astype(np.int8), mask=mask),
        "ts": pa.array(rng.integers(-10 ** 15, 10 ** 15, n),
                       pa.timestamp("us"), mask=mask),
    })


def _aggregates(sess, m, t):
    c = m.col
    return sess.from_arrow(t).select(
        "g", "d", "f", "b", "ts", x=c("d") - c("e"),
        neg=-c("d"), big=c("d") > c("e")).group_by("g", "big").agg(
        s=m.Sum(c("d")), mn=m.Min(c("d")), mx=m.Max(c("x")),
        sneg=m.Sum(c("neg")), sf=m.Sum(c("f")), mnf=m.Min(c("f")),
        mxf=m.Max(c("f")), sb=m.Sum(c("b")), mnb=m.Min(c("b")),
        ab=m.Average(c("b")), af=m.Average(c("f")), mxt=m.Max(c("ts")),
        mnt=m.Min(c("ts")), n=m.Count(c("d")))


@pytest.fixture(scope="module")
def jax_aggregates():
    t = _types_table()
    return t, _aggregates(JaxSession(BASE), JE, t).collect() \
        .sort_by([("g", "ascending"), ("big", "ascending")])


class TestAggregates:
    @pytest.mark.parametrize("plan", ["one_device", "distributed"])
    def test_sum_min_max_over_new_types_match_jax(self, jax_aggregates,
                                                   plan):
        """Group keys SHORT and BOOLEAN; Sum, Min, Max, Average over
        decimal, FLOAT, BYTE and TIMESTAMP, against the JAX engine (one
        device); distributed, every new type crosses the key exchange and
        the fused partial aggregate's int64 sums take the kernel wrapper
        (its plain twin here)."""
        t, want = jax_aggregates
        conf = BASE if plan == "one_device" else dict(BASE, **{
            "spark.rapids.shuffle.mode": "ICI",
            "spark.rapids.tpu.mesh.shape": "shuffle=4", FU: True,
            "spark.rapids.tpu.fusion.pallas.mode": "force"})
        sess = TpuSession(conf, device="cpu")
        if plan == "distributed":
            assert "TpuShuffleExchangeExec" in _aggregates(sess, PE,
                                                           t).explain()
        got = _aggregates(sess, PE, t).collect() \
            .sort_by([("g", "ascending"), ("big", "ascending")])
        assert got.schema == want.schema
        for name in want.column_names:
            if name in ("sf", "af", "ab"):
                np.testing.assert_allclose(got.column(name).to_numpy(),
                                           want.column(name).to_numpy(),
                                           rtol=1e-12)
            else:
                assert got.column(name).equals(want.column(name)), name

    def test_float_group_keys_with_nan_and_negative_zero(self):
        """-0.0 groups with 0.0 and NaN with NaN, under a second key."""
        x = np.array([0.0, -0.0, np.nan, np.nan, 1.5, -0.0, 0.0, 1.5],
                     np.float32)
        k = np.array([1, 2, 1, 2, 1, 1, 2, 2], np.int64)
        t = pa.table({"x": x, "k": k})
        got = TpuSession(BASE, device="cpu").from_arrow(t) \
            .group_by("x", "k").agg(n=PE.Count(None)).collect()
        assert got.num_rows == 6
        assert sorted(got.column("n").to_pylist()) == [1, 1, 1, 1, 2, 2]


# --------------------------------------------------------------------------
class TestJoins:
    @pytest.mark.parametrize("key", ["byte", "short", "timestamp",
                                     "decimal(7,2)"])
    def test_join_on_new_key_types_matches_jax(self, key):
        """Fused, with the probe hash through the kernel wrapper (its
        plain twin here): the same rows as the JAX engine."""
        rng = np.random.default_rng(13)
        dt = T.parse_type(key)
        space = {"byte": 200, "short": 3000}.get(key, 5000)
        vals = rng.integers(-space // 2, space // 2, 900)
        bvals = rng.permutation(np.arange(-space // 2, space // 2))[:100]

        def arr(v, mask=None):
            if isinstance(dt, T.DecimalType):
                return dec_array(v, 7, 2, None if mask is None else ~mask)
            if isinstance(dt, T.TimestampType):
                return pa.array(v, pa.timestamp("us"), mask=mask)
            return pa.array(v.astype(dt.np_dtype), mask=mask)

        probe = pa.table({"k": arr(vals, rng.random(900) < 0.05),
                          "v": np.arange(900, dtype=np.int64)})
        build = pa.table({"k": arr(bvals), "w": rng.integers(0, 99, 100)})
        conf = dict(BASE, **{FU: True,
                             "spark.rapids.tpu.fusion.pallas.mode": "force"})

        def query(sess, m):
            return sess.from_arrow(probe).filter(m.col("v") >= 0).join(
                sess.from_arrow(build), on="k")
        want = positional(query(JaxSession(conf), JE).collect(), False)
        got_sess = TpuSession(conf, device="cpu")
        got = positional(query(got_sess, PE).collect(), False)
        assert "TpuFusedStageExec" in query(got_sess, PE).explain()
        assert got.num_rows == want.num_rows > 0
        for name in want.column_names:
            a, b = want.column(name), got.column(name)
            if pa.types.is_timestamp(a.type):
                a = a.cast(b.type)
            assert a.equals(b), name


# --------------------------------------------------------------------------
class TestBoundaries:
    @pytest.mark.parametrize("case", [
        "decimal_multiply", "decimal_vs_int_compare", "decimal_plus_int",
        "sum_over_decimal_9", "addsub_result_over_18_digits",
        "decimal_remainder", "decimal_integral_divide", "cast_from_string",
        "float_join_key",
        "decimal_keys_of_two_types", "case_over_two_decimal_types"])
    def test_out_of_slice_raises_at_plan_time(self, case):
        with pytest.raises(NotImplementedError):
            self._plan(case).explain()  # before any data moves

    @staticmethod
    def _plan(case):
        sess = TpuSession(device="cpu")
        t = pa.table({"k": np.arange(4, dtype=np.int64),
                      "d": dec_array(np.arange(4), 7, 2),
                      "e": dec_array(np.arange(4), 9, 4),
                      "w": dec_array(np.arange(4), 18, 0),
                      "f": np.zeros(4, np.float32), "s": ["a"] * 4})
        df = sess.from_arrow(t)
        c = PE.col
        if case == "decimal_multiply":
            df = df.select(x=c("d") * c("d"))
        elif case == "decimal_vs_int_compare":
            df = df.filter(c("d") > PE.lit(1))
        elif case == "decimal_plus_int":
            df = df.select(x=c("d") + c("k"))
        elif case == "sum_over_decimal_9":
            # a grouped Sum to decimal(19,4) runs in limbs; a window Sum to
            # it does not (the JAX window holds it in one int64 or double)
            df = df.window(["k"], ["k"], x=PE.WindowAggregate(PE.Sum(c("e"))))
        elif case == "addsub_result_over_18_digits":
            # decimal(23,4) runs; as a join key it has no murmur3
            df = df.select(x=c("w") - c("e"))
            df = df.join(df, on="x")
        elif case == "decimal_remainder":
            df = df.select(x=c("d") % c("d"))
        elif case == "decimal_integral_divide":
            df = df.select(x=PE.IntegralDivide(c("d"), c("k")))
        elif case == "cast_from_string":  # to a decimal runs on the host
            # engine since slice 16; a decimal Round over it is refused
            # (the JAX Round keeps the type and the digits)
            df = df.select(x=PE.Round(c("s").cast(T.DecimalType(7, 2)), 0))
        elif case == "float_join_key":  # float keys join now; not a
            # float against a double (tests/test_torch_joins.py)
            df = df.join(sess.from_arrow(pa.table(
                {"f": np.zeros(4, np.float64)})), on="f")
        elif case == "decimal_keys_of_two_types":
            other = sess.from_arrow(pa.table({"d": dec_array(np.arange(4),
                                                             9, 2)}))
            df = df.join(other, on="d")
        else:
            df = df.select(x=PE.Coalesce(c("d"), c("e")))
        return df
