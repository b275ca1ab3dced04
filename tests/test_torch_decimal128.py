"""Decimals of 19-38 digits in spark_rapids_tpu_torch against the JAX
package on the CPU: the [cap, 2] int64 limb columns, the limb and 256-bit
arithmetic, expressions, sorts, aggregates (one device and over four mesh
positions), the parquet FIXED_LEN_BYTE_ARRAY decode, and the plan-time
boundary. Every case of tests/test_decimal128.py is carried over.

Inputs are made by numpy from seeds. Expressions run in both engines on
the same buffers (the JAX side eagerly on jax.numpy, the port's through
`interop.batch_from_numpy` or `Vec`s of the same limbs); queries run
through both sessions. Every comparison is exact: values (as Python
Decimals or unscaled ints) and validity. Where the JAX engine departs
from Spark the port is held to Python's `decimal` instead: the exact
Average past 18 digits (the JAX engine sums in f64), and the chunked Sum
past 2^20 rows in one group of one batch (the JAX 43-bit chunk sums
overflow)."""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.columnar import batch_to_arrow as jax_batch_to_arrow
from spark_rapids_tpu.expr import decimal128 as JD
from spark_rapids_tpu.expr.base import BoundReference as JBound, \
    EvalContext as JCtx, Vec as JVec
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow, \
    batch_to_arrow
from spark_rapids_tpu_torch.exec import aggregate as AGG
from spark_rapids_tpu_torch.expr import decimal128 as D
from spark_rapids_tpu_torch.expr.base import BoundReference, EvalContext, Vec
from spark_rapids_tpu_torch.io import parquet_device as P
from spark_rapids_tpu_torch.plugin import TpuSession
from torch_port import port_batch

Dec = decimal.Decimal
CTX = decimal.Context(prec=100)
BASE = {"spark.rapids.sql.explain": "NONE"}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        "spark.rapids.tpu.fusion.enabled": True,
        "spark.rapids.tpu.fusion.pallas.mode": "force",
        "spark.rapids.sql.batchSizeRows": 256}
MAX38 = 10 ** 38 - 1
INT128_MIN = -(2 ** 127)


def dec(u: int, scale: int) -> Dec:
    return CTX.scaleb(Dec(int(u)), -scale)


def unscaled_values(rng, digits: int, n: int):
    """Python ints of up to `digits` digits (9-digit pieces from numpy,
    then a random count of digits dropped, so every magnitude occurs),
    random signs, both bounds first."""
    pieces = rng.integers(0, 10 ** 9, (n, -(-digits // 9)))
    drop = rng.integers(0, digits, n)
    sign = rng.choice([-1, 1], n)
    vals = [int(sg) * (sum(int(p) * 10 ** (9 * i) for i, p in enumerate(row))
                       % 10 ** digits) // 10 ** int(dr)
            for row, dr, sg in zip(pieces, drop, sign)]
    vals[:2] = [10 ** digits - 1, -(10 ** digits - 1)]
    return vals


def dec_table(seed=3, n=400, digits=30, scale=3, null_frac=0.1):
    """tests/test_decimal128.py's table, from numpy seeds."""
    rng = np.random.default_rng(seed)
    u = unscaled_values(rng, digits, n)
    valid = rng.random(n) >= null_frac
    vals = [dec(x, scale) if ok else None for x, ok in zip(u, valid)]
    return pa.table({
        "d": pa.array(vals, pa.decimal128(digits + scale, scale)),
        "g": pa.array(np.arange(n) % 7, pa.int32()),
        "i": pa.array(np.arange(n), pa.int64()),
    }), vals


def limbs(values):
    """Python ints -> int64[n, 2] limbs (hi, lo)."""
    return np.array([D.split_int(v) for v in values], np.int64).reshape(-1, 2)


def ints(data) -> list:
    data = np.asarray(data)
    return [D.join_int(int(h), int(lo)) for h, lo in data]


def evaluate(make, args):
    """make(engine_module, [bound refs]) -> an expression of either engine;
    args: [(type string, data, valid)], a decimal128's data int64[n, 2]
    limbs. Returns ((JAX data, validity), (port data, validity))."""
    jrefs, prefs, jvecs, pvecs = [], [], [], []
    for i, (ts, data, valid) in enumerate(args):
        jt, pt = JT.parse_type(ts), T.parse_type(ts)
        d, v = np.asarray(data), np.asarray(valid, bool)
        jrefs.append(JBound(i, jt))
        prefs.append(BoundReference(i, pt))
        jvecs.append(JVec(jt, jnp.asarray(d), jnp.asarray(v)))
        pvecs.append(Vec(pt, torch.from_numpy(d.copy()),
                         torch.from_numpy(v.copy())))
    n = len(args[0][2])
    jout = make("jax", jrefs).eval(JCtx(jnp, row_mask=jnp.ones(n, bool)),
                                   jvecs)
    pout = make("port", prefs).eval(EvalContext(torch.ones(n, dtype=bool)),
                                    pvecs)
    return ((np.asarray(jout.data), np.asarray(jout.validity)),
            (pout.data.numpy(), pout.validity.numpy()))


def assert_same(jax_out, port_out):
    (jd, jv), (pd, pv) = jax_out, port_out
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pd[pv], jd[jv])


def E(engine):
    return JE if engine == "jax" else PE


# --------------------------------------------------------------------------
class TestLimbs:
    EDGES = [MAX38, -MAX38, INT128_MIN, 2 ** 127 - 1, 0, 1, -1, 2 ** 64 - 1,
             -(2 ** 64), 2 ** 63, -(2 ** 63) - 1]

    def _values(self, n=300):
        rng = np.random.default_rng(21)
        return self.EDGES + unscaled_values(rng, 38, n)

    def test_sum_chunks_recombine_every_value_and_sums(self):
        """Four 32-bit chunks recombine to each value, and their column
        sums to the 128-bit total (wrapping as two's complement)."""
        vals = self._values()
        hi, lo = (torch.from_numpy(c) for c in limbs(vals).T.copy())
        chunks = D.sum_chunks(hi, lo)
        assert all(int(c.min()) >= -(2 ** 31) and int(c.max()) < 2 ** 32
                   for c in chunks)
        assert ints(torch.stack(D.sum_recombine(chunks), 1)) == vals
        total = D.sum_recombine([c.sum().reshape(1) for c in chunks])
        want = (sum(vals) + 2 ** 127) % 2 ** 128 - 2 ** 127
        assert ints(torch.stack(total, 1)) == [want]

    def test_wide_chain_against_python_ints(self):
        """The 256-bit chain: x * 10^k, HALF_UP back down, narrowing with
        its fits flag, compares, and add/neg, at the bounds and -2^127."""
        vals = self._values(100)
        hi, lo = (torch.from_numpy(c) for c in limbs(vals).T.copy())
        w = D.wide_from128(hi, lo)
        for k in (0, 1, 9, 10, 38):
            up = D.wide_mul_pow10(w, k)
            h, l_, fits = D.wide_to128(up)
            assert [bool(f) for f in fits] == \
                [-(2 ** 127) <= v * 10 ** k < 2 ** 127 for v in vals]
            back = D.wide_to128(D.wide_div_pow10_half_up(up, k))
            assert ints(torch.stack(back[:2], 1)) == vals
        lt, eq = D.wide_cmp(w, D.wide_from128(hi.flip(0), lo.flip(0)))
        assert [bool(x) for x in lt] == [a < b for a, b in
                                          zip(vals, vals[::-1])]
        assert [bool(x) for x in eq] == [a == b for a, b in
                                          zip(vals, vals[::-1])]
        s = D.wide_to128(D.wide_add(w, D.wide_neg(w)))
        assert ints(torch.stack(s[:2], 1)) == [0] * len(vals)

    def test_rescales_and_bounds_against_python_ints(self):
        vals = [v for v in self._values(100) if v != INT128_MIN]
        hi, lo = (torch.from_numpy(c) for c in limbs(vals).T.copy())
        for k in (1, 4, 9, 19, 37):
            def half_up(v):
                q, r = divmod(abs(v), 10 ** k)
                q += 2 * r >= 10 ** k
                return -q if v < 0 else q
            got = D.div_pow10_half_up(hi, lo, k)
            assert ints(torch.stack(got, 1)) == [half_up(v) for v in vals]
            got = D.div_pow10_trunc(hi, lo, k)
            assert ints(torch.stack(got, 1)) == \
                [abs(v) // 10 ** k * (1 if v >= 0 else -1) for v in vals]
        small = [v for v in vals if abs(v) < 10 ** 20]
        sh, sl = (torch.from_numpy(c) for c in limbs(small).T.copy())
        assert ints(torch.stack(D.mul_pow10(sh, sl, 18), 1)) == \
            [v * 10 ** 18 for v in small]
        ok = D.in_bounds(hi, lo, 38)
        assert [bool(x) for x in ok] == [abs(v) <= MAX38 for v in vals]

    def test_in_bounds_int128_min(self):
        """JAX TestWideExactness::test_in_bounds_int128_min."""
        hi, lo = D.split_int(INT128_MIN)
        assert not bool(D.in_bounds(torch.tensor([hi]), torch.tensor([lo]),
                                    38)[0])
        jok = JD.in_bounds(np, np.array([hi], np.int64),
                           np.array([lo], np.int64), 38)
        assert not bool(jok[0])

    def test_adjust_precision_scale_unit(self):
        for a, b in (((38, 0), (38, 10)), ((10, 2), (12, 4))):
            r = D.add_result_type(T.DecimalType(*a), T.DecimalType(*b))
            jr = JD.add_result_type(JT.DecimalType(*a), JT.DecimalType(*b))
            assert (r.precision, r.scale) == (jr.precision, jr.scale)
        assert (D.adjust_precision_scale(77, 38).scale,
                D.adjust_precision_scale(40, 3).scale) == (6, 3)

    @pytest.mark.parametrize("small", [True, False])
    def test_divmod_rows_against_python_ints(self, small):
        """A 128-bit magnitude by per-row 64-bit divisors: by 32-bit limbs
        for divisors below 2^31, bit by bit up to 2^63 - 1."""
        rng = np.random.default_rng(4)
        mags = [abs(v) for v in self._values(60) if v != INT128_MIN]
        top = 2 ** 31 - 1 if small else 2 ** 63 - 1
        divs = [int(x) for x in rng.integers(1, top, len(mags))]
        divs[:3] = [1, 7, top]
        hi, lo = (torch.from_numpy(c) for c in limbs(mags).T.copy())
        qhi, qlo, r = D.divmod_rows(hi, lo, torch.tensor(divs), small)
        got = [((int(a) % 2 ** 64) << 64 | (int(b) % 2 ** 64), int(c))
               for a, b, c in zip(qhi, qlo, r)]
        assert got == [divmod(m, d) for m, d in zip(mags, divs)]

    def test_jax_three_chunk_sum_overflows_past_2_20_rows(self):
        """The JAX split into three 43-bit chunks sums each in int64, so a
        group of more than 2^20 rows of one batch can overflow a chunk
        sum; the port's four 32-bit chunks stay exact (ROADMAP Queue C)."""
        n = (1 << 21) + 5
        lo = np.full(n, (1 << 43) - 1, np.int64)  # every low chunk full
        hi = np.zeros(n, np.int64)
        want = n * ((1 << 43) - 1)
        js = [c.sum() for c in JD.sum_chunks(np, hi, lo)]
        jh, jl = JD.sum_recombine(np, *[np.array([s]) for s in js])
        assert JD.join_int(int(jh[0]), int(jl[0])) != want
        ps = [c.sum().reshape(1) for c in D.sum_chunks(
            torch.from_numpy(hi), torch.from_numpy(lo))]
        assert ints(torch.stack(D.sum_recombine(ps), 1)) == [want]


# --------------------------------------------------------------------------
class TestColumns:
    def test_roundtrip_and_placement(self):
        """Arrow -> limbs -> Arrow: the JAX package's buffers (its per-row
        Decimal conversion against the vectorised one) and the same
        table back; a JAX batch rebuilds in the port unchanged."""
        t, _ = dec_table()
        jb = jax_batch_from_arrow(t)
        pb = batch_from_arrow(t, torch.device("cpu"))
        assert tuple(pb.columns[0].data.shape) == (pb.capacity, 2)
        valid = np.asarray(jb.columns[0].validity)
        np.testing.assert_array_equal(pb.columns[0].validity.numpy(), valid)
        np.testing.assert_array_equal(pb.columns[0].data.numpy()[valid],
                                      np.asarray(jb.columns[0].data)[valid])
        assert batch_to_arrow(pb).equals(t)
        assert batch_to_arrow(port_batch(jb)).equals(jax_batch_to_arrow(jb))
        sl = t.slice(3, 50)  # an offset into the Arrow buffers
        assert batch_to_arrow(batch_from_arrow(sl, "cpu")).equals(sl)

    @pytest.mark.parametrize("p,s", [(38, 18), (38, 0), (20, 2), (28, 10)])
    def test_flba_decode_matches_read_table(self, tmp_path, p, s):
        """FIXED_LEN_BYTE_ARRAY decimals of 9, 12 and 16 bytes, negative
        values and +-(10^p - 1), with nulls, over dictionary and PLAIN
        pages, decoded on the device path equal `pq.read_table`."""
        rng = np.random.default_rng(p + s)
        n = 3000
        u = unscaled_values(rng, p, n)
        valid = rng.random(n) > 0.1
        vals = [dec(x, s) if ok else None for x, ok in zip(u, valid)]
        vals[:2] = [dec(10 ** p - 1, s), dec(-(10 ** p - 1), s)]
        t = pa.table({"d": pa.array(vals, pa.decimal128(p, s)),
                      "r": pa.array([vals[7]] * n, pa.decimal128(p, s))})
        path = str(tmp_path / "d.parquet")
        pq.write_table(t, path, row_group_size=1000)
        flen = pq.ParquetFile(path).schema.column(0).length
        assert flen == {20: 9, 28: 12, 38: 16}[p]
        got = TpuSession(BASE, device="cpu").read_parquet(path).collect()
        assert got.equals(pq.read_table(path))


# --------------------------------------------------------------------------
ARGS = {
    "decimal(38,0)": lambda rng, n: unscaled_values(rng, 38, n),
    "decimal(38,10)": lambda rng, n: unscaled_values(rng, 38, n),
    "decimal(25,2)": lambda rng, n: unscaled_values(rng, 25, n),
    "decimal(30,3)": lambda rng, n: unscaled_values(rng, 30, n),
    "decimal(18,4)": lambda rng, n: unscaled_values(rng, 18, n),
}
N = 256


def _arg(rng, ts, n=N):
    vals = ARGS[ts](rng, n)
    data = limbs(vals) if T.parse_type(ts).precision > 18 else \
        np.array(vals, np.int64)
    return ts, data, rng.random(n) > 0.1


class TestExpressions:
    @pytest.mark.parametrize("op", ["Add", "Subtract"])
    @pytest.mark.parametrize("pair", [
        ("decimal(38,0)", "decimal(38,0)"),  # overflow to null
        ("decimal(25,2)", "decimal(30,3)"),  # mixed scales, 128-bit path
        ("decimal(38,0)", "decimal(38,10)"),  # the 256-bit path, scale 6
        ("decimal(18,4)", "decimal(38,10)")])
    def test_add_subtract_match_jax(self, pair, op):
        rng = np.random.default_rng(5)
        args = [_arg(rng, pair[0]), _arg(rng, pair[1])]
        assert_same(*evaluate(
            lambda e, r: getattr(E(e), op)(r[0], r[1]), args))

    @pytest.mark.parametrize("pair", [("decimal(38,0)", "decimal(38,10)"),
                                      ("decimal(25,2)", "decimal(30,3)"),
                                      ("decimal(18,4)", "decimal(25,2)")])
    @pytest.mark.parametrize("op", ["LessThan", "EqualTo",
                                    "GreaterThanOrEqual"])
    def test_compares_match_jax(self, pair, op):
        rng = np.random.default_rng(6)
        a, b = _arg(rng, pair[0]), _arg(rng, pair[1])
        b = (b[0], np.concatenate([b[1][:N // 2], a[1][:N // 2]])
             if T.parse_type(b[0]) == T.parse_type(a[0]) else b[1], b[2])
        assert_same(*evaluate(
            lambda e, r: getattr(E(e), op)(r[0], r[1]), [a, b]))

    @pytest.mark.parametrize("src,dst", [
        ("decimal(30,3)", "decimal(30,5)"), ("decimal(30,3)", "decimal(26,2)"),
        ("decimal(38,0)", "decimal(38,10)"), ("decimal(38,10)", "decimal(20,1)"),
        ("decimal(25,2)", "decimal(12,2)"), ("decimal(18,4)", "decimal(30,3)"),
        ("decimal(38,0)", "long"), ("decimal(30,3)", "integer"),
        ("decimal(38,10)", "double"), ("decimal(25,2)", "float"),
        ("decimal(30,3)", "boolean"), ("long", "decimal(38,10)"),
        ("integer", "decimal(20,0)")])
    def test_casts_match_jax(self, src, dst):
        """HALF_UP rescales, overflow to null (also to a narrower
        decimal), exact truncation to integers, the JAX double formula."""
        rng = np.random.default_rng(7)
        if src in ARGS:
            arg = _arg(rng, src)
        else:
            arg = (src, rng.integers(-2 ** 31, 2 ** 31, N).astype(
                np.int64 if src == "long" else np.int32), rng.random(N) > .1)
        jt, pt = JT.parse_type(dst), T.parse_type(dst)
        assert_same(*evaluate(
            lambda e, r: (JE.Cast(r[0], jt) if e == "jax" else
                          PE.Cast(r[0], pt)), [arg]))

    @pytest.mark.parametrize("fn", ["UnaryMinus", "Abs", "If", "Coalesce",
                                    "CaseWhen"])
    def test_unary_and_conditionals_match_jax(self, fn):
        rng = np.random.default_rng(8)
        a, b = _arg(rng, "decimal(30,3)"), _arg(rng, "decimal(30,3)")
        b[1][:2] = [D.split_int(INT128_MIN), D.split_int(-MAX38)]
        flag = ("boolean", rng.random(N) > 0.5, rng.random(N) > 0.2)

        def make(e, r):
            m = E(e)
            if fn in ("UnaryMinus", "Abs"):
                return getattr(m, fn)(r[1])
            if fn == "If":
                return m.If(r[2], r[0], r[1])
            if fn == "Coalesce":
                return m.Coalesce(r[0], r[1])
            return m.CaseWhen([(r[2], r[0])], r[1])
        assert_same(*evaluate(make, [a, b, flag]))

    def test_literals_of_38_digits(self):
        """A decimal(38,x) literal broadcasts its limbs; compared and added
        to a column as in the JAX engine."""
        rng = np.random.default_rng(9)
        a = _arg(rng, "decimal(38,10)")
        lit = dec(-MAX38 + 5, 10)
        jt, pt = JT.DecimalType(38, 10), T.DecimalType(38, 10)
        assert_same(*evaluate(
            lambda e, r: (JE.Subtract(r[0], JE.lit(lit, jt)) if e == "jax"
                          else PE.Subtract(r[0], PE.lit(lit, pt))), [a]))
        assert_same(*evaluate(
            lambda e, r: (JE.LessThan(JE.lit(lit, jt), r[0]) if e == "jax"
                          else PE.LessThan(PE.lit(lit, pt), r[0])), [a]))


# --------------------------------------------------------------------------
def _both(q):
    """q(session, expr module) through both engines -> (JAX, port)."""
    return q(JaxSession(BASE), JE).collect(), \
        q(TpuSession(BASE, device="cpu"), PE).collect()


class TestQueries:
    def test_group_aggregates_vs_jax_and_python(self):
        """tests/test_decimal128.py test_group_aggregates_vs_python, with
        First/Last (ignore nulls) over one batch; the JAX engine and
        Python's sums agree with the port."""
        t, vals = dec_table()

        def q(sess, m):
            c = m.col
            return sess.from_arrow(t).group_by("g").agg(
                s=m.Sum(c("d")), mn=m.Min(c("d")), mx=m.Max(c("d")),
                c=m.Count(c("d")), f=m.First(c("d")), la=m.Last(c("d")),
                fi=m.First(c("d"), True))
        jout, out = _both(q)
        out = out.sort_by("g")
        assert out.equals(jout.sort_by("g"))
        rows = out.to_pylist()
        for g in range(7):
            sel = [v for i, v in enumerate(vals) if i % 7 == g]
            ok = [v for v in sel if v is not None]
            assert (rows[g]["s"], rows[g]["mn"], rows[g]["mx"],
                    rows[g]["c"]) == (sum(ok), min(ok), max(ok), len(ok))
            assert (rows[g]["f"], rows[g]["la"], rows[g]["fi"]) == \
                (sel[0], sel[-1], ok[0])

    def test_sort_order_and_filter(self):
        """Sorted by a 33-digit decimal both ways, and filtered by a
        compare with a literal, as the JAX engine does."""
        t, vals = dec_table(seed=5, n=200)
        zero = (JE.lit(Dec(0), JT.DecimalType(33, 3)),
                PE.lit(Dec(0), T.DecimalType(33, 3)))

        def q(sess, m):
            z = zero[0] if m is JE else zero[1]
            df = sess.from_arrow(t).filter(m.col("d") > z)
            return df.sort((m.col("d"), False, False), "i")
        jout, out = _both(q)
        assert out.equals(jout)
        got = out.column("d").to_pylist()
        assert got == sorted([v for v in vals if v is not None and v > 0],
                             reverse=True)
        asc = TpuSession(BASE, device="cpu").from_arrow(t).sort("d") \
            .collect().column("d").to_pylist()
        assert asc == [None] * asc.count(None) + sorted(
            v for v in vals if v is not None)

    def test_sum_widens_to_128(self):
        """A decimal(18,0) Sum is decimal(28,0): summed in limbs."""
        rng = np.random.default_rng(11)
        u = rng.integers(-10 ** 17, 10 ** 17, 500)
        t = pa.table({"d": pa.array([Dec(int(x)) for x in u],
                                    pa.decimal128(18, 0)),
                      "g": np.zeros(500, np.int32)})

        def q(sess, m):
            return sess.from_arrow(t).group_by("g").agg(s=m.Sum(m.col("d")))
        jout, out = _both(q)
        assert out.equals(jout)
        assert out.column("s").to_pylist() == [Dec(int(u.sum()))]
        assert out.schema.field("s").type == pa.decimal128(28, 0)

    def test_distributed_dec128_agg(self):
        """tests/test_decimal128.py's distributed case over four mesh
        positions (fused partial aggregate, its chunk sums through the
        int64 kernel's wrapper), and a decimal128 group key on one
        device."""
        t, vals = dec_table(seed=13, n=600)

        def q(sess, m):
            c = m.col
            return sess.from_arrow(t).group_by("g").agg(
                sm=m.Sum(c("d")), mn=m.Min(c("d")), mx=m.Max(c("d")))
        sess = TpuSession(dict(BASE, **MESH), device="cpu")
        assert "TpuShuffleExchangeExec" in q(sess, PE).explain()
        out = q(sess, PE).collect().sort_by("g")
        want = q(JaxSession(BASE), JE).collect().sort_by("g")
        assert out.equals(want)
        for g in range(7):
            sel = [v for i, v in enumerate(vals) if i % 7 == g
                   and v is not None]
            assert out.column("sm")[g].as_py() == sum(sel)
        keyed = TpuSession(BASE, device="cpu").from_arrow(t).group_by(
            "d").agg(n=PE.Count(None)).collect()
        assert keyed.num_rows == len(set(vals))

    def test_wide_exactness_queries(self):
        """TestWideExactness's queries: the dec(38,0) +/- dec(38,10) types
        as (38,6) and exact, true overflow nulls, an exact compare across
        a 10-digit scale gap, an upscale cast that must not wrap, and an
        integral cast to decimal(18,10) that must not wrap."""
        big = [Dec(34028236692093846346337460743), Dec(10) ** 30,
               Dec(-(10 ** 28)), Dec(7), Dec(9) * Dec(10) ** 37]
        t = pa.table({
            "a": pa.array(big, pa.decimal128(38, 0)),
            "b": pa.array([Dec("0.5"), Dec(0), Dec("0.0000000001"),
                           Dec("-7"), Dec(0)], pa.decimal128(38, 10)),
            "m": pa.array([Dec(9) * Dec(10) ** 37] * 5,
                          pa.decimal128(38, 0)),
            "v": pa.array([1844674408, 12345678, -(2 ** 63), 5, 0],
                          pa.int64()),
            "i": pa.array(range(5), pa.int64())})
        jt = (JT.DecimalType(38, 10), JT.DecimalType(18, 10))
        pt = (T.DecimalType(38, 10), T.DecimalType(18, 10))

        def q(sess, m):
            c = m.col
            ty = jt if m is JE else pt
            return sess.from_arrow(t).select(
                "i", s=c("a") + c("b"), d=c("a") - c("b"),
                o=c("a") + c("m"), gt=c("a") > c("b"), lt=c("a") < c("b"),
                up=m.Cast(c("a"), ty[0]), iv=m.Cast(c("v"), ty[1]))
        jout, out = _both(q)
        assert out.equals(jout)
        got = out.to_pylist()
        assert out.schema.field("s").type == pa.decimal128(38, 6)
        assert [g["s"] for g in got[:4]] == [
            Dec("34028236692093846346337460743.5"), Dec(10) ** 30,
            Dec(-(10 ** 28)), Dec(0)]
        assert got[3]["d"] == Dec(14)
        assert [g["o"] for g in got] == [b + Dec(9 * 10 ** 37)
                                         for b in big[:4]] + [None]
        assert [g["gt"] for g in got[:3]] == [True, True, False]
        # 10^28 at scale 10 passes 38 digits: null, never a wrapped value
        assert [g["up"] for g in got[:4]] == [None, None, None, Dec(7)]
        assert [g["iv"] for g in got[:3]] == [None, Dec(12345678), None]


# --------------------------------------------------------------------------
class TestExactAverage:
    """Average over a decimal whose sum passes 18 digits: the exact mean
    rounded HALF_UP at scale s + 4, in limbs. The JAX engine sums in f64
    and returns a double of the unscaled mean (ROADMAP Known differences),
    so the port is held to Python's decimal."""

    def test_mean128_on_tensors_against_python(self):
        """Sums up to +-(10^38 - 1) over counts up to 2^40: both division
        paths (32-bit limbs below 2^31, bit by bit above)."""
        rng = np.random.default_rng(12)
        sums = unscaled_values(rng, 34, 200) + [MAX38 // 10 ** 4, -7, 5, 0]
        for counts in ([int(c) for c in rng.integers(1, 2 ** 31,
                                                     len(sums))],
                       [int(c) for c in rng.integers(1, 2 ** 40,
                                                     len(sums))]):
            counts[-4:] = [1, 2, 2, 3]
            h, lo = (torch.from_numpy(c) for c in limbs(sums).T.copy())
            oh, ol, ok = AGG._decimal_mean128(h, lo, torch.tensor(counts),
                                              4, 38)
            want = []
            for s, c in zip(sums, counts):
                q, r = divmod(abs(s) * 10 ** 4, c)
                q += 2 * r >= c
                want.append(-q if s < 0 else q)
            assert ints(torch.stack([oh, ol], 1)) == want
            assert [bool(x) for x in ok] == [abs(w) <= MAX38 for w in want]

    @pytest.mark.parametrize("plan", ["one_device", "distributed"])
    def test_average_of_decimal_17_sums(self, plan):
        """q65's shape: avg over a decimal(17,2) column is decimal(21,6),
        its partial sum decimal(27,2) in limbs (crossing the exchange when
        distributed)."""
        rng = np.random.default_rng(14)
        n = 900
        u = rng.integers(-10 ** 17 + 1, 10 ** 17, n)
        u[:3] = [10 ** 17 - 1] * 3
        g = rng.integers(0, 5, n).astype(np.int32)
        valid = rng.random(n) > 0.05
        t = pa.table({"g": g, "d": pa.array(
            [dec(x, 2) if ok else None for x, ok in zip(u, valid)],
            pa.decimal128(17, 2))})
        conf = BASE if plan == "one_device" else dict(BASE, **MESH)
        out = TpuSession(conf, device="cpu").from_arrow(t).group_by("g") \
            .agg(a=PE.Average(PE.col("d"))).collect().sort_by("g")
        assert out.schema.field("a").type == pa.decimal128(21, 6)
        for k in range(5):
            sel = [dec(x, 2) for x, gg, ok in zip(u, g, valid)
                   if gg == k and ok]
            want = CTX.divide(sum(sel), len(sel)).quantize(
                Dec("0.000001"), rounding=decimal.ROUND_HALF_UP)
            assert out.column("a")[k].as_py() == want
        jout = JaxSession(BASE).from_arrow(t).group_by("g").agg(
            a=JE.Average(JE.col("d")))
        with pytest.raises(Exception):  # its f64 mean does not convert
            jout.collect()


# --------------------------------------------------------------------------
class TestBoundaries:
    @pytest.mark.parametrize("case", [
        "decimal_multiply", "decimal_plus_long", "dec128_join_key",
        "dec128_partition_key", "window_sum_past_18", "window_average",
        "window_min_dec128", "collect_list", "collect_set",
        "approx_percentile", "count_distinct", "ansi", "string_over_256",
        "dec128_divide", "least_dec128", "in_dec128",
        "variance_over_decimal"])
    def test_out_of_slice_raises_at_plan_time(self, case):
        sess = TpuSession(dict(BASE, **MESH) if case ==
                          "dec128_partition_key" else
                          dict(BASE, **{"spark.sql.ansi.enabled": True})
                          if case == "ansi" else BASE, device="cpu")
        t = pa.table({"k": np.arange(4, dtype=np.int64),
                      "d": pa.array([Dec(1)] * 4, pa.decimal128(25, 2)),
                      "e": pa.array([Dec(1)] * 4, pa.decimal128(10, 2)),
                      "s": ["a", "b", "c", "d" * 300]})
        c, W = PE.col, PE.WindowAggregate

        def plan():
            df = sess.from_arrow(t.drop(["s"]) if case != "string_over_256"
                                 else t)
            return {
                "decimal_multiply": lambda: df.select(x=c("d") * c("d")),
                "decimal_plus_long": lambda: df.select(x=c("d") + c("k")),
                "dec128_join_key": lambda: df.join(df, on="d"),
                "dec128_partition_key": lambda: df.group_by("d").agg(
                    n=PE.Count(None)),
                "window_sum_past_18": lambda: df.window(
                    ["k"], ["k"], x=W(PE.Sum(c("e")))),
                "window_average": lambda: df.window(
                    ["k"], ["k"], x=W(PE.Average(c("e")))),
                "window_min_dec128": lambda: df.window(
                    ["k"], ["k"], x=W(PE.Min(c("d")))),
                "collect_list": lambda: df.group_by("k").agg(
                    x=PE.CollectList(c("d"))),
                "collect_set": lambda: df.group_by("k").agg(
                    x=PE.CollectSet(c("k"))),
                "approx_percentile": lambda: df.group_by("k").agg(
                    x=PE.ApproximatePercentile(c("k"), 0.5)),
                "count_distinct": lambda: df.agg(x=PE.CountDistinct(c("k"))),
                # ANSI runs; a Round over a decimal stays refused (the
                # JAX Round keeps the decimal's type and digits)
                "ansi": lambda: df.select(x=PE.Round(c("d"), 0)),
                "string_over_256": lambda: df.group_by("s").agg(
                    x=PE.Sum(c("d"))),
                "dec128_divide": lambda: df.select(x=c("d") / c("k")),
                "least_dec128": lambda: df.select(x=PE.Least(c("d"),
                                                             c("d"))),
                "in_dec128": lambda: df.filter(PE.In(c("d"), [Dec(1)])),
                "variance_over_decimal": lambda: df.group_by("k").agg(
                    x=PE.StddevSamp(c("e"))),
            }[case]()
        if case == "string_over_256":
            # the long-string layout runs it (a string group key past the
            # head width reruns on the host), as the JAX engine does
            jdf = JaxSession(BASE).from_arrow(t).group_by("s").agg(
                x=JE.Sum(JE.col("d")))
            assert plan().collect().sort_by("s").equals(
                jdf.collect().sort_by("s"))
            return
        with pytest.raises(NotImplementedError):
            plan().explain()  # planning raises, before any data moves
