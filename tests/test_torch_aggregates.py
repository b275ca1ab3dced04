"""The grouped aggregates of the JAX `_agg_one` that slice 9 ports (the
variance family, Skewness, Kurtosis, CountIf, BoolAnd/BoolOr,
BitAnd/BitOr/BitXor, First/Last, MIN/MAX over strings and over 128-bit
decimals) and the First/Last and string MIN/MAX window frames, in
spark_rapids_tpu_torch against the JAX engine on the CPU, one device and
distributed over four mesh positions.

Both engines run the same query over the same Arrow table (numpy seeds):
groups of one row (a sample variance is null there), groups whose values
are all null, NaN among the doubles, nulls everywhere. Tolerances: exact
for counts, booleans, bits, strings, decimals and First/Last; rtol 1e-12
for the variance family over integers (its sums below 2^53 are exact in
any order, and the formulas agree to an ulp: the JAX engine's compiled
`s2 - c * mean * mean` fuses a multiply-add); rtol 1e-9 over doubles (the
engines add in different orders) and for the moments (the JAX engine's
`x ** 3` and torch's `pow` may differ by an ulp), with an absolute
tolerance of the same share of the column's largest magnitude: the moment
form cancels, so a variance near 0 carries the others' rounding (the JAX
engine's fused multiply-add leaves x*x's rounding error, 1e-12, as the
variance of a one-row group, where the port has 0). A standard deviation
is the square root of that, so stddevs take an absolute 1e-5 of the
column's largest. First/Last are compared
where the answer is determined: one batch on one device, or with
ignore_nulls over a column holding one valid value a group."""

import decimal

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        "spark.rapids.tpu.fusion.enabled": True,
        "spark.rapids.tpu.fusion.pallas.mode": "force",
        "spark.rapids.sql.batchSizeRows": 128}
# column -> (rtol, absolute tolerance as a share of the column's largest
# magnitude)
APPROX = {"var_x": (1e-9, 1e-9), "vs_x": (1e-9, 1e-9),
          "sd_x": (1e-9, 1e-5), "sds_x": (1e-9, 1e-5),
          "sk_i": (1e-9, 1e-9), "ku_i": (1e-9, 1e-9),
          "sk_x": (1e-9, 1e-9), "ku_x": (1e-9, 1e-9),
          "var_i": (1e-12, 1e-12), "sds_i": (1e-12, 1e-12)}
WORDS = np.array(["", "a", "ab", "b", "zz", "é", "a\x00", "x" * 40],
                 dtype=object)


def agg_table(n=700, seed=41):
    """Groups 0..39 (about 17 rows each), 40..42 one row each, 43 with
    every value null; `u` holds one valid value a group."""
    rng = np.random.default_rng(seed)
    g = np.concatenate([rng.integers(0, 40, n), [40, 41, 42, 43, 43]])
    m = len(g)
    null = rng.random(m) < 0.1
    null[g == 43] = True
    x = rng.normal(0, 100, m).round(2)
    x[rng.random(m) < 0.02] = np.nan
    first = np.zeros(m, bool)
    first[np.unique(g, return_index=True)[1]] = True
    d38 = [decimal.Decimal(int(a) * 10 ** 20 + int(b)).scaleb(-18)
           for a, b in zip(rng.integers(-10 ** 17, 10 ** 17, m),
                           rng.integers(0, 10 ** 18, m))]
    return pa.table({
        "g": pa.array(g.astype(np.int32)),
        "x": pa.array(x, mask=null),
        "i": pa.array(rng.integers(-1000, 1000, m).astype(np.int32),
                      mask=null),
        "b": pa.array(rng.random(m) < 0.7, mask=null),
        "l": pa.array(rng.integers(-2 ** 62, 2 ** 62, m), mask=null),
        "y": pa.array(rng.integers(-128, 128, m).astype(np.int8),
                      mask=null),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, m).astype(np.int16),
                      mask=null),
        "s": pa.array(list(WORDS[rng.integers(0, len(WORDS), m)]),
                      mask=null),
        "d": pa.array([None if k else v for k, v in zip(null, d38)],
                      pa.decimal128(38, 18)),
        "u": pa.array(rng.integers(0, 99, m), mask=~first),
    })


def aggs(m, order_free: bool):
    """Every aggregate of the slice, written once for either engine's
    constructors `m`; First/Last of nullable columns only where the row
    order is fixed."""
    c = m.col
    out = dict(
        var_x=m.VariancePop(c("x")), vs_x=m.VarianceSamp(c("x")),
        sd_x=m.StddevPop(c("x")), sds_x=m.StddevSamp(c("x")),
        var_i=m.VariancePop(c("i")), sds_i=m.StddevSamp(c("i")),
        sk_i=m.Skewness(c("i")), ku_i=m.Kurtosis(c("i")),
        sk_x=m.Skewness(c("x")), ku_x=m.Kurtosis(c("x")),
        ci=m.CountIf(c("b")), ba=m.BoolAnd(c("b")), bo=m.BoolOr(c("b")),
        band=m.BitAndAgg(c("l")), bor=m.BitOrAgg(c("y")),
        bx=m.BitXorAgg(c("h")), bxl=m.BitXorAgg(c("l")),
        mins=m.Min(c("s")), maxs=m.Max(c("s")),
        mind=m.Min(c("d")), maxd=m.Max(c("d")),
        fu=m.First(c("u"), True), lu=m.Last(c("u"), True))
    if not order_free:
        out.update(fs=m.First(c("s")), ls=m.Last(c("s")),
                   fd=m.First(c("d"), True), lx=m.Last(c("x"), True))
    return out


def assert_tables(got, want, approx=APPROX):
    assert got.schema == want.schema, (got.schema, want.schema)
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        a, b = want.column(name), got.column(name)
        assert a.is_null().equals(b.is_null()), name
        if name in approx:
            ref = a.drop_null().to_numpy()
            rtol, share = approx[name]
            scale = np.nanmax(np.abs(ref), initial=0.0)
            np.testing.assert_allclose(
                b.drop_null().to_numpy(), ref, rtol=rtol, atol=share * scale,
                equal_nan=True, err_msg=name)
        elif pa.types.is_floating(a.type):
            assert np.array_equal(a.drop_null().to_numpy(),
                                  b.drop_null().to_numpy(),
                                  equal_nan=True), name
        else:
            assert a.equals(b), name


def valid_counts(table, col: str) -> np.ndarray:
    """Valid values of `col` in each group 0..43."""
    g = table.column("g").to_numpy()
    ok = ~table.column(col).is_null().to_numpy(zero_copy_only=False)
    return np.bincount(g[ok], minlength=44)


@pytest.fixture(scope="module")
def table():
    return agg_table()


@pytest.fixture(scope="module")
def jax_grouped(table):
    return JaxSession(BASE).from_arrow(table).group_by("g").agg(
        **aggs(JE, False)).collect().sort_by("g")


class TestGrouped:
    @pytest.mark.parametrize("plan", ["one_device", "distributed"])
    def test_every_aggregate_matches_jax(self, table, jax_grouped, plan):
        """One device (one batch: First/Last of nullable columns too) and
        distributed (six batches, each group's partial buffers merged
        across the exchange; the fused partial aggregate's int64 sums
        through the kernel wrapper)."""
        conf = BASE if plan == "one_device" else dict(BASE, **MESH)
        df = TpuSession(conf, device="cpu").from_arrow(table).group_by(
            "g").agg(**aggs(PE, plan == "distributed"))
        if plan == "distributed":
            assert "TpuShuffleExchangeExec" in df.explain()
        got = df.collect().sort_by("g")
        want = jax_grouped.select(got.column_names)
        # a group of one valid value has m2 = 0, so Spark's skewness and
        # kurtosis are NaN there; the JAX engine's fused multiply-add
        # leaves m2 = 1e-12 and a number (see the module docstring)
        moments = ["sk_i", "ku_i", "sk_x", "ku_x"]
        for name in moments:
            n = valid_counts(table, name[-1])
            multi = pa.array(n >= 2)
            assert_tables(got.select([name]).filter(multi),
                          want.select([name]).filter(multi))
            one = got.column(name).to_numpy(zero_copy_only=False)[n == 1]
            assert np.isnan(one).all()
        others = [c for c in got.column_names if c not in moments]
        assert_tables(got.select(others), want.select(others))
        rows = got.to_pylist()
        assert [r["sds_i"] for r in rows[40:44]] == [None] * 4  # n <= 1
        assert rows[43]["var_i"] is None and rows[43]["ci"] == 0
        assert rows[40]["var_i"] == 0.0

    def test_global_aggregate_and_empty_input_match_jax(self, table):
        """No group keys, over the table and over no rows."""
        for t in (table, table.slice(0, 0)):
            def q(sess, m):
                c = m.col
                return sess.from_arrow(t).agg(
                    v=m.VarianceSamp(c("i")), k=m.Kurtosis(c("x")),
                    ci=m.CountIf(c("b")), bo=m.BoolOr(c("b")),
                    bx=m.BitXorAgg(c("l")), mx=m.Max(c("s")),
                    f=m.First(c("u"), True))
            assert_tables(q(TpuSession(BASE, device="cpu"), PE).collect(),
                          q(JaxSession(BASE), JE).collect(),
                          {"k": (1e-9, 1e-9)})

    def test_variance_against_numpy(self, table):
        """The JAX moment form: sample variance null at n <= 1, NaN where
        a double is NaN, against numpy's var over the same rows."""
        got = TpuSession(BASE, device="cpu").from_arrow(table).group_by(
            "g").agg(v=PE.VarianceSamp(PE.col("x")),
                     p=PE.VariancePop(PE.col("i"))).collect().sort_by("g")
        g = table.column("g").to_numpy()
        x, i = (table.column(n).to_numpy(zero_copy_only=False)
                for n in ("x", "i"))
        valid = ~table.column("x").is_null().to_numpy(zero_copy_only=False)
        for k, (v, p) in enumerate(zip(got.column("v").to_pylist(),
                                       got.column("p").to_pylist())):
            xs, iv = x[(g == k) & valid], i[(g == k) & valid]
            if len(xs) <= 1:
                assert v is None
            elif np.isnan(xs).any():
                assert np.isnan(v)
            else:
                assert v == pytest.approx(np.var(xs, ddof=1), rel=1e-9)
            assert (p is None) == (len(iv) == 0)
            if len(iv):
                assert p == pytest.approx(np.var(iv.astype(float)),
                                          rel=1e-9, abs=1e-9)


# --------------------------------------------------------------------------
def windows(m):
    """First/Last (with and without ignore nulls) over ROWS frames
    bounded, running and unbounded and the default RANGE frame, and string
    MIN/MAX over running and whole-partition frames."""
    c, W, R = m.col, m.WindowAggregate, m.RowFrame
    return dict(
        f_run=W(m.First(c("x")), R(None, 0)),
        l_run=W(m.Last(c("s")), R(None, 0)),
        f_b=W(m.First(c("s")), R(-2, 1)),
        l_b=W(m.Last(c("x"), True), R(-3, 2)),
        f_in=W(m.First(c("i"), True), R(1, 4)),
        l_all=W(m.Last(c("y"), True), R(None, None)),
        f_rng=W(m.First(c("i"), True)),
        l_rng=W(m.Last(c("i"))),
        min_s=W(m.Min(c("s")), R(None, 0)),
        max_s=W(m.Max(c("s")), R(None, None)),
        max_sr=W(m.Max(c("s"))))


@pytest.mark.parametrize("batch_rows", [1024, 128])
def test_window_frames_match_jax(table, batch_rows):
    """The window over one batch and over six (concatenated first), by
    (g) ordered by (i, k) ascending, nulls first: k, the row's position,
    breaks ties so that First/Last are determined. (The JAX planner sends
    a window over a decimal of more than 18 digits to its CPU engine,
    which fails on limbs, so `d` is left out here.)"""
    t = table.drop(["d"]).append_column(
        "k", pa.array(np.arange(table.num_rows)))

    def q(sess, m):
        return sess.from_arrow(t).window(["g"], ["i", "k"], **windows(m))
    conf = dict(BASE, **{"spark.rapids.sql.batchSizeRows": batch_rows})
    got = q(TpuSession(conf, device="cpu"), PE).collect()
    jdf = q(JaxSession(conf), JE)
    # the JAX device engine over one batch, its CPU engine (the oracle of
    # its own window tests) over six
    want = jdf.collect() if batch_rows >= table.num_rows else \
        jdf.collect_cpu()
    assert_tables(got, want, {})


def test_window_gathers_decimal128_limbs(table):
    """Limb rows through the window's gathers (First/Last ignoring nulls,
    Lead with a default, Lag), against a Python oracle (see above: the
    JAX engine has none)."""
    lit = decimal.Decimal("1.5")
    t = table.append_column("k", pa.array(np.arange(table.num_rows)))
    c, W = PE.col, PE.WindowAggregate
    got = TpuSession(BASE, device="cpu").from_arrow(t).window(
        ["g"], ["k"], f=W(PE.First(c("d"), True)),
        la=W(PE.Last(c("d"), True), PE.RowFrame(-1, 1)),
        ld=PE.Lead(c("d"), 1, lit), lg=PE.Lag(c("d"), 2)).collect()
    rows = got.to_pylist()
    parts = {}
    for r in rows:
        parts.setdefault(r["g"], []).append(r)
    for part in parts.values():
        assert [r["k"] for r in part] == sorted(r["k"] for r in part)
        ds = [r["d"] for r in part]
        for j, r in enumerate(part):
            seen = [v for v in ds[:j + 1] if v is not None]
            near = [v for v in ds[max(j - 1, 0):j + 2] if v is not None]
            assert r["f"] == (seen[0] if seen else None)
            assert r["la"] == (near[-1] if near else None)
            assert r["ld"] == (ds[j + 1] if j + 1 < len(ds) else lit)
            assert r["lg"] == (ds[j - 2] if j >= 2 else None)
