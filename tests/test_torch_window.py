"""Window functions in spark_rapids_tpu_torch against the JAX engine on
the CPU: every function with and without a partition and an order, ROWS
frames bounded and unbounded, the default RANGE frame, value-offset RANGE
frames over int, date and double keys (nulls, ties and NaN keys), nulls in
keys and values, and the plan-time refusals.

Both engines run the same query over the same Arrow table, cut into
several batches; the window sorts by (partition, order), and its output
order is compared row for row. Every query is held against the JAX
package's CPU engine (its plan nodes' numpy interpreter, the oracle of its
own window tests), and the one holding every function also against its
device engine, run on the CPU.

Tolerance: exact (ranks, counts, integer sums, MIN/MAX, lead/lag/nth,
strings, nulls), except DOUBLE Sum and Average, rtol 1e-9 (the two engines'
cumsums may add in another order). MIN/MAX over NaN follow Spark's order
in the port (NaN greatest) and are held to a numpy oracle; the JAX engine
propagates NaN."""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 128}
DOUBLE_SUMS = ("sum_v", "avg_v", "run_v", "avg_i", "rsum_v", "w_avg")


def _table(n=400, seed=21):
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.12
    dd = rng.choice([np.nan, -1.5, 0.0, 0.5, 2.0, 2.25, 7.0], n)
    return pa.table({
        "g": pa.array(rng.integers(0, 9, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "ts": pa.array(rng.integers(0, 30, n), mask=rng.random(n) < 0.05),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "v": pa.array(np.where(nulls, 0.0, rng.normal(0, 50, n).round(3)),
                      mask=nulls),
        "s": pa.array(list(np.array(["aa", "b", "", "cc\x00", "é", None],
                                    dtype=object)[rng.integers(0, 6, n)])),
        "dt": pa.array(rng.integers(18000, 18060, n).astype(np.int32),
                       mask=rng.random(n) < 0.05).cast(pa.date32()),
        "dd": pa.array(dd, mask=rng.random(n) < 0.05),
    })


def _windows(m, name):
    """The window queries, written once for either engine's constructors
    `m`."""
    c, W = m.col, m.WindowAggregate
    R, G = m.RowFrame, m.RangeFrame
    if name == "partition_order":
        return dict(partition_by=["g"], order_by=["ts", "i"], fns=dict(
            rn=m.RowNumber(), rk=m.Rank(), drk=m.DenseRank(),
            pr=m.PercentRank(), cd=m.CumeDist(), n3=m.NTile(3),
            n7=m.NTile(7), lead_v=m.Lead(c("v"), 1),
            lag_v=m.Lag(c("v"), 2, 0.5), lead_s=m.Lead(c("s"), 1, "zzz"),
            lag_s=m.Lag(c("s"), 1), nth=m.NthValue(c("v"), 2),
            nth_in=m.NthValue(c("v"), 2, ignore_nulls=True,
                              frame=R(-3, 3)),
            run_v=W(m.Sum(c("v"))),  # the default RANGE frame
            rsum_v=W(m.Sum(c("v")), R(None, 0)),
            cnt=W(m.Count(c("v")), R(None, 0)),
            cnt_all=W(m.Count(None), R(-2, 1)),
            min_i=W(m.Min(c("i")), R(-2, 2)),
            max_v=W(m.Max(c("v")), R(None, None)),
            avg_v=W(m.Average(c("v")), R(-1, 3)),
            sum_i=W(m.Sum(c("i")), R(1, None)),
            min_s=W(m.Min(c("s")), R(None, 0)),
            max_s=W(m.Max(c("s")), R(None, None)),
            max_run=W(m.Max(c("i")), G(None, 0)),
            min_past=W(m.Min(c("v")), R(None, -1))))
    if name == "order_only":
        return dict(partition_by=[], order_by=[(c("v"), False, False)],
                    fns=dict(rn=m.RowNumber(), rk=m.Rank(),
                             sum_i=W(m.Sum(c("i"))), lag_i=m.Lag(c("i"), 1),
                             n4=m.NTile(4)))
    if name == "partition_only":
        return dict(partition_by=["g", "s"], order_by=[], fns=dict(
            sum_v=W(m.Sum(c("v"))), cnt=W(m.Count(None)),
            min_s=W(m.Min(c("s"))), max_i=W(m.Max(c("i"))),
            avg_i=W(m.Average(c("i")))))
    if name == "neither":
        return dict(partition_by=[], order_by=[], fns=dict(
            cnt=W(m.Count(c("v"))), sum_i=W(m.Sum(c("i"))),
            max_s=W(m.Max(c("s")))))
    if name == "range_int":
        return dict(partition_by=["g"], order_by=["ts"], fns=dict(
            w_sum=W(m.Sum(c("i")), G(-3, 2)),
            w_cnt=W(m.Count(c("v")), G(None, 5)),
            w_min=W(m.Min(c("i")), G(-5, 0)),
            w_max=W(m.Max(c("v")), G(1, None)),
            w_nth=m.NthValue(c("i"), 1, frame=G(-2, 2))))
    if name == "range_date_desc":
        return dict(partition_by=["g"], order_by=[(c("dt"), False, True)],
                    fns=dict(w_sum=W(m.Sum(c("i")), G(-4, 0)),
                             w_avg=W(m.Average(c("v")), G(-2, 7))))
    if name == "range_double":
        return dict(partition_by=[], order_by=[(c("dd"), True, False)],
                    fns=dict(w_cnt=W(m.Count(c("i")), G(-0.5, 1.0)),
                             w_sum=W(m.Sum(c("i")), G(None, 0.25)),
                             w_min=W(m.Min(c("i")), G(-2.0, 0.0))))
    raise ValueError(name)


class _NS:
    def __init__(self, mod):
        self.__dict__.update({n: getattr(mod, n) for n in (
            "col lit RowNumber Rank DenseRank PercentRank CumeDist NTile "
            "Lead Lag NthValue WindowAggregate RowFrame RangeFrame Sum "
            "Count Min Max Average").split()})


JNS, PNS = _NS(JE), _NS(PE)


def _query(sess, m, name, table):
    spec = _windows(m, name)
    return sess.from_arrow(table).window(spec["partition_by"],
                                         spec["order_by"], **spec["fns"])


def _assert_rows(want: pa.Table, got: pa.Table, approx=DOUBLE_SUMS):
    assert want.schema == got.schema, (want.schema, got.schema)
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        a = want.column(name).to_pylist()
        b = got.column(name).to_pylist()
        for r, (x, y) in enumerate(zip(a, b)):
            if x is None or y is None:
                ok = x is None and y is None
            elif isinstance(x, float) and name in approx:
                ok = x == y or abs(x - y) <= 1e-9 * max(abs(x), abs(y))
            elif isinstance(x, float):
                ok = x == y or (x != x and y != y)
            else:
                ok = x == y
            assert ok, f"{name}[{r}]: JAX {x!r}, port {y!r}"


@pytest.fixture(scope="module")
def table():
    return _table()


# the JAX engine's device path compiles each window kernel (seconds on the
# CPU), so it runs the query holding every function; every query is held
# against the JAX package's CPU engine
ON_JAX_ENGINE = ("partition_order",)


@pytest.mark.parametrize("name", ["partition_order", "order_only",
                                  "partition_only", "neither", "range_int",
                                  "range_date_desc", "range_double"])
def test_window_matches_jax(table, name):
    if name != "range_double":  # MIN/MAX over NaN differ by design
        table = table.drop_columns(["dd"])
    jq = _query(JaxSession(BASE), JNS, name, table)
    port = _query(TpuSession(BASE, device="cpu"), PNS, name, table)
    assert port.explain().startswith("TpuWindowExec")
    got = port.collect()
    _assert_rows(jq.collect_cpu(), got)
    if name in ON_JAX_ENGINE:
        _assert_rows(jq.collect(), got)
    if name == "partition_order":  # the rows come back in window order
        g = got.column("g").to_pylist()
        assert g[:g.count(None)] == [None] * g.count(None)


def test_window_over_a_sort_and_a_limit(table):
    """A window's rows feed a top-k (the ordered reports' shape)."""
    def q(sess, m):
        return sess.from_arrow(table.drop_columns(["dd"])).window(
            partition_by=["g"], order_by=[(m.col("v"), True, True)],
            rk=m.Rank()).sort("g", "rk", "i").limit(25)
    port = q(TpuSession(BASE, device="cpu"), PNS)
    assert [ln.split("[")[0].strip() for ln in
            port.explain().splitlines()] == ["TpuTopKExec", "TpuWindowExec",
                                             "TpuScanExec"]
    _assert_rows(q(JaxSession(BASE), JNS).collect(), port.collect())


def test_min_max_over_nan_follow_spark():
    """NaN is the greatest value: a frame's max is NaN if it holds one, its
    min only if it holds nothing else (numpy oracle)."""
    v = [np.nan, 1.0, np.nan, np.nan, -2.0, np.nan, None, 3.0]
    t = pa.table({"g": pa.array([0, 0, 0, 1, 1, 2, 2, 2], pa.int32()),
                  "o": pa.array(np.arange(8)), "v": pa.array(v)})
    W, R = PE.WindowAggregate, PE.RowFrame
    got = TpuSession(BASE, device="cpu").from_arrow(t).window(
        ["g"], ["o"], run_min=W(PE.Min(PE.col("v")), R(None, 0)),
        run_max=W(PE.Max(PE.col("v")), R(None, 0)),
        all_min=W(PE.Min(PE.col("v")), R(None, None)),
        win_min=W(PE.Min(PE.col("v")), R(-1, 0))).collect().to_pydict()
    nan = float("nan")

    def same(a, b):
        return all(x == y or (x != x and y != y) for x, y in zip(a, b))
    assert same(got["run_min"], [nan, 1.0, 1.0, nan, -2.0, nan, nan, 3.0])
    assert same(got["run_max"], [nan, nan, nan, nan, nan, nan, nan, nan])
    assert same(got["all_min"], [1.0, 1.0, 1.0, -2.0, -2.0, 3.0, 3.0, 3.0])
    assert same(got["win_min"], [nan, 1.0, 1.0, nan, -2.0, nan, nan, 3.0])


@pytest.mark.parametrize("case", ["rank_without_order", "first_frame",
                                  "last_frame", "wide_decimal",
                                  "range_over_string", "range_two_orders",
                                  "bounded_string_min", "decimal_average"])
def test_plan_time_refusals(case):
    sess = TpuSession(BASE, device="cpu")
    W, c = PE.WindowAggregate, PE.col
    t = pa.table({"g": pa.array([1, 2], pa.int32()), "s": ["a", "b"],
                  "m": pa.array([1, 2], pa.decimal128(7, 2)),
                  "w": pa.array([1, 2], pa.decimal128(10, 2))})
    df = sess.from_arrow(t)
    fns = {
        "rank_without_order": (["g"], [], dict(r=PE.Rank())),
        "first_frame": (["g"], ["s"], dict(f=W(PE.First(c("s")),
                                               PE.RowFrame(-1, 1)))),
        "last_frame": ([], ["g"], dict(f=W(PE.Last(c("g"), True)))),
        "wide_decimal": (["g"], ["g"], dict(s=W(PE.Sum(c("w"))))),
        "range_over_string": (["g"], ["s"], dict(
            s=W(PE.Count(None), PE.RangeFrame(-1, 1)))),
        "range_two_orders": ([], ["g", "s"], dict(
            s=W(PE.Sum(c("g")), PE.RangeFrame(-1, 1)))),
        "bounded_string_min": (["g"], ["g"], dict(
            s=W(PE.Min(c("s")), PE.RowFrame(-1, 1)))),
        "decimal_average": (["g"], ["g"], dict(a=W(PE.Average(c("m"))))),
    }[case]
    if case in ("first_frame", "last_frame"):
        # First/Last frames plan since the slice that ported the aggregates
        got = df.window(fns[0], fns[1], **fns[2]).collect().column("f")
        assert got.to_pylist() == (["a", "b"] if case == "first_frame"
                                   else [1, 2])  # RANGE .. CURRENT ROW
        return
    with pytest.raises(NotImplementedError):
        df.window(fns[0], fns[1], **fns[2]).explain()


def test_sum_over_a_string_is_invalid():
    sess = TpuSession(BASE, device="cpu")
    df = sess.from_arrow(pa.table({"s": ["a"]}))
    with pytest.raises(TypeError):
        df.window([], [], x=PE.Sum(PE.col("s")))


def test_dates_in_window_output(table):
    """A date column passes through the window with its Arrow type."""
    out = TpuSession(BASE, device="cpu").from_arrow(table.slice(0, 5)) \
        .window([], ["i"], rn=PE.RowNumber()).collect()
    assert out.schema.field("dt").type == pa.date32()
    assert all(d is None or isinstance(d, datetime.date)
               for d in out.column("dt").to_pylist())
