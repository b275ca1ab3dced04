"""Scan pushdown of spark_rapids_tpu_torch (`plan/scan_pushdown.py`, the
pushdown programs of `io/parquet_device.py`) against itself with pushdown
off and against the JAX engine with pushdown on, on the CPU.

The rows of every query equal with pushdown on and off and the JAX
engine's with it on: over dictionary and PLAIN pages (the compressed-form
select and gather), with a residual filter and a renamed projection, the
aggregate rewrite (and none for a float sum or under ANSI), and on every
decode path that takes the exact applier instead: v2 pages (the row
group decoded by pyarrow), lz4 (the file by pyarrow), `filters=` and the
three reader strategies. The row groups pruned equal the JAX engine's,
strings never prune, and where the port departs on purpose (a NaN item
of IN keeps its row group: the port's IN matches NaN, Spark's rule) its
pushed rows equal its unpushed ones. A string predicate that differs only
past byte 256 compares whole strings. Off, the plan and every counter
are as without the pass.

Tolerance: exact."""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.basic import TpuFilterExec
from spark_rapids_tpu_torch.io import parquet_device as PD
from spark_rapids_tpu_torch.io.scanbase import TpuFileScanExec
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plan.scan_pushdown import PushedAgg, \
    ScanPushdown
from spark_rapids_tpu_torch.plugin import TpuSession
from spark_rapids_tpu_torch.utils.metrics import TaskMetrics

PD_KEY = "spark.rapids.tpu.scan.pushdown.enabled"
BASE = {"spark.rapids.sql.explain": "NONE"}
ON = dict(BASE, **{PD_KEY: True})


def _mk_table(n=2000):
    """The JAX test's table: ints with nulls, a float with nulls, short
    strings, decimals, booleans, dates, a null-heavy column."""
    rng = np.random.default_rng(7)
    return pa.table({
        "i32": pa.array([None if i % 13 == 0 else int(i % 500 - 250)
                         for i in range(n)], pa.int32()),
        "i64": pa.array(range(n), pa.int64()),
        "f64": pa.array([None if i % 17 == 0 else float(i) * 0.25
                         for i in range(n)], pa.float64()),
        "s": pa.array([None if i % 11 == 0 else f"val{i % 23:02d}"
                       for i in range(n)]),
        "dec": pa.array([decimal.Decimal(int(v)).scaleb(-2) for v in
                         rng.integers(-10**6, 10**6, n)],
                        pa.decimal128(10, 2)),
        "flag": pa.array([bool(i % 3 == 0) for i in range(n)]),
        "d": pa.array([int(i % 1000) for i in range(n)], pa.date32()),
        "nullheavy": pa.array([None if i % 4 != 0 else int(i)
                               for i in range(n)], pa.int64()),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pd")
    t = _mk_table()
    out = {}
    for name, kw in (("dict", {}), ("plain", {"use_dictionary": False}),
                     ("v2", {"data_page_version": "2.0"}),
                     ("lz4", {"compression": "lz4"})):
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(t, out[name], row_group_size=500, **kw)
    out["many"] = []
    for i in range(3):
        p = str(d / f"m{i}.parquet")
        pq.write_table(t.slice(i * 200, 200), p, row_group_size=100)
        out["many"].append(p)
    return out


def _dec(E, types, s):
    return E.lit(decimal.Decimal(s), types.DecimalType(10, 2))


def _queries(E, types):
    """The JAX test's queries, for either engine's constructors."""
    c, lit = E.col, E.lit
    return {
        "sel0": lambda df: df.filter(c("i64") < lit(-1)),
        "sel1": lambda df: df.filter(c("i64") < lit(20)),
        "sel50": lambda df: df.filter(c("i64") < lit(1000)),
        "sel100": lambda df: df.filter(c("i64") >= lit(0)),
        "str_eq": lambda df: df.filter(c("s") == lit("val07")),
        "in_list": lambda df: df.filter(E.In(c("i32"), [1, 2, 3, 200])),
        "null_check": lambda df: df.filter(E.IsNotNull(c("nullheavy"))
                                           & E.IsNull(c("s"))),
        "or_tree": lambda df: df.filter((c("i64") < lit(100))
                                        | (c("s") == lit("val03"))),
        "project": lambda df: df.filter(c("i64") < lit(300))
        .select("s", "i64", "f64"),
        "residual": lambda df: df.filter((c("i64") < lit(500))
                                         & (c("i64") + lit(0) < lit(400))),
        "flag_dec": lambda df: df.filter(c("flag") == lit(True))
        .select("i64", "dec", "d"),
        "dec_date_pred": lambda df: df.filter(
            (c("dec") < _dec(E, types, "1.50"))
            & (c("d") >= lit(100, types.DATE))),
        "float_range": lambda df: df.filter((c("f64") > lit(10.0))
                                            & (c("f64") <= lit(99.5))),
        "renamed": lambda df: df.select(k=c("i64"), t=c("s"))
        .filter(c("k") < lit(50)),
    }


PORT_Q, JAX_Q = _queries(PE, T), _queries(JE, JT)


def _sorted(t):
    return t.sort_by([(n, "ascending") for n in
                      (("i64",) if "i64" in t.column_names else
                       ("k",) if "k" in t.column_names else
                       t.column_names)])


def _port(conf, path, name, **opts):
    paths = path if isinstance(path, list) else [path]
    return _sorted(PORT_Q[name](TpuSession(conf, device="cpu")
                                .read_parquet(*paths, **opts)).collect())


def _jax(path, name):
    paths = path if isinstance(path, list) else [path]
    return _sorted(JAX_Q[name](JaxSession(ON).read_parquet(*paths))
                   .collect())


def _same(a, b):
    """Equal tables, NaN equal to NaN."""
    def values(t, n):
        return ["NaN" if isinstance(v, float) and v != v else v
                for v in t.column(n).to_pylist()]
    assert a.column_names == b.column_names
    assert a.num_rows == b.num_rows
    for n in a.column_names:
        assert values(a, n) == values(b, n), n


# the queries also held against the JAX engine with pushdown on (its
# device decode compiles a program a query, so not every one)
JAX_CHECKED = {"dict": ("sel1", "str_eq", "dec_date_pred", "renamed"),
               "plain": ("or_tree",)}


@pytest.mark.parametrize("name", list(PORT_Q))
def test_dict_pages(files, name):
    on = _port(ON, files["dict"], name)
    _same(on, _port(BASE, files["dict"], name))
    if name in JAX_CHECKED["dict"]:
        _same(on, _jax(files["dict"], name))


@pytest.mark.parametrize("name", ["sel1", "str_eq", "in_list",
                                  "null_check", "or_tree", "flag_dec",
                                  "dec_date_pred"])
def test_plain_pages(files, name):
    on = _port(ON, files["plain"], name)
    _same(on, _port(BASE, files["plain"], name))
    if name in JAX_CHECKED["plain"]:
        _same(on, _jax(files["plain"], name))


def test_the_select_and_gather_ran(files):
    """Dictionary and PLAIN pages take the compressed-form path: one
    packed dispatch a group, only survivors materialised."""
    for f in ("dict", "plain"):
        PD.COUNTERS.reset()
        TaskMetrics.reset()
        s = TpuSession(ON, device="cpu")
        out = s.read_parquet(files[f]).filter(PE.col("i64") < PE.lit(20)) \
            .select("i64").collect()
        assert out.num_rows == 20
        assert PD.COUNTERS.snapshot()["fused_dispatches"] == 1
        assert TaskMetrics.get().scan_bytes_materialized == 128 * 9
        assert TaskMetrics.get().scan_rowgroups_pruned == 3


@pytest.mark.parametrize("form", ["v2", "lz4", "filters", "many"])
def test_host_decode_paths(files, form):
    """Batches pyarrow decodes go through the exact applier."""
    path = files["v2" if form == "filters" else form]
    opts = {"filters": [("i64", "<", 1500)]} if form == "filters" else {}
    for name in ("sel50", "or_tree", "project", "renamed"):
        on = _port(ON, path, name, **opts)
        _same(on, _port(BASE, path, name, **opts))
        if form in ("v2", "lz4") and name == "or_tree":
            _same(on, _jax(path, name))


@pytest.mark.parametrize("reader", ["PERFILE", "COALESCING",
                                    "MULTITHREADED"])
def test_reader_strategies(files, reader):
    conf = {"spark.rapids.sql.format.parquet.deviceDecode.enabled": False,
            "spark.rapids.sql.format.parquet.reader.type": reader}
    for name in ("sel1", "null_check", "renamed"):
        _same(_port(dict(ON, **conf), files["many"], name),
              _port(dict(BASE, **conf), files["many"], name))
    q = TpuSession(dict(ON, **conf), device="cpu") \
        .read_parquet(*files["many"]).agg(n=PE.Count(),
                                          sm=PE.Sum(PE.col("i64")))
    assert q.collect().to_pydict() == {"n": [600], "sm": [599 * 600 // 2]}


def _plan(conf, df):
    return Overrides(TpuConf(conf), "cpu").apply(df.plan)


def test_planner_shapes(files):
    s = TpuSession(ON, device="cpu")
    df = s.read_parquet(files["dict"])
    plan = _plan(ON, df.filter(PE.col("i64") < PE.lit(10)))
    assert isinstance(plan, TpuFileScanExec)
    assert plan.pushed.predicate is not None
    plan = _plan(ON, df.filter((PE.col("i64") < PE.lit(10))
                               & (PE.col("i64") + PE.lit(0) < PE.lit(5))))
    assert isinstance(plan, TpuFilterExec)
    assert plan.children[0].pushed is not None
    plan = _plan(ON, df.select(k=PE.col("i64"), s=PE.col("s"))
                 .filter(PE.col("k") < PE.lit(50)))
    assert plan.pushed.columns == (("k", "i64"), ("s", "s"))
    assert plan.output.names == ("k", "s")
    plan = _plan(ON, df.filter(PE.col("i64") < PE.lit(100))
                 .agg(n=PE.Count(), sm=PE.Sum(PE.col("i64"))))
    assert isinstance(plan, TpuHashAggregateExec)
    assert tuple(a.op for a in plan.children[0].pushed.aggs) == \
        ("count", "sum")
    for extra, agg in (({}, PE.Sum(PE.col("f64"))),
                       ({}, PE.Sum(PE.col("dec"))),
                       ({"spark.sql.ansi.enabled": True},
                        PE.Sum(PE.col("i64")))):
        conf = dict(ON, **extra)
        plan = _plan(conf, TpuSession(conf, device="cpu")
                     .read_parquet(files["dict"]).agg(sm=agg))
        scan = plan.children[0]
        assert scan.pushed is None or not scan.pushed.aggs


def test_off_plan_and_counters_untouched(files):
    s = TpuSession(BASE, device="cpu")
    q = s.read_parquet(files["dict"]).filter(PE.col("i64") < PE.lit(10))
    plan = _plan(BASE, q)
    assert isinstance(plan, TpuFilterExec)
    scan = plan.children[0]
    assert "pushed" not in vars(scan) and "rows_pruned" not in vars(scan)
    assert scan.pushed is None
    assert q.explain() == plan.tree_string()
    TaskMetrics.reset()
    q.collect()
    tm = TaskMetrics.get()
    assert (tm.scan_rows_pruned, tm.scan_bytes_materialized,
            tm.scan_rowgroups_pruned) == (0, 0, 0)


def test_spec_repr_names_every_parameter():
    a = ScanPushdown(PE.col("x") < PE.lit(1), (("y", "x"),),
                     (PushedAgg("min", "x", "m"),))
    b = ScanPushdown(PE.col("x") < PE.lit(2), (("y", "x"),),
                     (PushedAgg("min", "x", "m"),))
    c = ScanPushdown(PE.col("x") < PE.lit(1), (("y", "x"),),
                     (PushedAgg("max", "x", "m"),))
    assert len({repr(a), repr(b), repr(c)}) == 3


def _pruned(path, cond):
    """The port's pushed rows and the row groups its scan pruned."""
    TaskMetrics.reset()
    out = TpuSession(ON, device="cpu").read_parquet(path).filter(cond) \
        .collect()
    return out, TaskMetrics.get().scan_rowgroups_pruned


def _jax_pruned(path, cond) -> int:
    """The JAX scan's count, from its pruning function over the footer
    (what its scan adds to scan_rowgroups_pruned)."""
    from spark_rapids_tpu.io.dynamic_pruning import schema_col_index
    from spark_rapids_tpu.plan.scan_pushdown import prune_row_groups
    meta = pq.ParquetFile(path).metadata
    scan = JaxSession(ON).read_parquet(path).plan
    return len(prune_row_groups(meta, schema_col_index(meta), scan.output,
                                cond))


def test_rowgroups_pruned_equal_jax(tmp_path):
    t = pa.table({"i64": pa.array(range(5000), pa.int64()),
                  "s": pa.array([f"x{i % 9}" for i in range(5000)]),
                  "k": pa.array([f"k{i:04d}" for i in range(5000)])})
    p = str(tmp_path / "rg.parquet")
    pq.write_table(t, p, row_group_size=500)
    cases = [(lambda E: E.col("i64") < E.lit(400), 9),
             (lambda E: (E.col("i64") >= E.lit(1200))
              & (E.col("i64") < E.lit(2100)), 7),
             (lambda E: E.lit(4600) <= E.col("i64"), 9),
             (lambda E: E.In(E.col("i64"), [3, 4444]), 8),
             (lambda E: E.IsNull(E.col("i64")), 10),
             (lambda E: E.col("k") == E.lit("k0900"), 0),  # strings: never
             (lambda E: E.col("i64") < E.lit(-5), 10)]
    for cond, want in cases:
        got, n = _pruned(p, cond(PE))
        assert n == _jax_pruned(p, cond(JE)) == want
        _same(_sorted(got), _sorted(TpuSession(BASE, device="cpu")
                                     .read_parquet(p).filter(cond(PE))
                                     .collect()))
    jout = JaxSession(ON).read_parquet(p).filter(
        JE.col("i64") < JE.lit(400)).collect()
    _same(_sorted(jout), _sorted(_pruned(p, PE.col("i64") < PE.lit(400))[0]))


def test_nan_in_keeps_its_row_group(tmp_path):
    """The only NaN sits in row group 2. The port's IN matches NaN (Spark's
    rule), so its pushed scan keeps every row group (min/max cannot show
    where a NaN is) and returns the unpushed plan's rows; the JAX IN
    compares with == and prunes the three without 50.0."""
    vals = np.arange(400, dtype=np.float64)
    vals[250] = np.nan
    t = pa.table({"f": pa.array(vals), "i": pa.array(np.arange(400))})
    p = str(tmp_path / "nan.parquet")
    pq.write_table(t, p, row_group_size=100)
    cond = PE.In(PE.col("f"), [float("nan"), 50.0])
    on, n = _pruned(p, cond)
    off = TpuSession(BASE, device="cpu").read_parquet(p).filter(cond) \
        .collect()
    _same(_sorted(on), _sorted(off))
    assert sorted(on.column("i").to_pylist()) == [50, 250]
    # min/max do not show NaN rows: a NaN item keeps every row group
    jn = _jax_pruned(p, JE.In(JE.col("f"), [float("nan"), 50.0]))
    assert (n, jn) == (0, 3)
    _, n = _pruned(p, PE.In(PE.col("f"), [50.0, 120.0]))
    assert n == _jax_pruned(p, JE.In(JE.col("f"), [50.0, 120.0])) == 2
    # > and >= over floats never prune (a NaN row is above any number)
    _, n = _pruned(p, PE.col("f") > PE.lit(1000.0))
    assert n == _jax_pruned(p, JE.col("f") > JE.lit(1000.0)) == 0


def test_long_string_predicate_compares_whole_strings(tmp_path):
    """Strings of 300 bytes sharing their first 256: a pushed equality
    must compare past the head. Past headWidth the decode builds the
    long-string layout, which the compressed-form path declines; the
    applier's comparison over it reruns the plan on the host, as the
    unpushed filter's does."""
    head = "a" * 256
    vals = [head + f"{i:03d}" + "z" * 41 for i in range(600)]
    t = pa.table({"s": pa.array(vals), "i": pa.array(np.arange(600))})
    p = str(tmp_path / "long.parquet")
    pq.write_table(t, p, row_group_size=200)
    want = head + "123" + "z" * 41
    outs = []
    for conf in (ON, BASE):
        TaskMetrics.reset()
        outs.append(TpuSession(conf, device="cpu").read_parquet(p)
                    .filter(PE.col("s") == PE.lit(want)).collect())
        assert TaskMetrics.get().cpu_fallback_reruns == 1
    _same(outs[0], outs[1])
    assert outs[0].column("i").to_pylist() == [123]
    jout = JaxSession(ON).read_parquet(p) \
        .filter(JE.col("s") == JE.lit(want)).collect()
    assert jout.column("i").to_pylist() == [123]


def test_short_string_predicate_on_the_compressed_form(tmp_path):
    """Within the head width a string leaf is tested once per dictionary
    value over its whole bytes (values differing in their last byte)."""
    vals = [f"{'b' * 60}{i % 7}" for i in range(700)]
    t = pa.table({"s": pa.array(vals), "i": pa.array(np.arange(700))})
    p = str(tmp_path / "short.parquet")
    pq.write_table(t, p, row_group_size=350)
    PD.COUNTERS.reset()
    out = TpuSession(ON, device="cpu").read_parquet(p) \
        .filter(PE.col("s") >= PE.lit("b" * 60 + "5")).collect()
    assert PD.COUNTERS.snapshot()["fused_dispatches"] == 1
    assert sorted(out.column("i").to_pylist()) == \
        [i for i in range(700) if i % 7 >= 5]


class TestAggregatePushdown:
    def test_materialises_no_rows(self, files):
        TaskMetrics.reset()
        out = TpuSession(ON, device="cpu").read_parquet(files["dict"]) \
            .filter(PE.col("i64") >= PE.lit(100)) \
            .agg(n=PE.Count(), nn=PE.Count(PE.col("nullheavy")),
                 mn=PE.Min(PE.col("i64")), mx=PE.Max(PE.col("i64")),
                 sm=PE.Sum(PE.col("i32"))).collect()
        assert TaskMetrics.get().scan_bytes_materialized == 0
        assert out.column("n").to_pylist() == [1900]
        assert out.column("mn").to_pylist() == [100]
        assert out.column("mx").to_pylist() == [1999]

    @pytest.mark.parametrize("path", ["dict", "plain", "v2", "lz4"])
    def test_matches_off_and_jax(self, files, path):
        def q(s, E):
            return s.read_parquet(files[path]).filter(
                E.col("i64") < E.lit(700)).agg(
                n=E.Count(), nn=E.Count(E.col("s")), mn=E.Min(E.col("d")),
                mx=E.Max(E.col("i32")), sm=E.Sum(E.col("i64")),
                fl=E.Max(E.col("flag")))
        on = q(TpuSession(ON, device="cpu"), PE).collect()
        _same(on, q(TpuSession(BASE, device="cpu"), PE).collect())
        if path in ("dict", "v2"):
            _same(on, q(JaxSession(ON), JE).collect())

    def test_empty_input_partials(self, files):
        def q(s, E):
            return s.read_parquet(files["dict"]).filter(
                E.col("i64") < E.lit(-5)).agg(
                n=E.Count(), mn=E.Min(E.col("i64")), sm=E.Sum(E.col("i64")))
        on = q(TpuSession(ON, device="cpu"), PE).collect()
        _same(on, q(TpuSession(BASE, device="cpu"), PE).collect())
        _same(on, q(JaxSession(ON), JE).collect())
        assert on.to_pydict() == {"n": [0], "mn": [None], "sm": [None]}

    def test_long_sum_wraps_as_unpushed(self, tmp_path):
        t = pa.table({"v": pa.array([2 ** 62] * 5 + [7], pa.int64())})
        p = str(tmp_path / "big.parquet")
        pq.write_table(t, p, row_group_size=2)
        got = [TpuSession(c, device="cpu").read_parquet(p)
               .agg(s=PE.Sum(PE.col("v"))).collect().column("s").to_pylist()
               for c in (ON, BASE)]
        # 5 x 2^62 + 7 wraps past 2^64, in the partials and the merge
        assert got[0] == got[1] == [2 ** 62 + 7]


def test_pushdown_beside_dynamic_pruning(tmp_path):
    """A probe scan with a pushed predicate and a dynamic-pruning filter
    from a broadcast join: both apply, the join stays unfused (as in the
    JAX engine: it fills the filter before its probe scan starts), and
    the rows equal the plan without pushdown."""
    t = pa.table({"k": pa.array(np.arange(4000) // 100),
                  "v": pa.array(np.arange(4000))})
    p = str(tmp_path / "probe.parquet")
    pq.write_table(t, p, row_group_size=500)
    dim = pa.table({"k": pa.array([3, 25, 31]), "w": pa.array([1, 2, 3])})
    outs = []
    for conf in (ON, BASE):
        s = TpuSession(dict(conf, **{
            "spark.rapids.sql.dynamicFilePruning.enabled": True,
            "spark.rapids.tpu.fusion.enabled": True}), device="cpu")
        q = s.read_parquet(p).filter(PE.col("v") >= PE.lit(1000)) \
            .join(s.from_arrow(dim), on="k")
        tree = q.explain()
        assert "TpuBroadcastHashJoinExec" in tree
        assert "TpuFusedStageExec" not in tree
        outs.append(_sorted(q.collect().select(["v", "w"]).rename_columns(
            ["i64", "w"])))
    _same(outs[0], outs[1])
    assert outs[0].num_rows == 200
