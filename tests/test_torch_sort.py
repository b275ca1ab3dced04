"""Sort, top-k, limit and union in spark_rapids_tpu_torch against the JAX
engine on the CPU.

The sort permutations come from the same padded buffers in both engines
(a JAX batch from Arrow, rebuilt in the port by interop.batch_from_numpy):
for every carried type, ascending and descending, nulls first and last,
the port's `sort_keys_for` + `lexsort_indices` must give JAX's
permutation exactly, ties (and -0.0 against 0.0, NaN against NaN) kept in
input order by both stable sorts. The execs run through both sessions on
one Arrow table cut into several batches.

Tolerance: exact everywhere (permutations, rows, nulls)."""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import jax.numpy as jnp

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.ops import rowops as jax_rowops
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.exec import sort as port_sort
from spark_rapids_tpu_torch.exec.base import batch_vecs
from spark_rapids_tpu_torch.ops import rowops
from spark_rapids_tpu_torch.plugin import TpuSession
from torch_port import assert_same_rows, port_batch, positional

N = 300
DIRECTIONS = [(True, True), (True, False), (False, True), (False, False)]
BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 128}


def _column(kind: str, rng) -> pa.Array:
    """N values of one type, ~10 % null, with many ties."""
    nulls = rng.random(N) < 0.1
    if kind == "bool":
        return pa.array(rng.random(N) < 0.5, mask=nulls)
    if kind in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(kind)
        vals = rng.integers(-5, 5, N).astype(kind)
        vals[:4] = [info.min, info.max, 0, -1]
        return pa.array(vals, mask=nulls)
    if kind in ("float32", "float64"):
        pool = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5,
                         2.25, -7.0, 1e-30], dtype=kind)
        return pa.array(pool[rng.integers(0, len(pool), N)], mask=nulls)
    if kind == "date":
        days = rng.integers(-400, 400, N).astype(np.int32)
        return pa.array(days, type=pa.int32(), mask=nulls).cast(pa.date32())
    if kind == "timestamp":
        us = rng.integers(-3, 3, N) * 86_400_000_000 + rng.integers(0, 5, N)
        return pa.array(us, type=pa.int64(), mask=nulls).cast(
            pa.timestamp("us", tz="UTC"))
    if kind.startswith("decimal"):
        p, s = (7, 2) if kind == "decimal(7,2)" else (18, 4)
        unscaled = rng.integers(-10 ** (p - 1), 10 ** (p - 1), N)
        unscaled[::3] = rng.integers(-3, 3, len(unscaled[::3]))
        import decimal
        return pa.array([None if m else decimal.Decimal(int(u)).scaleb(-s)
                         for u, m in zip(unscaled, nulls)],
                        type=pa.decimal128(p, s))
    if kind == "string":
        pool = ["", "a", "ab", "abc", "a\x00", "a\x00\x00", "b", "é",
                "éa", "日本", "日本語", "zz" * 10, "\x00", "A", "a" * 17,
                "a" * 16]
        return pa.array([None if m else pool[i] for i, m in
                         zip(rng.integers(0, len(pool), N), nulls)])
    raise ValueError(kind)


KINDS = ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
         "date", "timestamp", "decimal(7,2)", "decimal(18,4)", "string"]


@pytest.mark.parametrize("kind", KINDS)
def test_sort_permutation_matches_jax(kind):
    """Every direction and null placement, one key and a two-key order
    (the column, then its row position descending) in both engines."""
    rng = np.random.default_rng(KINDS.index(kind))
    t = pa.table({"k": _column(kind, rng)})
    jb = jax_batch_from_arrow(t)
    pb = port_batch(jb)
    jv, pv = jb.columns, batch_vecs(pb)[0]
    from spark_rapids_tpu.expr.base import Vec as JVec
    jvec = JVec(jv[0].dtype, jv[0].data, jv[0].validity, jv[0].lengths)
    jmask, pmask = jb.row_mask(), pb.row_mask()
    for asc, nf in DIRECTIONS:
        want = np.asarray(jax_rowops.lexsort_indices(
            jnp, [[(~jmask).astype(np.int8)],
                  jax_rowops.sort_keys_for(jnp, jvec, asc, nf)],
            jb.capacity))
        got = rowops.lexsort_indices(
            [[(~pmask).to(rowops.torch.int8)],
             rowops.sort_keys_for(pv, asc, nf)]).numpy()
        assert np.array_equal(got, want), (kind, asc, nf)
    # sort_batch_vecs: every column gathered by the same permutation
    out = rowops.sort_batch_vecs(batch_vecs(pb), [0], [False], [False],
                                 pmask)
    jout = jax_rowops.sort_batch_vecs(jnp, [jvec], [0], [False], [False],
                                      jmask)
    assert np.array_equal(out[0].validity.numpy(),
                          np.asarray(jout[0].validity))


def _table(n=1000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.05),
        "d": pa.array(rng.choice([np.nan, -0.0, 0.0, 1.0, -2.5], n)),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 30, n)],
                      mask=rng.random(n) < 0.05),
        "id": np.arange(n, dtype=np.int64),
    })


def _both(conf, build):
    """build(session, namespace) in both engines; returns (jax df, port
    df)."""
    return build(JaxSession(conf), JE), \
        build(TpuSession(conf, device="cpu"), PE)


def _assert_same(jdf, pdf):
    assert_same_tables(jdf.collect(), pdf.collect())


def assert_same_tables(want: pa.Table, got: pa.Table):
    """Row for row equality of two results, NaN equal to NaN and -0.0 to
    0.0 (the sort orders them as equal)."""
    want, got = positional(want), positional(got)
    assert want.schema == got.schema, (want.schema, got.schema)
    assert want.num_rows == got.num_rows
    for name in want.column_names:
        a = want.column(name).to_pylist()
        b = got.column(name).to_pylist()
        same = [x == y or (x != x and y != y) for x, y in zip(a, b)]
        assert all(same), f"{name} differs at row {same.index(False)}"


ORDERS = [("k", True, True), ("d", False, False), ("s", False, True),
          ("id", True, True)]


class TestSortExec:
    def test_in_core(self):
        """Several batches of at most batchSizeRows in total: one sort of
        the concatenated batch."""
        t = _table(200)

        def q(sess, m):
            return sess.from_arrow(t).sort(*ORDERS)
        jdf, pdf = _both(dict(BASE, **{
            "spark.rapids.sql.batchSizeRows": 256}), q)
        port_sort.COUNTERS.reset()
        _assert_same(jdf, pdf)
        snap = port_sort.COUNTERS.snapshot()
        assert (snap["in_core"], snap["out_of_core"]) == (1, 0)

    @pytest.mark.parametrize("rows", [128, 100])
    def test_out_of_core(self, rows):
        """More rows than batchSizeRows over several batches: runs sorted on
        the device, keys merged on the host, chunks of batchSizeRows."""
        t = _table()

        def q(sess, m):
            return sess.from_arrow(t).sort(*ORDERS)
        conf = dict(BASE, **{"spark.rapids.sql.batchSizeRows": rows})
        jdf, pdf = _both(conf, q)
        port_sort.COUNTERS.reset()
        _assert_same(jdf, pdf)
        snap = port_sort.COUNTERS.snapshot()
        assert snap["out_of_core"] == 1 and snap["in_core"] == 0
        assert snap["host_merge_s"] > 0
        batches = list(TpuSession(conf, device="cpu").plan_device(
            pdf.plan).execute())
        assert [b.row_count() for b in batches] == \
            [rows] * (1000 // rows) + ([1000 % rows] if 1000 % rows else [])

    def test_each_batch(self):
        t = _table(300)
        jb = [jax_batch_from_arrow(t.slice(o, 100)) for o in (0, 100, 200)]
        from torch_port import JaxSource, PortSource
        from spark_rapids_tpu.exec.sort import TpuSortExec as JSort
        j = JSort([(JE.col("s"), False, True), (JE.col("id"), True, True)],
                  JaxSource(jb), each_batch=True)
        p = port_sort.TpuSortExec(
            [(PE.col("s"), False, True), (PE.col("id"), True, True)],
            PortSource([port_batch(b) for b in jb]), each_batch=True)
        assert_same_rows(list(j.execute()), list(p.execute()))

    def test_expression_keys_and_the_default_null_order(self):
        t = _table(400)

        def q(sess, m):
            return sess.from_arrow(t).sort(m.col("k") % m.lit(7), "id",
                                           ascending=False)
        _assert_same(*_both(BASE, q))


class TestTopKLimitUnion:
    @pytest.mark.parametrize("k,offset", [(5, 7), (300, 0), (200, 150)])
    def test_top_k(self, k, offset):
        """k below and above a batch (128 rows), with and without an
        offset: the plan is a top-k in both engines."""
        t = _table()

        def q(sess, m):
            return sess.from_arrow(t).sort(*ORDERS).limit(k, offset=offset)
        jdf, pdf = _both(BASE, q)
        assert pdf.explain().startswith("TpuTopKExec")
        _assert_same(jdf, pdf)
        assert pdf.collect().num_rows == min(k, max(1000 - offset, 0))

    @pytest.mark.parametrize("conf", [
        {"spark.rapids.sql.topK.enabled": False},
        {"spark.rapids.sql.topK.threshold": 9}])
    def test_limit_over_sort_without_top_k(self, conf):
        t = _table()
        conf = dict(BASE, **conf)

        def q(sess, m):
            return sess.from_arrow(t).sort(*ORDERS).limit(10, offset=3)
        jdf, pdf = _both(conf, q)
        jplan = JaxOverrides(jdf.session.conf).apply(jdf.plan).tree_string()
        assert _shape(pdf.explain()) == _shape(jplan) == [
            (0, "TpuLimitExec"), (2, "TpuSortExec"), (4, "TpuScanExec")]
        _assert_same(jdf, pdf)

    def test_limit_with_offset_across_batches(self):
        t = _table()

        def q(sess, m):
            return sess.from_arrow(t).limit(300, offset=250)
        jdf, pdf = _both(BASE, q)
        _assert_same(jdf, pdf)
        assert pdf.collect().column("id").to_pylist() == \
            list(range(250, 550))

    def test_union(self):
        t, u = _table(300, seed=4), _table(200, seed=5)

        def q(sess, m):
            a = sess.from_arrow(t).filter(m.col("k") > m.lit(10))
            return a.union(sess.from_arrow(u)).limit(400, offset=5)
        jdf, pdf = _both(BASE, q)
        assert _shape(pdf.explain()) == [
            (0, "TpuLimitExec"), (2, "TpuUnionExec"), (4, "TpuFilterExec"),
            (6, "TpuScanExec"), (4, "TpuScanExec")]
        _assert_same(jdf, pdf)

    def test_sort_over_the_distributed_aggregate(self):
        """Sort takes every shard's batches: the top-k over the final
        aggregate of the distributed plan, against a Python oracle."""
        t = _table()
        conf = dict(BASE, **{"spark.rapids.shuffle.mode": "ICI",
                             "spark.rapids.tpu.mesh.shape": "shuffle=4"})
        pdf = TpuSession(conf, device="cpu").from_arrow(t).group_by("s") \
            .agg(n=PE.Count(PE.lit(1)), top=PE.Max(PE.col("id"))) \
            .sort(("n", False, False), "s").limit(12)
        plan = pdf.explain().splitlines()
        assert plan[0].startswith("TpuTopKExec")
        assert plan[1].strip().startswith("TpuHashAggregateExec[final")
        groups = {}
        for s, i in zip(t.column("s").to_pylist(),
                        t.column("id").to_pylist()):
            n, top = groups.get(s, (0, -1))
            groups[s] = (n + 1, max(top, i))
        # n descending, then s ascending with the null group first
        want = sorted(groups.items(), key=lambda kv: (
            -kv[1][0], kv[0] is not None, kv[0] or ""))[:12]
        got = pdf.collect().to_pydict()
        assert list(zip(got["s"], got["n"], got["top"])) == \
            [(s, n, top) for s, (n, top) in want]

    def test_union_of_different_types_raises(self):
        sess = TpuSession(BASE, device="cpu")
        a = sess.from_arrow(pa.table({"x": pa.array([1], pa.int64())}))
        b = sess.from_arrow(pa.table({"x": pa.array([1.0])}))
        with pytest.raises(NotImplementedError, match="union"):
            a.union(b).explain()


MESH = dict(BASE, **{"spark.rapids.shuffle.mode": "ICI",
                     "spark.rapids.tpu.mesh.shape": "shuffle=4",
                     "spark.rapids.tpu.fusion.enabled": True})


@pytest.mark.parametrize("conf", [BASE, MESH], ids=["one_device",
                                                    "distributed"])
@pytest.mark.parametrize("query", ["top_k", "window_top_k", "union_limit"])
def test_plans_match_jax(conf, query):
    """The device plan's tree (node names and depths) as the JAX engine
    plans it: sort, top-k, limit, union and window stay out of fusion
    chains and the distribution pass leaves them as they are."""
    t = _table(300)

    def q(sess, m):
        agg = sess.from_arrow(t).filter(m.col("k") > m.lit(3)) \
            .group_by("s").agg(n=m.Count(m.lit(1)))
        if query == "top_k":
            return agg.sort(("n", False, False)).limit(5)
        if query == "window_top_k":
            return agg.window(["n"], ["s"], r=m.Rank()).sort("r", "s") \
                .limit(7, offset=1)
        return agg.union(agg).limit(9)
    jdf, pdf = _both(conf, q)
    jplan = JaxOverrides(jdf.session.conf).apply(jdf.plan).tree_string()
    assert _shape(pdf.explain()) == _shape(jplan)


def _shape(plan: str):
    return [(len(ln) - len(ln.lstrip()), ln.split("[")[0].strip())
            for ln in plan.splitlines() if ln.strip()]


def test_sort_keys_on_dates_and_strings_round_trip():
    """The dates, timestamps and strings of a sorted collect come back as
    their Arrow values."""
    t = pa.table({"d": pa.array([datetime.date(2020, 1, 3), None,
                                 datetime.date(1969, 12, 31)]),
                  "s": pa.array(["b", "a\x00", "a"])})
    out = TpuSession(BASE, device="cpu").from_arrow(t).sort(
        "d", ("s", False, False)).collect()
    assert out.column("d").to_pylist() == [None, datetime.date(1969, 12, 31),
                                          datetime.date(2020, 1, 3)]
