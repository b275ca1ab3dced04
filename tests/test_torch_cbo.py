"""The cost-based optimizer and the row estimates of spark_rapids_tpu_torch
(`plan/cbo.py`) against the JAX package's `plan/cbo.py`, on the CPU.

`row_estimate` equals the JAX estimate on the JAX tests' plans (scan,
filter, limit, union, aggregate, join, the cartesian join, range, a
filter over a parquet scan by its footer statistics); the optimizer's
placement, the explain log with its `!` lines, equals the JAX
`optimize`'s at four transition costs, Expand, Sample and Range among
the nodes it places; and the results stay exact with the placed nodes
running on the port's host engine. The join whose build side is a
4,000,000-row cross join plans as a shuffled join, as in the JAX
engine, where the port broadcast it before.

Tolerance: exact."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.frontend import DataFrame as JaxDataFrame
from spark_rapids_tpu.plan.cbo import row_estimate as jax_row_estimate
from spark_rapids_tpu.plan.nodes import CpuExpandExec as JaxExpand
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.frontend import DataFrame
from spark_rapids_tpu_torch.plan.cbo import estimate_pass, row_estimate
from spark_rapids_tpu_torch.plan.nodes import CpuExpandExec
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "ALL"}
OPT = dict(BASE, **{"spark.rapids.sql.optimizer.enabled": True})
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4"}


def _table(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 5, n)),
                     "v": pa.array(rng.integers(-9, 9, n)),
                     "d": pa.array(rng.random(n))})


@pytest.fixture(scope="module")
def pq_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("cbo") / "t.parquet")
    pq.write_table(pa.table({"x": pa.array(np.arange(1000)),
                             "y": pa.array(np.arange(1000) * 0.5)}), p,
                   row_group_size=250)
    return p


def _plans(sess, E, path):
    """The same plans on either engine."""
    t, big = _table(100), _table(20_000, 1)
    df = sess.from_arrow(t)
    a = sess.from_arrow(pa.table({"k": pa.array(np.arange(5000) % 100)}))
    b = sess.from_arrow(pa.table({"x": pa.array(np.arange(2000))}))
    c = sess.from_arrow(pa.table({"k": pa.array(np.arange(2000) % 100)}))
    f = sess.read_parquet(path)
    return {
        "scan": df, "filter": df.filter(E.col("v") > E.lit(0)),
        "limit": df.limit(7), "union": df.union(df),
        "agg": sess.from_arrow(big).group_by("k").agg(s=E.Sum(E.col("v"))),
        "global_agg": df.agg(s=E.Sum(E.col("v"))),
        "join": df.join(sess.from_arrow(big), on="k"),
        "cross": b.cross_join(c),
        "cross_under_join": a.join(b.cross_join(c), on="k"),
        "range": sess.range(0, 12_345, 7),
        "range_neg": sess.range(100, 0, -3),
        "sample": df.sample(0.3, 1),
        "file": f, "file_filter": f.filter(E.col("x") < E.lit(100)),
        "file_filter_flipped": f.filter(E.lit(250.0) <= E.col("y")),
        "file_filter_and": f.filter((E.col("x") > E.lit(100))
                                    & (E.col("x") < E.lit(600))),
    }


def test_row_estimates_equal_jax(pq_path):
    ps = TpuSession(BASE, device="cpu")
    js = JaxSession(BASE)
    port, jax = _plans(ps, PE, pq_path), _plans(js, JE, pq_path)
    for name in port:
        assert row_estimate(port[name].plan) == \
            jax_row_estimate(jax[name].plan), name
    assert row_estimate(port["cross"].plan) == 4_000_000
    assert row_estimate(port["filter"].plan) == 50
    assert row_estimate(port["file_filter"].plan) == \
        pytest.approx(1000 * 100 / 999)


def test_estimate_pass_memo():
    ps = TpuSession(BASE, device="cpu")
    df = ps.from_arrow(_table(80)).filter(PE.col("v") > PE.lit(0))
    with estimate_pass():
        assert row_estimate(df.plan) == 40
        df.plan.children[0].table = _table(10)  # the memo holds the pass
        assert row_estimate(df.plan) == 40
    assert row_estimate(df.plan) == 5


def _expand(sess, E, mod, df):
    projections = [[E.col("k"), E.col("v"), E.lit(0)],
                   [E.lit(None, mod.LONG), E.col("v"), E.lit(1)]]
    return mod.DataFrame(sess, mod.CpuExpandExec(projections,
                                                 ["k", "v", "g"], df.plan))


class _P:
    LONG, CpuExpandExec, DataFrame = T.LONG, CpuExpandExec, DataFrame


class _J:
    LONG, CpuExpandExec, DataFrame = JT.LONG, JaxExpand, JaxDataFrame


def _placement_queries(sess, E, types, mod):
    """A device-capable tail over a host-only cast, and plans with Expand,
    Sample and Range under the optimizer."""
    big = sess.from_arrow(_table(5_000, 1))
    return {
        "cheap_tail": big.group_by("k").agg(s=E.Sum(E.col("d")))
        .select("k", u=E.col("s").cast(types.DecimalType(7, 2)))
        .select(y=E.col("k") + E.lit(1)),
        "expand": _expand(sess, E, mod, big).group_by("k", "g")
        .agg(s=E.Sum(E.col("v"))),
        "sample": big.sample(0.5, 3).filter(E.col("v") > E.lit(0))
        .group_by("k").agg(n=E.Count(E.lit(1))),
        "range": sess.range(0, 3000).select(m=E.col("id") % E.lit(7))
        .group_by("m").agg(n=E.Count(E.lit(1))),
        "join": big.join(sess.from_arrow(_table(50, 2)).select(
            "k", w=E.col("v")), on="k").agg(s=E.Sum(E.col("w"))),
    }


@pytest.mark.parametrize("cost", [0.0, 1.0, 10.0, 1e6])
def test_placement_equals_jax(cost):
    """The explain log (every node's mark and reasons, the optimizer's
    among them) equals the JAX planner's, and the results equal the JAX
    engine's with the placed nodes on the port's host engine."""
    conf = dict(OPT, **{"spark.rapids.sql.optimizer.transitionCost": cost})
    ps, js = TpuSession(conf, device="cpu"), JaxSession(conf)
    port = _placement_queries(ps, PE, T, _P)
    jax = _placement_queries(js, JE, JT, _J)
    for name in port:
        po = Overrides(ps.conf, "cpu")
        po.apply(port[name].plan)
        jo = JaxOverrides(js.conf)
        jo.apply(jax[name].plan)
        assert po.explain_log == jo.explain_log, name
        order = [(k, "ascending") for k in port[name].schema.names]
        got = port[name].collect().sort_by(order)
        assert got.to_pydict() == \
            jax[name].collect_cpu().sort_by(order).to_pydict(), name


def test_high_cost_runs_on_the_host_engine():
    """transitionCost 1e6 keeps the whole plan on the host, Expand,
    Sample and Range included; zero keeps it all on the device."""
    for cost, on_device in ((1e6, False), (0.0, True)):
        conf = dict(OPT, **{"spark.rapids.sql.optimizer.transitionCost":
                            cost})
        ps = TpuSession(conf, device="cpu")
        for name, q in _placement_queries(ps, PE, T, _P).items():
            if name == "cheap_tail":
                continue
            root = Overrides(ps.conf, "cpu").apply(q.plan)
            assert isinstance(root, TpuExec) == on_device, (name, cost)


def test_cross_join_build_is_shuffled_as_in_jax():
    """A 5,000-row table joined on k with the cross join of two 2,000-row
    tables, under the distributed conf: the JAX planner estimates the
    build at 4 M rows x 9 B, past the broadcast threshold, and plans a
    shuffled join over two exchanges; so does the port now."""
    ps = TpuSession(dict(BASE, **MESH), device="cpu")
    js = JaxSession(dict(BASE, **MESH))

    def q(sess):
        a = sess.from_arrow(pa.table({"k": pa.array(np.arange(5000) % 100)}))
        b = sess.from_arrow(pa.table({"x": pa.array(np.arange(2000))}))
        c = sess.from_arrow(pa.table({"k": pa.array(np.arange(2000) % 100)}))
        return a.join(b.cross_join(c), on="k")

    p, j = q(ps), q(js)
    tree = p.explain()
    jtree = JaxOverrides(js.conf).apply(j.plan).tree_string()
    assert tree.splitlines()[0].startswith("TpuShuffledHashJoinExec")
    assert jtree.splitlines()[0].startswith("TpuShuffledHashJoinExec")
    assert "TpuBroadcastHashJoinExec" not in tree
    assert tree.count("TpuShuffleExchangeExec") == 2


def test_cross_join_build_result_equals_jax():
    """The same shape at 60 x (20 x 30) rows under a 1,000-byte
    broadcast threshold (the cross join's 600 x 9 B estimate past it):
    shuffled, and the JAX engine's rows."""
    conf = dict(BASE, **MESH, **{
        "spark.rapids.sql.autoBroadcastJoinThreshold": 1000})
    ps, js = TpuSession(conf, device="cpu"), JaxSession(conf)

    def q(sess, E):
        a = sess.from_arrow(pa.table({"k": pa.array(np.arange(60) % 10)}))
        b = sess.from_arrow(pa.table({"x": pa.array(np.arange(20))}))
        c = sess.from_arrow(pa.table({"k": pa.array(np.arange(30) % 10)}))
        return a.join(b.cross_join(c), on="k").group_by("k").agg(
            n=E.Count(E.lit(1)), s=E.Sum(E.col("x")))

    p = q(ps, PE)
    assert "TpuShuffledHashJoinExec" in p.explain()
    got = p.collect().sort_by("k").to_pydict()
    assert got == q(js, JE).collect_cpu().sort_by("k").to_pydict()
    assert got["n"] == [6 * 20 * 3] * 10
