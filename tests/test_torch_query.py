"""spark_rapids_tpu_torch against the JAX engine on the CPU: the main query
through both sessions, the benchmark step against bench.cpu_pipeline, one
parity test per ported exec on bit-identical padded inputs
(interop.batch_from_numpy), the import boundary, the device rule, and the
plan-time refusals of what the slice does not cover.

Tolerances: the query aggregates integers, and every exec test compares
integer, boolean or exactly-copied float columns, so all of those are
exact. The bench step sums f64 in another order than numpy: rtol 1e-9."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.exec import aggregate as jax_aggregate
from spark_rapids_tpu.exec import basic as jax_basic
from spark_rapids_tpu.exec import broadcast as jax_broadcast
from spark_rapids_tpu.exec import coalesce as jax_coalesce
from spark_rapids_tpu.exec import joins as jax_joins
from spark_rapids_tpu.expr import Count as JCount, Max as JMax, \
    Min as JMin, Sum as JSum, col as jcol, lit as jlit
from spark_rapids_tpu.plan import fusion as jax_fusion
from spark_rapids_tpu.plan.nodes import AggExpr as JAggExpr
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
from spark_rapids_tpu_torch.errors import DeviceUnavailableError
from spark_rapids_tpu_torch.exec import aggregate, basic, broadcast, \
    coalesce, joins
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr import (Cast, Count, Max, Min, Round, Sum,
                                         col, lit)
from spark_rapids_tpu_torch.plan import fusion
from spark_rapids_tpu_torch.plan.nodes import AggExpr
from spark_rapids_tpu_torch.plugin import TpuSession
from torch_port import JaxSource, PortSource, assert_same_rows, port_batch

ROOT = Path(__file__).resolve().parents[1]
FU = "spark.rapids.tpu.fusion.enabled"
PALLAS = "spark.rapids.tpu.fusion.pallas.mode"
BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 1024}


def _query_tables(n=5000, n_dim=300, key_space=600, groups=37, seed=0):
    """The main query's tables at a small size, with a few nulls in the
    join key and the filtered/counted column."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, key_space, n).astype(np.int64)
    v = rng.uniform(0.5, 1.5, n)
    fact = pa.table({
        "k": pa.array(k, mask=rng.random(n) < 0.03),
        "g": rng.integers(0, groups, n).astype(np.int32),
        "v": pa.array(v, mask=rng.random(n) < 0.05),
        "c": rng.integers(0, 2 ** 30, n).astype(np.int64),
    })
    dim = pa.table({
        "k": rng.permutation(key_space)[:n_dim].astype(np.int64),
        "w": rng.integers(0, 2 ** 30, n_dim).astype(np.int64),
    })
    return fact, dim


def _query(sess, fact, dim, Sum_, Count_, col_):
    return sess.from_arrow(fact).filter(col_("v") > 0.6) \
        .join(sess.from_arrow(dim), on="k") \
        .group_by("g").agg(total=Sum_(col_("c") + col_("w")),
                           cnt=Count_(col_("v")))


@pytest.fixture(scope="module")
def tables():
    return _query_tables()


@pytest.fixture(scope="module")
def jax_result(tables):
    fact, dim = tables
    outs = [_query(JaxSession(dict(BASE, **{FU: fu})), fact, dim, JSum,
                   JCount, jcol).collect().sort_by("g") for fu in (True, False)]
    assert outs[0].equals(outs[1]), "JAX fusion on/off disagree"
    return outs[0]


class TestMainQuery:
    @pytest.mark.parametrize("conf", [{FU: True}, {FU: True, PALLAS: "force"},
                                      {FU: False}],
                             ids=["fused", "fused_kernel_wrapper", "unfused"])
    def test_matches_jax_engine(self, tables, jax_result, conf):
        fact, dim = tables
        sess = TpuSession(dict(BASE, **conf), device="cpu")
        out = _query(sess, fact, dim, Sum, Count, col).collect().sort_by("g")
        assert out.num_rows == 37
        assert out.equals(jax_result), f"port:\n{out}\nJAX:\n{jax_result}"

    def test_filter_and_probe_fuse_below_the_aggregate(self, tables):
        fact, dim = tables
        sess = TpuSession(dict(BASE, **{FU: True}), device="cpu")
        plan = _query(sess, fact, dim, Sum, Count, col).explain()
        lines = plan.splitlines()
        assert lines[0].startswith("TpuHashAggregateExec")
        assert lines[1].strip().startswith("TpuFusedStageExec")
        assert "Filter[" in lines[1] and "BroadcastHashJoin[inner" in lines[1]

    def test_chip_smoke_query_matches_its_oracle(self):
        """chip_smoke.py's query and numpy oracle, at a small size: exact."""
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs
        fact, dim = cs.query_tables(pa, 4000, 250, 500, 37, seed=5)
        sess = TpuSession(dict(BASE, **{FU: True}), device="cpu")
        out = cs.main_query(sess, fact, dim).collect().sort_by("g")
        for name, want in zip(("g", "total", "cnt"),
                              cs.query_oracle(fact, dim)):
            np.testing.assert_array_equal(out.column(name).to_numpy(), want)

    def test_bench_step_matches_cpu_pipeline(self):
        sys.path.insert(0, str(ROOT))
        import bench
        from spark_rapids_tpu_torch import benchstep
        data = benchstep.make_data(6000, 500, bench.N_GROUPS, 2000, seed=3)
        want_sums, want_rows = bench.cpu_pipeline(*data)
        sums, rows = benchstep.many_steps(
            *[torch.from_numpy(a) for a in data], n_groups=bench.N_GROUPS,
            key_space=2000, k_steps=3)
        np.testing.assert_allclose(sums.numpy(), want_sums, rtol=1e-9)
        assert int(rows) == want_rows


# --------------------------------------------------------------------------
# one parity test per ported exec, on identical padded batches

def _mixed_table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "a": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "b": pa.array(rng.integers(-2**62, 2**62, n), mask=rng.random(n) < 0.1),
        "f": pa.array(np.where(rng.random(n) < 0.05, np.nan,
                               rng.normal(0, 10, n)),
                      mask=rng.random(n) < 0.1),
        "t": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      mask=rng.random(n) < 0.1).cast(pa.date32()),
        "key": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.05),
    })


def _jax_and_port_batches(n=700, seed=0, parts=1):
    t = _mixed_table(n, seed)
    step = -(-n // parts)
    jbs = [jax_batch_from_arrow(t.slice(i, step)) for i in range(0, n, step)]
    return jbs, [port_batch(b) for b in jbs]


class TestExecParity:
    def test_scan_batches_identical(self):
        t = _mixed_table(300, 1)
        jb, pb = jax_batch_from_arrow(t), batch_from_arrow(t, "cpu")
        assert pb.capacity == jb.capacity and int(pb.num_rows) == 300
        for jc, pc in zip(jb.columns, pb.columns):
            assert (np.asarray(jc.validity) == pc.validity.numpy()).all()
            assert (np.asarray(jc.data) == pc.data.numpy()).all() or \
                np.array_equal(np.asarray(jc.data), pc.data.numpy(),
                               equal_nan=True)

    def test_project(self):
        jbs, pbs = _jax_and_port_batches()

        def exprs(c, l):
            return [(c("a") + c("b")).alias("s"), (c("b") * c("a")).alias("m"),
                    (c("a") - l(7)).alias("d"), (c("f") * l(2.5)).alias("x"),
                    ((c("f") > c("a")) | ~c("t")).alias("o"),
                    ((c("d") >= c("d")) & c("t")).alias("n"),
                    (c("f") == c("f")).alias("nan_eq")]

        j = jax_basic.TpuProjectExec(exprs(jcol, jlit), JaxSource(jbs))
        p = basic.TpuProjectExec(exprs(col, lit), PortSource(pbs))
        assert_same_rows(list(j.execute()), list(p.execute()))

    def test_filter(self):
        jbs, pbs = _jax_and_port_batches(parts=3)
        j = jax_basic.TpuFilterExec((jcol("f") < 3.0) & (jcol("key") > 5),
                                    JaxSource(jbs))
        p = basic.TpuFilterExec((col("f") < 3.0) & (col("key") > 5),
                                PortSource(pbs))
        jo, po = list(j.execute()), list(p.execute())
        assert [int(b.num_rows) for b in jo] == [int(b.num_rows) for b in po]
        assert_same_rows(jo, po)

    @pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
    def test_broadcast_hash_join(self, how):
        jbs, pbs = _jax_and_port_batches(parts=2)
        rng = np.random.default_rng(9)
        dim = pa.table({"key": pa.array(rng.integers(0, 60, 50),
                                        mask=rng.random(50) < 0.1),
                        "w": rng.integers(0, 99, 50)})
        jd = jax_batch_from_arrow(dim)
        j = jax_joins.TpuBroadcastHashJoinExec(
            JaxSource(jbs), jax_broadcast.TpuBroadcastExchangeExec(
                JaxSource([jd])), [jcol("key")], [jcol("key")], how)
        p = joins.TpuBroadcastHashJoinExec(
            PortSource(pbs), broadcast.TpuBroadcastExchangeExec(
                PortSource([port_batch(jd)])), [col("key")], [col("key")],
            how)
        assert_same_rows(list(j.execute()), list(p.execute()),
                         ordered=False)

    def test_hash_aggregate_multi_batch(self):
        jbs, pbs = _jax_and_port_batches(parts=3)

        def aggs(S, C, Mn, Mx, c, A):
            return [A(S(c("b")), "sb"), A(S(c("f")), "sf"), A(C(c("a")), "ca"),
                    A(C(None), "star"), A(Mn(c("d")), "mind"),
                    A(Mx(c("t")), "maxt"), A(Mx(c("a")), "maxa")]

        j = jax_aggregate.TpuHashAggregateExec(
            [jcol("key")], aggs(JSum, JCount, JMin, JMax, jcol, JAggExpr),
            JaxSource(jbs))
        p = aggregate.TpuHashAggregateExec(
            [col("key")], aggs(Sum, Count, Min, Max, col, AggExpr),
            PortSource(pbs))
        jo, po = list(j.execute()), list(p.execute())
        # f64 sums: same partial/merge order on both engines, so the
        # per-group result is compared exactly too
        assert_same_rows(jo, po, ordered=False)

    def test_concat_batches(self):
        jbs, pbs = _jax_and_port_batches(n=500, parts=3)
        jo = jax_coalesce.concat_batches(jbs)
        po = coalesce.concat_batches(pbs)
        assert po.capacity == jo.capacity
        assert_same_rows([jo], [po])

    def test_fused_stage(self):
        jbs, pbs = _jax_and_port_batches(parts=2)
        dim = pa.table({"key": np.arange(0, 40, 3, dtype=np.int64),
                        "w": np.arange(14, dtype=np.int64)})
        jd = jax_batch_from_arrow(dim)

        def chain(mod_basic, mod_join, mod_bcast, src, dsrc, c):
            f = mod_basic.TpuFilterExec(c("key") > 2, src)
            jn = mod_join.TpuBroadcastHashJoinExec(
                f, mod_bcast.TpuBroadcastExchangeExec(dsrc), [c("key")],
                [c("key")], "left")
            return mod_basic.TpuProjectExec([c("b"), (c("w") + c("a"))
                                             .alias("x")], jn)

        from spark_rapids_tpu.config import TpuConf as JaxConf
        from spark_rapids_tpu_torch.config import TpuConf
        j = jax_fusion.apply_fusion(chain(
            jax_basic, jax_joins, jax_broadcast, JaxSource(jbs),
            JaxSource([jd]), jcol), JaxConf({FU: True}))
        p = fusion.apply_fusion(chain(
            basic, joins, broadcast, PortSource(pbs),
            PortSource([port_batch(jd)]), col), TpuConf({FU: True}))
        assert type(j).__name__ == type(p).__name__ == "TpuFusedStageExec"
        assert_same_rows(list(j.execute()), list(p.execute()),
                         ordered=False)


# --------------------------------------------------------------------------
class TestEmptyInputs:
    """Empty build sides and empty inputs, against what Spark returns."""

    @pytest.mark.parametrize("how,rows", [("inner", 0), ("semi", 0),
                                          ("left", 5), ("anti", 5)])
    @pytest.mark.parametrize("fused", [True, False])
    def test_join_with_empty_build(self, how, rows, fused):
        sess = TpuSession({FU: fused}, device="cpu")
        t = pa.table({"k": np.arange(5, dtype=np.int64)})
        empty = pa.table({"k": pa.array([], pa.int64()),
                          "w": pa.array([], pa.int64())})
        out = sess.from_arrow(t).filter(col("k") >= 0) \
            .join(sess.from_arrow(empty), on="k", how=how).collect()
        assert out.num_rows == rows
        if how == "left":
            assert out.column(2).null_count == 5

    @pytest.mark.parametrize("source", ["empty_batch", "no_batches"])
    def test_global_aggregate_over_no_rows(self, source):
        sess = TpuSession(device="cpu")
        t = pa.table({"x": np.arange(4, dtype=np.int64)})
        df = sess.from_arrow(t).filter(col("x") > 10)
        if source == "no_batches":  # an inner join drops empty outputs
            df = df.join(sess.from_arrow(t), on="x")
        out = df.agg(n=Count(None), s=Sum(col("x"))).collect()
        assert out.to_pylist() == [{"n": 0, "s": None}]


# --------------------------------------------------------------------------
class TestBoundaries:
    def test_import_imports_no_jax(self):
        code = (
            "import importlib, pkgutil, sys\n"
            "import spark_rapids_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'spark_rapids_tpu' or "
            "m.startswith('spark_rapids_tpu.')]\n"
            "assert not bad, bad\n"
            "new = ['parallel.mesh', 'parallel.partitioning', "
            "'parallel.collective', 'exec.exchange', 'exec.requirements', "
            "'ops.pallas_groupby', 'expr.nullexprs', 'expr.conditional', "
            "'native', 'io.parquet_device', 'io.scanbase', 'io.parquet', "
            "'io.dynamic_pruning']\n"
            "missing = [m for m in new if p.__name__ + '.' + m not in "
            "sys.modules]\n"
            "assert not missing, missing\n"
            "print('clean')\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0 and "clean" in out.stdout, out.stderr

    def test_chip_smoke_imports_no_jax(self):
        tree = ast.parse((ROOT / "chip_smoke.py").read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in
                    ("jax", "spark_rapids_tpu")], names

    def test_session_runs_on_cuda_or_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(DeviceUnavailableError):
            TpuSession()
        with pytest.raises(DeviceUnavailableError):
            TpuSession(device="cuda")
        assert TpuSession(device="cpu").device.type == "cpu"

    @pytest.mark.parametrize("case", ["decimal128_column", "right_join",
                                      "ansi", "double_join_key",
                                      "sum_of_boolean"])
    def test_out_of_slice_raises_at_plan_time(self, case):
        conf = {"spark.sql.ansi.enabled": True} if case == "ansi" else {}
        sess = TpuSession(conf, device="cpu")
        t = pa.table({"k": np.arange(4, dtype=np.int64),
                      "x": np.arange(4, dtype=np.float64),
                      "b": np.array([True, False, True, True])})
        df = sess.from_arrow(t)
        if case == "decimal128_column":  # 20 digits: no 128-bit murmur3
            d20 = pa.array(np.arange(4, dtype=np.int8)).cast(
                pa.decimal128(20, 2))
            df = sess.from_arrow(t.append_column("y", d20)).join(
                sess.from_arrow(pa.table({"y": d20})), on="y")
        elif case == "right_join":  # right joins run; not on the limbs
            d20 = pa.array(np.arange(4, dtype=np.int8)).cast(
                pa.decimal128(20, 2))
            df = df.join(sess.from_arrow(pa.table({"k": d20})), on="k",
                         how="right")
        elif case == "double_join_key":  # double keys join; not a double
            # against a long (tests/test_torch_joins.py)
            df = df.join(sess.from_arrow(pa.table({"k": np.arange(
                4, dtype=np.float64)})), on="k")
        elif case == "sum_of_boolean":
            df = df.group_by("k").agg(s=Sum(col("b")))
        elif case == "ansi":  # ANSI runs; a decimal Round stays refused
            # (the JAX Round keeps the decimal's type and digits)
            df = df.select(x=Round(Cast(col("k"), T.DecimalType(7, 0)), 0))
        with pytest.raises(NotImplementedError):
            df.collect()
