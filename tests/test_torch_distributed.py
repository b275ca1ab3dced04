"""The port's distributed plan against the JAX engine on the CPU: the main
query and a broadcast-join grouped aggregate under
`spark.rapids.shuffle.mode=ICI` with a 4-position mesh and fusion on
(partial aggregate fused into the probe stage -> key exchange -> per-shard
final aggregate), the exchange and the partial aggregate on identical
batches, and the int64 segmented sum (kernel C's plain twin) against the
JAX kernel. The zipped shuffled join and the slot-overflow rerun are held
against numpy.

The JAX package runs on the 8 virtual CPU devices of tests/conftest.py, with
pallas.mode force (its Pallas kernels in interpret mode) and off; the port
runs with device="cpu", where its kernel wrappers take their plain twins.

Tolerances: int sums, counts, min and max are exact; f64 sums rtol 1e-9,
since the two engines may add in another order. The segmented sums are
integer results and equal bit for bit."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.exec import aggregate as jax_aggregate
from spark_rapids_tpu.exec import exchange as jax_exchange
from spark_rapids_tpu.expr import Count as JCount, Max as JMax, \
    Min as JMin, Sum as JSum, col as jcol, lit as jlit
from spark_rapids_tpu.ops.pallas_groupby import \
    segment_sum_i64 as jax_segment_sum_i64
from spark_rapids_tpu.plan.nodes import AggExpr as JAggExpr, \
    HashPartitionSpec as JHashPartitionSpec
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec import aggregate, exchange
from spark_rapids_tpu_torch.expr import Count, Max, Min, Sum, col, lit
from spark_rapids_tpu_torch.ops import pallas_groupby
from spark_rapids_tpu_torch.parallel import mesh
from spark_rapids_tpu_torch.plan.nodes import AggExpr, HashPartitionSpec
from spark_rapids_tpu_torch.plugin import TpuSession
from torch_port import JaxSource, PortSource, assert_same_rows, port_batch

ROOT = Path(__file__).resolve().parents[1]
FU = "spark.rapids.tpu.fusion.enabled"
PALLAS = "spark.rapids.tpu.fusion.pallas.mode"
MESH = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        FU: True}
JAX_NS = SimpleNamespace(Sum=JSum, Count=JCount, Min=JMin, Max=JMax,
                         col=jcol, lit=jlit)
PORT_NS = SimpleNamespace(Sum=Sum, Count=Count, Min=Min, Max=Max, col=col,
                          lit=lit)


def _tables(n=1500, n_dim=60, key_space=120, groups=37, seed=0):
    """The main query's columns plus an f64 value, a few nulls; the dim
    carries an int64 tag in place of the JAX tests' string one."""
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "k": pa.array(rng.integers(0, key_space, n), mask=rng.random(n) < 0.03),
        "g": rng.integers(0, groups, n).astype(np.int32),
        "v": pa.array(rng.uniform(0.5, 1.5, n), mask=rng.random(n) < 0.05),
        "c": rng.integers(0, 2 ** 30, n).astype(np.int64),
    })
    keys = rng.permutation(key_space)[:n_dim].astype(np.int64)
    dim = pa.table({"k": keys,
                    "w": rng.integers(0, 2 ** 30, n_dim).astype(np.int64),
                    "wf": rng.uniform(0.5, 1.5, n_dim),
                    "tag": keys % 7})
    return fact, dim


def _main_query(s, m, fact, dim):
    return s.from_arrow(fact).filter(m.col("v") > 0.6) \
        .join(s.from_arrow(dim), on="k") \
        .group_by("g").agg(total=m.Sum(m.col("c") + m.col("w")),
                           cnt=m.Count(m.col("v")))


def _broadcast_groupby(s, m, fact, dim):
    # tests/test_distributed_engine.py TestMeshBroadcastJoin, int64 tag
    return s.from_arrow(fact).join(s.from_arrow(dim), on="k") \
        .group_by("tag").agg(s=m.Sum(m.col("v") * m.col("wf")),
                             c=m.Count(m.lit(1)), mx=m.Max(m.col("c")),
                             mn=m.Min(m.col("w")))


QUERIES = {"main": (_main_query, "g"),
           "broadcast_groupby": (_broadcast_groupby, "tag")}


def _assert_tables(a: pa.Table, b: pa.Table, approx=()):
    assert a.schema == b.schema, (a.schema, b.schema)
    assert a.num_rows == b.num_rows
    for name in a.column_names:
        if name in approx:
            np.testing.assert_allclose(b.column(name).to_numpy(),
                                       a.column(name).to_numpy(), rtol=1e-9)
        else:
            assert a.column(name).equals(b.column(name)), name


@pytest.fixture(scope="module")
def tables():
    return _tables()


@pytest.fixture(scope="module")
def jax_runs(tables):
    """Each query through the JAX engine per pallas mode: (sorted result,
    plan string). The two modes must agree with each other too."""
    fact, dim = tables
    runs = {}
    for qname, (build, key) in QUERIES.items():
        for mode in ("force", "off"):
            sess = JaxSession(dict(MESH, **{PALLAS: mode}))
            q = build(sess, JAX_NS, fact, dim)
            before = jax_exchange.MESH_EXCHANGES
            out = q.collect().sort_by(key)
            assert jax_exchange.MESH_EXCHANGES > before
            from spark_rapids_tpu.plan.overrides import Overrides
            plan = Overrides(sess.conf).apply(q.plan).tree_string()
            runs[qname, mode] = out, plan
        _assert_tables(runs[qname, "off"][0], runs[qname, "force"][0],
                       approx=("s",))
    return runs


def _port_run(qname, mode, fact, dim, extra=None):
    build, key = QUERIES[qname]
    sess = TpuSession(dict(MESH, **{PALLAS: mode}, **(extra or {})),
                      device="cpu")
    q = build(sess, PORT_NS, fact, dim)
    before = exchange.MESH_EXCHANGES
    out = q.collect().sort_by(key)
    assert exchange.MESH_EXCHANGES > before, "no mesh exchange ran"
    return out, q.explain()


def _np_join(fact, dim, how="inner"):
    """numpy equi-join on k, where a null key matches nothing: the fact row
    and the dim row (-1: a left row without a match) of each joined row."""
    kv = fact.column("k").is_valid().to_numpy(zero_copy_only=False)
    k = fact.column("k").fill_null(0).to_numpy()
    dk = dim.column("k").to_numpy()
    order = np.argsort(dk, kind="stable")
    lo = np.searchsorted(dk[order], k, "left")
    n = np.where(kv, np.searchsorted(dk[order], k, "right") - lo, 0)
    fi = np.repeat(np.arange(len(k)), n)
    di = order[np.repeat(lo, n) + np.arange(n.sum())
               - np.repeat(np.cumsum(n) - n, n)]
    if how == "left":
        fi = np.concatenate([fi, np.nonzero(n == 0)[0]])
        di = np.concatenate([di, np.full((n == 0).sum(), -1)])
    return fi, di


def _np_join_groupby(fact, dim, how):
    """count(w), sum(c), max(w) by g over the numpy join."""
    fi, di = _np_join(fact, dim, how)
    g = fact.column("g").to_numpy()[fi]
    c = fact.column("c").to_numpy()[fi]
    w = np.where(di >= 0, dim.column("w").to_numpy()[di], 0)
    groups = np.unique(g)
    hit = di >= 0
    mx = [int(w[(g == x) & hit].max()) if ((g == x) & hit).any() else None
          for x in groups]
    return {"g": groups.tolist(),
            "n": [int(((g == x) & hit).sum()) for x in groups],
            "s": [int(c[g == x].sum()) for x in groups], "mx": mx}


class TestDistributedQuery:
    @pytest.mark.parametrize("mode", ["force", "off"])
    @pytest.mark.parametrize("qname", sorted(QUERIES))
    def test_matches_jax_engine(self, tables, jax_runs, qname, mode):
        fact, dim = tables
        want = jax_runs[qname, mode][0]
        launches = pallas_groupby.segment_sum_i64.launches
        out, _ = _port_run(qname, mode, fact, dim)
        assert out.num_rows == want.num_rows > 1
        _assert_tables(want, out, approx=("s",))
        # on the CPU the kernel wrapper takes its plain twin: no launches
        assert pallas_groupby.segment_sum_i64.launches == launches

    @pytest.mark.parametrize("mode", ["force", "off"])
    def test_plans_carry_partial_exchange_final(self, tables, jax_runs,
                                                mode):
        fact, dim = tables
        _, plan = _port_run("main", mode, fact, dim)
        for p in (plan, jax_runs["main", mode][1]):
            lines = p.splitlines()
            assert lines[0].startswith("TpuHashAggregateExec[final")
            assert lines[1].strip().startswith("TpuShuffleExchangeExec"
                                               "[hashpartitioning(")
            assert lines[2].strip().startswith("TpuFusedStageExec")
            assert "Filter[" in lines[2] and "BroadcastHashJoin[inner" in \
                lines[2] and "PartialAgg[" in lines[2]

    def test_kernel_seam_routes_every_int64_sum(self, tables, monkeypatch):
        """pallas.mode=force sends the fused partial aggregate's int64 sums
        through the kernel wrapper (3 per batch: Sum's sum and non-null
        count, Count's count), and off sends none; both give one result."""
        fact, dim = tables
        calls = []
        real = pallas_groupby.segment_sum_i64

        def spy(values, segment_ids, num_segments):
            calls.append(num_segments)
            return real(values, segment_ids, num_segments)

        monkeypatch.setattr(pallas_groupby, "segment_sum_i64", spy)
        conf = {"spark.rapids.sql.batchSizeRows": 512}
        outs = {}
        for mode in ("force", "off"):
            del calls[:]
            outs[mode] = _port_run("main", mode, fact, dim, conf)[0]
            n_calls = len(calls)
            assert n_calls == (3 * 3 if mode == "force" else 0), calls
        assert outs["force"].equals(outs["off"])

    def test_chip_smoke_path_inputs_are_the_kernels_inputs(self,
                                                           monkeypatch):
        """chip_smoke.py times kernel C on `segsum_path_inputs`: those must
        be exactly the first call the fused partial aggregate makes, and its
        distributed query must match its numpy oracle (small size)."""
        sys.path.insert(0, str(ROOT))
        import chip_smoke as cs
        fact, dim = cs.query_tables(pa, 20000, 600, 1200, 37, seed=5)
        calls = []
        real = pallas_groupby.segment_sum_i64
        monkeypatch.setattr(
            pallas_groupby, "segment_sum_i64",
            lambda *a: calls.append([t.clone() for t in a[:2]]) or real(*a))
        cap = 8192
        sess = TpuSession(dict(MESH, **{
            PALLAS: "force", "spark.rapids.sql.batchSizeRows": cap}),
            device="cpu")
        out = cs.main_query(sess, fact, dim).collect().sort_by("g")
        for name, want in zip(("g", "total", "cnt"),
                              cs.query_oracle(fact, dim)):
            np.testing.assert_array_equal(out.column(name).to_numpy(), want)
        vals, ids = cs.segsum_path_inputs(fact, dim, cap)
        assert len(calls) == 3 * 3
        assert torch.equal(calls[0][0], torch.from_numpy(vals))
        assert torch.equal(calls[0][1], torch.from_numpy(ids))

    def test_join_growth_reruns_only_the_sized_members(self, monkeypatch):
        """Every dim key eight times: the fused join outgrows its first
        capacity and reruns, while the partial aggregate after it still runs
        once per batch. Held against a numpy join and group-by."""
        fact, dim = _tables()
        dim8 = pa.concat_tables([dim] * 8)
        calls = []
        real = pallas_groupby.segment_sum_i64
        monkeypatch.setattr(
            pallas_groupby, "segment_sum_i64",
            lambda *a: calls.append(a[2]) or real(*a))
        sess = TpuSession(dict(MESH, **{
            PALLAS: "force", "spark.rapids.sql.batchSizeRows": 512}),
            device="cpu")
        root = sess.plan_device(_main_query(sess, PORT_NS, fact, dim8).plan)
        out = pa.concat_tables([batch_to_arrow(b) for b in root.execute()]
                               ).sort_by("g")
        stage = root.children[0].children[0]
        assert type(stage).__name__ == "TpuFusedStageExec"
        assert stage._join_caps[0] > 512  # the join grew past the batch
        assert len(calls) == 3 * 3  # 3 batches, the aggregate once each
        keep = fact.column("v").fill_null(0).to_numpy() > 0.6
        kept = fact.filter(keep)
        fi, di = _np_join(kept, dim8)
        g = kept.column("g").to_numpy()[fi]
        cw = kept.column("c").to_numpy()[fi] + dim8.column("w").to_numpy()[di]
        groups = np.unique(g)
        assert out.column("g").to_pylist() == groups.tolist()
        assert out.column("total").to_pylist() == [int(cw[g == x].sum())
                                                   for x in groups]
        assert out.column("cnt").to_pylist() == [int((g == x).sum())
                                                 for x in groups]


class TestZippedShuffledJoin:
    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_zipped_join_then_groupby(self, tables, how):
        """Broadcast off: both join sides cross a key exchange and the join
        zips the shards; the aggregate above splits partial -> exchange ->
        final. Held against a numpy join and group-by, exactly."""
        fact, dim = tables
        sess = TpuSession(dict(MESH, **{
            "spark.rapids.sql.autoBroadcastJoinThreshold": -1}),
            device="cpu")
        df = sess.from_arrow(fact).join(sess.from_arrow(dim), on="k",
                                        how=how) \
            .group_by("g").agg(n=Count(col("w")), s=Sum(col("c")),
                               mx=Max(col("w")))
        plan = df.explain()
        assert "TpuShuffledHashJoinExec" in plan
        assert "TpuBroadcastExchangeExec" not in plan
        assert plan.count("TpuShuffleExchangeExec") == 3
        out = df.collect().sort_by("g")
        want = _np_join_groupby(fact, dim, how)
        assert out.num_rows == len(want["g"]) == 37
        for name in ("g", "n", "s", "mx"):
            assert out.column(name).to_pylist() == want[name], name


class TestSlotOverflow:
    def test_skewed_slot_overflow_retries_not_drops(self):
        """tests/test_distributed_engine.py TestOverflowRetry, through a
        shuffled join so raw rows cross the exchange: every row shares one
        key, so all of them go to one position, a 16-row slot overflows,
        and the exchange reruns larger and drops nothing."""
        rng = np.random.default_rng(42)
        n = 600
        t = pa.table({"id": np.full(n, 7, dtype=np.int64),
                      "val": rng.normal(0, 1, n)})
        d = pa.table({"id": np.array([7, 8], dtype=np.int64),
                      "w": np.array([3, 4], dtype=np.int64)})
        sess = TpuSession(dict(MESH, **{
            "spark.rapids.shuffle.ici.slotRows": 16,
            "spark.rapids.sql.autoBroadcastJoinThreshold": -1}),
            device="cpu")
        retries = exchange.SLOT_OVERFLOW_RETRIES
        out = sess.from_arrow(t).join(sess.from_arrow(d), on="id") \
            .group_by("id").agg(n=Count(col("val")), s=Sum(col("val")),
                                w=Sum(col("w"))).collect()
        assert exchange.SLOT_OVERFLOW_RETRIES > retries
        assert out.num_rows == 1 and out.column("n").to_pylist() == [n]
        assert out.column("w").to_pylist() == [3 * n]
        np.testing.assert_allclose(out.column("s").to_pylist()[0],
                                   float(np.sum(t.column("val").to_numpy())),
                                   rtol=1e-9)


# --------------------------------------------------------------------------
# module parity on identical batches

def _partial_batches(n=900, parts=3, seed=3):
    rng = np.random.default_rng(seed)
    t = pa.table({"key": pa.array(rng.integers(0, 40, n),
                                  mask=rng.random(n) < 0.05),
                  "x": pa.array(rng.integers(-2 ** 40, 2 ** 40, n),
                                mask=rng.random(n) < 0.1),
                  "f": rng.normal(0, 10, n)})
    step = -(-n // parts)
    jbs = [jax_batch_from_arrow(t.slice(i, step)) for i in range(0, n, step)]
    return jbs, [port_batch(b) for b in jbs]


class TestModuleParity:
    def test_partial_aggregate_one_output_per_batch(self):
        jbs, pbs = _partial_batches()

        def aggs(S, C, Mn, Mx, c, A):
            return [A(S(c("x")), "sx"), A(S(c("f")), "sf"), A(C(c("x")), "cx"),
                    A(Mn(c("x")), "mn"), A(Mx(c("f")), "mx")]

        j = jax_aggregate.TpuHashAggregateExec(
            [jcol("key")], aggs(JSum, JCount, JMin, JMax, jcol, JAggExpr),
            JaxSource(jbs), mode="partial")
        p = aggregate.TpuHashAggregateExec(
            [col("key")], aggs(Sum, Count, Min, Max, col, AggExpr),
            PortSource(pbs), mode="partial")
        jo, po = list(j.execute()), list(p.execute())
        assert len(jo) == len(po) == 3
        for jb, pb in zip(jo, po):  # same order of adds: exact
            assert_same_rows([jb], [pb])

    def test_mesh_exchange_partitions_match(self):
        """Partition p of the port's exchange holds the rows of the JAX
        engine's partition p, in the same order."""
        jbs, pbs = _partial_batches(n=700, parts=2, seed=8)
        jconf = JaxConf(MESH)
        j = jax_exchange.TpuShuffleExchangeExec(
            JHashPartitionSpec([jcol("key")], 4), JaxSource(jbs), jconf)
        p = exchange.TpuShuffleExchangeExec(
            HashPartitionSpec([col("key")], 4), PortSource(pbs),
            TpuConf(MESH))
        jo, po = list(j.execute()), list(p.execute())
        assert len(jo) == len(po) == 4
        for jb, pb in zip(jo, po):
            assert int(jb.num_rows) == int(pb.num_rows)
            assert_same_rows([jb], [pb])

    def test_mesh_positions(self, monkeypatch):
        assert mesh.make_mesh(4, "cpu") == (torch.device("cpu"),) * 4
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert [str(d) for d in mesh.make_mesh(4, "cuda")] == \
            ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]
        conf = TpuConf({"spark.rapids.tpu.mesh.shape": "shuffle=1"})
        assert mesh.mesh_from_conf(conf, "cpu") is None
        assert mesh.mesh_from_conf(TpuConf(), "cpu") is None
        assert len(mesh.mesh_from_conf(TpuConf(MESH), "cpu")) == 4

    def test_mesh_over_several_cards_raises_at_plan_time(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert mesh.mesh_from_conf(TpuConf(MESH), "cuda") == \
            (torch.device("cuda", 0),) * 4
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        with pytest.raises(NotImplementedError):
            mesh.mesh_from_conf(TpuConf(MESH), "cuda")
        from spark_rapids_tpu_torch.exec.requirements import \
            ensure_distribution

        class CudaRoot:
            device = torch.device("cuda", 0)
            children = []
        with pytest.raises(NotImplementedError):
            ensure_distribution(CudaRoot(), TpuConf(MESH))


# --------------------------------------------------------------------------
def _segsum_cases():
    """(values, ids, G, reference). The first three run the JAX kernel (in
    interpret mode), padded to one shape with dropped rows (id -1, value 0)
    so that they share compiles; the others run jax.ops.segment_sum."""
    rng = np.random.default_rng(4)

    def pad(v, i, n=8):
        return (np.concatenate([v, np.zeros(n - len(v), np.int64)]),
                np.concatenate([i, np.full(n - len(i), -1, i.dtype)]))

    return {
        "wrap": (*pad(np.array([2 ** 62, 2 ** 62, 2 ** 62, 5, -2 ** 63, -1]),
                      np.array([0, 0, 0, 1, 2, 2], np.int32)), 4, "kernel"),
        "ids_out_of_range": (*pad(np.array([1, 2, 99, 77, 5]),
                                  np.array([0, 1, -1, 5, 4], np.int32)), 4,
                             "kernel"),
        "int64_ids_beyond_int32": (*pad(
            np.array([5, 1, 7, 9]),
            np.array([2 ** 32 + 2, 0, 2 ** 31, -2 ** 32 + 1], np.int64)), 4,
            "kernel"),
        "random_full_range": (rng.integers(-2 ** 62, 2 ** 62, 5000),
                              rng.integers(0, 77, 5000).astype(np.int32), 77,
                              "segment_sum"),
        "sorted_with_padding": (
            np.concatenate([rng.integers(0, 2 ** 31, 300),
                            np.zeros(212, np.int64)]),
            np.concatenate([np.sort(rng.integers(0, 30, 300)),
                            np.full(212, 511)]).astype(np.int32), 512,
            "segment_sum"),
    }


class TestSegmentSumI64:
    @pytest.mark.parametrize("case", sorted(_segsum_cases()))
    def test_plain_twin_equals_jax(self, case):
        vals, ids, g, ref_fn = _segsum_cases()[case]
        if ref_fn == "kernel":
            ref = np.asarray(jax_segment_sum_i64(jnp.asarray(vals),
                                                 jnp.asarray(ids), g))
        else:
            ref = np.asarray(jax.ops.segment_sum(
                jnp.asarray(vals), jnp.asarray(ids), num_segments=g))
        v, i = torch.from_numpy(vals), torch.from_numpy(ids)
        plain = pallas_groupby.segment_sum_i64_plain(v, i, g).numpy()
        assert plain.dtype == ref.dtype == np.int64
        assert (plain == ref).all(), (plain, ref)
        launches = pallas_groupby.segment_sum_i64.launches
        assert (pallas_groupby.segment_sum_i64(v, i, g).numpy() == ref).all()
        assert pallas_groupby.segment_sum_i64.launches == launches

    def test_beyond_the_tpu_window_equals_segment_sum(self):
        rng = np.random.default_rng(5)
        g = 4196
        vals = rng.integers(-2 ** 62, 2 ** 62, 20000)
        ids = rng.integers(-10, g + 10, 20000).astype(np.int32)
        ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                             jnp.asarray(ids),
                                             num_segments=g))
        got = pallas_groupby.fused_segment_sum(
            torch.from_numpy(vals), torch.from_numpy(ids), g).numpy()
        assert (got == ref).all()

    def test_fused_segment_sum_keeps_other_types_plain(self):
        vals = torch.tensor([1.5, 2.25, -1.0], dtype=torch.float64)
        ids = torch.tensor([0, 0, 2], dtype=torch.int32)
        out = pallas_groupby.fused_segment_sum(vals, ids, 3)
        assert out.dtype == torch.float64 and out.tolist() == [3.75, 0, -1]

    def test_rejects_bad_inputs(self):
        v = torch.zeros(4, dtype=torch.int64)
        i = torch.zeros(4, dtype=torch.int32)
        with pytest.raises(ValueError):
            pallas_groupby.segment_sum_i64(v, i, 0)
        with pytest.raises(TypeError):
            pallas_groupby.segment_sum_i64(v.double(), i, 4)
        with pytest.raises(ValueError):
            pallas_groupby.segment_sum_i64(v.to("meta"), i.to("meta"), 4)


# --------------------------------------------------------------------------
class TestBoundaries:
    def test_final_aggregate_needs_partitioned_input(self):
        src = PortSource(_partial_batches(n=100, parts=1)[1])
        with pytest.raises(NotImplementedError):
            aggregate.TpuHashAggregateExec(
                [col("key")], [AggExpr(Count(col("x")), "n")], src,
                mode="final")

    @pytest.mark.parametrize("conf", [
        {"spark.rapids.tpu.mesh.enabled": True},
        {"spark.rapids.shuffle.mode": "MULTITHREADED"}],
        ids=["sharded_plan", "host_shuffle_exchange"])
    def test_out_of_slice_raises_at_plan_time(self, conf):
        t = pa.table({"k": np.arange(8, dtype=np.int64)})
        sess = TpuSession(dict(MESH, **conf), device="cpu")
        df = sess.from_arrow(t).group_by("k").agg(n=Count(None))
        if "spark.rapids.tpu.mesh.enabled" in conf:
            with pytest.raises(NotImplementedError):
                df.collect()
            return
        # no ICI: no exchange is planned; one made by hand raises
        assert "TpuShuffleExchangeExec" not in df.explain()
        from spark_rapids_tpu_torch.plan.overrides import Overrides
        src = Overrides(sess.conf, sess.device)._convert(df.plan.children[0])
        with pytest.raises(NotImplementedError):
            exchange.TpuShuffleExchangeExec(
                HashPartitionSpec([col("k")], 4), src, sess.conf)
