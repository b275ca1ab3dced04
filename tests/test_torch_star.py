"""String-keyed star-schema reports (TPC-DS q3/q7/q36 shapes) in
spark_rapids_tpu_torch against the JAX engine on the CPU, and the modules
they brought, on identical padded batches (interop.batch_from_numpy).

The tables are chip_smoke.py's `star_tables` at the size of
tests/test_tpcds_shapes.py: 4,000 sales, 365 dates, 60 items, 8 stores,
from a numpy seed whose items include a null category. The queries are
chip_smoke.py's `star_queries`, written in the API both engines share.

Tolerances: keys, counts, MIN and MAX are exact, and so is every string,
boolean and hash (bit for bit); f64 sums and averages are held to rtol
1e-9, since the two engines may add in another order."""

import decimal
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.columnar import batch_to_arrow as jax_batch_to_arrow
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.exec import aggregate as jax_aggregate
from spark_rapids_tpu.exec import basic as jax_basic
from spark_rapids_tpu.exec import exchange as jax_exchange
from spark_rapids_tpu.expr.base import Vec as JVec
from spark_rapids_tpu.expr.hashing import hash_vec as jax_hash_vec
from spark_rapids_tpu.expr.predicates import \
    string_compare as jax_string_compare
from spark_rapids_tpu.plan import overrides as jax_overrides
from spark_rapids_tpu.plan.nodes import AggExpr as JAggExpr, \
    HashPartitionSpec as JHashPartitionSpec
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow, \
    batch_to_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec import aggregate, basic, coalesce, exchange
from spark_rapids_tpu_torch.expr.base import EvalContext, Vec, pad_width
from spark_rapids_tpu_torch.expr.hashing import hash_vec
from spark_rapids_tpu_torch.expr.predicates import string_compare, \
    string_equal
from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe
from spark_rapids_tpu_torch.plan import cbo
from spark_rapids_tpu_torch.plan.nodes import AggExpr, HashPartitionSpec
from spark_rapids_tpu_torch.plugin import TpuSession
from torch_port import JaxSource, PortSource, assert_same_rows, port_batch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

_NAMES = ("col lit Sum Average Count Max Min Coalesce CaseWhen IsNotNull If "
          "IsNull").split()
JAX_NS = SimpleNamespace(**{n: getattr(JE, n) for n in _NAMES})
PORT_NS = SimpleNamespace(**{n: getattr(PE, n) for n in _NAMES})
FU = "spark.rapids.tpu.fusion.enabled"
PALLAS = "spark.rapids.tpu.fusion.pallas.mode"
BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 1024, FU: True}
MESH = dict(BASE, **{"spark.rapids.shuffle.mode": "ICI",
                     "spark.rapids.tpu.mesh.shape": "shuffle=4"})
SEED = 14  # its 60 items include a null category


def _sorted(name, t):
    return t.sort_by([(k, "ascending") for k in cs.STAR_KEYS[name]])


def _assert_tables(name, want: pa.Table, got: pa.Table):
    """Exact, except f64 sums and averages: rtol 1e-9, nulls in place."""
    want, got = _sorted(name, want), _sorted(name, got)
    assert want.schema == got.schema, (want.schema, got.schema)
    assert want.num_rows == got.num_rows
    for col in want.column_names:
        a, b = want.column(col), got.column(col)
        if col in cs.STAR_APPROX[name]:
            assert a.is_null().equals(b.is_null()), col
            np.testing.assert_allclose(b.drop_null().to_numpy(),
                                       a.drop_null().to_numpy(), rtol=1e-9)
        else:
            assert a.equals(b), col


@pytest.fixture(scope="module")
def star():
    return cs.star_tables(pa, 4000, 365, 60, 8, seed=SEED)


@pytest.fixture(scope="module")
def jax_single(star):
    sess = JaxSession(BASE)
    return {n: q.collect()
            for n, q in cs.star_queries(sess, JAX_NS, star).items()}


@pytest.fixture(scope="module")
def jax_q7_distributed(star):
    before = jax_exchange.MESH_EXCHANGES
    out = cs.star_queries(JaxSession(dict(MESH, **{PALLAS: "off"})), JAX_NS,
                          star)["q7"].collect()
    assert jax_exchange.MESH_EXCHANGES > before
    return out


class TestStarQueries:
    @pytest.mark.parametrize("mode", ["off", "force"])
    @pytest.mark.parametrize("name", ["q3", "q7", "q36"])
    def test_one_device_matches_jax_engine(self, star, jax_single, name,
                                           mode):
        sess = TpuSession(dict(BASE, **{PALLAS: mode}), device="cpu")
        q = cs.star_queries(sess, PORT_NS, star)[name]
        plan = q.explain()
        assert "TpuFusedStageExec" in plan and "BroadcastHashJoin" in plan
        assert "TpuShuffledHashJoinExec" not in plan
        out = q.collect()
        assert out.num_rows > 1
        _assert_tables(name, jax_single[name], out)
        cs.check_star(name, out, cs.star_oracle(pa, star)[name])
        if name == "q7":  # the null category is a group of its own
            assert out.column("i_category").null_count == 1

    @pytest.mark.parametrize("mode", ["off", "force"])
    def test_q7_distributed_matches_jax_engine(self, star,
                                               jax_q7_distributed, mode):
        sess = TpuSession(dict(MESH, **{PALLAS: mode}), device="cpu")
        q = cs.star_queries(sess, PORT_NS, star)["q7"]
        lines = q.explain().splitlines()
        assert lines[0].startswith("TpuHashAggregateExec[final")
        assert lines[1].strip().startswith("TpuShuffleExchangeExec")
        assert "PartialAgg[" in lines[2] and "i_category" in lines[1] + \
            lines[2]
        before = exchange.MESH_EXCHANGES
        launches = pallas_groupby.segment_sum_i64.launches
        out = q.collect()
        assert exchange.MESH_EXCHANGES > before
        # on the CPU the kernel wrappers take their plain twins
        assert pallas_groupby.segment_sum_i64.launches == launches
        _assert_tables("q7", jax_q7_distributed, out)

    def test_average_count_routes_through_the_kernel_seam(
            self, star, monkeypatch):
        """Under force, the fused partial aggregate of the distributed Q7
        sends its int64 sums (the two Averages' counts and Count's count)
        through kernel C's wrapper; the f64 sums stay plain."""
        calls = []
        real = pallas_groupby.segment_sum_i64
        monkeypatch.setattr(pallas_groupby, "segment_sum_i64",
                            lambda v, i, g: calls.append(v.dtype) or
                            real(v, i, g))
        for mode in ("force", "off"):
            del calls[:]
            sess = TpuSession(dict(MESH, **{PALLAS: mode}), device="cpu")
            cs.star_queries(sess, PORT_NS, star)["q7"].collect()
            batches = -(-star["store_sales"].num_rows // 1024)
            # per batch: each Average's count and Count's count
            assert len(calls) == (3 * batches if mode == "force" else 0)
            assert set(calls) <= {torch.int64}

    def test_probe_hash_routes_through_kernel_a(self, star, monkeypatch):
        calls = []
        real = pallas_probe.murmur3_rows
        monkeypatch.setattr(pallas_probe, "murmur3_rows",
                            lambda *a: calls.append(a[0].dtype) or real(*a))
        sess = TpuSession(dict(BASE, **{PALLAS: "force"}), device="cpu")
        for name, q in cs.star_queries(sess, PORT_NS, star).items():
            del calls[:]
            q.collect()
            assert calls and set(calls) == {torch.int64}, name

    def test_kernel_inputs_are_captured_from_the_star_paths(self, star):
        """chip_smoke.first_call_args hands back the arguments of the first
        A call of a one-device Q7 and of the first C call of a distributed
        Q7 (what the script times the kernels on), and restores the
        wrappers."""
        real_a, real_c = pallas_probe.murmur3_rows, \
            pallas_groupby.segment_sum_i64
        sess = TpuSession(dict(BASE, **{PALLAS: "force"}), device="cpu")
        keys, valid, seed = cs.first_call_args(
            torch, pallas_probe, "murmur3_rows",
            cs.star_queries(sess, PORT_NS, star)["q7"].collect)
        assert keys.dtype == torch.int64 and keys.shape == valid.shape == \
            seed.shape == (1024,)
        assert seed.tolist() == [42] * 1024
        sess = TpuSession(dict(MESH, **{PALLAS: "force"}), device="cpu")
        vals, ids, groups = cs.first_call_args(
            torch, pallas_groupby, "segment_sum_i64",
            cs.star_queries(sess, PORT_NS, star)["q7"].collect)
        assert vals.dtype == torch.int64 and vals.shape == ids.shape
        assert set(vals.tolist()) <= {0, 1} and groups == vals.shape[0]
        assert int(pallas_groupby.segment_sum_i64_plain(
            vals, ids, groups).sum()) == int(vals.sum())
        assert pallas_probe.murmur3_rows is real_a
        assert pallas_groupby.segment_sum_i64 is real_c

    def test_kernel_capture_keeps_the_launch_count(self):
        """On the card a wrapper adds to its count through its module name,
        which points at the capturing stand-in while fn runs: the count
        must land on the wrapper all the same."""
        before = pallas_probe.murmur3_rows.launches
        keys = torch.arange(8, dtype=torch.int64)

        def launch_as_on_the_card():
            pallas_probe.murmur3_rows(keys, torch.ones(8, dtype=torch.bool),
                                      torch.full((8,), 42, dtype=torch.int32))
            pallas_probe.murmur3_rows.launches += 1

        got = cs.first_call_args(torch, pallas_probe, "murmur3_rows",
                                 launch_as_on_the_card)
        assert torch.equal(got[0], keys)
        assert pallas_probe.murmur3_rows.launches == before + 1
        pallas_probe.murmur3_rows.launches = before

    def test_broadcast_estimates_are_the_jax_engines(self):
        """The dims at their SF10 row counts: the same byte estimate as the
        JAX rule (20 B for a string column), all under the 10 MB broadcast
        threshold."""
        t = cs.star_tables(pa, 8, *cs.STAR_DIMS.values(), seed=SEED)
        jsess, psess = JaxSession(BASE), TpuSession(BASE, device="cpu")
        want = {"q3": [102_000 * 58, 73_049 * 19],
                "q7": [102 * 29, 102_000 * 58], "q36": [102_000 * 58]}
        for name, jq in cs.star_queries(jsess, JAX_NS, t).items():
            pq = cs.star_queries(psess, PORT_NS, t)[name]
            jb, pb = _builds(jq.plan), _builds(pq.plan)
            assert [cbo.estimated_bytes(b) for b in pb] == \
                [jax_overrides._estimated_bytes(b, jsess.conf)
                 for b in jb] == want[name]
            assert "TpuShuffledHashJoinExec" not in pq.explain()


def _builds(plan):
    """The build (right) child of every join of a plan, top down."""
    out = [plan.children[1]] if type(plan).__name__ == "CpuHashJoinExec" \
        else []
    for c in plan.children:
        out += _builds(c)
    return out


# --------------------------------------------------------------------------
# modules on identical padded batches

_WORDS = ["", "a", "ab", "abc", "abcd", "héllo", "日本語テキスト", "TN",
          "zz" * 9, "x" * 31, "Books", "Bookshelf", "a\x00", "ÿ"]


def _string_table(n=300, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array(_WORDS, dtype=object)
    return pa.table({
        "s": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                      mask=rng.random(n) < 0.1),
        "t": pa.array(words[rng.integers(0, len(words), n)].tolist()),
        "u": pa.array([w[:2] for w in words[rng.integers(0, len(words), n)]],
                      mask=rng.random(n) < 0.3),
        "k": pa.array(rng.integers(0, 5, n), mask=rng.random(n) < 0.05),
        "x": pa.array(rng.normal(0, 10, n), mask=rng.random(n) < 0.1),
        "i": rng.integers(1, 100, n).astype(np.int32),
    })


def _batches(n=300, seed=0, parts=1):
    t = _string_table(n, seed)
    step = -(-n // parts)
    jbs = [jax_batch_from_arrow(t.slice(i, step)) for i in range(0, n, step)]
    return jbs, [port_batch(b) for b in jbs]


def _assert_zero_tails(col, n):
    """Each of the first n rows of a string column, where valid, is zero
    past its length."""
    past = torch.arange(col.data.shape[1])[None, :] >= \
        col.lengths[:n, None].long()
    assert not (col.data[:n].bool() & past & col.validity[:n, None]).any()


def _project(exprs_of, jbs, pbs):
    j = jax_basic.TpuProjectExec(exprs_of(JAX_NS), JaxSource(jbs))
    p = basic.TpuProjectExec(exprs_of(PORT_NS), PortSource(pbs))
    jo, po = list(j.execute()), list(p.execute())
    assert_same_rows(jo, po)
    return po


class TestStrings:
    def test_arrow_round_trip(self):
        t = _string_table(200, 1)
        jb, pb = jax_batch_from_arrow(t), batch_from_arrow(t, "cpu")
        assert pb.capacity == jb.capacity
        for jc, pc in zip(jb.columns, pb.columns):
            assert (np.asarray(jc.validity) == pc.validity.numpy()).all()
            if jc.lengths is not None:
                assert (np.asarray(jc.data) == pc.data.numpy()).all()
                assert (np.asarray(jc.lengths) == pc.lengths.numpy()).all()
                _assert_zero_tails(pc, 200)
        assert batch_to_arrow(pb).equals(t)
        assert batch_to_arrow(port_batch(jb)).equals(t)
        edge = pa.table({"s": pa.array(["", None, "é" * 128, "x" * 256])})
        assert batch_to_arrow(batch_from_arrow(edge, "cpu")).equals(edge)
        # past the head width: the long-string layout, leaf for leaf the
        # JAX package's, and the same strings back
        long = pa.table({"s": ["x" * 257, None, "y"]})
        jc, pc = jax_batch_from_arrow(long).columns[0], \
            batch_from_arrow(long, "cpu").columns[0]
        assert pc.overflow is not None and jc.overflow is not None
        for a, b in zip((jc.data, jc.lengths) + tuple(jc.overflow),
                        (pc.data, pc.lengths) + tuple(pc.overflow)):
            assert (np.asarray(a) == b.numpy()).all()
        assert batch_to_arrow(batch_from_arrow(long, "cpu")).equals(long)

    def test_equality_and_ordering(self):
        jbs, pbs = _batches(seed=2)

        def exprs(m):
            c, lit = m.col, m.lit
            return [(c("s") == c("t")).alias("eq"),
                    (c("s") < c("t")).alias("lt"),
                    (c("s") <= c("t")).alias("le"),
                    (c("s") > c("u")).alias("gt"),
                    (c("s") >= c("u")).alias("ge"),
                    (c("s") != c("t")).alias("ne"),
                    (c("t") == lit("TN")).alias("tn"),
                    (c("t") < lit("Bookshelves and more")).alias("lit_wide")]
        _project(exprs, jbs, pbs)
        # string_compare itself, on the identical byte matrices
        jb, pb = jbs[0], pbs[0]
        for a, b in ((0, 1), (0, 2), (1, 2)):
            jv = [JVec(JT.STRING, jb.columns[i].data, jb.columns[i].validity,
                       jb.columns[i].lengths) for i in (a, b)]
            pv = [Vec.from_column(pb.columns[i]) for i in (a, b)]
            want = np.asarray(jax_string_compare(jnp, *jv))
            assert (string_compare(*pv).numpy() == want).all()

    def test_conditionals_over_mixed_widths(self):
        jbs, pbs = _batches(seed=3)

        def exprs(m):
            c, lit = m.col, m.lit
            return [m.If(c("k") > lit(2), c("s"), lit("a longer else branch "
                                                      "than any word")
                         ).alias("if_"),
                    m.CaseWhen([(c("x") > lit(5.0), lit("lux")),
                                (c("x") > lit(0.0), c("u"))],
                               c("t")).alias("case_"),
                    m.CaseWhen([(c("k") == lit(1), lit("one"))]
                               ).alias("no_else"),
                    m.Coalesce(c("u"), c("s"), lit("unknown")).alias("co"),
                    m.IsNull(c("s")).alias("isnull"),
                    m.IsNotNull(c("u")).alias("notnull")]
        po = _project(exprs, jbs, pbs)
        for col in po[0].columns[:4]:
            _assert_zero_tails(col, po[0].row_count())
        assert po[0].columns[0].data.shape[1] == 40  # the wider branch

    def test_zero_tails_after_concat_and_exchange(self):
        t = _string_table(300, 4)
        narrow = t.filter(pa.compute.less_equal(
            pa.compute.binary_length(t.column("t")), 5))
        batches = [batch_from_arrow(narrow, "cpu"),
                   batch_from_arrow(t, "cpu")]
        assert batches[0].columns[1].data.shape[1] == 8
        merged = coalesce.concat_batches(batches)
        assert merged.columns[1].data.shape[1] == 32
        for c in merged.columns[:3]:
            _assert_zero_tails(c, merged.row_count())
        assert batch_to_arrow(merged).equals(pa.concat_tables([narrow, t]))
        ex = exchange.TpuShuffleExchangeExec(
            HashPartitionSpec([PE.col("t")], 4), PortSource(batches),
            TpuConf(MESH))
        outs = list(ex.execute())
        assert sum(int(b.num_rows) for b in outs) == merged.row_count()
        for b in outs:
            for c in b.columns[:3]:
                _assert_zero_tails(c, b.row_count())

    def test_string_key_through_the_exchange_matches_jax(self):
        """Partition p of the port's exchange holds the JAX engine's
        partition p, in order: the string key hashes the same."""
        jbs, pbs = _batches(n=400, seed=5)
        j = jax_exchange.TpuShuffleExchangeExec(
            JHashPartitionSpec([JE.col("s"), JE.col("k")], 4),
            JaxSource(jbs), JaxConf(MESH))
        p = exchange.TpuShuffleExchangeExec(
            HashPartitionSpec([PE.col("s"), PE.col("k")], 4),
            PortSource(pbs), TpuConf(MESH))
        jo, po = list(j.execute()), list(p.execute())
        assert len(jo) == len(po) == 4
        for jb, pb in zip(jo, po):
            assert int(jb.num_rows) == int(pb.num_rows)
            assert_same_rows([jb], [pb])

    def test_murmur3_over_strings_and_doubles_matches_jax(self):
        rng = np.random.default_rng(6)
        n = 2000
        words = [bytes(rng.integers(0, 256, ln, dtype=np.uint8)).decode(
            "latin-1") for ln in rng.integers(0, 24, n)]
        specials = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
                             1e300, -1e-300, 2.0 ** 52, 123.25])
        dbl = np.where(rng.random(n) < 0.2,
                       specials[rng.integers(0, len(specials), n)],
                       rng.normal(0, 1e6, n))
        t = pa.table({"s": pa.array(words, mask=rng.random(n) < 0.1),
                      "d": pa.array(dbl, mask=rng.random(n) < 0.1)})
        jb = jax_batch_from_arrow(t)
        pb = port_batch(jb)
        seed = rng.integers(-2 ** 31, 2 ** 31, jb.capacity).astype(np.int32)
        for jc, pc in zip(jb.columns, pb.columns):
            jv = JVec(jc.dtype, jc.data, jc.validity, jc.lengths)
            want = np.asarray(jax.jit(lambda v, h: jax_hash_vec(jnp, v, h))(
                jv, jnp.asarray(seed.view(np.uint32))))
            got = hash_vec(Vec.from_column(pc), torch.from_numpy(seed))
            assert (got.numpy().view(np.uint32) == want).all(), jc.dtype

    def test_string_group_order_matches_jax(self):
        """A complete aggregate over string and int keys, several batches:
        the same groups in the same order (the packed-word sort keys give
        the JAX engine's byte-column order)."""
        jbs, pbs = _batches(n=600, seed=7, parts=3)

        def aggs(m, A):
            return [A(m.Count(m.lit(1)), "n"), A(m.Min(m.col("i")), "mn"),
                    A(m.Max(m.col("x")), "mx")]
        j = jax_aggregate.TpuHashAggregateExec(
            [JE.col("s"), JE.col("k")], aggs(JAX_NS, JAggExpr),
            JaxSource(jbs))
        p = aggregate.TpuHashAggregateExec(
            [PE.col("s"), PE.col("k")], aggs(PORT_NS, AggExpr),
            PortSource(pbs))
        jo, po = list(j.execute()), list(p.execute())
        assert_same_rows(jo, po, ordered=True)
        assert po[0].row_count() > 30

    def test_average_partial_then_final(self):
        """Average's partial buffers (f64 sum, i64 count) per batch match the
        JAX engine's, and the final side over them gives the JAX engine's
        complete answer."""
        jbs, pbs = _batches(n=600, seed=8, parts=3)

        def aggs(m, A):
            return [A(m.Average(m.col("x")), "ax"),
                    A(m.Average(m.col("i")), "ai"),
                    A(m.Count(m.lit(1)), "n")]
        keys = [JE.col("u")], [PE.col("u")]
        jp = list(jax_aggregate.TpuHashAggregateExec(
            keys[0], aggs(JAX_NS, JAggExpr), JaxSource(jbs),
            mode="partial").execute())
        pp = list(aggregate.TpuHashAggregateExec(
            keys[1], aggs(PORT_NS, AggExpr), PortSource(pbs),
            mode="partial").execute())
        assert len(jp) == len(pp) == 3
        assert pp[0].schema.names == ("u", "ax__p0", "ax__p1", "ai__p0",
                                      "ai__p1", "n__p0")
        for jb, pb in zip(jp, pp):  # one order of adds in a batch: exact
            assert_same_rows([jb], [pb])
        src = PortSource(pbs)
        final = aggregate.TpuHashAggregateExec(
            keys[1], aggs(PORT_NS, AggExpr),
            PortSource([coalesce.concat_batches(pp)]), mode="final",
            agg_bind_schema=src.output, partitioned_input=True)
        got = batch_to_arrow(list(final.execute())[0]).sort_by("u")
        complete = jax_aggregate.TpuHashAggregateExec(
            keys[0], aggs(JAX_NS, JAggExpr), JaxSource(jbs))
        want = jax_batch_to_arrow(list(complete.execute())[0]).sort_by("u")
        assert got.column("u").equals(want.column("u"))
        assert got.column("n").equals(want.column("n"))
        for c in ("ax", "ai"):
            assert got.column(c).is_null().equals(want.column(c).is_null())
            np.testing.assert_allclose(got.column(c).drop_null().to_numpy(),
                                       want.column(c).drop_null().to_numpy(),
                                       rtol=1e-9)


_LONG_STRING_CASES = ("string_over_head_width", "string_literal_over_256",
                      "string_over_256_under_a_wider_head_width_conf")


def _long_string_case_equals_jax(case):
    """One string case past 256 bytes on both engines, exact (the JAX
    engine's head width is its default conf's, 256; the port reads the
    session's)."""
    t = pa.table({"k": np.arange(4, dtype=np.int64),
                  "s": ["a", "b", "x" * 300, "d"]})
    conf = {"spark.rapids.sql.explain": "NONE"}
    if case == "string_over_256_under_a_wider_head_width_conf":
        conf["spark.rapids.tpu.string.headWidth"] = 512
        t = pa.table({"s": ["y" * 300, "y" * 300, "z"]})
    outs = []
    for sess, m in ((JaxSession(conf), JE),
                    (TpuSession(conf, device="cpu"), PE)):
        df = sess.from_arrow(t)
        if case == "string_over_head_width":
            df = df.filter(m.col("k") >= 1)
        elif case == "string_literal_over_256":
            df = df.filter(m.col("s") == m.lit("x" * 300))
        else:
            df = df.group_by("s").agg(n=m.Count(m.lit(1)))
        outs.append(df.collect().sort_by("s"))
    assert outs[0].equals(outs[1])
    assert outs[1].num_rows == {"string_over_head_width": 3,
                                "string_literal_over_256": 1}.get(case, 2)


# --------------------------------------------------------------------------
class TestBoundaries:
    @pytest.mark.parametrize("case", [
        "decimal_column", "string_over_head_width", "min_over_string",
        "max_over_string", "average_over_decimal", "least_over_strings",
        "string_vs_int_compare", "string_literal_over_256",
        "string_over_256_under_a_wider_head_width_conf"])
    def test_out_of_slice_raises_at_plan_time(self, case):
        """What the port refuses raises while planning; the string cases
        that once did (past 256 bytes) now run and equal the JAX
        engine."""
        sess = TpuSession(device="cpu")
        t = pa.table({"k": np.arange(4, dtype=np.int64),
                      "s": ["a", "b", "c", "d"]})
        df = sess.from_arrow(t)
        c = PE.col
        if case == "decimal_column":  # over 18 digits: no JAX Divide
            df = sess.from_arrow(t.append_column(
                "d", pa.array([decimal.Decimal("1.25")] * 4,
                              pa.decimal128(20, 2)))).select(
                x=c("d") / PE.lit(2))
        elif case in _LONG_STRING_CASES:
            # the long-string layout runs these: each equals the JAX engine
            _long_string_case_equals_jax(case)
            return
        elif case in ("min_over_string", "max_over_string"):
            # grouped MIN/MAX over strings run; a bounded window frame over
            # them does not, in either engine
            fn = PE.Min if case == "min_over_string" else PE.Max
            df = df.window(["k"], ["s"], m=PE.WindowAggregate(
                fn(c("s")), PE.RowFrame(-1, 1)))
        elif case == "average_over_decimal":
            # a grouped average over decimal(15,2) runs (its partial sum,
            # decimal(25,2), in limbs); a window average over it does not
            df = df.window(["k"], ["s"], a=PE.WindowAggregate(
                PE.Average(PE.lit(1, T.DecimalType(15, 2)))))
        elif case == "least_over_strings":
            df = df.select(x=PE.Least(c("s"), PE.lit("b")))
        else:
            df = df.filter(c("s") == PE.lit(3))
        with pytest.raises(NotImplementedError):
            df.explain()  # planning alone raises, before any data moves

    def test_jax_form_join_condition_reaches_the_planner(self):
        """The JAX signature's `condition=` (here a keyless join, so the
        nested-loop exec) gives the JAX engine's rows."""
        a = pa.table({"x": np.arange(3, dtype=np.int64)})
        b = pa.table({"y": np.array([2, 0, 2, 5], dtype=np.int64)})

        def run(sess, m):
            return sess.from_arrow(a).join(
                sess.from_arrow(b), condition=m.col("x") == m.col("y"))

        got = run(TpuSession(BASE, device="cpu"), PE).collect()
        want = run(JaxSession(BASE), JE).collect()
        assert got.sort_by("y").to_pylist() == \
            want.sort_by("y").to_pylist() == \
            [{"x": 0, "y": 0}, {"x": 2, "y": 2}, {"x": 2, "y": 2}]

    def test_literal_and_batch_widths(self):
        ctx = EvalContext(torch.ones(5, dtype=torch.bool))
        v = PE.lit("héllo").eval(ctx, [])
        assert v.data.shape == (5, 8) and v.lengths.tolist() == [6] * 5
        assert v.data[0, 6:].tolist() == [0, 0]
        assert PE.lit(None, T.STRING).eval(ctx, []).data.shape == (5, 8)

    def test_string_literal_is_one_broadcast_row(self):
        """A string literal is copied to the device once and broadcast to
        the batch; padding to a wider width keeps it a zero-tailed
        broadcast, and compares against a column read it as rows."""
        lit = PE.lit("TN")
        ctx = EvalContext(torch.ones(6, dtype=torch.bool))
        v = lit.eval(ctx, [])
        assert v.data.stride(0) == 0 and v.data.shape == (6, 8)
        assert lit.eval(ctx, []).data.data_ptr() == v.data.data_ptr()
        wide = pad_width(v.data, 24)
        assert wide.stride(0) == 0 and wide.shape == (6, 24)
        assert wide[3].tolist() == [ord("T"), ord("N")] + [0] * 22
        col = Vec(T.STRING, torch.from_numpy(np.zeros((6, 24), np.uint8)),
                  torch.ones(6, dtype=torch.bool),
                  torch.full((6,), 2, dtype=torch.int32))
        col.data[::2, :2] = torch.tensor([ord("T"), ord("N")],
                                         dtype=torch.uint8)
        assert string_equal(col, v).tolist() == [True, False] * 3
        assert string_equal(v, col).tolist() == [True, False] * 3
