"""The long-string layout of spark_rapids_tpu_torch (head byte matrix +
shared tail blob + per-row tail offsets, `columnar/strings.py`) against
the JAX package: the ports of tests/test_long_strings.py's layout,
traversal, healing and regression classes (its shuffle-serializer class
waits for the host shuffle manager), the leaves bit for bit, the spill
catalog, the exchange's tail-byte plane and the host boundary.

A 1 MB string and a 300-byte one go through parquet scan, filter,
broadcast and shuffled joins, the exchange, a sort by another key, the
spill catalog and collect on device="cpu", equal to the JAX engine's
collect() and collect_cpu(). Every comparison is exact: these are
strings, counts and integer-valued doubles."""

import dataclasses

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.columnar.column import from_arrow as jax_from_arrow
from spark_rapids_tpu.columnar.strings import \
    build_string_leaves as jax_build_string_leaves, \
    compact_tails as jax_compact_tails
from spark_rapids_tpu.exec.coalesce import \
    rebucket_string_widths as jax_rebucket
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession
import spark_rapids_tpu.expr as JE

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow, \
    batch_to_arrow
from spark_rapids_tpu_torch.columnar.column import from_arrow, to_arrow
from spark_rapids_tpu_torch.columnar import strings as port_strings
from spark_rapids_tpu_torch.columnar.strings import build_string_leaves, \
    compact_tails, tails_from_matrix
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.errors import CpuFallbackRequired
from spark_rapids_tpu_torch.exec import exchange
from spark_rapids_tpu_torch.exec.base import batch_vecs, vecs_to_batch
from spark_rapids_tpu_torch.exec.coalesce import TpuCoalesceBatchesExec, \
    concat_batches, rebucket_string_widths
from spark_rapids_tpu_torch.exec.transitions import device_batch_to_host, \
    host_batch_to_device
from spark_rapids_tpu_torch.memory.budget import MemoryBudget
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog, StorageTier
from spark_rapids_tpu_torch.ops.rowops import compact_vecs
from spark_rapids_tpu_torch.plan.nodes import HashPartitionSpec
from spark_rapids_tpu_torch.plugin import TpuSession
from spark_rapids_tpu_torch.utils.metrics import TaskMetrics
from torch_port import PortSource, port_batch

BASE = {"spark.rapids.sql.explain": "NONE"}
MESH = dict(BASE, **{"spark.rapids.shuffle.mode": "ICI",
                     "spark.rapids.tpu.mesh.shape": "shuffle=4",
                     "spark.rapids.tpu.fusion.enabled": True})
BIG = "x" * (1 << 20) + "END"          # ~1 MB
MED = "m" * 5000                       # past the head width, < 8 KB
T300 = "q" * 299 + "é"                 # 301 bytes, a multi-byte tail
# the host engine holds strings as the flat matrix at the longest row's
# bucket, so the cases that rerun there carry 3 KB rather than 1 MB
LONG = "z" * 3000 + "END"


def mixed_strings(n=40, big_at=(3, 17), big=BIG):
    vals = [f"short-{i}" for i in range(n)]
    for i in big_at:
        vals[i] = big
    vals[7] = MED
    vals[9] = T300
    vals[11] = None
    return vals


def _fact(n=64, big=BIG):
    return pa.table({
        "k": pa.array(np.arange(n) % 8, type=pa.int64()),
        "v": pa.array(np.arange(n, dtype=np.float64)),
        "s": pa.array(mixed_strings(n, big=big)),
    })


def _sessions(conf=BASE):
    return JaxSession(dict(conf)), TpuSession(dict(conf), device="cpu")


class TestLayout:
    def test_roundtrip_exact(self):
        arr = pa.array(mixed_strings())
        col_, n = from_arrow(arr, "cpu", head=256)
        assert col_.overflow is not None
        assert col_.data.shape[1] == 256  # the head, not the 1 MB width
        assert to_arrow(col_, n).to_pylist() == arr.to_pylist()

    def test_short_columns_unchanged(self):
        arr = pa.array(["a", "bb", None, "ccc"])
        col_, n = from_arrow(arr, "cpu", head=256)
        assert col_.overflow is None and col_.data.shape[1] == 8
        assert to_arrow(col_, n).to_pylist() == arr.to_pylist()

    def test_peak_bytes_bounded(self):
        vals = mixed_strings(n=1000)
        raw = sum(len(v.encode()) for v in vals if v is not None)
        b = batch_from_arrow(pa.table({"s": vals}), "cpu")
        assert b.device_memory_size() < 4 * raw
        assert b.device_memory_size() < 16 * (1 << 20)

    @pytest.mark.parametrize("hw", [8, 64, 256])
    def test_leaves_bit_for_bit(self, hw):
        """build_string_leaves and from_arrow give the JAX leaves, bit for
        bit, at each head width."""
        rng = np.random.default_rng(hw)
        vals = ["".join(rng.choice(list("abcé"), rng.integers(0, 400)))
                for _ in range(50)]
        vals[5] = None
        arr = pa.array(vals, pa.large_string())
        offsets = np.frombuffer(arr.buffers()[1], np.int64)
        databuf = np.frombuffer(arr.buffers()[2], np.uint8)
        lens = np.where(np.asarray(arr.is_valid()), np.diff(offsets), 0) \
            .astype(np.int32)
        want = jax_build_string_leaves(databuf, offsets, lens, 128,
                                       _JaxConf(hw))
        got = build_string_leaves(databuf, offsets, lens, 128, hw)
        for a, b in zip(want[:2] + want[2], got[:2] + got[2]):
            assert a.dtype == b.dtype and (a == b).all()
        if hw == 256:
            jc = jax_from_arrow(arr)[0]
            pc = from_arrow(arr, "cpu", head=256)[0]
            for a, b in zip((jc.data, jc.lengths) + tuple(jc.overflow),
                            (pc.data, pc.lengths) + tuple(pc.overflow)):
                assert (np.asarray(a) == b.numpy()).all()


class _JaxConf:
    """The JAX `head_width(conf)` reads one key of its conf."""

    def __init__(self, hw):
        self.hw = hw

    def get(self, key):
        assert key == "spark.rapids.tpu.string.headWidth"
        return self.hw


class TestEngineTraversal:
    def test_scan_filter_join_collect(self, tmp_path):
        """The acceptance query on both plans and both joins: the 1 MB
        string is carried (scanned, filtered, joined, exchanged, sorted by
        another key, collected) and never read on the device."""
        path = str(tmp_path / "long.parquet")
        pq.write_table(_fact(), path)
        dim = pa.table({"k": pa.array([1, 3, 5], type=pa.int64()),
                        "w": pa.array([1.0, 2.0, 3.0])})
        outs = {}
        for name, conf in (("one", BASE), ("mesh", MESH), ("shuffled", dict(
                MESH, **{"spark.rapids.sql.autoBroadcastJoinThreshold":
                         -1}))):
            jsess, psess = _sessions(conf)
            qs = [s.read_parquet(path).filter(m.col("v") < 40).join(
                s.from_arrow(dim), on="k", how="inner").sort("v")
                for s, m in ((jsess, JE), (psess, PE))]
            before = exchange.MESH_EXCHANGES
            got = qs[1].collect()
            assert TaskMetrics.get().cpu_fallback_reruns == 0
            if name == "shuffled":  # both sides crossed the exchange
                assert exchange.MESH_EXCHANGES - before == 2
            outs[name] = got
            if name == "one":
                assert got.equals(qs[0].collect())
                assert got.equals(qs[0].collect_cpu())
        assert outs["one"].equals(outs["mesh"])
        assert outs["one"].equals(outs["shuffled"])
        joined = outs["one"].column("s").to_pylist()
        assert joined.count(BIG) == 2 and T300 in joined  # rows 3, 17, 9

    def test_peak_device_bytes_during_query(self, tmp_path):
        """No batch holds the column as cap x 1 MB: with headWidth=256 the
        root's batches stay within a small factor of the raw bytes."""
        path = str(tmp_path / "long.parquet")
        pq.write_table(_fact(256), path)
        sess = TpuSession(BASE, device="cpu")
        q = sess.read_parquet(path).filter(PE.col("v") < 100).sort("v")
        peak = 0
        for b in sess.plan_device(q.plan).execute():
            peak = max(peak, b.device_memory_size())
        assert 0 < peak < 16 * (1 << 20)  # flat: >= 256 MB a batch

    def test_byte_op_falls_back_but_answers(self):
        t = _fact(big=LONG)
        for expr in ("length", "substring", "like"):
            outs = []
            for s, m in zip(_sessions(), (JE, PE)):
                e = {"length": lambda: m.Length(m.col("s")),
                     "substring": lambda: m.Substring(
                         m.col("s"), m.lit(-4), m.lit(3)),
                     "like": lambda: m.Like(m.col("s"),
                                            m.lit("%END"))}[expr]()
                outs.append(s.from_arrow(t).select("v", o=e).collect())
            assert TaskMetrics.get().cpu_fallback_reruns == 1
            assert outs[0].sort_by("v").equals(outs[1].sort_by("v"))

    def test_groupby_on_other_key_carries_count(self):
        t = _fact()
        outs = [s.from_arrow(t).filter(m.col("v") >= 0).group_by("k").agg(
            n=m.Count(m.col("s")), sv=m.Sum(m.col("v"))).collect()
            .sort_by("k") for s, m in zip(_sessions(), (JE, PE))]
        assert TaskMetrics.get().cpu_fallback_reruns == 0
        assert outs[0].equals(outs[1])

    def test_sort_on_long_string_falls_back(self):
        t = _fact(32, big=LONG)
        jsess, psess = _sessions()
        got = psess.from_arrow(t).sort("s").collect()
        assert TaskMetrics.get().cpu_fallback_reruns == 1
        assert got.equals(jsess.from_arrow(t).sort("s").collect_cpu())


class TestCoalesceHealing:
    def test_filter_drops_long_rows_then_heals(self):
        """After the filter removes every long row, the coalesce heals the
        column to the flat layout, at the width JAX's function gives."""
        n = 200
        vals = [BIG if i < 3 else f"s{i}" for i in range(n)]
        t = pa.table({"i": pa.array(range(n), type=pa.int64()),
                      "s": pa.array(vals)})
        jsess, psess = _sessions()
        jdf = jsess.from_arrow(t).filter(JE.col("i") >= 3)
        jsess.initialize_device()
        jb, = list(JaxOverrides(jsess.conf).apply(jdf.plan).execute())
        pdf = psess.from_arrow(t).filter(PE.col("i") >= 3)
        pb, = list(psess.plan_device(pdf.plan).execute())
        jh, ph = jax_rebucket(jb), rebucket_string_widths(pb)
        assert ph.columns[1].overflow is None
        assert ph.columns[1].data.shape == tuple(jh.columns[1].data.shape)
        assert ph.columns[1].data.shape[1] <= 8
        assert batch_to_arrow(ph).equals(batch_to_arrow(pb))

    def test_blob_gc_compacts(self):
        """The blob collection equals JAX's, bit for bit."""
        lens = np.array([300, 10, 500], np.int32)
        blob = np.zeros(4096, np.uint8)
        blob[0:44] = 1    # row 0's tail (300 - 256)
        blob[44:288] = 2  # row 2's tail (500 - 256)
        ts = np.array([0, 0, 44], np.int32)
        live = np.array([False, True, True])
        want = jax_compact_tails(lens, (blob, ts), live, 256)
        got = [t.numpy() for t in compact_tails(
            torch.from_numpy(lens), (torch.from_numpy(blob),
                                     torch.from_numpy(ts)),
            torch.from_numpy(live), 256)]
        assert got[0].dtype == want[0].dtype and \
            got[1].dtype == want[1].dtype
        assert (want[0] == got[0]).all() and (want[1] == got[1]).all()
        assert (got[0][got[1][2]:got[1][2] + 244] == 2).all()

    def test_coalesce_exec_heals_and_collects(self):
        """TpuCoalesceBatchesExec over batches of mixed layouts: one batch
        whose blob holds only its live rows' tails, the JAX rows."""
        vals = mixed_strings(40)
        t = pa.table({"i": pa.array(range(40), type=pa.int64()),
                      "s": pa.array(vals)})
        parts = [t.slice(0, 20), t.slice(20, 20)]
        jbs = [jax_batch_from_arrow(p) for p in parts]
        pbs = [port_batch(jb) for jb in jbs]
        # a filter keeps one long row: the blob is mostly dead
        keep = torch.zeros(pbs[0].capacity, dtype=torch.bool)
        keep[[3, 4, 5]] = True
        vecs, cnt = compact_vecs(batch_vecs(pbs[0]), keep)
        filtered = vecs_to_batch(pbs[0].schema, vecs, cnt)
        out, = list(TpuCoalesceBatchesExec(
            PortSource([filtered, pbs[1]])).execute())
        s = out.columns[1]
        assert s.overflow is not None
        live_tail = sum(max(len(v.encode()) - 256, 0)
                        for v in vals[3:6] + vals[20:] if v is not None)
        assert s.overflow[0].shape[0] <= 2 * max(live_tail, 1024)
        want = pa.concat_tables([t.slice(3, 3), t.slice(20, 20)])
        assert batch_to_arrow(out).equals(want)


class TestReviewRegressions:
    @pytest.mark.parametrize("kind", ["if", "case_when", "coalesce",
                                      "concat"])
    def test_conditional_over_long_string_answers(self, kind):
        """If/CaseWhen/Coalesce/Concat over a long column rerun on the
        host and never cut at the head width."""
        n = 20
        vals = [LONG if i == 2 else f"s{i}" for i in range(n)]
        vals[5] = None
        t = pa.table({"v": pa.array(np.arange(n, dtype=np.float64)),
                      "s": pa.array(vals)})
        outs = []
        for s, m in zip(_sessions(), (JE, PE)):
            c = m.col
            e = {"if": lambda: m.If(c("v") > 1.0, c("s"), m.lit("tiny")),
                 "case_when": lambda: m.CaseWhen(
                     [(c("v") > 1.0, c("s"))], m.lit("tiny")),
                 "coalesce": lambda: m.Coalesce(c("s"), m.lit("null")),
                 "concat": lambda: m.Concat(c("s"), m.lit("!"))}[kind]()
            outs.append(s.from_arrow(t).select("v", out=e).collect()
                        .sort_by("v"))
        assert TaskMetrics.get().cpu_fallback_reruns == 1
        assert outs[0].equals(outs[1])
        got = outs[1].column("out").to_pylist()[2]
        assert got == (LONG + "!" if kind == "concat" else LONG)

    def test_empty_batch_keeps_its_blob(self):
        """A zero-row batch whose column still carries the blob concats
        with a full one (the JAX serializer case, through concat)."""
        vals8 = [BIG if i == 2 else f"s{i}" for i in range(8)]
        full = batch_from_arrow(pa.table({"s": pa.array(vals8)}), "cpu")
        empty = dataclasses.replace(full, num_rows=torch.tensor(
            0, dtype=torch.int32))
        out = concat_batches([empty, full])
        assert batch_to_arrow(out).column("s").to_pylist() == vals8


@pytest.fixture()
def own_budget():
    """An unlimited budget of the test's own: a read-back reserves its
    bytes in the process budget, which later tests must not inherit."""
    saved = MemoryBudget._instance
    MemoryBudget.initialize(1 << 62)
    try:
        yield
    finally:
        MemoryBudget._instance = saved


class TestBoundaries:
    def test_spill_to_host_and_disk_bit_for_bit(self, tmp_path, own_budget):
        """A long-string batch parked, spilled to the host and to disk,
        and read back: every tensor, the blob included, bit for bit."""
        b = batch_from_arrow(pa.table({"s": mixed_strings(40)}), "cpu")
        want = batch_to_arrow(b)
        before = [x.clone() for x in b.flatten()[0]]
        for tier, limit in (("host", 1 << 30), ("disk", 1)):
            cat = BufferCatalog(spill_dir=str(tmp_path), host_limit=limit,
                                spill_codec="zstd")
            h = cat.add_batch(b)
            assert cat.synchronous_spill(1) > 0
            assert cat.tier_of(h) == (StorageTier.DISK if tier == "disk"
                                      else StorageTier.HOST)
            back = cat.acquire_batch(h)
            after = back.flatten()[0]
            assert back.columns[0].overflow is not None
            assert all(torch.equal(x, y) for x, y in zip(before, after))
            assert batch_to_arrow(back).equals(want)
            cat.remove(h)

    def test_host_boundary_flattens_and_relays(self):
        """To the host: the flat matrix at the longest row's bucket; back
        to the device: the long-string layout at the conf's head."""
        b = batch_from_arrow(pa.table({"s": mixed_strings(40, big=LONG)}),
                             "cpu")
        hb = device_batch_to_host(b)
        assert hb.columns[0].overflow is None
        assert hb.columns[0].data.shape[1] == 8192  # bucket of MED
        back = host_batch_to_device(hb, torch.device("cpu"), TpuConf(
            {"spark.rapids.tpu.string.headWidth": 64}))
        assert back.columns[0].data.shape[1] == 64
        assert batch_to_arrow(back).equals(batch_to_arrow(b))

    def test_tails_from_matrix_concat(self):
        """A flat column wider than the head meets a long one in concat:
        its bytes past the head move into the tail."""
        wide = batch_from_arrow(pa.table({"s": ["w" * 400, "v"]}), "cpu",
                                flat=True)
        long = batch_from_arrow(pa.table({"s": [BIG, "u"]}), "cpu")
        head, blob, ts = tails_from_matrix(wide.columns[0].data, 256)
        assert head.shape[1] == 256 and int(ts[1]) == 512 - 256
        out = concat_batches([wide, long])
        assert out.columns[0].data.shape[1] == 256
        assert batch_to_arrow(out).column("s").to_pylist() == \
            ["w" * 400, "v", BIG, "u"]

    def test_exchange_tail_plane(self):
        """The exchange over four mesh positions: each position gets the
        rows whose key hashes to it, long strings whole (the tails cross
        in the byte plane), and the positions together hold every row."""
        t = _fact(64)
        b = batch_from_arrow(t, "cpu")
        ex = exchange.TpuShuffleExchangeExec(
            HashPartitionSpec([PE.col("k")], 4), PortSource([b]),
            TpuConf(MESH))
        outs = list(ex.execute())
        assert len(outs) == 4
        got = pa.concat_tables([batch_to_arrow(o) for o in outs])
        assert got.sort_by("v").equals(t)
        for p, o in enumerate(outs):
            pid = ex.partitioner.ids_for_batch(o)[:o.row_count()]
            assert (pid == p).all()
            if o.columns[2].overflow is not None:  # blob: live tails only
                live = sum(max(len(v.encode()) - 256, 0) for v in
                           batch_to_arrow(o).column("s").to_pylist()
                           if v is not None)
                assert o.columns[2].overflow[0].shape[0] <= 2 * live + 1024
        assert sum(o.columns[2].overflow is not None for o in outs) >= 1



@pytest.fixture()
def small_blobs(monkeypatch):
    """The int32 tail offsets' reach lowered to 4 KiB."""
    monkeypatch.setattr(port_strings, "MAX_BLOB_BYTES", 4096)


class TestBlobOffsets:
    """tail_start is int32, so a blob past its reach raises
    CpuFallbackRequired wherever one is sized, rather than wrap."""

    @pytest.mark.parametrize("site", ["from_arrow", "concat",
                                      "tails_from_matrix", "compact_tails"])
    def test_past_the_reach_raises(self, small_blobs, site):
        one = pa.table({"s": [LONG, "u"]})  # a 2,747-byte tail, 4 KiB blob
        run = {
            "from_arrow": lambda: batch_from_arrow(
                pa.table({"s": [MED, "u"]}), "cpu"),
            "concat": lambda: concat_batches(
                [batch_from_arrow(one, "cpu") for _ in range(2)]),
            "tails_from_matrix": lambda: tails_from_matrix(
                torch.zeros((64, 512), dtype=torch.uint8), 256),
            "compact_tails": lambda: compact_tails(
                torch.tensor([5000, 5000], dtype=torch.int32),
                (torch.zeros(16384, dtype=torch.uint8),
                 torch.tensor([0, 4744], dtype=torch.int32)),
                torch.tensor([True, True]), 256)}[site]
        with pytest.raises(CpuFallbackRequired, match="int32"):
            run()
        batch_from_arrow(one, "cpu")  # one blob under the reach is fine

    def test_plan_reruns_on_the_host(self, small_blobs):
        """A scan whose blob would pass the reach reruns the plan on the
        host once and answers as the JAX engine does."""
        t = _fact(big=LONG)
        outs = [s.from_arrow(t).filter(m.col("k") >= 1).select("v", "s")
                .collect().sort_by("v")
                for s, m in zip(_sessions(), (JE, PE))]
        assert TaskMetrics.get().cpu_fallback_reruns == 1
        assert outs[0].equals(outs[1])
        assert LONG in outs[1].column("s").to_pylist()
