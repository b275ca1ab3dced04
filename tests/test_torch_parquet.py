"""The parquet scan of spark_rapids_tpu_torch (io/parquet_device.py,
io/scanbase.py, io/dynamic_pruning.py, native.py, the prefetch seam and the
planner hooks) against the JAX package's and against pyarrow, on the CPU.

Files are written by pyarrow from numpy seeds: a few thousand rows in
several row groups, as dictionary pages, PLAIN pages, dictionary pages that
spill to PLAIN inside a chunk, and many small pages with nulls, snappy and
uncompressed. The JAX package decodes them as its own
tests/test_parquet_device.py runs it here: its native library is not built,
so it takes its Python page walk.

Tolerance: exact everywhere (decoded values, validity, strings, integer
sums, counts, plans' shapes), except f64 sums and averages of the star
query, held to rtol 1e-9 because the engines may add in another order."""

import re
import sys
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar import batch_to_arrow as jax_batch_to_arrow
from spark_rapids_tpu.io import dynamic_pruning as jax_dpp
from spark_rapids_tpu.io import parquet_device as JP
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import Schema, batch_to_arrow
from spark_rapids_tpu_torch.exec.base import PrefetchIterator
from spark_rapids_tpu_torch.io import dynamic_pruning as dpp
from spark_rapids_tpu_torch.io import parquet_device as P
from spark_rapids_tpu_torch.plugin import TpuSession

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_star import JAX_NS, PORT_NS, _assert_tables  # noqa: E402
from torch_port import positional  # noqa: E402

CPU = torch.device("cpu")
FU = "spark.rapids.tpu.fusion.enabled"
BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 1024, FU: True}
MESH = dict(BASE, **{"spark.rapids.shuffle.mode": "ICI",
                     "spark.rapids.tpu.mesh.shape": "shuffle=4"})
DPP_OFF = {"spark.rapids.sql.dynamicFilePruning.enabled": False}
N = 3000

# file layouts: pyarrow.parquet.write_table arguments
LAYOUTS = {
    "dict": dict(use_dictionary=True, compression="snappy"),
    "plain": dict(use_dictionary=False, compression="none"),
    # the dictionary outgrows its page: dictionary pages, then PLAIN pages
    "spill": dict(use_dictionary=True, compression="snappy",
                  dictionary_pagesize_limit=512, data_page_size=1024),
    "small_pages": dict(use_dictionary=True, compression="none",
                        data_page_size=256),
}


def kinds_table(seed: int = 3, n: int = N) -> pa.Table:
    """One column of each kind the slice decodes, 20 % null: bool, int32,
    int64, float64, date, and a string with long and empty values."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.2
    words = np.array([f"w{i:04d}" + "x" * (i % 37) for i in range(400)] +
                     [""], dtype=object)
    return pa.table({
        "b": pa.array(rng.integers(0, 2, n).astype(bool), mask=mask),
        "i": pa.array(rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
                      .astype(np.int32), mask=mask),
        "l": pa.array(rng.integers(0, 700, n) * 10 ** 12, mask=mask),
        "d": pa.array(rng.normal(0, 1e6, n), mask=mask),
        "dt": pa.array(rng.integers(0, 40_000, n).astype(np.int32),
                       pa.date32(), mask=mask),
        "s": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                      pa.string(), mask=mask),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq")
    t = kinds_table()
    out = {}
    for name, kw in LAYOUTS.items():
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(t, out[name], row_group_size=1500, **kw)
    return out


def _chunk_bytes(path, rg, ci):
    pf = pq.ParquetFile(path)
    cm = pf.metadata.row_group(rg).column(ci)
    optional = pf.metadata.schema.column(ci).max_definition_level > 0
    with open(path, "rb") as f:
        f.seek(cm.dictionary_page_offset or cm.data_page_offset)
        return f.read(cm.total_compressed_size), cm, optional


def _expand(runs, ndef, bw):
    """A run table's values, on the host."""
    kinds, counts, values, bitoffs, packed = runs
    bits = np.unpackbits(np.asarray(packed), bitorder="little")
    out = []
    for k, c, v, bo in zip(kinds, counts, values, bitoffs):
        c = int(c)
        if k == 0:
            out.extend([int(v)] * c)
        else:
            sl = bits[bo:bo + c * bw].reshape(c, bw).astype(np.uint64)
            out.extend((sl << np.arange(bw, dtype=np.uint64))
                       .sum(axis=1).tolist())
    return out[:ndef]


def _def_levels(chunk):
    if chunk.def_runs_merged is not None:
        return _expand(chunk.def_runs_merged, chunk.total, 1)
    parts = [p.runs for p in chunk.pages if p.runs is not None]
    return _expand(P._merge_runs(parts), chunk.total, 1) if parts else None


def _payload_bytes(p):
    if isinstance(p.payload, np.ndarray):
        return p.payload.view(np.uint8).tobytes()
    return bytes(p.payload)


def _hybrid(rng, bw: int, runs: int = 40):
    """An RLE/bit-packed hybrid stream of `runs` runs at bit width bw, and
    the values it holds."""
    out, vals = bytearray(), []

    def varint(v):
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)

    for _ in range(runs):
        if rng.random() < 0.5:
            count = int(rng.integers(1, 300))
            v = int(rng.integers(0, 2 ** bw))
            varint(count << 1)
            out.extend(v.to_bytes((bw + 7) // 8, "little"))
            vals.extend([v] * count)
        else:
            groups = int(rng.integers(1, 6))
            vs = rng.integers(0, 2 ** bw, groups * 8, dtype=np.uint64)
            varint((groups << 1) | 1)
            bits = ((vs[:, None] >> np.arange(bw, dtype=np.uint64)) & 1)
            out.extend(np.packbits(bits.astype(np.uint8).ravel(),
                                   bitorder="little").tobytes())
            vals.extend(int(v) for v in vs)
    return bytes(out), vals


# --------------------------------------------------------------------------
def _walks_agree(path):
    """Every column chunk of row group 0: native walk == the port's Python
    walk == the JAX package's Python walk (pages, counts, payloads,
    dictionary, def levels, indices). Returns the last native chunk."""
    pf = pq.ParquetFile(path)
    for ci in range(pf.metadata.num_columns):
        buf, cm, optional = _chunk_bytes(path, 0, ci)
        nat = P._decode_chunk(buf, cm, optional)
        twin = P._decode_chunk_py(buf, cm, optional)
        ref = JP._decode_chunk_inner(buf, cm, optional)
        for other in (twin, ref):
            assert nat.total == other.total
            assert nat.dict_count == other.dict_count
            if other.dict_raw is not None:
                assert bytes(nat.dict_raw) == bytes(other.dict_raw)
            assert _def_levels(nat) == _def_levels(other)
            assert len(nat.pages) == len(other.pages)
            for a, b in zip(nat.pages, other.pages):
                assert (a.kind, a.bw, a.num_values, a.ndef) == \
                    (b.kind, b.bw, b.num_values, b.ndef)
                if a.kind == "plain":
                    assert _payload_bytes(a) == _payload_bytes(b)
                elif a.payload is not None:
                    assert _expand(a.payload, a.ndef, a.bw) == \
                        _expand(b.payload, b.ndef, b.bw)
    return nat


class TestNativeWalk:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_chunk_walk_matches_python_twins(self, files, layout):
        """native walk == the port's Python walk == the JAX package's Python
        walk: pages, counts, payloads, dictionary, def levels, indices."""
        nat = _walks_agree(files[layout])
        if layout == "spill":
            kinds = {p.kind for p in nat.pages}
            assert kinds == {"dict", "plain"}, kinds

    @pytest.mark.parametrize("layout", ["flba", "flba_plain", "int96"])
    def test_fixed_byte_chunks_match_python_twins(self, new_files, layout):
        """The same three walks over FIXED_LEN_BYTE_ARRAY decimals and
        INT96 timestamps, whose values pass through as their bytes."""
        _walks_agree(new_files[layout])

    @pytest.mark.parametrize("bw", [1, 3, 10, 17, 32])
    def test_rle_scan_matches_python_twins(self, bw):
        rng = np.random.default_rng(bw)
        stream, want = _hybrid(rng, bw)
        nat = native.rle_scan(np.frombuffer(stream, np.uint8), len(want), bw)
        twin = P._rle_runs(memoryview(stream), len(want), bw)
        ref = JP._rle_runs(memoryview(stream), len(want), bw)
        for other in (twin, ref):
            for a, b in zip(nat, other):
                assert np.array_equal(a, b)
        assert _expand(nat, len(want), bw) == want
        with pytest.raises(ValueError):
            native.rle_scan(np.frombuffer(stream[:-3], np.uint8), len(want),
                            bw)
        # the Python walk reads past a stream cut inside a varint as an
        # IndexError, which _decode_chunk_py reports as the same exception
        with pytest.raises((P.DeviceDecodeUnsupported, IndexError)):
            P._rle_runs(memoryview(stream[:-3]), len(want), bw)

    def test_page_headers_match_jax_parser(self, files):
        buf, cm, _ = _chunk_bytes(files["spill"], 0, 5)
        mv, pos, n = memoryview(buf), 0, 0
        while pos < len(buf):
            a = P._parse_page_header(mv, pos)
            b = JP._parse_page_header(mv, pos)
            assert all(getattr(a, f) == getattr(b, f)
                       for f in P._PageHeader.__slots__)
            pos += a.header_len + a.compressed
            n += 1
        assert n > 2 and pos == len(buf)

    def test_byte_array_scan_matches_python_twin(self, files):
        buf, cm, optional = _chunk_bytes(files["plain"], 0, 5)
        chunk = P._decode_chunk(buf, cm, optional)
        p = chunk.pages[0]
        blob = np.frombuffer(_payload_bytes(p), np.uint8)
        nat = native.byte_array_scan(blob, p.ndef)
        twin = P._byte_array_scan_py(blob, p.ndef)
        assert all(np.array_equal(a, b) for a, b in zip(nat[:2], twin[:2]))
        assert nat[2] == twin[2] > 0
        for scan in (native.byte_array_scan, P._byte_array_scan_py):
            with pytest.raises(ValueError):
                scan(blob[:-1], p.ndef)


# --------------------------------------------------------------------------
def _jax_schema(path):
    return JaxSession(BASE).read_parquet(path).plan.output


def _port_schema(path):
    return Schema.from_arrow(pq.read_schema(path))


class TestDecode:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_each_kind_matches_jax_and_pyarrow(self, files, layout):
        """Every column kind of every row group against pyarrow, and row
        group 0 against the JAX package's decode_row_group."""
        path = files[layout]
        pf = pq.ParquetFile(path)
        schema = _port_schema(path)
        JaxSession(BASE).initialize_device()
        with open(path, "rb") as f:
            for rg in range(pf.metadata.num_row_groups):
                b, n = P.decode_row_group(pf, f, rg, schema, CPU)
                got = batch_to_arrow(b)
                assert got.equals(pf.read_row_group(rg)), (layout, rg)
                assert n == got.num_rows == b.row_count()
                s = b.columns[schema.index_of("s")]
                assert not (s.data * (torch.arange(s.data.shape[1])[None, :]
                                      >= s.lengths[:, None])).any(), \
                    "bytes past a string's length must be zero"
            jb, _ = JP.decode_row_group(pf, f, 0, _jax_schema(path))
            pb, _ = P.decode_row_group(pf, f, 0, schema, CPU)
        assert jax_batch_to_arrow(jb).equals(batch_to_arrow(pb))

    def test_empty_file(self, tmp_path):
        path = str(tmp_path / "empty.parquet")
        pq.write_table(kinds_table().slice(0, 0), path)
        pf = pq.ParquetFile(path)
        got = [batch_to_arrow(b) for b, _ in P.device_decode_file(
            pf, path, _port_schema(path), CPU, 4)]
        assert sum(t.num_rows for t in got) == 0
        out = TpuSession(BASE, device="cpu").read_parquet(path).collect()
        assert out.num_rows == 0 and out.schema == pq.read_schema(path)

    def test_fused_four_chunk_decode_equals_serial(self, tmp_path):
        """7 row groups of 700, 700, ..., 300 rows: one packed group of 4
        and one of 3 with an odd tail, against row-group-by-row-group."""
        t = kinds_table(seed=5, n=4500)
        path = str(tmp_path / "rg7.parquet")
        pq.write_table(t, path, row_group_size=700, data_page_size=512)
        pf = pq.ParquetFile(path)
        schema = _port_schema(path)
        P.COUNTERS.reset()
        fused = list(P.device_decode_file(pf, path, schema, CPU, 4))
        counts = P.COUNTERS.snapshot()
        serial = list(P.device_decode_file(pf, path, schema, CPU, 1))
        assert [n for _, n in fused] == [2800, 1700]
        assert counts["fused_dispatches"] == 2 and \
            counts["declined_chunks"] == 0 and counts["scan_chunks"] == 7
        whole = pa.concat_tables([batch_to_arrow(b) for b, _ in fused])
        assert whole.equals(pa.concat_tables(
            [batch_to_arrow(b) for b, _ in serial]))
        assert whole.equals(pq.read_table(path))
        assert fused[0][0].capacity == 4096

    @pytest.mark.parametrize("declined", ["strings", "every_column"])
    @pytest.mark.parametrize("layout", ["dict", "spill"])
    def test_declined_group_decodes_row_group_by_row_group(
            self, files, monkeypatch, declined, layout):
        """A page layout the packed path declines (a dictionary page after
        a PLAIN one, which pyarrow does not write: forced here) decodes row
        group by row group through the eager assembles."""
        monkeypatch.setattr(P, "_prep_string", lambda chunk: None)
        if declined == "every_column":
            monkeypatch.setattr(P, "_prep_fixed", lambda chunk, phys: None)
        path = files[layout]
        pf = pq.ParquetFile(path)
        P.COUNTERS.reset()
        out = list(P.device_decode_file(pf, path, _port_schema(path), CPU, 4))
        assert P.COUNTERS.declined_chunks == 2 and \
            P.COUNTERS.fused_dispatches == 0
        assert pa.concat_tables([batch_to_arrow(b) for b, _ in out]).equals(
            pq.read_table(path))

    def test_packing_aligns_every_array(self):
        arrays = [np.arange(3, dtype=np.uint8), np.arange(5, dtype=np.int64),
                  np.array([True, False]), np.arange(3, dtype=np.uint32),
                  np.arange(4, dtype=np.float64)]
        packed, metas = P._pack_arrays(arrays)
        assert all(off % 8 == 0 for _, _, off in metas)
        dev = torch.from_numpy(packed)
        for a, m in zip(arrays, metas):
            got = P._unpack(dev, m)
            assert np.array_equal(got.numpy(), a.astype(
                np.int64) if a.dtype == np.uint32 else a)


# --------------------------------------------------------------------------
def _shape(plan: str):
    """A plan tree as (depth, node name) per line."""
    return [(len(ln) - len(ln.lstrip()), re.match(r"\s*(\w+)", ln).group(1))
            for ln in plan.splitlines() if ln.strip()]


@pytest.fixture(scope="module")
def query_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("q")
    fact, dim = cs.query_tables(pa, 3000, 300, 600, 37)
    paths = {"fact": str(d / "fact.parquet"), "dim": str(d / "dim.parquet")}
    pq.write_table(fact, paths["fact"], row_group_size=1024)
    pq.write_table(dim, paths["dim"])
    return fact, dim, paths


def _parquet_query(sess, ns, paths):
    c = ns.col
    return sess.read_parquet(paths["fact"]).filter(c("v") > ns.lit(0.6)) \
        .join(sess.read_parquet(paths["dim"]), on="k") \
        .group_by("g").agg(total=ns.Sum(c("c") + c("w")),
                           cnt=ns.Count(c("v")))


class TestQueries:
    @pytest.mark.parametrize("plan", ["one_device", "distributed"])
    def test_engine_query_matches_jax_engine(self, query_files, plan):
        fact, dim, paths = query_files
        conf = BASE if plan == "one_device" else MESH
        jsess = JaxSession(conf)
        jq = _parquet_query(jsess, JAX_NS, paths)
        want = jq.collect().sort_by("g")
        port = _parquet_query(TpuSession(conf, device="cpu"), PORT_NS, paths)
        got = port.collect().sort_by("g")
        assert got.equals(want)
        groups, total, cnt = cs.query_oracle(fact, dim)
        assert got.column("total").to_pylist() == total.tolist()
        # the broadcast join carries the dynamic-pruning filter, so neither
        # engine fuses it
        jplan = JaxOverrides(jsess.conf).apply(jq.plan).tree_string()
        assert _shape(port.explain()) == _shape(jplan)
        assert "TpuFusedStageExec" not in jplan
        assert "TpuFileScanExec" in jplan

    def test_engine_query_fuses_without_dynamic_pruning(self, query_files):
        fact, dim, paths = query_files
        conf = dict(BASE, **DPP_OFF)
        jsess = JaxSession(conf)
        jq = _parquet_query(jsess, JAX_NS, paths)
        port = _parquet_query(TpuSession(conf, device="cpu"), PORT_NS, paths)
        jplan = JaxOverrides(jsess.conf).apply(jq.plan).tree_string()
        assert _shape(port.explain()) == _shape(jplan)
        assert "TpuFusedStageExec" in port.explain()
        assert port.collect().sort_by("g").equals(jq.collect().sort_by("g"))

    @pytest.mark.parametrize("plan", ["one_device", "distributed"])
    def test_star_q7_matches_jax_engine(self, tmp_path, plan):
        star = cs.star_tables(pa, 2000, 365, 60, 8, seed=14)
        paths = {}
        for name, t in star.items():
            paths[name] = str(tmp_path / f"{name}.parquet")
            pq.write_table(t, paths[name], row_group_size=1000)
        conf = BASE if plan == "one_device" else MESH
        jsess = JaxSession(conf)
        jq = cs.star_queries(jsess, JAX_NS, star, paths)["q7"]
        port = cs.star_queries(TpuSession(conf, device="cpu"), PORT_NS,
                               star, paths)["q7"]
        got = port.collect()
        _assert_tables("q7", jq.collect(), got)
        cs.check_star("q7", got, cs.star_oracle(pa, star)["q7"])
        jplan = JaxOverrides(jsess.conf).apply(jq.plan).tree_string()
        assert _shape(port.explain()) == _shape(jplan)

    def test_host_decode_when_asked(self, query_files):
        _, _, paths = query_files
        conf = dict(BASE, **{
            "spark.rapids.sql.format.parquet.deviceDecode.enabled": False})
        P.COUNTERS.reset()
        got = _parquet_query(TpuSession(conf, device="cpu"), PORT_NS,
                             paths).collect().sort_by("g")
        assert P.COUNTERS.scan_chunks == 0
        want = _parquet_query(TpuSession(BASE, device="cpu"), PORT_NS,
                              paths).collect().sort_by("g")
        assert got.equals(want)


# --------------------------------------------------------------------------
class TestDynamicPruning:
    def test_row_groups_read_match_jax(self, tmp_path, monkeypatch):
        """A fact file sorted by its key and a build side holding keys
        below 60: both engines read the same row groups, fewer than all."""
        rng = np.random.default_rng(2)
        n = 6000
        fact = pa.table({"k": np.sort(rng.integers(0, 600, n)),
                         "x": rng.integers(0, 100, n)})
        dim = pa.table({"k": np.arange(600, dtype=np.int64),
                        "w": rng.integers(0, 9, 600)})
        fp, dp = str(tmp_path / "f.parquet"), str(tmp_path / "d.parquet")
        pq.write_table(fact, fp, row_group_size=500)
        pq.write_table(dim, dp)
        kept = {"jax": [], "port": []}
        for key, mod in (("jax", jax_dpp), ("port", dpp)):
            real = mod.row_group_filter

            def record(meta, ci, filters, real=real, key=key):
                out = real(meta, ci, filters)
                kept[key].append(out)
                return out
            monkeypatch.setattr(mod, "row_group_filter", record)
        results = []
        for sess, ns in ((JaxSession(BASE), JAX_NS),
                         (TpuSession(BASE, device="cpu"), PORT_NS)):
            c = ns.col
            q = sess.read_parquet(fp).join(
                sess.read_parquet(dp).filter(c("k") < ns.lit(60)), on="k") \
                .group_by("w").agg(s=ns.Sum(c("x")), n=ns.Count(ns.lit(1)))
            results.append(q.collect().sort_by("w"))
        assert results[0].equals(results[1])
        assert kept["jax"] == kept["port"]
        assert kept["port"] and 0 < len(kept["port"][0]) < 12
        P.COUNTERS.reset()
        q.collect()
        assert P.COUNTERS.scan_chunks == len(kept["port"][0]) + 1  # + dim

    def test_filter_values_and_overlap(self):
        f = dpp.DynamicKeyFilter("k")
        assert not f.ready()
        f.set_values(np.array([9, 3, 3, 40]))
        assert f.ready() and f.values.tolist() == [3, 9, 40]
        assert f._range_has_key(4, 9) and not f._range_has_key(10, 39)
        f.set_values([])
        assert not f._range_has_key(0, 100)


# --------------------------------------------------------------------------
def _one_row_batch(i: int):
    """A one-row batch holding i (the prefetch parks batches)."""
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    return batch_from_arrow(pa.table({"i": pa.array([i], pa.int64())}),
                            torch.device("cpu"))


def _first_value(b) -> int:
    return batch_to_arrow(b).column("i")[0].as_py()


class TestPrefetch:
    def test_producer_exception_reaches_consumer(self):
        def batches():
            yield _one_row_batch(1)
            raise KeyError("boom in the producer")

        it = PrefetchIterator(batches(), depth=2, name="t")
        got = []
        with pytest.raises(KeyError, match="boom"):
            for b in it:
                got.append(_first_value(b))
        assert got == [1]
        it._thread.join(timeout=5)
        assert not it._thread.is_alive()

    def test_early_stop_ends_the_producer(self):
        it = PrefetchIterator((_one_row_batch(i) for i in range(10 ** 6)),
                              depth=2, name="t")
        gen = iter(it)
        assert _first_value(next(gen)) == 0
        gen.close()
        assert not it._thread.is_alive()

    def test_scan_error_crosses_the_prefetch_thread(self, tmp_path):
        """A page header overwritten with garbage: the device walk declines
        the row group and pyarrow's decode of it, on the prefetch thread,
        fails too; its OSError reaches the consumer and the thread ends."""
        path = str(tmp_path / "bad_page.parquet")
        pq.write_table(kinds_table(n=500), path)
        cm = pq.ParquetFile(path).metadata.row_group(0).column(1)
        with open(path, "r+b") as f:
            f.seek(cm.data_page_offset)
            f.write(b"\xff" * 8)
        before = threading.active_count()
        with pytest.raises(OSError, match="thrift"):
            TpuSession(BASE, device="cpu").read_parquet(path).collect()
        assert threading.active_count() <= before


# --------------------------------------------------------------------------
def new_types_table(seed: int = 4, n: int = N) -> pa.Table:
    """One column of each type slice 6 decodes, 20 % null: decimal(7,2)
    (FLBA(4) by default, INT32 as an integer), decimal(18,4) (FLBA(8),
    INT64), decimal(9,2), FLOAT with NaN and -0.0, TIMESTAMP in micros
    and in millis (both INT96 when asked)."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.2

    def dec(p, s):
        u = rng.integers(-10 ** p + 1, 10 ** p, n)
        u[:2] = [10 ** p - 1, -10 ** p + 1]
        return cs.decimal_array(pa, u, p, s, ~mask)

    f = rng.normal(0, 1e3, n).astype(np.float32)
    f[:3] = [np.nan, -0.0, np.inf]
    return pa.table({
        "d72": dec(7, 2), "d184": dec(18, 4), "d92": dec(9, 2),
        "f": pa.array(f, mask=mask),
        "tus": pa.array(rng.integers(-10 ** 15, 10 ** 15, n),
                        pa.timestamp("us"), mask=mask),
        "tms": pa.array(rng.integers(-10 ** 12, 10 ** 12, n),
                        pa.timestamp("ms"), mask=mask),
    })


# layout: (pyarrow.parquet.write_table arguments, the columns written)
_DECIMALS = ("d72", "d184", "d92")
NEW_LAYOUTS = {
    "flba": ({}, None),
    "flba_plain": (dict(use_dictionary=False, compression="none"), None),
    "int_backed": (dict(store_decimal_as_integer=True), _DECIMALS),
    "int96": (dict(use_deprecated_int96_timestamps=True), ("tus", "tms")),
    "small_pages": (dict(compression="none", data_page_size=256), None),
}


def _same_values(got: pa.Table, want: pa.Table) -> None:
    """Column by column, value for value and validity for validity: a
    timestamp compared in UTC microseconds (the engines' type), a float
    with NaN equal to NaN."""
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        a, b = got.column(name), want.column(name)
        if pa.types.is_timestamp(b.type):
            b = b.cast(pa.timestamp(b.type.unit, tz="UTC")).cast(
                pa.timestamp("us", tz="UTC"))
        assert a.type == b.type, name
        assert a.is_null().equals(b.is_null()), name
        if pa.types.is_floating(b.type):
            assert np.array_equal(a.drop_null().to_numpy(),
                                  b.drop_null().to_numpy(), equal_nan=True)
        else:
            assert a.equals(b), name


@pytest.fixture(scope="module")
def new_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq6")
    t = new_types_table()
    out = {}
    for name, (kw, cols) in NEW_LAYOUTS.items():
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(t if cols is None else t.select(list(cols)),
                       out[name], row_group_size=700, **kw)
    return out


class TestNewTypes:
    @pytest.mark.parametrize("layout", sorted(NEW_LAYOUTS))
    def test_decode_matches_pyarrow_and_jax(self, new_files, layout):
        """FLBA and INT32/INT64 decimals, FLOAT, TIMESTAMP micros, millis
        and INT96, at 1 and at 4 row groups a dispatch, against
        pq.read_table, and the packed decode (4) against the JAX device
        decode at the same grouping (its compile of each decode program
        is seconds here, so one grouping)."""
        path = new_files[layout]
        pf = pq.ParquetFile(path)
        phys = {pf.metadata.schema.column(i).name:
                pf.metadata.schema.column(i).physical_type
                for i in range(len(pf.metadata.schema))}
        if layout == "int96":
            assert phys["tus"] == phys["tms"] == "INT96"
        elif layout == "int_backed":
            assert (phys["d72"], phys["d184"]) == ("INT32", "INT64")
        else:
            assert phys["d72"] == "FIXED_LEN_BYTE_ARRAY"
        want = pq.read_table(path)
        JaxSession(BASE).initialize_device()
        for cpd in (1, 4):
            got = pa.concat_tables([batch_to_arrow(b) for b, _ in
                                    P.device_decode_file(pf, path,
                                                         _port_schema(path),
                                                         CPU, cpd)])
            _same_values(got, want)
        jax = pa.concat_tables([jax_batch_to_arrow(b) for b, _ in
                                JP.device_decode_file(pf, path,
                                                      _jax_schema(path), None,
                                                      4)])
        _same_values(got, jax)

    def test_eager_assembles_decode_the_new_types(self, new_files,
                                                  monkeypatch):
        """The page layouts the packed path declines decode through the
        eager assembles (forced here), FLBA included."""
        monkeypatch.setattr(P, "_prep_fixed", lambda chunk, phys: None)
        monkeypatch.setattr(P, "_prep_flba", lambda chunk, flen: None)
        for layout in ("flba", "int96"):
            path = new_files[layout]
            pf = pq.ParquetFile(path)
            P.COUNTERS.reset()
            got = pa.concat_tables([batch_to_arrow(b) for b, _ in
                                    P.device_decode_file(pf, path,
                                                         _port_schema(path),
                                                         CPU, 4)])
            # 5 row groups: a packed group of 4, declined, and a lone one
            assert P.COUNTERS.declined_chunks == 4
            _same_values(got, pq.read_table(path))

    def test_flba_bytes_sign_extend(self):
        """Big-endian two's complement of 1 to 8 bytes -> int64."""
        vals = [0, 1, -1, 127, -128, 2 ** 31 - 1, -2 ** 31, 10 ** 18 - 1,
                -10 ** 18 + 1]
        for flen in range(1, 9):
            fit = [v for v in vals if -2 ** (8 * flen - 1) <= v <
                   2 ** (8 * flen - 1)]
            mat = np.array([list(v.to_bytes(flen, "big", signed=True))
                            for v in fit], np.uint8)
            got = P._flba_to_i64(torch.from_numpy(mat), flen)
            assert got.tolist() == fit, flen

    def test_footer_statistics_and_plans_match_jax(self, new_files):
        """Decimal footer min/max read as the JAX engine reads them, the
        same plans for a filter on a decimal (its selectivity estimate)
        and a join on a decimal key (no pruning filter in either engine),
        and the same rows."""
        import decimal
        path = new_files["flba"]
        jsess = JaxSession(BASE)
        sess = TpuSession(BASE, device="cpu")
        port_stats = sess.read_parquet(path).plan.column_stats()
        jax_stats = jsess.read_parquet(path).plan.column_stats()
        assert port_stats == jax_stats
        assert isinstance(port_stats["d72"][0], decimal.Decimal)
        lit = decimal.Decimal("123.45")
        dims = pa.table({"d72": cs.decimal_array(
            pa, np.arange(-5000, 5000, 7), 7, 2), "w": np.arange(1429)})
        for s, m, lt in ((jsess, JAX_NS, JT.DecimalType(5, 2)),
                         (sess, PORT_NS, T.DecimalType(5, 2))):
            c = m.col
            q = s.read_parquet(path).filter(c("d72") > m.lit(lit, lt)) \
                .join(s.from_arrow(dims), on="d72") \
                .group_by("w").agg(n=m.Count(m.lit(1)))
            if m is JAX_NS:
                jq = q
            else:
                pq_ = q
        jplan = JaxOverrides(jsess.conf).apply(jq.plan).tree_string()
        assert _shape(pq_.explain()) == _shape(jplan)
        assert pq_.collect().sort_by("w").equals(jq.collect().sort_by("w"))


# --------------------------------------------------------------------------
NULL_KINDS = {"int64": pa.int64(), "int32": pa.int32(), "date": pa.date32(),
              "double": pa.float64(), "string": pa.string()}


class TestAllNullChunks:
    """Column chunks that define no value: a dictionary page that holds
    none, and PLAIN strings whose value blob is empty."""

    @pytest.mark.parametrize("cpd", [1, 4])
    @pytest.mark.parametrize("kind", sorted(NULL_KINDS))
    def test_all_null_dictionary_chunk(self, tmp_path, kind, cpd):
        """[None] written with pyarrow's defaults: a dictionary page with
        no value. It needs no dictionary: an all-null column, through the
        decode and through a session."""
        path = str(tmp_path / f"{kind}.parquet")
        pq.write_table(pa.table({"c": pa.array([None], NULL_KINDS[kind])}),
                       path)
        want = pq.read_table(path)
        got = [batch_to_arrow(b) for b, _ in P.device_decode_file(
            pq.ParquetFile(path), path, _port_schema(path), CPU, cpd)]
        assert pa.concat_tables(got).equals(want)
        conf = dict(BASE, **{"spark.rapids.tpu.pipeline.scan."
                             "chunksPerDispatch": cpd})
        assert TpuSession(conf, device="cpu").read_parquet(path).collect() \
            .equals(want)

    @pytest.mark.parametrize("cpd", [1, 4])
    def test_all_null_row_group_matches_jax_engine(self, tmp_path, cpd):
        """Every kind, all null in one row group of a larger file (the
        packed decode merges it with its neighbours), read and joined on
        the int64 key in both engines and held against pyarrow."""
        n = 800
        rng = np.random.default_rng(6)
        cols = {"k": rng.integers(0, 50, n)}
        null_rg = np.arange(n) // 200 == 1
        for kind, typ in NULL_KINDS.items():
            vals = {"string": rng.integers(0, 9, n).astype(str).astype(
                object), "date": rng.integers(0, 900, n).astype(np.int32)}\
                .get(kind, rng.integers(0, 9, n))
            cols[f"c_{kind}"] = pa.array(vals, mask=null_rg).cast(typ) \
                if kind != "string" else pa.array(vals.tolist(), typ,
                                                  mask=null_rg)
        cols["k"] = pa.array(cols["k"], mask=null_rg)
        fact = pa.table(cols)
        fp, dp = str(tmp_path / "f.parquet"), str(tmp_path / "d.parquet")
        pq.write_table(fact, fp, row_group_size=200)
        pq.write_table(pa.table({"k": np.arange(50), "w": np.arange(50)}),
                       dp)
        conf = dict(BASE, **{"spark.rapids.tpu.pipeline.scan."
                             "chunksPerDispatch": cpd})
        outs = []
        for sess in (JaxSession(conf), TpuSession(conf, device="cpu")):
            scan = sess.read_parquet(fp).collect()
            joined = sess.read_parquet(fp).join(sess.read_parquet(dp),
                                                on="k").collect()
            outs.append((scan, joined))
        assert outs[1][0].equals(pq.read_table(fp))
        assert outs[1][0].equals(outs[0][0])
        assert positional(outs[1][1], False).equals(
            positional(outs[0][1], False))
        assert outs[1][1].num_rows == int((~null_rg).sum())

    @pytest.mark.parametrize("cpd", [1, 4])
    def test_all_null_plain_string_chunk(self, tmp_path, cpd):
        """PLAIN strings that define no value: an empty value blob. Held
        against pyarrow and the JAX host decode (its device decode fails
        here too)."""
        one = str(tmp_path / "one.parquet")
        pq.write_table(pa.table({"c": pa.array([None], pa.string())}), one,
                       use_dictionary=False)
        split = str(tmp_path / "split.parquet")
        pq.write_table(pa.table({"c": pa.array([None, "a"], pa.string())}),
                       split, use_dictionary=False, row_group_size=1)
        host = dict(BASE, **{
            "spark.rapids.sql.format.parquet.deviceDecode.enabled": False})
        jsess = JaxSession(host)
        for path in (one, split):
            want = pq.read_table(path)
            got = pa.concat_tables([batch_to_arrow(b) for b, _ in
                                    P.device_decode_file(
                                        pq.ParquetFile(path), path,
                                        _port_schema(path), CPU, cpd)])
            assert got.equals(want)
            assert jsess.read_parquet(path).collect().equals(want)


# --------------------------------------------------------------------------
class TestOutOfSlice:
    @pytest.mark.parametrize("case", ["decimal", "timestamp", "smallint",
                                      "tinyint", "fixed_len_byte_array",
                                      "nested"])
    def test_plan_time_raises(self, tmp_path, case):
        """Binary and nested columns, which no path of the port holds,
        raise at plan time. The columns the device decode lacks -- a
        timestamp in nanoseconds (whole microseconds), BYTE and SHORT
        (INT32 with an 8- or 16-bit annotation) -- are decoded by pyarrow
        and merged, as the JAX engine does, and equal its rows. A decimal of
        more than 18 digits decodes on the device."""
        n = 8
        col = {
            "decimal": pa.array([1, 2] * 4, pa.decimal128(20, 2)),
            "timestamp": pa.array(np.arange(n) * 1000, pa.timestamp("ns")),
            "smallint": pa.array(np.arange(n, dtype=np.int16)),
            "tinyint": pa.array(np.arange(n, dtype=np.int8)),
            "fixed_len_byte_array": pa.array([b"abcd"] * n, pa.binary(4)),
            "nested": pa.array([[1, 2]] * n, pa.list_(pa.int64())),
        }[case]
        path = str(tmp_path / f"{case}.parquet")
        pq.write_table(pa.table({"k": np.arange(n), "x": col}), path)
        sess = TpuSession(BASE, device="cpu")
        if case == "decimal":
            # decimal(20,2) (FLBA of 9 bytes) decodes into the limb layout
            # since the slice that ported it
            assert sess.read_parquet(path).collect().equals(
                pq.read_table(path))
            return
        if case in ("timestamp", "smallint", "tinyint"):
            # the footer check refuses the column, so pyarrow decodes it
            with pytest.raises(P.DeviceDecodeUnsupported):
                P.file_supported(path, _port_schema(path))
            P.COUNTERS.reset()
            got = sess.read_parquet(path).collect()
            assert P.COUNTERS.host_columns == 1
            assert got.equals(JaxSession(BASE).read_parquet(path).collect())
            return
        with pytest.raises(NotImplementedError):
            sess.read_parquet(path).explain()  # planning, before any data
        assert sess.read_parquet(path, columns=["k"]).collect().num_rows == n

    @pytest.mark.parametrize("case", ["v2_pages", "lz4", "string_300_bytes"])
    def test_scan_time_raises(self, tmp_path, case):
        """A v2-page file (each row group falls back whole) and an LZ4 file
        (no column the device decodes: the file is read by pyarrow) give
        pyarrow's rows. A 300-byte string (which once raised) decodes on
        the device into the long-string layout and equals pyarrow's rows
        and the JAX engine's."""
        t = kinds_table(n=400)
        kw = {"v2_pages": dict(data_page_version="2.0"),
              "lz4": dict(compression="lz4"),
              "string_300_bytes": {}}[case]
        if case == "string_300_bytes":
            t = t.set_column(5, "s", pa.array(["a" * 300] + ["b"] * 399))
        path = str(tmp_path / f"{case}.parquet")
        pq.write_table(t, path, **kw)
        df = TpuSession(BASE, device="cpu").read_parquet(path)
        df.explain()  # the footer is fine: planning passes
        if case != "string_300_bytes":
            P.COUNTERS.reset()
            assert df.collect().equals(pq.read_table(path))
            host = P.COUNTERS.snapshot()
            assert (host["host_row_groups"], host["host_files"]) == \
                ((1, 0) if case == "v2_pages" else (0, 1))
            return
        P.COUNTERS.reset()
        got = df.collect()
        assert got.equals(pq.read_table(path))
        assert got.equals(JaxSession(BASE).read_parquet(path).collect())
        assert P.COUNTERS.host_row_groups == 0  # the device decoded it
        pf = pq.ParquetFile(path)
        (b, _), = P.device_decode_file(pf, path, _port_schema(path), CPU, 1)
        si = b.schema.names.index("s")
        assert b.columns[si].overflow is not None
        assert b.columns[si].data.shape[1] == 256

    def test_unported_option_raises(self, files):
        """`filters=` (once refused) reads through pyarrow's row filter,
        equal to the JAX engine's read; an unknown option still raises."""
        flt = [("i", ">", 0)]
        got = TpuSession(BASE, device="cpu").read_parquet(
            files["dict"], filters=flt).collect()
        assert got.equals(pq.read_table(files["dict"], filters=flt))
        assert got.equals(JaxSession(BASE).read_parquet(
            files["dict"], filters=flt).collect())
        with pytest.raises(NotImplementedError):
            TpuSession(BASE, device="cpu").read_parquet(
                files["dict"], schema=None)
