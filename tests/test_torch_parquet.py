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
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch import native
from spark_rapids_tpu_torch.columnar.batch import Schema, batch_to_arrow
from spark_rapids_tpu_torch.exec.base import PrefetchIterator
from spark_rapids_tpu_torch.io import dynamic_pruning as dpp
from spark_rapids_tpu_torch.io import parquet_device as P
from spark_rapids_tpu_torch.plugin import TpuSession

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_star import JAX_NS, PORT_NS, _assert_tables  # noqa: E402

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
class TestNativeWalk:
    @pytest.mark.parametrize("layout", sorted(LAYOUTS))
    def test_chunk_walk_matches_python_twins(self, files, layout):
        """native walk == the port's Python walk == the JAX package's Python
        walk: pages, counts, payloads, dictionary, def levels, indices."""
        pf = pq.ParquetFile(files[layout])
        for ci in range(pf.metadata.num_columns):
            buf, cm, optional = _chunk_bytes(files[layout], 0, ci)
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
        if layout == "spill":
            kinds = {p.kind for p in nat.pages}
            assert kinds == {"dict", "plain"}, kinds

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
class TestPrefetch:
    def test_producer_exception_reaches_consumer(self):
        def batches():
            yield 1
            raise KeyError("boom in the producer")

        it = PrefetchIterator(batches(), depth=2, name="t")
        got = []
        with pytest.raises(KeyError, match="boom"):
            for b in it:
                got.append(b)
        assert got == [1]
        it._thread.join(timeout=5)
        assert not it._thread.is_alive()

    def test_early_stop_ends_the_producer(self):
        it = PrefetchIterator(iter(range(10 ** 6)), depth=2, name="t")
        gen = iter(it)
        assert next(gen) == 0
        gen.close()
        assert not it._thread.is_alive()

    def test_scan_error_crosses_the_prefetch_thread(self, tmp_path):
        path = str(tmp_path / "v2.parquet")
        pq.write_table(kinds_table(n=500), path, data_page_version="2.0")
        before = threading.active_count()
        with pytest.raises(P.DeviceDecodeUnsupported, match="page type 3"):
            TpuSession(BASE, device="cpu").read_parquet(path).collect()
        assert threading.active_count() <= before


# --------------------------------------------------------------------------
class TestOutOfSlice:
    @pytest.mark.parametrize("case", ["decimal", "timestamp", "int96",
                                      "fixed_len_byte_array", "nested",
                                      "float32"])
    def test_plan_time_raises(self, tmp_path, case):
        n = 8
        col = {
            "decimal": pa.array([1, 2] * 4, pa.decimal128(10, 2)),
            "timestamp": pa.array(np.arange(n), pa.timestamp("us")),
            "int96": pa.array(np.arange(n), pa.timestamp("ns")),
            "fixed_len_byte_array": pa.array([b"abcd"] * n, pa.binary(4)),
            "nested": pa.array([[1, 2]] * n, pa.list_(pa.int64())),
            "float32": pa.array(np.zeros(n, np.float32)),
        }[case]
        path = str(tmp_path / f"{case}.parquet")
        pq.write_table(pa.table({"k": np.arange(n), "x": col}), path,
                       use_deprecated_int96_timestamps=case == "int96")
        sess = TpuSession(BASE, device="cpu")
        with pytest.raises(NotImplementedError):
            sess.read_parquet(path).explain()  # planning, before any data
        if case in ("decimal", "timestamp", "int96", "float32"):
            # the footer check alone refuses the column too
            with pytest.raises(P.DeviceDecodeUnsupported):
                P.file_supported(path, _port_schema(path))
        assert sess.read_parquet(path, columns=["k"]).collect().num_rows == n

    @pytest.mark.parametrize("case", ["v2_pages", "lz4", "string_300_bytes"])
    def test_scan_time_raises(self, tmp_path, case):
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
        with pytest.raises(P.DeviceDecodeUnsupported):
            df.collect()
        with pytest.raises(P.DeviceDecodeUnsupported):
            pf = pq.ParquetFile(path)
            list(P.device_decode_file(pf, path, _port_schema(path), CPU, 1))

    def test_unported_option_raises(self, files):
        with pytest.raises(NotImplementedError):
            TpuSession(BASE, device="cpu").read_parquet(
                files["dict"], filters=[("i", ">", 0)])
