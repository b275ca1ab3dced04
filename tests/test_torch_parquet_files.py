"""Every parquet file the JAX engine reads, read by spark_rapids_tpu_torch
on the CPU: the host decode by column, row group and file
(io/scanbase.py, io/parquet_device.py), gzip and zstd on the device path,
the multi-file reader strategies (io/multifile.py) and `filters=`.

Files are written by pyarrow from numpy seeds: 3,000 rows in row groups of
1,000, with int8, int16, int32, decimal(7,2) (10 % null), double,
TIMESTAMP(NANOS) of whole microseconds, a zone-aware timestamp and a
string column, in one file form each: DELTA_BINARY_PACKED and
BYTE_STREAM_SPLIT columns, v2 data pages, LZ4, ZSTD, GZIP, BROTLI, a
DELTA_LENGTH_BYTE_ARRAY string column, and snappy.

Tolerance: exact everywhere. Each read equals the JAX engine's collect()
and pq.read_table's table with its timestamps in UTC microseconds; the
scan counters equal the counts worked out for each file below."""

import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import expr as JE
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch import expr as PE
from spark_rapids_tpu_torch.io import multifile
from spark_rapids_tpu_torch.io import parquet_device as P
from spark_rapids_tpu_torch.io.scanbase import normalize_timestamps
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.sql.batchSizeRows": 1024}
N, RG = 3000, 1000
# the columns whose type the device decode lacks, in every file form
TYPE_HOST = ("q", "h", "ts")


def probe_table(seed: int = 5, n: int = N) -> pa.Table:
    rng = np.random.default_rng(seed)
    cents = rng.integers(-10 ** 6, 10 ** 6, n)
    valid = rng.random(n) > 0.1
    words = np.array([f"w{i:03d}" + "z" * (i % 29) for i in range(300)],
                     dtype=object)
    us = rng.integers(-10 ** 15, 10 ** 15, n)
    return pa.table({
        "q": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "h": pa.array(rng.integers(-2 ** 15, 2 ** 15, n).astype(np.int16)),
        "d": pa.array(rng.integers(0, 10 ** 6, n).astype(np.int32)),
        "p": _dec72(cents, valid),
        "f": pa.array(rng.normal(0, 1e3, n)),
        "ts": pa.array(us * 1000, pa.timestamp("ns")),
        "tz": pa.array(us, pa.timestamp("us", tz="America/New_York")),
        "str": pa.array(words[rng.integers(0, len(words), n)].tolist()),
    })


def _dec72(cents, valid):
    from decimal import Decimal
    return pa.array([Decimal(int(c)).scaleb(-2) if ok else None
                     for c, ok in zip(cents, valid)], pa.decimal128(7, 2))


# form: (pyarrow.parquet.write_table arguments, host columns by the footer
# check (None: no column decodes on the device, the file goes to pyarrow),
# row groups that fall back whole)
FORMS = {
    "delta_bss": (dict(use_dictionary=False, column_encoding={
        "d": "DELTA_BINARY_PACKED", "f": "BYTE_STREAM_SPLIT"}),
        TYPE_HOST + ("d", "f"), 0),
    "v2_pages": (dict(data_page_version="2.0"), TYPE_HOST, 3),
    "lz4": (dict(compression="lz4"), None, 0),
    "zstd": (dict(compression="zstd"), TYPE_HOST, 0),
    "gzip": (dict(compression="gzip"), TYPE_HOST, 0),
    "brotli": (dict(compression="brotli"), None, 0),
    "delta_length_strings": (dict(use_dictionary=False, column_encoding={
        "str": "DELTA_LENGTH_BYTE_ARRAY"}), TYPE_HOST + ("str",), 0),
    "snappy": ({}, TYPE_HOST, 0),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq_files")
    t = probe_table()
    out = {}
    for name, (kw, _, _) in FORMS.items():
        out[name] = str(d / f"{name}.parquet")
        pq.write_table(t, out[name], row_group_size=RG, **kw)
    return out


def _jax_scan(conf, *paths, **options):
    """The JAX engine's scan exec of `paths`, its batches and its rows."""
    sess = JaxSession(conf)
    df = sess.read_parquet(*paths, **options)
    root = JaxOverrides(sess.conf).apply(df.plan)
    batches = list(root.execute())
    return root, len(batches), df.collect()


def _port_scan(conf, *paths, **options):
    """The port's scan exec of `paths`, its batches, the scan counters of
    that one scan, and the rows of a collect."""
    sess = TpuSession(conf, device="cpu")
    df = sess.read_parquet(*paths, **options)
    root = sess.plan_device(df.plan)
    P.COUNTERS.reset()
    batches = list(root.execute())
    counts = P.COUNTERS.snapshot()
    return root, len(batches), counts, df.collect()


@pytest.mark.parametrize("form", sorted(FORMS))
def test_file_form_matches_jax_and_pyarrow(files, form):
    """Rows equal to the JAX engine's and to pq.read_table's; the host
    columns, row groups and files counted as worked out in FORMS, and
    colsHostDecoded equal to the JAX scan's."""
    path = files[form]
    _, host_cols, host_rgs = FORMS[form]
    jroot, jbatches, want = _jax_scan(BASE, path)
    root, batches, counts, got = _port_scan(BASE, path)
    assert got.equals(want)
    assert got.equals(normalize_timestamps(pq.read_table(path)))
    assert root.cols_host_decoded == jroot.cols_host_decoded.value
    assert batches == jbatches
    if host_cols is None:
        assert (counts["host_files"], counts["scan_chunks"]) == (1, 0)
        assert root.cols_host_decoded == 0
        return
    assert root.cols_host_decoded == len(host_cols)
    assert counts["host_row_groups"] == host_rgs
    assert counts["host_files"] == 0
    assert counts["scan_chunks"] == N // RG - host_rgs
    assert counts["host_columns"] == \
        (0 if host_rgs else len(host_cols) * N // RG)


@pytest.mark.parametrize("codec", ["zstd", "gzip"])
def test_gzip_and_zstd_decode_on_the_device(files, codec):
    """The Python walk decompresses each page and the device decodes it:
    a decode of the device columns equals pyarrow's, with no host decode,
    in the packed and the row-group-by-row-group decode."""
    path = files[codec]
    names = [n for n in probe_table().column_names if n not in TYPE_HOST]
    want = normalize_timestamps(pq.read_table(path, columns=names))
    sess = TpuSession(BASE, device="cpu")
    schema = sess.read_parquet(path, columns=names).plan.output
    from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
    for cpd in (1, 4):
        P.COUNTERS.reset()
        got = pa.concat_tables(
            batch_to_arrow(b) for b, _ in P.device_decode_file(
                pq.ParquetFile(path), path, schema, "cpu", cpd))
        assert got.equals(want)
        snap = P.COUNTERS.snapshot()
        assert snap["scan_chunks"] == N // RG
        assert snap["host_columns"] + snap["host_row_groups"] + \
            snap["host_files"] == 0


@pytest.mark.parametrize("reader", ["AUTO", "PERFILE", "COALESCING",
                                    "MULTITHREADED"])
def test_reader_types_over_files(tmp_path, reader):
    """Five LZ4 files of 600 rows (no column decodes on the device):
    every reader strategy gives the JAX engine's rows in its order and its
    batch count (batchSizeRows 500: PERFILE and MULTITHREADED 10,
    COALESCING and AUTO 6)."""
    t = probe_table(n=3000)
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"part-{i:05d}.parquet"))
        pq.write_table(t.slice(600 * i, 600), paths[-1], compression="lz4")
    conf = dict(BASE, **{"spark.rapids.sql.batchSizeRows": 500,
                         "spark.rapids.sql.format.parquet.reader.type":
                         reader})
    _, jbatches, want = _jax_scan(conf, *paths)
    _, batches, counts, got = _port_scan(conf, *paths)
    assert counts["host_files"] == 5
    assert got.equals(want)
    assert got.equals(normalize_timestamps(t))
    assert batches == jbatches == \
        {"PERFILE": 10, "MULTITHREADED": 10}.get(reader, 6)


def test_filters_match_jax_and_pyarrow(files):
    """`filters=` reads through pyarrow's row filter on the host, as the
    JAX engine does, for a device-decodable file too."""
    flt = [("d", ">=", 200_000), ("d", "<", 600_000)]
    path = files["snappy"]
    _, jbatches, want = _jax_scan(BASE, path, filters=flt)
    _, batches, counts, got = _port_scan(BASE, path, filters=flt)
    assert (counts["scan_chunks"], counts["host_files"]) == (0, 1)
    assert got.equals(want)
    assert got.equals(normalize_timestamps(pq.read_table(path,
                                                         filters=flt)))
    assert 0 < got.num_rows < N and batches == jbatches


def test_sub_microsecond_nanos_raise_in_both_engines(tmp_path):
    """A TIMESTAMP(NANOS) value with a sub-microsecond remainder: the safe
    cast to microseconds raises in both engines."""
    path = str(tmp_path / "nanos.parquet")
    pq.write_table(pa.table({"k": np.arange(4), "ts": pa.array(
        [0, 1000, 1001, 2000], pa.timestamp("ns"))}), path)
    with pytest.raises(pa.ArrowInvalid, match="lose data"):
        JaxSession(BASE).read_parquet(path).collect()
    with pytest.raises(pa.ArrowInvalid, match="lose data"):
        TpuSession(BASE, device="cpu").read_parquet(path).collect()


@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_long_string_raises_on_every_path(tmp_path, codec):
    """A 300-byte string, through the device decode (snappy) or the
    file's host decode (lz4), once raised; it now takes the long-string
    layout on either path and equals the JAX engine's rows, never cut."""
    t = probe_table(n=400)
    t = t.set_column(t.schema.get_field_index("str"), "str",
                     pa.array(["a" * 300] + ["b"] * 399))
    path = str(tmp_path / "long.parquet")
    pq.write_table(t, path, compression=codec)
    got = TpuSession(BASE, device="cpu").read_parquet(path).collect()
    assert got.equals(JaxSession(BASE).read_parquet(path).collect())
    assert got.column("str")[0].as_py() == "a" * 300


def test_a_device_failure_is_not_caught(files, monkeypatch):
    """The fallback net is DeviceDecodeUnsupported, OSError and
    struct.error only: a RuntimeError in the device phase (a failed launch)
    ends the query, and nothing is decoded on the host for it."""
    def fail(*args, **kwargs):
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(P, "_decode_col", fail)
    for conf in (BASE, dict(BASE, **{
            "spark.rapids.tpu.pipeline.scan.chunksPerDispatch": 1})):
        P.COUNTERS.reset()
        with pytest.raises(RuntimeError, match="injected"):
            TpuSession(conf, device="cpu").read_parquet(
                files["zstd"]).collect()
        snap = P.COUNTERS.snapshot()
        assert snap["host_columns"] + snap["host_row_groups"] + \
            snap["host_files"] == 0


def test_multithreaded_reader_stops_with_its_scan():
    """A MULTITHREADED iteration stopped after its first table leaves no
    decode of it running: queued ones are cancelled, running ones waited
    for, and the output order is the submit order."""
    started, ended = [], []

    def decode(p):
        started.append(p)
        time.sleep(0.05)
        ended.append(p)
        return pa.table({"p": [p]})

    conf = TpuSession(dict(BASE, **{
        "spark.rapids.sql.format.parquet.reader.type": "MULTITHREADED",
        "spark.rapids.sql.format.parquet.multiThreadedRead."
        "maxNumFilesParallel": 2}), device="cpu").conf
    paths = [f"s3://bucket/f{i}" for i in range(8)]
    it = iter(multifile.FileBatchIterator(paths, decode, conf))
    assert next(it).column("p").to_pylist() == ["s3://bucket/f0"]
    it.close()
    n = len(started)
    assert sorted(started) == sorted(ended) and n < 8
    time.sleep(0.2)
    assert len(started) == n  # no queued decode ran after the close
    full = multifile.FileBatchIterator(paths, decode, conf)
    assert full.reader_type == "MULTITHREADED"
    assert [t.column("p")[0].as_py() for t in full] == paths


def test_dynamic_pruning_prunes_host_files(tmp_path):
    """The broadcast join's pruning filter drops whole files on the host
    path too (`_effective_paths`): of two fact files split by key, the one
    whose footer range holds no build key is never decoded."""
    rng = np.random.default_rng(9)
    paths = []
    for i, (lo, hi) in enumerate(((0, 300), (300, 600))):
        paths.append(str(tmp_path / f"fact-{i}.parquet"))
        pq.write_table(pa.table({"k": np.sort(rng.integers(lo, hi, 900)),
                                 "x": rng.integers(0, 100, 900)}),
                       paths[-1])
    dim = str(tmp_path / "dim.parquet")
    pq.write_table(pa.table({"k": np.arange(600, dtype=np.int64),
                             "w": rng.integers(0, 9, 600)}), dim)
    conf = dict(BASE, **{
        "spark.rapids.sql.format.parquet.deviceDecode.enabled": False})
    results = []
    for sess, m in ((JaxSession(conf), JE), (TpuSession(conf, device="cpu"),
                                             PE)):
        q = sess.read_parquet(*paths).join(
            sess.read_parquet(dim).filter(m.col("k") < m.lit(60)), on="k") \
            .group_by("w").agg(s=m.Sum(m.col("x")))
        P.COUNTERS.reset()
        results.append(q.collect().sort_by("w"))
    assert results[0].equals(results[1]) and results[1].num_rows > 0
    assert P.COUNTERS.host_files == 2  # the dim file and one fact file


def test_host_columns_take_the_scan_type():
    """A host-decoded column is cast to the scan's type before it merges
    (nanoseconds to UTC microseconds, padded to the batch's capacity); a
    cast that would lose a value raises DeviceDecodeUnsupported, which
    falls the row group back whole."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import Schema
    schema = Schema(("ts",), (T.TIMESTAMP,))
    ok = pa.table({"ts": pa.array([0, 2000, None], pa.timestamp("ns"))})
    col = P._host_cols_to_device(ok, schema, ["ts"], 128, "cpu")["ts"]
    assert col.capacity == 128
    assert col.data[:2].tolist() == [0, 2] and col.validity[:3].tolist() == \
        [True, True, False]
    lossy = pa.table({"ts": pa.array([1001], pa.timestamp("ns"))})
    with pytest.raises(P.DeviceDecodeUnsupported, match="host column cast"):
        P._host_cols_to_device(lossy, schema, ["ts"], 128, "cpu")


def test_counters_skip_a_group_that_falls_back(tmp_path):
    """A lossy host-column cast in the second row group of a packed group
    (a TIMESTAMP(NANOS) value with a sub-microsecond remainder): the packed
    decode and that row group's device decode are abandoned and count
    nothing, so scan_chunks + host_row_groups is the row-group count."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import (Schema,
                                                       batch_from_arrow,
                                                       batch_to_arrow)
    ns = np.arange(4 * RG, dtype=np.int64) * 1000
    ns[RG + 7] += 1
    path = str(tmp_path / "lossy.parquet")
    pq.write_table(pa.table({"k": np.arange(4 * RG),
                             "ts": pa.array(ns, pa.timestamp("ns"))}),
                   path, row_group_size=RG)
    pf = pq.ParquetFile(path)
    schema = Schema(("k", "ts"), (T.LONG, T.TIMESTAMP))
    assert set(P.host_columns(pf.metadata, schema)) == {"ts"}
    fell = []

    def host_fallback(rg):
        fell.append(rg)
        P.COUNTERS.add(host_row_groups=1)
        t = pf.read_row_group(rg)
        t = t.set_column(1, "ts", t.column("ts").cast(
            pa.timestamp("us", tz="UTC"), safe=False))
        return batch_from_arrow(t, "cpu"), t.num_rows

    P.COUNTERS.reset()
    out = list(P.device_decode_file(pf, path, schema, "cpu", 4,
                                    host_cols={"ts"},
                                    host_fallback=host_fallback))
    snap = P.COUNTERS.snapshot()
    assert fell == [1] and len(out) == 4
    assert snap["scan_chunks"] + snap["host_row_groups"] == 4
    # one copy a device-decoded row group: none of the abandoned ones
    assert (snap["scan_chunks"], snap["fused_dispatches"],
            snap["host_columns"], snap["h2d_copies"]) == (3, 0, 3, 3)
    got = pa.concat_tables(batch_to_arrow(b) for b, _ in out)
    assert got.column("k").to_pylist() == list(range(4 * RG))
    assert got.column("ts").cast(pa.int64()).to_pylist() == \
        (ns // 1000).tolist()
    P.COUNTERS.reset()
    with pytest.raises(P.DeviceDecodeUnsupported, match="host column"):
        list(P.device_decode_file(pf, path, schema, "cpu", 4,
                                  host_cols={"ts"}))
    snap = P.COUNTERS.snapshot()
    assert (snap["scan_chunks"], snap["host_columns"]) == (1, 1)
