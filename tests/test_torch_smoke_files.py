"""chip_smoke.py's parquet_files phase (`files_phases`, its file forms and
its predicted scan counters) run on the CPU at a small size.

On the card the phase reads star_decimal's 16,777,216 sales written again
as zstd, gzip, per-column host decodes, v2 pages, lz4, 64 files (snappy,
and lz4 under each reader strategy) and a snappy file read with
`filters=`; it holds every Q3 and Q7 result exact against the int64
oracle, the scan counters against `expected_scan`, kernel A to 2 per fused
join per store_sales batch and C to STAR_DECIMAL_C_PER_BATCH a batch under
the distributed plan. Here, as in tests/test_torch_smoke_decimal.py, the
kernel wrappers take their plain twins and stand-ins count their calls.
Row groups of 256 rows make 2,000 sales 8 row groups (2 merged batches of
1,024), batchSizeRows 256 cuts host tables into 256-row slices, and
many_files is 8 files instead of 64.

Tolerance: exact (results against the oracle, counters and launches
against their predictions, A against its twin bit for bit)."""

import sys
from pathlib import Path

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_parquet import CONF, MESH, _counting  # noqa: E402

N_SALES = 2000
DIMS = {"date_dim": 1095, "item": 60, "store": 8}
SPLIT = 8


@pytest.fixture(scope="module")
def files_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "PARQUET_ROW_GROUP", 256)
        mp.setattr(cs, "FILES_SPLIT", SPLIT)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        lines = []
        mp.setattr(cs, "emit", lines.append)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        data = cs.star_decimal_data(pa, str(tmp_path_factory.mktemp("sd")),
                                    N_SALES, DIMS)
        launches, a_args, c_args = cs.files_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c), data,
            conf=CONF, device="cpu", rounds=1, decode_rounds=1)
        a_rec = cs.murmur3_on_path(torch, a_args, cs.H100_BYTES_PER_S,
                                   path="parquet_files_v2_pages")
        yield launches, a_args, c_args, a_rec, lines
    finally:
        mp.undo()


def test_every_form_is_read(files_run):
    """One line per form, each with its predicted store_sales scan: the
    device forms 8 row groups in 2 packed dispatches (per_column with 3
    host columns a row group), v2_pages 8 host row groups, the host files
    in 256-row slices."""
    lines = {ln["form"]: ln for ln in files_run[4]
             if ln.get("phase") == "parquet_files"}
    assert set(lines) == {"snappy", "zstd", "gzip", "per_column",
                          "v2_pages", "lz4", "many_files",
                          "many_files_lz4_perfile",
                          "many_files_lz4_coalescing",
                          "many_files_lz4_multithreaded", "filters", "all"}
    pred = {f: (ln["predicted_scan"], ln["sales_batches"])
            for f, ln in lines.items() if "predicted_scan" in ln}
    for f in ("zstd", "gzip", "per_column"):
        scan, batches = pred[f]
        assert (scan["scan_chunks"], scan["fused_dispatches"], batches) == \
            (8, 2, 2)
        assert scan["host_columns"] == (24 if f == "per_column" else 0)
    assert pred["v2_pages"][0]["host_row_groups"] == 8
    assert pred["v2_pages"][1] == 8
    assert pred["lz4"] == (dict(pred["lz4"][0], host_files=1), 8)
    assert pred["many_files"][0]["scan_chunks"] == SPLIT
    assert pred["many_files_lz4_perfile"][1] == SPLIT
    assert pred["many_files_lz4_coalescing"][1] == 8
    assert pred["many_files_lz4_multithreaded"][1] == SPLIT
    rows = lines["snappy"]["filter_rows"]
    assert 0 < rows < N_SALES and pred["filters"][1] == -(-rows // 256)
    for f in ("zstd", "gzip"):
        assert lines[f]["decode"]["exact_vs_pyarrow"]


def test_launches_per_files_path(files_run):
    """A twice per fused join per store_sales batch (Q3 two joins, Q7
    two; the lz4 files' reader strategies run Q3 alone); C only under the
    distributed plan: Q7's 8 a batch."""
    launches = files_run[0]
    assert launches["parquet_files_many_files_lz4_coalescing"][
        "murmur3_rows"] == 2 * 2 * 8
    assert launches["parquet_files_zstd"] == {
        "murmur3_rows": 2 * 2 * 2 * 2, "segment_sum_f64": 0,
        "segment_sum_i64": 0}
    assert launches["parquet_files_v2_pages"]["murmur3_rows"] == 2 * 4 * 8
    assert launches["parquet_files_per_column_distributed"] == {
        "murmur3_rows": 2 * 2 * 2, "segment_sum_f64": 0,
        "segment_sum_i64": 8 * 2}


def test_a_on_host_decoded_keys(files_run):
    """A's first v2_pages input: the item keys of one row group that
    pyarrow decoded (256 rows), bit for bit against its twin; C's first
    distributed per_column input is int64."""
    _, (keys, valid, seed), (vals, ids, groups), a_rec, _ = files_run
    assert keys.shape == (256,) and keys.dtype == torch.int64
    assert a_rec["max_abs_err"] == 0 and a_rec["rows"] == 256
    assert vals.dtype == torch.int64


def test_per_column_file_layout(tmp_path):
    """files_forms' per_column file holds what the footer check refuses:
    a TINYINT quantity, a DELTA_BINARY_PACKED date key and a
    BYTE_STREAM_SPLIT FLBA(4) price."""
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.io import parquet_device as P
    t = cs.star_decimal_tables(pa, 300, 365, 60, 8)
    forms = cs.files_forms(pa, pq, t["store_sales"], str(tmp_path),
                           "unused", (0, 1))
    path = forms["per_column"][0]
    pf = pq.ParquetFile(path)
    _, bad = P.columns_supported(path, Schema.from_arrow(pf.schema_arrow))
    assert sorted(bad) == sorted(cs.FILES_HOST_COLS)
    assert "BYTE_STREAM_SPLIT" in pf.metadata.row_group(0).column(
        pf.schema_arrow.get_field_index("ss_sales_price")).encodings
