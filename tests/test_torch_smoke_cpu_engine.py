"""chip_smoke.py's cpu_engine phase (`cpu_engine_phases`) run on the CPU at
a small size.

On the card the phase runs decimal star Q7 with every parquet scan on the
host engine (one device and distributed), ordered Q7 with its average
quantity cast to decimal(7,2) on the host between device stages (both
plans), and the engine query with spark.rapids.sql.enabled=false; each
exact against its oracle, with the launches its explain tree predicts.
Here the decimal star's files are small (row groups of 128 rows: 4 merged
batches of store_sales; batchSizeRows 256: 8 host batches), the kernel
wrappers take their plain twins with a stand-in counting each call (as in
tests/test_torch_smoke_parquet.py), and the engine query has 4,096 fact
rows, of which the host path reads 2,048.

Tolerance: exact (the cast against Spark's rule, every other column
against the phase's oracles)."""

import sys
from pathlib import Path

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_parquet import CONF, DIMS, MESH, _counting  # noqa

N_SALES = 2000


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        d = str(tmp_path_factory.mktemp("cpu_engine"))
        mp.setattr(cs, "PARQUET_ROW_GROUP", 128)
        dec = cs.star_decimal_data(pa, d, n_sales=N_SALES, dims=DIMS)
        fact, dim = cs.query_tables(pa, 4096, 512, 1024, 64)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        yield cs.cpu_engine_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c), dec,
            fact, dim, conf=CONF, device="cpu", n_fact=2048)
    finally:
        mp.undo()


def test_every_path_is_exact_with_its_launches(cpu_run):
    """The phase checks each path itself; here its record: every path and
    plan, each launching what its explain tree predicts."""
    lines, launches = cpu_run
    assert [(ln["path"], ln["plan"]) for ln in lines] == [
        ("host_scan", "one_device"), ("host_scan", "distributed"),
        ("host_cast", "one_device"), ("host_cast", "distributed"),
        ("sql_off", "host")]
    for ln in lines:
        assert ln["exact"] and ln["launches_per_collect"] == {
            "murmur3_rows": ln["predicted"]["murmur3_rows"],
            "segment_sum_f64": 0,
            "segment_sum_i64": ln["predicted"]["segment_sum_i64"]}
    scan, dscan, cast, dcast, off = lines
    assert scan["batches"] == 8 and cast["batches"] == 4
    assert dscan["launches_per_collect"]["segment_sum_i64"] == \
        cs.STAR_DECIMAL_C_PER_BATCH["q7"] * 8
    assert cast["launches_per_collect"]["murmur3_rows"] > 0
    assert launches["cpu_engine_sql_off"] == {
        "murmur3_rows": 0, "segment_sum_f64": 0, "segment_sum_i64": 0}


def test_fallback_lines_name_their_reasons(cpu_run):
    lines, _ = cpu_run
    for ln in lines[:2]:
        assert ln["fallbacks"] and all(
            "CpuParquetScanExec is disabled; enable with "
            "spark.rapids.sql.exec.TpuParquetScanExec=true" in b
            for b in ln["fallbacks"])
    for ln in lines[2:4]:
        assert ln["fallbacks"] == [
            "! CpuProjectExec <- cast double -> decimal(7,2) is not "
            "supported on TPU"]


def test_transitions_are_counted(cpu_run):
    """Path 1 lifts every row of the scanned tables and brings none back;
    path 2 moves the report's groups each way; the host-only plan moves
    nothing and parks nothing."""
    lines, _ = cpu_run
    scan = lines[0]["transitions"]
    rows = N_SALES + DIMS["item"] + DIMS["store"]
    assert scan["to_device"]["rows"] == rows and scan["to_host"]["rows"] == 0
    assert scan["to_device"]["bytes"] > 0 and \
        scan["to_device"]["host_s"] > 0 and lines[0]["host_decode_s"] > 0
    # no card: no copy on a device stream
    assert scan["to_device"]["device_s"] == scan["to_host"]["device_s"] == 0
    cast = lines[2]["transitions"]
    assert cast["to_host"]["rows"] == cast["to_device"]["rows"] == \
        lines[2]["rows"] > 0 and cast["host_nodes_run"] == 1
    off = lines[4]
    assert off["peak_budget_bytes"] == 0 and off["parked"] == 0
    assert off["transitions"]["host_nodes_run"] == 5
    assert off["transitions"]["to_device"]["rows"] == 0
