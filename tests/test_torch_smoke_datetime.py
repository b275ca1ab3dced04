"""chip_smoke.py's datetime phase (`datetime_phases`, its queries and
oracle) run on the CPU at a small size, and its oracle held against the
JAX engine where the JAX engine follows Spark.

On the card the phase runs a calendar report (year, ISO week, weekday and
its name; datediff, last_day, add_months, next_day, trunc and
date_format; round, sqrt, log10, floor and ceil of an average; a shift
and two bitwise ops), TPC-DS q96's half hour on timestamps built from
ss_sold_time_sk, an hourly report for January 2001 (date_trunc,
date_format, unix_timestamp both ways, a TIMESTAMP -> STRING cast on the
host) and the price text parsed as decimal(7,2) on the host, on one
device and distributed, each exact against datetime_oracle with exact
launch counts of kernels A and C; under ANSI the parse raises. Here the
kernel wrappers take their plain twins and a stand-in counts each call;
store_sales fits one row group of 16,384 rows, one probe batch.

Tolerance: exact (keys, dates, timestamps, strings, counts, decimals as
unscaled ints); the average rtol 1e-12 and its functions against numpy's
of the engine's own average (round, sqrt, floor, ceil exact, log10 within
4 ULP)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_parquet import MESH, _counting  # noqa: E402

SIZES = {"store_sales": 16_384, "date_dim": 73_049, "item": 6_000,
         "store": 12, "warehouse": 3, "inventory_weeks": 2}
TEXT_ROWS = 8_192
CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PARQUET_ROW_GROUP", 16_384)
    try:
        d = str(tmp_path_factory.mktemp("datetime"))
        tables = cs.agg_tables(pa, SIZES)
        paths = cs.write_parquet(pq, {k: tables[k] for k in (
            "store_sales", "date_dim")}, d, tag="_aggs")
        ext = cs.strings_ext_data(pa, tables, d, paths, TEXT_ROWS)
        yield dict(cs.datetime_data(pa, tables, ext, TEXT_ROWS),
                   tables=tables)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def dt_run(small):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        lines = []
        mp.setattr(cs, "emit", lines.append)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches = cs.datetime_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c), small,
            conf=CONF, device="cpu")
        yield launches, lines
    finally:
        mp.undo()


def test_oracle_has_rows(small):
    """Every query answers with rows: the calendar's (year, week, weekday)
    groups, q96's stores, January's hours, the parse's stores with the
    malformed prices left out."""
    want = small["oracle"]
    assert want["calendar_groups"] > 1_000
    assert len(want["q96"]["n"]) == SIZES["store"]
    assert 100 < len(want["hourly"]["hour"]) <= 744
    assert want["hourly"]["same"] == want["hourly"]["n"]
    assert want["parse_malformed"] > 0
    assert len(want["parse"]["total"]) == SIZES["store"]


def test_phase_runs_and_counts(dt_run):
    """Both plans' lines with the host nodes, the ANSI raise, the
    expression times; A at 2 a fused join a probe batch, C at
    DT_C_PER_BATCH a batch distributed."""
    launches, lines = dt_run
    by = {(ln.get("query"), ln.get("plan")): ln for ln in lines
          if ln.get("phase") == "datetime"}
    for plan in ("one_device", "distributed"):
        for q in ("calendar", "q96", "hourly"):
            assert by[(q, plan)]["fused_joins"] == 1
            assert by[(q, plan)]["probe_batches"] == 1
        assert by[("parse", plan)]["fused_joins"] == 0
        assert by[("hourly", plan)]["host_nodes"] == [
            "! CpuProjectExec <- cast timestamp -> string is not supported "
            "on TPU"]
        assert by[("parse_ansi", plan)]["raised"] == (
            "[CAST_INVALID_INPUT] value cannot be cast to decimal(7,2)")
    check = [ln for ln in lines if ln.get("check")][0]
    assert set(check["device_ms"]) == {"year", "weekofyear", "dayofweek",
                                       "dayname", "date_format"}
    one, dist = launches["datetime"], launches["datetime_distributed"]
    assert (one["murmur3_rows"], one["segment_sum_i64"]) == (6, 0)
    assert (dist["murmur3_rows"], dist["segment_sum_i64"]) == (
        6, sum(cs.DT_C_PER_BATCH.values()))


def _jax_namespace():
    m = SimpleNamespace(**{n: getattr(JE, n) for n in cs.DT_NAMES})
    m.T = JT
    return m


@pytest.mark.parametrize("name", ["calendar", "q96"])
def test_oracle_matches_jax(small, name):
    """The numpy oracle against the JAX engine's host run of the same
    query (the hourly report's TIMESTAMP -> STRING and the decimal parse
    are casts the JAX CPU engine gets wrong: their oracles are Spark's
    rule, tests/test_torch_timestamp_casts.py)."""
    q = cs.datetime_queries(JaxSession({"spark.rapids.sql.explain":
                                        "NONE"}), _jax_namespace(),
                            small["paths"])[name]
    cs.check_datetime(pa, name, q.collect_cpu(), small["oracle"][name])
