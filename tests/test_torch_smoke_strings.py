"""chip_smoke.py's strings phase (`strings_phases`, its queries and numpy
oracle) run on the CPU at a small size, and its oracle held against the
JAX engine.

On the card the phase runs TPC-DS q23's frequent_ss_items (Substring over
the joined rows, a 30-byte string group key, the exchange on it, the
top-k over it), a text report by upper(substr(i_item_desc, 1, 2)) and the
sales of the items LIKE 'ab%' and RLIKE '^[a-c]b', on one device and
distributed, each against strings_oracle with exact launch counts of
kernels A and C; then the long-string layout at headWidth=64: a month of
sales carrying the descriptions (no byte op: no rerun), q23 over the
first sales (Substring meets the layout: one host rerun) and the month
under shuffled joins (the tails cross the exchange's byte plane). Here
the kernel wrappers take their plain twins and a stand-in counts each
call; every table arrives as one batch.

Tolerance: exact (keys, strings, counts, decimals as unscaled ints), the
report's avg_len rtol 1e-12."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_parquet import MESH, _counting  # noqa: E402

SIZES = {"store_sales": 16_384, "date_dim": 73_049, "item": 600,
         "store": 12, "warehouse": 3, "inventory_weeks": 3}
CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PARQUET_ROW_GROUP", 16_384)
    try:
        d = str(tmp_path_factory.mktemp("strings"))
        tables = cs.agg_tables(pa, SIZES)
        paths = cs.write_parquet(pq,
                                 {k: tables[k] for k in (
                                     "store_sales", "date_dim", "item")},
                                 d, tag="_aggs")
        data = cs.strings_data(pa, tables, d, paths, host_rows=8_192)
        yield dict(data, tables=tables)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def strings_run(small):
    """One run of strings_phases at a small size on the CPU, with the
    script's card-only helpers replaced by CPU stand-ins."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        lines = []
        mp.setattr(cs, "emit", lines.append)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches = cs.strings_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c), small,
            conf=CONF, device="cpu", gather_rows=2_048)
        yield launches, lines
    finally:
        mp.undo()


def test_launches_per_strings_path(strings_run):
    """Each collect launched A twice a fused join and C as
    STRINGS_C_PER_BATCH says (the phase holds each one); one device
    launches no C."""
    launches, lines = strings_run
    assert launches["strings"]["segment_sum_i64"] == 0
    assert launches["strings"]["murmur3_rows"] > 0
    assert launches["strings_distributed"]["segment_sum_i64"] == \
        sum(cs.STRINGS_C_PER_BATCH.values())
    by = {(ln.get("query"), ln.get("plan"), ln.get("head_width")): ln
          for ln in lines}
    assert by["q23_top_host_rerun", None, "64"]["cpu_fallback_reruns"] == 1
    # the phase held the device attempt's launches; the rerun adds none
    assert by["q23_top_host_rerun", None, "64"]["launches"] == \
        by["q23_top_host_rerun", None, "64"]["device_attempt_launches"]
    assert by["q23_top_host_rerun", None, "256"]["cpu_fallback_reruns"] == 0
    assert by["carry", None, "64"]["cpu_fallback_reruns"] == 0
    assert by["carry_shuffled", None, "64"]["exchanges"] >= 2


def test_layout_shrinks_the_column(strings_run):
    """At headWidth=64 the description column takes fewer bytes a batch
    than the flat 256-byte matrix, gathered and in the query's batches."""
    check = [ln for ln in strings_run[1]
             if ln.get("check") == "layout_and_expressions"][0]
    g = check["gathered_bytes"]
    assert g["64"] < g["256"]
    cb = check["carry_bytes_per_batch"]
    assert sum(cb["64"]) < sum(cb["256"])
    assert check["long_descs"] > 0


def _jax_namespace():
    return SimpleNamespace(**{n: getattr(JE, n) for n in (
        "col", "lit", "In", "Sum", "Count", "Average", "Max", "If",
        "Substring", "Upper", "Length", "Contains", "Concat", "StringTrim",
        "Like", "RLike")})


@pytest.mark.parametrize("name", ["q23_top", "report", "like", "rlike"])
def test_oracle_against_the_jax_engine(small, name):
    """The JAX package's CPU engine answers the same queries as the
    oracle."""
    qs = cs.strings_queries(JaxSession(dict(CONF, **cs.STRINGS_CONF)),
                            _jax_namespace(), small["paths"])
    cs.check_strings(pa, name, qs[name].collect_cpu(),
                     small["oracle"][name])


def test_oracle_against_python(small):
    """q23's counts and the LIKE items from Python over the rows."""
    t, want = small["tables"], small["oracle"]
    dd = t["date_dim"]
    year = dict(zip(dd.column("d_date_sk").to_pylist(),
                    dd.column("d_year").to_pylist()))
    descs = t["item"].column("i_item_desc").to_pylist()
    ss = t["store_sales"]
    counts = {}
    for date, item in zip(ss.column("ss_sold_date_sk").to_pylist(),
                          ss.column("ss_item_sk").to_pylist()):
        if year[date] in cs.STRINGS_YEARS:
            counts[item, date] = counts.get((item, date), 0) + 1
    top = sorted(counts.values(), reverse=True)[:cs.STRINGS_LIMIT]
    assert want["q23_top"]["cnt"] == top
    assert want["like_items"] == sum(d.startswith("ab") for d in descs)
    assert len(want["q23"]["cnt"]) == sum(v > cs.STRINGS_HAVING
                                          for v in counts.values())
    assert np.isclose(want["long_descs"] / len(descs), 0.7, atol=0.1)
