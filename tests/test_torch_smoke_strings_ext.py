"""chip_smoke.py's strings_ext phase (`strings_ext_phases`, its queries and
oracle) run on the CPU at a small size, and its oracle held against the
JAX engine.

On the card the phase runs TPC-DS q21 (its date window a date cast from
a string literal, -/+ 30 days by DateSub/DateAdd), a formatted store
report (concat_ws, lpad of keys cast to STRING, initcap, translate,
replace, soundex, format_number, an average cast to STRING on the host
engine) and a parse of store_sales staged as text, on one device and
distributed, each exact against strings_ext_oracle with exact launch
counts of kernels A and C; under
ANSI the text parse raises and its twin over the well-formed rows is
exact. Here the kernel wrappers take their plain twins and a stand-in
counts each call; 16 weeks of inventory in row groups of 16,384 make 3
merged probe batches.

Tolerance: exact (keys, strings, counts, decimals as unscaled ints), the
report's average and the parsed price sums rtol 1e-12."""

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
         "store": 12, "warehouse": 3, "inventory_weeks": 16}
TEXT_ROWS = 8_192
CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force"}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PARQUET_ROW_GROUP", 16_384)
    try:
        d = str(tmp_path_factory.mktemp("strings_ext"))
        tables = cs.agg_tables(pa, SIZES)
        paths = cs.write_parquet(pq, {k: tables[k] for k in (
            "store_sales", "date_dim", "item", "store", "warehouse",
            "inventory")}, d, tag="_aggs")
        data = cs.strings_ext_data(pa, tables, d, paths, TEXT_ROWS)
        yield dict(data, tables=tables)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ext_run(small):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        lines = []
        mp.setattr(cs, "emit", lines.append)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches = cs.strings_ext_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c), small,
            conf=CONF, device="cpu")
        yield launches, lines
    finally:
        mp.undo()


def test_oracle_has_rows(small):
    """The small data answers every query with rows: q21 past its HAVING,
    the report's 12 stores x 12 months, the malformed prices."""
    want = small["oracle"]
    assert 0 < len(want["q21"]["i_item_sk"]) <= cs.EXT_LIMIT
    assert len(want["report"]["id"]) == 12 * 12
    assert want["text_malformed"] > 0
    assert sum(want["text_good"]["n"]) == sum(want["text"]["n"])


def test_phase_runs_and_counts(ext_run, small):
    """Both plans' lines, the ANSI raise and twin, the parse check; A at 2
    a fused join a probe batch, C at EXT_C_PER_BATCH a batch distributed."""
    launches, lines = ext_run
    by = {(ln.get("query"), ln.get("plan")): ln for ln in lines
          if ln.get("phase") == "strings_ext"}
    for plan in ("one_device", "distributed"):
        assert by[("q21", plan)]["fused_joins"] == 3
        assert by[("q21", plan)]["probe_batches"] == 3
        assert by[("report", plan)]["host_nodes"] == [
            "! CpuProjectExec <- cast double -> string is not supported "
            "on TPU"]
        assert by[("text_ansi", plan)]["raised"] == (
            "[CAST_INVALID_INPUT] value cannot be cast to double")
    check = [ln for ln in lines if ln.get("check")][0]
    assert check["bit_identical_to_python_float"]
    # the text fits one row group here: every well-formed price parsed
    assert check["first_batch_rows"] == TEXT_ROWS
    assert check["parsed"] == sum(small["oracle"]["text"]["n"])
    assert launches["strings_ext"]["segment_sum_i64"] == 0
    assert launches["strings_ext"]["murmur3_rows"] == 2 * (3 * 3 + 2 * 1)
    c = cs.EXT_C_PER_BATCH
    assert launches["strings_ext_distributed"]["segment_sum_i64"] == \
        c["q21"] * 3 + c["report"] + c["text"]


def _jax_namespace():
    m = SimpleNamespace(**{n: getattr(JE, n) for n in (
        "col", "lit", "Cast", "CaseWhen", "Sum", "Count", "Average",
        "Concat", "ConcatWs", "StringLPad", "InitCap", "StringTranslate",
        "StringReplace", "SoundEx", "FormatNumber", "Like", "DateAdd",
        "DateSub")})
    m.T = JT
    return m


@pytest.mark.parametrize("name", ["q21", "report", "text"])
def test_oracle_matches_jax(small, name):
    """The numpy oracle against the JAX engine's host run of the same
    query (the report's host cast of the average included)."""
    q = cs.strings_ext_queries(JaxSession({"spark.rapids.sql.explain":
                                           "NONE"}), _jax_namespace(),
                               small["paths"])[name]
    cs.check_strings_ext(pa, name, q.collect_cpu(), small["oracle"][name])
