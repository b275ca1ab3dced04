"""chip_smoke.py's plan_nodes phase (`plan_nodes_phases`, its queries and
its numpy oracles) run on the CPU at a small size.

On the card the phase runs q28 with its bucket predicates pushed into the
parquet decode beside its unpushed twin, an aggregate-only report pushed
whole (no row data materialised), a year's window of sales sorted by
date (its row groups pruned by the footer) pushed and unpushed, a sample,
a range and the cost-based optimizer's placements, on one device and
distributed, each exact against its oracle and with exact launch counts
of kernels A and C. Here, as in tests/test_torch_smoke_joins.py, the
kernel wrappers take their plain twins and a stand-in counts each call;
the sales hold 32,768 rows in row groups of 8,192 (one merged batch) and
the sorted file 16,384 in row groups of 1,024, so a year's window keeps
four of sixteen. The optimizer places both queries as on the card (Q7
on the device, the engine query on the host), as the JAX planner does,
at this size and at the card's row counts.

Tolerance: exact (counts and decimals as unscaled ints)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.ops.rowops import sample_mask as jax_sample_mask
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_joins import CONF, SIZES  # noqa: E402
from test_torch_smoke_parquet import DIMS, MESH, _counting  # noqa: E402

SMALL = {"PARQUET_ROW_GROUP": 8_192, "PLAN_SORTED_ROWS": 16_384,
         "PLAN_SORTED_GROUP": 1_024, "PLAN_RANGE": (65_536, 1024),
         "FILES_SALES_ROWS": 4_096, "N_COUNTIES": 10, "Q58_BAND": 0.3}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    for k, v in SMALL.items():
        mp.setattr(cs, k, v)
    try:
        joins = cs.join_data(pa, str(tmp_path_factory.mktemp("pn")), SIZES)
        dec = cs.star_decimal_data(pa, str(tmp_path_factory.mktemp("pd")),
                                   2000, DIMS)
        fact, dim = cs.query_tables(pa, 8_192, 64, 256, 16)
        yield joins, dec, fact, dim
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def plan_run(small):
    """One run of plan_nodes_phases at a small size on the CPU, with the
    script's card-only helpers replaced by CPU stand-ins."""
    joins, dec, fact, dim = small
    mp = pytest.MonkeyPatch()
    try:
        for k, v in SMALL.items():
            mp.setattr(cs, k, v)
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        lines = []
        mp.setattr(cs, "emit", lines.append)
        launches = cs.plan_nodes_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c),
            joins["plan_nodes"], joins, dec, fact, dim, conf=CONF,
            device="cpu", rounds=1)
        yield launches, lines[-1]
    finally:
        mp.undo()


def test_launches_per_plan_nodes_path(plan_run):
    """A: 2 per fused join per merged batch, on both plans: the date
    window's two joins over 4 batches unpushed and 1 pushed (its four kept
    row groups), and Q7's two joins over its 1 batch. C, distributed only:
    the date window's fused partial sum and count, 3 a batch, the range's
    (fused with the projection above the range) 3 in its 1 batch, and
    Q7's 8 a batch. q28's and the report's aggregates are global, and the
    sample's partial aggregate sits above the Sample, which ends fusion's
    chain."""
    launches, line = plan_run
    assert launches["plan_nodes"] == {
        "murmur3_rows": 4 * 4 + 4 + 4, "segment_sum_f64": 0,
        "segment_sum_i64": 0}
    assert launches["plan_nodes_distributed"] == {
        "murmur3_rows": 4 * 4 + 4 + 4, "segment_sum_f64": 0,
        "segment_sum_i64": 3 * 4 + 3 + 3 + 8}
    q = line["one_device"]["queries"]
    assert q["date_window_pushed"]["scan"]["rowgroups_pruned"] == 12 == \
        line["sorted_file"]["rowgroups_pruned_predicted"]
    assert q["agg_report_pushed"]["scan"]["bytes_materialized"] == 0
    assert q["q28_pushed"]["scan"]["rows_pruned"] > 0
    assert q["q28"]["scan"] == {"rows_pruned": 0, "bytes_materialized": 0,
                                "rowgroups_pruned": 0}
    assert line["distributed"]["queries"]["opt_engine"]["bang_lines"] == \
        list(cs.OPT_MARKS["opt_engine"])


def test_sample_mask_np_is_the_engines(small):
    """The script's numpy copy of the mask draws the JAX mask's bits, at
    offsets near 2^63 too."""
    for off in (0, 977, 2 ** 63 - 100, 2 ** 64 - 50):
        for seed in (17, 0, -3):
            assert np.array_equal(
                cs.sample_mask_np(300, off, 0.3, seed),
                jax_sample_mask(np, 300, off, 0.3, seed))


def _jax_ns():
    m = SimpleNamespace(**{n: getattr(JE, n) for n in (
        "col", "lit", "Sum", "Count", "Average", "CaseWhen", "IsNull",
        "IsNotNull", "In", "Min", "Max", "Coalesce")})
    from spark_rapids_tpu import types as JT
    m.double, m.money = JT.DoubleType(), JT.DecimalType(*cs.MONEY)
    return m


def test_jax_engine_agrees(small):
    """The phase's queries but q28 (whose decimal averages the JAX CPU
    engine computes otherwise: ROADMAP.md, known differences) on the JAX
    engine's CPU engine, pushdown on, equal the oracles."""
    joins = small[0]
    data = joins["plan_nodes"]
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PLAN_RANGE", SMALL["PLAN_RANGE"])
    try:
        qs = cs.plan_node_queries(
            JaxSession(dict(CONF, **cs.PLAN_CONF, **cs.PUSHDOWN)), _jax_ns(),
            joins["paths"], data["sorted"], data["window"])
        want = dict(data["oracle"], range=cs.range_oracle())
        for name in ("agg_report", "date_window", "sample", "range"):
            cs.check_plan_query(pa, name, qs[name].collect_cpu(),
                                want[name])
    finally:
        mp.undo()


def _jax_q7(js, paths):
    """star_decimal_queries' Q7 on the JAX engine (its Q36's decimal
    literals need a type there, so the dict is not built whole)."""
    c, lit = JE.col, JE.lit
    it = js.read_parquet(paths["item"]).select(
        "i_brand", "i_category", "i_current_price",
        ss_item_sk=c("i_item_sk"))
    st = js.read_parquet(paths["store"]).select(
        "s_state", ss_store_sk=c("s_store_sk"))
    return js.read_parquet(paths["store_sales"]) \
        .join(it, on="ss_item_sk").join(st, on="ss_store_sk") \
        .filter(c("s_state") == lit("TN")).group_by("i_category") \
        .agg(agg1=JE.Average(c("ss_quantity")),
             agg2=JE.Average(c("ss_list_price")),
             agg3=JE.Average(c("ss_coupon_amt")),
             agg4=JE.Average(c("ss_sales_price")), n=JE.Count(lit(1)))


def test_optimizer_places_as_jax(small):
    """The `!` lines of the optimizer's placement of both queries, at this
    size and with the card's row counts in the footers, are the JAX
    planner's."""
    from spark_rapids_tpu.io import scanbase as jscan
    from spark_rapids_tpu_torch.io import scanbase as pscan
    from spark_rapids_tpu_torch.plugin import TpuSession
    _, dec, fact, dim = small
    head = fact.slice(0, SMALL["FILES_SALES_ROWS"])
    for full in (False, True):
        mp = pytest.MonkeyPatch()
        if full:
            rows = {p: cs.STAR_SALES_ROWS if n == "store_sales" else
                    cs.STAR_DIMS[n] for n, p in dec["paths"].items()}
            for mod in (jscan, pscan):
                mp.setattr(mod.CpuFileScanExec, "footer_row_count",
                           lambda self: sum(rows[p] for p in self.paths))
        try:
            for name, extra in (("opt_q7", cs.OPTIMIZER),
                                ("opt_engine", cs.OPT_HIGH)):
                conf = dict(CONF, **cs.PLAN_CONF, **extra,
                            **cs.EXPLAIN_NOT_ON_GPU)
                ps = TpuSession(conf, device="cpu")
                js = JaxSession(conf)
                if name == "opt_q7":
                    pq_ = cs.star_decimal_queries(ps, cs.star_namespace(),
                                                  dec["paths"])["q7"]
                    jq = _jax_q7(js, dec["paths"])
                else:
                    pq_ = cs.main_query(ps, head, dim)
                    jq = js.from_arrow(head).filter(
                        JE.col("v") > 0.6).join(
                        js.from_arrow(dim), on="k").group_by("g").agg(
                        total=JE.Sum(JE.col("c") + JE.col("w")),
                        cnt=JE.Count(JE.col("v")))
                pq_.explain()
                jo = JaxOverrides(js.conf)
                jo.apply(jq.plan)
                got = cs._bang_lines(ps._last_explain.splitlines())
                assert got == cs._bang_lines(jo.explain_log)
                assert got == cs.OPT_MARKS[name], (name, full, got)
        finally:
            mp.undo()
