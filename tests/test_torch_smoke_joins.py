"""chip_smoke.py's tpcds_joins phase (`joins_phases`, its tables, queries
and numpy oracle) run on the CPU at a small size, and its queries held
against the JAX engine.

On the card the phase runs q97 (a full outer join of two distinct-pair
aggregates, the sub-partition join on one device), q10 (a semi join and
two existence joins under OR, an IN list), q58 (string-keyed joins with
conditions, and the same joins before them) and q28 (cross joins of six
one-row aggregates) on one device and distributed, each row for row
against join_oracle, with exact launch counts of kernels A and C. Here,
as in tests/test_torch_smoke_ordered.py, the kernel wrappers take their
plain twins and a stand-in counts each call. The sizes keep the card's
plan shapes: date_dim holds the sales' 1,828 days alone, so the broadcast
threshold (20,000 bytes here, 10 MiB there) and the sub-partition
threshold (8,192 rows here, 4,194,304 there) fall between the same
estimates, and store, catalog and web sales arrive as
one merged batch each (four, two and one there), so A launches 2 per
fused join per batch and C 6 a shard batch in q10 and 2 a batch in q58.
q58's band is widened to 30 %, since few items pass 10 % at this size.

Tolerance: exact (counts and decimals as unscaled ints, the kernels
against their twins bit for bit), q58's doubles rtol 1e-9."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pyarrow as pa
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

SIZES = {"store_sales": 32_768, "catalog_sales": 16_384,
         "web_sales": 8_192, "date_dim": 1_828, "item": 40,
         "customer": 1_000, "customer_address": 500,
         "customer_demographics": 1_000}
CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force",
        "spark.rapids.sql.autoBroadcastJoinThreshold": 20_000,
        "spark.rapids.sql.join.subPartition.rows": 8_192}
# (A, C) a collect: one merged batch per sales file, 4 shard batches
LAUNCHES = {
    "one_device": {"q97": (4, 0), "q10": (6, 0), "q58": (12, 0),
                   "q58_pairs": (12, 0), "q28": (0, 0)},
    "distributed": {"q97": (4, 0), "q10": (6, 24), "q58": (12, 6),
                    "q58_pairs": (12, 6), "q28": (0, 0)},
}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PARQUET_ROW_GROUP", 8_192)
    mp.setattr(cs, "N_COUNTIES", 10)
    mp.setattr(cs, "Q58_BAND", 0.3)
    try:
        yield cs.join_data(pa, str(tmp_path_factory.mktemp("joins")), SIZES)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def joins_run(small):
    """One run of joins_phases at a small size on the CPU, with the
    script's card-only helpers replaced by CPU stand-ins."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "Q58_BAND", 0.3)
        mp.setattr(cs, "idle_share", lambda torch, fn: 0.0)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches, a_args, c_args = cs.joins_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c),
            sizes=SIZES, conf=CONF, device="cpu", rounds=1, warmup=False,
            want_launches=LAUNCHES, data=small)
        measured = (cs.murmur3_on_path(torch, a_args, cs.H100_BYTES_PER_S,
                                       path="tpcds_joins"),
                    cs.segsum_i64_on_path(torch, c_args, cs.H100_BYTES_PER_S,
                                          path="tpcds_joins_distributed"))
        yield launches, a_args, c_args, measured
    finally:
        mp.undo()


def test_launches_per_joins_path(joins_run):
    """Each query's collect launched what LAUNCHES says (the phase holds
    each one); the path runs sum them."""
    launches = joins_run[0]
    for plan, path in (("one_device", "tpcds_joins"),
                       ("distributed", "tpcds_joins_distributed")):
        a = sum(v[0] for v in LAUNCHES[plan].values())
        c = sum(v[1] for v in LAUNCHES[plan].values())
        assert launches[path] == {"murmur3_rows": a, "segment_sum_f64": 0,
                                  "segment_sum_i64": c}


def test_kernels_on_the_joins_paths(joins_run):
    """A on q97's date-join keys (int64), C on q58's decimal sums; both
    bit for bit against their twins."""
    _, (keys, valid, seed), (vals, ids, groups), (a_rec, c_rec) = joins_run
    assert keys.dtype == torch.int64 and vals.dtype == torch.int64
    assert a_rec["max_abs_err"] == 0 and c_rec["max_abs_err"] == 0
    assert int(vals.sum()) == c_rec["sum_of_values"] != 0


def test_jax_engine_agrees(small):
    """q97, q10 and q58 (before and after its conditions) on the JAX
    engine's CPU engine, over the same files, equal the oracle; q28's
    counts do too (its decimal averages differ there: ROADMAP.md, known
    differences)."""
    m = SimpleNamespace(**{n: getattr(JE, n) for n in (
        "col", "lit", "Sum", "Count", "Average", "CaseWhen", "IsNull",
        "IsNotNull", "In")})
    m.double, m.money = JT.DoubleType(), JT.DecimalType(*cs.MONEY)
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "Q58_BAND", 0.3)
    try:
        qs = cs.join_queries(JaxSession(dict(CONF, **cs.JOINS_CONF)), m,
                             small["paths"])
    finally:
        mp.undo()
    want = small["oracle"]
    for name in ("q97", "q10", "q58", "q58_pairs"):
        cs.check_join_query(pa, name, qs[name].collect_cpu(), want[name])
    q28 = qs["q28"].collect_cpu()
    for i in range(1, 7):
        assert q28.column(f"B{i}_CNT").to_pylist() == want["q28"][f"B{i}_CNT"]
    assert len(want["q58"]["i_item_id"]) > 0 and len(want["q10"]["cnt1"]) > 0


def test_oracle_against_plain_python(small):
    """q97's counts and q58's joined-item count from Python sets over the
    same tables."""
    t, want = small["tables"], small["oracle"]

    def pairs(tab, p, cust):
        return set(zip(tab.column(cust).to_pylist(),
                       tab.column(f"{p}_item_sk").to_pylist()))
    s = pairs(t["store_sales"], "ss", "ss_customer_sk")
    c = pairs(t["catalog_sales"], "cs", "cs_bill_customer_sk")
    assert want["q97"] == {"store_only": [len(s - c)],
                           "catalog_only": [len(c - s)],
                           "store_and_catalog": [len(s & c)]}
    dates = t["date_dim"]
    q1 = {sk for sk, y, q in zip(*[dates.column(n).to_pylist() for n in (
        "d_date_sk", "d_year", "d_qoy")]) if y == 2000 and q == 1}
    ids = []
    for name, p in (("store_sales", "ss"), ("catalog_sales", "cs"),
                    ("web_sales", "ws")):
        tab = t[name]
        ids.append({(i - 1) // 2 for d, i in zip(
            tab.column(f"{p}_sold_date_sk").to_pylist(),
            tab.column(f"{p}_item_sk").to_pylist()) if d in q1})
    assert want["q58_pairs"] == {"pairs": [len(ids[0] & ids[1] & ids[2])]}


def test_item_ids_and_demographics():
    """i_item_id is 16 characters, each on two rows; customer_demographics
    is dsdgen's cross product in full (1,920,800 combinations, the first
    attribute fastest)."""
    ids = cs._item_ids(6)
    assert list(ids) == ["AAAAAAAAAAAAAAAB"] * 2 + ["AAAAAAAAAAAAAAAC"] * 2 \
        + ["AAAAAAAAAAAAAAAD"] * 2
    codes = cs._cd_codes(cs.JOIN_SIZES["customer_demographics"])
    assert [int(c.max()) + 1 for c in codes] == [2, 5, 7, 20, 4, 7, 7, 7]
    assert [int(c[1]) for c in codes] == [1, 0, 0, 0, 0, 0, 0, 0]
