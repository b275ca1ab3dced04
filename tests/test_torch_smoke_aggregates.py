"""chip_smoke.py's tpcds_aggregates phase (`aggregates_phases`, its tables,
queries and numpy oracle) run on the CPU at a small size, and its oracle
held against the JAX engine where that computes the same thing and
against Python ints where it does not.

On the card the phase runs q65 (an average of revenue sums: a decimal(27,2)
partial sum in limbs, across the exchange when distributed), q39a and q39b
(stddev_samp over inventory, a self-join of the grouped result) and a
sum/avg/min/max report of the sales price as decimal(38,18), read from an
FLBA(16) parquet column, on one device and distributed, each row for row
against agg_oracle with exact launch counts of kernels A and C; it decodes
that decimal(38,18) column against pq.read_table and runs every aggregate
of the slice on the card and on the CPU (module_parity). Here the kernel
wrappers take their plain twins and a stand-in counts each call, as in
tests/test_torch_smoke_joins.py; every table arrives as one batch, so the
launches are the card's per batch: A 2 per fused join and key column, C 2
a batch for q65's revenue Sum and q39's two counts, 12 for the report.

Tolerance: exact (keys, strings, decimals as unscaled ints, the kernels
against their twins bit for bit), q39's means and covs rtol 1e-12."""

import decimal
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
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

SIZES = {"store_sales": 16_384, "date_dim": 73_049, "item": 600,
         "store": 12, "warehouse": 3, "inventory_weeks": 9}
CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force"}
# (A, C) a collect: one batch a table, 4 shard batches. Unlike the card,
# q39's self-join is small enough here to be broadcast and fused (two int64
# keys: 4 launches a probe batch)
LAUNCHES = {
    "one_device": {"q65": (10, 0), "q39a": (16, 0), "q39b": (16, 0),
                   "dec38": (0, 0)},
    "distributed": {"q65": (28, 4), "q39a": (28, 4), "q39b": (28, 4),
                    "dec38": (0, 12)},
}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "PARQUET_ROW_GROUP", 16_384)
    try:
        yield cs.agg_data(pa, str(tmp_path_factory.mktemp("aggs")), SIZES)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def aggs_run(small):
    """One run of aggregates_phases at a small size on the CPU, with the
    script's card-only helpers replaced by CPU stand-ins."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "idle_share", lambda torch, fn: 0.0)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches, a_args, c_args = cs.aggregates_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c),
            sizes=SIZES, conf=CONF, device="cpu", rounds=1, warmup=False,
            want_launches=LAUNCHES, data=small, parity_rows=2_048)
        measured = (cs.murmur3_on_path(torch, a_args, cs.H100_BYTES_PER_S,
                                       path="tpcds_aggregates"),
                    cs.segsum_i64_on_path(
                        torch, c_args, cs.H100_BYTES_PER_S,
                        path="tpcds_aggregates_distributed"))
        yield launches, a_args, c_args, measured
    finally:
        mp.undo()


def test_launches_per_aggregates_path(aggs_run):
    """Each query's collect launched what LAUNCHES says (the phase holds
    each one); the path runs sum them."""
    launches = aggs_run[0]
    for plan, path in (("one_device", "tpcds_aggregates"),
                       ("distributed", "tpcds_aggregates_distributed")):
        a = sum(v[0] for v in LAUNCHES[plan].values())
        c = sum(v[1] for v in LAUNCHES[plan].values())
        assert launches[path] == {"murmur3_rows": a, "segment_sum_f64": 0,
                                  "segment_sum_i64": c}


def test_kernels_on_the_aggregates_paths(aggs_run):
    """A on q39a's join keys (int64), C on q65's revenue sums; both bit
    for bit against their twins."""
    _, (keys, valid, seed), (vals, ids, groups), (a_rec, c_rec) = aggs_run
    assert keys.dtype == torch.int64 and vals.dtype == torch.int64
    assert a_rec["max_abs_err"] == 0 and c_rec["max_abs_err"] == 0
    assert int(vals.sum()) == c_rec["sum_of_values"] != 0


def _jax_namespace():
    m = SimpleNamespace(**{n: getattr(JE, n) for n in (
        "col", "lit", "Sum", "Count", "Average", "Min", "Max", "StddevSamp",
        "CaseWhen")})
    m.double = JT.DoubleType()
    return m


def test_oracle_against_the_jax_engine(small):
    """q39a and q39b on the JAX package's CPU engine (the moment form in
    numpy) equal the oracle, means and covs to rtol 1e-12; so do the
    report's Sum, Min and Max over decimal(38,18) (its Average is the
    exact mean in the port and a double in the JAX engine)."""
    qs = cs.agg_queries(JaxSession(dict(CONF, **cs.AGG_CONF)),
                        _jax_namespace(), small["paths"])
    want = small["oracle"]
    for name in ("q39a", "q39b"):
        cs.check_agg_query(pa, name, qs[name].collect_cpu(), want[name])
    c, p = JE.col, JE.col("ss_sales_price")
    # from the Arrow table: the JAX engine's host parquet read and its CPU
    # engine do not carry limbs
    report = JaxSession(CONF).from_arrow(
        small["tables"]["store_sales_dec38"]).group_by("ss_store_sk").agg(
        total=JE.Sum(p), lowest=JE.Min(p), highest=JE.Max(p)) \
        .sort(c("ss_store_sk")).collect()
    for col in ("total", "lowest", "highest"):
        assert cs.unscaled128(report.column(col)) == want["dec38"][col]
    assert len(want["q39a"]["i_item_sk"]) > 0


def test_oracle_against_python(small):
    """q65's averages and revenues from Python's decimal over the same
    rows, and the report's mean: the HALF_UP means the engines cannot
    share (the JAX engine's decimal Average is a double)."""
    t, want = small["tables"], small["oracle"]
    ctx = decimal.Context(prec=60)
    ss, dd = t["store_sales"], t["date_dim"]
    seq = dict(zip(dd.column("d_date_sk").to_pylist(),
                   dd.column("d_month_seq").to_pylist()))
    rev = {}
    for date, store, item, price in zip(*[ss.column(n).to_pylist() for n in (
            "ss_sold_date_sk", "ss_store_sk", "ss_item_sk",
            "ss_sales_price")]):
        lo, hi = cs.Q65_MONTHS
        if price is not None and lo <= seq[date] <= hi:
            rev[store, item] = rev.get((store, item), 0) + price
    for store, ave in want["q65_ave"].items():
        sel = [v for (s, _), v in rev.items() if s == store]
        if sel:
            exact = ctx.divide(sum(sel), len(sel)).quantize(
                decimal.Decimal("0.000001"), rounding=decimal.ROUND_HALF_UP)
            assert ave == int(exact.scaleb(6))
    assert len(want["q65"]["revenue"]) == cs.AGG_LIMIT
    prices = {}
    d38 = t["store_sales_dec38"]
    for store, p in zip(d38.column("ss_store_sk").to_pylist(),
                        d38.column("ss_sales_price").to_pylist()):
        if p is not None:
            prices.setdefault(store, []).append(p)
    for k, store in enumerate(want["dec38"]["ss_store_sk"]):
        exact = ctx.divide(sum(prices[store]), len(prices[store])).quantize(
            decimal.Decimal(1).scaleb(-22), rounding=decimal.ROUND_HALF_UP)
        assert want["dec38"]["mean"][k] == int(exact.scaleb(22))


def test_tables_follow_tpc_ds(small):
    """inventory is every second item in every warehouse, weekly from
    2001-01-01; i_item_desc holds 4-200 bytes and is unique; the
    decimal(38,18) prices equal the decimal(7,2) ones."""
    t = small["tables"]
    inv = t["inventory"]
    assert inv.num_rows == SIZES["inventory_weeks"] * \
        (SIZES["item"] // 2) * SIZES["warehouse"]
    assert set(inv.column("inv_item_sk").to_pylist()) == \
        set(range(1, SIZES["item"] + 1, 2))
    desc = t["item"].column("i_item_desc").to_pylist()
    assert len(set(desc)) == len(desc)
    assert 4 <= min(map(len, desc)) and max(map(len, desc)) <= 200
    a = t["store_sales"].column("ss_sales_price").to_pylist()
    b = t["store_sales_dec38"].column("ss_sales_price").to_pylist()
    assert [x is None for x in a] == [x is None for x in b]
    assert all(x == y for x, y in zip(a, b) if x is not None)
    assert np.isclose(np.mean([x is None for x in a]), cs.PRICE_NULL_SHARE,
                      atol=0.01)
