"""chip_smoke.py's ordered_reports phase (`ordered_phases`, its queries and
its oracles) run on the CPU at a small size.

On the card the phase holds the ordered Q3, Q7 and Q36 (ORDER BY ...
LIMIT 100, Q36 ranked within its category), the running window and the
out-of-core sort row for row against numpy oracles, and demands exact
launch counts: kernel A twice per fused join per merged batch, kernel C
ORDERED_C_PER_BATCH times a merged batch of the distributed plan's fused
partial aggregate (none in Q36, whose rollup's Expand ends the chain
below its partial aggregate), and neither in the running window or the
sort.
Here, as in tests/test_torch_smoke_decimal.py, the kernel wrappers take
their plain twins and a stand-in counts each call; files hold row groups
of 256 rows (2,000 sales: 2 merged batches), and batchSizeRows is 256, so
the distributed plan's four shard batches of about 470 (item, date) rows
sort out of core.

Tolerance: exact (every column against the oracles, the kernels against
their twins bit for bit), Q7's double average of the quantity rtol
1e-9."""

import sys
from pathlib import Path

import numpy as np
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
def ordered_run():
    """One run of ordered_phases at a small size on the CPU, with the
    script's card-only helpers replaced by CPU stand-ins."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "PARQUET_ROW_GROUP", 256)
        mp.setattr(cs, "idle_share", lambda torch, fn: 0.0)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches, a_args, c_args = cs.ordered_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c),
            n_sales=N_SALES, dims=DIMS, conf=CONF, device="cpu", rounds=1)
        measured = (cs.murmur3_on_path(torch, a_args, cs.H100_BYTES_PER_S,
                                       path="ordered_reports"),
                    cs.segsum_i64_on_path(torch, c_args, cs.H100_BYTES_PER_S,
                                          path="ordered_reports_distributed"))
        yield launches, a_args, c_args, measured
    finally:
        mp.undo()


def test_launches_per_ordered_path(ordered_run):
    """As on the decimal star reports: A 2 per fused join per batch (Q3
    and Q7 one each), C only distributed, (2 + 8) a batch: Q36's partial
    aggregate sits above its rollup's Expand and runs unfused; nothing
    from the running window and the sort."""
    launches = ordered_run[0]
    assert launches["ordered_reports"] == {
        "murmur3_rows": 8, "segment_sum_f64": 0, "segment_sum_i64": 0}
    assert launches["ordered_reports_distributed"] == {
        "murmur3_rows": 8, "segment_sum_f64": 0,
        "segment_sum_i64": 2 * (2 + 8)}


def test_kernels_on_the_ordered_paths(ordered_run):
    _, (keys, valid, seed), (vals, ids, groups), (a_rec, c_rec) = \
        ordered_run
    assert keys.dtype == torch.int64 and vals.dtype == torch.int64
    assert a_rec["max_abs_err"] == 0 and c_rec["max_abs_err"] == 0
    assert int(vals.sum()) == c_rec["sum_of_values"] != 0


@pytest.fixture(scope="module")
def small():
    t = cs.star_decimal_tables(pa, 3000, 400, 60, 8, seed=5)
    return t, cs.star_decimal_oracle(pa, t)


def test_ordered_oracle_orders_and_ranks(small):
    """The oracle's rows follow each report's TPC-DS order; Q36 holds its
    rollup's three levels (the (cat, bucket) rows, one per category, one
    in all), and its rank is the count of smaller margins in its
    (lochierarchy, parent) partition plus one (nulls first)."""
    _, want = small
    got = cs.ordered_oracle(want)
    q3 = list(zip(got["q3"]["d_year"], got["q3"]["sum_agg"],
                  got["q3"]["i_brand"]))
    assert len(q3) == min(cs.ORDERED_LIMIT, len(want["q3"]["sum_agg"]))
    assert q3 == sorted(q3, key=lambda r: (r[0], -r[1], r[2]))
    cats = got["q7"]["i_category"]
    assert cats[0] is None and cats[1:] == sorted(cats[1:])
    q36, rolled = got["q36"], cs.rollup_oracle(want["q36"])
    cats = set(want["q36"]["cat"])
    assert [rolled["lochierarchy"].count(k) for k in (0, 1, 2)] == \
        [len(want["q36"]["cat"]), len(cats), 1]
    assert rolled["profit"][-1] == sum(want["q36"]["profit"])
    for p, lv, g, r in zip(q36["parent"], q36["lochierarchy"],
                           q36["gross_margin"], q36["rank_within_parent"]):
        peers = [h for p2, l2, h in zip(rolled["parent"],
                                        rolled["lochierarchy"],
                                        rolled["gross_margin"])
                 if (p2, l2) == (p, lv)]
        assert r == 1 + sum(1 for h in peers if g is not None
                            and (h is None or h < g))

    def nulls_first(v):
        return (v is not None, v or "")
    keys = [(-lv, nulls_first(p), r, nulls_first(c), nulls_first(b))
            for lv, p, r, c, b in zip(
                q36["lochierarchy"], q36["parent"], q36["rank_within_parent"],
                q36["cat"], q36["bucket"])]
    assert keys == sorted(keys) and len(keys) == min(
        cs.ORDERED_LIMIT, len(rolled["cat"]))


def test_per_day_oracle(small):
    """The running window's oracle against a plain Python loop."""
    t, _ = small
    want = cs.per_day_oracle(t)
    ss = t["store_sales"]
    qty = {}
    for i, d, q in zip(ss.column("ss_item_sk").to_pylist(),
                       ss.column("ss_sold_date_sk").to_pylist(),
                       ss.column("ss_quantity").to_pylist()):
        qty[(i, d)] = qty.get((i, d), 0) + q
    rows = sorted(qty)
    assert list(zip(want["ss_item_sk"], want["ss_sold_date_sk"])) == rows
    cum, rn, prev = [], [], []
    for j, (i, d) in enumerate(rows):
        first = j == 0 or rows[j - 1][0] != i
        cum.append(qty[(i, d)] + (0 if first else cum[-1]))
        rn.append(1 if first else rn[-1] + 1)
        prev.append(None if first else qty[rows[j - 1]])
    assert want["cum_qty"].tolist() == cum
    assert want["rn"].tolist() == rn
    assert [p if ok else None for p, ok in
            zip(want["prev"].tolist(), want["prev_valid"])] == prev
    order = want["ooc_order"]
    assert np.all(np.diff(want["qty"][order]) <= 0)
