"""chip_smoke.py's star_decimal phase (`star_decimal_phases` and its
tables, queries and int64 oracle) run on the CPU at a small size.

On the card the phase holds every decimal result exact against the numpy
int64 oracle and demands exact launch counts: kernel A twice per fused join
per merged batch, and kernel C STAR_DECIMAL_C_PER_BATCH times a merged
batch of the distributed plan's fused partial aggregate (0 on one device).
Here, as in tests/test_torch_smoke_parquet.py, the kernel wrappers take
their plain twins (CPU tensors) and a stand-in counts each call the way the
wrapper counts a launch on the card; `pallas.mode=force` makes the engine
call them on the CPU. Files hold row groups of 256 rows, so 2,000 sales
are 8 row groups and 2 merged batches of 1,024 rows.

Tolerance: exact (the decimal results, keys, counts and Q36's ratio
against the oracle; the kernels against their twins bit for bit), Q7's
double average of the quantity rtol 1e-9. The oracle itself is held
against Python's decimal arithmetic here."""

import decimal
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
def decimal_run():
    """One run of star_decimal_phases at a small size on the CPU, with the
    script's card-only helpers replaced by CPU stand-ins."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "PARQUET_ROW_GROUP", 256)
        mp.setattr(cs, "idle_share", lambda torch, fn: 0.0)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        launches, a_args, c_args = cs.star_decimal_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c),
            n_sales=N_SALES, dims=DIMS, conf=CONF, device="cpu", rounds=1,
            decode_rounds=1)
        measured = (cs.murmur3_on_path(torch, a_args, cs.H100_BYTES_PER_S,
                                       path="star_decimal"),
                    cs.segsum_i64_on_path(torch, c_args, cs.H100_BYTES_PER_S,
                                          path="star_decimal_distributed"))
        yield launches, a_args, c_args, measured
    finally:
        mp.undo()


def test_launches_per_decimal_path(decimal_run):
    """2 merged batches: A 2 per fused join per batch (Q3 and Q7 fuse one
    join each; Q36's join carries a pruning filter), C only distributed:
    (2 + 8 + 7) a batch."""
    launches = decimal_run[0]
    assert launches["star_decimal"] == {
        "murmur3_rows": 8, "segment_sum_f64": 0, "segment_sum_i64": 0}
    assert launches["star_decimal_distributed"] == {
        "murmur3_rows": 8, "segment_sum_f64": 0,
        "segment_sum_i64": 2 * (2 + 8 + 7)}


def test_kernel_inputs_are_the_decimal_paths(decimal_run):
    """A's first input is a merged batch's int64 surrogate keys; C's is
    the distributed Q3's decimal sum: the unscaled ss_ext_sales_price of
    the joined rows, sorted into groups. Both bit for bit."""
    _, (keys, valid, seed), (vals, ids, groups), (a_rec, c_rec) = \
        decimal_run
    assert keys.shape == (1024,) and keys.dtype == torch.int64
    assert vals.dtype == torch.int64 and groups == 1024
    assert vals.abs().max() < 10 ** 7 and (vals % 1 == 0).all()
    assert int(vals.sum()) == c_rec["sum_of_values"] != 0
    assert a_rec["max_abs_err"] == 0 and c_rec["max_abs_err"] == 0


def test_oracle_matches_python_decimal():
    """The int64 oracle's sums and HALF_UP averages against Python's
    decimal on the same small tables."""
    t = cs.star_decimal_tables(pa, 600, 365, 60, 8, seed=3)
    want = cs.star_decimal_oracle(pa, t)
    ss, item = t["store_sales"], t["item"]
    states = t["store"].column("s_state").to_pylist()
    cats = item.column("i_category").to_pylist()
    groups = {}
    for st, it, price in zip(ss.column("ss_store_sk").to_pylist(),
                             ss.column("ss_item_sk").to_pylist(),
                             ss.column("ss_list_price").to_pylist()):
        if states[st] == "TN":
            groups.setdefault(cats[it], []).append(price)
    got = dict(zip(want["q7"]["i_category"], want["q7"]["agg2"]))
    for cat, prices in groups.items():
        mean = (sum(prices) / len(prices)).quantize(
            decimal.Decimal("0.000001"), rounding=decimal.ROUND_HALF_UP)
        assert decimal.Decimal(got[cat]).scaleb(-6) == mean, cat
    ext = np.array([int(v.scaleb(2)) for v in
                    ss.column("ss_ext_sales_price").to_pylist()])
    assert sum(s for s in want["q36"]["sales"]) == int(ext.sum())


def test_money_columns_are_flba_decimals(tmp_path):
    """pyarrow's defaults write decimal(7,2) as FIXED_LEN_BYTE_ARRAY(4),
    and decimal_array/unscaled round trip the unscaled ints."""
    import pyarrow.parquet as pq
    u = np.array([0, 1, -1, 9_999_999, -9_999_999, 12_345], np.int64)
    valid = np.array([True, True, False, True, True, True])
    arr = cs.decimal_array(pa, u, 7, 2, valid)
    assert arr.to_pylist()[3] == decimal.Decimal("99999.99")
    back, ok = cs.unscaled(pa.chunked_array([arr]))
    assert ok.tolist() == valid.tolist()
    assert back[valid].tolist() == u[valid].tolist()
    path = str(tmp_path / "m.parquet")
    pq.write_table(pa.table({"m": arr}), path)
    col = pq.ParquetFile(path).metadata.schema.column(0)
    assert (col.physical_type, col.length) == ("FIXED_LEN_BYTE_ARRAY", 4)
