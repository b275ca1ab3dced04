"""chip_smoke.py's parquet phases (`parquet_phases`, `murmur3_on_path`,
`segsum_i64_on_path`) run on the CPU at a small size.

On the card the script demands exact launch counts on the parquet paths:
kernel A twice per fused join per merged batch, and C as many times a
batch as on the same query from Arrow tables. Here the kernel wrappers
take their plain twins (CPU tensors), so a stand-in counts each call the
way the wrapper counts a launch on the card; `pallas.mode=force` makes
the engine call them on the CPU where `auto` calls them on the card. The
files hold row groups of 256 rows, so 4 row groups merge into one batch
of 1,024 rows, as 4 of 1,048,576 do on the card.

Tolerance: exact (every query's result against the numpy oracles, the
kernels against their twins bit for bit)."""

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

CONF = {"spark.rapids.tpu.fusion.pallas.mode": "force",
        "spark.rapids.sql.batchSizeRows": 256}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        "spark.rapids.tpu.fusion.enabled": True}
DIMS = {"date_dim": 365, "item": 60, "store": 8}


def _counting(monkeypatch, module, name):
    """module.<name> replaced by a stand-in that counts its calls in
    `.launches`, as the wrapper counts its launches on the card."""
    real = getattr(module, name)

    def stand_in(*args):
        stand_in.launches += 1
        return real(*args)

    stand_in.launches, stand_in.__name__ = 0, name
    monkeypatch.setattr(module, name, stand_in)
    return stand_in


@pytest.fixture(scope="module")
def parquet_run():
    """One run of parquet_phases at a small size on the CPU, with the
    script's card-only helpers (synchronize, CUDA-event timing, the traced
    idle share) replaced by CPU stand-ins."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch.cuda, "synchronize", lambda *a: None)
        mp.setattr(cs, "PARQUET_ROW_GROUP", 256)
        mp.setattr(cs, "ARROW_BATCH_ROWS", 256)
        mp.setattr(cs, "idle_share", lambda torch, fn: 0.0)
        mp.setattr(cs, "time_ms", lambda torch, fn, **kw: (fn(), 0.0)[1])
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        fact, dim = cs.query_tables(pa, 3000, 300, 600, 37)
        launches, a_args, c_args = cs.parquet_phases(
            torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c), fact,
            dim, n_sales=2000, dims=DIMS, conf=CONF, device="cpu", rounds=1,
            decode_rounds=1)
        measured = (cs.murmur3_on_path(torch, a_args, cs.H100_BYTES_PER_S,
                                       path="parquet_star_q7"),
                    cs.segsum_i64_on_path(torch, c_args, cs.H100_BYTES_PER_S,
                                          path="parquet_query"))
        yield launches, a_args, c_args, measured
    finally:
        mp.undo()


def test_launches_per_parquet_path(parquet_run):
    """The counts the script demands: 3000 fact rows in 12 row groups are
    3 merged batches, one fused join each (A 6); C 3 a batch distributed
    (9), as from Arrow; none with pruning on (the join is not fused)."""
    launches = parquet_run[0]
    assert launches["parquet_query_one_device_no_dpp"]["murmur3_rows"] == 6
    assert launches["parquet_query_distributed_no_dpp"] == {
        "murmur3_rows": 6, "segment_sum_f64": 0, "segment_sum_i64": 9}
    for plan in ("one_device", "distributed"):
        assert set(launches[f"parquet_query_{plan}"].values()) == {0}
    # 2000 sales rows are 8 row groups: 2 merged batches, 1 fused join
    assert launches["parquet_star_q7"]["murmur3_rows"] == 4


def test_kernel_inputs_are_the_merged_batches(parquet_run):
    """A's and C's captured inputs are those of a merged batch (capacity
    4 row groups), and hold bit for bit against their twins."""
    _, (keys, valid, seed), (vals, ids, groups), (a_rec, c_rec) = \
        parquet_run
    assert keys.shape == valid.shape == seed.shape == (1024,)
    assert keys.dtype == torch.int64 and seed.tolist() == [42] * 1024
    assert vals.shape == ids.shape == (1024,) and groups == 1024
    assert a_rec["rows"] == c_rec["rows"] == 1024
    assert a_rec["bit_identical_to_plain"] and a_rec["max_abs_err"] == 0
    assert c_rec["bit_identical_to_plain"] and c_rec["max_abs_err"] == 0
    assert c_rec["sum_of_values"] == int(vals.sum())


@pytest.mark.parametrize("plan, joins", [
    ("TpuHashAggregateExec[complete]\n  TpuFusedStageExec[FusedStageSpec("
     "members=[Filter[x]; BroadcastHashJoin[inner]])]\n"
     "    TpuFileScanExec(parquet)", 1),
    ("TpuHashAggregateExec[complete]\n  TpuBroadcastHashJoinExec[inner]\n"
     "    TpuFileScanExec(parquet)", 0),
    ("TpuFusedStageExec[members=[BroadcastHashJoin[a]; "
     "BroadcastHashJoin[b]]]", 2),
])
def test_fused_joins_counts_joins_inside_fused_stages(plan, joins):
    assert cs.fused_joins(plan) == joins
