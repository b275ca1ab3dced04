"""chip_smoke.py's memory phase (`memory_phases`, `catalog_check`) run on
the CPU at a small size.

On the card the phase parks 1 GiB in the spill catalog under each codec
and holds torch.cuda.memory_allocated's fall and the bit-for-bit read
back, then runs q51's running window, the out-of-core sort, q97 and the
distributed engine query at the session's budget and at a tight one
(spilling to host and disk), and injects a split into the in-core sort of
the running window's rows on one device and into the engine query's
single-batch aggregate, and a retry into q97's probe. Here the decimal
star's and the joins' files are small (row groups of 128 and 4,096 rows,
so that the store sales arrive as 4 merged batches as on the card;
batchSizeRows 256), the host spill store is 1 KiB, the kernel wrappers
take their plain twins with a stand-in counting each call (as in
tests/test_torch_smoke_joins.py), and memory_allocated is the catalog's
device-resident bytes.

Tolerance: exact (tight against loose results, tensors bit for bit)."""

import sys
from pathlib import Path

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.memory.budget import MemoryBudget
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog, StorageTier
from spark_rapids_tpu_torch.ops import pallas_groupby, pallas_probe, \
    pallas_segsum

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_smoke_joins import CONF as JOIN_CONF  # noqa: E402
from test_torch_smoke_joins import SIZES as JOIN_SIZES  # noqa: E402
from test_torch_smoke_parquet import CONF, DIMS, MESH, _counting  # noqa

N_SALES = 2000


def _device_bytes(*args) -> int:
    """The stand-in of torch.cuda.memory_allocated: the bytes of the
    current catalog's device-resident entries."""
    cat = BufferCatalog.get()
    return sum(e.nbytes for e in list(cat._entries.values())
               if e.tier == StorageTier.DEVICE)


@pytest.fixture(scope="module")
def memory_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    saved = MemoryBudget._instance, BufferCatalog._instance
    try:
        d = str(tmp_path_factory.mktemp("memory"))
        mp.setattr(cs, "PARQUET_ROW_GROUP", 128)
        dec = cs.star_decimal_data(pa, d, n_sales=N_SALES, dims=DIMS)
        mp.setattr(cs, "PARQUET_ROW_GROUP", 4096)
        joins = cs.join_data(pa, d, JOIN_SIZES)
        fact, dim = cs.query_tables(pa, 4096, 512, 1024, 64)
        for name, fn in (("synchronize", lambda *a: None),
                         ("reset_peak_memory_stats", lambda *a: None),
                         ("max_memory_allocated", lambda *a: 0),
                         ("memory_allocated", _device_bytes)):
            mp.setattr(torch.cuda, name, fn)
        a = _counting(mp, pallas_probe, "murmur3_rows")
        c = _counting(mp, pallas_groupby, "segment_sum_i64")
        mp.setattr(cs, "JOINS_CONF", dict(cs.JOINS_CONF, **JOIN_CONF))
        mp.setattr(cs, "MEMORY_HOST_LIMIT", 1 << 10)
        yield cs.memory_phases(torch, pa, MESH,
                               (a, pallas_segsum.segment_sum_f64, c),
                               dec, joins, fact, dim, conf=CONF,
                               device="cpu")
    finally:
        mp.undo()
        MemoryBudget._instance, BufferCatalog._instance = saved


def test_catalog_check_every_codec(memory_run):
    lines, _ = memory_run
    codecs = lines[0]["codecs"]
    assert sorted(codecs) == sorted(cs.MEMORY_CODECS)
    for rec in codecs.values():
        assert rec["allocated_fall"] >= rec["device_bytes"] > 0
        assert rec["bit_identical"]
    assert codecs["none"]["host_bytes"] == codecs["none"]["device_bytes"]


def test_tight_budgets_spill_and_agree(memory_run):
    """Each query's tight run equals its loose one (the phase raises
    otherwise), spilled to host and disk on the aggregate, sort and join
    paths, and never at the session's budget."""
    lines, _ = memory_run
    by_query = {ln["query"]: ln for ln in lines if "query" in ln}
    assert set(by_query) == {"running_window", "ooc_sort", "q97",
                             "engine_distributed"}
    for name, ln in by_query.items():
        tight, loose = ln["tight_budget"], ln["session_budget"]
        assert loose["spill"]["to_host"] == 0
        assert tight["budget_bytes"] < loose["peak_budget_bytes"] or \
            name == "engine_distributed"
        if name != "engine_distributed":
            assert tight["spill"]["to_disk_bytes"] > 0
            assert tight["spill"]["unspills"] > 0
    assert by_query["ooc_sort"]["tight_budget"]["sorts"]["out_of_core"] == 1
    assert by_query["q97"]["tight_budget"]["joins"][
        "sub_partition_builds"] == 1


def test_injected_faults(memory_run):
    lines, launches = memory_run
    inject = lines[-1]["injected"]
    assert inject["in_core_sort_split"]["splits"] == 1
    assert inject["in_core_sort_split"]["sorts"]["out_of_core"] == 1
    assert inject["q97_probe_retry"]["retries"] == 1
    assert inject["engine_aggregate_split"]["splits"] == 1
    assert launches["memory"]["murmur3_rows"] > 0
    assert launches["memory_distributed"]["segment_sum_i64"] > 0
