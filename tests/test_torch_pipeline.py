"""The prefetch of spark_rapids_tpu_torch (exec/base.py PrefetchIterator)
with the memory seams, mirroring tests/test_pipeline.py's
TestPrefetchIterator: order kept (beside the JAX iterator on the same
batches), depth bounds the lookahead, parked batches are visible to the
budget, typed errors cross the queue, an early close frees the parked
batches, and a dead producer holds no admission permit. Then the
parquet scan's 64-file MULTITHREADED host read with one admission permit
and a budget its prefetch overflows: the producer adopts the task's hold,
the reader's pool threads take none, and the read ends, equal to pyarrow's.

Tolerance: exact (values, counts)."""

import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.batch import \
    batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.columnar.batch import batch_to_arrow as jax_to_arrow
from spark_rapids_tpu.exec.base import PrefetchIterator as JaxPrefetch
from spark_rapids_tpu.memory.budget import MemoryBudget as JaxBudget

from spark_rapids_tpu_torch.columnar.batch import (batch_from_arrow,
                                                   batch_to_arrow)
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec.base import PrefetchIterator
from spark_rapids_tpu_torch.expr import col
from spark_rapids_tpu_torch.memory.budget import MemoryBudget
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.spillable import SpillableColumnarBatch
from spark_rapids_tpu_torch.plugin import TpuSession
from spark_rapids_tpu_torch.utils.metrics import TaskMetrics

CPU = torch.device("cpu")


def _table(i: int, n: int = 64) -> pa.Table:
    return pa.table({"a": pa.array(np.arange(n, dtype=np.int64) + i * n),
                     "b": pa.array(np.full(n, float(i)))})


def _small_batch(i: int, n: int = 64):
    return batch_from_arrow(_table(i, n), CPU)


@pytest.fixture(autouse=True)
def fresh_budget():
    """A session's device manager first, then a fresh unlimited budget, an
    empty catalog and a two-permit semaphore; all restored after."""
    DeviceManager.initialize(TpuConf(), CPU)
    saved = [(c, c._instance) for c in (MemoryBudget, BufferCatalog,
                                         TpuSemaphore)]
    MemoryBudget.initialize(1 << 62)
    BufferCatalog._instance = BufferCatalog(spill_codec="none")
    TpuSemaphore._instance = TpuSemaphore(2)
    TaskMetrics.reset()
    yield MemoryBudget.get()
    for c, inst in saved:
        c._instance = inst


class TestPrefetchIterator:
    def test_order_and_values_preserved(self):
        out = list(PrefetchIterator(iter([_small_batch(i) for i in range(8)]),
                                    depth=2, name="t"))
        jax_saved = JaxBudget._instance
        JaxBudget.initialize(1 << 62)
        try:
            want = [jax_to_arrow(b) for b in JaxPrefetch(
                iter([jax_batch_from_arrow(_table(i)) for i in range(8)]),
                depth=2, name="t")]
        finally:
            JaxBudget._instance = jax_saved
        assert [batch_to_arrow(b) for b in out] == want
        assert [batch_to_arrow(b).column("a")[0].as_py() for b in out] == \
            [i * 64 for i in range(8)]
        assert TaskMetrics.get().prefetch_batches == 8
        assert BufferCatalog.get().live_count == 0

    def test_depth_bounds_producer_lookahead(self):
        produced = []

        def src():
            for i in range(10):
                produced.append(i)
                yield _small_batch(i)

        it = iter(PrefetchIterator(src(), depth=2, name="t"))
        deadline = time.monotonic() + 5
        while len(produced) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # would overrun here if the bound were broken
        assert len(produced) <= 4  # depth 2 + one put waiting + one built
        assert BufferCatalog.get().live_count <= 3
        assert len(list(it)) == 10 and len(produced) == 10

    def test_parked_batches_are_budget_visible(self, fresh_budget):
        """Queued batches are parked spillable and charged; under a budget
        of one batch the older ones spill, and every byte comes back."""
        size = _small_batch(0).device_memory_size()
        MemoryBudget.initialize(size + size // 2)
        budget = MemoryBudget.get()
        pf = PrefetchIterator((_small_batch(i) for i in range(4)), depth=3,
                              name="t")
        deadline = time.monotonic() + 5
        while TaskMetrics.get().prefetch_batches < 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert budget.used > 0
        assert TaskMetrics.get().spill_to_host_ns > 0  # the overflow
        got = [batch_to_arrow(b).column("a")[0].as_py() for b in pf]
        assert got == [0, 64, 128, 192]
        assert budget.used == 0 and budget.peak_used >= 2 * size

    def test_typed_error_propagates_with_original_type(self):
        class WideKey(Exception):
            pass

        def src():
            yield _small_batch(0)
            raise WideKey("wide string key")

        pf = PrefetchIterator(src(), depth=2, name="t")
        it = iter(pf)
        next(it)
        with pytest.raises(WideKey, match="wide string"):
            next(it)
        pf._thread.join(timeout=5)
        assert not pf._thread.is_alive()

    def test_early_close_joins_thread_and_frees_parked(self, fresh_budget):
        pf = PrefetchIterator((_small_batch(i) for i in range(100)),
                              depth=3, name="t")
        it = iter(pf)
        next(it)
        it.close()  # the consumer stops early (a LIMIT)
        pf._thread.join(timeout=5)
        assert not pf._thread.is_alive()
        assert BufferCatalog.get().live_count == 0
        assert fresh_budget.used == 0

    def test_semaphore_not_held_by_dead_producer(self):
        """Producers materialise spillables on their own thread (the
        leak-prone shape): each adopts the task's hold, so after 3 x
        permits producers the permits are all still free."""
        def src():
            sp = SpillableColumnarBatch(_small_batch(0))
            yield sp.get_batch()
            sp.close()

        sem = TpuSemaphore.get()
        for _ in range(3 * sem.permits):  # would deadlock on a leak
            assert len(list(PrefetchIterator(src(), depth=1, name="t"))) == 1
        for _ in range(sem.permits):
            assert sem._sem.acquire(timeout=1)
        for _ in range(sem.permits):
            sem._sem.release()


def test_64_files_multithreaded_with_one_permit(tmp_path):
    """The host decode of 64 files on the MULTITHREADED reader's pool,
    behind the prefetch thread, with concurrentGpuTasks=1 and a budget a
    few prefetched batches overflow, under a sort (out of core: its runs
    are parked too, and materialising them takes the consumer's permit).
    It must end, equal to pyarrow's read, with every parked batch
    closed."""
    rng = np.random.default_rng(9)
    keys = rng.permutation(64 * 50)
    paths = []
    for i in range(64):
        t = pa.table({"k": pa.array(keys[i * 50:(i + 1) * 50]),
                      "v": pa.array(rng.normal(size=50))})
        paths.append(str(tmp_path / f"part-{i:05d}.parquet"))
        pq.write_table(t, paths[-1])
    conf = {"spark.rapids.sql.explain": "NONE",
            "spark.rapids.sql.concurrentGpuTasks": 1,
            "spark.rapids.sql.format.parquet.deviceDecode.enabled": False,
            "spark.rapids.sql.format.parquet.reader.type": "MULTITHREADED",
            "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads": 4,
            "spark.rapids.sql.batchSizeRows": 64}
    sess = TpuSession(conf, device="cpu")
    TpuSemaphore._instance = TpuSemaphore(1)
    MemoryBudget.initialize(3 * batch_from_arrow(
        pq.read_table(paths[0]), CPU).device_memory_size())
    result = {}

    def run():
        result["out"] = sess.read_parquet(*paths).sort(col("k")).collect()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(120)
    assert not t.is_alive(), "the read blocked"
    want = pq.read_table(paths).sort_by("k")
    assert result["out"].equals(want)
    assert BufferCatalog.get().live_count == 0
    assert MemoryBudget.get().used == 0
