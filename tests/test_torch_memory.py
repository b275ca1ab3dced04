"""The memory layer of spark_rapids_tpu_torch (memory/: the budget, the
spill catalog, spillable batches, OOM retry, the admission semaphore and
the device manager) and its seams in the sort, window, aggregate and join
execs, against the JAX package's memory layer on the CPU.

The unit cases are tests/test_memory.py's, on the port's classes; where an
operation is cheap in both packages (a spill, a split, a budget under
pressure) the JAX classes run it too and the outcomes must agree. The
round trip through the catalog runs every carried layout with nulls
(int8-64, float, double, bool, date, timestamp, decimal64, decimal128
limbs, strings) and every codec (none, zstd, lz4xla) to the host and to
disk, on the JAX engine's own padded buffers (tests/torch_port.py): every
tensor comes back bit for bit, padding included, and the rows equal the
JAX batch's.

The exec cases mirror tests/test_faults.py (sort, window and aggregate
survive injected OOM), tests/test_scaleout.py (injected split and retry in
a many-batch aggregate) and tests/test_observability.py (parking over the
budget spills older runs), and add tight budgets under which the
out-of-core sort's runs, the hash join's build, the sub-partition join's
parts and the nested-loop join's chunks spill. Each plan runs through both
engines with the same conf, budget and injection index: the rows must be
equal, and so must the TaskMetrics retry and split counts wherever the
two execs make the same seam calls (each case that differs says why).

The singletons of both packages are saved and restored around every test
by the fixture below.

Tolerance: exact everywhere (rows, nulls, tensors bit for bit, counts)."""

import decimal
import logging
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.columnar import batch_from_arrow as jax_batch_from_arrow
from spark_rapids_tpu.columnar import batch_to_arrow as jax_batch_to_arrow
from spark_rapids_tpu.memory.budget import MemoryBudget as JaxBudget
from spark_rapids_tpu.memory.catalog import BufferCatalog as JaxCatalog
from spark_rapids_tpu.memory.catalog import StorageTier as JaxTier
from spark_rapids_tpu.memory.device_manager import \
    DeviceManager as JaxManager
from spark_rapids_tpu.memory.retry import split_batch_halves as jax_split
from spark_rapids_tpu.memory.retry import with_retry as jax_with_retry
from spark_rapids_tpu.memory.spillable import \
    SpillableColumnarBatch as JaxSpillable
from spark_rapids_tpu.memory.semaphore import TpuSemaphore as JaxSemaphore
from spark_rapids_tpu.plugin import TpuSession as JaxSession
from spark_rapids_tpu.utils.metrics import TaskMetrics as JaxMetrics

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.errors import RetryOOM, SplitAndRetryOOM
from spark_rapids_tpu_torch.exec import joins as port_joins
from spark_rapids_tpu_torch.exec import sort as port_sort
from spark_rapids_tpu_torch.memory import catalog as port_catalog
from spark_rapids_tpu_torch.memory.budget import MemoryBudget
from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                   SpillPriority,
                                                   StorageTier)
from spark_rapids_tpu_torch.memory.device_manager import DeviceManager
from spark_rapids_tpu_torch.memory.retry import (split_batch_halves,
                                                 with_retry,
                                                 with_retry_no_split)
from spark_rapids_tpu_torch.memory.semaphore import TpuSemaphore
from spark_rapids_tpu_torch.memory.spillable import SpillableColumnarBatch
from spark_rapids_tpu_torch.plugin import TpuSession
from spark_rapids_tpu_torch.utils.metrics import TaskMetrics
from torch_port import assert_same_rows, port_batch, positional

CODECS = ("none", "zstd", "lz4xla")
# the JAX engine's plan-root prefetch thread races its spills under a tight
# budget (and the port prefetches file scans only): the execs run serially
BASE = {"spark.rapids.sql.explain": "NONE",
        "spark.rapids.tpu.pipeline.enabled": False}


@pytest.fixture(autouse=True)
def fresh_singletons():
    """Both packages' budget, catalog and semaphore saved and restored, a
    fresh catalog and an unlimited budget for the test, fresh metrics."""
    # the device managers first: a session made in the test must not size
    # a new budget over the one set here
    DeviceManager.initialize(TpuConf(BASE), torch.device("cpu"))
    JaxManager.initialize()
    saved = [(cls, cls._instance) for cls in (
        MemoryBudget, BufferCatalog, TpuSemaphore, JaxBudget, JaxCatalog,
        JaxSemaphore)]
    MemoryBudget.initialize(1 << 62)
    JaxBudget.initialize(1 << 62)
    BufferCatalog._instance = BufferCatalog(spill_codec="none")
    JaxCatalog._instance = JaxCatalog(spill_codec="none")
    TaskMetrics.reset()
    JaxMetrics.reset()
    yield
    for cls, inst in saved:
        cls._instance = inst


def _tables(n=100):
    return pa.table({"a": pa.array(np.arange(n, dtype=np.int64)),
                     "s": pa.array([f"row{i}" for i in range(n)])})


def _both(t):
    """(the JAX batch of t, the port's batch of the same padded buffers)."""
    jb = jax_batch_from_arrow(t)
    return jb, port_batch(jb)


def _batch(n=100):
    return _both(_tables(n))[1]


# ---------------------------------------------------------------------------
# tests/test_memory.py's cases on the port's classes
# ---------------------------------------------------------------------------


class TestSpillCatalog:
    def test_spill_to_host_and_back(self):
        jb, b = _both(_tables())
        cat = BufferCatalog(host_limit=1 << 30, spill_codec="none")
        jcat = JaxCatalog(host_limit=1 << 30, spill_codec="none")
        h, jh = cat.add_batch(b), jcat.add_batch(jb)
        assert cat.tier_of(h) == StorageTier.DEVICE
        freed, jfreed = cat.synchronous_spill(1), jcat.synchronous_spill(1)
        assert freed == jfreed == b.device_memory_size() > 0
        assert cat.tier_of(h) == StorageTier.HOST
        assert jcat.tier_of(jh) == JaxTier.HOST
        back = cat.acquire_batch(h)
        assert cat.tier_of(h) == StorageTier.DEVICE
        assert batch_to_arrow(back).equals(
            jax_batch_to_arrow(jcat.acquire_batch(jh)))
        cat.remove(h)
        jcat.remove(jh)

    def test_spill_overflows_to_disk(self, tmp_path):
        cat = BufferCatalog(spill_dir=str(tmp_path), host_limit=1,
                            spill_codec="none")
        h = cat.add_batch(_batch())
        cat.synchronous_spill(1)
        assert cat.tier_of(h) == StorageTier.DISK
        assert len(os.listdir(tmp_path)) == 1
        back = cat.acquire_batch(h)
        assert batch_to_arrow(back).column("s").to_pylist() == \
            [f"row{i}" for i in range(100)]
        assert os.listdir(tmp_path) == []
        cat.remove(h)

    def test_spill_priority_order(self):
        cat = BufferCatalog(host_limit=1 << 30, spill_codec="none")
        low = cat.add_batch(_batch(), SpillPriority.SPILL_FIRST)
        high = cat.add_batch(_batch(), SpillPriority.ACTIVE_BATCH)
        cat.synchronous_spill(1)  # needs little: the low one only
        assert cat.tier_of(low) == StorageTier.HOST
        assert cat.tier_of(high) == StorageTier.DEVICE


class TestSpillableBatch:
    def test_roundtrip(self):
        sb = SpillableColumnarBatch(_batch(50))
        assert sb.num_rows == 50
        assert sb.get_batch().row_count() == 50
        sb.close()
        sb.close()  # idempotent
        with pytest.raises(ValueError):
            sb.get_batch()
        assert MemoryBudget.get().used == 0


class TestRetry:
    def test_retry_oom_then_success(self):
        calls = {"n": 0}

        def fn(x):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RetryOOM("pressure")
            return x * 2

        assert with_retry_no_split(21, fn) == 42
        assert calls["n"] == 3
        tm = TaskMetrics.get()
        assert tm.retry_count == 2 and tm.retry_backoff_ms == [2.0, 4.0]

    def test_retry_gives_up(self):
        def fn(x):
            raise RetryOOM("always")

        with pytest.raises(RetryOOM):
            list(with_retry(1, fn))
        assert TaskMetrics.get().retry_count == 9  # MAX_RETRIES + 1

    def test_split_and_retry(self):
        """100 -> 50+50 -> 25 x 4 in both packages."""
        from spark_rapids_tpu.errors import SplitAndRetryOOM as JaxSplit

        def run(spillable, with_retry_fn, split, rows, split_oom):
            log = []

            def fn(sb):
                if sb.num_rows > 25:
                    raise split_oom("too big")
                n = rows(sb.get_batch())
                sb.close()
                return n

            def split_fn(sb):
                halves = split(sb)
                log.append(len(halves))
                return halves

            return list(with_retry_fn(spillable, fn, split_fn)), log

        jb, b = _both(_tables(100))
        got, log = run(SpillableColumnarBatch(b), with_retry,
                       split_batch_halves, lambda x: x.row_count(),
                       SplitAndRetryOOM)
        want, jlog = run(JaxSpillable(jb), jax_with_retry, jax_split,
                         lambda x: int(x.row_count()), JaxSplit)
        assert got == want == [25] * 4
        assert log == jlog == [2, 2, 2]
        assert BufferCatalog.get().live_count == 0

    def test_injection_via_budget(self):
        MemoryBudget.get().reset_injection(retry_at=1)
        with pytest.raises(RetryOOM, match="injected"):
            MemoryBudget.get().reserve(1024)
        MemoryBudget.get().reserve(1024)  # the next one succeeds
        MemoryBudget.get().release(1024)
        MemoryBudget.get().reset_injection(split_at=2)
        MemoryBudget.get().reserve(0)
        with pytest.raises(SplitAndRetryOOM, match="injected"):
            MemoryBudget.get().reserve(0)


class TestBudget:
    def test_exhaustion_raises_split(self):
        for budget_cls in (MemoryBudget, JaxBudget):
            budget_cls.initialize(1000)
            b = budget_cls.get()
            b.reserve(900)
            with pytest.raises(Exception) as err:
                b.reserve(500)
            assert type(err.value).__name__ == "SplitAndRetryOOM"
            b.release(900)
            assert b.used == 0 and b.peak_used == 900

    def test_oom_dump_dir_writes_catalog_state(self, tmp_path):
        conf = TpuConf({"spark.rapids.memory.gpu.oomDumpDir":
                        str(tmp_path / "dumps")})
        MemoryBudget.initialize(1000, conf)
        cat = BufferCatalog.get()
        h = cat.add_batch(_batch(), label="suspect")
        cat.synchronous_spill(1 << 40)  # host tier now: nothing frees
        with pytest.raises(SplitAndRetryOOM):
            MemoryBudget.get().reserve(5000)
        files = os.listdir(tmp_path / "dumps")
        assert len(files) == 1 and files[0].startswith("oom_dump_")
        text = (tmp_path / "dumps" / files[0]).read_text()
        assert "MemoryBudget: need=5000" in text
        assert "suspect" in text and "rows=100" in text
        cat.remove(h)

    def test_shutdown_logs_leaked_handles(self, caplog):
        cat = BufferCatalog.get()
        h = cat.add_batch(_batch(), label="leaky")
        saved = (DeviceManager._initialized, DeviceManager.device,
                 DeviceManager.budget_bytes, DeviceManager.hbm_total)
        try:
            with caplog.at_level(logging.WARNING,
                                 "spark_rapids_tpu_torch.memory"):
                DeviceManager.shutdown()
        finally:
            (DeviceManager._initialized, DeviceManager.device,
             DeviceManager.budget_bytes, DeviceManager.hbm_total) = saved
        assert any("leaked buffer handle" in r.message and
                   "leaky" in r.message for r in caplog.records)
        cat.remove(h)

    def test_pressure_spills_catalog(self):
        """A reserve over the budget spills the parked batch and then
        succeeds, in both packages."""
        for budget_cls, cat, batch, tier in (
                (MemoryBudget, BufferCatalog.get(), _batch(),
                 StorageTier.HOST),
                (JaxBudget, JaxCatalog.get(),
                 jax_batch_from_arrow(_tables()), JaxTier.HOST)):
            h = cat.add_batch(batch)
            size = batch.device_memory_size()
            budget_cls.initialize(size + 100)
            budget_cls.get().reserve(size)  # the parked batch's bytes
            budget_cls.get().reserve(size)
            assert cat.tier_of(h) == tier
            assert budget_cls.get().used == size
            cat.remove(h)


class TestSemaphore:
    def test_limits_concurrency(self):
        TpuSemaphore._instance = None
        TpuSemaphore.initialize(2)
        sem = TpuSemaphore.get()
        active, peak = [], []
        lock = threading.Lock()

        def task():
            sem.acquire_if_necessary()
            with lock:
                active.append(1)
                peak.append(len(active))
            time.sleep(0.02)
            with lock:
                active.pop()
            sem.complete_task()

        threads = [threading.Thread(target=task) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert max(peak) <= 2

    def test_reentrant_and_adopted(self):
        TpuSemaphore._instance = None
        TpuSemaphore.initialize(1)
        sem = TpuSemaphore.get()
        sem.acquire_if_necessary()
        sem.acquire_if_necessary()  # the same thread: no deadlock
        done = []

        def producer():  # shares the task's hold: takes no permit
            sem.adopt_task_hold()
            sem.acquire_if_necessary()
            sem.complete_task()
            done.append(True)

        t = threading.Thread(target=producer)
        t.start()
        t.join(5)
        assert done == [True]
        sem.complete_task()
        assert sem._sem.acquire(timeout=1)  # the one permit came back
        sem._sem.release()


class TestCompressedSpill:
    def test_host_spill_compressed_roundtrip(self):
        n = 4096
        t = pa.table({
            "a": pa.array(np.arange(n) % 5, type=pa.int64()),
            "b": pa.array(np.zeros(n), type=pa.float64()),
            "s": pa.array([f"tag{i % 3}" for i in range(n)]),
        })
        cat = BufferCatalog(host_limit=1 << 24, spill_codec="zstd")
        b = _both(t)[1]
        raw = b.device_memory_size()
        h = cat.add_batch(b)
        del b
        assert cat.synchronous_spill(raw) == raw
        assert cat.tier_of(h) == StorageTier.HOST
        assert 0 < cat.host_used < raw // 4  # redundant data compresses
        back = cat.acquire_batch(h)
        assert cat.host_used == 0
        assert batch_to_arrow(back).equals(t)
        cat.remove(h)

    def test_disk_spill_compressed_roundtrip(self, tmp_path):
        t = pa.table({"x": pa.array(np.arange(512), type=pa.int64())})
        cat = BufferCatalog(spill_dir=str(tmp_path), host_limit=1,
                            spill_codec="zstd")
        h = cat.add_batch(_both(t)[1])
        cat.synchronous_spill(1 << 30)
        assert cat.tier_of(h) == StorageTier.DISK
        assert batch_to_arrow(cat.acquire_batch(h)).equals(t)
        cat.remove(h)

    def test_unknown_codec_raises(self):
        with pytest.raises(ValueError, match="unknown spill codec"):
            BufferCatalog(spill_codec="snappy")
        with pytest.raises(ValueError, match="not in allowed values"):
            TpuConf({"spark.rapids.memory.spill.compression.codec":
                     "snappy"}).get(
                "spark.rapids.memory.spill.compression.codec")

    def test_spill_write_failure_keeps_host(self, tmp_path, monkeypatch):
        """An OSError on the disk write leaves the entry at HOST, whole; a
        read error is retried once."""
        cat = BufferCatalog(spill_dir=str(tmp_path), host_limit=1,
                            spill_codec="none")
        t = pa.table({"a": pa.array(np.arange(64, dtype=np.int64))})

        def fail(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(cat, "_host_to_disk", fail)
        h = cat.add_batch(_both(t)[1])
        cat.synchronous_spill(1)
        assert cat.tier_of(h) == StorageTier.HOST
        monkeypatch.undo()
        h2 = cat.add_batch(_both(t)[1])
        cat.synchronous_spill(1)
        assert cat.tier_of(h2) == StorageTier.DISK
        reads = []
        real = BufferCatalog._read_spill

        def flaky(path):
            reads.append(path)
            if len(reads) == 1:
                raise OSError("transient")
            return real(path)

        monkeypatch.setattr(BufferCatalog, "_read_spill",
                            staticmethod(flaky))
        for handle in (h, h2):
            assert batch_to_arrow(cat.acquire_batch(handle)).equals(t)
        assert len(reads) == 2
        cat.remove(h)
        cat.remove(h2)


# ---------------------------------------------------------------------------
# the round trip of every carried layout and codec
# ---------------------------------------------------------------------------


def _layout(kind: str, n: int, rng) -> pa.Array:
    """n values of one layout, ~15 % null."""
    nulls = rng.random(n) < 0.15
    if kind == "bool":
        return pa.array(rng.random(n) < 0.5, mask=nulls)
    if kind in ("int8", "int16", "int32", "int64"):
        info = np.iinfo(kind)
        vals = rng.integers(info.min, info.max, n, dtype=kind,
                            endpoint=True)
        return pa.array(vals, mask=nulls)
    if kind in ("float32", "float64"):
        vals = rng.normal(0, 1e6, n).astype(kind)
        vals[:3] = [np.nan, -0.0, np.inf]
        return pa.array(vals, mask=nulls)
    if kind == "date":
        return pa.array(rng.integers(-10_000, 30_000, n).astype(np.int32),
                        type=pa.int32(), mask=nulls).cast(pa.date32())
    if kind == "timestamp":
        return pa.array(rng.integers(-2 ** 50, 2 ** 50, n), type=pa.int64(),
                        mask=nulls).cast(pa.timestamp("us", tz="UTC"))
    if kind in ("decimal64", "decimal128"):
        p, s = (18, 4) if kind == "decimal64" else (38, 10)
        hi = 10 ** (p - 1)
        vals = [int(rng.integers(-2 ** 62, 2 ** 62)) *
                (int(rng.integers(1, 2 ** 60)) if p > 18 else 1) % hi
                for _ in range(n)]
        return pa.array([None if m else decimal.Decimal(v).scaleb(-s)
                         for v, m in zip(vals, nulls)],
                        type=pa.decimal128(p, s))
    if kind == "string":
        pool = ["", "a", "日本語", "x" * 40, "\x00z", "tail  "]
        return pa.array([None if m else pool[i] for i, m in
                         zip(rng.integers(0, len(pool), n), nulls)])
    raise ValueError(kind)


LAYOUTS = ("int8", "int16", "int32", "int64", "float32", "float64", "bool",
           "date", "timestamp", "decimal64", "decimal128", "string")


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bit pattern (NaN equals itself bit for bit)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _spill_roundtrip(t: pa.Table, codec: str, tier: str, tmp_path):
    """Park the port batch of t's JAX buffers, spill it to `tier`, read it
    back: every tensor bit for bit (padding too), rows as the JAX batch's,
    and the host bytes by the codec."""
    jb, b = _both(t)
    before, _ = b.flatten()
    before = [x.clone() for x in before]
    cat = BufferCatalog(spill_dir=str(tmp_path),
                        host_limit=1 if tier == "disk" else 1 << 30,
                        spill_codec=codec)
    h = cat.add_batch(b)
    del b
    assert cat.synchronous_spill(1) > 0
    assert cat.tier_of(h) == (StorageTier.DISK if tier == "disk"
                              else StorageTier.HOST)
    back = cat.acquire_batch(h)
    after, _ = back.flatten()
    assert len(after) == len(before)
    for x, y in zip(before, after):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))  # NaN payloads too
    assert_same_rows([jb], [back])
    cat.remove(h)
    assert cat.host_used == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_roundtrip_each_layout(layout, tmp_path):
    """Each layout alone, to the host and back, through one of the codecs
    in turn (all three run on every layout in the case below)."""
    rng = np.random.default_rng(LAYOUTS.index(layout) + 11)
    t = pa.table({layout: _layout(layout, 300, rng)})
    _spill_roundtrip(t, CODECS[LAYOUTS.index(layout) % 3], "host", tmp_path)


@pytest.mark.parametrize("tier", ("host", "disk"))
@pytest.mark.parametrize("codec", CODECS)
def test_roundtrip_every_layout(codec, tier, tmp_path):
    rng = np.random.default_rng(5)
    t = pa.table({k: _layout(k, 300, rng) for k in LAYOUTS})
    _spill_roundtrip(t, codec, tier, tmp_path)


def test_flatten_keeps_dtypes():
    rng = np.random.default_rng(3)
    b = _both(pa.table({k: _layout(k, 40, rng) for k in LAYOUTS}))[1]
    leaves, tree = b.flatten()
    assert leaves[-1] is b.num_rows
    kinds = {t.dtype for t in leaves}
    assert {torch.bool, torch.uint8, torch.int32, torch.int64, torch.int8,
            torch.int16, torch.float32, torch.float64} <= kinds
    assert any(t.dim() == 2 and t.dtype == torch.int64 for t in leaves)
    again = type(b).unflatten(tree, leaves)
    for x, y in zip(again.flatten()[0], leaves):
        assert x is y
    assert b.device_memory_size() == sum(
        t.numel() * t.element_size() for t in leaves[:-1])


# ---------------------------------------------------------------------------
# the execs' seams, both engines, same conf, budget and injection index
# ---------------------------------------------------------------------------


def _table(rng, n=600):
    return pa.table({
        "id": pa.array(rng.integers(0, 40, n), type=pa.int64()),
        "val": pa.array(rng.normal(0, 100, n), type=pa.float64()),
        "small": pa.array(rng.integers(-100, 100, n), type=pa.int32()),
        "s": pa.array([["aa", "bb", "cc-long-string", None][j]
                       for j in rng.integers(0, 4, n)]),
    })


def run_both(query, conf=None, budget=None, retry_at=0, split_at=0,
             sort_by=None, jax_budget="same"):
    """`query(session, expr namespace)` collected by both engines on the
    CPU with the same conf, budget (bytes; None: the session's own; the
    JAX engine's may be set apart by `jax_budget`) and injection indexes.
    Returns {engine: (rows, retries, splits, spilled to host)}."""
    conf = dict(BASE, **(conf or {}))
    out = {}
    for name in ("jax", "port"):
        total = budget
        if name == "jax":
            sess, budget_cls, metrics, ns = (
                JaxSession(conf), JaxBudget, JaxMetrics, JE)
            sess.initialize_device()
            if jax_budget != "same":
                total = jax_budget
        else:
            sess, budget_cls, metrics, ns = (
                TpuSession(conf, device="cpu"), MemoryBudget, TaskMetrics,
                PE)
        if total is not None:
            budget_cls.initialize(total, sess.conf)
        budget_cls.get().reset_injection(retry_at, split_at)
        try:
            got = query(sess, ns).collect()
        finally:
            budget_cls.get().reset_injection()
        tm = metrics.get()
        rows = positional(got, ordered=sort_by is None)
        out[name] = (rows, tm.retry_count, tm.split_retry_count,
                     tm.spill_to_host_ns > 0)
    assert out["jax"][0].equals(out["port"][0]), \
        (out["jax"][0].to_pydict(), out["port"][0].to_pydict())
    return out


def _leak_free():
    assert BufferCatalog.get().live_count == 0
    assert MemoryBudget.get().used == 0


class TestExecFaults:
    """tests/test_faults.py's memory-pressure matrix and
    tests/test_scaleout.py's retry integration."""

    def test_sort_survives_retry_oom(self, rng):
        t = _table(rng)
        got = run_both(lambda s, m: s.from_arrow(t).sort("val"), retry_at=1)
        assert got["jax"][1:3] == got["port"][1:3] == (1, 0)
        _leak_free()

    def test_window_survives_retry_oom(self, rng):
        t = _table(rng)
        got = run_both(lambda s, m: s.from_arrow(t).window(
            partition_by=["id"], order_by=["val"], rn=m.RowNumber()),
            retry_at=1)
        assert got["jax"][1:3] == got["port"][1:3] == (1, 0)
        _leak_free()

    def test_aggregate_survives_split_and_retry(self, rng):
        """One batch: the injected split sends it to the merge passes."""
        t = _table(rng)
        got = run_both(lambda s, m: s.from_arrow(t).group_by("id").agg(
            n=m.Count(m.col("val")), total=m.Sum(m.col("small"))),
            split_at=1)
        assert got["jax"][1:3] == got["port"][1:3] == (0, 1)
        _leak_free()

    @pytest.mark.parametrize("retry_at,split_at", [(0, 3), (2, 0)])
    def test_many_batch_aggregate_injected(self, rng, retry_at, split_at):
        """Six batches of 200 rows: the first pass and the pairwise merges
        make the same reserves in both engines, so the Nth is the same
        step."""
        t = _table(rng, 1200)
        got = run_both(lambda s, m: s.from_arrow(t).group_by("id").agg(
            total=m.Sum(m.col("small")), c=m.Count(m.col("val")),
            lo=m.Min(m.col("s"))),
            conf={"spark.rapids.sql.batchSizeRows": 200},
            retry_at=retry_at, split_at=split_at)
        want = (1 if retry_at else 0, 1 if split_at else 0)
        assert got["jax"][1:3] == got["port"][1:3] == want
        _leak_free()

    def test_in_core_sort_degrades_to_out_of_core(self, rng):
        """An injected split on the in-core sort's pre-flight: both engines
        take the out-of-core merge, whose runs split no further."""
        t = _table(rng)
        port_sort.COUNTERS.reset()
        got = run_both(lambda s, m: s.from_arrow(t).sort("id", "val"),
                       split_at=1)
        assert got["jax"][1:3] == got["port"][1:3] == (0, 1)
        assert port_sort.COUNTERS.snapshot()["out_of_core"] == 1
        _leak_free()

    def test_join_probe_survives_retry_oom(self, rng):
        """Injected RetryOOM at the first reserve of a hash join's plan:
        in the port that is the first probe batch's pre-flight, which
        reruns; the JAX join step makes no reserve of its own, so its
        first reserve comes later (the aggregate above) or never, and its
        counts are not compared. The rows are."""
        left, right = _table(rng, 400), _table(rng, 90)

        def query(s, m):
            return s.from_arrow(left).join(
                s.from_arrow(right).select(id=m.col("id"),
                                           r=m.col("small")),
                on="id", how="full")

        got = run_both(query, retry_at=1, sort_by=True,
                       conf={"spark.rapids.sql.autoBroadcastJoinThreshold":
                             -1})
        assert got["port"][1:3] == (1, 0)
        _leak_free()


class TestTightBudget:
    """Budgets below the plan's working set: parked runs, builds, parts
    and chunks spill to the host and come back exact."""

    def test_parking_over_budget_spills_older_runs(self):
        """tests/test_observability.py's case: parking the second run over
        the budget spills the first, quietly."""
        def table():
            n = 2048
            return pa.table({"a": pa.array(np.arange(n, dtype=np.int64)),
                             "b": pa.array(np.arange(n, dtype=np.float64))})

        b = _both(table())[1]
        MemoryBudget.initialize(int(b.device_memory_size() * 1.5))
        first = SpillableColumnarBatch(b)
        del b
        assert not first.spilled
        second = SpillableColumnarBatch(_both(table())[1])
        assert first.spilled and not second.spilled
        assert TaskMetrics.get().spill_to_host_ns > 0
        assert first.get_batch().row_count() == 2048
        first.close()
        second.close()
        assert MemoryBudget.get().used == 0
        assert MemoryBudget.get().peak_used > MemoryBudget.get().total

    def test_out_of_core_sort_spills_runs(self, rng):
        t = _table(rng, 1200)
        port_catalog.COUNTERS.reset()
        port_sort.COUNTERS.reset()
        # a run of 256 rows is 11,264 bytes: the budget holds one and a
        # bit, the five runs spill as the next one parks
        got = run_both(lambda s, m: s.from_arrow(t).sort("val"),
                       conf={"spark.rapids.sql.batchSizeRows": 256},
                       budget=20_000)
        assert got["jax"][1:] == got["port"][1:] == (0, 0, True)
        snap = port_catalog.COUNTERS.snapshot()
        assert snap["to_host"] > 0 and snap["unspills"] > 0
        assert port_sort.COUNTERS.snapshot()["out_of_core"] == 1
        _leak_free()

    # The joins: the JAX engine's shuffled join on one device takes its
    # build through its exchange, parked at a capacity many times the
    # port's build (for a 2,000-row build side of these tables, 5,177,344
    # bytes against the port's 71,680), and fails outright under a budget
    # the port's parts exceed. So the JAX engine runs at its session's
    # budget, the port at the tight one; the rows must be equal.
    JOIN_CONF = {"spark.rapids.sql.autoBroadcastJoinThreshold": -1,
                 "spark.rapids.sql.batchSizeRows": 512}

    @staticmethod
    def _join(how, left, right):
        def query(s, m):
            r = s.from_arrow(right).select(id=m.col("id"), r=m.col("small"),
                                           s2=m.col("s"))
            return s.from_arrow(left).join(r, on="id", how=how)
        return query

    def test_hash_join_build_spills(self, rng):
        """The build (1,000 rows, 35,840 bytes) parked between three probe
        batches of 512 (22,528 bytes): each probe batch parked over the
        budget spills the build, which comes back for the join."""
        port_catalog.COUNTERS.reset()
        got = run_both(self._join("right", _table(rng, 1500),
                                  _table(rng, 1000)),
                       sort_by=True, budget=50_000, jax_budget=None,
                       conf=self.JOIN_CONF)
        assert got["port"][1:] == (0, 0, True)
        snap = port_catalog.COUNTERS.snapshot()
        assert snap["to_host"] > 0 and snap["unspills"] > 0
        _leak_free()

    def test_sub_partition_join_spills_parts(self, rng):
        """The streamed sub-partition join (build over
        join.subPartition.rows): its parked parts spill and come back."""
        port_joins.COUNTERS.reset()
        port_catalog.COUNTERS.reset()
        got = run_both(self._join("full", _table(rng, 1500),
                                  _table(rng, 1000)),
                       sort_by=True, budget=50_000, jax_budget=None,
                       conf=dict(self.JOIN_CONF, **{
                           "spark.rapids.sql.join.subPartition.rows": 256}))
        assert got["port"][1:] == (0, 0, True)
        assert port_joins.COUNTERS.snapshot()["sub_partition_builds"] == 1
        assert port_catalog.COUNTERS.snapshot()["unspills"] > 0
        _leak_free()

    def test_nested_loop_chunks_spill(self, rng, monkeypatch):
        """A cross join in tiles of 64 x 64: the build's chunks are parked
        and spill under a budget of about two chunks."""
        monkeypatch.setattr(port_joins.TpuNestedLoopJoinExec, "TILE_BUDGET",
                            64 * 64)
        monkeypatch.setattr(port_joins.TpuNestedLoopJoinExec,
                            "PROBE_TILE_ROWS", 64)
        left, right = _table(rng, 300), _table(rng, 200)
        port_catalog.COUNTERS.reset()

        def query(s, m):
            return s.from_arrow(left).cross_join(
                s.from_arrow(right).select(r=m.col("small"))) \
                .filter(m.col("small") == m.col("r"))

        got = run_both(query, sort_by=True, budget=1_000, jax_budget=None)
        assert got["port"][1:] == (0, 0, True)
        assert port_catalog.COUNTERS.snapshot()["unspills"] > 0
        _leak_free()


def test_concurrent_park_spill_close_balances(tmp_path):
    """Twelve threads (more than the cores here) park, read back and close
    batches under a budget of four batches and a host store of two, with
    a short switch interval: spills, disk writes and unspills race (how
    many of each depends on the interleaving), every batch read back is
    whole, and the budget, the host store and the catalog must all end at
    zero. A
    reservation that finds no room raises its OOM, which the worker
    retries, as an exec's seam would."""
    import sys
    n_threads, rounds = 12, 8
    b = _batch(64)
    size = b.device_memory_size()
    MemoryBudget.initialize(4 * size)
    cat = BufferCatalog(spill_dir=str(tmp_path), host_limit=2 * size,
                        spill_codec="none")
    BufferCatalog._instance = cat
    want = batch_to_arrow(b)
    errors = []
    port_catalog.COUNTERS.reset()

    def worker():
        try:
            for _ in range(rounds):
                sp = SpillableColumnarBatch(_batch(64))
                while True:
                    try:
                        got = sp.get_batch(acquire_semaphore=False)
                        break
                    except (RetryOOM, SplitAndRetryOOM):
                        time.sleep(0.001)
                assert batch_to_arrow(got).equals(want)
                del got
                sp.close()
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert port_catalog.COUNTERS.snapshot()["to_host"] > 0
    assert MemoryBudget.get().used == 0
    assert cat.host_used == 0 and cat.live_count == 0
    assert os.listdir(tmp_path) == []


def test_refused_conf_keys():
    t = pa.table({"a": pa.array([1, 2], type=pa.int64())})
    for key, value in (("spark.rapids.tpu.sched.enabled", True),
                       ("spark.rapids.tpu.sched.tenant.quotas", "a=0.5"),
                       ("spark.rapids.tpu.mesh.hbmPerChip", "1g")):
        sess = TpuSession(dict(BASE, **{key: value}), device="cpu")
        with pytest.raises(NotImplementedError, match=key.split(".")[-1]):
            sess.from_arrow(t).collect()


def test_device_manager_sizes_the_cpu_budget():
    """On the CPU the total is the JAX package's 16 GiB: 0.9 x 16 GiB -
    640 MiB, the JAX budget on the CPU; a session holds the budget it
    found."""
    sess = TpuSession(dict(BASE), device="cpu")
    assert DeviceManager.device == torch.device("cpu")
    assert DeviceManager.hbm_total == JaxManager.hbm_total == 16 << 30
    assert DeviceManager.budget_bytes == JaxManager.budget_bytes == \
        int((16 << 30) * 0.9) - (640 << 20)
    assert sess.device == torch.device("cpu")
