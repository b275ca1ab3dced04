"""Tiered spill catalog (`spark_rapids_tpu/memory/catalog.py`; reference
`RapidsBufferCatalog.scala`: handles `makeNewHandle` `:121`, `addBuffer`
`:210`, `acquireBuffer` `:354`, `synchronousSpill` `:445`; stores
`Rapids{Device,Host,Disk}Store.scala`; priorities `SpillPriorities.scala`;
StorageTier `RapidsBuffer.scala:53`).

Tiers: DEVICE (torch tensors on the card) -> HOST (numpy arrays, or codec
blobs of them) -> DISK (a pickle file a buffer). Spilling copies every
tensor of a batch to the host (`ColumnarBatch.flatten`) and then drops the
catalog's device references: once the parker has dropped its own, the
caching allocator gets the blocks back. The budget is released by the
entry's bytes. Acquiring a spilled entry reads it back up the tiers,
re-reserves its bytes and copies it to the device it came from.

Codecs of the host tier (spark.rapids.memory.spill.compression.codec):
`none`; `zstd` through pyarrow; `lz4xla` through the repository's LZ4
block codec (native/src/lz4block.cpp, built by native.py). Any other name
raises. Host accounting uses the compressed size.

`COUNTERS` counts the spills to host and to disk and the unspills, with
their bytes, since its last reset.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import time
import weakref
from enum import IntEnum
from typing import Dict, List, Optional

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch
from ..exec.base import Counters
from ..utils.metrics import TaskMetrics

__all__ = ["StorageTier", "SpillPriority", "BufferCatalog", "SPILL_CODECS",
           "SpillCounters", "COUNTERS"]

SPILL_CODECS = ("none", "zstd", "lz4xla")


class StorageTier(IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


class SpillPriority:
    ACTIVE_BATCH = 100          # being processed; spill last
    ACTIVE_ON_DECK = 50
    BUFFERED = 0                # shuffle/broadcast buffers
    SPILL_FIRST = -100


class SpillCounters(Counters):
    """Spills since the last reset(): to the host (`to_host`, and the
    device bytes they freed, `to_host_bytes`), on to disk (`to_disk`, the
    host bytes written, `to_disk_bytes`), and reads back to the device
    (`unspills`, `unspill_bytes`)."""

    _FIELDS = ("to_host", "to_host_bytes", "to_disk", "to_disk_bytes",
               "unspills", "unspill_bytes")


COUNTERS = SpillCounters()


def _compress(codec: str, raw: np.ndarray) -> bytes:
    if codec == "zstd":
        import pyarrow as pa
        return pa.compress(raw, codec="zstd", asbytes=True)
    from ..native import lz4_compress
    return lz4_compress(raw)


def _decompress(codec: str, blob: bytes, raw_len: int):
    if codec == "zstd":
        import pyarrow as pa
        return pa.decompress(blob, decompressed_size=raw_len, codec="zstd",
                             asbytes=False)
    from ..native import lz4_decompress
    return lz4_decompress(blob, raw_len)


class _Entry:
    __slots__ = ("handle", "tier", "device_batch", "host_arrays",
                 "host_blobs", "host_bytes", "disk_path", "tree", "device",
                 "num_rows", "nbytes", "priority", "lock", "created_at",
                 "label")

    def __init__(self, handle: int, batch: ColumnarBatch, nbytes: int,
                 priority: int, label: str = ""):
        self.created_at = time.monotonic()
        self.label = label
        self.handle = handle
        self.tier = StorageTier.DEVICE
        self.device_batch: Optional[ColumnarBatch] = batch
        self.host_arrays: Optional[List[np.ndarray]] = None
        self.host_blobs: Optional[List] = None  # compressed representation
        self.host_bytes = 0  # host footprint (compressed when so)
        self.disk_path: Optional[str] = None
        self.tree = None
        self.device = batch.device
        # the device scalar until the entry spills (then a host int): read
        # only where a count is needed, so parking never syncs
        self.num_rows = batch.num_rows
        self.nbytes = nbytes
        self.priority = priority
        self.lock = threading.Lock()

    def rows(self) -> int:
        return int(self.num_rows)


class BufferCatalog:
    _instance: Optional["BufferCatalog"] = None

    def __init__(self, spill_dir: Optional[str] = None,
                 host_limit: int = 1 << 30,
                 spill_codec: Optional[str] = None):
        if spill_codec is None:
            from ..config import get_default_conf
            spill_codec = get_default_conf().get(
                "spark.rapids.memory.spill.compression.codec")
        if spill_codec not in SPILL_CODECS:
            raise ValueError(f"unknown spill codec {spill_codec!r}; one of "
                             f"{SPILL_CODECS}")
        self._entries: Dict[int, _Entry] = {}
        self._next_handle = 0
        self._lock = threading.Lock()
        self._spill_dir = spill_dir
        self.host_limit = host_limit
        self.spill_codec = spill_codec
        self.host_used = 0

    @classmethod
    def initialize(cls, conf) -> None:
        """The process catalog for `conf`'s host limit and codec."""
        cls._instance = BufferCatalog(
            host_limit=conf.get("spark.rapids.memory.host.spillStorageSize"),
            spill_codec=conf.get(
                "spark.rapids.memory.spill.compression.codec"))

    @classmethod
    def get(cls) -> "BufferCatalog":
        if cls._instance is None:
            from ..config import get_default_conf
            cls.initialize(get_default_conf())
        return cls._instance

    def _host_add(self, nbytes: int) -> None:
        with self._lock:
            self.host_used += nbytes

    # ------------------------------------------------------------------
    def add_batch(self, batch: ColumnarBatch,
                  priority: int = SpillPriority.BUFFERED,
                  label: str = "") -> int:
        nbytes = batch.device_memory_size()
        with self._lock:
            h = self._next_handle
            self._next_handle += 1
            self._entries[h] = _Entry(h, batch, nbytes, priority, label)
        return h

    def acquire_batch(self, handle: int) -> ColumnarBatch:
        """The batch on its device, read back up the tiers if it spilled."""
        e = self._entries[handle]
        with e.lock:
            if e.tier == StorageTier.DEVICE:
                return e.device_batch
            t0 = time.monotonic_ns()
            if e.tier == StorageTier.DISK:
                self._disk_to_host(e)
            batch = self._host_to_device(e)
            TaskMetrics.get().read_spill_ns += time.monotonic_ns() - t0
            COUNTERS.add(unspills=1, unspill_bytes=e.nbytes)
            e.device_batch = batch
            e.num_rows = batch.num_rows
            e.host_arrays = None
            e.host_blobs = None
            self._host_add(-e.host_bytes)
            e.host_bytes = 0
            e.tier = StorageTier.DEVICE
            return batch

    def remove(self, handle: int) -> Optional[StorageTier]:
        """Drop an entry; returns the tier it was in (None if it was gone
        already). A spill racing the removal finds it gone and frees
        nothing."""
        with self._lock:
            e = self._entries.pop(handle, None)
        if e is None:
            return None
        with e.lock:
            tier, e.tier = e.tier, None
            if e.disk_path and os.path.exists(e.disk_path):
                os.unlink(e.disk_path)
            if tier == StorageTier.HOST:
                self._host_add(-e.host_bytes)
            e.device_batch = e.host_arrays = e.host_blobs = None
        return tier

    def tier_of(self, handle: int) -> StorageTier:
        return self._entries[handle].tier

    def rows_of(self, handle: int) -> int:
        """The entry's row count (a host sync while it is on the device)."""
        return self._entries[handle].rows()

    # ---------------------------------------------------- observability
    def debug_dump(self) -> str:
        """One line per live handle with tier, size, rows, age and
        priority (the RMM state-dump analog)."""
        now = time.monotonic()
        with self._lock:
            entries = list(self._entries.values())
        lines = [f"BufferCatalog: {len(entries)} live handles, "
                 f"host_used={self.host_used}/{self.host_limit}B"]
        per_tier: Dict[StorageTier, int] = {}
        for e in sorted(entries, key=lambda e: -e.nbytes):
            per_tier[e.tier] = per_tier.get(e.tier, 0) + e.nbytes
            lines.append(
                f"  handle={e.handle} tier={e.tier.name} bytes={e.nbytes} "
                f"rows={e.rows()} age={now - e.created_at:.1f}s "
                f"prio={e.priority}"
                + (f" label={e.label}" if e.label else ""))
        for t, b in sorted(per_tier.items()):
            lines.append(f"  total[{t.name}]={b}B")
        return "\n".join(lines)

    def leak_report(self, older_than_s: float = 0.0) -> List[dict]:
        """Handles alive for `older_than_s` or longer: at the end of a
        query, a SpillableColumnarBatch that was never closed."""
        now = time.monotonic()
        with self._lock:
            return [{"handle": e.handle, "tier": e.tier.name,
                     "nbytes": e.nbytes, "age_s": now - e.created_at,
                     "label": e.label}
                    for e in self._entries.values()
                    if now - e.created_at >= older_than_s]

    @property
    def live_count(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    def synchronous_spill(self, need_bytes: int) -> int:
        """Spill device entries, lowest priority (then oldest) first, until
        `need_bytes` are freed or none is left; returns the bytes freed
        (the DeviceMemoryEventHandler loop analog)."""
        with self._lock:
            entries = list(self._entries.values())
        candidates = sorted([e for e in entries
                             if e.tier == StorageTier.DEVICE],
                            key=lambda e: e.priority)
        freed = 0
        for e in candidates:
            if freed >= need_bytes:
                break
            freed += self._spill_entry(e)
        return freed

    def _spill_entry(self, e: _Entry) -> int:
        from .budget import MemoryBudget
        with e.lock:
            if e.tier != StorageTier.DEVICE:
                return 0
            t0 = time.monotonic_ns()
            leaves, e.tree = e.device_batch.flatten()
            host = [t.to("cpu", copy=True).numpy() for t in leaves]
            del leaves
            e.num_rows = int(host[-1])
            if self.spill_codec != "none":
                e.host_blobs = []
                for a in host:
                    raw = np.ascontiguousarray(a)
                    e.host_blobs.append((a.dtype.str, a.shape, _compress(
                        self.spill_codec, raw.reshape(-1).view(np.uint8)),
                        a.nbytes))
                e.host_bytes = sum(len(b[2]) for b in e.host_blobs)
            else:
                e.host_arrays = host
                e.host_bytes = e.nbytes
            del host
            e.device_batch = None  # the catalog's device references go
            e.tier = StorageTier.HOST
            self._host_add(e.host_bytes)
            TaskMetrics.get().spill_to_host_ns += time.monotonic_ns() - t0
            COUNTERS.add(to_host=1, to_host_bytes=e.nbytes)
            MemoryBudget.get().release(e.nbytes)
            if self.host_used > self.host_limit:
                try:
                    self._host_to_disk(e)
                except OSError:
                    # the disk tier failed: the buffer is intact at HOST;
                    # run over the soft host limit rather than fail the
                    # spill that frees device memory for another reserve
                    pass
            return e.nbytes

    def _spill_path(self, handle: int) -> str:
        with self._lock:
            if self._spill_dir is None:
                self._spill_dir = tempfile.mkdtemp(prefix="srtpu_spill_")
                weakref.finalize(self, shutil.rmtree, self._spill_dir,
                                 ignore_errors=True)
        return os.path.join(self._spill_dir, f"buf{handle}.spill")

    def _host_to_disk(self, e: _Entry) -> None:
        t0 = time.monotonic_ns()
        path = self._spill_path(e.handle)
        payload = ("blobs", e.host_blobs) if e.host_blobs is not None \
            else ("arrays", e.host_arrays)
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        e.disk_path = path
        e.host_arrays = None
        e.host_blobs = None
        e.tier = StorageTier.DISK
        self._host_add(-e.host_bytes)
        TaskMetrics.get().spill_to_disk_ns += time.monotonic_ns() - t0
        COUNTERS.add(to_disk=1, to_disk_bytes=e.host_bytes)

    @staticmethod
    def _read_spill(path: str):
        with open(path, "rb") as f:
            return pickle.load(f)

    def _disk_to_host(self, e: _Entry) -> None:
        try:
            kind, payload = self._read_spill(e.disk_path)
        except OSError:
            # one retry of a transient read error; the file is the only
            # copy, so a second failure raises
            kind, payload = self._read_spill(e.disk_path)
        if kind == "blobs":
            e.host_blobs = payload
        else:
            e.host_arrays = payload
        e.tier = StorageTier.HOST
        self._host_add(e.host_bytes)
        os.unlink(e.disk_path)
        e.disk_path = None

    def _host_leaves(self, e: _Entry) -> List[np.ndarray]:
        if e.host_arrays is not None:
            return e.host_arrays
        out = []
        for dt, shape, blob, raw_len in e.host_blobs:
            raw = _decompress(self.spill_codec, blob, raw_len)
            raw = raw.view(np.dtype(dt)) if isinstance(raw, np.ndarray) \
                else np.frombuffer(raw, dtype=np.dtype(dt))
            out.append(raw.reshape(shape))
        return out

    def _host_to_device(self, e: _Entry) -> ColumnarBatch:
        from .budget import MemoryBudget
        MemoryBudget.get().reserve(e.nbytes)
        leaves = []
        for a in self._host_leaves(e):
            if not a.flags.writeable:  # a decompressed, read-only buffer
                a = a.copy()
            leaves.append(torch.from_numpy(a).to(e.device))
        return ColumnarBatch.unflatten(e.tree, leaves)
