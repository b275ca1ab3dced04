"""SpillableColumnarBatch (`spark_rapids_tpu/memory/spillable.py`;
reference `SpillableColumnarBatch.scala:28,64,110`): a batch parked in the
spill catalog, so it can spill while it is not in use; materialising it
takes the admission semaphore unless the caller says otherwise.

Parking never syncs: the row count stays a device scalar until something
asks for `num_rows` (the split of `with_retry`, the catalog's dump). The
JAX class reads it when it parks, which here would stall a prefetch
producer once a batch.

On the host engine (`cpu.hostbatch.on_host`) a spillable batch only
holds its batch: no catalog entry, no budget charge, no permit, as the JAX
CPU nodes park nothing.
"""

from __future__ import annotations

from typing import Optional

from ..columnar.batch import ColumnarBatch
from .budget import MemoryBudget
from .catalog import BufferCatalog, SpillPriority, StorageTier
from .semaphore import TpuSemaphore

__all__ = ["SpillableColumnarBatch"]


class SpillableColumnarBatch:
    def __init__(self, batch: ColumnarBatch,
                 priority: int = SpillPriority.ACTIVE_ON_DECK):
        from ..cpu.hostbatch import on_host
        self.size_bytes = batch.device_memory_size()
        self._num_rows: Optional[int] = None
        # a host exec's batch stays where it is, outside the memory layer
        self._held: Optional[ColumnarBatch] = batch if on_host() else None
        if self._held is not None:
            self._handle: Optional[int] = -1
            return
        self._catalog = BufferCatalog.get()
        self._handle = self._catalog.add_batch(batch, priority)
        # parked device bytes count against the budget: under a tight one,
        # parking the Nth run or build spills older parked buffers to host
        MemoryBudget.get().note_parked(self.size_bytes)

    @property
    def num_rows(self) -> int:
        """The live row count (a host sync the first time, while the batch
        is on the device)."""
        if self._num_rows is None:
            if self._handle is None:
                raise ValueError("spillable batch already closed")
            self._num_rows = self._held.row_count() if self._held \
                is not None else self._catalog.rows_of(self._handle)
        return self._num_rows

    def get_batch(self, acquire_semaphore: bool = True) -> ColumnarBatch:
        """The batch on the device. `acquire_semaphore=False` is for the
        prefetch consumer: a prefetched batch is the task's own in-flight
        stream, so taking it back must not take an admission permit."""
        if self._handle is None:
            raise ValueError("spillable batch already closed")
        if self._held is not None:
            return self._held
        if acquire_semaphore:
            TpuSemaphore.get().acquire_if_necessary()
        return self._catalog.acquire_batch(self._handle)

    @property
    def spilled(self) -> bool:
        return self._handle is not None and self._held is None and \
            self._catalog.tier_of(self._handle) != StorageTier.DEVICE

    def close(self) -> None:
        """Drop the batch from the catalog; idempotent."""
        if self._handle is None:
            return
        if self._held is not None:
            self._held = self._handle = None
            return
        if self._catalog.remove(self._handle) == StorageTier.DEVICE:
            # device-resident: undo the park-time charge (a spilled entry
            # released it; an unspilled one re-reserved it)
            MemoryBudget.get().release(self.size_bytes)
        self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
