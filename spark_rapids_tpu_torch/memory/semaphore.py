"""Admission semaphore (`spark_rapids_tpu/memory/semaphore.py`; reference
`GpuSemaphore.scala`: acquireIfNecessary `:67,125`, completeTask `:173`).

Limits how many tasks may hold live device batches at once
(spark.rapids.sql.concurrentGpuTasks). A thread takes its permit at its
first `acquire_if_necessary` (materialising a spillable batch) and keeps
it, reentrantly, until `complete_task`. A prefetch producer works for its
consumer's task: it adopts that task's hold (`adopt_task_hold`) instead of
taking a permit of its own, which with one permit would deadlock. The
JAX package's scheduler door (spark.rapids.tpu.sched.enabled) is not
ported; its conf key raises at plan time.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..utils.metrics import TaskMetrics

__all__ = ["TpuSemaphore"]


class TpuSemaphore:
    _instance: Optional["TpuSemaphore"] = None

    def __init__(self, permits: int):
        self.permits = permits
        self._sem = threading.BoundedSemaphore(permits)
        self._held = threading.local()

    @classmethod
    def initialize(cls, permits: int) -> None:
        cur = cls._instance
        if cur is None or cur.permits != permits:
            cls._instance = TpuSemaphore(permits)

    @classmethod
    def get(cls) -> "TpuSemaphore":
        if cls._instance is None:
            cls.initialize(2)
        return cls._instance

    def acquire_if_necessary(self) -> None:
        if getattr(self._held, "count", 0) > 0:
            self._held.count += 1
            return
        t0 = time.monotonic_ns()
        self._sem.acquire()
        TaskMetrics.get().semaphore_wait_ns += time.monotonic_ns() - t0
        self._held.count = 1
        self._held.borrowed = False

    def adopt_task_hold(self) -> None:
        """Mark the current thread as sharing its task's admission (a
        prefetch producer): acquires nothing; `release_if_held` and
        `complete_task` here unwind the count without releasing the task's
        permit."""
        if getattr(self._held, "count", 0) == 0:
            self._held.count = 1
            self._held.borrowed = True

    def release_if_held(self) -> None:
        count = getattr(self._held, "count", 0)
        if count > 1:
            self._held.count -= 1
        elif count == 1:
            self._held.count = 0
            if not getattr(self._held, "borrowed", False):
                self._sem.release()
            self._held.borrowed = False

    def complete_task(self) -> None:
        while getattr(self._held, "count", 0) > 0:
            self.release_if_held()
