"""Task-level accumulators (`spark_rapids_tpu/utils/metrics.py`
`TaskMetrics`, reference GpuTaskMetrics), with only the fields the memory
layer and the prefetch write: spill and read-spill time, admission wait,
OOM retries and their backoffs, and the prefetch counts.

One instance per thread (`TaskMetrics.get()`); a prefetch producer adopts
its consumer's instance, so its counts land in the consumer's task.
"""

from __future__ import annotations

import threading

__all__ = ["TaskMetrics"]


class TaskMetrics:
    _tls = threading.local()

    def __init__(self):
        self.semaphore_wait_ns = 0
        self.retry_count = 0
        self.split_retry_count = 0
        self.retry_block_ns = 0
        # per-attempt OOM-retry backoff (ms), in attempt order
        self.retry_backoff_ms: list = []
        self.spill_to_host_ns = 0
        self.spill_to_disk_ns = 0
        self.read_spill_ns = 0
        # prefetch threads spawned for this task, batches they parked, and
        # the consumer's wall ns stalled on an empty prefetch queue
        self.prefetch_threads = 0
        self.prefetch_batches = 0
        self.prefetch_stall_ns = 0

    @classmethod
    def get(cls) -> "TaskMetrics":
        tm = getattr(cls._tls, "metrics", None)
        if tm is None:
            tm = TaskMetrics()
            cls._tls.metrics = tm
        return tm

    @classmethod
    def reset(cls) -> None:
        cls._tls.metrics = TaskMetrics()

    @classmethod
    def adopt(cls, tm: "TaskMetrics") -> None:
        """Make `tm` this thread's instance (a prefetch producer)."""
        cls._tls.metrics = tm
