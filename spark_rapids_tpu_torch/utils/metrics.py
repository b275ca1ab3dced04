"""Task-level accumulators (`spark_rapids_tpu/utils/metrics.py`
`TaskMetrics`, reference GpuTaskMetrics), with only the fields the memory
layer, the prefetch and the host engine write: spill and read-spill time,
admission wait, OOM retries and their backoffs, the prefetch counts, the
host plan nodes run, the rows, bytes and seconds moved each way by the
host <-> device transitions (exec/transitions.py), the stage reruns on
the host after `CpuFallbackRequired`, and the scan pushdown's counts.

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
        # host plan nodes run (cpu/hostbatch.run_host), and the host ->
        # device and device -> host transitions: rows, buffer bytes, the
        # host ns of the call (to the device: pinning and enqueueing the
        # copies; to the host: waiting for the stream and copying), and on
        # a card the CUDA event pairs around the copies on its stream
        self.host_nodes_run = 0
        self.to_device_rows = 0
        self.to_device_bytes = 0
        self.to_device_ns = 0
        self.to_device_copies: list = []
        self.to_host_rows = 0
        self.to_host_bytes = 0
        self.to_host_ns = 0
        self.to_host_copies: list = []
        # plans rerun on the host after CpuFallbackRequired (plugin.py)
        self.cpu_fallback_reruns = 0
        # scan pushdown (io/scanbase.py): rows the pushed predicate
        # dropped, row-data bytes the decode materialised, row groups the
        # footer statistics pruned
        self.scan_rows_pruned = 0
        self.scan_bytes_materialized = 0
        self.scan_rowgroups_pruned = 0

    def copy_seconds(self) -> tuple:
        """(to device, to host): the seconds the card's stream spent on
        the transitions' copies, from their event pairs; waits for the
        last copy of each."""
        def total(pairs):
            if pairs:
                pairs[-1][1].synchronize()
            return sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        return total(self.to_device_copies), total(self.to_host_copies)

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
