"""Device memory budget (`spark_rapids_tpu/memory/budget.py`; reference:
the RMM alloc-failure callback -> `DeviceMemoryEventHandler.scala:38` spill
loop, per-thread `RetryOOM`/`SplitAndRetryOOM` from RmmSpark).

PyTorch's caching allocator owns the real memory, so instead of a failure
callback the budget does pre-flight accounting, as in the JAX package:
operators `reserve()` their estimated working set before their kernels;
when the budget would be exceeded it first asks the spill catalog to free
device buffers, then raises RetryOOM / SplitAndRetryOOM for the
`with_retry` loop (memory/retry.py). A real `torch.cuda.OutOfMemoryError`
is never turned into a retry. The injection counters implement
spark.rapids.sql.test.injectRetryOOM / injectSplitAndRetryOOM (reference
RapidsConf.scala:1250).

The JAX budget's per-tenant quotas and per-chip ledgers belong to modules
that are not ported (sched/, mesh/); their conf keys raise at plan time.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Optional

from ..config import TpuConf, get_default_conf
from ..cpu.hostbatch import on_host
from ..errors import RetryOOM, SplitAndRetryOOM

__all__ = ["MemoryBudget"]


class MemoryBudget:
    _instance: Optional["MemoryBudget"] = None

    def __init__(self, total: int, conf: TpuConf):
        self.total = total
        self.used = 0
        # high-water mark of `used` since init/reset_peak
        self.peak_used = 0
        self.conf = conf
        self._lock = threading.Lock()
        self._alloc_count = 0
        self.inject_retry_at = conf.get("spark.rapids.sql.test.injectRetryOOM")
        self.inject_split_at = conf.get(
            "spark.rapids.sql.test.injectSplitAndRetryOOM")

    @classmethod
    def initialize(cls, total: int, conf: Optional[TpuConf] = None) -> None:
        cls._instance = MemoryBudget(total, conf or get_default_conf())

    @classmethod
    def get(cls) -> "MemoryBudget":
        if cls._instance is None:
            cls.initialize(1 << 62)
        return cls._instance

    def _try_charge_locked(self, nbytes: int) -> bool:
        if self.used + nbytes > self.total:
            return False
        self.used += nbytes
        self.peak_used = max(self.peak_used, self.used)
        return True

    def reserve(self, nbytes: int) -> None:
        """Pre-flight reservation; raises RetryOOM / SplitAndRetryOOM under
        pressure, after a synchronous spill. A host exec's call
        (`cpu.hostbatch.on_host`) reserves nothing and counts toward no
        injection."""
        if on_host():
            return
        with self._lock:
            self._alloc_count += 1
            n = self._alloc_count
            if self.inject_retry_at and n == self.inject_retry_at:
                raise RetryOOM("injected RetryOOM")
            if self.inject_split_at and n == self.inject_split_at:
                raise SplitAndRetryOOM("injected SplitAndRetryOOM")
            if self._try_charge_locked(nbytes):
                return
        from .catalog import BufferCatalog
        freed = BufferCatalog.get().synchronous_spill(nbytes)
        with self._lock:
            if self._try_charge_locked(nbytes):
                return
            if freed > 0:
                raise RetryOOM(
                    f"device memory pressure: need {nbytes}, "
                    f"used {self.used}/{self.total} (spilled {freed})")
            used = self.used
        # terminal: dump outside the lock (file IO must not stall
        # concurrent reserve/release), then raise
        self._maybe_oom_dump(nbytes)
        raise SplitAndRetryOOM(
            f"device memory exhausted: need {nbytes}, "
            f"used {used}/{self.total}, nothing left to spill")

    def _maybe_oom_dump(self, need: int) -> None:
        """Write the budget and the catalog's state to
        spark.rapids.memory.gpu.oomDumpDir on a terminal OOM (the reference
        dumps RMM state the same way); best effort, the OOM still raises."""
        try:
            d = self.conf.get("spark.rapids.memory.gpu.oomDumpDir")
            if not d:
                return
            from .catalog import BufferCatalog
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"oom_dump_{time.strftime('%Y%m%dT%H%M%S')}_"
                   f"{os.getpid()}_{uuid.uuid4().hex[:6]}.txt")
            with open(path, "w") as f:
                f.write(f"MemoryBudget: need={need} used={self.used} "
                        f"total={self.total}\n")
                f.write(BufferCatalog.get().debug_dump() + "\n")
        except Exception:  # noqa: BLE001 -- the dump must not mask the OOM
            pass

    def release(self, nbytes: int) -> None:
        if on_host():  # the host engine reserved nothing
            return
        with self._lock:
            self.used = max(0, self.used - nbytes)

    def note_parked(self, nbytes: int) -> None:
        """Account a parked spillable batch's device bytes. Unlike
        `reserve()` this never raises and never counts toward the
        injection schedule: parking over the budget spills the overage
        (the oldest, lowest-priority parked buffers go to host), the
        reference's bounded device residency for pending sort runs and
        join builds. The owner releases on close while the entry is on the
        device; the catalog's spill and unspill keep it balanced between."""
        with self._lock:
            self.used += nbytes
            self.peak_used = max(self.peak_used, self.used)
            over = self.used - self.total
        if over > 0:
            from .catalog import BufferCatalog
            BufferCatalog.get().synchronous_spill(over)

    def reset_peak(self) -> None:
        with self._lock:
            self.peak_used = self.used

    def reset_injection(self, retry_at: int = 0, split_at: int = 0) -> None:
        with self._lock:
            self._alloc_count = 0
            self.inject_retry_at = retry_at
            self.inject_split_at = split_at
