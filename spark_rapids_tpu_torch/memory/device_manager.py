"""Device manager (`spark_rapids_tpu/memory/device_manager.py`; reference
`GpuDeviceManager.scala`: initializeGpuAndMemory `:128`, pool sizing
`computeRmmPoolSize` `:192`).

Binds the session's device, sizes the budget of columnar data (a fraction
of the device's memory less a reserve, as the RMM pool is sized) and owns
the process singletons: the memory budget, the spill catalog and the
admission semaphore. On a CUDA device the first touch (CUDA init and the
device count) runs under spark.rapids.tpu.device.startupTimeoutSec, and the
total is `torch.cuda.mem_get_info(device)[1]`; on the CPU it is the JAX
package's 16 GiB default, so CPU tests size budgets as the JAX tests do.
PyTorch's caching allocator owns the real memory: the budget is pre-flight
accounting, and a real `torch.cuda.OutOfMemoryError` is not turned into a
retry.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

from ..config import TpuConf, get_default_conf
from ..errors import DeviceStartupError

__all__ = ["DeviceManager"]

_DEFAULT_HBM = 16 << 30  # the JAX package's default when the device won't say


def _backend_touch() -> int:
    """The first CUDA touch: init and the device count."""
    torch.cuda.init()
    return torch.cuda.device_count()


class DeviceManager:
    _lock = threading.Lock()
    _initialized = False
    device: Optional[torch.device] = None
    hbm_total = 0
    budget_bytes = 0
    # a failed or hung first touch, remembered so every later session
    # fails fast instead of arming a fresh deadline against it
    _startup_error: Optional[DeviceStartupError] = None

    @classmethod
    def _first_touch(cls, conf: TpuConf) -> None:
        if cls._startup_error is not None:
            raise cls._startup_error
        timeout = conf.get("spark.rapids.tpu.device.startupTimeoutSec")
        if timeout is None or timeout <= 0:
            _backend_touch()
            return
        result: dict = {}

        def touch():
            try:
                result["count"] = _backend_touch()
            except Exception as exc:  # noqa: BLE001 -- re-raised typed
                result["error"] = exc

        t0 = time.monotonic()
        worker = threading.Thread(target=touch, daemon=True,
                                  name="cuda-first-touch")
        worker.start()
        worker.join(timeout)
        diags = {"elapsed_s": round(time.monotonic() - t0, 2),
                 "timeout_s": timeout}
        if worker.is_alive():
            cls._startup_error = DeviceStartupError(
                f"CUDA did not respond within {timeout:g}s of its first "
                f"touch (init / device count). Diagnostics: {diags}",
                diagnostics=diags)
            raise cls._startup_error
        if "error" in result:
            diags["cause"] = repr(result["error"])
            cls._startup_error = DeviceStartupError(
                f"CUDA failed at its first touch: {result['error']}. "
                f"Diagnostics: {diags}", diagnostics=diags)
            raise cls._startup_error from result["error"]

    @classmethod
    def initialize(cls, conf: Optional[TpuConf] = None,
                   device: Optional[torch.device] = None) -> None:
        """Size the budget for `device` (default cuda:ordinal) and set up
        the singletons; once per process and device."""
        conf = conf or get_default_conf()
        if device is None:
            ordinal = conf.get("spark.rapids.tpu.device.ordinal")
            device = torch.device("cuda", max(ordinal, 0))
        device = torch.device(device)
        with cls._lock:
            if cls._initialized and cls.device == device:
                return
            if device.type == "cuda":
                cls._first_touch(conf)
                total = int(torch.cuda.mem_get_info(device)[1])
            else:
                total = _DEFAULT_HBM
            frac = min(conf.get("spark.rapids.memory.gpu.allocFraction"),
                       conf.get("spark.rapids.memory.gpu.maxAllocFraction"))
            min_frac = conf.get("spark.rapids.memory.gpu.minAllocFraction")
            budget = int(total * frac) - \
                conf.get("spark.rapids.memory.gpu.reserve")
            if budget < int(total * min_frac):
                raise RuntimeError(
                    f"device budget {budget} below minAllocFraction "
                    f"({min_frac} of {total}); adjust "
                    "spark.rapids.memory.gpu.* settings")
            from .budget import MemoryBudget
            from .catalog import BufferCatalog
            from .semaphore import TpuSemaphore
            MemoryBudget.initialize(budget, conf)
            BufferCatalog.initialize(conf)
            TpuSemaphore.initialize(conf.concurrent_tpu_tasks)
            cls.device, cls.hbm_total, cls.budget_bytes = \
                device, total, budget
            cls._initialized = True

    @classmethod
    def shutdown(cls) -> None:
        """Forget the device; handles still in the spill catalog are leaks
        (a SpillableColumnarBatch never closed) and log a warning with the
        catalog's state (GpuDeviceManager.scala:295-305)."""
        from .catalog import BufferCatalog
        cat = BufferCatalog._instance
        leaks = cat.leak_report() if cat is not None else []
        if leaks:
            logging.getLogger("spark_rapids_tpu_torch.memory").warning(
                "device shutdown with %d leaked buffer handle(s) (%d bytes) "
                "-- close() every SpillableColumnarBatch:\n%s", len(leaks),
                sum(e["nbytes"] for e in leaks), cat.debug_dump())
        with cls._lock:
            cls._initialized = False
            cls.device = None
            cls._startup_error = None
