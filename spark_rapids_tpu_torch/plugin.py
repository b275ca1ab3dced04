"""Session (`spark_rapids_tpu/plugin.py`: TpuSession.from_arrow, range,
read_parquet and execute_plan, without the result cache, statistics, live view, scheduler
or telemetry hooks).

`execute_plan` runs the rewritten plan: a device root streams its batches
to Arrow; a host root (a tagged root, `spark.rapids.sql.enabled=false`,
`use_device=False`, `spark.rapids.sql.mode=explainOnly`) runs by
`execute_cpu`. A device stream that raises `CpuFallbackRequired` is rerun
whole on the host engine, and the rerun counted
(`TaskMetrics.cpu_fallback_reruns`), as in the JAX session.

The session owns the device. `TpuSession(conf)` runs on `cuda:0` (or
`cuda:<spark.rapids.tpu.device.ordinal>`); with no CUDA it raises instead
of moving to the CPU. Tests and CPU callers ask for the CPU explicitly with
`device="cpu"`. A session initialises the memory layer for its device
(memory/device_manager.py: the budget, the spill catalog, the admission
semaphore), and each collect starts a new peak of the budget and fresh
TaskMetrics on its thread.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from .columnar.batch import batch_to_arrow, concat_tables
from .config import TpuConf
from .errors import DeviceUnavailableError
from .plan.nodes import PhysicalPlan
from .plan.overrides import Overrides

__all__ = ["TpuSession", "resolve_device"]


def resolve_device(device: Union[str, torch.device, None],
                   ordinal: int = 0) -> torch.device:
    """None -> cuda:ordinal (a negative ordinal is 0), raising when CUDA is
    absent; anything else is taken as given (a CUDA device is checked to
    exist)."""
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                "no CUDA device: TpuSession runs on cuda:0 unless the caller "
                "asks for another device (device='cpu')")
        return torch.device("cuda", max(ordinal, 0))
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(f"{device} requested but CUDA is absent")
    return device


class TpuSession:
    def __init__(self, conf: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None):
        from .memory.device_manager import DeviceManager
        self.conf = TpuConf(conf)
        self.device = resolve_device(
            device, self.conf.get("spark.rapids.tpu.device.ordinal"))
        DeviceManager.initialize(self.conf, self.device)
        self._last_explain = ""

    def from_arrow(self, table, label: str = "memory"):
        from .frontend import DataFrame
        from .plan.nodes import CpuScanExec
        return DataFrame(self, CpuScanExec(table, label))

    def range(self, start: int, end: Optional[int] = None, step: int = 1):
        """A DataFrame of the LONG column `id`: range(end) or range(start,
        end[, step])."""
        from .frontend import DataFrame
        from .plan.nodes import CpuRangeExec
        if end is None:
            start, end = 0, start
        return DataFrame(self, CpuRangeExec(start, end, step))

    def read_parquet(self, *paths, **options):
        """A DataFrame over parquet files, decoded on the session's device
        (io/parquet_device.py). `columns=[...]` prunes columns."""
        from .frontend import DataFrame
        from .io.parquet import parquet_scan_plan
        return DataFrame(self, parquet_scan_plan(list(paths), self.conf,
                                                 **options))

    def plan_device(self, plan: PhysicalPlan):
        """The rewritten plan: a device exec tree (with host subtrees
        under TpuFromCpuExec), or a host plan."""
        ov = Overrides(self.conf, self.device)
        root = ov.apply(plan)
        self._last_explain = ov.explain_string()
        if self._last_explain:
            print(self._last_explain)
        return root

    def execute_plan(self, plan: PhysicalPlan,
                     use_device: Optional[bool] = None):
        """Rewrite a plan, run it, and return a pyarrow Table. With
        `use_device=False`, or `spark.rapids.sql.enabled=false`, the whole
        plan runs on the host engine."""
        from .cpu.hostbatch import host_conf, set_host_conf
        from .errors import CpuFallbackRequired
        from .exec.base import TpuExec
        from .memory.budget import MemoryBudget
        from .utils.metrics import TaskMetrics
        enabled = self.conf.is_sql_enabled if use_device is None else \
            use_device
        root = self.plan_device(plan) if enabled else plan
        TaskMetrics.reset()  # fresh counters: they describe this collect
        MemoryBudget.get().reset_peak()
        prev = host_conf()
        set_host_conf(self.conf)
        try:
            if not isinstance(root, TpuExec):
                tables = [batch_to_arrow(b) for b in root.execute_cpu()]
            else:
                try:
                    tables = [batch_to_arrow(b) for b in root.execute()]
                except CpuFallbackRequired:
                    # the device cannot represent this data: rerun the
                    # whole plan on the host (plan sources are idempotent)
                    TaskMetrics.get().cpu_fallback_reruns += 1
                    tables = [batch_to_arrow(b) for b in plan.execute_cpu()]
        finally:
            set_host_conf(prev)
        return concat_tables(tables, plan.output)

    def explain_plan(self, plan: PhysicalPlan) -> str:
        return self.plan_device(plan).tree_string()
