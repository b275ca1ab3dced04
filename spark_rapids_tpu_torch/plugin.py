"""Session (`spark_rapids_tpu/plugin.py`: TpuSession.from_arrow,
read_parquet and execute_plan, without the result cache, statistics, live view, scheduler
or telemetry hooks).

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

    def read_parquet(self, *paths, **options):
        """A DataFrame over parquet files, decoded on the session's device
        (io/parquet_device.py). `columns=[...]` prunes columns."""
        from .frontend import DataFrame
        from .io.parquet import parquet_scan_plan
        return DataFrame(self, parquet_scan_plan(list(paths), self.conf,
                                                 **options))

    def plan_device(self, plan: PhysicalPlan):
        """The device exec tree for a plan (rewrite + fusion)."""
        ov = Overrides(self.conf, self.device)
        root = ov.apply(plan)
        self._last_explain = ov.explain_string()
        if self._last_explain:
            print(self._last_explain)
        return root

    def execute_plan(self, plan: PhysicalPlan):
        """Rewrite a plan, run it on the session device, and return a
        pyarrow Table."""
        from .memory.budget import MemoryBudget
        from .utils.metrics import TaskMetrics
        root = self.plan_device(plan)
        TaskMetrics.reset()  # fresh counters: they describe this collect
        MemoryBudget.get().reset_peak()
        tables = [batch_to_arrow(b) for b in root.execute()]
        return concat_tables(tables, plan.output)

    def explain_plan(self, plan: PhysicalPlan) -> str:
        return self.plan_device(plan).tree_string()
