"""Framework exception types (the subset of `spark_rapids_tpu/errors.py`
this engine raises, plus the two errors that belong to the CUDA build).

RetryOOM / SplitAndRetryOOM are the reference's per-thread retry exceptions
(`RmmRapidsRetryIterator.scala:28-120` handles them); here the memory
budget's pre-flight accounting raises them (memory/budget.py), never the
allocator: a real `torch.cuda.OutOfMemoryError` is not turned into a
retry."""

from __future__ import annotations


class RapidsTpuError(Exception):
    """Base class for framework errors."""


class DeviceUnavailableError(RapidsTpuError):
    """No device was named and CUDA is absent. Entry points run on the card
    unless the caller asks for the CPU (`device="cpu"`); they never move to
    the CPU on their own."""


class CpuFallbackRequired(RapidsTpuError):
    """A batch or operator cannot run on the device: the session reruns the
    plan on the host engine (`execute_cpu`) and counts the rerun in
    `TaskMetrics.cpu_fallback_reruns`."""


class RetryOOM(RapidsTpuError):
    """Device memory pressure: block, spill, and retry the idempotent step."""


class SplitAndRetryOOM(RapidsTpuError):
    """Device memory pressure too high for retry alone: split the input and
    retry."""


class DeviceStartupError(RapidsTpuError):
    """The device failed or hung at its first touch (CUDA init and the
    device count) within `spark.rapids.tpu.device.startupTimeoutSec`.
    Fatal for device execution; raised with diagnostics instead of
    blocking the query."""

    def __init__(self, message: str, diagnostics: dict | None = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}


class KernelBuildError(RapidsTpuError):
    """A hand-written CUDA kernel failed to compile or load."""


class KernelLaunchError(RapidsTpuError):
    """A CUDA kernel launch returned an error code (`cudaGetLastError`)."""


class AnsiViolation(RapidsTpuError):
    """Spark ANSI-mode runtime error (an ArithmeticException): integral
    overflow, division by zero or cast overflow under
    spark.sql.ansi.enabled. `message` is Spark's error class and text."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message
