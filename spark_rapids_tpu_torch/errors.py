"""Framework exception types (the subset of `spark_rapids_tpu/errors.py`
this engine raises, plus the two errors that belong to the CUDA build)."""

from __future__ import annotations


class RapidsTpuError(Exception):
    """Base class for framework errors."""


class DeviceUnavailableError(RapidsTpuError):
    """No device was named and CUDA is absent. Entry points run on the card
    unless the caller asks for the CPU (`device="cpu"`); they never move to
    the CPU on their own."""


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
