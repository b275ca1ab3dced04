"""Build and load the hand-written CUDA kernels in `csrc/`.

Each source compiles with `nvcc -shared` into its own shared library with a
plain C interface, loaded through ctypes; no PyTorch headers are involved,
so a build takes seconds. Builds happen at first use (or all at once through
`build()`), into `_build/` beside this package, named by a hash of the
source and the flags, so an edited source never loads a stale library.
`build()` starts one nvcc per source at the same time.

Nothing here runs at import: the CPU tests import every module on a machine
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

from ..errors import KernelBuildError

__all__ = ["SOURCES", "build", "load", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("murmur3_rows", "segment_sum_f64", "segment_sum_i64")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, one nvcc
    process per source, all started together. Returns each compiled
    source's compiler output (register and shared-memory use per kernel);
    raises KernelBuildError if any compile fails."""
    started = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, errors = {}, []
    for name, out, tmp, proc in started:
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            # kept for a later reader of -Xptxas -v (registers, spills)
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            try:
                lib = ctypes.CDLL(str(library_path(name)))
            except OSError as e:
                raise KernelBuildError(f"cannot load {name}: {e}") from e
            _libs[name] = lib
        return lib
