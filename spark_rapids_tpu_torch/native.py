"""ctypes loader for the host C++ of the parquet decode and the spill codec
(`spark_rapids_tpu/native/runtime.py`, the parts the port calls).

The port builds `native/src/chunk_walk.cpp` (the page walk: Thrift page
headers, snappy, the RLE/bit-packed run scans, the PLAIN concatenation),
`native/src/strings_repack.cpp` (the BYTE_ARRAY offset scan) and
`native/src/lz4block.cpp` (the LZ4 block codec of the `lz4xla` spill codec)
from the repository's own sources, with `g++ -O3 -fPIC -std=c++17 -shared`
(the flags of `native/Makefile`), at first use, into `_build/` beside this
package. The library is named by a hash of the sources and the flags, so an
edited source never loads a stale build.

Unlike the JAX loader, nothing here degrades: a failed build raises
NativeBuildError, and the scan always takes the native walk. The Python
walkers in `io/parquet_device.py` are the plain twins that the tests hold
the native walk against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .errors import RapidsTpuError

__all__ = ["NativeBuildError", "library_path", "load", "chunk_walk",
           "rle_scan", "byte_array_scan", "lz4_compress", "lz4_decompress"]

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG.parent / "native" / "src"
BUILD_DIR = _PKG / "_build"
SOURCES = ("chunk_walk.cpp", "strings_repack.cpp", "lz4block.cpp")
_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeBuildError(RapidsTpuError):
    """The host C++ of the parquet decode failed to compile or load."""


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsrtpu-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeBuildError("g++ not found: the parquet page walk is built "
                               "from native/src at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *_FLAGS, "-o", str(tmp), *[str(SRC_DIR / s) for s in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} failed (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none


class _SrtpuChunk(ctypes.Structure):
    _fields_ = [
        ("num_pages", ctypes.c_int64),
        ("page_kind", ctypes.POINTER(ctypes.c_uint8)),
        ("page_bw", ctypes.POINTER(ctypes.c_int32)),
        ("page_num_values", ctypes.POINTER(ctypes.c_int64)),
        ("page_ndef", ctypes.POINTER(ctypes.c_int64)),
        ("page_plain_off", ctypes.POINTER(ctypes.c_int64)),
        ("page_idx_run_off", ctypes.POINTER(ctypes.c_int64)),
        ("page_idx_packed_off", ctypes.POINTER(ctypes.c_int64)),
        ("def_nruns", ctypes.c_int64),
        ("def_kinds", ctypes.POINTER(ctypes.c_uint8)),
        ("def_counts", ctypes.POINTER(ctypes.c_int64)),
        ("def_values", ctypes.POINTER(ctypes.c_uint32)),
        ("def_bitoffs", ctypes.POINTER(ctypes.c_int64)),
        ("def_packed", ctypes.POINTER(ctypes.c_uint8)),
        ("def_packed_len", ctypes.c_int64),
        ("idx_nruns", ctypes.c_int64),
        ("idx_kinds", ctypes.POINTER(ctypes.c_uint8)),
        ("idx_counts", ctypes.POINTER(ctypes.c_int64)),
        ("idx_values", ctypes.POINTER(ctypes.c_uint32)),
        ("idx_bitoffs", ctypes.POINTER(ctypes.c_int64)),
        ("idx_packed", ctypes.POINTER(ctypes.c_uint8)),
        ("idx_packed_len", ctypes.c_int64),
        ("plain", ctypes.POINTER(ctypes.c_uint8)),
        ("plain_len", ctypes.c_int64),
        ("dict_raw", ctypes.POINTER(ctypes.c_uint8)),
        ("dict_len", ctypes.c_int64),
        ("dict_count", ctypes.c_int64),
        ("total_values", ctypes.c_int64),
    ]


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.srtpu_byte_array_scan.restype = ctypes.c_int64
    lib.srtpu_byte_array_scan.argtypes = [u8p, ctypes.c_int64,
                                          ctypes.c_int64, i64p, i32p]
    lib.srtpu_rle_scan.restype = ctypes.c_int64
    lib.srtpu_rle_scan.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int32, u8p, i64p, u32p, i64p,
                                   u8p, i64p]
    lib.srtpu_chunk_walk.restype = ctypes.POINTER(_SrtpuChunk)
    lib.srtpu_chunk_walk.argtypes = [u8p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32, i32p]
    lib.srtpu_chunk_free.restype = None
    lib.srtpu_chunk_free.argtypes = [ctypes.POINTER(_SrtpuChunk)]
    lib.srtpu_lz4_compress_bound.restype = ctypes.c_int64
    lib.srtpu_lz4_compress_bound.argtypes = [ctypes.c_int64]
    lib.srtpu_lz4_compress.restype = ctypes.c_int64
    lib.srtpu_lz4_compress.argtypes = [u8p, ctypes.c_int64, u8p,
                                       ctypes.c_int64]
    lib.srtpu_lz4_decompress.restype = ctypes.c_int64
    lib.srtpu_lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int64]


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            try:
                lib = ctypes.CDLL(str(out))
            except OSError as e:
                raise NativeBuildError(f"cannot load {out}: {e}") from e
            _bind(lib)
            _lib = lib
        return _lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def byte_array_scan(blob: np.ndarray, n: int) -> tuple:
    """PLAIN BYTE_ARRAY stream -> (starts int64[n], lens int32[n], max_len):
    the serial (u32 len, bytes)* prefix walk. Raises ValueError on a
    truncated stream."""
    blob = np.ascontiguousarray(blob, np.uint8)
    starts = np.empty(n, np.int64)
    lens = np.empty(n, np.int32)
    mx = load().srtpu_byte_array_scan(_u8(blob), blob.shape[0], n,
                                      _ptr(starts, ctypes.c_int64),
                                      _ptr(lens, ctypes.c_int32))
    if mx < 0:
        raise ValueError("truncated BYTE_ARRAY stream")
    return starts, lens, int(mx)


def lz4_compress(raw: bytes) -> bytes:
    """One LZ4 block of `raw` (native/src/lz4block.cpp)."""
    lib = load()
    src = np.frombuffer(raw, np.uint8)
    n = src.shape[0]
    dst = np.empty(lib.srtpu_lz4_compress_bound(n), np.uint8)
    got = lib.srtpu_lz4_compress(_u8(src), n, _u8(dst), dst.shape[0])
    if got < 0:
        raise ValueError("LZ4 output exceeded its bound")
    return dst[:got].tobytes()


def lz4_decompress(blob: bytes, raw_len: int) -> np.ndarray:
    """The `raw_len` bytes of one LZ4 block, as a writable uint8 array;
    ValueError if the block is malformed."""
    src = np.frombuffer(blob, np.uint8)
    dst = np.empty(raw_len, np.uint8)
    got = load().srtpu_lz4_decompress(_u8(src), src.shape[0], _u8(dst),
                                      raw_len)
    if got != raw_len:
        raise ValueError("malformed LZ4 block")
    return dst


def rle_scan(payload: np.ndarray, num_values: int, bit_width: int) -> tuple:
    """RLE/bit-packed hybrid stream -> run table (kinds u8[R], counts
    i64[R], values u32[R], bitoffs i64[R], packed u8[>=1]). Raises
    ValueError on a truncated stream. The output arrays are sized for the
    worst case, one run per 2 stream bytes."""
    payload = np.ascontiguousarray(payload, np.uint8)
    n = payload.shape[0]
    cap = n // 2 + 2
    kinds = np.empty(cap, np.uint8)
    counts = np.empty(cap, np.int64)
    values = np.empty(cap, np.uint32)
    bitoffs = np.empty(cap, np.int64)
    packed = np.empty(max(n, 1), np.uint8)
    plen = ctypes.c_int64(0)
    nruns = load().srtpu_rle_scan(
        _u8(payload), n, num_values, bit_width, _u8(kinds),
        _ptr(counts, ctypes.c_int64), _ptr(values, ctypes.c_uint32),
        _ptr(bitoffs, ctypes.c_int64), _u8(packed), ctypes.byref(plen))
    if nruns < 0:
        raise ValueError("truncated RLE stream")
    return (kinds[:nruns].copy(), counts[:nruns].copy(),
            values[:nruns].copy(), bitoffs[:nruns].copy(),
            packed[:max(plen.value, 1)].copy())


_CTYPE_NP = {ctypes.c_uint8: np.uint8, ctypes.c_int32: np.int32,
             ctypes.c_int64: np.int64, ctypes.c_uint32: np.uint32}


def _copy(ptr, n: int) -> np.ndarray:
    """An owning numpy copy of n elements at a C pointer."""
    np_dt = _CTYPE_NP[ptr._type_]
    if n <= 0 or not ptr:
        return np.zeros(max(n, 0), np_dt)
    return np.ctypeslib.as_array(ptr, shape=(n,)).copy()


# error codes of srtpu_chunk_walk (native/src/chunk_walk.cpp)
_WALK_ERRORS = {1: "allocation failed", 2: "unparseable page header",
                3: "page type or encoding outside the device decode "
                   "(v2 page, dictionary page out of order, an encoding "
                   "other than PLAIN/RLE_DICTIONARY)",
                4: "malformed page stream (truncated or corrupt)"}


def chunk_walk(buf, codec: int, optional: bool, is_bool: bool) -> dict:
    """The whole page walk of one column chunk in C++. codec: 0
    uncompressed, 1 snappy. Returns a dict of OWNING numpy arrays (the
    native allocation is freed before this returns, so nothing handed to
    an asynchronous copy can point into freed memory). Raises ValueError
    with the walk's reason when the chunk is outside its shape."""
    lib = load()
    src = np.frombuffer(buf, np.uint8)
    err = ctypes.c_int32(0)
    cp = lib.srtpu_chunk_walk(_u8(src), src.shape[0], codec, int(optional),
                              int(is_bool), ctypes.byref(err))
    if not cp:
        raise ValueError(_WALK_ERRORS.get(err.value,
                                          f"page walk error {err.value}"))
    try:
        c = cp.contents
        npages = c.num_pages
        return {
            "page_kind": _copy(c.page_kind, npages),
            "page_bw": _copy(c.page_bw, npages),
            "page_num_values": _copy(c.page_num_values, npages),
            "page_ndef": _copy(c.page_ndef, npages),
            "page_plain_off": _copy(c.page_plain_off, npages),
            "page_idx_run_off": _copy(c.page_idx_run_off, npages),
            "page_idx_packed_off": _copy(c.page_idx_packed_off, npages),
            "def_runs": (_copy(c.def_kinds, c.def_nruns),
                         _copy(c.def_counts, c.def_nruns),
                         _copy(c.def_values, c.def_nruns),
                         _copy(c.def_bitoffs, c.def_nruns),
                         _copy(c.def_packed, max(c.def_packed_len, 1))),
            "idx_runs": (_copy(c.idx_kinds, c.idx_nruns),
                         _copy(c.idx_counts, c.idx_nruns),
                         _copy(c.idx_values, c.idx_nruns),
                         _copy(c.idx_bitoffs, c.idx_nruns),
                         _copy(c.idx_packed, max(c.idx_packed_len, 1))),
            "idx_packed_len": int(c.idx_packed_len),
            "plain": _copy(c.plain, c.plain_len),
            "dict_raw": (_copy(c.dict_raw, c.dict_len)
                         if c.dict_len or c.dict_count else None),
            "dict_count": int(c.dict_count),
            "total_values": int(c.total_values),
        }
    finally:
        lib.srtpu_chunk_free(cp)
