"""Device parquet decode (`spark_rapids_tpu/io/parquet_device.py`, the
reference's `GpuParquetScan.scala:1600,1796,2461`: ship the raw column
chunks and decode whole pages on the accelerator).

Host, the control plane, numpy and C++ only:
  * the footer through pyarrow's metadata (row groups, chunk offsets,
    codecs);
  * the page walk of each column chunk in C++ (`native.chunk_walk`, built
    from `native/src/chunk_walk.cpp`): Thrift page headers, snappy, the
    RLE/bit-packed run scans of the definition levels and the dictionary
    indices (run tables of kind, count, value and bit offset, with no value
    expanded), and the PLAIN payloads concatenated;
  * the BYTE_ARRAY offset scan (`native.byte_array_scan`), the one serial
    step of a string column.
Device, eager torch ops on an explicit device:
  * definition levels and dictionary indices expand from their run tables:
    each output slot finds its run by `searchsorted` over the run ends and
    unpacks its bits from a window of at most 5 bytes held in int64;
  * PLAIN values arrive as raw little-endian bytes viewed as the column's
    type, dictionary values by a gather on the expanded indices;
  * fixed-width byte values (FIXED_LEN_BYTE_ARRAY decimals, INT96
    timestamps) arrive as a uint8[n, flen] matrix, dictionary rows by the
    same gather, and convert by vector shifts: big-endian two's complement
    sign-extended to int64 limbs (`_flba_to_limbs`), or INT96's nanos of the day
    and julian day to microseconds (`_int96_to_micros`);
  * strings gather their byte spans into the flat `uint8[cap, w]` layout,
    or, past the scan's head width, into the long-string layout (the head
    by the same gather, the rest into a tail blob; the packed path
    declines such a column, which the row group's eager decode builds);
  * non-null values land in their row slots by the rank cumsum(defined) - 1.

The default path (`decode_row_groups_fused`) decodes several row groups at
once: every column's arrays of every chunk pack into ONE host buffer, ship
in ONE copy, and the chunks merge into one batch by a rank gather. A group
whose page layout the packed path declines (dictionary pages after PLAIN
ones) decodes row group by row group from the same host work
(`_per_rg_batches`), still on the device; `COUNTERS` counts both.

Columns the footer check (`columns_supported`) refuses -- a codec other
than snappy, gzip, zstd or none, an encoding other than PLAIN, RLE and the
dictionary ones, a type the decode lacks (BYTE, SHORT, TIMESTAMP in
nanoseconds, FLBA decimals wider than 16 bytes), a physical type that
changes between row groups -- are decoded by pyarrow (`host_cols`), cast
to the scan's type and merged into the device batch at its capacity
(`_host_decode_cols`, `_host_cols_to_device`). A page the walk declines (a
v2 page, a truncated stream) raises DeviceDecodeUnsupported, and the scan
(io/scanbase.py) passes `device_decode_file` a `host_fallback` that
decodes that row group on the host. `COUNTERS` counts every host decode,
and only work whose batch was built: a group or row group that falls back
is not counted as decoded.

Names follow the JAX module; the JAX `_traced_*` functions and
`_fused_multi_program` are plain functions here (`_decode_col`,
`_decode_string_col`, `_read_idx`, `_fused_multi_decode`), since nothing is
traced. Differences from the JAX module, none of which changes a value:
  * A FIXED_LEN_BYTE_ARRAY decimal of 1-16 bytes converts by vector
    shifts (`_flba_to_limbs`): to int64 for precision <= 18 ('dec64'),
    to the [cap, 2] limbs past it ('dec128').
  * Snappy and uncompressed chunks take the native walk; gzip and zstd
    chunks the Python walk (`_decode_chunk_py`, `_rle_runs`), which
    decompresses each page through pyarrow, as the JAX walk does. The
    Python walkers are also the native walk's plain twins, held against it
    by the tests.
  * `_pack_arrays` pads every piece to 8 bytes, so each array views out of
    the shipped buffer at an aligned offset.
  * Row counts are host integers (from the footer), so nothing here reads a
    device value back.
"""

from __future__ import annotations

import contextlib
import os
import struct
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import native as _native
from .. import types as T
from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column, torch_dtype
from ..columnar.padding import row_bucket, width_bucket
from ..columnar.strings import blob_bucket, head_width, tail_byte_stream, \
    tail_starts_for
from ..errors import RapidsTpuError

__all__ = ["DeviceDecodeUnsupported", "FALLBACK_ERRORS", "COUNTERS",
           "host_columns", "columns_supported", "file_supported",
           "decode_row_group", "decode_row_groups_fused",
           "device_decode_file"]


class DeviceDecodeUnsupported(RapidsTpuError):
    """A column chunk the device decode does not cover; the scan decodes it
    on the host instead (io/scanbase.py)."""


# what falls a row group back to pyarrow (the JAX net): a malformed or
# unsupported stream and I/O errors; anything else, a failed launch among
# them, propagates
FALLBACK_ERRORS = (DeviceDecodeUnsupported, OSError, struct.error)


class ScanCounters:
    """What the decode did since the last reset(): row groups decoded
    (`scan_chunks`), packed multi-chunk dispatches (`fused_dispatches`),
    row groups of a packed group decoded one by one because the packed path
    declined their page layout (`declined_chunks`), host-to-device copies
    and their bytes; and the host decodes: column chunks decoded by pyarrow
    and merged into a device batch (`host_columns`), row groups decoded
    whole by pyarrow (`host_row_groups`), files decoded whole by pyarrow
    (`host_files`). Counts added inside `staged()` land only when its
    block ends without an exception."""

    _FIELDS = ("scan_chunks", "fused_dispatches", "declined_chunks",
               "h2d_copies", "h2d_bytes", "host_columns", "host_row_groups",
               "host_files")

    def __init__(self):
        self._lock = threading.Lock()
        self._stages = threading.local()  # per thread: the open stages
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)

    def add(self, **counts: int) -> None:
        stack = getattr(self._stages, "stack", None)
        if stack:
            for f, n in counts.items():
                stack[-1][f] = stack[-1].get(f, 0) + n
            return
        with self._lock:  # the decode runs on the scan's prefetch thread
            for f, n in counts.items():
                setattr(self, f, getattr(self, f) + n)

    @contextlib.contextmanager
    def staged(self):
        """Hold this thread's counts of the block back until it ends; an
        exception drops them, so a decode that falls back is not
        counted."""
        stack = self._stages.__dict__.setdefault("stack", [])
        stack.append({})
        try:
            yield
        except BaseException:
            stack.pop()
            raise
        self.add(**stack.pop())

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


COUNTERS = ScanCounters()


# ----------------------------------------------------------------------------
# Thrift compact protocol (just enough for the parquet PageHeader)
# ----------------------------------------------------------------------------

def _varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _skip_field(buf, pos, ftype):
    if ftype in (1, 2):  # bool true/false encoded in the field header
        return pos
    if ftype == 3:
        return pos + 1
    if ftype in (4, 5, 6):
        _, pos = _varint(buf, pos)
        return pos
    if ftype == 7:
        return pos + 8
    if ftype == 8:
        n, pos = _varint(buf, pos)
        return pos + n
    if ftype == 9:  # list
        head = buf[pos]
        pos += 1
        n = head >> 4
        etype = head & 0x0F
        if n == 15:
            n, pos = _varint(buf, pos)
        for _ in range(n):
            pos = _skip_field(buf, pos, etype)
        return pos
    if ftype == 12:  # struct
        return _skip_struct(buf, pos)
    raise DeviceDecodeUnsupported(f"thrift type {ftype}")


def _skip_struct(buf, pos):
    while True:
        head = buf[pos]
        pos += 1
        if head == 0:
            return pos
        if not head >> 4:
            _, pos = _varint(buf, pos)
        pos = _skip_field(buf, pos, head & 0x0F)


def _read_struct_fields(buf, pos):
    """Yields (field_id, field_type, value_or_None, new_pos); i32 and i64
    values decoded."""
    fid = 0
    while True:
        head = buf[pos]
        pos += 1
        if head == 0:
            yield None, None, None, pos
            return
        delta = head >> 4
        ftype = head & 0x0F
        if delta:
            fid += delta
        else:
            raw, pos = _varint(buf, pos)
            fid = _zigzag(raw)
        if ftype in (4, 5, 6):
            raw, pos = _varint(buf, pos)
            yield fid, ftype, _zigzag(raw), pos
        elif ftype in (1, 2):
            yield fid, ftype, ftype == 1, pos
        else:
            start = pos
            pos = _skip_field(buf, pos, ftype)
            yield fid, ftype, (start, pos), pos


class _PageHeader:
    __slots__ = ("type", "uncompressed", "compressed", "num_values",
                 "encoding", "def_encoding", "header_len")


def _parse_page_header(buf: memoryview, pos: int) -> _PageHeader:
    h = _PageHeader()
    start = pos
    h.type = h.uncompressed = h.compressed = None
    h.num_values = h.encoding = h.def_encoding = None
    for fid, ftype, val, pos in _read_struct_fields(buf, pos):
        if fid is None:
            break
        if fid == 1:
            h.type = val
        elif fid == 2:
            h.uncompressed = val
        elif fid == 3:
            h.compressed = val
        elif fid in (5, 7) and ftype == 12:
            sub_pos = val[0]  # (start, end) of the nested header struct
            for sfid, _, sval, sub_pos in _read_struct_fields(buf, sub_pos):
                if sfid is None:
                    break
                if sfid == 1:
                    h.num_values = sval
                elif sfid == 2:
                    h.encoding = sval
                elif sfid == 3:
                    h.def_encoding = sval
    h.header_len = pos - start
    return h


# ----------------------------------------------------------------------------
# RLE/bit-packed hybrid and BYTE_ARRAY scans: the plain twins of the native
# walk (the scan itself runs native/src/chunk_walk.cpp)
# ----------------------------------------------------------------------------

def _rle_runs(payload: memoryview, num_values: int, bit_width: int = 1):
    """Split an RLE/bit-packed hybrid stream into a run table:
    (kinds u8 [R] 0=rle 1=packed, counts i64, values u32, bitoffs i64,
    packed u8), bitoffs indexing the packed byte blob for packed runs.
    bit_width 1 is the def-level stream; a dictionary index stream carries
    its width (up to 32) in its page payload's first byte."""
    vbytes = (bit_width + 7) // 8
    kinds: List[int] = []
    counts: List[int] = []
    values: List[int] = []
    bitoffs: List[int] = []
    packed = bytearray()
    pos, out = 0, 0
    vmask = (1 << bit_width) - 1
    while out < num_values and pos < len(payload):
        header, pos = _varint(payload, pos)
        if header & 1:  # bit-packed group: (header>>1)*8 values
            n = (header >> 1) * 8
            nbytes = (header >> 1) * bit_width
            kept = min(n, num_values - out)
            if pos + (kept * bit_width + 7) // 8 > len(payload):
                raise DeviceDecodeUnsupported("truncated RLE stream")
            kinds.append(1)
            counts.append(kept)
            values.append(0)
            bitoffs.append(len(packed) * 8)
            packed.extend(payload[pos:pos + nbytes])
            pos += nbytes
            out += kept
        else:  # RLE run of header>>1 copies of a vbytes-wide LE value
            n = header >> 1
            if pos + vbytes > len(payload):
                raise DeviceDecodeUnsupported("truncated RLE stream")
            v = int.from_bytes(bytes(payload[pos:pos + vbytes]), "little")
            pos += vbytes
            kinds.append(0)
            counts.append(min(n, num_values - out))
            values.append(v & vmask)
            bitoffs.append(0)
            out += counts[-1]
    if out < num_values:
        raise DeviceDecodeUnsupported("truncated RLE stream")
    if not packed:
        packed = bytearray(1)
    return (np.array(kinds, np.uint8), np.array(counts, np.int64),
            np.array(values, np.uint32), np.array(bitoffs, np.int64),
            np.frombuffer(bytes(packed), np.uint8))


def _rle_runs_native(payload, num_values: int, bit_width: int = 1):
    """_rle_runs through the native scanner (`native.rle_scan`), as the JAX
    walk scans when its library is built: the run scans of the gzip and
    zstd walk."""
    try:
        return _native.rle_scan(np.frombuffer(payload, np.uint8),
                                num_values, bit_width)
    except ValueError as e:
        raise DeviceDecodeUnsupported("truncated RLE stream") from e


def _byte_array_scan_py(blob: np.ndarray, n: int) -> tuple:
    """Plain twin of native.byte_array_scan: the serial (u32 len, bytes)*
    walk -> (starts int64[n], lens int32[n], max_len)."""
    starts = np.empty(n, np.int64)
    lens = np.empty(n, np.int32)
    pos, total, mx = 0, blob.shape[0], 0
    for i in range(n):
        if pos + 4 > total:
            raise ValueError("truncated BYTE_ARRAY stream")
        ln = int.from_bytes(bytes(blob[pos:pos + 4]), "little")
        pos += 4
        if pos + ln > total:
            raise ValueError("truncated BYTE_ARRAY stream")
        starts[i] = pos
        lens[i] = ln
        mx = max(mx, ln)
        pos += ln
    return starts, lens, mx


def _byte_array_scan(blob: np.ndarray, n: int) -> tuple:
    try:
        return _native.byte_array_scan(blob, n)
    except ValueError as e:
        raise DeviceDecodeUnsupported(str(e)) from e


# ----------------------------------------------------------------------------
# Device kernels: eager torch ops. Every gather clamps its index as XLA's
# gather does implicitly; on CUDA an out-of-range index would be a device
# assert that poisons the context.
# ----------------------------------------------------------------------------

def _run_of(counts: torch.Tensor, cap: int):
    """Output slot -> (its run, its index within the run, the total count)
    over a run table with at least one run."""
    ends = torch.cumsum(counts, 0)
    j = torch.arange(cap, dtype=torch.int64, device=counts.device)
    run = torch.searchsorted(ends, j, right=True).clamp_(0,
                                                         counts.shape[0] - 1)
    base = torch.where(run > 0, ends[(run - 1).clamp(min=0)], 0)
    return j, run, j - base, ends[-1]


def _expand_def_levels(kinds, counts, values, bitoffs, packed,
                       cap: int) -> torch.Tensor:
    """Run table -> bool[cap] defined mask."""
    j, run, within, total = _run_of(counts, cap)
    bitpos = bitoffs[run] + within
    byte = packed[(bitpos >> 3).clamp(0, packed.shape[0] - 1)]
    bit = (byte.to(torch.int64) >> (bitpos & 7)) & 1
    lvl = torch.where(kinds[run] == 1, bit, values[run])
    return (lvl == 1) & (j < total)


def _expand_rle(kinds, counts, values, bitoffs, packed, cap: int,
                bw: int) -> torch.Tensor:
    """Run table -> int64[cap] values (dictionary indices): each slot reads
    a (bw + 7) / 8 + 1 byte window, at most 40 bits, and shifts its value
    out (JAX `_expand_rle_u32`, in int64: torch's uint32 shifts and
    searchsorted are partial on CUDA)."""
    j, run, within, total = _run_of(counts, cap)
    bitpos = bitoffs[run] + within * bw
    b0 = bitpos >> 3
    last = packed.shape[0] - 1
    window = torch.zeros(cap, dtype=torch.int64, device=counts.device)
    for k in range((bw + 7) // 8 + 1):
        byte = packed[(b0 + k).clamp(0, last)].to(torch.int64)
        window |= byte << (8 * k)
    pv = (window >> (bitpos & 7)) & ((1 << bw) - 1)
    out = torch.where(kinds[run] == 1, pv, values[run])
    return torch.where(j < total, out, 0)


def _scatter_values(vals: torch.Tensor, defined: torch.Tensor):
    """Dense non-null values (padded to cap) + defined mask -> row slots."""
    rank = torch.cumsum(defined.to(torch.int32), 0) - 1
    data = vals[rank.clamp(0, vals.shape[0] - 1)]
    keep = defined[:, None] if data.dim() == 2 else defined  # limbs
    return torch.where(keep, data, torch.zeros((), dtype=vals.dtype,
                                               device=vals.device)), \
        defined


def _gather_strings(blob, starts, lens, defined, width: int):
    """Row r reads value rank[r]'s span out of the shipped page/dict blob
    into the flat string layout (uint8[cap, width] + int32 lengths)."""
    cap = defined.shape[0]
    safe = (torch.cumsum(defined.to(torch.int32), 0) - 1).clamp(0, cap - 1)
    return _string_matrix_tail(blob, starts[safe], lens[safe], defined,
                               width)


def _string_matrix_tail(blob, starts, lens, valid, width: int):
    """Row-aligned span read: uint8[cap, width] + int32 lengths out of
    `blob`, invalid rows and the bytes past each length zeroed."""
    ln = torch.where(valid, lens, 0).to(torch.int32)
    if blob.shape[0] == 0:  # no value defined: nothing to read, one dead byte
        blob = torch.zeros(1, dtype=torch.uint8, device=blob.device)
    j = torch.arange(width, dtype=torch.int64, device=blob.device)
    idx = starts[:, None] + j[None, :]
    mat = blob[idx.clamp(0, blob.shape[0] - 1)]
    keep = (j[None, :] < ln[:, None]) & valid[:, None]
    return torch.where(keep, mat, 0).to(torch.uint8), ln


# ----------------------------------------------------------------------------
# Host orchestration
# ----------------------------------------------------------------------------

_PHYS_TO_NP = {"BOOLEAN": "bool", "INT32": "int32", "INT64": "int64",
               "FLOAT": "float32", "DOUBLE": "float64"}
# fixed-width byte values: the walk keeps their bytes as they are
_FIXED_BYTES = ("FIXED_LEN_BYTE_ARRAY", "INT96")
# the codecs the native walk decodes
_NATIVE_CODEC = {"UNCOMPRESSED": 0, "SNAPPY": 1}
# the codecs the Python walk decompresses through pyarrow; parquet "LZ4"
# (Hadoop-framed), LZ4_RAW and BROTLI go to the host decode
_CODEC = {"SNAPPY": "snappy", "GZIP": "gzip", "ZSTD": "zstd"}


def _decompress(data: bytes, codec: str, size: int) -> bytes:
    import pyarrow as pa
    if codec == "UNCOMPRESSED":
        return data
    name = _CODEC.get(codec)
    if name is None:
        raise DeviceDecodeUnsupported(f"codec {codec}")
    try:
        return pa.decompress(data, decompressed_size=size, codec=name)
    except (pa.ArrowInvalid, ValueError, OSError) as e:
        raise DeviceDecodeUnsupported(f"decompress failed: {e}") from e


def _defined_count(part) -> int:
    """Non-null count of one page's def-level run table: the counts of the
    RLE runs of 1, and the set bits of each packed run by a prefix sum (JAX
    `_defined_count`, without its loop over runs)."""
    kinds, counts, values, bitoffs, packed = part
    rle = kinds == 0
    total = int(counts[rle & (values == 1)].sum())
    if not rle.all():
        bits = np.concatenate(([0], np.cumsum(
            np.unpackbits(packed, bitorder="little"), dtype=np.int64)))
        lo, n = bitoffs[~rle], counts[~rle]
        total += int((bits[lo + n] - bits[lo]).sum())
    return total


class _Page:
    """One data page's control plane: def-level run table (None for
    required columns and for the native walk, which merges them per chunk),
    non-null count, and a PLAIN payload or a dictionary-index run table."""
    __slots__ = ("num_values", "ndef", "runs", "kind", "payload", "bw")


class _Chunk:
    # def_runs_merged: the native walk's whole-chunk def-level run table
    # with global bit offsets (the Python walk leaves it None and
    # _host_phase merges per page); plain_all: the native walk's
    # concatenated PLAIN payload, which the fast-path prep passes through
    __slots__ = ("pages", "dict_raw", "dict_count", "total",
                 "def_runs_merged", "plain_all")


def _decode_chunk(buf: bytes, col_meta, optional: bool) -> _Chunk:
    """One column chunk -> page descriptors: the native walk for snappy and
    uncompressed chunks, the Python walk for the codecs it decompresses
    through pyarrow (JAX `_decode_chunk`). Anything outside their shape
    raises DeviceDecodeUnsupported."""
    codec = _NATIVE_CODEC.get(col_meta.compression)
    if codec is None:
        return _decode_chunk_py(buf, col_meta, optional, _rle_runs_native)
    if col_meta.physical_type not in _PHYS_TO_NP and \
            col_meta.physical_type not in ("BYTE_ARRAY",) + _FIXED_BYTES:
        raise DeviceDecodeUnsupported(
            f"physical type {col_meta.physical_type}")
    is_bool = col_meta.physical_type == "BOOLEAN"
    try:
        res = _native.chunk_walk(buf, codec, optional, is_bool)
    except ValueError as e:
        # the Python walk names the page at fault (a v2 page, an encoding);
        # whatever it finds, the chunk is refused
        _decode_chunk_py(buf, col_meta, optional)
        raise DeviceDecodeUnsupported(str(e)) from e
    return _chunk_from_native(res, is_bool)


def _chunk_from_native(res: dict, is_bool: bool) -> _Chunk:
    """Native walk result -> the Python walk's _Chunk shape. Dictionary
    pages get LOCAL run-table slices (bit offsets rebased per page); the
    merged def-level table keeps its global offsets."""
    chunk = _Chunk()
    chunk.dict_raw = res["dict_raw"]
    chunk.dict_count = res["dict_count"]
    chunk.total = res["total_values"]
    chunk.def_runs_merged = res["def_runs"] \
        if res["def_runs"][0].shape[0] else None
    plain = res["plain"]
    chunk.plain_all = plain if not is_bool else None
    chunk.pages = []
    npages = res["page_kind"].shape[0]
    ik, ic, iv, ib, ip = res["idx_runs"]
    for i in range(npages):
        p = _Page()
        p.num_values = int(res["page_num_values"][i])
        p.ndef = int(res["page_ndef"][i])
        p.runs = None
        last = i + 1 == npages
        if res["page_kind"][i] == 0:
            p.kind = "plain"
            p.bw = 0
            lo = int(res["page_plain_off"][i])
            hi = plain.shape[0] if last else int(res["page_plain_off"][i + 1])
            pay = plain[lo:hi]
            p.payload = np.unpackbits(
                pay, bitorder="little")[:p.ndef] if is_bool else pay
        else:
            p.kind = "dict"
            p.bw = int(res["page_bw"][i])
            rlo = int(res["page_idx_run_off"][i])
            rhi = ik.shape[0] if last else int(res["page_idx_run_off"][i + 1])
            plo = int(res["page_idx_packed_off"][i])
            phi = res["idx_packed_len"] if last \
                else int(res["page_idx_packed_off"][i + 1])
            if p.bw and p.ndef:
                packed = ip[plo:phi]
                if packed.shape[0] == 0:
                    packed = np.zeros(1, np.uint8)
                p.payload = (ik[rlo:rhi], ic[rlo:rhi], iv[rlo:rhi],
                             ib[rlo:rhi] - plo * 8, packed)
            else:
                p.payload = None
        chunk.pages.append(p)
    return chunk


def _decode_chunk_py(buf: bytes, col_meta, optional: bool,
                     rle=_rle_runs) -> _Chunk:
    """The Python page walk (JAX `_decode_chunk_inner`): with the Python
    run scan `_rle_runs`, the plain twin of the native walk and the
    semantic spec it is held against; with `_rle_runs_native`, the walk of
    the codecs the native walk lacks."""
    try:
        return _decode_chunk_inner(buf, col_meta, optional, rle)
    except (IndexError, struct.error) as e:
        raise DeviceDecodeUnsupported(f"malformed page stream: {e}") from e


def _decode_chunk_inner(buf: bytes, col_meta, optional: bool,
                        rle=_rle_runs) -> _Chunk:
    phys = col_meta.physical_type
    if phys not in _PHYS_TO_NP and phys not in ("BYTE_ARRAY",) + \
            _FIXED_BYTES:
        raise DeviceDecodeUnsupported(f"physical type {phys}")
    is_bool = phys == "BOOLEAN"
    mv = memoryview(buf)
    pos = 0
    chunk = _Chunk()
    chunk.pages = []
    chunk.dict_raw = None
    chunk.dict_count = 0
    chunk.total = 0
    chunk.def_runs_merged = None
    chunk.plain_all = None
    while pos < len(mv):
        h = _parse_page_header(mv, pos)
        if h.type is None or h.compressed is None or h.uncompressed is None:
            raise DeviceDecodeUnsupported("unparseable page header")
        pos += h.header_len
        if h.type == 2:  # dictionary page: PLAIN-encoded distinct values
            if chunk.pages or chunk.dict_raw is not None:
                raise DeviceDecodeUnsupported("out-of-order dictionary page")
            if h.encoding not in (0, 2):  # PLAIN / PLAIN_DICTIONARY
                raise DeviceDecodeUnsupported(
                    f"dict page encoding {h.encoding}")
            chunk.dict_raw = _decompress(bytes(mv[pos:pos + h.compressed]),
                                         col_meta.compression,
                                         h.uncompressed)
            chunk.dict_count = h.num_values or 0
            pos += h.compressed
            continue
        if h.type != 0:  # only v1 data pages; a v2 body is not wholly
            # compressed, so it is refused before decompression
            raise DeviceDecodeUnsupported(f"page type {h.type}")
        payload = _decompress(bytes(mv[pos:pos + h.compressed]),
                              col_meta.compression, h.uncompressed)
        pos += h.compressed
        body = memoryview(payload)
        p = _Page()
        p.num_values = h.num_values
        if optional:
            if h.def_encoding != 3:  # RLE
                raise DeviceDecodeUnsupported(
                    f"def-level encoding {h.def_encoding}")
            (dlen,) = struct.unpack_from("<i", body, 0)
            p.runs = rle(body[4:4 + dlen], h.num_values)
            page_vals = body[4 + dlen:]
            p.ndef = _defined_count(p.runs)
        else:
            p.runs = None
            page_vals = body
            p.ndef = h.num_values
        if h.encoding == 0:  # PLAIN
            p.kind = "plain"
            p.bw = 0
            if is_bool:
                # bit-packing restarts at a byte boundary on every page:
                # keep unpacked 0/1 bytes
                if len(page_vals) * 8 < p.ndef:
                    raise DeviceDecodeUnsupported("truncated bool page")
                p.payload = np.unpackbits(
                    np.frombuffer(page_vals, np.uint8),
                    bitorder="little")[:p.ndef]
            else:
                p.payload = bytes(page_vals)
        elif h.encoding in (2, 8):  # PLAIN_DICTIONARY / RLE_DICTIONARY
            if chunk.dict_raw is None:
                raise DeviceDecodeUnsupported("dict page missing")
            p.kind = "dict"
            p.bw = page_vals[0] if len(page_vals) else 0
            if p.bw > 32:
                raise DeviceDecodeUnsupported(f"index bit width {p.bw}")
            p.payload = rle(page_vals[1:], p.ndef, p.bw) \
                if p.bw and p.ndef else None
        else:
            raise DeviceDecodeUnsupported(f"value encoding {h.encoding}")
        chunk.pages.append(p)
        chunk.total += h.num_values
    return chunk


def _merge_runs(run_parts):
    kinds = np.concatenate([p[0] for p in run_parts])
    counts = np.concatenate([p[1] for p in run_parts])
    values = np.concatenate([p[2] for p in run_parts])
    packed_lens = [p[4].shape[0] for p in run_parts]
    offs = np.concatenate(([0], np.cumsum(packed_lens)[:-1]))
    bitoffs = np.concatenate([p[3] + o * 8
                              for p, o in zip(run_parts, offs)])
    packed = np.concatenate([p[4] for p in run_parts])
    return kinds, counts, values, bitoffs, packed


_OK_ENCODINGS = {"PLAIN", "RLE", "BIT_PACKED", "PLAIN_DICTIONARY",
                 "RLE_DICTIONARY"}

# the engine types decoded as their physical values, by the physical type
# that holds them (decimals and timestamps: `_column_spec`)
_EXPECTED_PHYS = {
    T.BooleanType: "BOOLEAN",
    T.IntegerType: "INT32",
    T.LongType: "INT64",
    T.FloatType: "FLOAT",
    T.DoubleType: "DOUBLE",
    T.DateType: "INT32",
    T.StringType: "BYTE_ARRAY",
}
# the widest FIXED_LEN_BYTE_ARRAY decimal the decode converts
_MAX_FLBA_DECIMAL_BYTES = 16


class _ColSpec:
    """Footer-derived decode plan for one column (JAX `_ColSpec`).
    kind: 'prim' (viewed or dictionary values), 'string' (BYTE_ARRAY) or
    'flba' (fixed-width byte values: FLBA decimals, INT96).
    post: the conversion after the decode: None, 'ts_ms' (millis ->
    micros), 'dec64' (big-endian FLBA -> int64), 'dec128' (big-endian
    FLBA -> int64[n, 2] limbs) or 'int96'.
    flen: the byte width of a 'flba' value."""
    __slots__ = ("kind", "post", "flen")

    def __init__(self, kind, post=None, flen=0):
        self.kind, self.post, self.flen = kind, post, flen


def _timestamp_unit(pqcol):
    lt = pqcol.logical_type
    if lt is not None and lt.type == "TIMESTAMP":
        import json
        return json.loads(lt.to_json()).get("timeUnit")
    return {"TIMESTAMP_MICROS": "microseconds",
            "TIMESTAMP_MILLIS": "milliseconds"}.get(
                str(pqcol.converted_type))


def _column_spec(pqcol, dt) -> _ColSpec:
    """Footer column descriptor + engine type -> decode spec, or
    DeviceDecodeUnsupported with the reason (JAX `_column_spec`)."""
    phys = pqcol.physical_type
    if isinstance(dt, T.DecimalType):
        lt = pqcol.logical_type
        if lt is None or lt.type != "DECIMAL":
            raise DeviceDecodeUnsupported(f"{phys} without DECIMAL "
                                          "annotation")
        if pqcol.scale != dt.scale or pqcol.precision > dt.precision:
            raise DeviceDecodeUnsupported(
                f"decimal({pqcol.precision},{pqcol.scale}) in file vs "
                f"{dt.simple_string()} in schema")
        wide = dt.precision > T.DecimalType.MAX_LONG_DIGITS
        if phys in ("INT32", "INT64") and not wide:  # the unscaled value
            return _ColSpec("prim")
        if phys == "FIXED_LEN_BYTE_ARRAY":
            if not 0 < pqcol.length <= _MAX_FLBA_DECIMAL_BYTES:
                raise DeviceDecodeUnsupported(
                    f"FLBA length {pqcol.length}")
            return _ColSpec("flba", "dec128" if wide else "dec64",
                            pqcol.length)
        raise DeviceDecodeUnsupported(f"{phys} for {dt.simple_string()}")
    if isinstance(dt, T.TimestampType):
        if phys == "INT96":
            return _ColSpec("flba", "int96", 12)
        if phys != "INT64":
            raise DeviceDecodeUnsupported(f"{phys} for timestamp")
        unit = _timestamp_unit(pqcol)
        if unit == "microseconds":
            return _ColSpec("prim")
        if unit == "milliseconds":
            return _ColSpec("prim", "ts_ms")
        # nanoseconds would narrow with a loss (Spark refuses NANOS)
        raise DeviceDecodeUnsupported(f"timestamp unit {unit}")
    want = _EXPECTED_PHYS.get(type(dt))
    if want is None:
        raise DeviceDecodeUnsupported(f"logical type {dt.simple_string()}")
    if phys != want:
        raise DeviceDecodeUnsupported(f"{phys} for {dt.simple_string()}")
    return _ColSpec("string" if phys == "BYTE_ARRAY" else "prim")


def _col_index(meta) -> dict:
    sch = meta.schema
    return {sch.column(i).path: i for i in range(len(sch))}


def columns_supported(path, schema):
    """(ParquetFile, host_columns of its footer) (JAX
    `columns_supported`)."""
    import pyarrow.parquet as pq
    pf = pq.ParquetFile(path)
    return pf, host_columns(pf.metadata, schema)


def host_columns(meta, schema) -> dict:
    """Footer-only check of a file's FileMetaData, no page bytes read:
    {column name: reason} for the columns the device decode cannot take,
    which the scan decodes on the host. The page-level checks (page
    version, string lengths) run when the pages are walked."""
    col_index = _col_index(meta)
    bad = {}
    for name, dt in zip(schema.names, schema.types):
        try:
            ci = col_index.get(name)
            if ci is None:
                raise DeviceDecodeUnsupported(f"column {name} not flat")
            pqcol = meta.schema.column(ci)
            if pqcol.max_repetition_level > 0:
                raise DeviceDecodeUnsupported("repeated column")
            _column_spec(pqcol, dt)
            for rg in range(meta.num_row_groups):
                cm = meta.row_group(rg).column(ci)
                if cm.physical_type != pqcol.physical_type:
                    raise DeviceDecodeUnsupported(
                        f"{cm.physical_type} for {dt.simple_string()}")
                if cm.compression != "UNCOMPRESSED" and \
                        cm.compression not in _CODEC:
                    raise DeviceDecodeUnsupported(
                        f"codec {cm.compression}")
                if not set(cm.encodings) <= _OK_ENCODINGS:
                    raise DeviceDecodeUnsupported(
                        f"encodings {cm.encodings}")
        except DeviceDecodeUnsupported as e:
            bad[name] = str(e)
    return bad


def file_supported(path, schema):
    """All-or-nothing form of columns_supported: raises
    DeviceDecodeUnsupported if any column is refused; returns the parsed
    ParquetFile."""
    pf, bad = columns_supported(path, schema)
    if bad:
        name, reason = next(iter(bad.items()))
        raise DeviceDecodeUnsupported(f"{name}: {reason}")
    return pf


class _ColWork:
    """One column's host-phase product: the parsed chunk, the merged
    def-level run table, and the fast-path ship list and meta when the page
    layout allows the packed path (ship None: the eager assemble)."""
    __slots__ = ("name", "dt", "spec", "kind", "phys", "optional", "chunk",
                 "defruns", "ship", "meta")


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_runs(runs):
    """Pad a run table to power-of-two lengths, and to at least one run
    (zero-count runs append harmlessly past the cumsum; the packed blob
    pads with dead bytes)."""
    kinds, counts, values, bitoffs, packed = runs
    pad = _pow2(max(len(kinds), 1)) - len(kinds)
    if pad:
        kinds = np.pad(kinds, (0, pad))
        counts = np.pad(counts, (0, pad))
        values = np.pad(values, (0, pad))
        bitoffs = np.pad(bitoffs, (0, pad))
    pb = _pow2(max(len(packed), 1))
    if pb > len(packed):
        packed = np.pad(packed, (0, pb - len(packed)))
    return kinds, counts, values, bitoffs, packed


def _host_phase(pf, f, rg: int, schema, host_cols=()):
    """Host half of a row-group decode of the columns not in `host_cols`:
    chunk reads, the page walks and the fast-path preps; numpy only, no
    device work."""
    meta = pf.metadata
    col_index = _col_index(meta)
    rgm = meta.row_group(rg)
    nrows = rgm.num_rows
    fd = f.fileno()

    def read_chunk(cm):
        start = cm.dictionary_page_offset or cm.data_page_offset
        want = cm.total_compressed_size
        # positional reads leave the handle's offset alone; loop because one
        # pread may return short
        parts, got = [], 0
        while got < want:
            part = os.pread(fd, want - got, start + got)
            if not part:
                break  # EOF: the walk raises on the short buffer
            parts.append(part)
            got += len(part)
        return parts[0] if len(parts) == 1 else b"".join(parts)

    works = {}
    for name, dt in zip(schema.names, schema.types):
        if name in host_cols:
            continue
        ci = col_index.get(name)
        if ci is None:
            raise DeviceDecodeUnsupported(f"column {name} missing from file")
        cm = rgm.column(ci)
        pqcol = meta.schema.column(ci)
        if pqcol.max_repetition_level > 0:
            raise DeviceDecodeUnsupported("repeated column")
        w = _ColWork()
        w.name, w.dt = name, dt
        w.spec = _column_spec(pqcol, dt)
        w.kind = w.spec.kind
        w.phys = cm.physical_type
        w.optional = pqcol.max_definition_level > 0
        w.chunk = _decode_chunk(read_chunk(cm), cm, w.optional)
        if w.chunk.total != nrows:
            raise DeviceDecodeUnsupported("page/row-group mismatch")
        if w.chunk.def_runs_merged is not None:
            w.defruns = _pad_runs(w.chunk.def_runs_merged)
        else:  # the Python walk's per-page tables, merged here
            parts = [p.runs for p in w.chunk.pages if p.runs is not None]
            w.defruns = _pad_runs(_merge_runs(parts)) \
                if w.optional and parts else None
        w.ship = w.meta = None
        prepped = None
        if w.kind == "prim":
            prepped = _prep_fixed(w.chunk, w.phys)
        elif w.kind == "flba":
            prepped = _prep_flba(w.chunk, w.spec.flen)
        if prepped is not None:
            w.ship, w.meta = prepped
        works[name] = w
    return works, nrows


# -- host -> device transfer --------------------------------------------------

_NP_TO_TORCH = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64,
                np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def _pack_arrays(arrays: List[np.ndarray]):
    """Flatten host arrays into ONE contiguous uint8 buffer, each piece
    padded to 8 bytes so it views back out at an aligned offset. Returns
    (packed uint8[n], metas), each meta (dtype str, shape, byte offset)."""
    metas, parts, off = [], [], 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        raw = a.astype(np.uint8).reshape(-1) if a.dtype == np.bool_ \
            else a.view(np.uint8).reshape(-1)
        metas.append((a.dtype.str, a.shape, off))
        parts.append(raw)
        off += raw.size
        pad = -off % 8
        if pad:
            parts.append(np.zeros(pad, np.uint8))
            off += pad
    packed = np.concatenate(parts) if parts else np.zeros(8, np.uint8)
    return packed, tuple(metas)


def _unpack(packed: torch.Tensor, meta) -> torch.Tensor:
    """One array back out of the shipped buffer: a slice and a view, with
    uint32 (run values) widened to int64."""
    dt_str, shape, off = meta
    dt = np.dtype(dt_str)
    n = int(np.prod(shape)) if shape else 1
    seg = packed[off:off + n * dt.itemsize]
    if dt == np.bool_:
        return seg.view(torch.bool).reshape(shape)
    if dt == np.uint32:
        return (seg.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
                ).reshape(shape)
    return seg.view(_NP_TO_TORCH[dt]).reshape(shape)


def _ship(arrays: List[np.ndarray], device: torch.device) -> List:
    """Arrays -> device tensors in ONE host-to-device copy."""
    packed, metas = _pack_arrays(arrays)
    dev = torch.from_numpy(packed).to(device)
    COUNTERS.add(h2d_copies=1, h2d_bytes=int(packed.nbytes))
    return [_unpack(dev, m) for m in metas]


def _pad_rows(t: torch.Tensor, cap: int) -> torch.Tensor:
    """Zero rows appended up to cap (the leading dim), or cut to cap."""
    if t.shape[0] >= cap:
        return t[:cap]
    return torch.cat([t, t.new_zeros((cap - t.shape[0],) + t.shape[1:])])


def _cat(parts: list, empty: torch.Tensor) -> torch.Tensor:
    if not parts:
        return empty
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _engine_data(data: torch.Tensor, dt, post=None) -> torch.Tensor:
    """Decoded values -> the engine type's buffer; 'ts_ms' scales stored
    milliseconds to microseconds."""
    want = torch_dtype(dt)
    data = data if data.dtype == want else data.to(want)
    return data * 1000 if post == "ts_ms" else data


def _flba_to_limbs(mat: torch.Tensor, flen: int):
    """Big-endian two's complement uint8[n, flen] (flen <= 16) -> (hi, lo)
    int64 limbs (the expr/decimal128 layout), sign-extended past flen
    bytes, by vector shifts (JAX `_flba_to_limbs`)."""
    fill = torch.where(mat[:, 0] >= 128, 0xFF, 0).to(torch.int64) \
        if flen < 16 else None
    lo = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    hi = torch.zeros_like(lo)
    for j in range(16):  # byte j counts from the least significant end
        src = flen - 1 - j
        b = mat[:, src].to(torch.int64) if src >= 0 else fill
        if j < 8:
            lo |= b << (8 * j)
        else:
            hi |= b << (8 * (j - 8))
    return hi, lo


def _flba_to_i64(mat: torch.Tensor, flen: int) -> torch.Tensor:
    """The low limb: the int64 value of a decimal of <= 18 digits."""
    return _flba_to_limbs(mat, flen)[1]


_JULIAN_EPOCH_DAY = 2_440_588  # julian day of 1970-01-01
_US_PER_DAY = 86_400_000_000


def _int96_to_micros(mat: torch.Tensor) -> torch.Tensor:
    """INT96 timestamps uint8[n, 12]: little-endian nanos of the day (8
    bytes), then the little-endian julian day (4 bytes) -> microseconds
    since the epoch (Spark's `ParquetRowConverter` arithmetic; the nanos
    are non-negative, so the division truncates as Java's does)."""
    nanos = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    for j in range(8):
        nanos |= mat[:, j].to(torch.int64) << (8 * j)
    day = torch.zeros_like(nanos)
    for j in range(4):
        day |= mat[:, 8 + j].to(torch.int64) << (8 * j)
    return (day - _JULIAN_EPOCH_DAY) * _US_PER_DAY + \
        torch.div(nanos, 1000, rounding_mode="trunc")


def _flba_values(mat: torch.Tensor, post: str, flen: int) -> torch.Tensor:
    """A value-dense byte matrix -> the column's int64 values."""
    if post == "int96":
        return _int96_to_micros(mat)
    if post == "dec128":
        return torch.stack(_flba_to_limbs(mat, flen), dim=1)
    return _flba_to_i64(mat, flen)


# -- eager assembles: the page interleavings the packed path declines ---------

def _device_phase(pf, rg: int, schema, works, nrows: int,
                  device: torch.device, host_cols, hw: int):
    """Device half of one row group: the fast-path columns' arrays ship in
    one copy and decode with `_decode_col`; strings and odd page layouts
    run their eager assembles; then the host columns are decoded by
    pyarrow and merged at the same capacity. A string column past `hw`
    bytes takes the long-string layout."""
    cap = row_bucket(nrows)
    fused = [w for w in works.values() if w.ship is not None]
    cols = {}
    if fused:
        flat: List[np.ndarray] = []
        for w in fused:
            if w.defruns is not None:
                flat.extend(w.defruns)
            flat.extend(w.ship)
        it = iter(_ship(flat, device))
        for w in fused:
            data, validity, _ = _decode_col(_col_sig(w), cap, nrows, it,
                                            device)
            cols[w.name] = Column(w.dt, data, validity)
    for name, dt in zip(schema.names, schema.types):
        if name in cols or name in host_cols:
            continue
        w = works[name]
        if w.defruns is not None:
            defined = _expand_def_levels(*_ship(list(w.defruns), device),
                                         cap)
        else:  # a required column, or a 0-row row group (no pages)
            defined = torch.arange(cap, device=device) < nrows
        if w.kind == "string":
            cols[name] = _assemble_strings(w.chunk, dt, defined, cap, device,
                                           hw)
        elif w.kind == "flba":
            cols[name] = _assemble_flba(w.chunk, w.spec, dt, defined, cap,
                                        device)
        else:
            cols[name] = _assemble_fixed(w.chunk, w.phys, dt, defined, cap,
                                         device, w.spec.post)
    cols.update(_host_decode_cols(pf, [rg], schema, host_cols, cap, nrows,
                                  device, hw))
    return ColumnarBatch(schema, tuple(cols[n] for n in schema.names),
                         torch.tensor(nrows, dtype=torch.int32,
                                      device=device)), nrows


def decode_row_group(pf, f, rg: int, schema, device: torch.device,
                     host_cols=(), head: Optional[int] = None):
    """Decode ONE row group on `device` -> (ColumnarBatch, row count). `pf`
    is a parsed ParquetFile; `f` an open binary handle on the same file;
    `host_cols` the columns columns_supported() refused, decoded by
    pyarrow and merged into the batch. A string column past `head` bytes
    (the default conf's head width when None) takes the long-string
    layout. A page the walk declines raises DeviceDecodeUnsupported, for
    the caller's fallback."""
    hw = head_width() if head is None else head
    works, nrows = _host_phase(pf, f, rg, schema, host_cols)
    out = _device_phase(pf, rg, schema, works, nrows, device, host_cols, hw)
    COUNTERS.add(scan_chunks=1)
    return out


def _host_cols_to_device(t, schema, names, cap: int, device,
                         head: Optional[int] = None):
    """Host-decoded Arrow columns -> {name: Column} at the batch's
    capacity, each cast to the scan's type first: the file's type may
    differ (a TIMESTAMP in nanoseconds), and a value merged at another
    type would be wrong without an error. A cast pyarrow finds lossy
    raises DeviceDecodeUnsupported, which falls the row group back whole
    (JAX `_host_cols_to_device`). A string past `head` bytes takes the
    long-string layout (with None, the flat matrix: `from_arrow`)."""
    import pyarrow as pa
    from ..columnar.column import from_arrow
    by_name = dict(zip(schema.names, schema.types))
    out = {}
    for name in names:
        arr = t.column(name)
        want = T.to_arrow(by_name[name])
        if arr.type != want:
            try:
                arr = arr.cast(want)
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError) as e:
                raise DeviceDecodeUnsupported(
                    f"host column cast {arr.type} -> {want}: {e}") from e
        out[name] = from_arrow(arr, device, capacity=cap, head=head)[0]
    return out


def _host_decode_cols(pf, rgs, schema, host_cols, cap: int, nrows: int,
                      device, hw: int):
    """pyarrow's decode of the host columns of row groups `rgs` ->
    {name: Column} at capacity `cap` (JAX `_host_decode_cols`); counts one
    host column chunk per column and row group."""
    names = [n for n in schema.names if n in host_cols]
    if not names:
        return {}
    import pyarrow as pa
    try:
        t = pf.read_row_groups(list(rgs), columns=names)
    except (OSError, pa.ArrowInvalid, KeyError) as e:
        # KeyError: the column left the file after the footer check
        raise DeviceDecodeUnsupported(f"host column decode: {e}") from e
    if t.num_rows != nrows:
        raise DeviceDecodeUnsupported("host column row-count mismatch")
    out = _host_cols_to_device(t, schema, names, cap, device, head=hw)
    COUNTERS.add(host_columns=len(names) * len(rgs))
    return out


def _expand_indices(page: _Page, dict_count: int, device) -> torch.Tensor:
    """One dictionary-coded page's index stream -> int64 [ndef]."""
    if page.bw == 0 or page.payload is None:
        return torch.zeros(page.ndef, dtype=torch.int64, device=device)
    runs = _ship(list(_pad_runs(page.payload)), device)
    idx = _expand_rle(*runs, row_bucket(page.ndef), int(page.bw))[:page.ndef]
    return idx.clamp(0, max(dict_count - 1, 0))


def _dict_segments(pages):
    """Consecutive equal-bit-width dictionary pages -> [(bw, ndef,
    runs|None)], runs the 5 merged numpy arrays (None for bw 0)."""
    segs = []
    for p in pages:
        bw = 0 if p.payload is None else int(p.bw)
        if segs and segs[-1][0] == bw:
            segs[-1][1].append(p)
        else:
            segs.append((bw, [p]))
    out = []
    for bw, ps in segs:
        ndef = sum(p.ndef for p in ps)
        if ndef == 0:
            continue
        runs = _merge_runs([p.payload for p in ps]) if bw else None
        out.append((bw, ndef, runs))
    return out


def _dict_prefix(chunk: _Chunk):
    """Number of leading dictionary pages, or None when a dictionary page
    follows a PLAIN page (the eager assembles' layout)."""
    kinds = [p.kind for p in chunk.pages]
    ndict = 0
    while ndict < len(kinds) and kinds[ndict] == "dict":
        ndict += 1
    if not kinds or not all(k == "plain" for k in kinds[ndict:]):
        return None
    return ndict


def _prep_fast_path(chunk: _Chunk, meta: dict, build_dict_vals,
                    build_plain, passthrough):
    """Host half of the dictionary-prefix + PLAIN-suffix fast path: (ship
    list of numpy arrays, meta), or None when the page layout needs the
    eager assemble."""
    ndict = _dict_prefix(chunk)
    if ndict is None:
        return None
    ship: List[np.ndarray] = []
    meta.update({"segs": [], "dict_count": chunk.dict_count,
                 "has_dict_vals": False, "has_plain": False})
    # dictionary pages that define no value (an all-null chunk) need no
    # dictionary: _dict_segments drops them
    segs = _dict_segments(chunk.pages[:ndict])
    if segs:
        if chunk.dict_raw is None or not chunk.dict_count:
            raise DeviceDecodeUnsupported("dict page missing values")
        ship.append(build_dict_vals(chunk))
        meta["has_dict_vals"] = True
        for bw, ndef, runs in segs:
            meta["segs"].append((bw, ndef, runs is not None))
            if runs is not None:
                ship.extend(_pad_runs(runs))
    plain_pages = [p for p in chunk.pages[ndict:] if p.ndef]
    if plain_pages:
        whole = passthrough(sum(p.ndef for p in plain_pages))
        if whole is not None:
            ship.append(whole)  # the native walk's concatenated payload
        else:
            plain = [build_plain(p) for p in plain_pages]
            ship.append(plain[0] if len(plain) == 1
                        else np.concatenate(plain))
        meta["has_plain"] = True
    return ship, meta


def _prep_fixed(chunk: _Chunk, phys: str):
    """Fixed-width fast-path prep (see _prep_fast_path)."""
    np_dt = np.dtype(_PHYS_TO_NP[phys])
    is_bool = phys == "BOOLEAN"

    def dict_vals(c):
        try:
            return np.frombuffer(c.dict_raw, np_dt, count=c.dict_count)
        except ValueError as e:
            raise DeviceDecodeUnsupported(
                f"truncated dict page: {e}") from e

    def plain_values(p):
        if is_bool:
            return p.payload.astype(np.bool_)
        try:
            return np.frombuffer(p.payload, np_dt, count=p.ndef)
        except ValueError as e:
            raise DeviceDecodeUnsupported(
                f"truncated value page: {e}") from e

    def passthrough(total):
        if chunk.plain_all is not None and not is_bool and \
                chunk.plain_all.nbytes == total * np_dt.itemsize:
            return chunk.plain_all.view(np_dt)
        return None

    return _prep_fast_path(chunk, {"np_dt": np_dt, "is_bool": is_bool},
                           dict_vals, plain_values, passthrough)


def _prep_flba(chunk: _Chunk, flen: int):
    """Fixed-width byte values' fast-path prep (see _prep_fast_path): the
    dictionary and the PLAIN values as uint8[n, flen] matrices."""

    def dict_vals(c):
        need = c.dict_count * flen
        if len(c.dict_raw) < need:
            raise DeviceDecodeUnsupported("truncated dict page")
        return np.frombuffer(c.dict_raw, np.uint8,
                             count=need).reshape(-1, flen)

    def plain_mat(p):
        try:
            return np.frombuffer(p.payload, np.uint8,
                                 count=p.ndef * flen).reshape(-1, flen)
        except ValueError as e:
            raise DeviceDecodeUnsupported(
                f"truncated value page: {e}") from e

    def passthrough(total):
        if chunk.plain_all is not None and \
                chunk.plain_all.nbytes == total * flen:
            return chunk.plain_all.reshape(-1, flen)
        return None

    return _prep_fast_path(chunk, {"flen": flen}, dict_vals, plain_mat,
                           passthrough)


def _assemble_flba(chunk: _Chunk, spec: _ColSpec, dt, defined, cap: int,
                   device):
    """Fixed-width byte values in any page order: one value-dense
    uint8[n, flen] matrix (dictionary pages gather rows of the dictionary
    matrix, consecutive PLAIN pages ship as one), converted by vector
    shifts and scattered to the row slots by null rank."""
    flen = spec.flen
    dict_mat = None
    if chunk.dict_raw is not None and chunk.dict_count:
        need = chunk.dict_count * flen
        if len(chunk.dict_raw) < need:
            raise DeviceDecodeUnsupported("truncated dict page")
        dict_mat, = _ship([np.frombuffer(chunk.dict_raw, np.uint8,
                                         count=need).reshape(-1, flen)],
                          device)
    parts = []
    host_run: List[np.ndarray] = []

    def flush_host():
        if host_run:
            parts.extend(_ship([np.concatenate(host_run)], device))
            host_run.clear()

    for p in chunk.pages:
        if p.ndef == 0:
            continue
        if p.kind == "plain":
            try:
                host_run.append(np.frombuffer(p.payload, np.uint8,
                                              count=p.ndef * flen)
                                .reshape(-1, flen))
            except ValueError as e:
                raise DeviceDecodeUnsupported(
                    f"truncated value page: {e}") from e
        else:
            if dict_mat is None:
                raise DeviceDecodeUnsupported("dict page missing values")
            flush_host()
            parts.append(dict_mat[_expand_indices(p, chunk.dict_count,
                                                  device)])
    flush_host()
    mat = _cat(parts, torch.zeros((0, flen), dtype=torch.uint8,
                                  device=device))
    vals = _flba_values(_pad_rows(mat, cap), spec.post, flen)
    data, validity = _scatter_values(vals, defined)
    return Column(dt, _engine_data(data, dt), validity)


def _assemble_fixed(chunk: _Chunk, phys: str, dt, defined, cap: int,
                    device, post=None):
    """Fixed-width column in any page order: per-page non-null value
    streams (PLAIN bytes or a dictionary gather) in page order, then
    scattered to the row slots by null rank."""
    np_dt = np.dtype(_PHYS_TO_NP[phys])
    is_bool = phys == "BOOLEAN"
    dict_vals = None
    if chunk.dict_raw is not None and chunk.dict_count:
        try:
            host = np.frombuffer(chunk.dict_raw, np_dt,
                                 count=chunk.dict_count)
        except ValueError as e:
            raise DeviceDecodeUnsupported(f"truncated dict page: {e}") from e
        dict_vals, = _ship([host], device)
    parts = []
    host_run: List[np.ndarray] = []  # consecutive PLAIN pages ship as one

    def flush_host():
        if host_run:
            parts.extend(_ship([np.concatenate(host_run)], device))
            host_run.clear()

    for p in chunk.pages:
        if p.ndef == 0:  # nothing defined: no values, no dictionary read
            continue
        if p.kind == "plain":
            if is_bool:
                host_run.append(p.payload.astype(np.bool_))
                continue
            try:
                host_run.append(np.frombuffer(p.payload, np_dt, count=p.ndef))
            except ValueError as e:
                raise DeviceDecodeUnsupported(
                    f"truncated value page: {e}") from e
        else:
            if dict_vals is None:
                raise DeviceDecodeUnsupported("dict page missing values")
            flush_host()
            parts.append(dict_vals[_expand_indices(p, chunk.dict_count,
                                                   device)])
    flush_host()
    tdt = torch.bool if is_bool else _NP_TO_TORCH[np_dt]
    vals = _cat(parts, torch.zeros(0, dtype=tdt, device=device))
    data, validity = _scatter_values(_pad_rows(vals, cap), defined)
    return Column(dt, _engine_data(data, dt, post), validity)


def _assemble_strings(chunk: _Chunk, dt, defined, cap: int, device,
                      hw: int):
    """BYTE_ARRAY column in any page order -> the flat string layout, or
    past `hw` bytes the long-string layout. The host runs only the serial
    offset scans; the device gathers every value span out of the shipped
    page and dictionary blobs."""
    # the blob: PLAIN page payloads in page order, the dictionary at the end
    plain_bases = {}
    base = 0
    for i, p in enumerate(chunk.pages):
        if p.kind == "plain":
            plain_bases[i] = base
            base += len(p.payload)
    blob_parts = [np.frombuffer(p.payload, np.uint8)
                  for p in chunk.pages if p.kind == "plain"]
    max_len = 1
    host_spans: List[np.ndarray] = []
    has_dict = any(p.kind == "dict" and p.ndef for p in chunk.pages)
    if has_dict:
        if chunk.dict_raw is None:
            raise DeviceDecodeUnsupported("dict page missing values")
        dict_blob = np.frombuffer(chunk.dict_raw, np.uint8)
        dst, dln, dmx = _byte_array_scan(dict_blob, chunk.dict_count)
        blob_parts.append(dict_blob)
        host_spans += [dst + base, dln]
        max_len = max(max_len, dmx)
    # per-value (start, len) streams in page order; consecutive PLAIN pages
    # coalesce into one host run (many small pages, one copy)
    order: list = []  # ("host", starts, lens) | ("dict", page)
    for i, p in enumerate(chunk.pages):
        if p.ndef == 0:
            continue
        if p.kind == "plain":
            st, ln, mx = _byte_array_scan(np.frombuffer(p.payload, np.uint8),
                                          p.ndef)
            max_len = max(max_len, mx)
            if order and order[-1][0] == "host":
                order[-1][1].append(st + plain_bases[i])
                order[-1][2].append(ln)
            else:
                order.append(("host", [st + plain_bases[i]], [ln]))
        else:
            order.append(("dict", p))
    host_spans.append(np.concatenate(blob_parts) if blob_parts
                      else np.zeros(1, np.uint8))
    runs = [np.concatenate(o[1]) for o in order if o[0] == "host"] + \
        [np.concatenate(o[2]) for o in order if o[0] == "host"]
    shipped = _ship(host_spans + runs, device)
    if has_dict:
        dict_starts, dict_lens = shipped[0], shipped[1]
        shipped = shipped[2:]
    blob = shipped[0]
    nhost = (len(shipped) - 1) // 2
    host_st, host_ln = shipped[1:1 + nhost], shipped[1 + nhost:]
    st_parts, ln_parts, h = [], [], 0
    for o in order:
        if o[0] == "host":
            st_parts.append(host_st[h])
            ln_parts.append(host_ln[h])
            h += 1
        else:
            idx = _expand_indices(o[1], chunk.dict_count, device)
            st_parts.append(dict_starts[idx])
            ln_parts.append(dict_lens[idx])
    starts = _cat(st_parts, torch.zeros(0, dtype=torch.int64, device=device))
    lens = _cat(ln_parts, torch.zeros(0, dtype=torch.int32, device=device))
    starts, lens = _pad_rows(starts, cap), _pad_rows(lens, cap)
    if max_len > hw:
        return _assemble_long_strings(dt, blob, starts, lens, defined, hw)
    matrix, lengths = _gather_strings(blob, starts, lens, defined,
                                      width_bucket(max_len))
    return Column(dt, matrix, defined, lengths)


def _assemble_long_strings(dt, blob, starts, lens, defined, hw: int
                           ) -> Column:
    """The long-string layout from value spans (JAX
    `_assemble_long_strings`): the head bytes through the flat gather at
    the head width, the bytes past it into the tail blob, value by value
    in row order, tail_start their exclusive cumsum. starts/lens hold one
    entry per defined value, rows map to values by their rank."""
    cap = defined.shape[0]
    head, lengths = _gather_strings(blob, starts, lens, defined, hw)
    tail_lens = torch.clamp(lengths.to(torch.int64) - hw, min=0)
    rank = (torch.cumsum(defined.to(torch.int32), 0) - 1).clamp(0, cap - 1)
    row_starts = starts[rank] + hw
    stream, _ = tail_byte_stream(blob, row_starts, tail_lens)
    total = int(stream.shape[0])
    tail_blob = torch.zeros(blob_bucket(total), dtype=torch.uint8,
                            device=blob.device)
    tail_blob[:total] = stream
    return Column(dt, head, defined, lengths,
                  (tail_blob, tail_starts_for(tail_lens)))


# -- the packed decode: one column's decode from the ship-order iterator ------

def _col_sig(w) -> tuple:
    m = w.meta
    return (w.kind, w.phys, w.spec.post, w.spec.flen, w.defruns is not None,
            m["has_dict_vals"], m["dict_count"], tuple(m["segs"]),
            m["has_plain"], w.dt.simple_string())


def _read_idx(it, segs, device):
    """Dictionary-index expansion over a column's segments: int64 [ndef],
    or None when the column has no dictionary-coded values (JAX
    `_read_idx_traced`)."""
    parts = []
    for bw, ndef, has_runs in segs:
        if not has_runs:
            parts.append(torch.zeros(ndef, dtype=torch.int64, device=device))
            continue
        runs = [next(it) for _ in range(5)]
        parts.append(_expand_rle(*runs, row_bucket(ndef), bw)[:ndef])
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _defined(it, has_def: bool, cap: int, nrows: int, device):
    if has_def:
        return _expand_def_levels(*[next(it) for _ in range(5)], cap)
    return torch.arange(cap, device=device) < nrows


def _decode_col(colsig, cap: int, nrows: int, it, device):
    """Decode ONE column from the ship-order tensor iterator `it` (JAX
    `_traced_decode_col`); shared by the per-row-group and the packed
    multi-chunk decode. Returns (data, validity, lengths or None)."""
    if colsig[0] == "string":
        return _decode_string_col(colsig, cap, nrows, it, device)
    (kind, phys, post, flen, has_def, has_dict, dict_count, segs, has_plain,
     dt_name) = colsig
    defined = _defined(it, has_def, cap, nrows, device)
    is_bool = phys == "BOOLEAN"
    dict_vals = next(it) if has_dict else None
    idx = _read_idx(it, segs, device)
    pieces = []
    if idx is not None:
        idx = idx.clamp(0, max(dict_count - 1, 0))
        pieces.append(dict_vals[idx])
    if has_plain:
        pieces.append(next(it))
    dt = T.parse_type(dt_name)
    if kind == "flba":
        mat = _cat(pieces, torch.zeros((0, flen), dtype=torch.uint8,
                                       device=device))
        vals = _flba_values(_pad_rows(mat, cap), post, flen)
        data, validity = _scatter_values(vals, defined)
        return _engine_data(data, dt), validity, None
    tdt = torch.bool if is_bool else _NP_TO_TORCH[np.dtype(_PHYS_TO_NP[phys])]
    vals = _cat(pieces, torch.zeros(0, dtype=tdt, device=device))
    data, validity = _scatter_values(_pad_rows(vals, cap), defined)
    return _engine_data(data, dt, post), validity, None


def _decode_string_col(colsig, cap: int, nrows: int, it, device):
    """String fast path (JAX `_traced_decode_string`): the expanded
    dictionary indices gather (start, len) spans out of the dictionary's
    span tables, the PLAIN suffix's spans arrive host-scanned, and one
    `_gather_strings` builds the byte matrix from the shipped blob."""
    (_, has_def, has_dict, dict_count, segs, has_plain, _,
     width) = colsig
    defined = _defined(it, has_def, cap, nrows, device)
    st_parts, ln_parts = [], []
    if has_dict:
        dst = next(it)
        dln = next(it)
        idx = _read_idx(it, segs, device)
        if idx is not None:
            idx = idx.clamp(0, max(dict_count - 1, 0))
            st_parts.append(dst[idx])
            ln_parts.append(dln[idx])
    if has_plain:
        st_parts.append(next(it))
        ln_parts.append(next(it))
    blob = next(it)
    starts = _cat(st_parts, torch.zeros(0, dtype=torch.int64, device=device))
    lens = _cat(ln_parts, torch.zeros(0, dtype=torch.int32, device=device))
    matrix, lengths = _gather_strings(blob, _pad_rows(starts, cap),
                                      _pad_rows(lens, cap), defined, width)
    return matrix, defined, lengths


def _string_sig_from(meta: dict, w) -> tuple:
    return ("string", w.defruns is not None, meta["has_dict_vals"],
            meta["dict_count"], tuple(meta["segs"]), meta["has_plain"],
            meta["plain_ndef"], meta["width"])


def _prep_string(chunk: _Chunk):
    """Host half of the string fast path: dictionary-prefix + PLAIN-suffix
    layouts only. The blob holds the PLAIN payloads in page order and the
    dictionary at the end; span tables come from the native offset scan.
    Returns (ship, meta), meta["max_len"] the longest value, or None for
    another page interleaving."""
    ndict = _dict_prefix(chunk)
    if ndict is None:
        return None
    plain_pages = [p for p in chunk.pages[ndict:] if p.ndef]
    blob_parts = [np.frombuffer(p.payload, np.uint8) for p in plain_pages]
    plain_bases, base = [], 0
    for p in plain_pages:
        plain_bases.append(base)
        base += len(p.payload)
    max_len = 1
    ship: List[np.ndarray] = []
    meta = {"segs": [], "dict_count": chunk.dict_count,
            "has_dict_vals": False, "has_plain": False, "plain_ndef": 0}
    segs = _dict_segments(chunk.pages[:ndict])  # pages defining a value
    if segs:
        if chunk.dict_raw is None or not chunk.dict_count:
            raise DeviceDecodeUnsupported("dict page missing values")
        dict_blob = np.frombuffer(chunk.dict_raw, np.uint8)
        dst, dln, dmx = _byte_array_scan(dict_blob, chunk.dict_count)
        blob_parts.append(dict_blob)
        max_len = max(max_len, dmx)
        ship.append((dst + base).astype(np.int64))
        ship.append(dln.astype(np.int32))
        meta["has_dict_vals"] = True
        for bw, ndef, runs in segs:
            meta["segs"].append((bw, ndef, runs is not None))
            if runs is not None:
                ship.extend(_pad_runs(runs))
    if plain_pages:
        st_parts, ln_parts = [], []
        for p, pb in zip(plain_pages, plain_bases):
            st, ln, mx = _byte_array_scan(np.frombuffer(p.payload, np.uint8),
                                          p.ndef)
            max_len = max(max_len, mx)
            st_parts.append(st + pb)
            ln_parts.append(ln)
        ship.append(np.concatenate(st_parts).astype(np.int64))
        ship.append(np.concatenate(ln_parts).astype(np.int32))
        meta["has_plain"] = True
        meta["plain_ndef"] = sum(p.ndef for p in plain_pages)
    ship.append(np.concatenate(blob_parts) if blob_parts
                else np.zeros(1, np.uint8))
    meta["max_len"] = max_len
    meta["width"] = width_bucket(max_len)
    return ship, meta


# -- fused MULTI-CHUNK decode -------------------------------------------------

def _fused_multi_decode(groups_sig, caps, cap_total: int, nrows, packed,
                        device):
    """Decode SEVERAL row-group chunks out of one shipped buffer and merge
    them into one batch's columns (JAX `_fused_multi_program`). Global row
    j maps to (chunk, row within it) by a searchsorted over the cumulative
    row counts: the rank gather. Returns (data, validity, lengths or None)
    per column."""
    nchunks = len(groups_sig)
    ncols = len(groups_sig[0][0])
    per_col = [[] for _ in range(ncols)]
    for c_i, (colsigs, metas) in enumerate(groups_sig):
        it = iter([_unpack(packed, m) for m in metas])
        for ci, colsig in enumerate(colsigs):
            per_col[ci].append(_decode_col(colsig, caps[c_i], nrows[c_i], it,
                                           device))
    total = int(sum(nrows))
    if nchunks == 1 and caps[0] == cap_total:
        return [cols[0] for cols in per_col]  # already one batch's columns
    cum = torch.tensor(np.cumsum(nrows), dtype=torch.int64, device=device)
    chunk_base = torch.tensor(np.concatenate(([0], np.cumsum(caps)[:-1])),
                              dtype=torch.int64, device=device)
    j = torch.arange(cap_total, dtype=torch.int64, device=device)
    c_of_j = torch.searchsorted(cum, j, right=True).clamp_(0, nchunks - 1)
    base = torch.where(c_of_j > 0, cum[(c_of_j - 1).clamp(min=0)], 0)
    src = chunk_base[c_of_j] + (j - base)
    live = j < total
    outs = []
    for cols in per_col:
        datas = [d for d, _, _ in cols]
        if datas[0].dim() == 2:  # string byte matrices: pad to one width
            w = max(d.shape[1] for d in datas)
            datas = [torch.nn.functional.pad(d, (0, w - d.shape[1]))
                     if d.shape[1] < w else d for d in datas]
        data = torch.cat(datas)
        gsrc = src.clamp(0, data.shape[0] - 1)
        valid = torch.cat([v for _, v, _ in cols])[gsrc] & live
        lens = None
        if cols[0][2] is not None:
            lens = torch.cat([ln for _, _, ln in cols])
            lens = torch.where(live, lens[gsrc], 0)
        outs.append((data[gsrc], valid, lens))
    return outs


def _read_chunks(pf, f, rgs, schema, host_cols=()):
    """Host phase of a dispatch group: every row group's chunks parsed once
    -> ([(rg, works, nrows)], total rows)."""
    chunks, total = [], 0
    for rg in rgs:
        works, nrows = _host_phase(pf, f, rg, schema, host_cols)
        chunks.append((rg, works, nrows))
        total += nrows
    return chunks, total


def _group_signatures(chunks, names, hw: int):
    """Fast-path prep of a whole dispatch group: per-chunk column sigs and
    the single packed buffer -> (groups_sig, caps, packed), or None when a
    column of a chunk declines the fast path."""
    groups_sig, caps, bounds = [], [], []
    all_arrays: List[np.ndarray] = []
    for _, works, nrows in chunks:
        caps.append(row_bucket(nrows))
        colsigs = []
        arrays: List[np.ndarray] = []
        for name in names:
            w = works[name]
            ship, meta = w.ship, w.meta
            if ship is None and w.kind == "string":
                # local only: `works` stays as it was, so the per-row-group
                # decode assembles the string eagerly
                prepped = _prep_string(w.chunk)
                # past the head: the eager assemble's long-string layout
                if prepped is not None and prepped[1]["max_len"] <= hw:
                    ship, meta = prepped
            if ship is None:
                return None
            colsigs.append(_string_sig_from(meta, w) if w.kind == "string"
                           else _col_sig(w))
            if w.defruns is not None:
                arrays.extend(w.defruns)
            arrays.extend(ship)
        bounds.append(len(all_arrays))
        all_arrays.extend(arrays)
        groups_sig.append(tuple(colsigs))
    packed, metas = _pack_arrays(all_arrays)
    bounds.append(len(all_arrays))
    groups_sig = tuple((cs, metas[bounds[i]:bounds[i + 1]])
                       for i, cs in enumerate(groups_sig))
    return groups_sig, caps, packed


def decode_row_groups_fused(pf, f, rgs, schema, device: torch.device,
                            host_cols=(), head: Optional[int] = None):
    """Decode SEVERAL row groups as one dispatch group -> [(ColumnarBatch,
    rows)]. When every device column of every chunk takes a fast-path prep
    the group ships in ONE packed copy and the list holds one merged batch,
    the host columns decoded by one pyarrow read of the group and merged at
    its capacity; a declined layout decodes row group by row group from the
    same host work (no host step repeats). A string column past `head`
    bytes (the default conf's head width when None) takes the long-string
    layout."""
    hw = head_width() if head is None else head
    chunks, total = _read_chunks(pf, f, rgs, schema, host_cols)
    return _decode_chunks_fused(pf, schema, chunks, total, device, host_cols,
                                hw)


def _per_rg_batches(pf, schema, chunks, device, host_cols, hw: int,
                    declined: bool = True):
    """Per-row-group decode from the same works: no second host phase."""
    out = [_device_phase(pf, rg, schema, works, nrows, device, host_cols, hw)
           for rg, works, nrows in chunks]
    COUNTERS.add(scan_chunks=len(out), declined_chunks=len(out) * declined)
    return out


def _decode_chunks_fused(pf, schema, chunks, total: int, device,
                         host_cols, hw: int):
    names = [n for n in schema.names if n not in host_cols]
    if not names or total == 0:
        return _per_rg_batches(pf, schema, chunks, device, host_cols, hw,
                               declined=False)
    sig = _group_signatures(chunks, names, hw)
    if sig is None:
        return _per_rg_batches(pf, schema, chunks, device, host_cols, hw)
    groups_sig, caps, packed = sig
    cap_total = row_bucket(total)
    dev = torch.from_numpy(packed).to(device)
    outs = _fused_multi_decode(groups_sig, caps, cap_total,
                               [n for _, _, n in chunks], dev, device)
    by_name = dict(zip(schema.names, schema.types))
    cols = {n: Column(by_name[n], data, validity, lengths)
            for n, (data, validity, lengths) in zip(names, outs)}
    cols.update(_host_decode_cols(pf, [rg for rg, _, _ in chunks], schema,
                                  host_cols, cap_total, total, device, hw))
    COUNTERS.add(h2d_copies=1, h2d_bytes=int(packed.nbytes),
                 fused_dispatches=1, scan_chunks=len(chunks))
    return [(ColumnarBatch(schema, tuple(cols[n] for n in schema.names),
                           torch.tensor(total, dtype=torch.int32,
                                        device=device)), total)]


def device_decode_file(pf, path: str, schema, device: torch.device,
                       chunks_per_dispatch: int = 1, rgs=None,
                       host_cols=(), host_fallback=None,
                       head: Optional[int] = None) -> Iterator:
    """Yield (ColumnarBatch, row count) per dispatch group of the file's
    row groups (all of them, or `rgs`), one group live at a time, the
    columns `host_cols` decoded by pyarrow. `chunks_per_dispatch` > 1
    decodes that many row groups per packed dispatch, and a group that
    fails decodes again row group by row group; 1 decodes row group by row
    group. Without `host_fallback`, a group fails on DeviceDecodeUnsupported
    and a row group's raises it. With it, a group or row group fails on
    FALLBACK_ERRORS, and `host_fallback(rg) -> (batch, rows)` decodes the
    failed row group. A failed attempt counts nothing (COUNTERS.staged).
    A string column past `head` bytes (the default conf's head width when
    None) takes the long-string layout."""
    net = DeviceDecodeUnsupported if host_fallback is None \
        else FALLBACK_ERRORS
    group = max(int(chunks_per_dispatch), 1)
    if rgs is None:
        rgs = range(pf.metadata.num_row_groups)
    rgs = list(rgs)
    with open(path, "rb") as f:
        for i in range(0, len(rgs), group):
            chunk_rgs = rgs[i:i + group]
            if len(chunk_rgs) > 1:
                try:
                    with COUNTERS.staged():
                        outs = decode_row_groups_fused(
                            pf, f, chunk_rgs, schema, device, host_cols,
                            head)
                except net:
                    pass  # row group by row group below
                else:
                    yield from outs
                    continue
            for rg in chunk_rgs:
                try:
                    with COUNTERS.staged():
                        out = decode_row_group(pf, f, rg, schema, device,
                                               host_cols, head)
                except net:
                    if host_fallback is None:
                        raise
                    out = host_fallback(rg)
                yield out


# -- scan pushdown: compute on the compressed data ----------------------------
# The pushed spec (plan/scan_pushdown.py) inside the packed multi-chunk
# decode (JAX `_pushdown_select_program` and `_pushdown_gather_program`,
# written over this module's own ship order): the select step tests each
# pushed leaf once per DICTIONARY VALUE and maps the verdict over the
# expanded indices, and tests PLAIN streams value by value, so the row mask
# needs no decoded column; pushed count/min/max/sum reduce over the mask.
# The gather step then decodes only the projected columns and keeps only
# the surviving rows, at the survivors' row bucket; a string column's byte
# gather reads the survivors' spans straight out of the shipped buffer.
# Leaves evaluate with the port's own expression classes over a batch of
# the column's values, so comparison, promotion, decimal, NaN and IN
# semantics are the unpushed filter's.


def _colsig_array_count(colsig) -> int:
    """How many shipped arrays one column takes, in ship order (the
    reads of `_decode_col` and `_decode_string_col`)."""
    if colsig[0] == "string":
        (_, has_def, has_dict, _dc, segs, has_plain, _pn, _w) = colsig
        return 5 * has_def + (2 + 5 * sum(hr for _, _, hr in segs)) \
            * has_dict + 2 * has_plain + 1
    (_k, _p, _post, _flen, has_def, has_dict, _dc, segs, has_plain,
     _dt) = colsig
    return 5 * has_def + has_dict + 5 * sum(hr for _, _, hr in segs) + \
        has_plain


def _col_arrays(colsigs, metas, names, packed, cap: int, nrows: int):
    """{column: _ChunkColumn} of one chunk."""
    arrays = [_unpack(packed, m) for m in metas]
    out, off = {}, 0
    for name, cs in zip(names, colsigs):
        cnt = _colsig_array_count(cs)
        out[name] = _ChunkColumn(cs, arrays[off:off + cnt],
                                 metas[off:off + cnt], cap, nrows)
        off += cnt
    # the count mirrors the ship order: a drift must fail here, not test
    # a predicate over shifted arrays
    assert off == len(arrays), (off, len(arrays))
    return out


def _engine_values(colsig, arr: torch.Tensor) -> torch.Tensor:
    """A dense stream of raw shipped values (a dictionary or a PLAIN run)
    as the engine type's values: `_decode_col`'s conversions."""
    (kind, _p, post, flen, _hd, _hdict, _dc, _s, _hp, dt_name) = colsig
    dt = T.parse_type(dt_name)
    if kind == "flba":
        return _engine_data(_flba_values(arr, post, flen), dt)
    return _engine_data(arr, dt, post)


def _eval_leaf(expr, dt, data, lengths=None) -> torch.Tensor:
    """One pushed leaf over a dense, all-valid value stream: bool[n] of
    the values it holds for."""
    from ..expr.base import EvalContext, Vec
    ones = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    res = expr.eval(EvalContext(ones), [Vec(dt, data, ones, lengths)])
    return res.data & res.validity


class _ChunkColumn:
    """One chunk's column of a pushdown dispatch: its shipped arrays, read
    once into the compressed form (`pieces`) for the select step and
    again for the gather or the aggregates."""

    __slots__ = ("colsig", "arrays", "metas", "cap", "nrows", "_pieces",
                 "_rank")

    def __init__(self, colsig, arrays, metas, cap: int, nrows: int):
        self.colsig, self.arrays, self.metas = colsig, arrays, metas
        self.cap, self.nrows = cap, nrows
        self._pieces = self._rank = None

    def pieces(self, device, width: int = 0):
        """(defined, [(values, lengths or None, expanded indices or
        None)]): the dictionary's values (its indices beside them) and
        then the PLAIN run's, each in the engine type; strings as whole
        values at `width` bytes (the packed path takes a string column
        only within the head width)."""
        if self._pieces is None:
            self._pieces = _value_pieces(self.colsig, self.cap, self.nrows,
                                         self.arrays, device, width)
        return self._pieces

    def rank(self, device) -> torch.Tensor:
        """Each row's value ordinal, cumsum(defined) - 1 clamped."""
        if self._rank is None:
            defined = self.pieces(device)[0]
            self._rank = (torch.cumsum(defined.to(torch.int32), 0) - 1
                          ).clamp(0, self.cap - 1)
        return self._rank


def _value_pieces(colsig, cap: int, nrows: int, arrays, device,
                  width: int):
    it = iter(arrays)
    if colsig[0] == "string":
        (_, has_def, has_dict, dict_count, segs, has_plain, plain_ndef,
         _w) = colsig
    else:
        (_k, _p, _post, _flen, has_def, has_dict, dict_count, segs,
         has_plain, _dt) = colsig
    defined = _defined(it, has_def, cap, nrows, device)
    pieces = []
    if colsig[0] == "string":
        ones = torch.ones(max(dict_count, plain_ndef), dtype=torch.bool,
                          device=device)
        if has_dict:
            dst, dln = next(it), next(it)
            idx = _read_idx(it, segs, device)
        if has_plain:
            pst, pln = next(it), next(it)
        blob = next(it)
        if has_dict and idx is not None:
            pieces.append(_string_matrix_tail(
                blob, dst, dln, ones[:dict_count], width) +
                (idx.clamp(0, dict_count - 1),))
        if has_plain:
            pieces.append(_string_matrix_tail(
                blob, pst, pln, ones[:plain_ndef], width) + (None,))
        return defined, pieces
    dict_raw = next(it) if has_dict else None
    idx = _read_idx(it, segs, device)
    if dict_raw is not None and idx is not None:
        pieces.append((_engine_values(colsig, dict_raw), None,
                       idx.clamp(0, max(dict_count - 1, 0))))
    if has_plain:
        pieces.append((_engine_values(colsig, next(it)), None, None))
    return defined, pieces


def _leaf_rows(cols, dt, leaves, device, width: int):
    """{leaf: [bool[cap] per chunk]}: each leaf of one column (`cols`, its
    _ChunkColumn in each chunk) evaluated once over the values of every
    chunk's dictionary and PLAIN run, concatenated, then mapped to rows
    (a dictionary's verdict by its expanded indices; each value to its
    row by null rank; false on null rows)."""
    per_chunk = [c.pieces(device, width) for c in cols]
    pieces = [p for _, ps in per_chunk for p in ps]
    if not pieces:
        return {li: [d & False for d, _ in per_chunk] for li, _ in leaves}
    sizes = [p[0].shape[0] for p in pieces]
    values = _cat([p[0] for p in pieces], None)
    lengths = None if pieces[0][1] is None else \
        _cat([p[1] for p in pieces], None)
    out = {}
    for li, expr in leaves:
        verdicts = iter(torch.split(_eval_leaf(expr, dt, values, lengths),
                                    sizes))
        rows = []
        for c, (defined, ps) in zip(cols, per_chunk):
            dense = [v if idx is None else v[idx]
                     for (_, _, idx), v in zip(ps, verdicts)]
            dense = _cat(dense, torch.zeros(0, dtype=torch.bool,
                                            device=device))
            rows.append(_pad_rows(dense, c.cap)[c.rank(device)] & defined)
        out[li] = rows
    return out


def _string_spans(colsig, cap: int, nrows: int, arrays, device):
    """A string column's per-row (start, length) spans into its blob and
    its defined mask, without the byte gather."""
    (_, has_def, has_dict, dict_count, segs, has_plain, _pn, _w) = colsig
    it = iter(arrays)
    defined = _defined(it, has_def, cap, nrows, device)
    st_parts, ln_parts = [], []
    if has_dict:
        dst, dln = next(it), next(it)
        idx = _read_idx(it, segs, device)
        if idx is not None:
            idx = idx.clamp(0, max(dict_count - 1, 0))
            st_parts.append(dst[idx])
            ln_parts.append(dln[idx])
    if has_plain:
        st_parts.append(next(it))
        ln_parts.append(next(it))
    starts = _cat(st_parts, torch.zeros(0, dtype=torch.int64, device=device))
    lens = _cat(ln_parts, torch.zeros(0, dtype=torch.int32, device=device))
    st_row, _ = _scatter_values(_pad_rows(starts, cap), defined)
    ln_row, _ = _scatter_values(_pad_rows(lens, cap), defined)
    return st_row, ln_row, defined


def _comb_tree(tree, leaf_rows, defined_by):
    op = tree[0]
    if op == "and":
        return _comb_tree(tree[1], leaf_rows, defined_by) & \
            _comb_tree(tree[2], leaf_rows, defined_by)
    if op == "or":
        return _comb_tree(tree[1], leaf_rows, defined_by) | \
            _comb_tree(tree[2], leaf_rows, defined_by)
    if op == "leaf":
        return leaf_rows[tree[1]]
    if op == "isnull":  # the caller ands the live rows in
        return ~defined_by[tree[1]]
    return defined_by[tree[1]]


def _null_test_cols(tree, out: set) -> set:
    if tree is not None and tree[0] in ("and", "or"):
        _null_test_cols(tree[1], out)
        _null_test_cols(tree[2], out)
    elif tree is not None and tree[0] in ("isnull", "notnull"):
        out.add(tree[1])
    return out


def _merge_index(nrows, caps, cap_total: int, rows: torch.Tensor):
    """Global rows -> their positions in the chunks' concatenated arrays
    (the rank gather of `_fused_multi_decode`)."""
    device = rows.device
    cum = torch.tensor(np.cumsum(nrows), dtype=torch.int64, device=device)
    chunk_base = torch.tensor(np.concatenate(([0], np.cumsum(caps)[:-1])),
                              dtype=torch.int64, device=device)
    c_of = torch.searchsorted(cum, rows, right=True).clamp_(0, len(caps) - 1)
    base = torch.where(c_of > 0, cum[(c_of - 1).clamp(min=0)], 0)
    return chunk_base[c_of] + (rows - base)


def _pushdown_select(chunk_cols, dev, dt_by_name, device):
    """Per chunk: the rows that pass (bool[cap]) and, for the pushed
    aggregates, {column: (data or None, validity)} (a column only
    counted needs its defined mask)."""
    leaves_by_col = {}
    for li, (cname, expr) in enumerate(dev.leaves):
        leaves_by_col.setdefault(cname, []).append((li, expr))
    defined_by = [{} for _ in chunk_cols]
    leaf_rows = [{} for _ in chunk_cols]
    for name in sorted(set(leaves_by_col) | _null_test_cols(dev.tree,
                                                            set())):
        cols = [chunk[name] for chunk in chunk_cols]
        width = max(c.colsig[-1] for c in cols) \
            if cols[0].colsig[0] == "string" else 0
        for c_i, c in enumerate(cols):
            defined_by[c_i][name] = c.pieces(device, width)[0]
        for li, rows in _leaf_rows(cols, dt_by_name[name],
                                   leaves_by_col.get(name, ()), device,
                                   width).items():
            for c_i, r in enumerate(rows):
                leaf_rows[c_i][li] = r
    keeps, chunk_vals = [], []
    for c_i, chunk in enumerate(chunk_cols):
        c0 = next(iter(chunk.values()))
        keep = torch.arange(c0.cap, device=device) < c0.nrows
        if dev.tree is not None:
            keep = keep & _comb_tree(dev.tree, leaf_rows[c_i],
                                     defined_by[c_i])
        keeps.append(keep)
        vals = {}
        for name in {a.column for a in dev.aggs if a.op != "count"}:
            v, pos, d = _value_index(chunk[name], device)
            vals[name] = (v[pos], d)
        for name in {a.column for a in dev.aggs if a.op == "count"}:
            if name is None or name in vals:
                continue
            d = defined_by[c_i].get(name)
            if d is None:
                c = chunk[name]
                d = _defined(iter(c.arrays), c.colsig[1]
                             if c.colsig[0] == "string" else c.colsig[4],
                             c.cap, c.nrows, device)
            vals[name] = (None, d)
        chunk_vals.append(vals)
    return keeps, chunk_vals


def _pushdown_aggregate(dev, keeps, chunk_vals, device):
    """The pushed aggregates' one-row partial batch over every chunk."""
    from ..plan.scan_pushdown import reduce_partial
    values = []
    for a in dev.aggs:
        parts = []
        for keep, vals in zip(keeps, chunk_vals):
            if a.column is None:
                parts.append(reduce_partial("count", None, keep))
                continue
            data, validity = vals[a.column]
            parts.append(reduce_partial(a.op, data, keep & validity))
        val, valid = parts[0]
        for v, ok in parts[1:]:
            val = torch.minimum(val, v) if a.op == "min" else \
                torch.maximum(val, v) if a.op == "max" else val + v
            valid = valid | ok
        values.append((val, valid))
    return dev.applier.partials(values, device)


def _value_index(col: _ChunkColumn, device):
    """A fixed-width column of one chunk as (values, pos, defined): row
    r's value is values[pos[r]] where defined[r]. The values are the
    dictionary's and then the PLAIN run's, already in the engine type
    (`_ChunkColumn.pieces`), so the conversion runs over the dictionary
    and a row costs one gather."""
    defined, pieces = col.pieces(device)
    if not pieces:  # nothing defined in the chunk
        dt = T.parse_type(col.colsig[-1])
        shape = (1, 2) if T.is_dec128(dt) else (1,)
        return (torch.zeros(shape, dtype=torch_dtype(dt), device=device),
                torch.zeros(col.cap, dtype=torch.int64, device=device),
                defined)
    rank = col.rank(device).to(torch.int64)
    vals, _, idx = pieces[0]
    if idx is None:  # PLAIN values only
        pos = rank
    else:
        n_idx = idx.shape[0]
        pos = torch.where(rank < n_idx, idx[rank.clamp(max=n_idx - 1)],
                          vals.shape[0] + rank - n_idx)
    return _cat([p[0] for p in pieces], None), pos, defined


def _pushdown_gather(chunk_cols, caps, nrows, cap_total: int, keep_g,
                     kept: int, dev, dt_by_name, packed, device):
    """The surviving rows of the projected columns, at the survivors' row
    bucket: a fixed-width column gathers the survivors' values out of its
    chunks' dictionary and PLAIN values (`_value_index`); a string column
    gathers only the survivors' bytes."""
    out_cap = row_bucket(max(kept, 1))
    sel = torch.sort((~keep_g).to(torch.int8), stable=True).indices[:out_cap]
    live = torch.arange(out_cap, device=device) < kept
    src = _merge_index(nrows, caps, cap_total, sel)
    merged = {}
    for name in sorted({s for _, s in dev.columns}):
        per = [cols[name] for cols in chunk_cols]
        if dt_by_name[name] == T.STRING:
            sts, lns, defs = [], [], []
            for c in per:
                st, ln, d = _string_spans(c.colsig, c.cap, c.nrows,
                                          c.arrays, device)
                sts.append(st + c.metas[-1][2])  # the blob's packed offset
                lns.append(ln)
                defs.append(d)
            st, ln, d = torch.cat(sts), torch.cat(lns), torch.cat(defs)
            g = src.clamp(0, st.shape[0] - 1)
            valid = d[g] & live
            width = max(c.colsig[-1] for c in per)
            mat, lengths = _string_matrix_tail(packed, st[g], ln[g], valid,
                                               width)
            merged[name] = (mat, valid, lengths)
            continue
        vals, poss, defs, base = [], [], [], 0
        for c in per:
            v, pos, d = _value_index(c, device)
            vals.append(v)
            poss.append(pos + base)
            defs.append(d)
            base += v.shape[0]
        pos, d = torch.cat(poss), torch.cat(defs)
        g = src.clamp(0, pos.shape[0] - 1)
        merged[name] = (torch.cat(vals)[pos[g]], d[g] & live, None)
    cols = tuple(Column(dt, *merged[s])
                 for (_, s), dt in zip(dev.columns, dev.out_schema.types))
    return ColumnarBatch(dev.out_schema, cols, torch.tensor(
        kept, dtype=torch.int32, device=device))


def decode_row_groups_pushdown(pf, f, rgs, schema, device: torch.device,
                               host_cols, dev, head: Optional[int] = None):
    """Decode a dispatch group of row groups under a pushed spec (`dev`, a
    plan.scan_pushdown.DevicePushdown) -> [(batch, output rows, input
    rows, rows kept, bytes materialised)]. With no host column and every
    chunk on the packed path, the group ships in one copy, the predicate
    runs on the compressed form and only survivors (or the aggregate
    partials, no row data) are built; otherwise the group decodes whole
    and the applier takes each batch (`_pushdown_degrade`). A malformed
    group raises DeviceDecodeUnsupported for the caller's net."""
    hw = head_width() if head is None else head
    chunks, total = _read_chunks(pf, f, rgs, schema, host_cols)
    names = [n for n in schema.names if n not in host_cols]
    tried = not host_cols and bool(names) and total > 0
    sig = _group_signatures(chunks, names, hw) if tried else None
    if sig is None:
        return _pushdown_degrade(pf, schema, chunks, total, device,
                                 host_cols, dev, hw, sig_declined=tried)
    groups_sig, caps, packed = sig
    packed_dev = torch.from_numpy(packed).to(device)
    COUNTERS.add(h2d_copies=1, h2d_bytes=int(packed.nbytes),
                 fused_dispatches=1, scan_chunks=len(chunks))
    nrows = [n for _, _, n in chunks]
    dt_by_name = dict(zip(schema.names, schema.types))
    chunk_cols = [_col_arrays(cs, metas, names, packed_dev, cap, n)
                  for (cs, metas), cap, n in zip(groups_sig, caps, nrows)]
    keeps, chunk_vals = _pushdown_select(chunk_cols, dev, dt_by_name,
                                         device)
    if dev.aggs:
        batch = _pushdown_aggregate(dev, keeps, chunk_vals, device)
        kept = int(sum(k.sum(dtype=torch.int64) for k in keeps))
        return [(batch, 1, total, kept, 0)]
    cap_total = row_bucket(total)
    j = torch.arange(cap_total, dtype=torch.int64, device=device)
    keep_cat = keeps[0] if len(keeps) == 1 else torch.cat(keeps)
    src = _merge_index(nrows, caps, cap_total, j)
    keep_g = keep_cat[src.clamp(0, keep_cat.shape[0] - 1)] & (j < total)
    kept = int(keep_g.sum())
    batch = _pushdown_gather(chunk_cols, caps, nrows, cap_total, keep_g,
                             kept, dev, dt_by_name, packed_dev, device)
    return [(batch, kept, total, kept, int(batch.device_memory_size()))]


def _pushdown_degrade(pf, schema, chunks, total: int, device, host_cols,
                      dev, hw: int, sig_declined: bool = False):
    """The group decoded whole (packed or row group by row group, from the
    same host work) and each batch through the exact applier.
    `sig_declined`: the packed path already declined, so go row group by
    row group at once."""
    inner = _per_rg_batches(pf, schema, chunks, device, host_cols, hw) \
        if sig_declined else \
        _decode_chunks_fused(pf, schema, chunks, total, device, host_cols,
                             hw)
    outs = []
    for b, nrows in inner:
        in_bytes = int(b.device_memory_size())
        ob, kept = dev.applier.apply(b)
        outs.append((ob, 1 if dev.aggs else kept, nrows, kept, in_bytes))
    return outs


def device_decode_pushdown(pf, path: str, schema, device: torch.device, dev,
                           chunks_per_dispatch: int = 1, rgs=None,
                           host_cols=(), host_fallback=None,
                           head: Optional[int] = None) -> Iterator:
    """`device_decode_file` under a pushed spec: yield (batch, output
    rows, input rows, rows kept, bytes materialised) per dispatch group,
    each group through `decode_row_groups_pushdown`; a group that fails
    decodes row group by row group (a declined one by `host_fallback`)
    and each batch goes through the applier."""
    net = DeviceDecodeUnsupported if host_fallback is None \
        else FALLBACK_ERRORS
    group = max(int(chunks_per_dispatch), 1)
    rgs = list(range(pf.metadata.num_row_groups) if rgs is None else rgs)
    with open(path, "rb") as f:
        for i in range(0, len(rgs), group):
            chunk_rgs = rgs[i:i + group]
            try:
                with COUNTERS.staged():
                    outs = decode_row_groups_pushdown(
                        pf, f, chunk_rgs, schema, device, host_cols, dev,
                        head)
            except net:
                pass  # row group by row group below
            else:
                yield from outs
                continue
            for rg in chunk_rgs:
                try:
                    with COUNTERS.staged():
                        b, nrows = decode_row_group(pf, f, rg, schema,
                                                    device, host_cols, head)
                except net:
                    if host_fallback is None:
                        raise
                    b, nrows = host_fallback(rg)
                in_bytes = int(b.device_memory_size())
                ob, kept = dev.applier.apply(b)
                yield ob, (1 if dev.aggs else kept), nrows, kept, in_bytes
