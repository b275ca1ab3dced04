"""Device column vectors (`spark_rapids_tpu/columnar/column.py`, fixed-width
types and flat strings).

A `Column` is a plain dataclass of torch tensors on one device: a data
buffer and a bool validity mask, both padded to a capacity bucket (see
padding.py), plus int32 lengths for a STRING column. Rows at or beyond the
batch's logical row count are padding whose data AND validity contents are
unspecified; kernels mask with the batch row mask wherever padding could
leak into results. Data under null rows is unspecified too.

A STRING column is the JAX package's flat layout: data uint8[cap, w] with
w = width_bucket(longest value) and lengths int32[cap]. The bytes past each
row's length are zero, so equality, the hash and the sort keys may read the
whole row. Every operation that builds a byte matrix keeps that invariant.
A column whose longest value passes the head width
(`spark.rapids.tpu.string.headWidth`, columnar/strings.py) takes the
long-string layout instead: data is the uint8[cap, head] head matrix and
`overflow` holds (blob uint8[B], tail_start int32[cap]). The blob is not
aligned to rows: a row move maps every other buffer (`map_rows`) and
passes the blob through. `from_arrow` with `head=None` builds the flat
matrix at any width, which is what the host engine holds.

Fixed-width columns: BOOLEAN, BYTE (int8), SHORT (int16), INT, LONG,
FLOAT (float32), DOUBLE, DATE (int32 days), TIMESTAMP (int64 microseconds
since the epoch, UTC) and DECIMAL: of precision <= 18 the int64 unscaled
value, wider the JAX package's limb layout, int64[cap, 2] with the signed
high limb in column 0 and the low limb's bit pattern in column 1
(expr/decimal128.py). The nested types raise NotImplementedError at plan
time.

The Arrow round trip of a decimal is vectorised: Arrow's decimal128 holds
each value as 16 little-endian bytes of two's complement, that is the
(lo, hi) pair of int64 words read by a numpy view; a value of 18 digits or
fewer is its low word (the high one is its sign extension). The JAX
package converts one Python Decimal a row; the values are the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from .padding import row_bucket

__all__ = ["Column", "torch_dtype", "check_supported", "from_arrow",
           "to_arrow", "data_shape"]

_TORCH_DTYPES = {
    T.BooleanType: torch.bool,
    T.ByteType: torch.int8,
    T.ShortType: torch.int16,
    T.IntegerType: torch.int32,
    T.LongType: torch.int64,
    T.FloatType: torch.float32,
    T.DoubleType: torch.float64,
    T.DateType: torch.int32,
    T.TimestampType: torch.int64,
    T.DecimalType: torch.int64,  # the unscaled value, or its two limbs
    T.StringType: torch.uint8,
}

# microseconds per unit of an Arrow timestamp
_US_PER_UNIT = {"s": 1_000_000, "ms": 1_000, "us": 1}


def check_supported(dt: T.DataType, what: str = "column") -> None:
    if type(dt) not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"{what} type {dt.simple_string()} is not supported by "
            "spark_rapids_tpu_torch yet (it carries boolean, byte, short, "
            "int, long, float, double, date, timestamp, decimal and "
            "string)")


def torch_dtype(dt: T.DataType) -> torch.dtype:
    """The element type of the data buffer (uint8 bytes for STRING)."""
    check_supported(dt)
    return _TORCH_DTYPES[type(dt)]


def data_shape(dt: T.DataType, cap: int) -> tuple:
    """The data buffer's shape for a fixed-width type: [cap], or [cap, 2]
    for a decimal of more than 18 digits."""
    return (cap, 2) if T.is_dec128(dt) else (cap,)


@dataclasses.dataclass
class Column:
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor
    lengths: Optional[torch.Tensor] = None  # int32[cap], STRING only
    # the long-string layout (columnar/strings.py): (blob uint8[B],
    # tail_start int32[cap]); the blob is not aligned to rows
    overflow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return isinstance(self.dtype, T.StringType)

    def leaves(self) -> List[torch.Tensor]:
        """Every buffer: data, validity (, lengths) (, blob, tail_start)."""
        out = [self.data, self.validity]
        if self.lengths is not None:
            out.append(self.lengths)
        if self.overflow is not None:
            out.extend(self.overflow)
        return out

    @staticmethod
    def from_leaves(dtype: T.DataType, leaves, has_overflow: bool
                    ) -> "Column":
        """The column whose `leaves()` these are."""
        if has_overflow:
            *rows, blob, ts = leaves
            return Column(dtype, *rows, overflow=(blob, ts))
        return Column(dtype, *leaves)

    def map_rows(self, fn, blob_fn=None) -> "Column":
        """fn over every row-aligned buffer (tail_start included); the
        blob goes through blob_fn, or as it is (JAX `vec_map_arrays`)."""
        return Column(self.dtype, fn(self.data), fn(self.validity),
                      None if self.lengths is None else fn(self.lengths),
                      None if self.overflow is None else
                      ((blob_fn or (lambda b: b))(self.overflow[0]),
                       fn(self.overflow[1])))


def _pad_to(arr: np.ndarray, cap: int) -> np.ndarray:
    """Pad the leading dim to the capacity; always a writable array that
    torch may own (Arrow's zero-copy buffers are read-only)."""
    if arr.shape[0] == cap:
        return arr if arr.flags.writeable else arr.copy()
    return np.pad(arr, [(0, cap - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1))


def _string_leaves(arr, cap: int, head: Optional[int]):
    """Arrow string array -> (head or flat uint8[cap, w] zero-tailed
    bytes, int32[cap] lengths, overflow or None). With `head` None, the
    flat matrix at the longest value's width bucket; else the long-string
    layout once a value passes `head` bytes."""
    import pyarrow as pa
    from .strings import build_string_leaves
    if pa.types.is_string(arr.type):
        arr = arr.cast(pa.large_string())
    n = len(arr)
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int64, count=n + 1,
                            offset=arr.offset * 8)
    lens = np.diff(offsets)
    if arr.null_count:  # a null slot's bytes are not part of the matrix
        lens = np.where(np.asarray(arr.is_valid()), lens, 0)
    databuf = np.frombuffer(arr.buffers()[2], dtype=np.uint8) \
        if arr.buffers()[2] is not None else np.zeros(0, np.uint8)
    longest = int(lens.max()) if n else 0
    return build_string_leaves(databuf, offsets, lens.astype(np.int32), cap,
                               longest if head is None else head)


def _decimal_unscaled(arr, wide: bool) -> np.ndarray:
    """Arrow decimal128 array -> its unscaled values: int64 (the low word
    of each 16-byte value) for precision <= 18, else int64[n, 2] limbs
    (hi, lo); null slots hold 0."""
    n = len(arr)
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * (arr.offset + n)).reshape(-1, 2)
    words = words[arr.offset:]
    vals = words[:, ::-1] if wide else words[:, 0]
    if arr.null_count:
        valid = np.asarray(arr.is_valid())
        return np.where(valid[:, None] if wide else valid, vals, 0)
    return np.ascontiguousarray(vals)


def _decimal_array(vals: np.ndarray, valid: np.ndarray, dt: T.DecimalType):
    """Unscaled values (int64, or int64[n, 2] limbs hi, lo) -> Arrow
    decimal128 array: each value's low word, then its high word."""
    import pyarrow as pa
    words = np.empty((len(vals), 2), np.int64)
    if vals.ndim == 2:
        words[:, 0], words[:, 1] = vals[:, 1], vals[:, 0]
    else:
        words[:, 0] = vals
        words[:, 1] = vals >> 63
    nulls = int((~valid).sum())
    bitmap = pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()) \
        if nulls else None
    return pa.Array.from_buffers(pa.decimal128(dt.precision, dt.scale),
                                 len(vals), [bitmap, pa.py_buffer(
                                     words.tobytes())], null_count=nulls)


def _timestamp_micros(arr) -> np.ndarray:
    """Arrow timestamp array of any unit -> int64 microseconds (nanoseconds
    floor-divide, as Spark truncates them); null slots hold 0."""
    import pyarrow as pa
    raw = arr.cast(pa.int64()).fill_null(0).to_numpy(zero_copy_only=False)
    if arr.type.unit == "ns":
        return raw // 1000
    return raw * _US_PER_UNIT[arr.type.unit]


def from_arrow(arr, device: torch.device, capacity: Optional[int] = None,
               head: Optional[int] = None) -> Tuple[Column, int]:
    """Arrow array -> device Column; returns (column, num_rows). A string
    column takes the long-string layout once a value passes `head` bytes,
    and is the flat matrix at any width when `head` is None."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    dtype = T.from_arrow(arr.type)
    check_supported(dtype)
    n = len(arr)
    cap = capacity or row_bucket(n)
    valid = np.ones(n, dtype=bool) if arr.null_count == 0 else \
        np.asarray(arr.is_valid())
    valid_t = torch.from_numpy(_pad_to(valid, cap)).to(device)
    if isinstance(dtype, T.StringType):
        chars, lens, ovf = _string_leaves(arr, cap, head)
        return Column(dtype, torch.from_numpy(chars).to(device), valid_t,
                      torch.from_numpy(lens).to(device),
                      None if ovf is None else tuple(
                          torch.from_numpy(a).to(device) for a in ovf)), n
    if isinstance(dtype, T.DecimalType):
        if pa.types.is_decimal256(arr.type):
            arr = arr.cast(pa.decimal128(dtype.precision, dtype.scale))
        vals = _decimal_unscaled(arr, T.is_dec128(dtype))
    elif isinstance(dtype, T.TimestampType):
        vals = _timestamp_micros(arr)
    elif isinstance(dtype, T.DateType):
        # fill nulls BEFORE to_numpy: a nullable int array otherwise
        # converts via float64
        vals = arr.cast(pa.int32()).fill_null(0).to_numpy(zero_copy_only=False)
    elif arr.null_count:
        zero = False if isinstance(dtype, T.BooleanType) else 0
        vals = arr.fill_null(zero).to_numpy(zero_copy_only=False)
    else:
        vals = arr.to_numpy(zero_copy_only=False)
    vals = np.ascontiguousarray(vals, dtype=dtype.np_dtype)
    return Column(dtype, torch.from_numpy(_pad_to(vals, cap)).to(device),
                  valid_t), n


def to_arrow(col: Column, num_rows: int):
    """Device Column -> Arrow array (host boundary)."""
    import pyarrow as pa
    valid = col.validity[:num_rows].cpu().numpy()
    mask = ~valid
    if col.is_string:
        from .strings import live_bytes
        flat, lens = live_bytes(col.data, col.lengths, col.overflow,
                                col.validity, num_rows)
        offsets = np.concatenate(([0], np.cumsum(lens.cpu().numpy())))
        return pa.Array.from_buffers(
            pa.large_string(), num_rows,
            [pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()),
             pa.py_buffer(offsets.tobytes()),
             pa.py_buffer(flat.cpu().numpy().tobytes())],
            null_count=int(mask.sum())).cast(pa.string())
    vals = col.data[:num_rows].cpu().numpy()
    if isinstance(col.dtype, T.DecimalType):
        return _decimal_array(vals, valid, col.dtype)
    return pa.array(vals, type=T.to_arrow(col.dtype),
                    mask=mask if mask.any() else None)
