"""Device column vectors (`spark_rapids_tpu/columnar/column.py`, fixed-width
types only).

A `Column` is a plain dataclass of two torch tensors on one device: a data
buffer and a bool validity mask, both padded to a capacity bucket (see
padding.py). Rows at or beyond the batch's logical row count are padding
whose data AND validity contents are unspecified; kernels mask with the
batch row mask wherever padding could leak into results. Data under null
rows is unspecified too.

This slice carries BOOLEAN, INT, LONG, DOUBLE and DATE. Strings, decimals,
timestamps, the narrow integers, FLOAT and nested types wait for later
slices and raise NotImplementedError here, at plan time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import types as T
from .padding import row_bucket

__all__ = ["Column", "torch_dtype", "check_supported",
           "from_arrow", "to_arrow"]

_TORCH_DTYPES = {
    T.BooleanType: torch.bool,
    T.IntegerType: torch.int32,
    T.LongType: torch.int64,
    T.DoubleType: torch.float64,
    T.DateType: torch.int32,
}


def check_supported(dt: T.DataType, what: str = "column") -> None:
    if type(dt) not in _TORCH_DTYPES:
        raise NotImplementedError(
            f"{what} type {dt.simple_string()} is not supported by "
            "spark_rapids_tpu_torch yet (this slice carries boolean, int, "
            "long, double and date)")


def torch_dtype(dt: T.DataType) -> torch.dtype:
    check_supported(dt)
    return _TORCH_DTYPES[type(dt)]


@dataclasses.dataclass
class Column:
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])


def _pad_to(arr: np.ndarray, cap: int) -> np.ndarray:
    """Pad to the capacity; always a writable array that torch may own
    (Arrow's zero-copy buffers are read-only)."""
    if arr.shape[0] == cap:
        return arr if arr.flags.writeable else arr.copy()
    return np.pad(arr, (0, cap - arr.shape[0]))


def from_arrow(arr, device: torch.device,
               capacity: Optional[int] = None) -> Tuple[Column, int]:
    """Arrow array -> device Column; returns (column, num_rows)."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    dtype = T.from_arrow(arr.type)
    check_supported(dtype)
    n = len(arr)
    cap = capacity or row_bucket(n)
    valid = np.ones(n, dtype=bool) if arr.null_count == 0 else \
        np.asarray(arr.is_valid())
    if isinstance(dtype, T.DateType):
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
                  torch.from_numpy(_pad_to(valid, cap)).to(device)), n


def to_arrow(col: Column, num_rows: int):
    """Device Column -> Arrow array (host boundary)."""
    import pyarrow as pa
    valid = col.validity[:num_rows].cpu().numpy()
    vals = col.data[:num_rows].cpu().numpy()
    mask = ~valid
    return pa.array(vals, type=T.to_arrow(col.dtype),
                    mask=mask if mask.any() else None)
