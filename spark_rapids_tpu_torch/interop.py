"""Rebuild a padded device batch from host arrays.

The tests extract a JAX `ColumnarBatch`'s padded buffers as numpy arrays
and rebuild the identical batch here (same capacity, same padding contents,
same masks), so both engines see bit-identical inputs. Nothing here knows
about JAX: it takes names, types and arrays.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from . import types as T
from .columnar.batch import ColumnarBatch, Schema
from .columnar.column import Column, torch_dtype

__all__ = ["batch_from_numpy"]


def batch_from_numpy(schema_fields: Sequence[Tuple[str, Union[str,
                                                              T.DataType]]],
                     datas: Sequence[np.ndarray],
                     validities: Sequence[np.ndarray], num_rows: int,
                     device) -> ColumnarBatch:
    """schema_fields: (name, type) pairs, the type a DataType of this
    package or its simple string ("long", "date", "string", ...).
    datas/validities: one padded array per field, all of one capacity; a
    string field's data is a (uint8[cap, w] byte matrix, int32[cap]
    lengths) pair, or for a long-string column (head, lengths, blob
    uint8[B], tail_start int32[cap]). num_rows: the logical row count
    (<= capacity)."""
    device = torch.device(device)
    names = tuple(n for n, _ in schema_fields)
    types = tuple(T.parse_type(t) if isinstance(t, str) else t
                  for _, t in schema_fields)
    if not (len(names) == len(datas) == len(validities)):
        raise ValueError("one data and one validity array per field")

    def host(a, dtype):
        return torch.from_numpy(np.require(a, dtype, ["C", "W"]))

    cols = []
    for dt, d, v in zip(types, datas, validities):
        valid = host(v, bool)
        if isinstance(dt, T.StringType):
            chars, lens = d[0], d[1]
            chars, lens = host(chars, np.uint8), host(lens, np.int32)
            if chars.dim() != 2 or lens.shape != chars.shape[:1]:
                raise ValueError("a string field takes (uint8[cap, w], "
                                 "int32[cap])")
            ovf = None
            if len(d) == 4:
                ovf = (host(d[2], np.uint8).to(device),
                       host(d[3], np.int32).to(device))
            cols.append(Column(dt, chars.to(device), valid.to(device),
                               lens.to(device), ovf))
        else:
            data = host(d, dt.np_dtype)
            cols.append(Column(dt, data.to(device=device,
                                           dtype=torch_dtype(dt)),
                               valid.to(device)))
    caps = {c.capacity for c in cols} | {len(v) for v in validities}
    if len(caps) != 1:
        raise ValueError(f"all buffers must share one capacity, got {caps}")
    if not 0 <= num_rows <= caps.pop():
        raise ValueError(f"num_rows {num_rows} outside [0, capacity]")
    return ColumnarBatch(Schema(names, types), tuple(cols),
                         torch.tensor(num_rows, dtype=torch.int32,
                                      device=device))
