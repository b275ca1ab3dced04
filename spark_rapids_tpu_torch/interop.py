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
    package or its simple string ("long", "date", ...). datas/validities:
    one padded array per field, all of one capacity. num_rows: the logical
    row count (<= capacity)."""
    device = torch.device(device)
    names = tuple(n for n, _ in schema_fields)
    types = tuple(T.parse_type(t) if isinstance(t, str) else t
                  for _, t in schema_fields)
    if not (len(names) == len(datas) == len(validities)):
        raise ValueError("one data and one validity array per field")
    caps = {len(a) for a in datas} | {len(a) for a in validities}
    if len(caps) != 1:
        raise ValueError(f"all buffers must share one capacity, got {caps}")
    if not 0 <= num_rows <= caps.pop():
        raise ValueError(f"num_rows {num_rows} outside [0, capacity]")
    cols = []
    for dt, d, v in zip(types, datas, validities):
        tdt = torch_dtype(dt)
        data = torch.from_numpy(np.require(d, dt.np_dtype, ["C", "W"]))
        valid = torch.from_numpy(np.require(v, bool, ["C", "W"]))
        cols.append(Column(dt, data.to(device=device, dtype=tdt),
                           valid.to(device)))
    return ColumnarBatch(Schema(names, types), tuple(cols),
                         torch.tensor(num_rows, dtype=torch.int32,
                                      device=device))
