"""Columnar batches (`spark_rapids_tpu/columnar/batch.py`).

A `ColumnarBatch` is a plain dataclass: a static schema, a tuple of
`Column`s sharing one capacity bucket, and the logical row count as an
int32 scalar tensor on the batch's device. Keeping the count on the device
lets filters and joins change cardinality without a host sync;
`row_count()` is the explicit, host-synchronising read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from .. import types as T
from .column import Column, data_shape, from_arrow as col_from_arrow, \
    to_arrow as col_to_arrow, torch_dtype
from .padding import row_bucket

__all__ = ["Schema", "ColumnarBatch", "batch_from_arrow", "batch_to_arrow",
           "empty_column", "empty_batch", "join_output_schema"]


@dataclasses.dataclass(frozen=True)
class Schema:
    names: Tuple[str, ...]
    types: Tuple[T.DataType, ...]

    def __post_init__(self):
        if len(self.names) != len(self.types):
            raise ValueError("schema names and types differ in length")

    def __len__(self):
        return len(self.names)

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def to_arrow(self):
        import pyarrow as pa
        return pa.schema([pa.field(n, T.to_arrow(t))
                          for n, t in zip(self.names, self.types)])

    @staticmethod
    def from_arrow(schema) -> "Schema":
        return Schema(tuple(schema.names),
                      tuple(T.from_arrow(f.type) for f in schema))

    def __repr__(self):
        inner = ", ".join(f"{n}: {t.simple_string()}"
                          for n, t in zip(self.names, self.types))
        return f"Schema({inner})"


def join_output_schema(left: Schema, right: Schema, join_type: str) -> Schema:
    """semi/anti project the left side; existence appends the BOOLEAN
    `exists` flag; everything else is the combined row (the JAX package's
    one definition)."""
    if join_type in ("semi", "anti"):
        return left
    if join_type == "existence":
        return Schema(left.names + ("exists",), left.types + (T.BOOLEAN,))
    return Schema(left.names + right.names, left.types + right.types)


@dataclasses.dataclass
class ColumnarBatch:
    schema: Schema
    columns: Tuple[Column, ...]
    num_rows: torch.Tensor  # int32 scalar on the batch's device

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def row_count(self) -> int:
        """Host-synchronising logical row count (host paths only)."""
        return int(self.num_rows)

    def row_mask(self) -> torch.Tensor:
        """bool[cap]: True for live (non-padding) rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def device_memory_size(self) -> int:
        """Bytes of the columns' buffers (data, validity, lengths, a long
        string's blob and tail offsets), the JAX package's count: the
        row-count scalar is not counted."""
        return sum(t.numel() * t.element_size()
                   for c in self.columns for t in c.leaves())

    def flatten(self) -> Tuple[List[torch.Tensor], tuple]:
        """(every tensor of the batch, a tree to rebuild it from them):
        each column's leaves in order, then the row-count scalar. The
        counterpart of jax.tree_util.tree_flatten over the JAX batch."""
        leaves = [t for c in self.columns for t in c.leaves()]
        leaves.append(self.num_rows)
        tree = (self.schema, tuple((c.dtype, len(c.leaves()),
                                    c.overflow is not None)
                                   for c in self.columns))
        return leaves, tree

    @staticmethod
    def unflatten(tree: tuple, leaves: Sequence[torch.Tensor]
                  ) -> "ColumnarBatch":
        """The batch that `flatten` gave `tree` and `leaves` for."""
        schema, cols = tree
        out, at = [], 0
        for dtype, k, ovf in cols:
            out.append(Column.from_leaves(dtype, leaves[at:at + k], ovf))
            at += k
        return ColumnarBatch(schema, tuple(out), leaves[at])

    def owned(self, cap: Optional[int] = None) -> "ColumnarBatch":
        """The first `cap` rows (all of them by default; the caller keeps
        cap >= the row count) in buffers of their own: a slice of shared
        storage would keep the whole storage alive after a spill."""
        cap = self.capacity if cap is None else cap
        return ColumnarBatch(self.schema, tuple(
            c.map_rows(lambda t: t[:cap].clone(), torch.clone)
            for c in self.columns), self.num_rows)

    def repadded(self, new_cap: int) -> "ColumnarBatch":
        """The same rows at capacity `new_cap`: zero padding appended, or
        the padding tail cut (the caller keeps new_cap >= the row count)."""
        def fit(t):
            cap = t.shape[0]
            if new_cap <= cap:
                return t[:new_cap]
            return torch.cat([t, t.new_zeros((new_cap - cap,) + t.shape[1:])])

        return ColumnarBatch(self.schema, tuple(
            c.map_rows(fit) for c in self.columns), self.num_rows)


def batch_from_arrow(table, device: torch.device,
                     capacity: Optional[int] = None, conf=None,
                     flat: bool = False) -> ColumnarBatch:
    """pyarrow Table -> device ColumnarBatch (the H2D boundary). A string
    column past the head width of `conf` (the process default when None)
    takes the long-string layout; `flat` keeps every string column the
    flat matrix, as the host engine holds it."""
    from .strings import head_width
    n = table.num_rows
    cap = capacity or row_bucket(n)
    head = None if flat else head_width(conf)
    cols: List[Column] = [col_from_arrow(table.column(i), device, cap,
                                         head)[0]
                          for i in range(table.num_columns)]
    return ColumnarBatch(Schema.from_arrow(table.schema), tuple(cols),
                         torch.tensor(n, dtype=torch.int32, device=device))


def batch_to_arrow(batch: ColumnarBatch):
    """Device ColumnarBatch -> pyarrow Table (the D2H boundary)."""
    import pyarrow as pa
    n = batch.row_count()
    arrays = [col_to_arrow(c, n) for c in batch.columns]
    return pa.Table.from_arrays(arrays, schema=batch.schema.to_arrow())


def empty_column(dt: T.DataType, cap: int, device: torch.device) -> Column:
    """An all-null column of `cap` rows (a string column is 8 bytes wide,
    the narrowest bucket, as in the JAX package)."""
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    if isinstance(dt, T.StringType):
        return Column(dt, torch.zeros((cap, 8), dtype=torch.uint8,
                                      device=device), valid,
                      torch.zeros(cap, dtype=torch.int32, device=device))
    return Column(dt, torch.zeros(data_shape(dt, cap), dtype=torch_dtype(dt),
                                  device=device), valid)


def empty_batch(schema: Schema, device: torch.device,
                capacity: int = 0) -> ColumnarBatch:
    cap = row_bucket(max(capacity, 1))
    return ColumnarBatch(schema, tuple(empty_column(dt, cap, device)
                                       for dt in schema.types),
                         torch.tensor(0, dtype=torch.int32, device=device))


def concat_tables(tables: Sequence, schema: Schema):
    import pyarrow as pa
    if not tables:
        return schema.to_arrow().empty_table()
    return pa.concat_tables(tables)
