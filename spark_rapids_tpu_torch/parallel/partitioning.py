"""Partitioners: an int32 partition id per row
(`spark_rapids_tpu/parallel/partitioning.py`, hash partitioning only).

Hash placement matches Spark exactly, pmod(murmur3(keys, seed 42), n)
through `expr/hashing.py`, so a row lands in the same partition in both
engines. A key of a decimal past 18 digits has no murmur3 in the JAX
package, and is refused when the partitioner is planned. Range,
round-robin and single partitioning wait for the exchanges
that other plan nodes make.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .. import types as T
from ..columnar.batch import ColumnarBatch
from ..expr.base import BoundReference, Expression, Vec, bind_references
from ..expr.hashing import hash_vecs

__all__ = ["TpuPartitioning", "HashPartitioning"]


class TpuPartitioning:
    """Partition ids for every row of a batch; padding rows get -1, so the
    bucketing drops them without the row mask."""

    num_partitions: int

    def partition_ids(self, vecs: Sequence[Vec],
                      row_mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def ids_for_batch(self, batch: ColumnarBatch) -> torch.Tensor:
        vecs = [Vec.from_column(c) for c in batch.columns]
        mask = batch.row_mask()
        return torch.where(mask, self.partition_ids(vecs, mask), -1)


def _pmod(h: torch.Tensor, n: int) -> torch.Tensor:
    """Spark pmod on int32: ((h % n) + n) % n. torch's % already takes the
    divisor's sign, which gives the same value."""
    return torch.remainder(h.to(torch.int32), n).to(torch.int32)


@dataclasses.dataclass
class HashPartitioning(TpuPartitioning):
    """pmod(murmur3(keys, seed=42), n), Spark's HashPartitioning."""

    key_ordinals: Sequence[int]
    num_partitions: int

    def partition_ids(self, vecs, row_mask):
        keys = [vecs[i] for i in self.key_ordinals]
        return _pmod(hash_vecs(keys, 42), self.num_partitions)

    @staticmethod
    def from_exprs(keys: Sequence[Expression], schema,
                   num_partitions: int) -> "HashPartitioning":
        ords = []
        for k in keys:
            b = bind_references(k, schema)
            if not isinstance(b, BoundReference):
                raise ValueError("partition keys must be column references "
                                 "after planning")
            if T.is_dec128(b.data_type):
                # the JAX murmur3 stops at 18 digits (expr/hashing.py)
                raise NotImplementedError(
                    f"hash partitioning by a {b.data_type.simple_string()} "
                    "key is not supported by spark_rapids_tpu_torch")
            ords.append(b.ordinal)
        return HashPartitioning(tuple(ords), num_partitions)

    def __repr__(self):
        return (f"hashpartitioning({list(self.key_ordinals)}, "
                f"{self.num_partitions})")
