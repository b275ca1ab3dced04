"""Batch concatenation (`spark_rapids_tpu/exec/coalesce.py` concat_batches).

Concatenation drops inter-batch padding: concatenate the padded columns,
stable-compact on the concatenated live-row mask, then cut to the output
bucket the host chose from the summed row counts.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.padding import row_bucket
from ..expr.base import Vec
from ..ops.rowops import compact_vecs
from .base import batch_vecs, vecs_to_batch

__all__ = ["concat_batches"]


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    counts = torch.stack([b.num_rows for b in batches]).tolist()  # one sync
    out_cap = row_bucket(sum(counts))
    schema = batches[0].schema
    masks = torch.cat([b.row_mask() for b in batches])
    per_batch = [batch_vecs(b) for b in batches]
    merged = [Vec(schema.types[i],
                  torch.cat([vs[i].data for vs in per_batch]),
                  torch.cat([vs[i].validity for vs in per_batch]))
              for i in range(len(schema.types))]
    compacted, total = compact_vecs(merged, masks)
    # like the JAX engine: the capacity is min(bucket, summed capacities)
    out = [Vec(v.dtype, v.data[:out_cap], v.validity[:out_cap])
           for v in compacted]
    return vecs_to_batch(schema, out, total)
