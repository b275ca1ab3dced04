"""Batch concatenation (`spark_rapids_tpu/exec/coalesce.py` concat_batches).

Concatenation drops inter-batch padding: concatenate the padded columns,
stable-compact on the concatenated live-row mask, then cut to the output
bucket the host chose from the summed row counts. String columns of
unequal width buckets concatenate at the widest, zero-padded; the
`rebucket_string_widths` narrowing of the JAX package is not ported, so a
column never narrows here.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.padding import row_bucket
from ..expr.base import Vec, pad_width
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
    merged = []
    for i, dt in enumerate(schema.types):
        vs = [b[i] for b in per_batch]
        datas = [v.data for v in vs]
        lengths = None
        if vs[0].is_string:
            w = max(d.shape[1] for d in datas)
            datas = [pad_width(d, w) for d in datas]
            lengths = torch.cat([v.lengths for v in vs])
        merged.append(Vec(dt, torch.cat(datas),
                          torch.cat([v.validity for v in vs]), lengths))
    compacted, total = compact_vecs(merged, masks)
    # like the JAX engine: the capacity is min(bucket, summed capacities)
    out = [v.gather(slice(0, out_cap)) for v in compacted]
    return vecs_to_batch(schema, out, total)
