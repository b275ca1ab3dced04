"""Batch concatenation and coalescing (`spark_rapids_tpu/exec/coalesce.py`
concat_batches, rebucket_string_widths and TpuCoalesceBatchesExec).

Concatenation drops inter-batch padding: concatenate the padded columns,
stable-compact on the concatenated live-row mask, then cut to the output
bucket the host chose from the summed row counts. String columns of
unequal width buckets concatenate at the widest, zero-padded. Where any
input of a string column is in the long-string layout, the column
concatenates in that layout: the heads at the widest head, the blobs end
to end with each input's tail offsets shifted by the bytes before it, and
a flat input wider than the head split by `tails_from_matrix`.

`rebucket_string_widths` narrows every string column to its live rows'
widest bucket, heals a long-string column whose live rows all fit its
head back to the flat layout, and collects a blob that is less than half
live. The JAX planner puts the coalesce exec only at a bare exchange,
which the port does not have yet, so the exec and the function are held
to the JAX package at the exec level.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar.batch import ColumnarBatch
from ..columnar.column import Column
from ..columnar.padding import row_bucket, width_bucket
from ..columnar.strings import blob_bucket, check_blob, compact_tails, \
    tails_from_matrix
from ..expr.base import Vec, pad_width
from ..ops.rowops import compact_vecs
from .base import TpuExec, UnaryTpuExec, batch_vecs, vecs_to_batch

__all__ = ["concat_batches", "rebucket_string_widths",
           "TpuCoalesceBatchesExec"]


def _concat_overflow_strings(vs: List[Vec]) -> Vec:
    """One string column across batches in the long-string layout."""
    hw = max(v.data.shape[1] for v in vs if v.overflow is not None)
    heads, starts, blobs = [], [], []
    blob_off = 0
    for v in vs:
        if v.overflow is not None:
            h = pad_width(v.data, hw)
            blob, ts = v.overflow
        elif v.data.shape[1] <= hw:
            h = pad_width(v.data, hw)
            blob = v.data.new_zeros(0)
            ts = torch.zeros(v.data.shape[0], dtype=torch.int32,
                             device=v.data.device)
        else:
            h, blob, ts = tails_from_matrix(v.data, hw)
        heads.append(h)
        starts.append(ts.to(torch.int32) + blob_off)
        blobs.append(blob)
        blob_off += int(blob.shape[0])
    check_blob(blob_off)
    return Vec(vs[0].dtype, torch.cat(heads),
               torch.cat([v.validity for v in vs]),
               torch.cat([v.lengths for v in vs]),
               (torch.cat(blobs), torch.cat(starts)))


def _concat_column(vs: List[Vec]) -> Vec:
    if any(v.overflow is not None for v in vs):
        return _concat_overflow_strings(vs)
    datas = [v.data for v in vs]
    lengths = None
    if vs[0].is_string:
        w = max(d.shape[1] for d in datas)
        datas = [pad_width(d, w) for d in datas]
        lengths = torch.cat([v.lengths for v in vs])
    return Vec(vs[0].dtype, torch.cat(datas),
               torch.cat([v.validity for v in vs]), lengths)


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    counts = torch.stack([b.num_rows for b in batches]).tolist()  # one sync
    out_cap = row_bucket(sum(counts))
    schema = batches[0].schema
    masks = torch.cat([b.row_mask() for b in batches])
    per_batch = [batch_vecs(b) for b in batches]
    merged = [_concat_column([b[i] for b in per_batch])
              for i in range(len(schema.types))]
    compacted, total = compact_vecs(merged, masks)
    # like the JAX engine: the capacity is min(bucket, summed capacities)
    out = [v.gather(slice(0, out_cap)) for v in compacted]
    return vecs_to_batch(schema, out, total)


def _shrink(col: Column, live: torch.Tensor) -> Column:
    """One string column narrowed to its live rows (one host read)."""
    eff = torch.where(live, col.lengths, 0)
    mx = int(eff.max()) if eff.numel() else 0
    hw = col.data.shape[1]
    if col.overflow is not None and mx > hw:
        # still long: collect the blob's dead bytes when under half live
        live_tail = int(torch.clamp(eff.to(torch.int64) - hw, min=0).sum())
        if blob_bucket(live_tail) * 2 > int(col.overflow[0].shape[0]):
            return col
        return Column(col.dtype, col.data, col.validity, col.lengths,
                      compact_tails(col.lengths, col.overflow, live, hw))
    # every live row fits the head: the flat layout, at the live width
    new_w = min(width_bucket(max(mx, 1)), hw)
    if new_w == hw and col.overflow is None:
        return col
    return Column(col.dtype, col.data[:, :new_w], col.validity,
                  torch.clamp(col.lengths, max=new_w))


def rebucket_string_widths(batch: ColumnarBatch) -> ColumnarBatch:
    """String columns narrowed to the batch's live rows: the flat width to
    their longest row's bucket, a long-string column healed to the flat
    layout when its live rows fit the head, its blob collected when less
    than half of it is live. Lengths of dead rows clamp to the new width,
    so padding can never force a wide layout."""
    mask = batch.row_mask()
    cols = tuple(_shrink(c, mask) if c.is_string else c
                 for c in batch.columns)
    if all(a is b for a, b in zip(cols, batch.columns)):
        return batch
    return ColumnarBatch(batch.schema, cols, batch.num_rows)


class TpuCoalesceBatchesExec(UnaryTpuExec):
    """Concatenate the child's batches into one (JAX's RequireSingleBatch
    goal), narrowed by rebucket_string_widths. A byte target comes with
    the plan that puts this exec at a bare exchange."""

    def __init__(self, child: TpuExec, conf=None):
        super().__init__([child], conf)

    def do_execute(self) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute())
        if batches:
            yield rebucket_string_widths(concat_batches(batches))
