"""The long-string device layout: a head byte matrix plus a shared tail
blob (`spark_rapids_tpu/columnar/strings.py`).

The flat layout (column.py) pays `cap x width` bytes, where width is the
bucket of the longest value: one long string widens every row's slot.
Past the head width a string column takes this layout instead:

  head:       uint8[cap, W0]  the first W0 bytes of every row (W0 the
              bucket of `spark.rapids.tpu.string.headWidth`, default 256),
              zero past each row's length like any flat matrix.
  blob:       uint8[B]        the bytes past W0 of every row, concatenated;
              B is a capacity bucket. The blob is shared by every batch a
              row move makes from it, and is not aligned to rows.
  tail_start: int32[cap]      each row's offset into the blob (unspecified
              where the length is <= W0). A row move (filter compaction,
              join gather, sort, slice) gathers tail_start like any other
              row buffer and leaves the blob as it is: O(rows) whatever
              the strings' sizes.
  lengths:    int32[cap]      the full byte length (head + tail).

A column with `overflow=(blob, tail_start)` is a long-string column. An
operation that only moves rows takes it as it is; one that reads the bytes
raises CpuFallbackRequired on the device (expr/base.py
`require_flat_strings`), and the session reruns the plan on the host,
whose string columns are always the flat matrix. The blob keeps dead
bytes after a filter; `compact_tails` collects them at a coalesce, and a
batch whose live rows all fit the head heals back to the flat layout
(exec/coalesce.py `rebucket_string_widths`).

tail_start is int32, so a blob holds at most MAX_BLOB_BYTES: every site
that sizes one (`blob_bucket`, `tails_from_matrix`, the concat's blobs end
to end) calls `check_blob`, which raises CpuFallbackRequired past it, and
the plan reruns on the host rather than read wrapped offsets.

`build_string_leaves` reads Arrow's host buffers and is numpy, as in the
JAX package; the rest is torch and runs on the tensors' device, the host
included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import get_default_conf
from ..errors import CpuFallbackRequired
from .padding import width_bucket

__all__ = ["head_width", "blob_bucket", "check_blob", "build_string_leaves",
           "compact_tails", "tails_from_matrix", "segment_arange",
           "tail_byte_stream", "tail_starts_for", "live_bytes",
           "MAX_BLOB_BYTES"]

MAX_BLOB_BYTES = (1 << 31) - 1  # the reach of an int32 tail_start


def segment_arange(lens: np.ndarray) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated: the position within
    its segment of every byte a blob gather or scatter moves."""
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    seg_starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    return out - np.repeat(seg_starts, lens)


def head_width(conf=None) -> int:
    """The head width bucket of `conf` (the process default when None)."""
    conf = conf or get_default_conf()
    return width_bucket(int(conf.get("spark.rapids.tpu.string.headWidth")))


def check_blob(nbytes: int) -> None:
    """Raise CpuFallbackRequired when a blob of `nbytes` would hold offsets
    past the int32 tail_start's reach."""
    if nbytes > MAX_BLOB_BYTES:
        raise CpuFallbackRequired(
            f"a string tail blob of {nbytes} bytes passes the int32 "
            f"tail offsets' {MAX_BLOB_BYTES}")


def blob_bucket(nbytes: int) -> int:
    """Blob capacity bucket: 1 KiB chunks, a power-of-two count of them;
    raises past MAX_BLOB_BYTES (`check_blob`)."""
    check_blob(nbytes)
    chunks = max(1, -(-nbytes // 1024))
    p = 1
    while p < chunks:
        p *= 2
    return p * 1024


def _pad_rows(a: np.ndarray, cap: int) -> np.ndarray:
    if a.shape[0] == cap:
        return a
    return np.pad(a, (0, cap - a.shape[0]))


def build_string_leaves(
        databuf: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
        cap: int, hw: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Arrow-style (bytes, int64 offsets[n+1], int32 lens[n]) -> (head[cap,
    W], lengths[cap], overflow or None). A column whose longest value fits
    the head width `hw` (the default conf's when None) is the flat layout
    at that value's width bucket, with no overflow."""
    n = len(lens)
    mx = int(lens.max()) if n else 0
    hw = head_width() if hw is None else hw
    w = width_bucket(max(mx, 1))
    lens = np.ascontiguousarray(lens, dtype=np.int32)

    def matrix(width, clamp):
        chars = np.zeros((cap, width), dtype=np.uint8)
        if n:
            eff = np.minimum(lens, clamp) if clamp else lens
            row_id = np.repeat(np.arange(n), eff)
            if row_id.size:
                within = segment_arange(eff)
                src = np.repeat(np.asarray(offsets[:-1], np.int64), eff) \
                    + within
                chars[row_id, within] = databuf[src]
        return chars

    if mx <= hw:
        return matrix(w, None), _pad_rows(lens, cap), None

    head = matrix(hw, hw)
    tail_lens = np.maximum(lens - hw, 0).astype(np.int64)
    total = int(tail_lens.sum())
    blob = np.zeros(blob_bucket(total), np.uint8)
    tail_start = np.zeros(cap, np.int32)
    starts = np.concatenate(([0], np.cumsum(tail_lens)[:-1]))
    tail_start[:n] = starts.astype(np.int32)
    if total:
        within = segment_arange(tail_lens)
        src = np.repeat(np.asarray(offsets[:-1], np.int64) + hw, tail_lens) \
            + within
        blob[np.repeat(starts, tail_lens) + within] = databuf[src]
    return head, _pad_rows(lens, cap), (blob, tail_start)


def tails_from_matrix(data: torch.Tensor, w0: int):
    """A flat matrix [cap, W] wider than the head (W > w0) -> (head
    [cap, w0], blob, tail_start) with no host read: the blob is the
    rectangular region past the head, flattened, so tail_start is the
    fixed stride W - w0 (the bytes past each row's true tail are dead, and
    a coalesce collects them)."""
    cap, w = data.shape
    stride = w - w0
    check_blob(cap * stride)
    head = data[:, :w0]
    blob = data[:, w0:].reshape(cap * stride)
    return head, blob, torch.arange(cap, dtype=torch.int32,
                                    device=data.device) * stride


def tail_byte_stream(blob: torch.Tensor, tail_start: torch.Tensor,
                     tail_lens: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Device: the rows' tail bytes in row order, (bytes uint8[total], the
    row of each byte int64[total]). tail_lens is int64[rows], 0 for a row
    whose bytes must not move."""
    rows = torch.arange(tail_lens.shape[0], device=blob.device)
    row_of = torch.repeat_interleave(rows, tail_lens)
    if row_of.numel() == 0:
        return blob[:0], row_of
    seg_start = torch.cumsum(tail_lens, 0) - tail_lens
    within = torch.arange(row_of.numel(), device=blob.device) - \
        seg_start[row_of]
    src = tail_start.to(torch.int64)[row_of] + within
    return blob[src.clamp(0, blob.shape[0] - 1)], row_of


def tail_starts_for(tail_lens: torch.Tensor) -> torch.Tensor:
    """Device: int32 offsets of rows whose tails lie back to back in row
    order (the exclusive cumsum of their tail lengths)."""
    return (torch.cumsum(tail_lens, 0) - tail_lens).to(torch.int32)


def compact_tails(lengths: torch.Tensor, overflow, live: torch.Tensor,
                  hw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blob collection: a new (blob, tail_start) holding only the live
    rows' tails back to back in row order, tail_start at the same row
    capacity (one host read, for the blob's size)."""
    blob, tail_start = overflow
    tail_lens = torch.where(live, torch.clamp(
        lengths.to(torch.int64) - hw, min=0), 0)
    stream, _ = tail_byte_stream(blob, tail_start, tail_lens)
    total = int(stream.shape[0])
    new_blob = blob.new_zeros(blob_bucket(total))
    new_blob[:total] = stream
    return new_blob, tail_starts_for(tail_lens)


def live_bytes(data: torch.Tensor, lengths: torch.Tensor, overflow,
               valid: torch.Tensor, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first n rows' bytes concatenated, with no [n, longest] matrix
    in between for a long-string column (head rows and blob spans go
    straight to the output), and their int64 lengths, 0 under a null. On a
    card the host then copies only live bytes (the Arrow boundary)."""
    lens = torch.where(valid[:n], lengths[:n], 0).to(torch.int64)
    head = data[:n]
    hw = head.shape[1]
    head_lens = torch.clamp(lens, max=hw)
    cols = torch.arange(hw, device=head.device)[None, :]
    head_bytes = head[cols < head_lens[:, None]]
    if overflow is None:
        return head_bytes, lens
    tail_lens = lens - head_lens
    tails, t_row = tail_byte_stream(overflow[0], overflow[1][:n], tail_lens)
    out_off = torch.cumsum(lens, 0) - lens
    out = head.new_empty(int(head_bytes.shape[0] + tails.shape[0]))
    rows = torch.arange(n, device=head.device)
    h_row = torch.repeat_interleave(rows, head_lens)
    h_within = torch.arange(h_row.numel(), device=head.device) - \
        (torch.cumsum(head_lens, 0) - head_lens)[h_row]
    out[out_off[h_row] + h_within] = head_bytes
    t_within = torch.arange(t_row.numel(), device=head.device) - \
        (torch.cumsum(tail_lens, 0) - tail_lens)[t_row]
    out[out_off[t_row] + hw + t_within] = tails
    return out, lens
