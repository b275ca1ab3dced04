"""Host <-> device transitions (`spark_rapids_tpu/exec/transitions.py`;
reference `GpuTransitionOverrides.scala`, HostColumnarToGpu and
GpuColumnarToRowExec placement `:50-120`).

Both sides are columnar, so a transition is a batch copy:
`TpuFromCpuExec` lifts a host subtree's batches onto the device (a pinned,
non-blocking copy into the batch's row bucket), and `CpuFromTpuExec` runs
a device subtree and hands its batches, cut to their live rows' row
bucket, to a host parent. Each copy counts its rows, buffer bytes and
host nanoseconds in TaskMetrics (`to_device_*`, `to_host_*`), and on a
card the timing events around its copies, whose device seconds
`TaskMetrics.copy_seconds` reads.

On the host a string column is always the flat matrix: a long-string
column's live bytes (`live_bytes`) are laid out flat on the way to the
host, and a host string column past the head width takes the long-string
layout on the way to the device (`build_string_leaves`).
"""

from __future__ import annotations

import time
from typing import Iterator, List

import numpy as np
import torch

from ..columnar.batch import ColumnarBatch, Schema
from ..columnar.column import Column
from ..columnar.padding import row_bucket
from ..columnar.strings import build_string_leaves, head_width, live_bytes
from ..cpu.hostbatch import HOST, HostBatch, scoped_stream
from ..utils.metrics import TaskMetrics
from .base import TpuExec

__all__ = ["host_batch_to_device", "device_batch_to_host", "TpuFromCpuExec",
           "CpuFromTpuExec"]


def _relayout(c: Column, n: int, hw) -> Column:
    """A string column's first n rows laid out again on the host, at its
    capacity: with `hw` None the flat matrix at the longest row's bucket
    (the host's layout), else past `hw` bytes the long-string layout (JAX
    `assemble_matrix` and `build_string_leaves`)."""
    flat, lens = live_bytes(c.data, c.lengths, c.overflow, c.validity, n)
    lens = lens.cpu().numpy()
    offsets = np.concatenate(([0], np.cumsum(lens)))
    longest = int(lens.max()) if n else 0
    head, full, ovf = build_string_leaves(
        flat.cpu().numpy(), offsets, lens.astype(np.int32), c.capacity,
        longest if hw is None else hw)
    return Column(c.dtype, torch.from_numpy(head), c.validity.cpu(),
                  torch.from_numpy(full),
                  None if ovf is None else
                  tuple(torch.from_numpy(a) for a in ovf))


def _copy(b: ColumnarBatch, n: int, device: torch.device, events: list,
          hw: int = None) -> ColumnarBatch:
    """`b`'s first row bucket of `n` rows on `device`. Between a card and
    the host, the copies run between two timing events on the card's
    stream, appended to `events`; a copy to the card reads pinned buffers
    (pinned before the first event) and runs asynchronously. A copy to
    the device (`hw` given) lays out string columns past `hw` bytes as
    long strings; a copy to the host flattens them."""
    b = b.repadded(row_bucket(n))
    cols = list(b.columns)
    for i, c in enumerate(cols):
        if hw is None and c.overflow is not None or \
                hw is not None and c.is_string and c.data.shape[1] > hw:
            cols[i] = _relayout(c, n, hw)
    b = ColumnarBatch(b.schema, tuple(cols), b.num_rows)
    leaves = [c.leaves() for c in b.columns]
    card = device if device.type == "cuda" else b.device
    if card.type == "cuda":
        if device.type == "cuda":
            leaves = [[t.pin_memory() for t in ts] for ts in leaves]
        stream = torch.cuda.current_stream(card)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record(stream)
    moved = [[t.to(device, non_blocking=device.type == "cuda") for t in ts]
             for ts in leaves]
    if card.type == "cuda":
        end.record(stream)
        events.append((start, end))
    return ColumnarBatch(b.schema, tuple(
        Column.from_leaves(c.dtype, ts, c.overflow is not None)
        for c, ts in zip(b.columns, moved)),
        torch.tensor(n, dtype=torch.int32, device=device))


def host_batch_to_device(hb: HostBatch, device: torch.device,
                         conf=None) -> ColumnarBatch:
    """A host batch on `device`, in the row bucket of its rows (JAX
    `row_bucket(n, op="transition")`; the port has no bucket tuner to
    attribute it to), strings past the head width of `conf` as long
    strings."""
    t0 = time.perf_counter_ns()
    tm = TaskMetrics.get()
    n = hb.row_count()
    out = _copy(hb, n, device, tm.to_device_copies, head_width(conf))
    tm.to_device_rows += n
    tm.to_device_bytes += out.device_memory_size()
    tm.to_device_ns += time.perf_counter_ns() - t0
    return out


def device_batch_to_host(b: ColumnarBatch) -> HostBatch:
    """A device batch on the CPU, cut to its live rows' row bucket."""
    t0 = time.perf_counter_ns()
    tm = TaskMetrics.get()
    n = b.row_count()
    out = _copy(b, n, HOST, tm.to_host_copies)
    tm.to_host_rows += n
    tm.to_host_bytes += out.device_memory_size()
    tm.to_host_ns += time.perf_counter_ns() - t0
    return out


class TpuFromCpuExec(TpuExec):
    """Device exec over a host subtree's output (a leaf of the device
    plan: the distribution pass stops here, fusion walks into it)."""

    def __init__(self, cpu_plan, conf, device: torch.device):
        super().__init__([], conf, device)
        self.cpu_plan = cpu_plan

    @property
    def output(self) -> Schema:
        return self.cpu_plan.output

    def do_execute(self) -> Iterator[ColumnarBatch]:
        for hb in self.cpu_plan.execute_cpu():
            yield host_batch_to_device(hb, self.device, self.conf)

    def tree_string(self, indent: int = 0) -> str:
        return ("  " * indent + "TpuFromCpuExec\n"
                + self.cpu_plan.tree_string(indent + 1))


class CpuFromTpuExec:
    """Host plan node over a device subtree's output (a duck-typed
    PhysicalPlan); the device stream is pulled in the device scope."""

    def __init__(self, tpu_exec: TpuExec):
        self.tpu_exec = tpu_exec
        self.children: List = []

    @property
    def output(self) -> Schema:
        return self.tpu_exec.output

    @property
    def name(self) -> str:
        return "CpuFromTpuExec"

    def execute_cpu(self) -> Iterator[HostBatch]:
        for b in scoped_stream(self.tpu_exec.execute(), host=False):
            yield device_batch_to_host(b)

    def tree_string(self, indent: int = 0) -> str:
        return ("  " * indent + "CpuFromTpuExec\n"
                + self.tpu_exec.tree_string(indent + 1))
