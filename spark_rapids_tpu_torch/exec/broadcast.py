"""Broadcast exchange (`spark_rapids_tpu/exec/broadcast.py`), in process.

The child executes once across all consumers; its batches are
concatenated into one device batch that every `do_execute()` hands out.
The JAX engine serializes that batch to a host blob (the payload a
multi-host driver would ship); a single-GPU engine has no consumer on
another device, so this slice keeps the device batch and serializes
nothing.
"""

from __future__ import annotations

from typing import Iterator, Optional

from ..columnar.batch import ColumnarBatch, Schema
from .base import TpuExec, UnaryTpuExec
from .coalesce import concat_batches

__all__ = ["TpuBroadcastExchangeExec"]


class TpuBroadcastExchangeExec(UnaryTpuExec):
    def __init__(self, child: TpuExec, conf=None):
        super().__init__([child], conf)
        self._batch: Optional[ColumnarBatch] = None
        self._done = False

    @property
    def output(self) -> Schema:
        return self.child.output

    def do_execute(self) -> Iterator[ColumnarBatch]:
        if not self._done:
            batches = list(self.child.execute())
            self._batch = concat_batches(batches) if batches else None
            self._done = True
        if self._batch is not None:
            yield self._batch

    def _arg_string(self):
        return "[device-resident]"
