"""Exec operator base (`spark_rapids_tpu/exec/base.py`).

An exec produces an iterator of device `ColumnarBatch`es: the pull loop.
Every kernel is an eager function on torch tensors, so there is no compile
service and no jit; host code between kernels handles iteration and the
few host syncs (join capacities) the engine pays on purpose.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from ..columnar.batch import ColumnarBatch, Schema
from ..config import TpuConf, get_default_conf
from ..expr.base import EvalContext, Vec

__all__ = ["TpuExec", "UnaryTpuExec", "batch_vecs", "vecs_to_batch",
           "device_ctx"]


class TpuExec:
    """`device` is where the exec's batches live: given explicitly at the
    leaves (scans), inherited from the first child everywhere else."""

    def __init__(self, children: Sequence["TpuExec"], conf: TpuConf = None,
                 device: torch.device = None):
        self.children = list(children)
        self.conf = conf or get_default_conf()
        self.device = device if device is not None else \
            (self.children[0].device if self.children else None)

    @property
    def output(self) -> Schema:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__

    def execute(self) -> Iterator[ColumnarBatch]:
        """Produce output batches (a single-partition stream)."""
        return self.do_execute()

    def do_execute(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def tree_string(self, indent: int = 0) -> str:
        s = "  " * indent + f"{self.name}{self._arg_string()}\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s

    def _arg_string(self) -> str:
        return ""


class UnaryTpuExec(TpuExec):
    @property
    def child(self) -> TpuExec:
        return self.children[0]

    @property
    def output(self) -> Schema:
        return self.child.output


def device_ctx(batch: ColumnarBatch) -> EvalContext:
    return EvalContext(batch.row_mask())


def batch_vecs(batch: ColumnarBatch) -> List[Vec]:
    return [Vec.from_column(c) for c in batch.columns]


def vecs_to_batch(schema: Schema, vecs: Sequence[Vec],
                  num_rows) -> ColumnarBatch:
    device = vecs[0].data.device
    return ColumnarBatch(schema, tuple(v.to_column() for v in vecs),
                         torch.as_tensor(num_rows, dtype=torch.int32,
                                         device=device))
