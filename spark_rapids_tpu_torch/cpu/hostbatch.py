"""Host batches and host placement (`spark_rapids_tpu/cpu/hostbatch.py`).

The JAX CPU engine is a numpy interpreter over exact-length host vectors.
The port's host engine is instead its own execs, built on
`torch.device("cpu")`: a `HostBatch` is the port's `ColumnarBatch` with
every tensor on the CPU, and a host plan node (`PhysicalPlan.execute_cpu`)
runs the exec of its kind over its children's host batches.

`run_host` pulls a host exec's stream inside the host placement scope
(`scoped_stream`), which `on_host()` reads. Inside
that scope the memory layer's seams stand aside, as the JAX CPU nodes
have none: the budget neither reserves nor releases,
a spillable batch holds its batch in place (no catalog entry, no
semaphore permit), and no prefetch thread starts. The seams read the
scope, never the tensors' device, so a device plan run on the CPU (the
tests) keeps them. `CpuFromTpuExec` pulls its device stream in the
device scope.

The host engine reads its conf (ANSI, batch sizes) from the thread's
`host_conf`, which the session sets for each collect, as the JAX engine
sets its CPU ANSI mode (`plan/nodes.py` `set_ansi_mode`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

import torch

from ..columnar.batch import ColumnarBatch, Schema, batch_from_arrow
from ..config import TpuConf, get_default_conf

__all__ = ["HostBatch", "HOST", "host_batch_from_arrow", "on_host",
           "scoped_stream", "set_host_conf", "host_conf", "HostStreamExec",
           "run_host"]

HOST = torch.device("cpu")

# the port's batch, every tensor on the CPU
HostBatch = ColumnarBatch

_TLS = threading.local()


def host_batch_from_arrow(table) -> HostBatch:
    """Strings at any width are the flat matrix on the host."""
    return batch_from_arrow(table, HOST, flat=True)


def on_host() -> bool:
    """True while this thread runs a host exec's stream."""
    return getattr(_TLS, "host", False)


@contextlib.contextmanager
def _placement(host: bool):
    prev = on_host()
    _TLS.host = host
    try:
        yield
    finally:
        _TLS.host = prev


def scoped_stream(stream, host: bool) -> Iterator:
    """`stream`'s items, each pulled (and the stream closed) inside the
    placement scope `host`; the consumer runs in its own scope between
    pulls."""
    it = iter(stream)
    try:
        while True:
            with _placement(host):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            with _placement(host):
                close()


def set_host_conf(conf: Optional[TpuConf]) -> None:
    _TLS.conf = conf


def host_conf() -> TpuConf:
    return getattr(_TLS, "conf", None) or get_default_conf()


from ..exec.base import TpuExec  # noqa: E402  (exec.base imports this module's users)


class HostStreamExec(TpuExec):
    """A host node's input inside its host exec: the child plan's
    `execute_cpu()` batches, as a leaf exec on the CPU."""

    def __init__(self, plan, conf: TpuConf):
        super().__init__([], conf, HOST)
        self.plan = plan

    @property
    def output(self) -> Schema:
        return self.plan.output

    def do_execute(self):
        return self.plan.execute_cpu()

    def tree_string(self, indent: int = 0) -> str:
        return self.plan.tree_string(indent)


def run_host(ex: TpuExec) -> Iterator[HostBatch]:
    """The output batches of `ex`, a host node's exec over HostStreamExec
    inputs, its stream pulled in the host scope; counts one host node
    run."""
    from ..utils.metrics import TaskMetrics
    TaskMetrics.get().host_nodes_run += 1
    return scoped_stream(ex.execute(), host=True)
