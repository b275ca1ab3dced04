"""Exec operator base (`spark_rapids_tpu/exec/base.py`).

An exec produces an iterator of device `ColumnarBatch`es: the pull loop.
Every kernel is an eager function on torch tensors, so there is no compile
service and no jit; host code between kernels handles iteration and the
few host syncs (join capacities) the engine pays on purpose.

`PrefetchIterator` / `maybe_prefetch` run a file scan's decode one or two
batches ahead of its consumer on a background thread (the scan seam of the
JAX package's pipelined execution). Each prefetched batch waits parked as a
`SpillableColumnarBatch`, so the budget sees it and may spill it.

ANSI errors (JAX `kernel_errors`/`raise_kernel_errors`): the expressions
append a device flag and a message for each check (expr/base.py
`ansi_raise`); the exec reads a batch's flags in ONE host copy, beside
whatever it reads for that batch anyway (a join's slot totals, a row
count), and raises the first violation in evaluation order, which is the
JAX engine's order. `COUNTERS.flag_reads` counts the host reads made for
the flags alone: the syncs ANSI mode adds.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..columnar.batch import ColumnarBatch, Schema
from ..config import TpuConf, get_default_conf
from ..errors import AnsiViolation
from ..expr.base import EvalContext, Vec

__all__ = ["TpuExec", "UnaryTpuExec", "batch_vecs", "vecs_to_batch",
           "device_ctx", "read_flags", "check_errors", "Counters",
           "COUNTERS", "PrefetchIterator", "maybe_prefetch"]


class Counters:
    """Thread-safe named counts since the last reset(); a subclass names
    its fields in `_FIELDS`."""

    _FIELDS: Tuple[str, ...] = ()

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for f in self._FIELDS:
                setattr(self, f, 0)

    def add(self, **counts) -> None:
        with self._lock:
            for f, n in counts.items():
                setattr(self, f, getattr(self, f) + n)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self._FIELDS}


class AnsiCounters(Counters):
    """Host reads made only to read ANSI error flags (`flag_reads`)."""

    _FIELDS = ("flag_reads",)


COUNTERS = AnsiCounters()


class TpuExec:
    """`device` is where the exec's batches live: given explicitly at the
    leaves (scans), inherited from the first child everywhere else. A
    host plan node's exec pulls its stream in the host placement scope
    (`cpu.hostbatch.scoped_stream`), where `on_host()` holds and the memory
    layer's seams stand aside."""

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


def device_ctx(batch: ColumnarBatch, ansi: bool = False) -> EvalContext:
    return EvalContext(batch.row_mask(), ansi)


def read_flags(errors: Sequence, values: Sequence[torch.Tensor] = ()
               ) -> Tuple[List[int], Optional[str]]:
    """The ANSI flags of `errors` and `values` (integer device scalars) in
    one host copy: (the values as ints, the message of the first flag set,
    or None). Flags with no values to ride on count a `flag_reads`."""
    if not errors:
        return (torch.stack(list(values)).tolist() if values else []), None
    if not values:
        COUNTERS.add(flag_reads=1)
    host = torch.stack([v.to(torch.int64) for v in values] +
                       [f.to(torch.int64) for f, _ in errors]).tolist()
    k = len(values)
    first = next((m for hit, (_, m) in zip(host[k:], errors) if hit), None)
    return host[:k], first


def check_errors(errors: Sequence,
                 values: Sequence[torch.Tensor] = ()) -> List[int]:
    """read_flags, raising AnsiViolation for the first flag set."""
    vals, first = read_flags(errors, values)
    if first is not None:
        raise AnsiViolation(first)
    return vals


def batch_vecs(batch: ColumnarBatch) -> List[Vec]:
    return [Vec.from_column(c) for c in batch.columns]


def vecs_to_batch(schema: Schema, vecs: Sequence[Vec],
                  num_rows) -> ColumnarBatch:
    device = vecs[0].data.device
    return ColumnarBatch(schema, tuple(v.to_column() for v in vecs),
                         torch.as_tensor(num_rows, dtype=torch.int32,
                                         device=device))


_END = object()


class _Failure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchIterator:
    """Bounded-depth prefetch of an upstream batch iterator on a background
    thread, so the host half of the next batch's decode (page walks, packing,
    the copy) overlaps the consumer's device work.

      * At most `depth` batches wait in the queue, each parked as a
        SpillableColumnarBatch: the budget sees them (note_parked), and a
        tight one spills them to the host instead of letting the pipeline
        hold device memory unseen.
      * The producer works for the consumer's task: it adopts the task's
        TaskMetrics and its admission hold (adopt_task_hold), taking no
        permit of its own, and the consumer takes each parked batch back
        without one (`get_batch(acquire_semaphore=False)`).
      * Every exception the producer raises reaches the consumer with its
        own type, and the producer thread always ends.
      * A consumer that stops early (an error downstream, a closed
        generator) stops the producer, closes every parked batch and joins
        the thread.
      * The producer builds its tensors on the device the scan names; the
        thread's current CUDA device plays no part.
    """

    _PUT_POLL_S = 0.02

    def __init__(self, inner: Iterator[ColumnarBatch], depth: int,
                 name: str = "prefetch"):
        from ..memory.semaphore import TpuSemaphore
        from ..utils.metrics import TaskMetrics
        self._inner = inner
        self._name = name
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._tm = TaskMetrics.get()  # the consumer's (task's) metrics
        self._sem = TpuSemaphore.get()
        self._tm.prefetch_threads += 1
        self._thread = threading.Thread(target=self._produce,
                                        name=f"srtpu-{name}", daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        from ..memory.spillable import SpillableColumnarBatch
        from ..utils.metrics import TaskMetrics
        TaskMetrics.adopt(self._tm)
        self._sem.adopt_task_hold()  # ride the task's admission permit
        try:
            for batch in self._inner:
                item = SpillableColumnarBatch(batch)
                del batch
                self._tm.prefetch_batches += 1
                if not self._put(item):
                    item.close()  # the consumer is gone
                    return
            self._put(_END)
        except BaseException as e:  # noqa: BLE001 -- crosses the queue
            self._put(_Failure(e))
        finally:
            # a consumer that stopped early leaves the upstream generator
            # suspended: close it here, on its own thread, so its cleanup
            # (file handles, the multi-file reader's queued decodes) runs
            # before the thread ends
            close = getattr(self._inner, "close", None)
            if close is not None:
                close()
            # unwind this thread's counts; the adopted permit stays the
            # consumer's
            self._sem.complete_task()

    def _put(self, item) -> bool:
        """A put that gives up once the consumer has stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._PUT_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _get(self):
        """A get that notices a producer that died without its end token."""
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive():
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            f"prefetch producer '{self._name}' died without "
                            "a result") from None

    def __iter__(self) -> Iterator[ColumnarBatch]:
        try:
            while True:
                t0 = time.monotonic_ns()
                item = self._get()
                self._tm.prefetch_stall_ns += time.monotonic_ns() - t0
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                try:
                    batch = item.get_batch(acquire_semaphore=False)
                finally:
                    item.close()
                yield batch
        finally:
            self.close()

    def close(self) -> None:
        """Stop the producer, close what it parked, and join it; drain once
        more after the join for an item put while the first drain ran."""
        self._stop.set()
        for _ in range(2):
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not _END and not isinstance(item, _Failure):
                    item.close()
            self._thread.join(timeout=10.0)


def maybe_prefetch(inner: Iterator[ColumnarBatch], conf: Optional[TpuConf],
                   name: str = "prefetch") -> Iterator[ColumnarBatch]:
    """`inner` behind a PrefetchIterator when pipelined execution is on
    (`spark.rapids.tpu.pipeline.enabled`, depth
    `spark.rapids.tpu.pipeline.prefetch.depth`); otherwise, and on the
    host engine, `inner` itself, with no thread."""
    from ..cpu.hostbatch import on_host
    conf = conf or get_default_conf()
    depth = conf.get("spark.rapids.tpu.pipeline.prefetch.depth")
    if on_host() or not conf.get("spark.rapids.tpu.pipeline.enabled") or \
            depth < 1:
        return inner
    return iter(PrefetchIterator(inner, depth, name))
