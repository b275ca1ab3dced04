"""OOM retry (`spark_rapids_tpu/memory/retry.py`; reference
`RmmRapidsRetryIterator.scala:28-120`: withRetry / withRetryNoSplit).

`with_retry(input, fn, split_fn)` runs the idempotent `fn`; on RetryOOM it
backs off (the budget already tried a synchronous spill) and reruns; on
SplitAndRetryOOM it splits the input in two and processes both halves, the
reference's control flow. Without the JAX package's scheduler there is no
query deadline, so `deadline_backoff` keeps only the backoff.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Iterator, List, TypeVar

from ..errors import RetryOOM, SplitAndRetryOOM
from ..utils.metrics import TaskMetrics

__all__ = ["MAX_RETRIES", "deadline_backoff", "split_batch_halves",
           "with_retry", "with_retry_no_split",
           "with_retry_no_split_spillable"]

A = TypeVar("A")
R = TypeVar("R")

MAX_RETRIES = 8


def deadline_backoff(backoff_s: float) -> float:
    """The backoff to sleep (the JAX function also fails fast past a query
    deadline; the port has none)."""
    return backoff_s


def split_batch_halves(spillable):
    """Default splitter of a SpillableColumnarBatch: its live rows in two
    parked halves, each a copy of exactly its rows (the JAX
    `Vec.slice_rows`); the input is closed."""
    from ..exec.base import batch_vecs, vecs_to_batch
    from .spillable import SpillableColumnarBatch
    batch = spillable.get_batch()
    n = spillable.num_rows
    if n < 2:
        raise SplitAndRetryOOM("cannot split a batch with < 2 rows")
    half = n // 2
    outs = []
    for lo, hi in ((0, half), (half, n)):
        vecs = [v.map_rows(lambda t: t[lo:hi].clone())
                for v in batch_vecs(batch)]
        outs.append(SpillableColumnarBatch(
            vecs_to_batch(batch.schema, vecs, hi - lo)))
    del batch
    spillable.close()
    return outs


def with_retry(value: A, fn: Callable[[A], R],
               split_fn: Callable[[A], List[A]] = None) -> Iterator[R]:
    """Yield fn(x) for x in the (possibly split) inputs."""
    pending: Deque[A] = deque([value])
    x: A = value
    try:
        while pending:
            x = pending.popleft()
            attempts = 0
            while True:
                try:
                    yield fn(x)
                    break
                except RetryOOM:
                    attempts += 1
                    tm = TaskMetrics.get()
                    tm.retry_count += 1
                    if attempts > MAX_RETRIES:
                        raise
                    backoff_s = deadline_backoff(
                        min(0.001 * (2 ** attempts), 0.25))
                    tm.retry_backoff_ms.append(backoff_s * 1000.0)
                    t0 = time.monotonic_ns()
                    time.sleep(backoff_s)
                    tm.retry_block_ns += time.monotonic_ns() - t0
                except SplitAndRetryOOM:
                    TaskMetrics.get().split_retry_count += 1
                    if split_fn is None:
                        raise
                    # the halves go to the FRONT: depth first, so the live
                    # set stays bounded
                    pending.extendleft(reversed(split_fn(x)))
                    break
    except BaseException:
        # a terminal failure with halves still queued: close the current
        # item and every pending one, or their catalog handles leak;
        # close() is idempotent, so callers' own closes stay safe
        for item in [x, *pending]:
            close = getattr(item, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 -- the first error wins
                    pass
        raise


def with_retry_no_split(value: A, fn: Callable[[A], R]) -> R:
    return next(with_retry(value, fn))


def with_retry_no_split_spillable(batch, fn):
    """`fn(batch)` under the retry seam with the input parked spillable
    (the shape of every retry-only operator: sort, window, a single-batch
    aggregate): a pre-flight `reserve(0)` lets the budget raise under
    pressure, RetryOOM reruns `fn` after the backoff, and SplitAndRetryOOM
    propagates to callers with a degradation path (the out-of-core sort,
    the multi-batch aggregate). The wrapper is closed on every exit.
    Callers pass a temporary, so the wrapper holds the only reference and
    a spill during a backoff frees the device memory."""
    from .budget import MemoryBudget
    from .spillable import SpillableColumnarBatch

    def run(sp):
        MemoryBudget.get().reserve(0)  # pre-flight / injection point
        out = fn(sp.get_batch())
        sp.close()
        return out

    sp0 = SpillableColumnarBatch(batch)
    del batch
    try:
        return with_retry_no_split(sp0, run)
    finally:
        sp0.close()  # a no-op when run() closed it
