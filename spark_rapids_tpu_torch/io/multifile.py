"""Multi-file reader strategies of the host decode
(`spark_rapids_tpu/io/multifile.py`).

Three strategies, as in the reference's parquet scan:
  PERFILE       one file at a time: decode, then slice;
  COALESCING    every file's table decoded, concatenated, then sliced into
                batchSizeRows batches (many small files, few batches);
  MULTITHREADED the files decode on a process-wide thread pool, at most
                maxNumFilesParallel at once, and come out in the order they
                were submitted.
AUTO picks MULTITHREADED when a path has a cloud scheme
(`spark.rapids.cloudSchemes`), COALESCING for more than one file, PERFILE
otherwise. Every table is cut into `batchSizeRows` slices.

The pool lives as long as the process, as the JAX package's does. A scan
that stops early or fails cancels the decodes it has queued and waits for
the ones already running, so no pool thread works for a scan that ended.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Callable, Iterator, List, Optional, Sequence
from urllib.parse import urlparse

from ..config import TpuConf, get_default_conf

__all__ = ["reader_thread_pool", "choose_reader_type", "FileBatchIterator"]

_pool_lock = threading.Lock()
_pool: Optional[cf.ThreadPoolExecutor] = None


def reader_thread_pool(num_threads: int) -> cf.ThreadPoolExecutor:
    """The process-wide reader pool, made at its first use."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = cf.ThreadPoolExecutor(
                max_workers=num_threads, thread_name_prefix="multifile-reader")
        return _pool


def choose_reader_type(paths: Sequence[str], conf: TpuConf) -> str:
    rt = conf.get("spark.rapids.sql.format.parquet.reader.type")
    if rt != "AUTO":
        return rt
    cloud = {s.strip() for s in conf.get("spark.rapids.cloudSchemes")
             .split(",")}
    if any(urlparse(str(p)).scheme in cloud for p in paths):
        return "MULTITHREADED"
    return "COALESCING" if len(paths) > 1 else "PERFILE"


class FileBatchIterator:
    """Host Arrow tables of `paths` under a reader strategy;
    `decode_fn(path) -> pa.Table` is the format's host decode."""

    def __init__(self, paths: Sequence[str], decode_fn: Callable,
                 conf: TpuConf = None, batch_rows: Optional[int] = None):
        self.paths = list(paths)
        self.decode_fn = decode_fn
        self.conf = conf or get_default_conf()
        self.reader_type = choose_reader_type(self.paths, self.conf)
        self.batch_rows = batch_rows or self.conf.batch_size_rows

    def __iter__(self) -> Iterator:
        if not self.paths:
            return
        if self.reader_type == "PERFILE":
            for p in self.paths:
                yield from self._slices(self.decode_fn(p))
        elif self.reader_type == "COALESCING":
            import pyarrow as pa
            tables = [self.decode_fn(p) for p in self.paths]
            non_empty = [t for t in tables if t.num_rows]
            if not non_empty:
                yield tables[0]  # the schema of the all-empty case
            else:
                yield from self._slices(pa.concat_tables(non_empty)
                                        if len(non_empty) > 1
                                        else non_empty[0])
        else:
            yield from self._multithreaded()

    def _multithreaded(self) -> Iterator:
        threads = self.conf.get(
            "spark.rapids.sql.format.parquet.multiThreadedRead.numThreads")
        max_par = max(self.conf.get("spark.rapids.sql.format.parquet."
                                    "multiThreadedRead.maxNumFilesParallel"),
                      1)
        pool = reader_thread_pool(threads)
        pending: List[cf.Future] = []
        idx = 0
        try:
            # keep up to max_par decodes in flight, yield in submit order
            while idx < len(self.paths) or pending:
                while idx < len(self.paths) and len(pending) < max_par:
                    pending.append(pool.submit(self.decode_fn,
                                               self.paths[idx]))
                    idx += 1
                yield from self._slices(pending.pop(0).result())
        finally:
            for fut in pending:
                fut.cancel()
            cf.wait(pending)

    def _slices(self, table) -> Iterator:
        n = table.num_rows
        if n == 0:
            yield table
            return
        for off in range(0, n, self.batch_rows):
            yield table.slice(off, min(self.batch_rows, n - off))
