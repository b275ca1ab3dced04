"""File-scan plan node and device scan exec
(`spark_rapids_tpu/io/scanbase.py`: `CpuFileScanExec`'s footer side and host
decode, and `TpuFileScanExec`'s parquet paths with their pushdown, without
the result cache, mesh shards or spans).

The plan node reads only footers: the schema, the exact row count and the
per-column min/max the planner's estimates use. The exec decodes each file
on the device, row-group groups at a time (io/parquet_device.py), behind
the scan's prefetch thread, and takes pyarrow's host decode where the
device decode declines, as the JAX scan does:
  * a column the footer check refuses (an encoding, a codec, a type the
    decode lacks) is decoded by pyarrow and merged into the device batch;
  * a row group whose pages the device decode declines (a v2 page, a
    truncated stream) is decoded whole by pyarrow;
  * a file with no column the device can decode is decoded whole by
    pyarrow, and if no file of the scan has one, the whole scan goes
    through the multi-file reader strategies (io/multifile.py).
`filters=` and `spark.rapids.sql.format.parquet.deviceDecode.enabled=false`
send the scan to the host decode.

Under scan pushdown (plan/scan_pushdown.py) the scan carries a pushed
spec (`pushed`) and outputs its schema: the device decode runs the spec
on the compressed form (`parquet_device.device_decode_pushdown`), after
the footer statistics prune row groups (`_pushdown_prune_rgs`), and every
batch decoded another way (pyarrow's host decode of a file, a declined
row group, the reader strategies, `filters=`) goes through the exact
applier (`_apply_pushdown`). An aggregate-pushed scan that decodes
nothing emits the empty input's partials (`_agg_partial_guard`). Its
counts are `rows_pruned`, `bytes_materialized` and `rowgroups_pruned`
(the JAX rowsPruned, bytesMaterialized, rowgroupsPruned) and the
TaskMetrics `scan_*` fields. The fallback net is the JAX one,
`parquet_device.FALLBACK_ERRORS`: a malformed or unsupported stream and
I/O errors. Anything else, a failed CUDA launch among them, ends the
query. Every host decode is counted in `parquet_device.COUNTERS`.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from .. import types as T
from ..columnar.batch import Schema, batch_from_arrow
from ..columnar.strings import head_width
from ..config import TpuConf, get_default_conf
from ..exec.base import TpuExec, maybe_prefetch
from ..plan.nodes import PhysicalPlan
from .multifile import FileBatchIterator

__all__ = ["CpuFileScanExec", "TpuFileScanExec", "normalize_timestamps"]


class CpuFileScanExec(PhysicalPlan):
    """Plan node of a file scan; a format subclass gives the schema and the
    host decode of one file."""

    format_name = "file"

    def __init__(self, paths: Sequence[str], conf: TpuConf = None,
                 columns: Optional[List[str]] = None, **options):
        super().__init__([])
        self.paths = [str(p) for p in paths]
        self.conf = conf or get_default_conf()
        self.columns = columns
        self.options = options
        self._schema = self._infer_schema()
        self._footer_meta_cache = None
        self._col_stats = None
        self._host_cols = None

    def _infer_schema(self) -> Schema:
        raise NotImplementedError

    def decode_file(self, path: str):
        """Host (pyarrow) decode of one file -> pyarrow Table."""
        raise NotImplementedError

    @property
    def output(self) -> Schema:
        return self._schema

    def _postprocess(self, t):
        """The scan's columns, in order, with every timestamp in UTC
        microseconds (JAX `_postprocess`)."""
        names = list(self.output.names)
        if t.schema.names != names:
            t = t.select(names)
        return normalize_timestamps(t)

    # -- footer statistics: the planner's estimates read these -------------
    def _footer_metas(self):
        """Parsed parquet FileMetaData of every path, read once."""
        if self._footer_meta_cache is None:
            import pyarrow.parquet as pq
            self._footer_meta_cache = [pq.ParquetFile(p).metadata
                                       for p in self.paths]
        return self._footer_meta_cache

    def host_columns(self) -> dict:
        """{path: the columns the device decode cannot take}, from the
        footers, worked out once (parquet_device.host_columns)."""
        if self._host_cols is None:
            from .parquet_device import host_columns
            self._host_cols = {
                p: frozenset(host_columns(m, self.output))
                for p, m in zip(self.paths, self._footer_metas())}
        return self._host_cols

    def footer_row_count(self) -> int:
        """Exact total row count from the footers."""
        return sum(m.num_rows for m in self._footer_metas())

    def column_stats(self) -> dict:
        """{column: (min, max)} merged across files and row groups from the
        footer statistics (a column without them is absent)."""
        if self._col_stats is not None:
            return self._col_stats
        stats: dict = {}
        for meta in self._footer_metas():
            sch = meta.schema
            for i in range(len(sch)):
                name = sch.column(i).path
                for rg in range(meta.num_row_groups):
                    st = meta.row_group(rg).column(i).statistics
                    if st is None or not st.has_min_max:
                        continue
                    cur = stats.get(name)
                    stats[name] = (st.min, st.max) if cur is None else \
                        (min(cur[0], st.min), max(cur[1], st.max))
        self._col_stats = stats
        return stats

    def host_tables(self, paths: Optional[Sequence[str]] = None,
                    conf: Optional[TpuConf] = None):
        """pyarrow Tables of the files, decoded on the host under the
        reader strategy of `conf` (the plan's by default), cut into
        batchSizeRows slices."""
        for t in FileBatchIterator(self.paths if paths is None else paths,
                                   self.decode_file, conf or self.conf):
            yield self._postprocess(t)

    def execute_cpu(self):
        """The host engine's scan (JAX `execute_cpu`): pyarrow's decode
        under the reader strategy, in batchSizeRows slices."""
        from ..cpu.hostbatch import host_batch_from_arrow, host_conf
        from ..utils.metrics import TaskMetrics
        TaskMetrics.get().host_nodes_run += 1
        for t in self.host_tables(conf=host_conf()):
            yield host_batch_from_arrow(t)

    def _arg_string(self):
        return f"[{self.format_name}, {len(self.paths)} files]"


def normalize_timestamps(t):
    """Timestamps of any unit and zone -> microseconds in UTC, Spark's
    TimestampType, by pyarrow's safe cast: a value with a sub-microsecond
    remainder raises ArrowInvalid, as in the JAX package."""
    import pyarrow as pa
    cols, changed = [], False
    for f in t.schema:
        col = t.column(f.name)
        if pa.types.is_timestamp(f.type) and (f.type.unit != "us"
                                              or f.type.tz != "UTC"):
            col = col.cast(pa.timestamp("us", tz="UTC"))
            changed = True
        cols.append(col)
    return pa.table(cols, names=t.schema.names) if changed else t


def schema_from_arrow(schema) -> Schema:
    """Schema of a file's Arrow schema; a column whose Arrow type the port
    has no type for raises NotImplementedError (planning refuses the
    others)."""
    types = []
    for f in schema:
        try:
            types.append(T.from_arrow(f.type))
        except TypeError as e:
            raise NotImplementedError(
                f"column {f.name} of type {f.type} is not supported by "
                "spark_rapids_tpu_torch yet") from e
    return Schema(tuple(schema.names), tuple(types))


class TpuFileScanExec(TpuExec):
    """Device exec over a file scan (the reference's GpuFileSourceScanExec)."""

    # the pushed spec, set by plan/scan_pushdown.install_pushdown; a class
    # attribute, so a scan without pushdown carries no state of it
    pushed = None

    def __init__(self, plan: CpuFileScanExec, conf: TpuConf,
                 device: torch.device):
        super().__init__([], conf, device)
        self.cpu_scan = plan
        # DynamicKeyFilters the planner wires in; the broadcast join fills
        # them before it pulls this exec's stream
        self.dynamic_filters: list = []
        # the JAX metric colsHostDecoded: one count per file and column the
        # footer check sends to the host decode
        self.cols_host_decoded = 0

    @property
    def output(self) -> Schema:
        if self.pushed is not None:
            return self._pushed_schema
        return self.cpu_scan.output

    @property
    def name(self):
        return f"TpuFileScanExec({self.cpu_scan.format_name})"

    def _arg_string(self):
        pushed = "" if self.pushed is None else f", pushed={self.pushed!r}"
        return f"[{len(self.cpu_scan.paths)} files, {self.device}{pushed}]"

    # -- scan pushdown (plan/scan_pushdown.py) -----------------------------
    def _pushdown_applier(self):
        if self._pd_applier is None:
            from ..plan.scan_pushdown import PushdownApplier
            self._pd_applier = PushdownApplier(self.cpu_scan.output,
                                               self.pushed, self.conf)
        return self._pd_applier

    def _device_pushdown(self):
        if self._pd_device is None:
            from ..plan.scan_pushdown import DevicePushdown
            self._pd_device = DevicePushdown(self.pushed,
                                             self.cpu_scan.output,
                                             self._pushdown_applier())
        return self._pd_device

    def _pd_record(self, in_rows: int, kept: int, bytes_mat: int) -> None:
        """One decoded unit: the rows the pushed predicate dropped and the
        row-data bytes the decode materialised on the device."""
        from ..utils.metrics import TaskMetrics
        tm = TaskMetrics.get()
        pruned = max(in_rows - kept, 0)
        self.rows_pruned += pruned
        self.bytes_materialized += bytes_mat
        tm.scan_rows_pruned += pruned
        tm.scan_bytes_materialized += bytes_mat

    def _apply_pushdown(self, batch, in_rows: int):
        """A fully decoded batch through the exact applier, counted."""
        bytes_mat = int(batch.device_memory_size())
        out, kept = self._pushdown_applier().apply(batch)
        self._pd_record(in_rows, kept, bytes_mat)
        return out

    def _agg_partial_guard(self, it):
        """An aggregate-pushed scan emits at least one partial row, so the
        merge sees the unpushed plan's answer over no rows."""
        any_out = False
        for b in it:
            any_out = True
            yield b
        if not any_out:
            yield self._pushdown_applier().empty_partials(self.device)

    def _pushdown_prune_rgs(self, meta, rgs):
        """The row groups left after the footer statistics prune those no
        row of which can pass the pushed predicate."""
        from ..plan.scan_pushdown import KEY_ROWGROUP, prune_row_groups
        if self.pushed is None or self.pushed.predicate is None or \
                not rgs or not self.conf.get(KEY_ROWGROUP):
            return rgs
        from ..utils.metrics import TaskMetrics
        from .dynamic_pruning import schema_col_index
        dead = prune_row_groups(meta, schema_col_index(meta),
                                self.cpu_scan.output, self.pushed.predicate)
        kept = [rg for rg in rgs if rg not in dead]
        n = len(rgs) - len(kept)
        self.rowgroups_pruned += n
        TaskMetrics.get().scan_rowgroups_pruned += n
        return kept

    def _effective_paths(self):
        """The file list after the ready dynamic filters."""
        paths = self.cpu_scan.paths
        if not self.dynamic_filters:
            return paths
        from .dynamic_pruning import prune_parquet_paths
        return prune_parquet_paths(paths, self.dynamic_filters)[0]

    def do_execute(self) -> Iterator:
        fmt = self.cpu_scan.format_name
        inner = self._decode_batches()
        if self.pushed is not None and self.pushed.aggs:
            inner = self._agg_partial_guard(inner)
        yield from maybe_prefetch(inner, self.conf, name=f"scan-{fmt}")

    def _upload(self, t):
        return batch_from_arrow(t, self.device, conf=self.conf)

    def _host_batch(self, t):
        """The scan's batch of a table pyarrow decoded: uploaded, and
        through the applier under pushdown."""
        b = self._upload(t)
        return b if self.pushed is None else \
            self._apply_pushdown(b, t.num_rows)

    def _decode_batches(self):
        if not self.cpu_scan.options.get("filters") and self.conf.get(
                "spark.rapids.sql.format.parquet.deviceDecode.enabled"):
            yield from self._parquet_batches()
            return
        for t in self.cpu_scan.host_tables(self._effective_paths(),
                                           self.conf):
            yield self._host_batch(t)

    def _host_file_batches(self, path: str):
        """One file decoded by pyarrow, in batchSizeRows slices."""
        scan = self.cpu_scan
        for t in FileBatchIterator([path], scan.decode_file, self.conf):
            yield self._host_batch(scan._postprocess(t))

    def _parquet_batches(self):
        """Device decode, one dispatch group of row groups at a time, with
        the host decode by column, row group and file (the module
        docstring). The footer check reads the footers the plan node
        cached; each file is opened once, for its decode."""
        import pyarrow.parquet as pq
        from .dynamic_pruning import row_group_filter, schema_col_index
        from .parquet_device import (COUNTERS, device_decode_file,
                                     device_decode_pushdown)
        scan = self.cpu_scan
        names = list(scan.output.names)
        paths = self._effective_paths()
        host_cols = scan.host_columns()
        # a file with no column the device can decode is read by pyarrow
        supported = {p for p in paths if len(host_cols[p]) < len(names)}
        self.cols_host_decoded += sum(len(host_cols[p]) for p in supported)
        if not supported:
            # nothing can be decoded on the device: the reader strategies
            for t in scan.host_tables(paths, self.conf):
                yield self._host_batch(t)
            return
        dev = None if self.pushed is None else self._device_pushdown()
        group = 1
        if self.conf.get("spark.rapids.tpu.pipeline.enabled"):
            group = max(self.conf.get(
                "spark.rapids.tpu.pipeline.scan.chunksPerDispatch"), 1)
        for path in paths:
            if path not in supported:
                yield from self._host_file_batches(path)
                continue
            pf = pq.ParquetFile(path)

            def host_fallback(rg, pf=pf):
                """A row group the device decode declined, by pyarrow."""
                t = scan._postprocess(pf.read_row_group(rg, columns=names))
                COUNTERS.add(host_row_groups=1)
                return self._upload(t), t.num_rows

            try:
                meta = pf.metadata
                keep = row_group_filter(meta, schema_col_index(meta),
                                        self.dynamic_filters) \
                    if self.dynamic_filters else None
                rgs = [rg for rg in range(meta.num_row_groups)
                       if keep is None or rg in keep]
                if dev is None:
                    for b, _ in device_decode_file(
                            pf, path, scan.output, self.device, group, rgs,
                            host_cols[path], host_fallback,
                            head_width(self.conf)):
                        yield b
                    continue
                for b, _, in_rows, kept, bytes_mat in device_decode_pushdown(
                        pf, path, scan.output, self.device, dev, group,
                        self._pushdown_prune_rgs(meta, rgs), host_cols[path],
                        host_fallback, head_width(self.conf)):
                    self._pd_record(in_rows, kept, bytes_mat)
                    yield b
            finally:
                pf.close()
