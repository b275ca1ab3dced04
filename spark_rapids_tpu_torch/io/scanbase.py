"""File-scan plan node and device scan exec
(`spark_rapids_tpu/io/scanbase.py`: `CpuFileScanExec`'s footer side and
`TpuFileScanExec`'s parquet device path, without pushdown, the result
cache, mesh shards or spans).

The plan node reads only footers: the schema, the exact row count and the
per-column min/max the planner's estimates use. The exec decodes each file
on the device, row-group groups at a time (io/parquet_device.py), behind
the scan's prefetch thread. `spark.rapids.sql.format.parquet.deviceDecode.
enabled=false` is an explicit request for pyarrow's host decode, uploaded
through the Arrow path; nothing takes it unasked.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from .. import types as T
from ..columnar.batch import Schema, batch_from_arrow
from ..config import TpuConf
from ..exec.base import TpuExec, maybe_prefetch
from ..plan.nodes import PhysicalPlan

__all__ = ["CpuFileScanExec", "TpuFileScanExec"]


class CpuFileScanExec(PhysicalPlan):
    """Plan node of a file scan; a format subclass gives the schema and the
    host decode of one file."""

    format_name = "file"

    def __init__(self, paths: Sequence[str],
                 columns: Optional[List[str]] = None):
        super().__init__([])
        self.paths = [str(p) for p in paths]
        self.columns = columns
        self._schema = self._infer_schema()
        self._footer_meta_cache = None
        self._col_stats = None

    def _infer_schema(self) -> Schema:
        raise NotImplementedError

    def decode_file(self, path: str):
        """Host (pyarrow) decode of one file -> pyarrow Table."""
        raise NotImplementedError

    @property
    def output(self) -> Schema:
        return self._schema

    # -- footer statistics: the planner's estimates read these -------------
    def _footer_metas(self):
        """Parsed parquet FileMetaData of every path, read once."""
        if self._footer_meta_cache is None:
            import pyarrow.parquet as pq
            self._footer_meta_cache = [pq.ParquetFile(p).metadata
                                       for p in self.paths]
        return self._footer_meta_cache

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

    def host_tables(self, paths: Optional[Sequence[str]] = None):
        """pyarrow Tables of the files, decoded on the host."""
        for p in self.paths if paths is None else paths:
            yield self.decode_file(p)

    def _arg_string(self):
        return f"[{self.format_name}, {len(self.paths)} files]"


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

    def __init__(self, plan: CpuFileScanExec, conf: TpuConf,
                 device: torch.device):
        super().__init__([], conf, device)
        self.cpu_scan = plan
        # DynamicKeyFilters the planner wires in; the broadcast join fills
        # them before it pulls this exec's stream
        self.dynamic_filters: list = []

    @property
    def output(self) -> Schema:
        return self.cpu_scan.output

    @property
    def name(self):
        return f"TpuFileScanExec({self.cpu_scan.format_name})"

    def _arg_string(self):
        return f"[{len(self.cpu_scan.paths)} files, {self.device}]"

    def _effective_paths(self):
        """The file list after the ready dynamic filters."""
        paths = self.cpu_scan.paths
        if not self.dynamic_filters:
            return paths
        from .dynamic_pruning import prune_parquet_paths
        return prune_parquet_paths(paths, self.dynamic_filters)[0]

    def do_execute(self) -> Iterator:
        fmt = self.cpu_scan.format_name
        yield from maybe_prefetch(self._decode_batches(), self.conf,
                                  name=f"scan-{fmt}")

    def _decode_batches(self):
        if self.conf.get(
                "spark.rapids.sql.format.parquet.deviceDecode.enabled"):
            yield from self._parquet_batches()
            return
        # the host decode, asked for: pyarrow, then the Arrow upload in
        # batchSizeRows slices
        step = self.conf.batch_size_rows
        for t in self.cpu_scan.host_tables(self._effective_paths()):
            for off in range(0, t.num_rows, step):
                yield batch_from_arrow(t.slice(off, step), self.device)

    def _parquet_batches(self):
        """Device decode, one dispatch group of row groups at a time: with
        pipelining on, spark.rapids.tpu.pipeline.scan.chunksPerDispatch row
        groups per packed dispatch, else one."""
        import pyarrow.parquet as pq
        from .dynamic_pruning import row_group_filter, schema_col_index
        from .parquet_device import device_decode_file
        group = 1
        if self.conf.get("spark.rapids.tpu.pipeline.enabled"):
            group = max(self.conf.get(
                "spark.rapids.tpu.pipeline.scan.chunksPerDispatch"), 1)
        for path in self._effective_paths():
            pf = pq.ParquetFile(path)
            try:
                meta = pf.metadata
                keep = row_group_filter(meta, schema_col_index(meta),
                                        self.dynamic_filters) \
                    if self.dynamic_filters else None
                rgs = [rg for rg in range(meta.num_row_groups)
                       if keep is None or rg in keep]
                for b, _ in device_decode_file(pf, path, self.output,
                                               self.device, group, rgs):
                    yield b
            finally:
                pf.close()
