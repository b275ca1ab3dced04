"""Parquet scan plan node (`spark_rapids_tpu/io/parquet.py`)."""

from __future__ import annotations

from typing import Sequence

from ..columnar.batch import Schema
from ..config import TpuConf
from .scanbase import CpuFileScanExec, schema_from_arrow

__all__ = ["CpuParquetScanExec", "parquet_scan_plan"]


class CpuParquetScanExec(CpuFileScanExec):
    format_name = "parquet"

    def _infer_schema(self) -> Schema:
        import pyarrow as pa
        import pyarrow.parquet as pq
        schema = pq.read_schema(self.paths[0])
        if self.columns:
            schema = pa.schema([schema.field(c) for c in self.columns])
        return schema_from_arrow(schema)

    def decode_file(self, path: str):
        """pyarrow's decode of one file with the scan's row filter
        (`filters=`); timestamps are normalised by _postprocess."""
        import pyarrow.parquet as pq
        from .parquet_device import COUNTERS
        t = pq.read_table(path, columns=list(self.output.names),
                          filters=self.options.get("filters"),
                          use_threads=False)
        COUNTERS.add(host_files=1)
        return t


def parquet_scan_plan(paths: Sequence[str], conf: TpuConf, **options):
    """The scan node of `TpuSession.read_parquet`: `columns` prunes columns,
    `filters` is pyarrow's row filter (its row-group pruning, then the
    rows), which sends the scan to the host decode as in the JAX package.
    Any other option raises NotImplementedError."""
    if not conf.get("spark.rapids.sql.format.parquet.enabled"):
        raise ValueError("parquet scan disabled by conf")
    columns = options.pop("columns", None)
    unknown = sorted(set(options) - {"filters"})
    if unknown:
        raise NotImplementedError(
            f"read_parquet options {unknown} are not supported by "
            "spark_rapids_tpu_torch yet")
    if not paths:
        raise ValueError("read_parquet needs at least one path")
    return CpuParquetScanExec(paths, conf, columns=columns, **options)
