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
        import pyarrow.parquet as pq
        return pq.read_table(path, columns=list(self.output.names),
                             use_threads=False)


def parquet_scan_plan(paths: Sequence[str], conf: TpuConf, **options):
    """The scan node of `TpuSession.read_parquet`. Of the JAX package's
    options only `columns` is in this slice: `filters` (pyarrow's row-group
    pushdown) and the others raise NotImplementedError."""
    if not conf.get("spark.rapids.sql.format.parquet.enabled"):
        raise ValueError("parquet scan disabled by conf")
    columns = options.pop("columns", None)
    if options:
        raise NotImplementedError(
            f"read_parquet options {sorted(options)} are not supported by "
            "spark_rapids_tpu_torch yet")
    if not paths:
        raise ValueError("read_parquet needs at least one path")
    return CpuParquetScanExec(paths, columns=columns)
