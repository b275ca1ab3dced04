"""Dynamic file and row-group pruning from the build side's join keys
(`spark_rapids_tpu/io/dynamic_pruning.py`, the engine's form of the
reference's dynamic partition pruning, `GpuSubqueryBroadcastExec.scala`).

The planner wires a DynamicKeyFilter between a broadcast hash join and a
probe-side parquet scan whose column the join key is; the join fills it
with the build side's distinct keys after it has built its table, strictly
before it pulls the probe stream. The scan then skips every file and row
group whose footer [min, max] holds none of those keys. Pruning only skips
what cannot match: a missing or unreadable statistic keeps the row group,
and the join's result is the same with or without it.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DynamicKeyFilter", "prune_parquet_paths", "row_group_filter",
           "row_group_overlaps", "schema_col_index"]

# what a footer or statistics read may raise; the file or row group is kept
_FOOTER_ERRORS = (OSError, ValueError, TypeError, KeyError, IndexError)


class DynamicKeyFilter:
    """Runtime pruning values for one scan column, filled by the join (a
    sorted numpy array for numbers, a sorted list for strings); until then
    it prunes nothing (ready() is False)."""

    def __init__(self, column: str):
        self.column = column
        self.values = None

    def ready(self) -> bool:
        return self.values is not None

    def set_values(self, values) -> None:
        if len(values) == 0:
            self.values = []
            return
        if isinstance(values[0], (str, bytes)):
            self.values = sorted({v.decode("utf-8", "replace")
                                  if isinstance(v, bytes) else v
                                  for v in values})
            return
        arr = np.asarray(values)
        # only 1-D numbers compare with footer statistics: anything else
        # stays not ready and prunes nothing
        self.values = np.unique(arr) if arr.ndim == 1 and \
            arr.dtype.kind in "iuf" else None

    def _range_has_key(self, mn, mx) -> bool:
        vals = self.values
        if len(vals) == 0:
            return False
        try:
            if isinstance(vals, list):  # strings
                i = bisect.bisect_left(vals, mn)
                return i < len(vals) and vals[i] <= mx
            mn = np.asarray(mn).astype(vals.dtype)
            mx = np.asarray(mx).astype(vals.dtype)
            i = int(np.searchsorted(vals, mn, side="left"))
            return i < len(vals) and vals[i] <= mx
        except (TypeError, ValueError):
            return True  # incomparable statistics: cannot prune


def row_group_overlaps(meta, ci: int, rg: int,
                       filt: DynamicKeyFilter) -> bool:
    """True if row group rg MIGHT hold one of the filter's keys (so it must
    be read). Missing or unreadable statistics always read."""
    try:
        st = meta.row_group(rg).column(ci).statistics
        if st is None or not st.has_min_max:
            return True
        return filt._range_has_key(st.min, st.max)
    except _FOOTER_ERRORS:
        return True


def schema_col_index(meta) -> dict:
    """Footer column path -> ordinal."""
    sch = meta.schema
    return {sch.column(i).path: i for i in range(len(sch))}


def prune_parquet_paths(paths: Sequence[str],
                        filters: List[DynamicKeyFilter]
                        ) -> Tuple[List[str], int]:
    """Drop the files that no ready filter's keys can be in. Returns
    (kept paths, pruned count); a footer that cannot be read keeps its
    file."""
    import pyarrow.parquet as pq
    active = [f for f in filters if f.ready()]
    if not active:
        return list(paths), 0
    kept = []
    for p in paths:
        keep = True
        try:
            meta = pq.ParquetFile(p).metadata
            col_index = schema_col_index(meta)
            for f in active:
                ci = col_index.get(f.column)
                if ci is not None and not any(
                        row_group_overlaps(meta, ci, rg, f)
                        for rg in range(meta.num_row_groups)):
                    keep = False
                    break
        except _FOOTER_ERRORS:
            keep = True
        if keep:
            kept.append(p)
    return kept, len(paths) - len(kept)


def row_group_filter(meta, col_index: dict,
                     filters: List[DynamicKeyFilter]) -> Optional[set]:
    """The row-group ordinals of one file to READ (None: all of them)."""
    active = [(f, col_index.get(f.column)) for f in filters if f.ready()]
    active = [(f, ci) for f, ci in active if ci is not None]
    if not active:
        return None
    return {rg for rg in range(meta.num_row_groups)
            if all(row_group_overlaps(meta, ci, rg, f) for f, ci in active)}
