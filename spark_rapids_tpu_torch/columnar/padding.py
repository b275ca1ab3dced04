"""Bucketed-padding discipline (`spark_rapids_tpu/columnar/padding.py`
without the tuner ladder).

Device batches are padded to a small set of capacity buckets and the
logical row count travels as a device scalar. CUDA kernels take runtime
sizes, so the port keeps the buckets for layout parity with the JAX engine:
the tests rebuild a JAX batch here with the same capacity, padding and
masks, and compare the two engines row for row.
"""

from __future__ import annotations

from ..config import get_default_conf

__all__ = ["LANE", "row_bucket"]

LANE = 128


def row_bucket(n: int, min_rows: int = 0) -> int:
    """Smallest capacity bucket >= n: buckets start at max(minRows, LANE)
    and grow by spark.rapids.tpu.padding.growth (lane-aligned), default
    2x. Reads the process default conf, as the JAX engine does."""
    conf = get_default_conf()
    growth = max(1.25, conf.get("spark.rapids.tpu.padding.growth"))
    if min_rows <= 0:
        min_rows = conf.get("spark.rapids.tpu.padding.minRows")
    cap = max(min_rows, LANE)
    while cap < n:
        cap = ((int(cap * growth) + LANE - 1) // LANE) * LANE
    return cap
