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

__all__ = ["LANE", "row_bucket", "width_bucket"]

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


def width_bucket(w: int) -> int:
    """String byte-matrix width bucket: multiples of 8 up to a lane, then
    powers of two. Every bucket is a multiple of 8, so a row packs into
    whole int64 words (ops/rowops.sort_keys_for)."""
    if w <= 8:
        return 8
    if w <= LANE:
        return (w + 7) & ~7
    cap = LANE
    while cap < w:
        cap <<= 1
    return cap
