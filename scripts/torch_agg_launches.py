#!/usr/bin/env python3
"""Launches of kernels A and C that chip_smoke.py's tpcds_aggregates phase
makes on the card, counted on the CPU.

    python3 scripts/torch_agg_launches.py [--dir DIR]

Writes agg_tables at a small size with the card's row-group structure
(store_sales in 16 row groups, 4 merged batches; inventory in 17, 5), plans
every query as at full size (each parquet scan's footer row count reads as
the card's, so every broadcast choice is the card's), runs the phase on the
CPU with the kernel wrappers replaced by stand-ins that count their calls,
and prints (A, C) per collect of each query on each plan: the numbers
`chip_smoke.AGG_LAUNCHES` must hold. It needs no GPU; the files go to a
temporary directory unless --dir names one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

import pyarrow as pa
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from spark_rapids_tpu_torch.io.scanbase import CpuFileScanExec  # noqa: E402
from spark_rapids_tpu_torch.ops import (pallas_groupby, pallas_probe,  # noqa
                                        pallas_segsum)

ROW_GROUP = 4_096
SIZES = {"store_sales": 16 * ROW_GROUP, "date_dim": 73_049, "item": 408,
         "store": 102, "warehouse": 10, "inventory_weeks": 33}
FULL_ROWS = {"store_sales": cs.AGG_SIZES["store_sales"],
             "store_sales_dec38": cs.AGG_SIZES["store_sales"],
             "inventory": cs.AGG_SIZES["inventory_weeks"]
             * (cs.AGG_SIZES["item"] // 2) * cs.AGG_SIZES["warehouse"],
             "date_dim": cs.AGG_SIZES["date_dim"],
             "item": cs.AGG_SIZES["item"], "store": cs.AGG_SIZES["store"],
             "warehouse": cs.AGG_SIZES["warehouse"]}
MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": f"shuffle={cs.MESH_POSITIONS}",
        "spark.rapids.tpu.fusion.enabled": True}


class _Any(int):
    """A launch count that equals any other: the phase's own check is
    left to chip_smoke.py; here the counts are read."""

    def __eq__(self, other):
        return True

    __hash__ = int.__hash__


def _counting(module, name: str):
    real = getattr(module, name)

    def stand_in(*args):
        stand_in.launches += 1
        return real(*args)

    stand_in.launches, stand_in.__name__ = 0, name
    setattr(module, name, stand_in)
    return stand_in


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", help="directory for the parquet files")
    args = ap.parse_args()
    cs.PARQUET_ROW_GROUP = ROW_GROUP
    with (contextlib.nullcontext(args.dir) if args.dir else
          tempfile.TemporaryDirectory(prefix="agg_launches_")) as d:
        os.makedirs(d, exist_ok=True)
        data = cs.agg_data(pa, d, SIZES)
        CpuFileScanExec.footer_row_count = lambda self: FULL_ROWS[
            os.path.basename(self.paths[0]).replace("_aggs.parquet", "")]
        torch.cuda.synchronize = lambda *a: None
        cs.idle_share = lambda torch, fn: 0.0
        a = _counting(pallas_probe, "murmur3_rows")
        c = _counting(pallas_groupby, "segment_sum_i64")
        anything = {plan: {q: (_Any(), _Any()) for q in cs.AGG_LAUNCHES[plan]}
                    for plan in cs.AGG_LAUNCHES}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cs.aggregates_phases(
                torch, pa, MESH, (a, pallas_segsum.segment_sum_f64, c),
                sizes=SIZES, conf={"spark.rapids.tpu.fusion.pallas.mode":
                                   "force"}, device="cpu", rounds=1,
                warmup=False, want_launches=anything, data=data,
                parity_rows=2_048)
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    counted = {plan: {q: (r["launches_per_collect"]["murmur3_rows"],
                          r["launches_per_collect"]["segment_sum_i64"])
                      for q, r in rec[plan]["queries"].items()}
               for plan in ("one_device", "distributed")}
    print(json.dumps({"launches_per_collect": counted,
                      "equal_to_AGG_LAUNCHES": counted == {
                          p: dict(v) for p, v in cs.AGG_LAUNCHES.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
