#!/usr/bin/env python3
"""chip_smoke.py's ordered_reports and plan_nodes phases alone on one CUDA
card, with their data sets made in two spawn workers as the script makes
them.

    python3 scripts/torch_plan_nodes_alone.py

Builds the kernels, makes the decimal star's and the joins' data sets
(`chip_smoke.prepared`, files in temporary directories it removes), runs
`ordered_phases` (Q36 with its ROLLUP among them) and
`plan_nodes_phases` on one device and under the distributed plan, and
prints each phase's JSON line, its launch counts and its seconds.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MESH = {"spark.rapids.shuffle.mode": "ICI",
        "spark.rapids.tpu.mesh.shape": "shuffle=4",
        "spark.rapids.tpu.fusion.enabled": True}


def main() -> int:
    import pyarrow as pa
    import torch

    import chip_smoke as cs
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops.pallas_groupby import segment_sum_i64
    from spark_rapids_tpu_torch.ops.pallas_probe import murmur3_rows
    from spark_rapids_tpu_torch.ops.pallas_segsum import segment_sum_f64
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    kernels = (murmur3_rows, segment_sum_f64, segment_sum_i64)
    with contextlib.ExitStack() as stack:
        dirs = {k: stack.enter_context(tempfile.TemporaryDirectory(
            prefix=f"plan_nodes_{k}_")) for k in ("decimal", "joins")}
        pool = stack.enter_context(ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")))
        futures = {k: pool.submit(cs.prepared, k, d)
                   for k, d in dirs.items()}
        cuda_build.build()
        fact, dim = cs.query_tables(pa, cs.QUERY_FACT_ROWS, cs.N_DIM,
                                    cs.KEY_SPACE, cs.N_GROUPS)
        dec = cs.loaded(futures["decimal"])
        t1 = time.monotonic()
        launches, _, _ = cs.ordered_phases(torch, pa, MESH, kernels,
                                           data=dec)
        print("ordered_reports", launches, time.monotonic() - t1,
              flush=True)
        dec = {k: dec[k] for k in ("oracle", "paths")}
        joins = cs.loaded(futures["joins"])
        t1 = time.monotonic()
        launches = cs.plan_nodes_phases(torch, pa, MESH, kernels,
                                        joins["plan_nodes"], joins, dec,
                                        fact, dim)
        print("plan_nodes", launches, time.monotonic() - t1, flush=True)
    print("total", time.monotonic() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
