#!/usr/bin/env python3
"""TPC-DS q28 (chip_smoke.join_queries') with and without scan pushdown on
one CUDA card: warm walls in turns, then one collect of each under
torch.profiler.

    python3 scripts/torch_q28_pushdown_profile.py [--rounds N]

store_sales holds 16,777,216 rows in row groups of 1,048,576 (join_tables
at JOIN_SIZES, the other sales tables cut: q28 reads store_sales alone),
in a temporary directory it removes. Prints the walls of q28 unpushed and
pushed, each also without the scan's prefetch thread, in alternating
order; then for one profiled collect of each: its wall, the device's busy
seconds, the counts of CUDA synchronizations and copies, and the top
device and host ops.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PUSHDOWN = {"spark.rapids.tpu.scan.pushdown.enabled": True}
NO_PREFETCH = {"spark.rapids.tpu.pipeline.prefetch.depth": 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.plugin import TpuSession
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cuda_build.build()
    sizes = dict(cs.JOIN_SIZES, catalog_sales=1024, web_sales=1024,
                 customer=1000, customer_address=1000,
                 customer_demographics=1000)
    with tempfile.TemporaryDirectory(prefix="q28_") as d:
        paths = cs.write_parquet(pq, cs.join_tables(pa, sizes), d,
                                 tag="_q28")
        base = dict(cs.JOINS_CONF, **{"spark.rapids.tpu.fusion.enabled":
                                      True})
        variants = {"unpushed": {}, "pushed": PUSHDOWN,
                    "unpushed_no_prefetch": NO_PREFETCH,
                    "pushed_no_prefetch": dict(PUSHDOWN, **NO_PREFETCH)}
        qs = {}
        for name, extra in variants.items():
            qs[name] = cs.join_queries(TpuSession(dict(base, **extra)),
                                       cs.join_namespace(), paths)["q28"]
            qs[name].collect()  # warm-up
        walls = {name: [] for name in qs}
        for i in range(args.rounds):
            order = list(qs.items())
            for name, q in order if i % 2 == 0 else reversed(order):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                q.collect()
                torch.cuda.synchronize()
                walls[name].append(round(time.perf_counter() - t0, 3))
        print("walls", walls, flush=True)
        for name in ("unpushed", "pushed"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                qs[name].collect()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ev = prof.key_averages()
            busy = sum(e.self_device_time_total for e in ev) / 1e6
            syncs = {e.key: e.count for e in ev
                     if "ynchronize" in e.key or "emcpy" in e.key}
            print(name, "wall", round(wall, 3), "device busy s",
                  round(busy, 3), "syncs and copies", syncs, flush=True)
            for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:10]:
                print("  device", e.key[:60], e.count,
                      round(e.self_device_time_total / 1e3, 2), flush=True)
            for e in sorted(ev, key=lambda e: -e.self_cpu_time_total)[:12]:
                print("  host", e.key[:60], e.count,
                      round(e.self_cpu_time_total / 1e3, 2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
