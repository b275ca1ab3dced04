#!/usr/bin/env python3
"""Where the engine query's time goes on one NVIDIA GPU.

    python3 scripts/torch_query_profile.py [--distributed] [--pallas MODE]
                                           [--star QUERY] [--out DIR]

DIR defaults to profile_out/ (git-ignored).

Runs chip_smoke.py's engine query (filter -> broadcast join -> grouped
aggregate, fusion on) through spark_rapids_tpu_torch at chip_smoke.py's
size (16,777,216 fact rows), warms it up, then
traces one warm collect() with torch.profiler. With --distributed the query
runs under chip_smoke.py's distributed plan (ICI shuffle over a 4-position
mesh: fused partial aggregate -> key exchange -> per-shard final). --pallas
sets spark.rapids.tpu.fusion.pallas.mode (auto or off). --star q3|q7|q36
traces chip_smoke.py's star-schema report of that name instead, at its
size (16,777,216 sales, SF10 dimensions). Prints one JSON
line: wall time, device busy time (the union of kernel intervals on the
card), the device's idle share, and the largest kernels by device time; the
full key_averages table goes to
DIR/query_profile[_QUERY][_distributed]_MODE.txt.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--pallas", choices=("auto", "off"), default="auto")
    ap.add_argument("--star", choices=("q3", "q7", "q36"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_query_profile: no CUDA device", file=sys.stderr)
        return 2
    import pyarrow as pa

    import chip_smoke as cs
    from spark_rapids_tpu_torch.plugin import TpuSession

    conf = {"spark.rapids.tpu.fusion.enabled": True,
            "spark.rapids.tpu.fusion.pallas.mode": args.pallas}
    if args.distributed:
        conf.update({"spark.rapids.shuffle.mode": "ICI",
                     "spark.rapids.tpu.mesh.shape":
                         f"shuffle={cs.MESH_POSITIONS}"})
    if args.star:
        star = cs.star_tables(pa, cs.STAR_SALES_ROWS, *cs.STAR_DIMS.values())
        df = cs.star_queries(TpuSession(conf), cs.star_namespace(),
                             star)[args.star]
    else:
        fact, dim = cs.query_tables(pa, cs.QUERY_FACT_ROWS, cs.N_DIM,
                                    cs.KEY_SPACE, cs.N_GROUPS)
        df = cs.main_query(TpuSession(conf), fact, dim)
    df.collect()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        df.collect()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = cs.device_busy_s(torch, prof)
    by_kernel = {}
    for e in dev_events:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = "query_profile" + (f"_{args.star}" if args.star else "") + \
        ("_distributed" if args.distributed else "")
    (out / f"{name}_{args.pallas}.txt").write_text(prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=60))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "query": args.star or "engine",
        "fact_rows": cs.QUERY_FACT_ROWS,
        "plan": "distributed" if args.distributed else "single",
        "pallas_mode": args.pallas, "wall_s": wall_s,
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall_s,
        "device_events": len(dev_events),
        "top_kernels_ms": [[name[:80], ms] for name, ms in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
