#!/usr/bin/env python3
"""Where the engine query's time goes on one NVIDIA GPU.

    python3 scripts/torch_query_profile.py [--distributed] [--pallas MODE]
                                           [--star QUERY] [--parquet]
                                           [--conf KEY=VALUE ...] [--out DIR]

DIR defaults to profile_out/ (git-ignored).

Runs chip_smoke.py's engine query (filter -> broadcast join -> grouped
aggregate, fusion on) through spark_rapids_tpu_torch at chip_smoke.py's
size (16,777,216 fact rows), warms it up, then
traces one warm collect() with torch.profiler. With --distributed the query
runs under chip_smoke.py's distributed plan (ICI shuffle over a 4-position
mesh: fused partial aggregate -> key exchange -> per-shard final). --pallas
sets spark.rapids.tpu.fusion.pallas.mode (auto or off). --star q3|q7|q36
traces chip_smoke.py's star-schema report of that name instead, at its
size (16,777,216 sales, SF10 dimensions). --parquet writes the query's
tables to parquet files (row groups of 1,048,576 rows, snappy) in a
temporary directory and reads them with read_parquet; it also traces the
scan alone (the device decode of the same files, as the query's scans run
it) and reports its device busy time and its host-to-device copy time, so
the decode's share of the query's device time shows. --conf sets any other
session setting (for example
spark.rapids.sql.dynamicFilePruning.enabled=false). Prints one JSON line:
wall time, device busy time (the union of kernel intervals on the card),
the device's idle share, the host-to-device copy time, and the largest
kernels by device time; the full key_averages table goes to
DIR/query_profile[_QUERY][_parquet][_distributed]_MODE.txt.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--pallas", choices=("auto", "off"), default="auto")
    ap.add_argument("--star", choices=("q3", "q7", "q36"))
    ap.add_argument("--parquet", action="store_true")
    ap.add_argument("--conf", action="append", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="query_profile_") as d:
        return run(args, d)


def h2d_ms(torch, prof) -> float:
    """Device time of the host-to-device copies in a trace."""
    return sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "HtoD" in e.name)


def scan_alone(torch, profile, activities, cs, paths, conf, device):
    """Trace the device decode of the query's files alone, as its scans run
    it: (wall s, device busy s, host-to-device copy ms)."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.io.parquet_device import device_decode_file
    tc = TpuConf(conf)
    group = tc.get("spark.rapids.tpu.pipeline.scan.chunksPerDispatch") \
        if tc.get("spark.rapids.tpu.pipeline.enabled") else 1

    def decode_all():
        for path in paths.values():
            pf = pq.ParquetFile(path)
            schema = Schema.from_arrow(pf.schema_arrow)
            for _ in device_decode_file(pf, path, schema, device, group):
                pass
        torch.cuda.synchronize()

    decode_all()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        decode_all()
        wall = time.perf_counter() - t0
    return wall, cs.device_busy_s(torch, prof), h2d_ms(torch, prof)


def run(args, tmp: str) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("torch_query_profile: no CUDA device", file=sys.stderr)
        return 2
    import pyarrow as pa
    import pyarrow.parquet as pq

    import chip_smoke as cs
    from spark_rapids_tpu_torch.plugin import TpuSession

    conf = {"spark.rapids.tpu.fusion.enabled": True,
            "spark.rapids.tpu.fusion.pallas.mode": args.pallas}
    conf.update(kv.split("=", 1) for kv in args.conf)
    if args.distributed:
        conf.update({"spark.rapids.shuffle.mode": "ICI",
                     "spark.rapids.tpu.mesh.shape":
                         f"shuffle={cs.MESH_POSITIONS}"})
    paths = None
    if args.star:
        tables = cs.star_tables(pa, cs.STAR_SALES_ROWS,
                                *cs.STAR_DIMS.values())
        if args.parquet:
            paths = cs.write_parquet(pq, tables, tmp)
        df = cs.star_queries(TpuSession(conf), cs.star_namespace(),
                             tables, paths)[args.star]
    else:
        fact, dim = cs.query_tables(pa, cs.QUERY_FACT_ROWS, cs.N_DIM,
                                    cs.KEY_SPACE, cs.N_GROUPS)
        tables = {"fact": fact, "dim": dim}
        if args.parquet:
            paths = cs.write_parquet(pq, tables, tmp)
        df = cs.main_query(TpuSession(conf), fact, dim, paths)
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
        ("_parquet" if args.parquet else "") + \
        ("_distributed" if args.distributed else "")
    scan = None
    if args.parquet:
        wall, busy, h2d = scan_alone(
            torch, profile, [ProfilerActivity.CPU, ProfilerActivity.CUDA],
            cs, paths, conf, torch.device("cuda", 0))
        scan = {"wall_s": wall, "device_busy_s": busy, "h2d_ms": h2d}
    (out / f"{name}_{args.pallas}.txt").write_text(prof.key_averages().table(
        sort_by="cuda_time_total", row_limit=60))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "card": smi, "query": args.star or "engine",
        "fact_rows": cs.QUERY_FACT_ROWS, "parquet": args.parquet,
        "conf": args.conf,
        "plan": "distributed" if args.distributed else "single",
        "pallas_mode": args.pallas, "wall_s": wall_s,
        "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall_s,
        "device_events": len(dev_events), "h2d_ms": h2d_ms(torch, prof),
        "scan_alone": scan,
        "top_kernels_ms": [[name[:80], ms] for name, ms in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
