#!/usr/bin/env python3
"""Where the device parquet decode's time goes on one NVIDIA GPU.

    python3 scripts/torch_parquet_profile.py [--rows N] [--rounds R]
                                             [--compression snappy|none]

Writes chip_smoke.py's engine fact table (N rows, default 16,777,216:
`k` i64, `g` i32, `v` f64, `c` i64) with pyarrow in row groups of
1,048,576 rows to a temporary directory, then decodes it on the card as
the scan does, timing each stage of the decode apart (the median over R
rounds, host clock, each stage ending in a synchronize).

One row group a dispatch (`decode_row_group`, the scan at
spark.rapids.tpu.pipeline.scan.chunksPerDispatch=1):

  host    `_host_phase`: pread, the native walk with snappy, run tables,
          PLAIN pass-through
  device  `_device_phase`: its pageable copies (counted in h2d_copies),
          run-table expansion and gathers, strings assembled eagerly

Four row groups a dispatch (`decode_row_groups_fused`, the default):

  host    `_read_chunks`: `_host_phase` of each row group of the group
  pack    `_group_signatures`: every array of the group into one new
          host buffer
  copy    that buffer to the card with `.to(device)` (a pageable copy)
  pinned  the same bytes through a pinned host buffer allocated once:
          numpy -> pinned copy, then a non-blocking copy to the card
  device  `_fused_multi_decode`: run-table expansion, gathers, the merge

Prints one JSON line with the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--compression", default="snappy",
                    choices=("snappy", "none"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_parquet_profile: no CUDA device", file=sys.stderr)
        return 2
    import pyarrow as pa
    import pyarrow.parquet as pq

    import chip_smoke as cs
    from spark_rapids_tpu_torch.columnar.batch import Schema
    from spark_rapids_tpu_torch.columnar.padding import row_bucket
    from spark_rapids_tpu_torch.io import parquet_device as P

    dev = torch.device("cuda", 0)
    fact, _ = cs.query_tables(pa, args.rows, cs.N_DIM, cs.KEY_SPACE,
                              cs.N_GROUPS)
    with tempfile.TemporaryDirectory(prefix="parquet_profile_") as d:
        path = cs.write_parquet(pq, {"fact": fact}, d,
                                args.compression)["fact"]
        pf = pq.ParquetFile(path)
        schema = Schema.from_arrow(pf.schema_arrow)
        names = list(schema.names)
        nrg = pf.metadata.num_row_groups
        pinned = None
        result = {}
        for group in (1, 4):
            stages = {k: [] for k in (
                ("host", "device", "total") if group == 1 else
                ("host", "pack", "copy", "pinned", "device", "total"))}
            copies = []
            for _ in range(args.rounds + 1):  # the first round warms up
                acc = dict.fromkeys(stages, 0.0)
                P.COUNTERS.reset()
                with open(path, "rb") as f:
                    for i in range(0, nrg, group):
                        if group == 1:
                            t0 = time.perf_counter()
                            works, nrows = P._host_phase(pf, f, i, schema)
                            t1 = time.perf_counter()
                            P._device_phase(pf, i, schema, works, nrows, dev)
                            torch.cuda.synchronize()
                            acc["host"] += t1 - t0
                            acc["device"] += time.perf_counter() - t1
                            continue
                        t0 = time.perf_counter()
                        chunks, total = P._read_chunks(
                            pf, f, range(i, min(i + group, nrg)), schema)
                        t1 = time.perf_counter()
                        groups_sig, caps, packed = P._group_signatures(
                            chunks, names)
                        t2 = time.perf_counter()
                        on_dev = torch.from_numpy(packed).to(dev)
                        P.COUNTERS.add(h2d_copies=1)
                        torch.cuda.synchronize()
                        t3 = time.perf_counter()
                        if pinned is None or pinned.numel() < packed.size:
                            pinned = torch.empty(packed.size,
                                                 dtype=torch.uint8,
                                                 pin_memory=True)
                        staged = pinned[:packed.size]
                        staged.numpy()[:] = packed
                        staged.to(dev, non_blocking=True)
                        torch.cuda.synchronize()
                        t4 = time.perf_counter()
                        P._fused_multi_decode(
                            groups_sig, caps, row_bucket(total),
                            [n for _, _, n in chunks], on_dev, dev)
                        torch.cuda.synchronize()
                        t5 = time.perf_counter()
                        for k, dt in (("host", t1 - t0), ("pack", t2 - t1),
                                      ("copy", t3 - t2), ("pinned", t4 - t3),
                                      ("device", t5 - t4)):
                            acc[k] += dt
                acc["total"] = sum(v for k, v in acc.items()
                                   if k not in ("pinned", "total"))
                for k, v in acc.items():
                    stages[k].append(v)
                copies.append(P.COUNTERS.h2d_copies)
            result[f"row_groups_per_dispatch_{group}"] = dict(
                {k: statistics.median(v[1:]) for k, v in stages.items()},
                h2d_copies=copies[-1])
        file_bytes = Path(path).stat().st_size
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "rows": args.rows,
                      "compression": args.compression,
                      "file_bytes": file_bytes, "row_groups": nrg,
                      "rounds": args.rounds, "stage_s": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
