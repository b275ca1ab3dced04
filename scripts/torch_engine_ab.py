#!/usr/bin/env python3
"""The engine query's warm collects, one checkout against another, on one
NVIDIA GPU.

    python3 scripts/torch_engine_ab.py DIR [DIR ...] [--rounds N]

Each DIR is a checkout of the repository (for example `git archive` of a
parent commit unpacked into an ignored directory, and this checkout). For
each DIR in the order given, a process of its own imports that checkout's
`chip_smoke.py` and `spark_rapids_tpu_torch`, builds its kernels, makes
chip_smoke's engine query tables (16,777,216 fact rows, seed 1), and times
N warm collects (default 11) after a checked one, on one device and under
the distributed plan (4 mesh positions, fusion on), each checked against
the numpy oracle. Give the checkouts in turns (A B B A) to compare two
commits within one call. Prints the card's `nvidia-smi` name and power
limit, then one JSON line a checkout: the median, min and max wall of
each plan and every wall. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def measure(root: Path, rounds: int) -> dict:
    """The engine query's walls with `root`'s package (run in a process
    of its own, whose first path entry is `root`)."""
    import pyarrow as pa
    import torch

    import chip_smoke as cs
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.plugin import TpuSession
    if not Path(cs.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"chip_smoke came from {cs.__file__}")
    cuda_build.build()
    fact, dim = cs.query_tables(pa, cs.QUERY_FACT_ROWS, cs.N_DIM,
                                cs.KEY_SPACE, cs.N_GROUPS)
    want = cs.query_oracle(fact, dim)
    mesh = {"spark.rapids.shuffle.mode": "ICI",
            "spark.rapids.tpu.mesh.shape": f"shuffle={cs.MESH_POSITIONS}"}
    out = {"root": str(root)}
    for plan, extra in (("one_device", {}), ("distributed", mesh)):
        df = cs.main_query(TpuSession(dict(
            extra, **{"spark.rapids.tpu.fusion.enabled": True})), fact, dim)
        cs.check_query(df.collect(), want, plan)
        walls = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = df.collect()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            cs.check_query(got, want, plan)
        out[plan] = {"median": statistics.median(walls), "min": min(walls),
                     "max": max(walls), "walls": walls}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=11)
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root = Path(args.dirs[0]).resolve()
        sys.path.insert(0, str(root))
        print(json.dumps(measure(root, args.rounds)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_engine_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for d in args.dirs:
        root = Path(d).resolve()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--child", "--rounds", str(args.rounds), str(root)],
                       cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
