#!/usr/bin/env python3
"""Kernel B's design choices taken out one at a time, on one NVIDIA GPU.

    python3 scripts/torch_segsum_ablations.py [--groups G[,G...]]

Each ablation is `csrc/segment_sum_f64.cu` with one edit, built with the
package's nvcc flags into `spark_rapids_tpu_torch/_build/ablations/` and
run through the package's wrapper (same geometry, same inputs):

- as_built: the source as it is;
- loads_only: the rows are loaded as the kernel loads them but only summed
  per lane, not added by segment (a floor for this way of reading; its
  result is not a segmented sum);
- no_pdl: both kernels launched the ordinary way, without programmatic
  dependent launch;
- match_any: lanes of one segment found with `__match_any_sync` and summed
  by the rank tree, in place of the tag bytes and the pair path.

An edit that no longer applies to the source fails the script. Prints one
JSON line per ablation and segment count: cold and warm device times (as
scripts/torch_segsum_profile.py takes them) and whether the result is
bit-identical on repeat and within 1e-9 x each segment's L1 mass of numpy
(also on sorted ids). Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

ADD_ROWS = """    add_rows(mine, tag, g[0], v[0], lane);
    add_rows(mine, tag, g[1], v[1], lane);
"""
MATCH_ADD_ROWS = """__device__ __forceinline__ void add_rows(
    double* hist, unsigned char*, int g, double v, int lane) {
  const unsigned peers = __match_any_sync(kFull, g);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const unsigned above = peers & ~((2u << lane) - 1u);
  int next = g >= 0 && above ? __ffs(above) - 1 : 32;
  for (int step = 1; __any_sync(kFull, next < 32); step <<= 1) {
    const int src = next < 32 ? next : lane;
    const double x = __shfl_sync(kFull, v, src);
    if (next < 32 && (rank & (2 * step - 1)) == 0) v += x;
    const int next2 = __shfl_sync(kFull, next, src);
    next = next < 32 ? next2 : 32;
  }
  if (g >= 0 && rank == 0) hist[g] += v;
  __syncwarp();
}

template <typename Id>
__global__"""


def _edit(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"ablation edit no longer applies: {old[:60]!r}")
    return src.replace(old, new, 1)


def ablations(src: str) -> dict:
    loads = _edit(src, ADD_ROWS, "    acc += (g[0] >= 0 ? v[0] : 0.0) + "
                  "(g[1] >= 0 ? v[1] : 0.0);\n")
    loads = _edit(loads, "  for (int64_t u = lo; u < hi; ++u) {",
                  "  double acc = 0.0;\n"
                  "  for (int64_t u = lo; u < hi; ++u) {")
    loads = _edit(loads, "  __syncthreads();\n  for (int s = threadIdx.x;",
                  "  if (acc == -1.0) mine[0] = acc;\n"
                  "  __syncthreads();\n  for (int s = threadIdx.x;")
    start = src.index("__device__ __forceinline__ void add_rows(")
    end = src.index("template <typename Id>\n__global__", start)
    match = src[:start] + MATCH_ADD_ROWS + src[end + len(
        "template <typename Id>\n__global__"):]
    return {
        "as_built": src,
        "loads_only": loads,
        "no_pdl": _edit(src, "programmaticStreamSerializationAllowed = 1",
                        "programmaticStreamSerializationAllowed = 0"),
        "match_any": match,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default=str(cs.N_GROUPS))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_segsum_ablations: no CUDA device", file=sys.stderr)
        return 2
    from spark_rapids_tpu_torch.ops import cuda_build, pallas_segsum as ps

    out_dir = cuda_build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = ablations((cuda_build.CSRC / "segment_sum_f64.cu").read_text())
    procs = {}
    for name, text in srcs.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build._FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")

    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(7)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for g in (int(x) for x in args.groups.split(",")):
        copies = []
        for _ in range(4):
            v_np, i_np = cs.segsum_inputs(gen, cs.N_FACT, g)
            copies.append((torch.from_numpy(v_np).to(dev),
                           torch.from_numpy(i_np).to(dev), g))
        vals, ids, _ = copies[0]
        sorted_ids = torch.sort(ids).values

        def right(i):
            v_np, i_np = vals.cpu().numpy(), i.cpu().numpy()
            want = np.bincount(i_np, weights=v_np, minlength=g)
            mass = np.bincount(i_np, weights=np.abs(v_np), minlength=g)
            a = ps.segment_sum_f64(vals, i, g)
            b = ps.segment_sum_f64(vals, i, g)
            return bool(torch.equal(a, b)) and bool(
                np.all(np.abs(a.cpu().numpy() - want) <= 1e-9 * mass))

        for name in srcs:
            fn = ctypes.CDLL(str(out_dir / f"lib{name}.so")
                             ).segment_sum_f64_launch
            fn.argtypes = ps._launch_fn().argtypes
            fn.restype = ctypes.c_int
            ps._launcher = fn
            print(json.dumps({
                "card": smi, "ablation": name, "rows": cs.N_FACT,
                "groups": g, "right": right(ids),
                "right_sorted_ids": right(sorted_ids),
                "cold_ms": cs.time_ms(torch, cs.rotating(
                    ps.segment_sum_f64, copies)),
                "warm_ms": cs.time_ms(
                    torch, lambda: ps.segment_sum_f64(vals, ids, g))}),
                flush=True)
        ps._launcher = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
