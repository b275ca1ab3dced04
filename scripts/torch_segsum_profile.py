#!/usr/bin/env python3
"""Kernel B (the deterministic f64 segmented sum) alone on one NVIDIA GPU.

    python3 scripts/torch_segsum_profile.py [--rows N] [--groups G]
                                            [--copies K] [--bench-step]
                                            [--package-root DIR]

Defaults: the bench step's shape, 4,194,304 rows and 1,024 groups, int32
ids. Builds `csrc/segment_sum_f64.cu`, prints its `-Xptxas -v` lines, checks
the result (bit-identical on repeat, within 1e-9 x each group's L1 mass of
numpy and of the plain twin), then prints one JSON line of device times:

- warm_ms: back-to-back calls on one input (part of it may stay in L2);
- cold_ms: calls over K copies of the input in turn (K x 50 MB at the
  default shape, so each call reads device memory);
- cuda_kernels_cold_ms / _warm_ms: each CUDA kernel of one call, from
  torch.profiler;
- the plain twin's and `index_add_`'s warm times, the byte bound and the
  cold time's share of it.

--bench-step also times chip_smoke.py's bench step (benchstep.many_steps
at bench.py's shapes, 8 steps a call): the median, min and max per step
over 11 calls, checked against numpy (rtol 1e-9) and bit for bit between
calls. --package-root DIR takes spark_rapids_tpu_torch from DIR instead of
this checkout (to time another commit's kernel in the same call). Needs
CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=cs.N_FACT)
    ap.add_argument("--groups", type=int, default=cs.N_GROUPS)
    ap.add_argument("--copies", type=int, default=4)
    ap.add_argument("--bench-step", action="store_true")
    ap.add_argument("--package-root", default=None)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_segsum_profile: no CUDA device", file=sys.stderr)
        return 2
    if args.package_root:
        sys.path.insert(0, str(Path(args.package_root).resolve()))
    from spark_rapids_tpu_torch.ops import cuda_build
    from spark_rapids_tpu_torch.ops.pallas_segsum import (
        segment_sum_f64, segment_sum_f64_plain)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    rate = cs.hbm_rate(kind)
    # the compiler's output: from this build, else from the log kept beside
    # the library (a package without that log gives none)
    log = cuda_build.build(("segment_sum_f64",)).get("segment_sum_f64")
    kept = cuda_build.library_path("segment_sum_f64").with_suffix(".log")
    if log is None and kept.exists():
        log = kept.read_text()
    ptxas = [ln.strip() for ln in (log or "").splitlines()
             if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln
                                        or "bytes stack" in ln)]

    n, g = args.rows, args.groups
    gen = np.random.default_rng(7)
    copies = []
    for _ in range(args.copies):
        vals_np, ids_np = cs.segsum_inputs(gen, n, g)
        copies.append((torch.from_numpy(vals_np).to(dev),
                       torch.from_numpy(ids_np).to(dev), g))
    vals, ids, _ = copies[-1]
    out1 = segment_sum_f64(vals, ids, g)
    out2 = segment_sum_f64(vals, ids, g)
    plain = segment_sum_f64_plain(vals, ids, g)
    torch.cuda.synchronize()
    exact = np.bincount(ids_np, weights=vals_np, minlength=g)
    mass = np.bincount(ids_np, weights=np.abs(vals_np), minlength=g)
    err = np.abs(out1.cpu().numpy() - exact)
    twin = (out1 - plain).abs().cpu().numpy()
    checks = {"repeat_bit_identical": bool(torch.equal(out1, out2)),
              "within_1e-9_mass_of_numpy": bool(np.all(err <= 1e-9 * mass)),
              "within_1e-9_mass_of_twin": bool(np.all(twin <= 1e-9 * mass))}

    cold = cs.rotating(segment_sum_f64, copies)
    warm_ms = cs.time_ms(torch, lambda: segment_sum_f64(vals, ids, g))
    cold_ms = cs.time_ms(torch, cold)
    split = cs.cuda_kernel_ms(torch, cold)
    split_warm = cs.cuda_kernel_ms(
        torch, lambda: segment_sum_f64(vals, ids, g))
    plain_ms = cs.time_ms(torch, lambda: segment_sum_f64_plain(vals, ids, g))
    ids64 = ids.to(torch.int64)
    lib_ms = cs.time_ms(torch, lambda: torch.zeros(
        g, dtype=torch.float64, device=dev).index_add_(0, ids64, vals))
    bound = (n * (vals.element_size() + ids.element_size()) + g * 8) \
        / rate * 1e3
    step = None
    if args.bench_step:
        step_ms, counts, _ = cs.bench_step_runs(torch, dev, (segment_sum_f64,))
        step = dict(cs.spread(step_ms),
                    launches_per_call=sorted(c for c, in counts))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for ln in ptxas:
        print(ln)
    print(json.dumps({
        "card": smi, "package": str(Path(cuda_build.__file__).parents[2]),
        "rows": n, "groups": g, "copies": args.copies,
        "input_mb_per_copy": n * 12 / 1e6, "checks": checks,
        "max_err_vs_numpy": float(err.max()),
        "max_abs_err_vs_plain": float(twin.max()),
        "warm_ms": warm_ms, "cold_ms": cold_ms,
        "cuda_kernels_cold_ms": split, "cuda_kernels_warm_ms": split_warm,
        "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": bound,
        "bound_share_cold": bound / cold_ms, "bench_step_ms": step}),
        flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
