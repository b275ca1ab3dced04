"""The benchmark's query step (`bench.py` `make_data`, `tpu_many_steps`):
scan -> filter -> join -> grouped f64 aggregate, written as one function
over tensors, with every size an argument.

The join is a dense-table gather (build the dim table by scatter, probe by
gather) and the grouped sum runs through the deterministic segmented-sum
kernel (ops/pallas_segsum.py). The step repeats `k_steps` times, as the
JAX benchmark does inside one program, and returns the per-step mean.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .ops.pallas_segsum import segment_sum_f64

__all__ = ["make_data", "many_steps"]


def make_data(n_fact: int, n_dim: int, n_groups: int, key_space: int,
              seed: int = 0):
    """(fact_key i64, fact_grp i32, fact_val f64, dim_key i64 sorted
    unique, dim_w f64) as numpy arrays; the same draws as bench.make_data
    for the same sizes and seed."""
    rng = np.random.default_rng(seed)
    fact_key = rng.integers(0, key_space, size=n_fact).astype(np.int64)
    fact_grp = rng.integers(0, n_groups, size=n_fact).astype(np.int32)
    fact_val = rng.uniform(0.5, 1.5, size=n_fact).astype(np.float64)
    dim_key = np.sort(rng.permutation(key_space)[:n_dim]).astype(np.int64)
    dim_w = rng.uniform(0.5, 1.5, size=n_dim).astype(np.float64)
    return fact_key, fact_grp, fact_val, dim_key, dim_w


def many_steps(fact_key: torch.Tensor, fact_grp: torch.Tensor,
               fact_val: torch.Tensor, dim_key: torch.Tensor,
               dim_w: torch.Tensor, *, n_groups: int, key_space: int,
               k_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the step k_steps times on the tensors' device; returns (per-group
    f64 sums, matched row count), both averaged over the steps like the
    JAX benchmark."""
    device = fact_key.device
    tw = torch.zeros(key_space, dtype=torch.float64, device=device)
    tw[dim_key] = dim_w
    tm = torch.zeros(key_space, dtype=torch.bool, device=device)
    tm[dim_key] = True
    sums = torch.zeros(n_groups, dtype=torch.float64, device=device)
    rows = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(k_steps):
        keep = fact_val > 0.6
        matched = tm[fact_key] & keep
        contrib = torch.where(matched, fact_val * tw[fact_key], 0.0)
        sums = sums + segment_sum_f64(contrib, fact_grp, n_groups)
        rows = rows + matched.sum()
    return sums / k_steps, rows // k_steps
