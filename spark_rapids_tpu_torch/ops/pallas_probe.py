"""Murmur3 row hashing for the fused join probe, on a hand-written CUDA
kernel (`spark_rapids_tpu/ops/pallas_probe.py`).

The fused stage sizes each join by hashing the probe and build keys every
batch. `murmur3_rows` runs one column of that chain: the CUDA kernel in
`csrc/murmur3_rows.cu` for a CUDA tensor, its plain twin
`murmur3_rows_plain` for a CPU tensor, and an error for anything else.
Both are bit-identical to `expr.hashing.hash_vec`, so the counts derived
here are exactly those `exec.joins._probe_counts` computes and fusion on
and off agree.

The sort and the searchsorted in `candidate_counts` sit outside the kernel
in the JAX package too; they stay `torch.sort` / `torch.searchsorted`.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import KernelLaunchError
from ..expr.hashing import INT_FAMILY, LONG_FAMILY, hash_int, hash_long, \
    hash_vec
from . import cuda_build

__all__ = ["murmur3_rows", "murmur3_rows_plain", "hash_vecs_pallas",
           "candidate_counts"]

_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        fn = cuda_build.load("murmur3_rows").murmur3_rows_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def murmur3_rows_plain(keys: torch.Tensor, validity: torch.Tensor,
                       seed: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel: int32 keys hash as one 4-byte block,
    int64 keys as two; null rows pass the seed through."""
    h = hash_long(keys, seed) if keys.dtype == torch.int64 else \
        hash_int(keys, seed)
    return torch.where(validity, h, seed)


def murmur3_rows(keys: torch.Tensor, validity: torch.Tensor,
                 seed: torch.Tensor) -> torch.Tensor:
    """New int32 running hash of one key column. keys: int32 or int64 [n];
    validity: bool [n]; seed: int32 [n], the running hash so far."""
    n = keys.shape[0]
    if keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1:
        raise TypeError(f"keys must be 1-D int32/int64, got {keys.dtype}")
    if validity.dtype != torch.bool or seed.dtype != torch.int32 or \
            validity.shape != (n,) or seed.shape != (n,):
        raise TypeError("validity must be bool [n] and seed int32 [n]")
    if keys.device.type == "cpu":
        return murmur3_rows_plain(keys, validity, seed)
    if keys.device.type != "cuda" or validity.device != keys.device or \
            seed.device != keys.device:
        raise ValueError(f"murmur3_rows runs on CUDA tensors (or on the CPU "
                         f"through its plain twin), got {keys.device}")
    keys, validity, seed = (t.contiguous() for t in (keys, validity, seed))
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    fn = _launch_fn()
    with torch.cuda.device(keys.device):
        err = fn(keys.data_ptr(), keys.element_size(), validity.data_ptr(),
                 seed.data_ptr(), out.data_ptr(), n,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelLaunchError(f"murmur3_rows launch failed: CUDA error {err}")
    if n:
        murmur3_rows.launches += 1
    return out


murmur3_rows.launches = 0


def _hash_one(v, seed: torch.Tensor) -> torch.Tensor:
    """One column into the running row hash: the kernel for the integral
    layouts, `expr.hashing.hash_vec` (identical bits) otherwise."""
    if isinstance(v.dtype, INT_FAMILY):
        return murmur3_rows(v.data.to(torch.int32), v.validity, seed)
    if isinstance(v.dtype, LONG_FAMILY):
        return murmur3_rows(v.data.to(torch.int64), v.validity, seed)
    return hash_vec(v, seed)


def hash_vecs_pallas(vecs, seed: int = 42) -> torch.Tensor:
    """Drop-in for expr.hashing.hash_vecs (bit-identical int32 result)."""
    n = vecs[0].validity.shape[0]
    h = torch.full((n,), seed, dtype=torch.int32,
                   device=vecs[0].validity.device)
    for v in vecs:
        h = _hash_one(v, h)
    return h


def _keys_valid(keys):
    ok = None
    for k in keys:
        ok = k.validity if ok is None else (ok & k.validity)
    return ok


def candidate_counts(pkeys, bkeys, pmask: torch.Tensor,
                     bmask: torch.Tensor) -> torch.Tensor:
    """Per-probe-row candidate counts: the `_probe_counts` sizing values with
    the row hash routed through the kernel. Feeds the fused stage's single
    expand-capacity sync."""
    pvalid = _keys_valid(pkeys) & pmask
    bvalid = _keys_valid(bkeys) & bmask
    ph = hash_vecs_pallas(pkeys).to(torch.int64)
    bh = hash_vecs_pallas(bkeys).to(torch.int64)
    # exile invalid build rows to a hash bucket no valid probe can hit
    bh = torch.where(bvalid, bh, 2 ** 62)
    bh_sorted = torch.sort(bh).values
    lo = torch.searchsorted(bh_sorted, ph, right=False)
    hi = torch.searchsorted(bh_sorted, ph, right=True)
    return torch.where(pvalid, hi - lo, 0).to(torch.int32)
