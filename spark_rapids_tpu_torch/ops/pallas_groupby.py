"""Exact int64 segmented sum on a hand-written CUDA kernel
(`spark_rapids_tpu/ops/pallas_groupby.py`).

The fused stage's terminal partial aggregate spends its group-by in
segmented int64 sums (Sum's sum and its non-null count, Count's count).
While that member runs with the kernels engaged, `ops.rowops` routes those
sums through `fused_segment_sum`, which calls `segment_sum_i64` for a 1-D
int64 contribution and the plain path for any other.

`segment_sum_i64` launches `csrc/segment_sum_i64.cu` for CUDA tensors and
takes its plain twin `segment_sum_i64_plain` for CPU tensors. Both have the
JAX function's semantics: sums wrap like int64, rows whose id lies outside
[0, num_segments) contribute nothing, and an int64 id of 2^31 or more drops
instead of wrapping into range.

One difference from the JAX package, in which code computes the sum and
never in the sum: JAX uses its kernel only while the segment count is at
most MAX_SEGMENTS = 4096, because the TPU keeps a [256, G] one-hot tile in
VMEM, and the segment count is the batch capacity (1,048,576 at the
default batch size), so at full size JAX takes `jax.ops.segment_sum`.
Hopper has no such limit and integer sums are exact in any order, so here
the kernel serves every segment count.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import KernelLaunchError
from . import cuda_build
from .rowops import segment_sum

__all__ = ["segment_sum_i64", "segment_sum_i64_plain", "fused_segment_sum"]

_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        fn = cuda_build.load("segment_sum_i64").segment_sum_i64_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(values: torch.Tensor, segment_ids: torch.Tensor,
           num_segments: int) -> None:
    if num_segments < 1:
        raise ValueError(f"num_segments must be positive, got {num_segments}")
    if values.dtype != torch.int64:
        raise TypeError(f"values must be int64, got {values.dtype}")
    if values.dim() != 1 or values.shape != segment_ids.shape:
        raise ValueError("values and segment_ids must be 1-D of one length")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32/int64, got "
                        f"{segment_ids.dtype}")


def segment_sum_i64_plain(values: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain torch twin: `index_add_` with out-of-range ids sent to a spare
    slot that is cut off (index_add_ raises on them where JAX drops them)."""
    _check(values, segment_ids, num_segments)
    return segment_sum(values, segment_ids, num_segments)


def segment_sum_i64(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Wrapping int64 sum of `values` by `segment_ids` (sorted or not)."""
    _check(values, segment_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_i64_plain(values, segment_ids, num_segments)
    if values.device.type != "cuda" or segment_ids.device != values.device:
        raise ValueError(f"segment_sum_i64 runs on CUDA tensors (or on the "
                         f"CPU through its plain twin), got {values.device}")
    out = torch.zeros(num_segments, dtype=torch.int64, device=values.device)
    n = values.shape[0]
    if n == 0:
        return out
    vals, ids = values.contiguous(), segment_ids.contiguous()
    fn = _launch_fn()
    with torch.cuda.device(values.device):
        err = fn(vals.data_ptr(), ids.data_ptr(), ids.element_size(), n,
                 num_segments, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"segment_sum_i64 launch failed: CUDA error {err}")
    segment_sum_i64.launches += 1
    return out


segment_sum_i64.launches = 0


def fused_segment_sum(contrib: torch.Tensor, gid: torch.Tensor,
                      cap: int) -> torch.Tensor:
    """`ops.rowops._FUSED_SEGMENT_SUM` target: the kernel for a 1-D int64
    contribution, the plain path for any other."""
    if contrib.dim() != 1 or contrib.dtype != torch.int64:
        return segment_sum(contrib, gid, cap)
    return segment_sum_i64(contrib, gid, cap)
