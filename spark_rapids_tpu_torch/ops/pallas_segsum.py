"""float64 segmented sum on a hand-written CUDA kernel
(`spark_rapids_tpu/ops/pallas_segsum.py`).

`segment_sum_f64` launches `csrc/segment_sum_f64.cu` for CUDA tensors and
takes its plain twin for CPU tensors. The kernel is deterministic: per-warp
partials in shared memory added in row order, then combined in warp order
and in block order, with no floating-point atomics, so two runs on one
input give identical bits (torch's `index_add_` on CUDA does not). Rows with ids outside
[0, num_segments) contribute nothing, int64 ids included; num_segments above
MAX_SEGMENTS raises ValueError, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import KernelLaunchError
from . import cuda_build

__all__ = ["segment_sum_f64", "segment_sum_f64_plain", "MAX_SEGMENTS"]

MAX_SEGMENTS = 4096   # a warp's partials [G] f64 must fit shared memory
_HIST_BYTES = 96 * 1024  # shared memory for the per-warp histograms of a block
_MAX_WARPS = 8
_MAX_BLOCKS = 528     # 4 per SM on an H100; fixed so results never depend on the card

_launcher = None


def _launch_fn():
    global _launcher
    if _launcher is None:
        fn = cuda_build.load("segment_sum_f64").segment_sum_f64_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(values: torch.Tensor, segment_ids: torch.Tensor,
           num_segments: int) -> None:
    if num_segments > MAX_SEGMENTS:
        raise ValueError(f"num_segments {num_segments} > {MAX_SEGMENTS}")
    if num_segments < 1:
        raise ValueError(f"num_segments must be positive, got {num_segments}")
    if values.dim() != 1 or values.shape != segment_ids.shape:
        raise ValueError("values and segment_ids must be 1-D of one length")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32/int64, got "
                        f"{segment_ids.dtype}")


def segment_sum_f64_plain(values: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain torch twin: out-of-range ids go to a spare slot that is cut
    off (index_add_ raises on them where JAX drops them)."""
    _check(values, segment_ids, num_segments)
    in_range = (segment_ids >= 0) & (segment_ids < num_segments)
    idx = torch.where(in_range, segment_ids, num_segments).to(torch.int64)
    out = torch.zeros(num_segments + 1, dtype=torch.float64,
                      device=values.device)
    return out.index_add_(0, idx, values.to(torch.float64))[:num_segments]


def segment_sum_f64(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """f64 segmented sum of `values` by `segment_ids` (unsorted)."""
    _check(values, segment_ids, num_segments)
    if values.device.type == "cpu":
        return segment_sum_f64_plain(values, segment_ids, num_segments)
    if values.device.type != "cuda" or segment_ids.device != values.device:
        raise ValueError(f"segment_sum_f64 runs on CUDA tensors (or on the "
                         f"CPU through its plain twin), got {values.device}")
    n = values.shape[0]
    out = torch.zeros(num_segments, dtype=torch.float64, device=values.device)
    if n == 0:
        return out
    vals = values.to(torch.float64).contiguous()
    ids = segment_ids.contiguous()
    # a fixed row split for a given (n, num_segments): the order of every
    # add, hence every bit of the result, depends on nothing else
    warps = max(1, min(_MAX_WARPS, _HIST_BYTES // (num_segments * 8)))
    steps = -(-n // 32)
    rows_per_block = -(-steps // min(steps, _MAX_BLOCKS)) * 32
    nblocks = -(-n // rows_per_block)
    parts = torch.empty(nblocks * num_segments, dtype=torch.float64,
                        device=values.device)
    fn = _launch_fn()
    with torch.cuda.device(values.device):
        err = fn(vals.data_ptr(), ids.data_ptr(), ids.element_size(), n,
                 num_segments, nblocks, warps, rows_per_block,
                 parts.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"segment_sum_f64 launch failed: CUDA error {err}")
    # one count per call; the call runs two kernels (segsum_partials, then
    # segsum_combine)
    segment_sum_f64.launches += 1
    return out


segment_sum_f64.launches = 0
