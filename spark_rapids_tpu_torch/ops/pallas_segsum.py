"""float64 segmented sum on a hand-written CUDA kernel
(`spark_rapids_tpu/ops/pallas_segsum.py`).

`segment_sum_f64` launches `csrc/segment_sum_f64.cu` for CUDA tensors and
takes its plain twin for CPU tensors. The kernel is deterministic: per-warp
partials in shared memory, peers of one segment summed in a fixed tree over
their lane ranks, then combined in warp order and in a fixed tree over the
blocks, with no floating-point atomics, so two runs on one input give
identical bits (torch's `index_add_` on CUDA does not). Rows with ids
outside [0, num_segments) contribute nothing, int64 ids included;
num_segments above MAX_SEGMENTS raises ValueError, as in the JAX package.

`launch_geometry` is the row split and the grid, a function of (rows,
segments) alone; `step_rows` spells out which rows each lane of each warp
step adds, as the kernel reads them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..errors import KernelLaunchError
from . import cuda_build

__all__ = ["segment_sum_f64", "segment_sum_f64_plain", "launch_geometry",
           "step_rows", "Geometry", "MAX_SEGMENTS"]

MAX_SEGMENTS = 4096   # a warp's partials [G] f64 must fit shared memory
UNIT_ROWS = 64        # one unit (a warp step): 32 lanes x 2 adjacent rows
MAX_WARPS = 24
SMEM_BYTES = 216 * 1024  # a block's warp histograms and tags: one block per SM
SEGMENT_BYTES = 9     # per warp and segment: an f64 partial and a 1-byte tag
MAX_BLOCKS = 132      # an H100's SMs; fixed, so no result depends on the card


class Geometry(NamedTuple):
    blocks: int          # partials blocks, each writing one row [G]
    warps: int           # warps per block, one histogram [G] each
    units_per_warp: int  # contiguous units of UNIT_ROWS rows per warp
    smem_bytes: int      # dynamic shared memory of a partials block


def launch_geometry(n: int, num_segments: int) -> Geometry:
    """The kernel's row split and grid for n rows and num_segments groups.
    Warp w of block b owns the units_per_warp units from unit
    (b * warps + w) * units_per_warp on. Blocks stay at most MAX_BLOCKS, so
    on an H100 all are resident at once."""
    warps = max(1, min(MAX_WARPS,
                       SMEM_BYTES // (num_segments * SEGMENT_BYTES)))
    units = -(-n // UNIT_ROWS)
    per_warp = max(1, -(-units // (MAX_BLOCKS * warps)))
    blocks = -(-units // (per_warp * warps))
    return Geometry(blocks, warps, per_warp,
                    warps * num_segments * SEGMENT_BYTES)


def step_rows(geom: Geometry, n: int) -> np.ndarray:
    """The rows each lane adds in each warp step, as the kernel reads them:
    int64 [blocks, warps, steps (units_per_warp), 32 lanes, 2], -1 where a
    lane adds nothing. Step t of warp w of block b is unit
    u = (b * warps + w) * units_per_warp + t, where lane l adds rows
    u * 64 + 2l and u * 64 + 2l + 1."""
    b, w, t, lane, e = np.ix_(
        np.arange(geom.blocks), np.arange(geom.warps),
        np.arange(geom.units_per_warp), np.arange(32), np.arange(2))
    units = -(-n // UNIT_ROWS)
    lo = np.minimum((b * geom.warps + w) * geom.units_per_warp, units)
    hi = np.minimum(lo + geom.units_per_warp, units)
    unit = lo + t
    row = unit * UNIT_ROWS + 2 * lane + e
    return np.where((unit < hi) & (row < n), row, -1)


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


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """t, or a fresh copy where its data is not nbytes-aligned (the kernel
    reads rows in pairs)."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


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
    if n == 0:
        return torch.zeros(num_segments, dtype=torch.float64,
                           device=values.device)
    vals = _aligned(values.to(torch.float64).contiguous(), 16)
    ids = segment_ids.contiguous()
    ids = _aligned(ids, 2 * ids.element_size())
    geom = launch_geometry(n, num_segments)
    parts = torch.empty(geom.blocks * num_segments, dtype=torch.float64,
                        device=values.device)
    out = torch.empty(num_segments, dtype=torch.float64, device=values.device)
    fn = _launch_fn()
    with torch.cuda.device(values.device):
        err = fn(vals.data_ptr(), ids.data_ptr(), ids.element_size(), n,
                 num_segments, geom.blocks, geom.warps, geom.units_per_warp,
                 parts.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"segment_sum_f64 launch failed: CUDA error {err}")
    # one count per call; the call runs two kernels (segsum_partials, then
    # segsum_combine)
    segment_sum_f64.launches += 1
    return out


segment_sum_f64.launches = 0
