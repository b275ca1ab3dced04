// Deterministic float64 segmented sum over at most 4096 segments.
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/pallas_segsum.py
// `_make_kernel` (reached through segment_sum_f64). The TPU has no fast
// f64, so that kernel splits values into hi/lo f32 halves, reduces them
// with one-hot MXU matmuls and scatters a residual for values beyond f32
// range. Hopper has native f64, so none of that carries over: values are
// added in f64 as they are, which also keeps 1e300 exact and confines a NaN
// to its own segment.
//
// Bound: device memory (12 B read per row: an f64 value and an int32 id;
// one add per row). The contract also asks that two runs on one input give
// identical bits, so no add may happen in an order that varies, which
// rules out floating-point atomics. The design:
//   pass 1: block b reduces a fixed contiguous row range. Each warp of the
//     block owns a private histogram of per-segment partials in shared
//     memory and walks its own contiguous share of the range, 32 rows a
//     step (one coalesced load per lane). Within a step every lane sums, in
//     lane order, the step's values whose id equals its own (32 shuffles);
//     the lowest lane of each id then adds that sum to the warp's
//     histogram. Distinct ids mean distinct addresses, so no atomics.
//     At the end the block adds its warps' histograms in warp order.
//   pass 2: one thread per segment sums the block partials in block order.
// Ids are range-checked in their own width before any narrowing, so an
// int64 id >= 2^31 is dropped instead of wrapping onto a valid segment.
//
// Interface: plain C launchers for ctypes. They launch on the caller's
// stream, allocate nothing (the caller passes the partials scratch and
// picks the warps per block so the histograms fit), and return
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename Id>
__global__ void segsum_partials(const double* __restrict__ vals,
                                const Id* __restrict__ ids, int64_t n,
                                int num_segments, int64_t rows_per_block,
                                double* __restrict__ parts) {
  extern __shared__ double hist[];  // [warps][num_segments]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < warps * num_segments; i += blockDim.x)
    hist[i] = 0.0;
  __syncthreads();
  double* mine = hist + static_cast<int64_t>(warp) * num_segments;

  const int64_t blo = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t bhi = blo + rows_per_block < n ? blo + rows_per_block : n;
  // each warp: a contiguous, 32-aligned share of the block's rows
  const int64_t per_warp = ((rows_per_block / warps) + 31) & ~int64_t(31);
  const int64_t lo = blo + warp * per_warp;
  const int64_t hi = lo + per_warp < bhi ? lo + per_warp : bhi;
  for (int64_t base = lo; base < hi; base += 32) {
    const int64_t r = base + lane;
    int g = -1;
    double v = 0.0;
    if (r < hi) {
      const Id id = ids[r];
      if (id >= 0 && id < static_cast<Id>(num_segments)) {
        g = static_cast<int>(id);
        v = vals[r];
      }
    }
    double acc = 0.0;
    int first = -1;
#pragma unroll 8
    for (int src = 0; src < 32; ++src) {
      const int gs = __shfl_sync(kFull, g, src);
      const double x = __shfl_sync(kFull, v, src);
      if (gs == g) {
        acc += x;
        if (first < 0) first = src;
      }
    }
    if (g >= 0 && first == lane) mine[g] += acc;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) {
    double sum = 0.0;
    for (int w = 0; w < warps; ++w)
      sum += hist[static_cast<int64_t>(w) * num_segments + s];
    parts[static_cast<int64_t>(blockIdx.x) * num_segments + s] = sum;
  }
}

__global__ void segsum_combine(const double* __restrict__ parts, int nblocks,
                               int num_segments, double* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= num_segments) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b)
    s += parts[static_cast<int64_t>(b) * num_segments + g];
  out[g] = s;
}

template <typename Id>
cudaError_t launch_partials(const void* vals, const void* ids, long long n,
                            int num_segments, int nblocks, int warps,
                            long long rows_per_block, void* parts,
                            cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(warps) * num_segments * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      segsum_partials<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  segsum_partials<Id><<<nblocks, warps * 32, smem, s>>>(
      static_cast<const double*>(vals), static_cast<const Id*>(ids), n,
      num_segments, rows_per_block, static_cast<double*>(parts));
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_f64_launch(const void* vals, const void* ids,
                                      int id_bytes, long long n,
                                      int num_segments, int nblocks,
                                      int warps, long long rows_per_block,
                                      void* parts, void* out, void* stream) {
  if (num_segments <= 0 || nblocks <= 0 || warps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (id_bytes == 4) {
    err = launch_partials<int32_t>(vals, ids, n, num_segments, nblocks, warps,
                                   rows_per_block, parts, s);
  } else if (id_bytes == 8) {
    err = launch_partials<int64_t>(vals, ids, n, num_segments, nblocks, warps,
                                   rows_per_block, parts, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  segsum_combine<<<(num_segments + 255) / 256, 256, 0, s>>>(
      static_cast<const double*>(parts), nblocks, num_segments,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
