// Exact, wrapping int64 segmented sum over any number of segments.
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/pallas_groupby.py
// `_make_kernel` (reached through segment_sum_i64 / fused_segment_sum), the
// group-by accumulate of the fused partial aggregate. The TPU's matrix unit
// has no int64, so that kernel splits each value into four 16-bit limbs,
// sums them in f32 one-hot matmuls that stay exact below 2^24, and
// recombines the limbs in uint64; its [256, G] one-hot tile in VMEM caps G
// at 4096. Hopper adds int64 natively, and 64-bit integer atomics wrap
// modulo 2^64 exactly like int64 addition, so none of that carries over and
// G has no cap here. Integer addition does not depend on order, so the
// result is bit-identical from run to run and equal to any other exact sum.
//
// Bound: device memory. Each row reads an int64 value and an int32/int64
// id, and the output [G] int64 is written once (the wrapper zeroes it).
// The path's ids are sorted group ids with long runs of one id, and its
// padding rows all carry id G-1 with value 0, so one atomic per row would
// pile onto a few addresses. The design:
//   - one thread per row, warps walking the rows 32 at a time (grid-stride);
//   - ids are range-checked in their own width before any narrowing, so an
//     int64 id >= 2^31 is dropped instead of wrapping onto a valid segment;
//   - within each 32-row step the warp takes a segmented inclusive scan
//     over runs of equal ids (5 shuffle rounds); the last lane of each run
//     adds the run's sum with one atomicAdd on unsigned long long, and only
//     when that sum is not 0 (adding 0 changes nothing, and the padding
//     rows add nothing at all). Unsorted ids still come out right: each
//     run of equal neighbouring ids adds its own sum.
//
// Interface: a plain C launcher for ctypes. It launches on the caller's
// stream, allocates nothing (the caller passes the zeroed output), and
// returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

template <typename Id>
__global__ void segsum_i64(const long long* __restrict__ vals,
                           const Id* __restrict__ ids, long long n,
                           long long num_segments,
                           unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  // the loop bound is uniform across the warp, so every shuffle below runs
  // with all 32 lanes
  for (long long base = warp * 32; base < n; base += warps * 32) {
    const long long r = base + lane;
    long long g = -1;  // -1: dropped row (outside the range or past n)
    unsigned long long v = 0;
    if (r < n) {
      const long long id = static_cast<long long>(ids[r]);
      if (id >= 0 && id < num_segments) {
        g = id;
        v = static_cast<unsigned long long>(vals[r]);
      }
    }
    // first lane of this lane's run of equal ids: a running max of run heads
    const long long prev = __shfl_up_sync(kFull, g, 1);
    int start = (lane == 0 || prev != g) ? lane : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int s = __shfl_up_sync(kFull, start, d);
      if (lane >= d && s > start) start = s;
    }
    // segmented inclusive scan: sum of the run's lanes up to this one
    unsigned long long sum = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long o = __shfl_up_sync(kFull, sum, d);
      if (lane - d >= start) sum += o;
    }
    const long long next = __shfl_down_sync(kFull, g, 1);
    const bool last = lane == 31 || next != g;
    if (last && g >= 0 && sum != 0) atomicAdd(out + g, sum);
  }
}

template <typename Id>
cudaError_t launch(const void* vals, const void* ids, long long n,
                   long long num_segments, void* out, cudaStream_t s) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  segsum_i64<Id><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      static_cast<const long long*>(vals), static_cast<const Id*>(ids), n,
      num_segments, static_cast<unsigned long long*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_i64_launch(const void* vals, const void* ids,
                                      int id_bytes, long long n,
                                      long long num_segments, void* out,
                                      void* stream) {
  if (n <= 0 || num_segments <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (id_bytes == 4) {
    err = launch<int32_t>(vals, ids, n, num_segments, out, s);
  } else if (id_bytes == 8) {
    err = launch<int64_t>(vals, ids, n, num_segments, out, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
