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
// Bound on an H100: device memory. Each row reads an f64 value and an id
// (12 B with int32 ids; 50.3 MB at 4,194,304 rows, 0.0150 ms at 3.35 TB/s)
// for one add. Two runs on one input must give identical bits, so no add
// may happen in an order that varies: no floating-point atomics. The
// design, against the four limits of a first version (dependent loads, a
// 32-round shuffle loop per 32 rows, a tail wave, a serial combine):
//
// - Bytes in flight. A warp walks units of 64 rows; in a unit each lane
//   owns two adjacent rows, read as one 16-byte f64 pair and one id pair
//   whatever the ids hold, and the next unit's loads are issued before the
//   current unit is added. Rows past the end are masked. The partials
//   kernel is launched as a programmatic dependent (PDL): it clears its
//   histograms while the kernel before it finishes.
// - Few instructions per 32 rows. Lanes find a clash (two lanes on one
//   segment) by writing their lane number into a per-warp tag byte of the
//   segment and reading it back, then one vote. Without a clash (the usual
//   case at 1,024 uniform segments) every lane adds its row to the warp's
//   histogram; a clash of two lanes costs one more tag round and one
//   shuffle; only three lanes or more on one segment take a binary tree
//   over their ranks (5 ballots, at most 5 rounds of shuffles). The order
//   of every add depends on lane positions only (add_rows).
//   `__match_any_sync` was tried first and cost more issue time than this.
// - One wave. A block holds one f64 histogram [G] and one tag array [G] per
//   warp in shared memory, at most 216 KB: 24 warps at G <= 1,024, 6 at
//   G = 4,096. At most 132 blocks, so on an H100 (132 SMs, one such block
//   each) every block is resident at once. The row split is a function of
//   (n, G) only, computed by the wrapper (ops/pallas_segsum.py
//   launch_geometry): warp w of block b owns units
//   [(b * warps + w) * units_per_warp, + units_per_warp).
// - A parallel combine in fixed order. Each block adds its warps'
//   histograms in warp order and writes one partial row [G] (1.07 MB at
//   131 blocks x 1,024 segments). Then one block per 32 segments: warp k
//   sums partial rows k, k + 32, ... in order, and warp 0 adds the 32 warp
//   sums in warp order. It is launched as a programmatic dependent too, so
//   its blocks are waiting when the partials end.
//
// Ids are range-checked in their own width before any narrowing, so an
// int64 id >= 2^31 is dropped instead of wrapping onto a valid segment.
//
// Interface: a plain C launcher for ctypes. It launches on the caller's
// stream, allocates nothing (the caller passes the partials scratch and the
// geometry), and returns the first CUDA error. The values must be 16-byte
// aligned and the ids aligned to two ids.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnitRows = 64;  // one unit: 32 lanes x 2 adjacent rows
constexpr int kMaxWarps = 24;
constexpr int kSmemBytes = 216 * 1024;  // histograms and tags of a block
constexpr int kCombineWarps = 32;

template <typename Id>
struct IdPair;
template <>
struct IdPair<int32_t> {
  using T = int2;
};
template <>
struct IdPair<int64_t> {
  using T = longlong2;
};

template <typename Id>
__device__ __forceinline__ int segment_of(Id id, int num_segments) {
  return id >= 0 && id < static_cast<Id>(num_segments) ? static_cast<int>(id)
                                                       : -1;
}

// Programmatic dependent launch (sm_90): griddep_wait blocks until the
// kernel before this one in the stream has completed and its writes are
// visible (at once when this kernel was launched the ordinary way);
// griddep_launch_dependents lets the next kernel start its blocks early.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// A lane's two rows of unit u: rows u * 64 + 2 * lane + e, e < 2. A row
// past the warp's units or past n gets segment -1.
template <typename Id>
__device__ __forceinline__ void load_unit(const double* __restrict__ vals,
                                          const Id* __restrict__ ids,
                                          int64_t u, int64_t unit_hi,
                                          int64_t n, int num_segments,
                                          int lane, double (&v)[2],
                                          int (&g)[2]) {
  const int64_t row = u * kUnitRows + 2 * lane;
  v[0] = v[1] = 0.0;
  g[0] = g[1] = -1;
  if (u >= unit_hi) return;
  if (row + 1 < n) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(vals + row));
    const typename IdPair<Id>::T id =
        __ldg(reinterpret_cast<const typename IdPair<Id>::T*>(ids + row));
    v[0] = x.x;
    v[1] = x.y;
    g[0] = segment_of<Id>(id.x, num_segments);
    g[1] = segment_of<Id>(id.y, num_segments);
  } else if (row < n) {
    v[0] = vals[row];
    g[0] = segment_of<Id>(ids[row], num_segments);
  }
}

// The lanes whose key w (a lane number) equals this lane's: one ballot per
// bit of w.
__device__ __forceinline__ unsigned lanes_with(int w) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const unsigned set = __ballot_sync(kFull, (w >> b) & 1);
    peers &= (w >> b) & 1 ? set : ~set;
  }
  return peers;
}

// Adds one row per lane (segment g, or -1 for none) to the warp's
// histogram, so that the order of every add depends on lane positions only.
// Each lane writes its lane number to tag[g] and reads it back: where lanes
// share a segment, one write stands and the others see a clash.
// - No clash in the warp (the usual case at 1,024 uniform segments): every
//   lane adds its row.
// - Clashes, all in pairs: the lanes that lost write again, so that each
//   lane of a pair learns the other's number. The lower lane adds
//   (its row + the other's row).
// - A segment held by three lanes or more: the lanes group by the number
//   that stood first, each group is summed by a binary tree over the lanes'
//   ranks in it, and its lowest lane adds the sum.
__device__ __forceinline__ void add_rows(double* hist, unsigned char* tag,
                                         int g, double v, int lane) {
  if (g >= 0) tag[g] = static_cast<unsigned char>(lane);
  __syncwarp();
  const int w = g >= 0 ? tag[g] : lane;  // a dropped row keys on its lane
  bool adds = g >= 0;
  if (__any_sync(kFull, w != lane)) {
    __syncwarp();
    if (w != lane) tag[g] = static_cast<unsigned char>(lane);
    __syncwarp();
    const int t = g >= 0 ? tag[g] : lane;
    if (__any_sync(kFull, w != lane && t != lane)) {
      const unsigned peers = lanes_with(w);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      // next: the lane of the peer `step` ranks above this one, or 32
      const unsigned above = peers & ~((2u << lane) - 1u);
      int next = g >= 0 && above ? __ffs(above) - 1 : 32;
      for (int step = 1; __any_sync(kFull, next < 32); step <<= 1) {
        const int src = next < 32 ? next : lane;
        const double x = __shfl_sync(kFull, v, src);
        if (next < 32 && (rank & (2 * step - 1)) == 0) v += x;
        const int next2 = __shfl_sync(kFull, next, src);
        next = next < 32 ? next2 : 32;
      }
      adds = g >= 0 && rank == 0;
    } else {
      const int other = w != lane ? w : t;  // this lane where alone
      const double x = __shfl_sync(kFull, v, other);
      if (other != lane) {
        adds = lane < other;
        v += x;
      }
    }
  }
  if (adds) hist[g] += v;
  __syncwarp();
}

template <typename Id>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    segsum_partials(const double* __restrict__ vals,
                    const Id* __restrict__ ids, int64_t n, int num_segments,
                    int64_t units_per_warp, double* __restrict__ parts) {
  // [warps][num_segments] f64 histograms, then [warps][num_segments] tags
  extern __shared__ double hist[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t units = (n + kUnitRows - 1) / kUnitRows;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * warps + warp) *
                        units_per_warp;
  const int64_t lo = first < units ? first : units;
  const int64_t hi = lo + units_per_warp < units ? lo + units_per_warp : units;

  // Launched as a programmatic dependent: the histograms are cleared while
  // the kernel before it in the stream finishes; its inputs are read only
  // after that kernel has completed. The combine may launch at once.
  griddep_launch_dependents();
  for (int i = threadIdx.x; i < warps * num_segments; i += blockDim.x)
    hist[i] = 0.0;
  griddep_wait();
  double v[2];
  int g[2];
  load_unit<Id>(vals, ids, lo, hi, n, num_segments, lane, v, g);
  __syncthreads();
  double* mine = hist + warp * num_segments;
  unsigned char* tag = reinterpret_cast<unsigned char*>(
                           hist + warps * num_segments) + warp * num_segments;

  for (int64_t u = lo; u < hi; ++u) {
    double nv[2];
    int ng[2];
    load_unit<Id>(vals, ids, u + 1, hi, n, num_segments, lane, nv, ng);
    add_rows(mine, tag, g[0], v[0], lane);
    add_rows(mine, tag, g[1], v[1], lane);
    v[0] = nv[0];
    v[1] = nv[1];
    g[0] = ng[0];
    g[1] = ng[1];
  }
  __syncthreads();
  for (int s = threadIdx.x; s < num_segments; s += blockDim.x) {
    double sum = 0.0;
    for (int w = 0; w < warps; ++w)
      sum += hist[static_cast<int64_t>(w) * num_segments + s];
    parts[static_cast<int64_t>(blockIdx.x) * num_segments + s] = sum;
  }
}

// One block per 32 segments: warp k sums partial rows k, k + 32, ... in
// order; warp 0 then adds the warps' sums in warp order.
__global__ void __launch_bounds__(kCombineWarps * 32)
    segsum_combine(const double* __restrict__ parts, int nblocks,
                   int num_segments, double* __restrict__ out) {
  __shared__ double sums[kCombineWarps][32];
  griddep_wait();  // the partials are complete and visible
  griddep_launch_dependents();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (g < num_segments) {
#pragma unroll 4
    for (int b = warp; b < nblocks; b += kCombineWarps)
      s += parts[static_cast<int64_t>(b) * num_segments + g];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && g < num_segments) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < kCombineWarps; ++w) t += sums[w][lane];
    out[g] = t;
  }
}

// Launches on stream s with programmatic stream serialization, so that the
// kernel's blocks may start while the kernel before it finishes.
template <typename Kernel, typename... Args>
cudaError_t launch_dependent(Kernel kernel, int blocks, int threads,
                             size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename Id>
cudaError_t launch(const void* vals, const void* ids, int64_t n,
                   int num_segments, int nblocks, int warps,
                   int64_t units_per_warp, void* parts, void* out,
                   cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(warps) * num_segments * (sizeof(double) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      segsum_partials<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = launch_dependent(segsum_partials<Id>, nblocks, warps * 32, smem, s,
                         static_cast<const double*>(vals),
                         static_cast<const Id*>(ids), n, num_segments,
                         units_per_warp, static_cast<double*>(parts));
  if (err != cudaSuccess) return err;
  return launch_dependent(segsum_combine, (num_segments + 31) / 32,
                          kCombineWarps * 32, 0, s,
                          static_cast<const double*>(parts), nblocks,
                          num_segments, static_cast<double*>(out));
}

}  // namespace

extern "C" int segment_sum_f64_launch(const void* vals, const void* ids,
                                      int id_bytes, long long n,
                                      int num_segments, int nblocks,
                                      int warps, long long units_per_warp,
                                      void* parts, void* out, void* stream) {
  if (num_segments <= 0 || nblocks <= 0 || units_per_warp <= 0 ||
      warps <= 0 || warps > kMaxWarps ||
      static_cast<long long>(warps) * num_segments * 9 > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4)
    return static_cast<int>(launch<int32_t>(vals, ids, n, num_segments,
                                            nblocks, warps, units_per_warp,
                                            parts, out, s));
  if (id_bytes == 8)
    return static_cast<int>(launch<int64_t>(vals, ids, n, num_segments,
                                            nblocks, warps, units_per_warp,
                                            parts, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
