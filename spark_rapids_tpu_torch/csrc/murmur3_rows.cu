// Spark murmur3_x86_32 of one key per row, chained on a per-row running seed.
//
// Replaces the Pallas kernel spark_rapids_tpu/ops/pallas_probe.py
// `_make_kernel` (reached through hash_int_rows / hash_long_rows). The TPU
// version walks 8x256 int32 tiles with double-buffered DMA and emulates
// uint32 on int32; here one thread hashes one row on native uint32.
//
// Bound: device memory. A long key row reads 8 B of key, 1 B of validity and
// 4 B of seed and writes 4 B of hash (17 B for ~20 integer operations), far
// below the card's operations-per-byte line. The kernel therefore does one
// coalesced pass: neighbouring threads read neighbouring rows, the int64 key
// is split into its two words in registers, and the null pass-through
// (`where(validity, h, seed)`) is fused so nothing is written twice.
//
// Interface: a plain C launcher for ctypes. It launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1b873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t fmix(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  return h1 ^ (h1 >> 16);
}

template <typename Key>
__global__ void murmur3_rows_kernel(const Key* __restrict__ keys,
                                    const bool* __restrict__ valid,
                                    const int32_t* __restrict__ seed,
                                    int32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint32_t s = static_cast<uint32_t>(seed[i]);
    uint32_t h;
    if constexpr (sizeof(Key) == 8) {
      const uint64_t u = static_cast<uint64_t>(keys[i]);
      h = mix_h1(s, mix_k1(static_cast<uint32_t>(u)));
      h = fmix(mix_h1(h, mix_k1(static_cast<uint32_t>(u >> 32))), 8u);
    } else {
      h = fmix(mix_h1(s, mix_k1(static_cast<uint32_t>(keys[i]))), 4u);
    }
    out[i] = static_cast<int32_t>(valid[i] ? h : s);
  }
}

}  // namespace

extern "C" int murmur3_rows_launch(const void* keys, int key_bytes,
                                   const void* valid, const void* seed,
                                   void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 8) {
    murmur3_rows_kernel<int64_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const int64_t*>(keys), static_cast<const bool*>(valid),
        static_cast<const int32_t*>(seed), static_cast<int32_t*>(out), n);
  } else if (key_bytes == 4) {
    murmur3_rows_kernel<int32_t><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const bool*>(valid),
        static_cast<const int32_t*>(seed), static_cast<int32_t*>(out), n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
