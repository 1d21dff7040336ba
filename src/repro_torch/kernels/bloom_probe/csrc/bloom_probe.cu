// Bloom-filter probe kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_probe/bloom_probe.py
// (_probe_kernel, wrapper bloom_probe), and adds the ragged pairs form that
// the batched LSM read path calls (the reference computes that form only in
// jnp: src/repro/kernels/bloom_probe/ref.py, bloom_probe_pairs_ref).
//
// Each key (or key x filter pair) arrives pre-hashed as two uint32 halves
// lo / hi (hi odd).  Probe i tests bit (lo + i*hi) mod nbits of a packed
// uint32 filter, in wrapping uint32 arithmetic; the key hits when all k bits
// are set.  The loop stops at the first clear bit: hit is an AND, so the
// result is the same as testing all k.
//
// What bounds it: per pair, 8 bytes of hash, 12 bytes of (word_off as
// int64, num_words as int32) and a 4-byte result, plus at most k 4-byte
// gathers from the filter image.  A level's image is a few MB, which stays
// resident in the 50 MB L2.  The read path launches it with about 64 keys
// x a few candidate SSTs per level, so launch latency, not bytes, sets its
// time: one thread per key or pair with a grid-stride loop is enough, and
// the design keeps no shared-memory staging, no TMA and no tensor-core
// work.
//
// The launchers allocate nothing and do not synchronise; they launch on the
// caller's stream and return cudaGetLastError() so the wrapper can raise on
// a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ int32_t probe_one(uint32_t lo, uint32_t hi,
                                             const uint32_t* __restrict__ words,
                                             uint32_t nbits, int k) {
  for (int i = 0; i < k; ++i) {
    const uint32_t pos = (lo + static_cast<uint32_t>(i) * hi) % nbits;
    const uint32_t w = __ldg(words + (pos >> 5));
    if (((w >> (pos & 31u)) & 1u) == 0u) return 0;
  }
  return 1;
}

__global__ void bloom_probe_kernel(const uint32_t* __restrict__ lo,
                                   const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ bits,
                                   uint32_t nbits, int64_t n, int k,
                                   int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    out[p] = probe_one(__ldg(lo + p), __ldg(hi + p), bits, nbits, k);
  }
}

__global__ void bloom_probe_pairs_kernel(const uint32_t* __restrict__ lo,
                                         const uint32_t* __restrict__ hi,
                                         const int64_t* __restrict__ word_off,
                                         const int32_t* __restrict__ num_words,
                                         const uint32_t* __restrict__ bits,
                                         int64_t n, int k,
                                         int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    // uint32 wrap of num_words * 32, as the reference computes it
    const uint32_t nbits = static_cast<uint32_t>(__ldg(num_words + p)) * 32u;
    out[p] = probe_one(__ldg(lo + p), __ldg(hi + p),
                       bits + __ldg(word_off + p), nbits, k);
  }
}

inline unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int bloom_probe(const void* lo, const void* hi, const void* bits,
                           long long num_words, long long n, int k, void* out,
                           void* stream) {
  const uint32_t nbits = static_cast<uint32_t>(num_words) * 32u;
  bloom_probe_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(bits), nbits, static_cast<int64_t>(n), k,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bloom_probe_pairs(const void* lo, const void* hi,
                                 const void* word_off, const void* num_words,
                                 const void* bits, long long n, int k,
                                 void* out, void* stream) {
  bloom_probe_pairs_kernel<<<grid_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const int64_t*>(word_off),
      static_cast<const int32_t*>(num_words),
      static_cast<const uint32_t*>(bits), static_cast<int64_t>(n), k,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
