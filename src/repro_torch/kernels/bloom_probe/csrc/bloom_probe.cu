// Bloom-filter probe kernels for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/bloom_probe/bloom_probe.py
// (_probe_kernel, wrapper bloom_probe), and adds the pairs form that the
// batched LSM read path calls (the reference computes that form only in
// jnp: src/repro/kernels/bloom_probe/ref.py, bloom_probe_pairs_ref).
//
// Probe i of a key tests bit (lo + i*hi) mod nbits of a packed uint32
// filter, in wrapping uint32 arithmetic, where lo / hi are the halves of
// the key's splitmix64 hash (hi forced odd); the key hits when all k bits
// are set.  The loop stops at the first clear bit: hit is an AND, so the
// result is the same as testing all k.
//
// bloom_probe (the TPU kernel's function): N keys, hashed on the host,
// arrive as lo / hi and probe one filter with one k -> int32[N].
//
// bloom_probe_pairs: one launch serves a whole batched read across every
// level of the store.  The host sends the batch's raw uint64 keys once and,
// for each (key x candidate SST) pair, the key's index, the SST's slot and
// the pair's k (9 bytes).  Each thread takes one pair, hashes its key with
// the splitmix64 finaliser (bit for bit repro_torch.lsm.sstable._mix64),
// and probes the slot's filter inside the store's resident image; the slot
// table (word offset, word count) stays on the card with the image ->
// uint8[P].
//
// What bounds them: a launch carries ~64 keys and a few hundred pairs,
// ~3 KB, and gathers a few words each from an image of a few MB that stays
// in the 50 MB L2.  Its device time is the launch floor (~2 us) whatever
// the body does, so the design deliberately keeps no shared-memory
// staging, no TMA and no tensor-core work: one thread per pair with a
// grid-stride loop.  What this card rewards here is fewer launches and
// fewer host round trips, which the read path gets by hashing on the card
// and probing all levels of a batch in one launch.
//
// The launchers allocate nothing and do not synchronise; they launch on
// the caller's stream and return cudaGetLastError() so the wrapper can
// raise on a refused launch.

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

// splitmix64 finaliser: three xor-shifts, two wrapping 64-bit multiplies
__device__ __forceinline__ uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
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

__global__ void bloom_probe_pairs_kernel(
    const uint64_t* __restrict__ keys, const int32_t* __restrict__ pair_key,
    const int32_t* __restrict__ pair_slot, const uint8_t* __restrict__ pair_k,
    const int64_t* __restrict__ slot_off,
    const int32_t* __restrict__ slot_words,
    const uint32_t* __restrict__ words, int64_t n, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n; p += stride) {
    const uint64_t h = mix64(__ldg(keys + __ldg(pair_key + p)));
    const uint32_t lo = static_cast<uint32_t>(h);
    const uint32_t hi = static_cast<uint32_t>(h >> 32) | 1u;
    const int32_t s = __ldg(pair_slot + p);
    // uint32 wrap of num_words * 32, as the reference computes it
    const uint32_t nbits = static_cast<uint32_t>(__ldg(slot_words + s)) * 32u;
    out[p] = static_cast<uint8_t>(
        probe_one(lo, hi, words + __ldg(slot_off + s), nbits, __ldg(pair_k + p)));
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

extern "C" int bloom_probe_pairs(const void* keys, const void* pair_key,
                                 const void* pair_slot, const void* pair_k,
                                 const void* slot_off, const void* slot_words,
                                 const void* words, long long n, void* out,
                                 void* stream) {
  bloom_probe_pairs_kernel<<<grid_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(keys), static_cast<const int32_t*>(pair_key),
      static_cast<const int32_t*>(pair_slot),
      static_cast<const uint8_t*>(pair_k),
      static_cast<const int64_t*>(slot_off),
      static_cast<const int32_t*>(slot_words),
      static_cast<const uint32_t*>(words), static_cast<int64_t>(n),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
