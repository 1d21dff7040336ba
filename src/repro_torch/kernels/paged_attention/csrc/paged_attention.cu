// Paged decode attention for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/paged_attention.py (_decode_kernel,
// wrapper paged_attention_decode): one new token per sequence attends over
// that sequence's KV pages, reached through its row of a block table.
//
//   q        [B, H, D]                  H = KV * G (GQA)
//   k, v     [P, page_size, KV, D]      the paged pool of one layer
//   tables   int32 [B, max_pages]       page of each page slot (pad with 0)
//   lens     int32 [B]                  index of the newest valid token
//   out      [B, H, D]                  softmax(q.k / sqrt(D)) . v
//
// A position p counts when p <= lens[b] (inclusive).  The TPU kernel walks
// every page slot and masks with the finite NEG_INF = -1e30, so slots past
// the context get weight exp(-1e30 - m) = 0 exactly; this kernel stops at
// position min(lens[b], max_pages * page_size - 1), which gives the same
// sums.  lens[b] must be >= 0 (position 0 is always valid) and every page
// index a block reads must lie in [0, P).
//
// What bounds it: bytes.  A decode reads (ctx + 1) * D values of K and of V
// per KV head and does about 4 * G flops per value read, far below the
// card's ~20 flops per byte of fp32.  The TPU kernel grids over
// (batch, kv head, page slot) and carries the online softmax in VMEM
// scratch across the sequential page axis.  Here blocks run in parallel
// and carry nothing, so one block of 128 threads takes one (batch, kv head)
// and loops over the sequence itself, 64 positions a round: each warp
// scores its positions against all G query rows (lanes split D, a shuffle
// reduction per row), one warp per row updates the running max and sum,
// and the threads then fold the round's V rows into a [G, D] accumulator
// in shared memory.  Each thread reads its own block-table entries.  q,
// K and V may be fp32 or bf16; all arithmetic is fp32.
//
// The design keeps few blocks in flight (B * KV of them, 8 for one
// Qwen3-1.7B decode), so one SM streams a whole head's context: simple and
// right first; splitting the sequence across blocks is later work.
//
// The launcher allocates nothing and does not synchronise; it launches on
// the caller's stream and returns cudaGetLastError().

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;       // positions scored per round
constexpr int kMaxG = 16;        // query rows per KV head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, int kvh, int g, int d,
                    int page_size, int max_pages, float scale,
                    T* __restrict__ out) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // [g][d]
  float* acc_s = q_s + g * d;           // [g][d]
  float* s_s = acc_s + g * d;           // [g][kChunk] scores, then weights
  float* m_s = s_s + g * kChunk;        // [g] running max
  float* l_s = m_s + g;                 // [g] running sum
  float* alpha_s = l_s + g;             // [g] this round's rescale
  __shared__ long long off_s[kChunk];   // element offset of each K/V row

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gd = g * d;

  const long long q_off = (static_cast<long long>(b) * kvh + h) * gd;
  for (int e = tid; e < gd; e += kThreads) {
    q_s[e] = to_f(q[q_off + e]);
    acc_s[e] = 0.f;
  }
  for (int r = tid; r < g; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const long long cap = static_cast<long long>(max_pages) * page_size;
  const long long last = min(static_cast<long long>(lens[b]), cap - 1);
  const int n_tok = static_cast<int>(last + 1);
  const int32_t* table = tables + static_cast<long long>(b) * max_pages;
  __syncthreads();

  for (int c0 = 0; c0 < n_tok; c0 += kChunk) {
    const int n = min(kChunk, n_tok - c0);
    // scores: warp w takes positions w, w + kWarps, ... of the round
    for (int j = warp; j < n; j += kWarps) {
      const int t = c0 + j;
      const long long page = table[t / page_size];
      const long long off =
          ((page * page_size + t % page_size) * kvh + h) * d;
      if (lane == 0) off_s[j] = off;
      float part[kMaxG];
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) part[r] = 0.f;
      for (int i = lane; i < d; i += 32) {
        const float kx = to_f(k_pages[off + i]);
#pragma unroll
        for (int r = 0; r < kMaxG; ++r)
          if (r < g) part[r] += q_s[r * d + i] * kx;
      }
#pragma unroll
      for (int r = 0; r < kMaxG; ++r) {
        if (r < g) {
          const float s = warp_sum(part[r]);
          if (lane == 0) s_s[r * kChunk + j] = s * scale;
        }
      }
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int r = warp; r < g; r += kWarps) {
      float* s_row = s_s + r * kChunk;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_row[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(s_row[j] - m_new);
        s_row[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();
    // fold the round's V rows into the accumulator
    for (int e = tid; e < gd; e += kThreads) {
      const int r = e / d;
      const int i = e - r * d;
      const float* p_row = s_s + r * kChunk;
      float a = acc_s[e] * alpha_s[r];
      for (int j = 0; j < n; ++j) a += p_row[j] * to_f(v_pages[off_s[j] + i]);
      acc_s[e] = a;
    }
    __syncthreads();
  }
  for (int e = tid; e < gd; e += kThreads)
    store(out + q_off + e, acc_s[e] / fmaxf(l_s[e / d], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lens, void* out, int b, int h, int kvh, int d,
           int page_size, int max_pages, cudaStream_t stream) {
  const int g = h / kvh;
  // at most 16 * 256 * 8 + 16 * 64 * 4 + 192 bytes: below the 48 KB
  // a block gets without opting in
  const size_t smem = sizeof(float) * (2 * g * d + g * kChunk + 3 * g);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  paged_decode_kernel<T><<<dim3(kvh, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lens), kvh, g, d, page_size, max_pages,
      scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, pages and out alike).  Needs H % KV == 0,
// 1 <= H / KV <= 16 and 1 <= D <= 256 (checked by the Python wrapper).
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lens, void* out, int dtype,
                                      int b, int h, int kvh, int d,
                                      int page_size, int max_pages,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, tables, lens, out, b, h, kvh,
                         d, page_size, max_pages, s);
  return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, lens, out, b, h,
                               kvh, d, page_size, max_pages, s);
}
