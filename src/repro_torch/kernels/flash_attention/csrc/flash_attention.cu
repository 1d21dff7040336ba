// Flash attention forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_fwd_kernel,
// wrapper flash_attention_fwd):
//
//   q     [B, H, Sq, D]       H = KV * G (GQA)
//   k, v  [B, KV, Skv, D]
//   out   [B, H, Sq, D]       softmax(q.k / sqrt(D) + mask) . v
//
// with the key at position kp visible to the query at position qp when
// kp < Skv, and, if causal, kp <= qp, and, with a window, kp > qp - window.
// Masked scores are the finite NEG_INF = -1e30 of the TPU kernel, so a row
// that meets only masked keys in a tile carries weight-1 garbage that the
// next tile with a visible key scales by exp(-1e30 - m) = 0, as there.
//
// As on the TPU, the G query heads of a KV head are folded into the rows
// of one problem: row r = qp * G + g.  The TPU kernel grids over
// (batch, kv head, q block, k block) with the k blocks sequential and the
// online softmax carried in VMEM scratch; it asserts that the sequence is a
// multiple of its 256-row blocks.  Here one block of 128 threads takes 32
// folded rows of one (batch, kv head) and loops over the key tiles itself,
// 32 keys a tile, from the first tile the window can see to the last one
// the causal mask lets through; tiles past that contribute exactly 0 and
// are skipped.  Rows and keys past the end are masked in the kernel, so
// any Sq and Skv work (the engine's prompts have any length).
//
// Per tile, K and V go to shared memory as fp32 (K rows padded by one word
// so the 32 lanes read 32 banks).  Warp w owns rows w, w + 4, ..., w + 28
// and lane c owns key c of the tile: a lane computes the 8 scores of its
// key, the row max and sum are warp shuffles, and P.V reads each weight
// from its lane with a shuffle while each lane accumulates D / 32 columns
// of its 8 rows in registers.
//
// What bounds it: operations.  A causal prefill of S positions does about
// 2 * S^2 * H * D flops on 4 * S * (H + 2 KV) * D bytes, far above the
// card's ~20 flops per byte of fp32 CUDA-core work.  This first kernel
// runs on the CUDA cores in fp32, without tensor cores (mma / wgmma), TMA
// or a pipelined ring of tiles: that is later work.
//
// The launcher allocates nothing and does not synchronise; it launches on
// the caller's stream and returns cudaGetLastError().

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // folded q rows per block
constexpr int kTile = 32;                      // keys per tile: one a lane
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

// ND = columns of D a lane accumulates: D <= 32 * ND.
template <typename T, int ND>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int h,
                 int kvh, int sq, int skv, int d, int causal, int window,
                 float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                     // [kRows][d]
  float* k_s = q_s + kRows * d;          // [kTile][d + 1]
  float* v_s = k_s + kTile * (d + 1);    // [kTile][d]

  const int g = h / kvh;
  const int r0 = blockIdx.x * kRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_rows = sq * g;
  const long long head0 = static_cast<long long>(b) * h + hk * g;

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int r = e / d;
    const int i = e - r * d;
    const int rr = r0 + r;
    float x = 0.f;
    if (rr < n_rows) {
      const int pos = rr / g;
      x = to_f(q[((head0 + rr % g) * sq + pos) * d + i]);
    }
    q_s[e] = x;
  }

  int qp[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][ND];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    qp[r] = (r0 + warp + kWarps * r) / g;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[r][j] = 0.f;
  }

  // keys the block's rows can see
  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + kRows, n_rows) - 1) / g;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  k_beg -= k_beg % kTile;
  const long long kv0 = (static_cast<long long>(b) * kvh + hk) * skv * d;

  for (int k0 = k_beg; k0 < k_end; k0 += kTile) {
    __syncthreads();                     // the last tile is consumed
    for (int e = tid; e < kTile * d; e += kThreads) {
      const int c = e / d;
      const int i = e - c * d;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < skv) {
        const long long off = kv0 + static_cast<long long>(k0 + c) * d + i;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[c * (d + 1) + i] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* k_row = k_s + lane * (d + 1);
    for (int i = 0; i < d; ++i) {
      const float kx = k_row[i];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] += q_s[(warp + kWarps * r) * d + i] * kx;
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool seen = kp < skv && (!causal || kp <= qp[r]) &&
                        (window <= 0 || kp > qp[r] - window);
      const float x = seen ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[r][j] *= alpha;
    }

    // P.V: weight (row r, key c) lives in lane c
    for (int c = 0; c < kTile; ++c) {
      const float* v_row = v_s + c * d;
      float vx[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int i = lane + 32 * j;
        vx[j] = i < d ? v_row[i] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = __shfl_sync(0xffffffffu, s[r], c);
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[r][j] += p * vx[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int rr = r0 + warp + kWarps * r;
    if (rr >= n_rows) continue;
    const long long off = ((head0 + rr % g) * sq + rr / g) * d;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int i = lane + 32 * j;
      if (i < d) store(out + off + i, acc[r][j] / den);
    }
  }
}

template <typename T, int ND>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int kvh, int sq, int skv, int d, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      (static_cast<size_t>(kRows) * d + kTile * (d + 1) +
                       static_cast<size_t>(kTile) * d);
  auto kern = flash_fwd_kernel<T, ND>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int g = h / kvh;
  const dim3 grid((sq * g + kRows - 1) / kRows, kvh, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), h, kvh, sq, skv, d,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int h, int kvh, int sq, int skv, int d, int causal, int window,
             cudaStream_t s) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, out, b, h, kvh, sq, skv, d, causal, window, s);
  if (d <= 64)
    return launch<T, 2>(q, k, v, out, b, h, kvh, sq, skv, d, causal, window, s);
  if (d <= 128)
    return launch<T, 4>(q, k, v, out, b, h, kvh, sq, skv, d, causal, window, s);
  return launch<T, 8>(q, k, v, out, b, h, kvh, sq, skv, d, causal, window, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and out alike).  window <= 0 means no
// window.  Needs H % KV == 0, 1 <= D <= 256 and Sq, Skv >= 1 (checked by
// the Python wrapper).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int dtype,
                                   int b, int h, int kvh, int sq, int skv,
                                   int d, int causal, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, b, h, kvh, sq, skv, d, causal,
                           window, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, b, h, kvh, sq, skv, d, causal,
                                 window, s);
}
