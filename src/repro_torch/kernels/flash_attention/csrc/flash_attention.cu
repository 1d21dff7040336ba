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
// multiple of its 256-row blocks.  Here a block takes a run of folded rows
// of one (batch, kv head) and loops over the key tiles itself, from the
// first tile the window can see to the last one the causal mask lets
// through; tiles past that contribute exactly 0 and are skipped.  Rows and
// keys past the end are masked in the kernel, so any Sq and Skv work (the
// engine's prompts have any length).
//
// What bounds it: operations.  A prefill of S positions does 4 * S^2 * H *
// D flops (half that under the causal mask) on 2 * S * (H + KV) * D values
// read or written: hundreds of flops per byte, above both the fp32 CUDA
// cores' ~20 and the bf16 tensor cores' ~295 per byte of HBM.
// Two kernels, chosen by the wrapper before the launch:
//
// bf16, D a multiple of 16 up to 256 (flash_fwd_bf16_wgmma_kernel): on the
// tensor cores, by warpgroup.  A block is one warpgroup (4 warps) and takes
// 64 folded rows, walking the keys 64 a tile.  Q (64 x D) and a two-stage
// ring of K and V tiles (64 x D each) sit in shared memory as column blocks
// of 64 x 64, rows of 128 bytes with each 16-byte chunk at chunk ^ (row %
// 8): the layout of wgmma's 128-byte swizzle, the blocks on 1,024-byte
// boundaries.  cp.async fills them (16 bytes a thread, rows and columns
// past the end zero-filled; a proxy fence before the barrier hands them to
// the tensor cores): tile t + 1 is requested right after the one barrier
// of tile t and lands while tile t computes.  S = Q.K^T is D / 16
// m64n64k16 wgmma products with both operands read from shared memory
// through descriptors (K-major; a k-step is 32 bytes on inside a 128-byte
// row, 8 KB on to the next column block).  O += P.V is 4 m64n64k16
// products per 64 columns of D, with P from registers, rounded to bf16
// from the S accumulators (as the reference's sdpa casts its weights to
// v's dtype; two n-tiles of accumulators are one k-step's A fragment), and
// V read MN-major (8-row groups 1,024 bytes apart).  The online softmax
// stays in registers in fp32: the max in log2 units, each weight one
// ex2.approx of fma(score, log2(e) / sqrt(D), -max); a row's max and sum
// are shuffles across the 4 lanes that hold it.  Masks apply only on tiles
// that cut the block's rows, and blocks launch latest rows (most tiles)
// first.  D below the instantiated width (64, 128, 256) is padded with
// zero columns.  A wrong descriptor gives wrong sums, not a fault, so the
// card run checks every (D, G, mask) the models use, and more, against
// the plain version.  Not yet done: a producer warp with TMA and mbarriers,
// and overlapping one tile's softmax with the next tile's products.
//
// fp32, or bf16 with another D (flash_fwd_kernel): fp32 arithmetic on the
// CUDA cores, without TF32.  A block of 128 threads takes 64 folded rows
// and walks the keys 32 a tile.  Q (64 x D) and a two-stage ring of K and
// V tiles sit in shared memory as fp32, rows padded by 4 words; fp32 rows
// with D % 4 == 0 come by cp.async (tile t + 1 lands while tile t
// computes), others are loaded and converted a value at a time.  The
// threads form 16 row groups x 8 column groups, and a thread holds a
// register micro-tile of 4 rows x 4 keys of S and of 4 rows x D / 8
// columns of O, so each float4 it reads from shared memory feeds 4 to 16
// FMAs: S from float4s of 4 Q rows and 4 K rows a step, P through shared
// memory, O from float4s of P and of V rows.  The online softmax stays in
// registers; a row's max and sum are shuffles over its 8 lanes.
//
// A row that sees no key at all (a window, qp >= Skv + window - 1) gets
// the reference's output there, the uniform weights of the -1e30 fill:
// the mean of all of its KV head's v, summed in fp32 in key order, and the
// fill's log-sum-exp, -1e30, written by flash_fwd_no_key_kernel, which
// the launchers add after either kernel only when a call has such rows.
//
// With a non-null lse pointer both forward kernels also write each row's
// log-sum-exp of its scaled scores (natural log, fp32 [B, H, Sq]); the
// autograd Function passes one when it needs a gradient, inference
// launches do not.
//
// The backward (every attention layer of a train step).  It replaces no
// Pallas kernel: the reference's custom VJP (src/repro/kernels/
// flash_attention/ops.py, _bwd) recomputes attention with jnp under
// jax.vjp.  From q, k, v, out, dout and lse, with P = exp(S / sqrt(D) -
// lse) and Delta = sum_d dO O a row:
//
//   dV = P^T dO     dS = P (dO V^T - Delta)     dQ = dS K / sqrt(D)
//   dK = dS^T Q / sqrt(D)
//
// masked entries exactly 0 (as autograd through attention_ref, whose
// masked scores are a constant), and a row that sees no key at all (a
// window, Sq past Skv + window - 1) adding dO / Skv to every key's dV, the
// uniform weights of the -1e30 fill.  What bounds it: operations, 10
// flops a (query head, visible key, head dim) for five products.  Two
// kernels, each owning its output rows, so there are no atomics and a
// rerun gives the same bits; the price is seven products where the bound
// counts five (S and dP in both), a ceiling of 0.71 of the bound.
//
// bf16, D a multiple of 16 up to 128 (namespace hb, the wrapper's "mma"):
// on the tensor cores with wgmma, fed through rings of mbarrier stages that
// TMA fills (cp.async.bulk.tensor on 4-d tensor maps of q, dout, k and v,
// the 128-byte swizzle the forward's tiles use; zeros past every end).  A
// block is consumer warpgroups of 64 rows each and a producer warpgroup
// whose first thread issues every copy, up to 8 tiles ahead, each stage
// refilled once every consumer warp has released it; setmaxnreg hands the
// producer's registers to the consumers.  Positions are not folded: a
// tile is 64 positions of one query head (a TMA box).
//   flash_bwd_dq_wgmma_kernel: 64 positions of one head a warpgroup (three
//     at D 64, two at D 128), walking the 64-key tiles they can see: S =
//     Q K^T and dP = dO V^T in one group (both operands in shared memory,
//     K-major), then dQ += dS K (dS from registers, K MN-major).  First it
//     computes Delta for its rows and writes it, with lse in log2 units,
//     into a [2, B, H, Sq rounded up to 64] scratch for the second kernel.
//   flash_bwd_dkdv_wgmma_kernel: 64 keys of a (batch, KV head) a
//     warpgroup, two a block, K and V loaded once; it walks tiles of 64
//     positions of each of the G query heads that can see them, head after
//     head, with the tile's lse and Delta copied beside Q and dO: S^T = K
//     Q^T and dP^T = V dO^T in one group, then dV += P^T dO and dK += dS^T
//     Q in one (P^T and dS^T from registers as the forward hands P to P.V,
//     dO and Q MN-major), the sums over the group in registers.
// The elementwise work of a tile is straight-line: every exponential taken
// (ex2 of a log2-scaled score), masks selected; only tiles that cut a mask
// evaluate it.  The blocks with the most work launch first.
//
// fp32, and bf16 with another D (namespace bw, "simt"): fp32 arithmetic on
// the CUDA cores, no TF32.  flash_bwd_dq_kernel takes 64 folded rows r =
// qp * G + g of a (batch, KV head) and walks the key tiles they can see,
// 32 keys a tile; flash_bwd_dkdv_kernel takes 32 keys and walks the folded
// rows of all G query heads that can see them, 32 a tile, so the sums over
// the group stay in registers: the forward's register micro-tiles, tiles
// loaded with cp.async.
//
// The launchers allocate nothing and do not synchronise; they launch on
// the caller's stream and return cudaGetLastError().

#include <cmath>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------
// fp32 arithmetic on the CUDA cores
// ---------------------------------------------------------------------
namespace cc {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kRows = 64;       // folded q rows a block: 4 a row group
constexpr int kKeys = 32;       // keys a tile: 4 a column group
constexpr int kPad = 4;         // floats after each shared row
constexpr int kPs = kKeys + kPad;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The rows that see no key (a window, qp >= first = skv + window - 1) get
// the reference's output there, the uniform weights of the -1e30 fill:
// the mean of their KV head's v, summed in fp32 in key order and rounded
// to the output's type, and the fill's log-sum-exp, -1e30.  A block a
// (KV head, batch); the launcher adds it after the forward kernel only
// when a call has such rows, and the forward kernels' own rows stay as
// they were (no model makes such rows).
template <typename T>
__global__ void __launch_bounds__(256)
flash_fwd_no_key_kernel(const T* __restrict__ v, T* __restrict__ out,
                        float* __restrict__ lse, int h, int kvh, int sq,
                        int skv, int d, int first) {
  extern __shared__ float mean_s[];    // [d]
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / kvh;
  const T* vb = v + (static_cast<long long>(b) * kvh + hk) * skv * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.f;
    for (int n = 0; n < skv; ++n)
      acc += to_f(vb[static_cast<long long>(n) * d + c]);
    mean_s[c] = acc / static_cast<float>(skv);
  }
  __syncthreads();
  const long long head0 = static_cast<long long>(b) * h + hk * g;
  const int rows = (sq - first) * g;   // (position, head) pairs
  for (long long e = threadIdx.x; e < static_cast<long long>(rows) * d;
       e += blockDim.x) {
    const int r = static_cast<int>(e / d);
    const int c = static_cast<int>(e - static_cast<long long>(r) * d);
    store(out + ((head0 + r % g) * sq + first + r / g) * d + c, mean_s[c]);
  }
  if (lse != nullptr)
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      lse[(head0 + r % g) * sq + first + r / g] = kNegInf;
}

// After a forward launch: the rows that see no key, if the call has any.
template <typename T>
int no_key_rows(const void* v, void* out, float* lse, int b, int h,
                int kvh, int sq, int skv, int d, int window,
                cudaStream_t stream) {
  const int first = skv + window - 1;
  if (window <= 0 || first >= sq) return static_cast<int>(cudaSuccess);
  flash_fwd_no_key_kernel<T><<<dim3(kvh, b), 256, sizeof(float) * d,
                               stream>>>(
      static_cast<const T*>(v), static_cast<T*>(out), lse, h, kvh, sq, skv,
      d, first);
  return static_cast<int>(cudaGetLastError());
}

// ROWS rows into dst [ROWS][KD + kPad] as fp32: row r from row_of(r)
// (nullptr past the end: zeros), columns past d zero.  vec (fp32, d % 4 ==
// 0, 16-byte aligned rows): cp.async, landing by the next wait; otherwise
// loaded and converted a value at a time, visible after the next barrier.
template <typename T, int KD, int ROWS, typename RowOf>
__device__ __forceinline__ void load_rows(float* dst, RowOf row_of, int d,
                                          bool vec, const T* any) {
  constexpr int kS = KD + kPad;
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int e = tid; e < ROWS * KD / 4; e += kThreads) {
        const int r = e / (KD / 4);
        const int c = (e - r * (KD / 4)) * 4;
        const T* src = row_of(r);
        const bool ok = src != nullptr && c < d;
        cp_async16(dst + r * kS + c, ok ? src + c : any, ok);
      }
      return;
    }
  }
  for (int e = tid; e < ROWS * KD; e += kThreads) {
    const int r = e / KD;
    const int i = e - r * KD;
    const T* src = row_of(r);
    dst[r * kS + i] = src != nullptr && i < d ? to_f(src[i]) : 0.f;
  }
}

// KD: the instantiated head dim (d <= KD; columns past d are zero in
// shared memory and never stored).  Thread (rg, cg) = (tid / 8, tid % 8)
// holds rows 4 rg .. 4 rg + 3 of the block; of S, keys cg + 8 j of the
// tile (so the 8 lanes of a row group read 8 K rows on 32 banks); of O,
// columns 4 cg + 32 c .. + 3 (so they read 128 contiguous bytes of a V
// row).  A row's max and sum are shuffles over its 8 lanes.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int h,
                 int kvh, int sq, int skv, int d, int causal, int window,
                 int vec, float scale) {
  constexpr int kS = KD + kPad;        // shared row stride, floats
  constexpr int kC = KD / 32;          // float4 columns of O a thread
  extern __shared__ __align__(16) float cc_smem[];
  float* q_s = cc_smem;                // [kRows][kS]
  float* kv_s = q_s + kRows * kS;      // [2][K, V][kKeys][kS]
  float* p_s = kv_s + 4 * kKeys * kS;  // [kRows][kPs]

  const int g = h / kvh;
  const int n_rows = sq * g;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // latest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const long long head0 = static_cast<long long>(b) * h + hk * g;
  const long long kv0 = (static_cast<long long>(b) * kvh + hk) * skv * d;
  const T* kb = k + kv0;
  const T* vb = v + kv0;

  // keys the block's rows can see
  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + kRows, n_rows) - 1) / g;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kKeys - 1) / kKeys
                                    : 0;

  load_rows<T, KD, kRows>(
      q_s,
      [&](int r) -> const T* {
        const int rr = r0 + r;
        return rr < n_rows ? q + ((head0 + rr % g) * sq + rr / g) * d
                           : nullptr;
      },
      d, vec, q);
  auto load_kv = [&](int t) {
    const int k0 = k_beg + t * kKeys;
    float* ks = kv_s + (t & 1) * 2 * kKeys * kS;
    load_rows<T, KD, kKeys>(
        ks,
        [&](int n) -> const T* {
          return k0 + n < skv ? kb + static_cast<long long>(k0 + n) * d
                              : nullptr;
        },
        d, vec, q);
    load_rows<T, KD, kKeys>(
        ks + kKeys * kS,
        [&](int n) -> const T* {
          return k0 + n < skv ? vb + static_cast<long long>(k0 + n) * d
                              : nullptr;
        },
        d, vec, q);
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  int qp[4];
  float m[4], l[4], o[4][kC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qp[i] = (r0 + rg * 4 + i) / g;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }
  const int d4 = (d + 3) & ~3;         // columns holding data

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();                   // tile t is in; tile t - 1's stage
                                       // and p_s are free
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    const int k0 = k_beg + t * kKeys;
    const float* ks = kv_s + (t & 1) * 2 * kKeys * kS;
    const float* vs = ks + kKeys * kS;

    // S: 4 rows x 4 keys, 4 columns of D a step
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d4; c += 4) {
      float4 qv[4], kx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (rg * 4 + i) * kS + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kx[j] = *reinterpret_cast<const float4*>(ks + (cg + 8 * j) * kS + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kx[j].x, a);
          a = fmaf(qv[i].y, kx[j].y, a);
          a = fmaf(qv[i].z, kx[j].z, a);
          s[i][j] = fmaf(qv[i].w, kx[j].w, a);
        }
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 8 * j;
        const bool seen = kp < skv && (!causal || kp <= qp[i]) &&
                          (window <= 0 || kp > qp[i] - window);
        s[i][j] = seen ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o_ = 1; o_ < 8; o_ <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        l[i] += p;
        p_s[(rg * 4 + i) * kPs + cg + 8 * j] = p;
      }
    }
    __syncthreads();

    // O += P . V: 4 rows x 4 kC columns, 4 keys a step
#pragma unroll 2
    for (int n = 0; n < kKeys; n += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (rg * 4 + i) * kPs + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (n + nn) * kS + cg * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = nn == 0 ? pv[i].x : nn == 1 ? pv[i].y
                          : nn == 2 ? pv[i].z : pv[i].w;
            o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int o_ = 1; o_ < 8; o_ <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o_);
    const int rr = r0 + rg * 4 + i;
    if (rr >= n_rows) continue;
    const float den = fmaxf(sum, 1e-30f);
    if (lse != nullptr && cg == 0)
      lse[(head0 + rr % g) * sq + rr / g] = m[i] + logf(den);
    T* dst = out + ((head0 + rr % g) * sq + rr / g) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 32 * c + e;
        if (col < d) store(dst + col, o[i][c][e] / den);
      }
  }
}

template <typename T, int KD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int h, int kvh, int sq, int skv, int d,
           int causal, int window, cudaStream_t stream) {
  constexpr int kS = KD + kPad;
  const size_t smem =
      sizeof(float) * (kRows * kS + 4 * kKeys * kS + kRows * kPs);
  auto kern = flash_fwd_kernel<T, KD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = std::is_same<T, float>::value && d % 4 == 0 &&
                  align % 16 == 0;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const int g = h / kvh;
  const dim3 grid((sq * g + kRows - 1) / kRows, kvh, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, h, kvh, sq, skv,
      d, causal, window, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int h, int kvh, int sq, int skv, int d,
             int causal, int window, cudaStream_t s) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, lse, b, h, kvh, sq, skv, d, causal,
                         window, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, lse, b, h, kvh, sq, skv, d, causal,
                         window, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, lse, b, h, kvh, sq, skv, d, causal,
                          window, s);
  return launch<T, 256>(q, k, v, out, lse, b, h, kvh, sq, skv, d, causal,
                        window, s);
}

}  // namespace cc

// ---------------------------------------------------------------------
// bf16 on the tensor cores (wgmma)
// ---------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kRows = 64;       // folded q rows a block: one m64 tile
constexpr int kKeys = 64;       // keys a tile
constexpr int kBlock = 64 * 64; // elements of a [64][64] swizzled block
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Element offset of 16-byte chunk c of row r (0..63) in a tile of 64 rows
// stored as column blocks of [64 rows][64 elements]: each block rows of
// 128 bytes, the chunk at (c % 8) ^ (r % 8), the layout of wgmma's 128-byte
// swizzle when the block starts on 1,024 bytes.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * kBlock + r * 64 + (((c ^ r) & 7) << 3);
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU instruction (2^-huge = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of accumulators across
// the asynchronous products
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A . B, m64n64k16, A and B from shared memory, both K-major
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A . B, m64n64k16, A and B from shared memory, both K-major: the first
// k-step of a product, whose accumulators need no zeros first
__device__ __forceinline__ void mma_ss_first(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// d += A . B, m64n64k16, A from registers (the mma.m16n8k16 A layout per
// warp), B from shared memory MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// KD: the instantiated head dim (a multiple of 64; d <= KD, d % 16 == 0,
// columns past d zero in shared memory and never stored).  Accumulators
// follow wgmma's m64nN layout: warp w holds rows 16 w + gid and
// 16 w + gid + 8, d[4 j + e] the columns 8 j + 2 tig + (e & 1).
template <int KD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_wgmma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ out, float* __restrict__ lse,
                            int h, int kvh, int sq, int skv, int d,
                            int causal, int window, float scale_log2) {
  constexpr int kChunks = KD / 8;
  constexpr int kTile = kKeys * KD;
  constexpr int kCB = KD / 64;                   // column blocks
  extern __shared__ __align__(128) unsigned char wg_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t{1023});
  bf16* kv_s = q_s + kRows * KD;                 // [2][K, V][kTile]

  const int g = h / kvh;
  const int n_rows = sq * g;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // latest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const long long head0 = static_cast<long long>(b) * h + hk * g;
  const long long kv0 = (static_cast<long long>(b) * kvh + hk) * skv * d;
  const bf16* kb = k + kv0;
  const bf16* vb = v + kv0;

  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + kRows, n_rows) - 1) / g;
  const int k_end = causal ? min(skv, q_hi + 1) : skv;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kKeys - 1) / kKeys
                                    : 0;

  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const int rr = r0 + r;
    const bool ok = rr < n_rows && c * 8 < d;
    const bf16* src =
        ok ? q + ((head0 + rr % g) * sq + rr / g) * d + c * 8 : q;
    cp_async16(q_s + swz(r, c), src, ok);
  }
  auto load_kv = [&](int t) {
    const int k0 = k_beg + t * kKeys;
    bf16* ks = kv_s + (t & 1) * 2 * kTile;
    bf16* vs = ks + kTile;
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int n = e / kChunks;
      const int c = e - n * kChunks;
      const bool ok = k0 + n < skv && c * 8 < d;
      const long long off =
          ok ? static_cast<long long>(k0 + n) * d + c * 8 : 0;
      cp_async16(ks + swz(n, c), kb + off, ok);
      cp_async16(vs + swz(n, c), vb + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  const int row_a = r0 + warp * 16 + gid;
  const int qp[2] = {row_a / g, (row_a + 8) / g};

  float o[kCB][32];
#pragma unroll
  for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    const int k0 = k_beg + t * kKeys;
    const bf16* ks = kv_s + (t & 1) * 2 * kTile;
    const bf16* vs = ks + kTile;

    // S = Q . K^T: KD / 16 k-steps, 32 bytes apart in a 128-byte row,
    // the next column block 8 KB on
    fence();
    pin(s);
#pragma unroll
    for (int kc = 0; kc < KD / 16; ++kc) {
      const int off = (kc >> 2) * kBlock + (kc & 3) * 16;
      mma_ss(s, desc(q_s + off, 16, 1024), desc(ks + off, 16, 1024),
             kc > 0);
    }
    commit();
    wait_all();
    pin(s);

    // mask where the tile cuts the block's rows; rescale by the new max,
    // kept in log2 units
    const bool whole = k0 + kKeys <= skv &&
                       (!causal || k0 + kKeys - 1 <= q_lo) &&
                       (window <= 0 || k0 > q_hi - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      if (!whole) {
        const int kp = k0 + (i >> 2) * 8 + tig * 2 + (i & 1);
        const int p = qp[hf];
        const bool seen = kp < skv && (!causal || kp <= p) &&
                          (window <= 0 || kp > p - window);
        s[i] = seen ? s[i] : kNegInf;
      }
      mx[hf] = fmaxf(mx[hf], s[i]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mn = fmaxf(m[hf], quad_max(mx[hf]) * scale_log2);
      const float alpha = ex2(m[hf] - mn);
      m[hf] = mn;
      l[hf] *= alpha;
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[cb][4 * j + 2 * hf] *= alpha;
          o[cb][4 * j + 2 * hf + 1] *= alpha;
        }
    }
    // P = 2^(s * scale - m), rounded to bf16: n-tiles 2 kk and 2 kk + 1
    // are the A fragment of key step kk
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p[e] = ex2(fmaf(s[8 * kk + e], scale_log2, -m[(e >> 1) & 1]));
      l[0] += p[0] + p[1] + p[4] + p[5];
      l[1] += p[2] + p[3] + p[6] + p[7];
      a[kk][0] = pack_bf16(p[0], p[1]);
      a[kk][1] = pack_bf16(p[2], p[3]);
      a[kk][2] = pack_bf16(p[4], p[5]);
      a[kk][3] = pack_bf16(p[6], p[7]);
    }
    // O += P . V: per 64-column block, 4 key steps of 16 rows (2 KB on);
    // V is MN-major, its 8-row groups 1,024 bytes apart (SBO)
    fence();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) {
      pin(o[cb]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(o[cb], a[kk], desc(vs + cb * kBlock + kk * 16 * 64, 16, 1024));
    }
    commit();
    wait_all();
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) pin(o[cb]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float den = fmaxf(quad_sum(l[hf]), 1e-30f);
    const float inv = 1.f / den;
    const int rr = row_a + 8 * hf;
    if (rr >= n_rows) continue;
    if (lse != nullptr && tig == 0)      // in natural-log units
      lse[(head0 + rr % g) * sq + rr / g] = (m[hf] + log2f(den)) * kLn2;
    bf16* dst = out + ((head0 + rr % g) * sq + rr / g) * d;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + j * 8 + tig * 2;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[cb][4 * j + 2 * hf] * inv,
                                    o[cb][4 * j + 2 * hf + 1] * inv);
      }
  }
}

template <int KD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int h, int kvh, int sq, int skv, int d,
           int causal, int window, cudaStream_t stream) {
  // the tiles, and room to start them on 1,024 bytes
  const size_t smem = sizeof(bf16) * (kRows + 4 * kKeys) * KD + 1024;
  auto kern = flash_fwd_bf16_wgmma_kernel<KD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float scale_log2 = static_cast<float>(
      1.4426950408889634 / sqrt(static_cast<double>(d)));
  const int g = h / kvh;
  const dim3 grid((sq * g + kRows - 1) / kRows, kvh, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, h, kvh, sq,
      skv, d, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------
// backward on the CUDA cores (fp32, and bf16 the tensor cores do not take)
// ---------------------------------------------------------------------
namespace bw {

constexpr int kThreads = 128;
constexpr int kS_Pad = cc::kPad;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;       // [B, H, Sq], natural log
  float* delta;           // Delta: [B, H, Sq]; tensor cores [B, H, sq_pad]
  float* lse2;            // tensor cores: lse in log2 units [B, H, sq_pad]
  void* dq;
  void* dk;
  void* dv;
  int h, kvh, sq, skv, d, causal, window, vec;
  int sq_pad;                      // tensor cores: Sq rounded up to 64
  int do_hfirst;                   // tensor cores: dout's head stride is
                                   // below its position stride
  long long do_sb, do_sh, do_ss;   // dout's strides, elements (D's 1)
  float scale;                     // 1 / sqrt(D)
};

// Whether the query at qp sees the key at kp; without branches, so the
// tensor-core kernels' elementwise code stays straight-line
__device__ __forceinline__ bool seen(int qp, int kp, const Args& p) {
  return (qp < p.sq) & (kp < p.skv) & (!p.causal | (kp <= qp)) &
         ((p.window <= 0) | (kp > qp - p.window));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// dQ over 64 folded rows r = qp * G + g of one (batch, KV head), walking
// the key tiles the rows can see (as the forward), 32 keys a tile:
//   S = Q K^T, P = exp(S / sqrt(D) - lse), dP = dO V^T,
//   dS = P (dP - Delta), dQ += dS K;   dQ / sqrt(D) stored at the end,
// Delta = sum_d dO O computed first for the block's rows and stored for
// the dK/dV kernel.  A thread holds 4 rows x 4 keys of S and dP and 4
// rows x D / 8 columns of dQ; dS goes through shared memory.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args p) {
  constexpr int kS = KD + kS_Pad;
  constexpr int kRows = 64;
  constexpr int kKeys = 32;
  constexpr int kDs = kKeys + 4;
  constexpr int kC = KD / 32;
  extern __shared__ __align__(16) float bw_smem[];
  float* q_s = bw_smem;                         // [kRows][kS]
  float* do_s = q_s + kRows * kS;               // [kRows][kS]
  float* k_s = do_s + kRows * kS;               // [kKeys][kS]
  float* v_s = k_s + kKeys * kS;                // [kKeys][kS]
  float* lse_s = v_s + kKeys * kS;
  float* dl_s = lse_s + kRows;
  float* ds_s = dl_s + kRows;                   // [kRows][kDs]

  const T* q = static_cast<const T*>(p.q);
  const T* out = static_cast<const T*>(p.out);
  const T* dout = static_cast<const T*>(p.dout);
  const int d = p.d, sq = p.sq, skv = p.skv;
  const int g = p.h / p.kvh;
  const int n_rows = sq * g;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // latest first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long head0 = static_cast<long long>(b) * p.h + hk * g;
  const long long kv0 = (static_cast<long long>(b) * p.kvh + hk) * skv * d;
  const T* kb = static_cast<const T*>(p.k) + kv0;
  const T* vb = static_cast<const T*>(p.v) + kv0;
  auto row_of = [&](int rr) { return (head0 + rr % g) * sq + rr / g; };

  const int q_lo = r0 / g;
  const int q_hi = (min(r0 + kRows, n_rows) - 1) / g;
  const int k_end = p.causal ? min(skv, q_hi + 1) : skv;
  const int k_beg = p.window > 0 ? max(0, q_lo - p.window + 1) : 0;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kKeys - 1) / kKeys
                                    : 0;

  cc::load_rows<T, KD, kRows>(
      q_s,
      [&](int r) -> const T* {
        return r0 + r < n_rows ? q + row_of(r0 + r) * d : nullptr;
      },
      d, p.vec, q);
  cc::load_rows<T, KD, kRows>(
      do_s,
      [&](int r) -> const T* {
        const int rr = r0 + r;
        return rr < n_rows ? dout + b * p.do_sb + (hk * g + rr % g) * p.do_sh +
                                 (rr / g) * p.do_ss
                           : nullptr;
      },
      d, p.vec, q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // Delta and the log-sum-exp of each row, a warp a row at a time
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int rr = r0 + r;
    float acc = 0.f;
    if (rr < n_rows) {
      const T* orow = out + row_of(rr) * d;
      for (int i = lane; i < d; i += 32)
        acc = fmaf(do_s[r * kS + i], cc::to_f(orow[i]), acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      dl_s[r] = acc;
      lse_s[r] = rr < n_rows ? p.lse[row_of(rr)] : 0.f;
      if (rr < n_rows) p.delta[row_of(rr)] = acc;
    }
  }
  auto load_kv = [&](int k0) {
    auto key = [&](const T* base) {
      return [=](int n) -> const T* {
        return k0 + n < skv ? base + static_cast<long long>(k0 + n) * d
                            : nullptr;
      };
    };
    cc::load_rows<T, KD, kKeys>(k_s, key(kb), d, p.vec, q);
    cc::load_rows<T, KD, kKeys>(v_s, key(vb), d, p.vec, q);
    cp_async_commit();
    cp_async_wait<0>();
  };

  const int rg = tid >> 3;             // rows 4 rg ..
  const int cg = tid & 7;              // keys cg + 8 j, columns 4 cg + 32 c
  const int d4 = (d + 3) & ~3;
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = (r0 + rg * 4 + i) / g;
  float acc[4][kC][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_beg + t * kKeys;
    __syncthreads();
    load_kv(k0);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 2
    for (int c = 0; c < d4; c += 4) {
      float4 qv[4], ov[4], kx[4], vx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(q_s + (rg * 4 + i) * kS + c);
        ov[i] = *reinterpret_cast<const float4*>(do_s + (rg * 4 + i) * kS + c);
        kx[i] = *reinterpret_cast<const float4*>(k_s + (cg + 8 * i) * kS + c);
        vx[i] = *reinterpret_cast<const float4*>(v_s + (cg + 8 * i) * kS + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qv[i], kx[j], s[i][j]);
          dp[i][j] = dot4(ov[i], vx[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 8 * j;
        // masked: 0, selected (P of a row that sees no key is 0 here)
        ds_s[r * kDs + cg + 8 * j] =
            seen(qp[i], kp, p)
                ? expf(s[i][j] * p.scale - lse_s[r]) * (dp[i][j] - dl_s[r])
                : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int n = 0; n < kKeys; n += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(ds_s + (rg * 4 + i) * kDs
                                                  + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float4 kv4 = *reinterpret_cast<const float4*>(
              k_s + (n + nn) * kS + cg * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = comp(dsv[i], nn);
            acc[i][c][0] = fmaf(w, kv4.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(w, kv4.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(w, kv4.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(w, kv4.w, acc[i][c][3]);
          }
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + rg * 4 + i;
    if (rr >= n_rows) continue;
    T* dst = static_cast<T*>(p.dq) + row_of(rr) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 32 * c + e;
        if (col < d) cc::store(dst + col, acc[i][c][e] * p.scale);
      }
  }
}

// dK and dV over 32 keys of one (batch, KV head), walking the folded query
// rows of all G heads that can see them, 32 a tile (so the sums over the
// group stay in registers):
//   S^T = K Q^T, P^T = exp(S^T / sqrt(D) - lse), dP^T = V dO^T,
//   dS^T = P^T (dP^T - Delta), dV += P^T dO, dK += dS^T Q;
// dK / sqrt(D) stored at the end.  A row that sees no key at all (a
// window, Sq past Skv + window - 1) has the uniform weights 1 / Skv of the
// -1e30 fill: its dO / Skv is added to every key's dV.  A thread holds 2
// keys x 4 rows of S^T and dP^T and 2 keys x D / 8 columns of dK and dV;
// P^T and dS^T go through shared memory.
template <typename T, int KD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args p) {
  constexpr int kS = KD + kS_Pad;
  constexpr int kKeys = 32;
  constexpr int kRows = 32;
  constexpr int kPs = kRows + 4;
  constexpr int kC = KD / 32;
  extern __shared__ __align__(16) float bw_smem[];
  float* k_s = bw_smem;                         // [kKeys][kS]
  float* v_s = k_s + kKeys * kS;                // [kKeys][kS]
  float* q_s = v_s + kKeys * kS;                // [kRows][kS]
  float* do_s = q_s + kRows * kS;               // [kRows][kS]
  float* lse_s = do_s + kRows * kS;
  float* dl_s = lse_s + kRows;
  float* dosum = dl_s + kRows;                  // [KD]
  float* p_s = dosum + KD;                      // [kKeys][kPs]
  float* ds_s = p_s + kKeys * kPs;              // [kKeys][kPs]

  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const int d = p.d, sq = p.sq, skv = p.skv;
  const int g = p.h / p.kvh;
  const int n_rows = sq * g;
  const int kb0 = blockIdx.x * kKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long head0 = static_cast<long long>(b) * p.h + hk * g;
  const long long kv0 = (static_cast<long long>(b) * p.kvh + hk) * skv * d;
  const T* kb = static_cast<const T*>(p.k) + kv0;
  const T* vb = static_cast<const T*>(p.v) + kv0;
  auto row_of = [&](int rr) { return (head0 + rr % g) * sq + rr / g; };
  auto do_row = [&](int qp, int gg) {
    return dout + b * p.do_sb + (hk * g + gg) * p.do_sh + qp * p.do_ss;
  };

  // the folded rows that can see a key of the block
  const int kb1 = min(kb0 + kKeys, skv);
  const int q_first = p.causal ? kb0 : 0;
  const int q_last = p.window > 0 ? min(sq - 1, kb1 - 1 + p.window - 1)
                                  : sq - 1;
  const int row_lo = q_first * g;
  const int row_hi = q_first <= q_last ? (q_last + 1) * g : row_lo;
  const int n_tiles = (row_hi - row_lo + kRows - 1) / kRows;
  const int masked_lo = p.window > 0 ? skv + p.window - 1 : sq;

  auto key = [&](const T* base) {
    return [=](int n) -> const T* {
      return kb0 + n < skv ? base + static_cast<long long>(kb0 + n) * d
                           : nullptr;
    };
  };
  cc::load_rows<T, KD, kKeys>(k_s, key(kb), d, p.vec, q);
  cc::load_rows<T, KD, kKeys>(v_s, key(vb), d, p.vec, q);
  cp_async_commit();
  for (int c = tid; c < KD; c += kThreads) {
    float acc = 0.f;
    if (c < d)
      for (int qp = masked_lo; qp < sq; ++qp)
        for (int gg = 0; gg < g; ++gg) acc += cc::to_f(do_row(qp, gg)[c]);
    dosum[c] = acc / static_cast<float>(skv);
  }
  auto load_rows = [&](int rt0) {
    cc::load_rows<T, KD, kRows>(
        q_s,
        [&](int r) -> const T* {
          const int rr = rt0 + r;
          return rr < n_rows ? q + row_of(rr) * d : nullptr;
        },
        d, p.vec, q);
    cc::load_rows<T, KD, kRows>(
        do_s,
        [&](int r) -> const T* {
          const int rr = rt0 + r;
          return rr < n_rows ? do_row(rr / g, rr % g) : nullptr;
        },
        d, p.vec, q);
    for (int r = tid; r < kRows; r += kThreads) {
      const int rr = rt0 + r;
      const bool ok = rr < n_rows;
      lse_s[r] = ok ? p.lse[row_of(rr)] : 0.f;
      dl_s[r] = ok ? p.delta[row_of(rr)] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
  };

  const int rg = tid >> 3;             // keys 2 rg, 2 rg + 1
  const int cg = tid & 7;              // rows cg + 8 j, columns 4 cg + 32 c
  const int d4 = (d + 3) & ~3;
  float dk[2][kC][4] = {}, dv[2][kC][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int rt0 = row_lo + t * kRows;
    __syncthreads();
    load_rows(rt0);
    __syncthreads();
    float st[2][4] = {}, dpt[2][4] = {};
#pragma unroll 2
    for (int c = 0; c < d4; c += 4) {
      float4 kx[2], vx[2], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kx[i] = *reinterpret_cast<const float4*>(k_s + (2 * rg + i) * kS + c);
        vx[i] = *reinterpret_cast<const float4*>(v_s + (2 * rg + i) * kS + c);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(q_s + (cg + 8 * j) * kS + c);
        ov[j] = *reinterpret_cast<const float4*>(do_s + (cg + 8 * j) * kS + c);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = dot4(kx[i], qv[j], st[i][j]);
          dpt[i][j] = dot4(vx[i], ov[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kl = 2 * rg + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = cg + 8 * j;
        const bool vis = seen((rt0 + r) / g, kb0 + kl, p);
        const float pr = vis ? expf(st[i][j] * p.scale - lse_s[r]) : 0.f;
        p_s[kl * kPs + r] = pr;
        ds_s[kl * kPs + r] = vis ? pr * (dpt[i][j] - dl_s[r]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kRows; r += 4) {
      float4 pv[2], dsv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(p_s + (2 * rg + i) * kPs + r);
        dsv[i] = *reinterpret_cast<const float4*>(ds_s + (2 * rg + i) * kPs
                                                  + r);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int col = cg * 4 + 32 * c;
          const float4 ov4 = *reinterpret_cast<const float4*>(
              do_s + (r + rr) * kS + col);
          const float4 qv4 = *reinterpret_cast<const float4*>(
              q_s + (r + rr) * kS + col);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float pw = comp(pv[i], rr), dw = comp(dsv[i], rr);
            dv[i][c][0] = fmaf(pw, ov4.x, dv[i][c][0]);
            dv[i][c][1] = fmaf(pw, ov4.y, dv[i][c][1]);
            dv[i][c][2] = fmaf(pw, ov4.z, dv[i][c][2]);
            dv[i][c][3] = fmaf(pw, ov4.w, dv[i][c][3]);
            dk[i][c][0] = fmaf(dw, qv4.x, dk[i][c][0]);
            dk[i][c][1] = fmaf(dw, qv4.y, dk[i][c][1]);
            dk[i][c][2] = fmaf(dw, qv4.z, dk[i][c][2]);
            dk[i][c][3] = fmaf(dw, qv4.w, dk[i][c][3]);
          }
        }
    }
  }
  __syncthreads();                     // dosum is in place
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kb0 + 2 * rg + i;
    if (kp >= skv) continue;
    T* dkr = static_cast<T*>(p.dk) + kv0 + static_cast<long long>(kp) * d;
    T* dvr = static_cast<T*>(p.dv) + kv0 + static_cast<long long>(kp) * d;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cg * 4 + 32 * c + e;
        if (col >= d) continue;
        cc::store(dkr + col, dk[i][c][e] * p.scale);
        cc::store(dvr + col, dv[i][c][e] + dosum[col]);
      }
  }
}

template <typename T, int KD>
int launch(const Args& p, int b, cudaStream_t stream) {
  constexpr int kS = KD + kS_Pad;
  const size_t dq_smem =
      sizeof(float) * ((2 * 64 + 2 * 32) * kS + 2 * 64 + 64 * (32 + 4));
  const size_t kv_smem =
      sizeof(float) * ((2 * 32 + 2 * 32) * kS + 2 * 32 + KD +
                       2 * 32 * (32 + 4));
  auto dq_kern = flash_bwd_dq_kernel<T, KD>;
  auto kv_kern = flash_bwd_dkdv_kernel<T, KD>;
  cudaError_t err = cudaSuccess;
  if (dq_smem > 48 * 1024)
    err = cudaFuncSetAttribute(dq_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem));
  if (err == cudaSuccess && kv_smem > 48 * 1024)
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int g = p.h / p.kvh;
  dq_kern<<<dim3((p.sq * g + 63) / 64, p.kvh, b), kThreads, dq_smem,
            stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<dim3((p.skv + 31) / 32, p.kvh, b), kThreads, kv_smem, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& p, int b, cudaStream_t s) {
  if (p.d <= 32) return launch<T, 32>(p, b, s);
  if (p.d <= 64) return launch<T, 64>(p, b, s);
  if (p.d <= 128) return launch<T, 128>(p, b, s);
  return launch<T, 256>(p, b, s);
}

}  // namespace bw

// ---------------------------------------------------------------------
// backward, bf16 on the tensor cores (wgmma, fed by TMA through mbarrier
// rings)
// ---------------------------------------------------------------------
namespace hb {

using bf16 = __nv_bfloat16;
using wg::commit;
using wg::desc;
using wg::fence;
using wg::kBlock;
using wg::mma_rs;
using wg::mma_ss;
using wg::mma_ss_first;
using wg::pin;

// A kernel's shape: kWG consumer warpgroups of 64 rows each and a producer
// warpgroup, whose first thread issues every copy (issued from a consumer
// warp, the copies stall that warpgroup's products; PERF.md section 6); it
// hands its registers to the consumers (setmaxnreg: at launch 65,536 /
// kThreads each).  The ring's stages: as many as shared
// memory holds, up to 8, so a tile's copy is issued several tiles ahead of
// its products.  dQ takes three consumer warpgroups at D 64, two at D 128;
// dK/dV two, for its accumulators.
template <int KD, bool kDq>
struct Cfg {
  static constexpr int kWG = kDq && KD <= 64 ? 3 : 2;
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kProducerRegs = kWG == 3 ? 24 : 40;
  static constexpr int kConsumerRegs = kWG == 3 ? 160 : 232;
  static constexpr int kStages = KD <= 64 ? 8 : 4;
};
constexpr int kRows = 64;                  // rows of a tile: one m64
constexpr float kLog2e = 1.4426950408889634f;

// q, dout, k and v as TMA tensor maps (built by the launcher): bf16 4-d
// (D, positions, heads, batch), dout (D, heads, positions, batch) when its
// head stride is the smaller (Args::do_hfirst); a box is 64 columns of 64
// positions of one head, landing as a [64][64] block with the 128-byte
// swizzle, zeros past every end.
struct Maps {
  CUtensorMap q, dout, k, v;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait for the completion of the barrier's phase of this parity; a wait
// past kWatchdog clocks (seconds: a lost arrival, never a slow copy) traps,
// so the launch fails with an error instead of hanging the card.
constexpr long long kWatchdog = 1ll << 34;
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > kWatchdog) __trap();
  } while (!done);
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// one TMA box at coordinates (c0, c1, c2, c3), completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// 64 rows (positions row ..) of head `hd` of batch `b`: KD / 64 boxes
template <int KD>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          int row, int hd, int b,
                                          int hfirst, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < KD / 64; ++cb) {
    if (hfirst)
      tma_load(dst + cb * kBlock, map, cb * 64, hd, row, b, bar);
    else
      tma_load(dst + cb * kBlock, map, cb * 64, row, hd, b, bar);
  }
}
// The producer warpgroup gives up registers, the consumers take them: a
// whole warpgroup executes each, before any divergence.
template <int N>
__device__ __forceinline__ void set_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}
// waits until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Whether some of query positions q0 .. q0 + 63 sees some of keys k0 ..
// k0 + 63, and whether each of them sees each of those
__device__ __forceinline__ bool any_seen(int q0, int k0, const bw::Args& p) {
  const int q1 = min(q0 + kRows, p.sq) - 1;
  const int k1 = min(k0 + kRows, p.skv) - 1;
  return q0 <= q1 && k0 <= k1 && (!p.causal || k0 <= q1) &&
         (p.window <= 0 || k1 > q0 - p.window);
}
__device__ __forceinline__ bool all_seen(int q0, int k0, const bw::Args& p) {
  return q0 + kRows <= p.sq && k0 + kRows <= p.skv &&
         (!p.causal || k0 + kRows - 1 <= q0) &&
         (p.window <= 0 || k0 > q0 + kRows - 1 - p.window);
}

// A fragment of k-step kk from 8 values of a row pair (the accumulator's
// n-tiles 2 kk and 2 kk + 1, as the forward hands P to P.V)
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&x)[8]) {
  a[0] = wg::pack_bf16(x[0], x[1]);
  a[1] = wg::pack_bf16(x[2], x[3]);
  a[2] = wg::pack_bf16(x[4], x[5]);
  a[3] = wg::pack_bf16(x[6], x[7]);
}
// keeps A fragments in their registers until the products that read them
// have been waited for
__device__ __forceinline__ void keep(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4])::"memory");
}

// The first 1,024-byte boundary in dynamic shared memory, as an offset from
// the array, so the compiler still sees shared-memory accesses through it
__device__ __forceinline__ unsigned char* align1024(unsigned char* base) {
  return base + ((1024u - (smem_addr(base) & 1023u)) & 1023u);
}

// The elementwise work of a tile, P and then dS.  A thread holds two rows
// of the accumulators (hf = 0, 1: the rows 8 apart) and, of each, the
// columns 8 j + 2 tig, + 1 (element 4 j + 2 hf + c).  Every exponential is
// taken and the mask selects (no branch); kMasked: a tile that cuts the
// rows' masks, masked entries exactly 0.

// dQ: P = 2^(s log2(e) / sqrt(D) - lse2), in place (rows qp, qp + 8;
// keys k0 ..)
template <bool kMasked>
__device__ __forceinline__ void dq_p(float (&sa)[32], const float (&l2)[2],
                                     float scale_log2, int qp, int k0,
                                     int tig, const bw::Args& p) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hf = (i >> 1) & 1;
    const float x = wg::ex2(fmaf(sa[i], scale_log2, -l2[hf]));
    sa[i] = kMasked && !bw::seen(qp + 8 * hf,
                                  k0 + 8 * (i >> 2) + 2 * tig + (i & 1), p)
                ? 0.f
                : x;
  }
}
// dQ: dS = P (dp - Delta), rounded to bf16 as the A fragments of dS K's 4
// key steps (n-tiles 2 kk and 2 kk + 1, as the forward hands P to P.V)
template <bool kMasked>
__device__ __forceinline__ void dq_ds(uint32_t (&a)[4][4],
                                      const float (&pr)[32],
                                      const float (&dp)[32],
                                      const float (&dl)[2], int qp, int k0,
                                      int tig, const bw::Args& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      const int hf = (e >> 1) & 1;
      x[e] = pr[i] * (dp[i] - dl[hf]);
      if (kMasked)
        x[e] = bw::seen(qp + 8 * hf, k0 + 8 * (i >> 2) + 2 * tig + (i & 1),
                         p)
                   ? x[e]
                   : 0.f;
    }
    to_a(a[kk], x);
  }
}
// dK/dV: P^T = 2^(s^T log2(e) / sqrt(D) - lse2), in place, and as the A
// fragments of P^T dO (keys kp, kp + 8; query positions q0 ..; the tile's
// lse2 in shared memory)
template <bool kMasked>
__device__ __forceinline__ void dkdv_p(uint32_t (&ap)[4][4],
                                       float (&st)[32], const float* lse2,
                                       float scale_log2, int q0, int kp,
                                       int tig, const bw::Args& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      const int r = 8 * (i >> 2) + 2 * tig + (i & 1);
      x[e] = wg::ex2(fmaf(st[i], scale_log2, -lse2[r]));
      if (kMasked)
        x[e] = bw::seen(q0 + r, kp + 8 * ((e >> 1) & 1), p) ? x[e] : 0.f;
      st[i] = x[e];
    }
    to_a(ap[kk], x);
  }
}
// dK/dV: dS^T = P^T (dp^T - Delta) as the A fragments of dS^T Q
template <bool kMasked>
__device__ __forceinline__ void dkdv_ds(uint32_t (&ad)[4][4],
                                        const float (&pr)[32],
                                        const float (&dpt)[32],
                                        const float* dl, int q0, int kp,
                                        int tig, const bw::Args& p) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      const int r = 8 * (i >> 2) + 2 * tig + (i & 1);
      y[e] = pr[i] * (dpt[i] - dl[r]);
      if (kMasked)
        y[e] = bw::seen(q0 + r, kp + 8 * ((e >> 1) & 1), p) ? y[e] : 0.f;
    }
    to_a(ad[kk], y);
  }
}

// dQ over 64 query positions of one head a consumer warpgroup, walking the
// 64-key tiles they can see:
//   S = Q K^T, P = 2^(S log2(e) / sqrt(D) - lse log2(e)), dP = dO V^T,
//   dS = P (dP - Delta), dQ += dS K;  dQ / sqrt(D) stored at the end.
// First each warp computes Delta = sum_d dO O of its 16 rows and stores it,
// with lse in log2 units, into the [B, H, sq_pad] scratch the dK/dV kernel
// reads (positions past Sq: 0).  Q and dO arrive once; K and V through the
// ring.  S and dP: one group of wgmma with both operands in shared memory,
// K-major; dQ += dS K with dS from registers (bf16) and K read MN-major.
template <int KD>
__global__ void __launch_bounds__(Cfg<KD, true>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ Maps m, const bw::Args p) {
  using C = Cfg<KD, true>;
  constexpr int kWG = C::kWG;
  constexpr int kStages = C::kStages;
  constexpr int kCB = KD / 64;
  constexpr int kTile = kRows * KD;
  extern __shared__ __align__(128) unsigned char hb_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(align1024(hb_smem));
  bf16* do_s = q_s + kWG * kTile;               // [kWG][kTile]
  bf16* ring = do_s + kWG * kTile;              // [kStages][K, V][kTile]
  float* lse_s = reinterpret_cast<float*>(ring + kStages * 2 * kTile);
  float* dl_s = lse_s + kWG * kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + kWG * kRows);
  const uint32_t qo_bar = smem_addr(bars);
  auto full = [&](int s) { return qo_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return qo_bar + 8 * (1 + kStages + s); };

  const int g = p.h / p.kvh;
  const int n_pt = (p.sq + kWG * kRows - 1) / (kWG * kRows);
  const int heads = gridDim.x / n_pt;           // B * H
  const int pt = n_pt - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;  // latest first
  const int b = bh / p.h;
  const int hq = bh - b * p.h;
  const int hk = hq / g;
  const int qp0 = pt * kWG * kRows;
  const int q_hi = min(qp0 + kWG * kRows, p.sq) - 1;
  const int k_end = p.causal ? min(p.skv, q_hi + 1) : p.skv;
  const int k_beg = p.window > 0 ? max(0, qp0 - p.window + 1) : 0;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kRows - 1) / kRows
                                    : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qo_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::kConsumers) {          // the producer's first thread
    set_regs_dec<C::kProducerRegs>();
    if (tid != C::kConsumers) return;
    mbar_expect_tx(qo_bar, 2 * kWG * kTile * 2);
    for (int w = 0; w < kWG; ++w) {
      load_tile<KD>(q_s + w * kTile, &m.q, qp0 + w * kRows, hq, b, 0, qo_bar);
      load_tile<KD>(do_s + w * kTile, &m.dout, qp0 + w * kRows, hq, b,
                    p.do_hfirst, qo_bar);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
      const int k0 = k_beg + t * kRows;
      bf16* ks = ring + s * 2 * kTile;
      mbar_expect_tx(full(s), 2 * kTile * 2);
      load_tile<KD>(ks, &m.k, k0, hk, b, 0, full(s));
      load_tile<KD>(ks + kTile, &m.v, k0, hk, b, 0, full(s));
    }
    return;
  }

  set_regs_inc<C::kConsumerRegs>();
  const int w = tid >> 7;              // consumer warpgroup
  const int warp = (tid >> 5) & 3;     // its warp: rows 16 warp ..
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int qw0 = qp0 + w * kRows;
  const float scale_log2 = p.scale * kLog2e;
  const long long row0 = (static_cast<long long>(b) * p.h + hq) * p.sq;
  const long long pad0 = (static_cast<long long>(b) * p.h + hq) * p.sq_pad;
  const bf16* out = static_cast<const bf16*>(p.out);
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb +
                     hq * p.do_sh;

  // Delta and the log-sum-exp of the warp's 16 rows: two lanes a row,
  // each half of D in 16-byte loads, all issued before the sums
  {
    const int r = 16 * warp + (lane >> 1);
    const int qp = qw0 + r;
    const int c0 = (lane & 1) * (KD / 2);
    float acc = 0.f;
    if (qp < p.sq) {
      const bf16* orow = out + (row0 + qp) * p.d;
      const bf16* drow = dout + qp * p.do_ss;
      uint4 ov[KD / 16], dv[KD / 16];
#pragma unroll
      for (int j = 0; j < KD / 16; ++j) {
        const int c = c0 + 8 * j;
        const bool in = c < p.d;
        ov[j] = in ? *reinterpret_cast<const uint4*>(orow + c)
                   : make_uint4(0, 0, 0, 0);
        dv[j] = in ? *reinterpret_cast<const uint4*>(drow + c)
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < KD / 16; ++j) {
        const __nv_bfloat162* o2 =
            reinterpret_cast<const __nv_bfloat162*>(&ov[j]);
        const __nv_bfloat162* d2 =
            reinterpret_cast<const __nv_bfloat162*>(&dv[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(o2[e]);
          const float2 y = __bfloat1622float2(d2[e]);
          acc = fmaf(y.x, x.x, acc);
          acc = fmaf(y.y, x.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0) {
      const float l = qp < p.sq ? p.lse[row0 + qp] * kLog2e : 0.f;
      dl_s[w * kRows + r] = acc;
      lse_s[w * kRows + r] = l;
      if (qp < p.sq_pad) {
        p.delta[pad0 + qp] = acc;
        p.lse2[pad0 + qp] = l;
      }
    }
  }
  __syncwarp();
  const int ra = 16 * warp + gid;      // rows ra and ra + 8
  const float l2[2] = {lse_s[w * kRows + ra], lse_s[w * kRows + ra + 8]};
  const float dl[2] = {dl_s[w * kRows + ra], dl_s[w * kRows + ra + 8]};

  const bf16* qs = q_s + w * kTile;
  const bf16* dos = do_s + w * kTile;
  float dq[kCB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) dq[cb][i] = 0.f;
  mbar_wait(qo_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = k_beg + t * kRows;
    mbar_wait(full(s), (t / kStages) & 1);
    if (any_seen(qw0, k0, p)) {        // warpgroup-uniform
      const bf16* ks = ring + s * 2 * kTile;
      const bf16* vs = ks + kTile;
      // S = Q K^T and dP = dO V^T: KD / 16 k-steps each, 32 bytes apart in
      // a 128-byte row, the next column block 8 KB on
      float sa[32], dp[32];
      fence();
      mma_ss_first(sa, desc(qs, 16, 1024), desc(ks, 16, 1024));
#pragma unroll
      for (int kc = 1; kc < KD / 16; ++kc) {
        const int off = (kc >> 2) * kBlock + (kc & 3) * 16;
        mma_ss(sa, desc(qs + off, 16, 1024), desc(ks + off, 16, 1024), 1);
      }
      mma_ss_first(dp, desc(dos, 16, 1024), desc(vs, 16, 1024));
#pragma unroll
      for (int kc = 1; kc < KD / 16; ++kc) {
        const int off = (kc >> 2) * kBlock + (kc & 3) * 16;
        mma_ss(dp, desc(dos + off, 16, 1024), desc(vs + off, 16, 1024), 1);
      }
      commit();
      wait_groups<0>();
      pin(sa);
      pin(dp);
      // dS, rounded to bf16 as the A fragments of dS K's 4 key steps
      uint32_t a[4][4];
      if (all_seen(qw0, k0, p)) {      // warpgroup-uniform
        dq_p<false>(sa, l2, scale_log2, qw0 + ra, k0, tig, p);
        dq_ds<false>(a, sa, dp, dl, qw0 + ra, k0, tig, p);
      } else {
        dq_p<true>(sa, l2, scale_log2, qw0 + ra, k0, tig, p);
        dq_ds<true>(a, sa, dp, dl, qw0 + ra, k0, tig, p);
      }
      // dQ += dS K: per 64-column block of D, 4 key steps of 16 rows
      fence();
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) {
        pin(dq[cb]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs(dq[cb], a[kk],
                 desc(ks + cb * kBlock + kk * 16 * 64, 16, 1024));
      }
      commit();
      wait_groups<0>();
      keep(a);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) pin(dq[cb]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int qp = qw0 + ra + 8 * hf;
    if (qp >= p.sq) continue;
    bf16* dst = static_cast<bf16*>(p.dq) + (row0 + qp) * p.d;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * tig;
        if (col < p.d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(dq[cb][4 * j + 2 * hf] * p.scale,
                                    dq[cb][4 * j + 2 * hf + 1] * p.scale);
      }
  }
}

// dK and dV over 64 keys of one (batch, KV head) a consumer warpgroup (128
// a block), walking tiles of 64 positions of each of the G query heads
// that can see them, head after head (so the sums over the group stay in
// registers):
//   S^T = K Q^T, P^T = 2^(S^T log2(e) / sqrt(D) - lse log2(e)),
//   dP^T = V dO^T, dS^T = P^T (dP^T - Delta), dV += P^T dO, dK += dS^T Q;
// dK / sqrt(D) stored at the end.  K and V arrive once; Q, dO and the
// tile's lse and Delta through the ring.  S^T and dP^T: one group of wgmma
// with both operands in shared memory, K-major; dV and dK one group with
// P^T and dS^T from registers (bf16) and dO and Q read MN-major.  A row
// that sees no key at all (a window, Sq past Skv + window - 1) has the
// uniform weights 1 / Skv of the -1e30 fill: its dO / Skv is added to
// every key's dV.
template <int KD>
__global__ void __launch_bounds__(Cfg<KD, false>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ Maps m,
                            const bw::Args p) {
  using C = Cfg<KD, false>;
  constexpr int kWG = C::kWG;
  constexpr int kStages = C::kStages;
  constexpr int kCB = KD / 64;
  constexpr int kTile = kRows * KD;
  extern __shared__ __align__(128) unsigned char hb_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(align1024(hb_smem));
  bf16* v_s = k_s + kWG * kTile;                // [kWG][kTile]
  bf16* ring = v_s + kWG * kTile;               // [kStages][Q, dO][kTile]
  // [kStages][lse, Delta][kRows], then [KD]
  float* stats = reinterpret_cast<float*>(ring + kStages * 2 * kTile);
  float* dosum = stats + kStages * 2 * kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dosum + KD);
  const uint32_t kv_bar = smem_addr(bars);
  auto full = [&](int s) { return kv_bar + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_bar + 8 * (1 + kStages + s); };

  const int g = p.h / p.kvh;
  const int n_kb = (p.skv + kWG * kRows - 1) / (kWG * kRows);
  const int heads = gridDim.x / n_kb;           // B * KV
  const int kb = static_cast<int>(blockIdx.x) / heads;  // most rows first
  const int bk = static_cast<int>(blockIdx.x) % heads;
  const int b = bk / p.kvh;
  const int hk = bk - b * p.kvh;
  const int kb0 = kb * kWG * kRows;

  // the positions that can see a key of the block, in 64-position tiles
  const int kb1 = min(kb0 + kWG * kRows, p.skv);
  const int q_first = p.causal ? kb0 : 0;
  const int q_last = p.window > 0 ? min(p.sq - 1, kb1 - 1 + p.window - 1)
                                  : p.sq - 1;
  const int qt_lo = q_first / kRows;
  const int n_qt = q_first <= q_last ? q_last / kRows - qt_lo + 1 : 0;
  const int n_tiles = g * n_qt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::kConsumers) {          // the producer's first thread
    set_regs_dec<C::kProducerRegs>();
    if (tid != C::kConsumers) return;
    mbar_expect_tx(kv_bar, 2 * kWG * kTile * 2);
    for (int w = 0; w < kWG; ++w) {
      load_tile<KD>(k_s + w * kTile, &m.k, kb0 + w * kRows, hk, b, 0,
                    kv_bar);
      load_tile<KD>(v_s + w * kTile, &m.v, kb0 + w * kRows, hk, b, 0,
                    kv_bar);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
      const int gg = t / n_qt;
      const int qt0 = (qt_lo + t - gg * n_qt) * kRows;
      const int hq = hk * g + gg;
      bf16* qs = ring + s * 2 * kTile;
      const long long at = (static_cast<long long>(b) * p.h + hq) * p.sq_pad
                           + qt0;
      mbar_expect_tx(full(s), 2 * kTile * 2 + 2 * kRows * 4);
      load_tile<KD>(qs, &m.q, qt0, hq, b, 0, full(s));
      load_tile<KD>(qs + kTile, &m.dout, qt0, hq, b, p.do_hfirst, full(s));
      bulk_load(stats + s * 2 * kRows, p.lse2 + at, kRows * 4, full(s));
      bulk_load(stats + s * 2 * kRows + kRows, p.delta + at, kRows * 4,
                full(s));
    }
    return;
  }

  set_regs_inc<C::kConsumerRegs>();
  const int w = tid >> 7;              // consumer warpgroup: keys kw0 ..
  const int warp = (tid >> 5) & 3;     // its warp: keys kw0 + 16 warp ..
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int kw0 = kb0 + w * kRows;
  const float scale_log2 = p.scale * kLog2e;
  const long long kv0 =
      (static_cast<long long>(b) * p.kvh + hk) * p.skv * p.d;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.do_sb;

  // the rows that see no key: sum over them of dO / Skv
  const int masked_lo = p.window > 0 ? p.skv + p.window - 1 : p.sq;
  for (int c = tid; c < KD; c += C::kConsumers) {
    float acc = 0.f;
    if (c < p.d)
      for (int qp = masked_lo; qp < p.sq; ++qp)
        for (int gg = 0; gg < g; ++gg)
          acc += __bfloat162float(
              dout[(hk * g + gg) * p.do_sh + qp * p.do_ss + c]);
    dosum[c] = acc / static_cast<float>(p.skv);
  }

  const bf16* ks = k_s + w * kTile;
  const bf16* vs = v_s + w * kTile;
  float dk[kCB][32], dv[kCB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb) {
      dk[cb][i] = 0.f;
      dv[cb][i] = 0.f;
    }
  const int ka = 16 * warp + gid;      // keys kw0 + ka and kw0 + ka + 8
  mbar_wait(kv_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int gg = t / n_qt;
    const int qt0 = (qt_lo + t - gg * n_qt) * kRows;
    mbar_wait(full(s), (t / kStages) & 1);
    if (any_seen(qt0, kw0, p)) {       // warpgroup-uniform
      const bf16* qs = ring + s * 2 * kTile;
      const bf16* dos = qs + kTile;
      const float* lse2 = stats + s * 2 * kRows;
      const float* dl = lse2 + kRows;
      float st[32], dpt[32];
      fence();
      mma_ss_first(st, desc(ks, 16, 1024), desc(qs, 16, 1024));
#pragma unroll
      for (int kc = 1; kc < KD / 16; ++kc) {
        const int off = (kc >> 2) * kBlock + (kc & 3) * 16;
        mma_ss(st, desc(ks + off, 16, 1024), desc(qs + off, 16, 1024), 1);
      }
      mma_ss_first(dpt, desc(vs, 16, 1024), desc(dos, 16, 1024));
#pragma unroll
      for (int kc = 1; kc < KD / 16; ++kc) {
        const int off = (kc >> 2) * kBlock + (kc & 3) * 16;
        mma_ss(dpt, desc(vs + off, 16, 1024), desc(dos + off, 16, 1024), 1);
      }
      commit();
      wait_groups<0>();
      pin(st);
      pin(dpt);
      // P^T and dS^T, rounded to bf16 as the A fragments of the 4 row
      // steps of dV and dK
      uint32_t ap[4][4], ad[4][4];
      if (all_seen(qt0, kw0, p)) {     // warpgroup-uniform
        dkdv_p<false>(ap, st, lse2, scale_log2, qt0, kw0 + ka, tig, p);
        dkdv_ds<false>(ad, st, dpt, dl, qt0, kw0 + ka, tig, p);
      } else {
        dkdv_p<true>(ap, st, lse2, scale_log2, qt0, kw0 + ka, tig, p);
        dkdv_ds<true>(ad, st, dpt, dl, qt0, kw0 + ka, tig, p);
      }
      // dV += P^T dO and dK += dS^T Q: per 64-column block of D, 4 row
      // steps of 16 (2 KB on)
      fence();
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) {
        pin(dv[cb]);
        pin(dk[cb]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs(dv[cb], ap[kk],
                 desc(dos + cb * kBlock + kk * 16 * 64, 16, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs(dk[cb], ad[kk],
                 desc(qs + cb * kBlock + kk * 16 * 64, 16, 1024));
      }
      commit();
      wait_groups<0>();
      keep(ap);
      keep(ad);
#pragma unroll
      for (int cb = 0; cb < kCB; ++cb) {
        pin(dv[cb]);
        pin(dk[cb]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  consumers_sync<C::kConsumers>();     // dosum is in place
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = kw0 + ka + 8 * hf;
    if (kp >= p.skv) continue;
    bf16* dkr = static_cast<bf16*>(p.dk) + kv0 +
                static_cast<long long>(kp) * p.d;
    bf16* dvr = static_cast<bf16*>(p.dv) + kv0 +
                static_cast<long long>(kp) * p.d;
#pragma unroll
    for (int cb = 0; cb < kCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * tig;
        if (col >= p.d) continue;
        *reinterpret_cast<__nv_bfloat162*>(dkr + col) =
            __floats2bfloat162_rn(dk[cb][4 * j + 2 * hf] * p.scale,
                                  dk[cb][4 * j + 2 * hf + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
            __floats2bfloat162_rn(dv[cb][4 * j + 2 * hf] + dosum[col],
                                  dv[cb][4 * j + 2 * hf + 1] +
                                      dosum[col + 1]);
      }
  }
}

// cuTensorMapEncodeTiled from the driver the process already loaded
// (looked up once: the library links against the runtime only)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeFn>(
                                          dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// bf16 (d, n1, n2, n3) with element strides s1, s2, s3 (d's 1); a box of 64
// columns and b1 x b2 of dims 1 and 2
bool make_map(CUtensorMap* map, const void* base, int d, int n1, int n2,
              int n3, long long s1, long long s2, long long s3, int b1,
              int b2) {
  const EncodeFn encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2),
                              static_cast<cuuint64_t>(n3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1) * 2,
                                 static_cast<cuuint64_t>(s2) * 2,
                                 static_cast<cuuint64_t>(s3) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KD>
int launch(const bw::Args& p, int b, cudaStream_t stream) {
  constexpr int kTile = kRows * KD;
  using Q = Cfg<KD, true>;
  using K = Cfg<KD, false>;
  const size_t dq_smem =
      sizeof(bf16) * (2 * Q::kWG + 2 * Q::kStages) * kTile + 1024 +
      sizeof(float) * 2 * Q::kWG * kRows + 8 * (1 + 2 * Q::kStages);
  const size_t kv_smem =
      sizeof(bf16) * (2 * K::kWG + 2 * K::kStages) * kTile + 1024 +
      sizeof(float) * (2 * K::kStages * kRows + KD) +
      8 * (1 + 2 * K::kStages);
  auto dq_kern = flash_bwd_dq_wgmma_kernel<KD>;
  auto kv_kern = flash_bwd_dkdv_wgmma_kernel<KD>;
  // runtime calls first: they make the device's context current in this
  // thread (autograd runs a backward on a thread of its own), which the
  // driver's tensor-map encoder needs
  cudaError_t err = cudaFuncSetAttribute(
      dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kv_kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Maps m;
  const long long d = p.d;
  const bool ok =
      make_map(&m.q, p.q, p.d, p.sq, p.h, b, d, p.sq * d,
               static_cast<long long>(p.h) * p.sq * d, kRows, 1) &&
      make_map(&m.k, p.k, p.d, p.skv, p.kvh, b, d, p.skv * d,
               static_cast<long long>(p.kvh) * p.skv * d, kRows, 1) &&
      make_map(&m.v, p.v, p.d, p.skv, p.kvh, b, d, p.skv * d,
               static_cast<long long>(p.kvh) * p.skv * d, kRows, 1) &&
      (p.do_hfirst
           ? make_map(&m.dout, p.dout, p.d, p.h, p.sq, b, p.do_sh, p.do_ss,
                      p.do_sb, 1, kRows)
           : make_map(&m.dout, p.dout, p.d, p.sq, p.h, b, p.do_ss, p.do_sh,
                      p.do_sb, kRows, 1));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int n_pt = (p.sq + Q::kWG * kRows - 1) / (Q::kWG * kRows);
  const int n_kb = (p.skv + K::kWG * kRows - 1) / (K::kWG * kRows);
  dq_kern<<<n_pt * p.h * b, Q::kThreads, dq_smem, stream>>>(m, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kv_kern<<<n_kb * p.kvh * b, K::kThreads, kv_smem, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hb

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, k, v and out alike).  window <= 0 means no
// window.  lse: null, or fp32 [B, H, Sq] for each row's log-sum-exp of
// its scaled scores (the backward's input).  Needs H % KV == 0, 1 <= D <=
// 256 and Sq, Skv >= 1 (checked by the Python wrapper).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int dtype, int b, int h, int kvh, int sq,
                                   int skv, int d, int causal, int window,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    const int err = cc::dispatch<float>(q, k, v, out, l, b, h, kvh, sq, skv,
                                        d, causal, window, s);
    return err != 0 ? err
                    : cc::no_key_rows<float>(v, out, l, b, h, kvh, sq, skv,
                                             d, window, s);
  }
  const int err = cc::dispatch<__nv_bfloat16>(q, k, v, out, l, b, h, kvh,
                                              sq, skv, d, causal, window, s);
  return err != 0 ? err
                  : cc::no_key_rows<__nv_bfloat16>(v, out, l, b, h, kvh, sq,
                                                   skv, d, window, s);
}

// bf16 q, k, v and out on the tensor cores.  Needs H % KV == 0, D % 16 == 0,
// 16 <= D <= 256, Sq, Skv >= 1 and 16-byte aligned pointers (checked by the
// Python wrapper).  window <= 0 means no window; lse as above.
extern "C" int flash_attention_fwd_bf16_wgmma(const void* q, const void* k,
                                              const void* v, void* out,
                                              void* lse, int b, int h,
                                              int kvh, int sq, int skv,
                                              int d, int causal, int window,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int err =
      d <= 64 ? wg::launch<64>(q, k, v, out, l, b, h, kvh, sq, skv, d,
                               causal, window, s)
      : d <= 128 ? wg::launch<128>(q, k, v, out, l, b, h, kvh, sq, skv, d,
                                   causal, window, s)
                 : wg::launch<256>(q, k, v, out, l, b, h, kvh, sq, skv, d,
                                   causal, window, s);
  return err != 0 ? err
                  : cc::no_key_rows<__nv_bfloat16>(v, out, l, b, h, kvh, sq,
                                                   skv, d, window, s);
}

// The backward: dq [B, H, Sq, D], dk and dv [B, KV, Skv, D] in q's dtype
// from q, k, v, out (the forward's), dout (strides do_sb, do_sh, do_ss
// in elements, D's 1) and the forward's lse.  kind: 1 = bf16 on the tensor
// cores (D % 16 == 0, D <= 128, every pointer and row 16-byte aligned;
// scratch: fp32 [2, B, H, Sq rounded up to 64], Delta then lse in log2
// units), 0 = the CUDA cores (dtype 0 = fp32, 1 = bf16; D <= 256;
// scratch: fp32 [B, H, Sq], Delta).  Two launches on the stream: dQ
// (which writes the scratch), then dK and dV.  window <= 0 means no
// window.  The shapes are checked by the Python wrapper; a kind or D
// outside these, or a tensor map the driver refuses, is refused with
// cudaErrorInvalidValue before a launch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int kind, int dtype, int b, int h, int kvh, int sq, int skv,
    int d, int causal, int window, long long do_sb, long long do_sh,
    long long do_ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bw::Args p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(scratch);
  p.sq_pad = (sq + 63) / 64 * 64;
  p.lse2 = p.delta + static_cast<long long>(b) * h * p.sq_pad;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.h = h;
  p.kvh = kvh;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.do_sb = do_sb;
  p.do_sh = do_sh;
  p.do_ss = do_ss;
  p.do_hfirst = do_sh < do_ss;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(dout);
  p.vec = dtype == 0 && d % 4 == 0 && align % 16 == 0 && do_sb % 4 == 0 &&
          do_sh % 4 == 0 && do_ss % 4 == 0;
  if (d < 1 || d > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 1) {
    if (dtype != 1 || d % 16 != 0 || d > 128)
      return static_cast<int>(cudaErrorInvalidValue);
    if (d <= 64) return hb::launch<64>(p, b, s);
    return hb::launch<128>(p, b, s);
  }
  if (kind != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return bw::dispatch<float>(p, b, s);
  return bw::dispatch<__nv_bfloat16>(p, b, s);
}
