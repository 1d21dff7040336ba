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
// rerun gives the same bits:
//   flash_bwd_dq_kernel: 64 folded rows of a (batch, KV head), walking
//     the key tiles they can see, as the forward; it computes Delta for its
//     rows and stores it for the second kernel.
//   flash_bwd_dkdv_kernel: a block of keys of a (batch, KV head), walking
//     the folded rows of all G query heads that can see them, 32 a tile,
//     so the sums over the group stay in registers.
// Each comes in two variants, picked by the wrapper (bwd_variant): bf16
// on the tensor cores with mma.sync m16n8k16 and fp32 accumulators (D a
// multiple of 16 up to 128; tiles loaded with cp.async, fragments with
// ldmatrix, .trans for the products whose B is stored [k][n]; dS handed
// from the accumulators to the next product in registers), and fp32
// arithmetic on the CUDA cores for fp32 and every other bf16 call (the
// forward's register micro-tiles; no TF32).  Not yet done: wgmma, TMA, and
// overlapping a tile's loads with the previous tile's products.
//
// The launchers allocate nothing and do not synchronise; they launch on
// the caller's stream and return cudaGetLastError().

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// backward: dQ, then dK and dV
// ---------------------------------------------------------------------
namespace bw {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;       // [B, H, Sq], natural log
  float* delta;           // [B, H, Sq]: written by dQ, read by dK/dV
  void* dq;
  void* dk;
  void* dv;
  int h, kvh, sq, skv, d, causal, window, vec;
  long long do_sb, do_sh, do_ss;   // dout's strides, elements (D's is 1)
  float scale;                     // 1 / sqrt(D)
};

__device__ __forceinline__ bool seen(int qp, int kp, const Args& p) {
  return qp < p.sq && kp < p.skv && (!p.causal || kp <= qp) &&
         (p.window <= 0 || kp > qp - p.window);
}

// A variant's shared tiles: fp32 rows padded by 4 words on the CUDA cores,
// bf16 rows padded by 16 bytes on the tensor cores (ldmatrix's 8 row
// addresses then fall on distinct banks).
template <bool kMma>
struct Tile {
  using E = typename std::conditional<kMma, bf16, float>::type;
  static constexpr int kPad = kMma ? 8 : cc::kPad;   // elements a row
};

// ROWS rows into dst (row r from row_of(r), nullptr past the end: zeros;
// columns past d zero), landing by the next cp.async wait or, for the
// CUDA-core loads a value at a time, visible after the next barrier.
template <typename T, int KD, bool kMma, int ROWS, typename RowOf>
__device__ __forceinline__ void load(typename Tile<kMma>::E* dst,
                                     RowOf row_of, int d, int vec,
                                     const T* any) {
  if constexpr (kMma) {
    constexpr int kC = KD / 8;
    constexpr int kS = KD + Tile<kMma>::kPad;
    for (int e = threadIdx.x; e < ROWS * kC; e += kThreads) {
      const int r = e / kC;
      const int c = e - r * kC;
      const T* src = row_of(r);
      const bool ok = src != nullptr && c * 8 < d;
      cp_async16(dst + r * kS + c * 8, ok ? src + c * 8 : any, ok);
    }
  } else {
    cc::load_rows<T, KD, ROWS>(dst, row_of, d, vec, any);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// d += A . B, m16n8k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The A fragment of k-step kk from accumulators of n-tiles 2 kk, 2 kk + 1
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = wg::pack_bf16(lo[0], lo[1]);
  a[1] = wg::pack_bf16(lo[2], lo[3]);
  a[2] = wg::pack_bf16(hi[0], hi[1]);
  a[3] = wg::pack_bf16(hi[2], hi[3]);
}
// ldmatrix row offsets in a [rows][kS] tile: an A fragment (16 x 16 at
// row r0, column c0), a pair of B fragments from [n][k] storage (n 16 at
// r0, k 16 at c0), a pair of B fragments from [k][n] storage (k 16 at r0,
// n 16 at c0; loaded transposed)
__device__ __forceinline__ int a_off(int kS, int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * kS + c0 + ((lane >> 4) << 3);
}
__device__ __forceinline__ int bn_off(int kS, int r0, int c0, int lane) {
  return (r0 + (lane & 7) + ((lane >> 4) << 3)) * kS + c0 +
         (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bk_off(int kS, int r0, int c0, int lane) {
  return (r0 + (lane & 15)) * kS + c0 + ((lane >> 4) << 3);
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
// the key tiles the rows can see (as the forward):
//   S = Q K^T, P = exp(S / sqrt(D) - lse), dP = dO V^T,
//   dS = P (dP - Delta), dQ += dS K;   dQ / sqrt(D) stored at the end,
// Delta = sum_d dO O computed first for the block's rows and stored for
// the dK/dV kernel.  kMma: bf16 on the tensor cores (mma.sync m16n8k16,
// 64-key tiles, warp w the rows 16 w ..; dS handed from the accumulators
// to the next product in registers); else fp32 on the CUDA cores (32-key
// tiles, a thread 4 rows x 4 keys of S and dP and 4 rows x D / 8 columns
// of dQ, dS through shared memory).
template <typename T, int KD, bool kMma>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args p) {
  using E = typename Tile<kMma>::E;
  constexpr int kS = KD + Tile<kMma>::kPad;
  constexpr int kRows = 64;
  constexpr int kKeys = kMma ? 64 : 32;
  constexpr int kDs = kKeys + 4;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  E* q_s = reinterpret_cast<E*>(bw_smem);       // [kRows][kS]
  E* do_s = q_s + kRows * kS;                   // [kRows][kS]
  E* k_s = do_s + kRows * kS;                   // [kKeys][kS]
  E* v_s = k_s + kKeys * kS;                    // [kKeys][kS]
  float* lse_s = reinterpret_cast<float*>(v_s + kKeys * kS);
  float* dl_s = lse_s + kRows;
  float* ds_s = dl_s + kRows;                   // CUDA cores: [kRows][kDs]

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

  load<T, KD, kMma, kRows>(
      q_s,
      [&](int r) -> const T* {
        return r0 + r < n_rows ? q + row_of(r0 + r) * d : nullptr;
      },
      d, p.vec, q);
  load<T, KD, kMma, kRows>(
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
  // Delta and the log-sum-exp of each row (log2 units for ex2), a warp a
  // row at a time
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int rr = r0 + r;
    float acc = 0.f;
    if (rr < n_rows) {
      const T* orow = out + row_of(rr) * d;
      for (int i = lane; i < d; i += 32)
        acc = fmaf(cc::to_f(do_s[r * kS + i]), cc::to_f(orow[i]), acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      dl_s[r] = acc;
      const float l = rr < n_rows ? p.lse[row_of(rr)] : 0.f;
      lse_s[r] = kMma ? l * kLog2e : l;
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
    load<T, KD, kMma, kKeys>(k_s, key(kb), d, p.vec, q);
    load<T, KD, kMma, kKeys>(v_s, key(vb), d, p.vec, q);
    cp_async_commit();
    cp_async_wait<0>();
  };

  if constexpr (kMma) {
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    const int ra = warp * 16 + gid;             // rows ra and ra + 8
    const int qp[2] = {(r0 + ra) / g, (r0 + ra + 8) / g};
    float acc[KD / 8][4] = {};
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = k_beg + t * kKeys;
      __syncthreads();                 // the last tile's reads are done
      load_kv(k0);
      __syncthreads();
      float s[kKeys / 8][4] = {}, dp[kKeys / 8][4] = {};
#pragma unroll
      for (int kc = 0; kc < KD / 16; ++kc) {
        uint32_t aq[4], ao[4];
        const int ao_ = a_off(kS, warp * 16, kc * 16, lane);
        ldsm_x4(aq, q_s + ao_);
        ldsm_x4(ao, do_s + ao_);
#pragma unroll
        for (int np = 0; np < kKeys / 16; ++np) {
          uint32_t bk[4], bv[4];
          const int bo_ = bn_off(kS, np * 16, kc * 16, lane);
          ldsm_x4(bk, k_s + bo_);
          ldsm_x4(bv, v_s + bo_);
          mma16816(s[2 * np], aq, bk[0], bk[1]);
          mma16816(s[2 * np + 1], aq, bk[2], bk[3]);
          mma16816(dp[2 * np], ao, bv[0], bv[1]);
          mma16816(dp[2 * np + 1], ao, bv[2], bv[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          const int r = ra + 8 * hf;
          const int kp = k0 + nt * 8 + 2 * tig + (e & 1);
          // masked: 0, selected (Delta of a row that sees no key is
          // whatever the forward wrote there, and P is 0)
          s[nt][e] = seen(qp[hf], kp, p)
                         ? wg::ex2(fmaf(s[nt][e], scale_log2, -lse_s[r])) *
                               (dp[nt][e] - dl_s[r])
                         : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < KD / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4_t(bk, k_s + bk_off(kS, kk * 16, np * 16, lane));
          mma16816(acc[2 * np], a, bk[0], bk[1]);
          mma16816(acc[2 * np + 1], a, bk[2], bk[3]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = r0 + ra + 8 * hf;
      if (rr >= n_rows) continue;
      bf16* dst = static_cast<bf16*>(p.dq) + row_of(rr) * d;
#pragma unroll
      for (int nt = 0; nt < KD / 8; ++nt) {
        const int col = nt * 8 + 2 * tig;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[nt][2 * hf] * p.scale,
                                    acc[nt][2 * hf + 1] * p.scale);
      }
    }
  } else {
    constexpr int kC = KD / 32;
    const int rg = tid >> 3;           // rows 4 rg ..
    const int cg = tid & 7;            // keys cg + 8 j, columns 4 cg + 32 c
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
}

// dK and dV over a block of keys of one (batch, KV head), walking the
// folded query rows of all G heads that can see them, 32 a tile (so the
// sums over the group stay in registers):
//   S^T = K Q^T, P^T = exp(S^T / sqrt(D) - lse), dP^T = V dO^T,
//   dS^T = P^T (dP^T - Delta), dV += P^T dO, dK += dS^T Q;
// dK / sqrt(D) stored at the end.  A row that sees no key at all (a
// window, Sq past Skv + window - 1) has the uniform weights 1 / Skv of the
// -1e30 fill: its dO / Skv is added to every key's dV.  kMma: 64 keys, warp
// w the keys 16 w ..; else 32 keys, a thread 2 keys x 4 rows of S^T and
// dP^T and 2 keys x D / 8 columns of dK and dV, P^T and dS^T through shared
// memory.
template <typename T, int KD, bool kMma>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args p) {
  using E = typename Tile<kMma>::E;
  constexpr int kS = KD + Tile<kMma>::kPad;
  constexpr int kKeys = kMma ? 64 : 32;
  constexpr int kRows = 32;
  constexpr int kPs = kRows + 4;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  E* k_s = reinterpret_cast<E*>(bw_smem);       // [kKeys][kS]
  E* v_s = k_s + kKeys * kS;                    // [kKeys][kS]
  E* q_s = v_s + kKeys * kS;                    // [kRows][kS]
  E* do_s = q_s + kRows * kS;                   // [kRows][kS]
  float* lse_s = reinterpret_cast<float*>(do_s + kRows * kS);
  float* dl_s = lse_s + kRows;
  float* dosum = dl_s + kRows;                  // [KD]
  float* p_s = dosum + KD;                      // CUDA cores: [kKeys][kPs]
  float* ds_s = p_s + kKeys * kPs;              // CUDA cores: [kKeys][kPs]

  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const int d = p.d, sq = p.sq, skv = p.skv;
  const int g = p.h / p.kvh;
  const int n_rows = sq * g;
  const int kb0 = blockIdx.x * kKeys;
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
  load<T, KD, kMma, kKeys>(k_s, key(kb), d, p.vec, q);
  load<T, KD, kMma, kKeys>(v_s, key(vb), d, p.vec, q);
  cp_async_commit();
  for (int c = tid; c < KD; c += kThreads) {
    float acc = 0.f;
    if (c < d)
      for (int qp = masked_lo; qp < sq; ++qp)
        for (int gg = 0; gg < g; ++gg) acc += cc::to_f(do_row(qp, gg)[c]);
    dosum[c] = acc / static_cast<float>(skv);
  }
  auto load_rows = [&](int rt0) {
    load<T, KD, kMma, kRows>(
        q_s,
        [&](int r) -> const T* {
          const int rr = rt0 + r;
          return rr < n_rows ? q + row_of(rr) * d : nullptr;
        },
        d, p.vec, q);
    load<T, KD, kMma, kRows>(
        do_s,
        [&](int r) -> const T* {
          const int rr = rt0 + r;
          return rr < n_rows ? do_row(rr / g, rr % g) : nullptr;
        },
        d, p.vec, q);
    for (int r = tid; r < kRows; r += kThreads) {
      const int rr = rt0 + r;
      const bool ok = rr < n_rows;
      const float l = ok ? p.lse[row_of(rr)] : 0.f;
      lse_s[r] = kMma ? l * kLog2e : l;
      dl_s[r] = ok ? p.delta[row_of(rr)] : 0.f;
    }
    cp_async_commit();
    cp_async_wait<0>();
  };

  if constexpr (kMma) {
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    const int ka = warp * 16 + gid;             // keys ka and ka + 8
    float dk[KD / 8][4] = {}, dv[KD / 8][4] = {};
    for (int t = 0; t < n_tiles; ++t) {
      const int rt0 = row_lo + t * kRows;
      __syncthreads();                 // the last tile's reads are done
      load_rows(rt0);
      __syncthreads();
      float st[kRows / 8][4] = {}, dpt[kRows / 8][4] = {};
#pragma unroll
      for (int kc = 0; kc < KD / 16; ++kc) {
        uint32_t ak[4], av[4];
        const int ao_ = a_off(kS, warp * 16, kc * 16, lane);
        ldsm_x4(ak, k_s + ao_);
        ldsm_x4(av, v_s + ao_);
#pragma unroll
        for (int np = 0; np < kRows / 16; ++np) {
          uint32_t bq[4], bo[4];
          const int bo_ = bn_off(kS, np * 16, kc * 16, lane);
          ldsm_x4(bq, q_s + bo_);
          ldsm_x4(bo, do_s + bo_);
          mma16816(st[2 * np], ak, bq[0], bq[1]);
          mma16816(st[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(dpt[2 * np], av, bo[0], bo[1]);
          mma16816(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kb0 + ka + 8 * (e >> 1);
          const int r = nt * 8 + 2 * tig + (e & 1);
          const bool vis = seen((rt0 + r) / g, kp, p);
          const float pr =
              vis ? wg::ex2(fmaf(st[nt][e], scale_log2, -lse_s[r])) : 0.f;
          st[nt][e] = pr;
          dpt[nt][e] = vis ? pr * (dpt[nt][e] - dl_s[r]) : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        uint32_t ap[4], ad[4];
        acc_to_a(ap, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(ad, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < KD / 16; ++np) {
          uint32_t bo[4], bq[4];
          const int bo_ = bk_off(kS, kk * 16, np * 16, lane);
          ldsm_x4_t(bo, do_s + bo_);
          ldsm_x4_t(bq, q_s + bo_);
          mma16816(dv[2 * np], ap, bo[0], bo[1]);
          mma16816(dv[2 * np + 1], ap, bo[2], bo[3]);
          mma16816(dk[2 * np], ad, bq[0], bq[1]);
          mma16816(dk[2 * np + 1], ad, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                   // dosum is in place
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kp = kb0 + ka + 8 * hf;
      if (kp >= skv) continue;
      bf16* dkr = static_cast<bf16*>(p.dk) + kv0 + static_cast<long long>(kp) * d;
      bf16* dvr = static_cast<bf16*>(p.dv) + kv0 + static_cast<long long>(kp) * d;
#pragma unroll
      for (int nt = 0; nt < KD / 8; ++nt) {
        const int col = nt * 8 + 2 * tig;
        if (col >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(dkr + col) =
            __floats2bfloat162_rn(dk[nt][2 * hf] * p.scale,
                                  dk[nt][2 * hf + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
            __floats2bfloat162_rn(dv[nt][2 * hf] + dosum[col],
                                  dv[nt][2 * hf + 1] + dosum[col + 1]);
      }
    }
  } else {
    constexpr int kC = KD / 32;
    const int rg = tid >> 3;           // keys 2 rg, 2 rg + 1
    const int cg = tid & 7;            // rows cg + 8 j, columns 4 cg + 32 c
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
    __syncthreads();                   // dosum is in place
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
}

template <typename T, int KD, bool kMma>
int launch(const Args& p, int b, cudaStream_t stream) {
  using E = typename Tile<kMma>::E;
  constexpr int kS = KD + Tile<kMma>::kPad;
  constexpr int kQKeys = kMma ? 64 : 32;        // dQ: 64 rows a block
  constexpr int kKKeys = kMma ? 64 : 32;        // dK/dV: 32 rows a tile
  const size_t dq_smem =
      sizeof(E) * (2 * 64 + 2 * kQKeys) * kS +
      sizeof(float) * (2 * 64 + (kMma ? 0 : 64 * (kQKeys + 4)));
  const size_t kv_smem =
      sizeof(E) * (2 * kKKeys + 2 * 32) * kS +
      sizeof(float) * (2 * 32 + KD + (kMma ? 0 : 2 * kKKeys * (32 + 4)));
  auto dq_kern = flash_bwd_dq_kernel<T, KD, kMma>;
  auto kv_kern = flash_bwd_dkdv_kernel<T, KD, kMma>;
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
  kv_kern<<<dim3((p.skv + kKKeys - 1) / kKKeys, p.kvh, b), kThreads, kv_smem,
            stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_simt(const Args& p, int b, cudaStream_t s) {
  if (p.d <= 32) return launch<T, 32, false>(p, b, s);
  if (p.d <= 64) return launch<T, 64, false>(p, b, s);
  if (p.d <= 128) return launch<T, 128, false>(p, b, s);
  return launch<T, 256, false>(p, b, s);
}

}  // namespace bw

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
  if (dtype == 0)
    return cc::dispatch<float>(q, k, v, out, l, b, h, kvh, sq, skv, d,
                               causal, window, s);
  return cc::dispatch<__nv_bfloat16>(q, k, v, out, l, b, h, kvh, sq, skv, d,
                                     causal, window, s);
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
  if (d <= 64)
    return wg::launch<64>(q, k, v, out, l, b, h, kvh, sq, skv, d, causal,
                          window, s);
  if (d <= 128)
    return wg::launch<128>(q, k, v, out, l, b, h, kvh, sq, skv, d, causal,
                           window, s);
  return wg::launch<256>(q, k, v, out, l, b, h, kvh, sq, skv, d, causal,
                         window, s);
}

// The backward: dq [B, H, Sq, D], dk and dv [B, KV, Skv, D] in q's dtype
// from q, k, v, out (the forward's), dout (strides do_sb, do_sh, do_ss
// in elements, D's 1) and the forward's lse; delta: fp32 [B, H, Sq]
// scratch.  kind: 1 = bf16 on the tensor cores (D % 16 == 0, D <= 128,
// every row 16-byte aligned), 0 = the CUDA cores (dtype 0 = fp32, 1 =
// bf16; D <= 256).  Two launches on the stream: dQ (which writes delta),
// then dK and dV.  window <= 0 means no window.  The shapes are checked by
// the Python wrapper; a kind or D outside these is refused with
// cudaErrorInvalidValue before a launch.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
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
  p.delta = static_cast<float*>(delta);
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
    if (d <= 64) return bw::launch<__nv_bfloat16, 64, true>(p, b, s);
    return bw::launch<__nv_bfloat16, 128, true>(p, b, s);
  }
  if (kind != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return bw::dispatch_simt<float>(p, b, s);
  return bw::dispatch_simt<__nv_bfloat16>(p, b, s);
}
