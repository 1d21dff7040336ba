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
// the context get weight exp(-1e30 - m) = 0 exactly; this kernel reads only
// positions up to min(lens[b], max_pages * page_size - 1) and gives the
// others weight 0, which gives the same sums.  lens[b] must be >= 0
// (position 0 is always valid) and every page index a block reads must lie
// in [0, P).
//
// What bounds it: bytes at small G, operations at large G.  A decode reads
// (ctx + 1) * D values of K and of V per KV head and does 4 * G flops per
// (K, V) pair of values: G / 2 flops a byte in fp32, G a byte in bf16,
// against the fp32 CUDA cores' ridge of ~20 (67 TFLOP/s over 3.35 TB/s).
// Qwen3-1.7B's G 2 is far below it; Granite-34B's MQA, 48 query heads on
// one KV head, is above it (24 flops a byte in fp32); a tensor-core path
// for such groups is later work.  To reach the memory rate the reads must
// come from many SMs with many loads in flight.  The TPU kernel grids over
// (batch, kv head, page slot) with the online softmax carried across the
// sequential page axis in VMEM; here blocks run in parallel, so the
// context is split instead (flash decoding):
//
// - The grid is (split, kv head x group chunk, batch).  A split is a run
//   of whole pages, at least 64 positions (the wrapper's split_plan); one
//   Qwen3-1.7B request of ~1,180 positions is 19 splits x 8 heads = 152
//   blocks.  The grid is sized from max_pages * page_size, which the host
//   knows: lens stays on the card and nothing synchronises.
// - A block holds at most kGroupChunk = 16 query rows of its KV head in
//   registers, so a group of G > 16 is cut into ceil(G / 16) chunks, chunk
//   c taking rows [16 c, min(16 c + 16, G)); each chunk reads its KV
//   head's pages itself (Granite's 48:1: three reads of one small stream,
//   the later ones mostly from L2).  G <= 16 is one chunk: the grid and
//   the code path of a kernel without chunks.  The TPU kernel takes the
//   whole group in one (1, 1, G, D) block of VMEM.
// - In a block of 4 warps, warp w takes P consecutive positions at a time
//   (w * P, then + 4 P).  A lane holds E = ceil(D / 32) columns of the
//   chunk's query rows in registers and loads its E columns of the P K
//   rows and P V rows at once (one 16-byte load a lane for an fp32 row of
//   D 128: one warp-wide load a row), so 2 P rows are in flight per warp.
//   A row's score of a position is a warp shuffle sum; the running max,
//   sum and the lane's E columns of the [rows, D] accumulator stay in
//   registers.
//   Each block reads its own block-table entries.
// - The 4 warps' (m, l, acc) are merged once in shared memory and the
//   block writes its split's partial (m, l, acc[rows, D]) to fp32 scratch,
//   each chunk's [splits][rows] partials after its first query row's.  A
//   split wholly past lens[b] writes m = NEG_INF, l = 0, acc = 0.
// - One launch: after a __threadfence, each block adds one to its (b,
//   head, chunk)'s arrival counter; the block that arrives last rescales
//   every split's partial by exp(m - max m), sums them and writes the
//   output, then resets the counter to 0.  An empty split weighs exactly
//   0.  The counters (int32 [B * KV * chunks], zero) belong to the
//   wrapper, which makes them once per device; launches that share them
//   must run on one stream.
//
// q, K and V may be fp32 or bf16; all arithmetic is fp32.  The launcher
// allocates nothing and does not synchronise; it launches on the caller's
// stream and returns cudaGetLastError().

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kGroupChunk = 16;   // query rows of one KV head a block holds

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int BYTES> struct Vec;
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<16> { using type = uint4; };

// The lane's E columns [i0, i0 + E) of one row, as fp32.  vec: the row is
// 32 * E values long and E * sizeof(T)-byte aligned, so a lane's columns
// come in loads of up to 16 bytes; otherwise one value at a time, columns
// past d read as 0.
template <typename T, int E>
__device__ __forceinline__ void load_lane(const T* __restrict__ row, int i0,
                                          int d, bool vec, float (&x)[E]) {
  if (vec) {
    constexpr int kBytes = E * sizeof(T) < 16 ? E * sizeof(T) : 16;
    constexpr int kLoads = E * sizeof(T) / kBytes;
    using V = typename Vec<kBytes>::type;
    alignas(16) T buf[E];
    const V* src = reinterpret_cast<const V*>(row + i0);
#pragma unroll
    for (int c = 0; c < kLoads; ++c)
      reinterpret_cast<V*>(buf)[c] = __ldg(src + c);
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = to_f(buf[j]);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      x[j] = i0 + j < d ? to_f(row[i0 + j]) : 0.f;
  }
}

// E: columns a lane holds (D <= 32 E); GM: the most query rows a block
// holds (min(G, kGroupChunk) <= GM); P: positions a warp loads at once.
// Block (sp, hc, b) takes split sp of KV head hc / chunks for the rows of
// chunk hc % chunks.
template <typename T, int E, int GM, int P>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ lens, int kvh, int g,
                    int chunks, int d, int page_size, int max_pages,
                    int split, int n_splits, int vec, float scale,
                    float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ counters,
                    T* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ int is_last;

  const int sp = blockIdx.x;
  const int h = blockIdx.y / chunks;
  const int c = blockIdx.y - h * chunks;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = lane * E;
  const int rows = min(kGroupChunk, g - c * kGroupChunk);   // <= GM
  const int gd = rows * d;
  const long long bh = static_cast<long long>(b) * kvh + h;
  const long long unit = bh * chunks + c;           // its arrival counter
  const long long row0 = bh * g + c * kGroupChunk;  // its first query row

  // this lane's columns of the chunk's query rows, scaled by 1 / sqrt(D)
  float qr[GM][E];
#pragma unroll
  for (int r = 0; r < GM; ++r) {
    if (r < rows) {
      load_lane<T, E>(q + (row0 + r) * d, i0, d, vec, qr[r]);
#pragma unroll
      for (int j = 0; j < E; ++j) qr[r][j] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) qr[r][j] = 0.f;
    }
  }

  const long long cap = static_cast<long long>(max_pages) * page_size;
  const int last = static_cast<int>(min(static_cast<long long>(lens[b]),
                                        cap - 1));
  const int p_beg = sp * split;
  const int p_end = min(p_beg + split, last + 1);   // <= p_beg: empty
  const int32_t* table = tables + static_cast<long long>(b) * max_pages;

  float m[GM], l[GM], acc[GM][E];
#pragma unroll
  for (int r = 0; r < GM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) acc[r][j] = 0.f;
  }

  for (int p0 = p_beg + warp * P; p0 < p_end; p0 += kWarps * P) {
    float kx[P][E], vx[P][E];
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int pos = p0 + t;
      if (pos < p_end) {
        const long long row =
            (static_cast<long long>(table[pos / page_size]) * page_size +
             pos % page_size) * kvh + h;
        load_lane<T, E>(k_pages + row * d, i0, d, vec, kx[t]);
        load_lane<T, E>(v_pages + row * d, i0, d, vec, vx[t]);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) kx[t][j] = vx[t][j] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < GM; ++r) {
      if (r >= rows) continue;
      float s[P];
      float mx = kNegInf;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) part += qr[r][j] * kx[t][j];
        s[t] = warp_sum(part);
        if (p0 + t < p_end) mx = fmaxf(mx, s[t]);
      }
      // p0 < p_end, so mx is a real score and alpha wipes the initial
      // NEG_INF state to exactly 0
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int j = 0; j < E; ++j) acc[r][j] *= alpha;
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const float p = p0 + t < p_end ? expf(s[t] - m_new) : 0.f;
        l[r] += p;
#pragma unroll
        for (int j = 0; j < E; ++j) acc[r][j] += p * vx[t][j];
      }
    }
  }

  // merge the warps: shared [kWarps][rows][d] acc, then [kWarps][rows] m
  // and l
  float* w_acc = smem;
  float* w_m = w_acc + kWarps * gd;
  float* w_l = w_m + kWarps * rows;
#pragma unroll
  for (int r = 0; r < GM; ++r) {
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (i0 + j < d) w_acc[(warp * rows + r) * d + i0 + j] = acc[r][j];
    if (lane == 0) {
      w_m[warp * rows + r] = m[r];
      w_l[warp * rows + r] = l[r];
    }
  }
  __syncthreads();
  // the chunk's partials, [n_splits][rows][d] and [n_splits][rows][2],
  // start at its first query row's: row0 * n_splits rows of scratch
  float* c_acc = part_acc + row0 * n_splits * d;
  float* c_ml = part_ml + row0 * n_splits * 2;
  for (int e = tid; e < gd; e += kThreads) {
    const int r = e / d;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * rows + r]);
    float a = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp with no position has l = 0 and acc = 0
      const float wt = expf(w_m[w * rows + r] - mx);
      a += wt * w_acc[w * gd + e];
      sum += wt * w_l[w * rows + r];
    }
    c_acc[static_cast<long long>(sp) * gd + e] = a;
    if (e - r * d == 0) {
      c_ml[(sp * rows + r) * 2] = mx;
      c_ml[(sp * rows + r) * 2 + 1] = sum;
    }
  }

  // the last block of (b, head, chunk) to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + unit, 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* c_w = smem;                       // [n_splits][rows] split weights
  float* c_l = c_w + n_splits * rows;      // [rows] total sums
  // warp w takes rows w, w + 4, ...: the splits' max and total sum are
  // warp reductions, each split's weight goes to shared memory
  for (int r = warp; r < rows; r += kWarps) {
    float mx = kNegInf;
    for (int s = lane; s < n_splits; s += 32)
      mx = fmaxf(mx, __ldcg(c_ml + (s * rows + r) * 2));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      // split 0 holds position 0, so mx is real and an empty split's
      // weight is exp(-1e30 - mx) = 0
      const float wt = expf(__ldcg(c_ml + (s * rows + r) * 2) - mx);
      c_w[s * rows + r] = wt;
      sum += wt * __ldcg(c_ml + (s * rows + r) * 2 + 1);
    }
    sum = warp_sum(sum);
    if (lane == 0) c_l[r] = sum;
  }
  __syncthreads();
  for (int e = tid; e < gd; e += kThreads) {
    const int r = e / d;
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s)
      a += c_w[s * rows + r] *
           __ldcg(c_acc + static_cast<long long>(s) * gd + e);
    store(out + row0 * d + e, a / c_l[r]);
  }
  if (tid == 0) counters[unit] = 0;
}

template <typename T, int E, int GM>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lens, void* out, float* scratch, int* counters, int b,
           int h, int kvh, int d, int page_size, int max_pages, int split,
           int n_splits, cudaStream_t stream) {
  constexpr int P = GM * E >= 32 ? 4 : 8;
  const int g = h / kvh;
  const int chunks = (g + kGroupChunk - 1) / kGroupChunk;
  const int rows = g < kGroupChunk ? g : kGroupChunk;   // a block's most
  const size_t warp_floats = static_cast<size_t>(kWarps) * rows * (d + 2);
  const size_t combine_floats = static_cast<size_t>(n_splits) * rows + rows;
  const size_t smem = sizeof(float) * (warp_floats > combine_floats
                                           ? warp_floats : combine_floats);
  auto kern = paged_decode_kernel<T, E, GM, P>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const int vec = d == 32 * E && align % 16 == 0;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  float* part_acc = scratch;
  float* part_ml = scratch + static_cast<size_t>(b) * kvh * n_splits * g * d;
  kern<<<dim3(n_splits, kvh * chunks, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lens), kvh, g, chunks, d, page_size,
      max_pages, split, n_splits, vec, scale, part_acc, part_ml, counters,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E>
int dispatch_g(const void* q, const void* k, const void* v,
               const void* tables, const void* lens, void* out,
               float* scratch, int* counters, int b, int h, int kvh, int d,
               int page_size, int max_pages, int split, int n_splits,
               cudaStream_t s) {
  const int g = h / kvh;
  if (g <= 2)
    return launch<T, E, 2>(q, k, v, tables, lens, out, scratch, counters, b,
                           h, kvh, d, page_size, max_pages, split, n_splits,
                           s);
  if (g <= 4)
    return launch<T, E, 4>(q, k, v, tables, lens, out, scratch, counters, b,
                           h, kvh, d, page_size, max_pages, split, n_splits,
                           s);
  if (g <= 8)
    return launch<T, E, 8>(q, k, v, tables, lens, out, scratch, counters, b,
                           h, kvh, d, page_size, max_pages, split, n_splits,
                           s);
  // G > 16 too, in chunks of kGroupChunk rows
  return launch<T, E, kGroupChunk>(q, k, v, tables, lens, out, scratch,
                                   counters, b, h, kvh, d, page_size,
                                   max_pages, split, n_splits, s);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* tables,
             const void* lens, void* out, float* scratch, int* counters,
             int b, int h, int kvh, int d, int page_size, int max_pages,
             int split, int n_splits, cudaStream_t s) {
  if (d <= 64)
    return dispatch_g<T, 2>(q, k, v, tables, lens, out, scratch, counters, b,
                            h, kvh, d, page_size, max_pages, split, n_splits,
                            s);
  if (d <= 128)
    return dispatch_g<T, 4>(q, k, v, tables, lens, out, scratch, counters, b,
                            h, kvh, d, page_size, max_pages, split, n_splits,
                            s);
  return dispatch_g<T, 8>(q, k, v, tables, lens, out, scratch, counters, b, h,
                          kvh, d, page_size, max_pages, split, n_splits, s);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (q, pages and out alike).  Needs H % KV == 0,
// KV * ceil(H / KV / 16) <= 65535, B <= 65535 and 1 <= D <= 256 (checked
// by the Python wrapper's supports).  split: positions a block takes (a
// multiple of page_size); n_splits: ceil(max_pages * page_size / split).
// scratch: fp32, B * H * n_splits * (D + 2) values; counters: int32
// [B * KV * ceil(H / KV / 16)], all 0 (and left so).
extern "C" int paged_attention_decode(const void* q, const void* k_pages,
                                      const void* v_pages, const void* tables,
                                      const void* lens, void* out,
                                      void* scratch, void* counters,
                                      int dtype, int b, int h, int kvh, int d,
                                      int page_size, int max_pages, int split,
                                      int n_splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  int* ct = static_cast<int*>(counters);
  if (dtype == 0)
    return dispatch<float>(q, k_pages, v_pages, tables, lens, out, sc, ct, b,
                           h, kvh, d, page_size, max_pages, split, n_splits,
                           s);
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, tables, lens, out, sc,
                                 ct, b, h, kvh, d, page_size, max_pages,
                                 split, n_splits, s);
}
