// Mamba-1 selective scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two Pallas TPU kernels
//   src/repro/kernels/selective_scan/selective_scan.py (_scan_kernel,
//     wrapper selective_scan): reads a precomputed bx = dt * B * x;
//   src/repro/kernels/selective_scan/fused.py (_fused_kernel, wrapper
//     selective_scan_fused): forms bx = (dt * x) * B itself;
// both computing, in fp32, with h_0 = 0,
//
//   h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n] + bx_t[d, n]
//   y_t[d]    = sum_n h_t[d, n] * c_t[n]
//
//   dt, x, y  [B, T, di]      bx [B, T, di, N]
//   B, C      [B, T, N]       A  [di, N]
//
// The TPU kernels grid over (batch, di blocks, T chunks) with the chunks
// sequential and the [block_d, N] state carried in VMEM scratch, and they
// assert di % block_d == 0 and T % chunk == 0.  Here nothing carries
// between blocks, so a block owns a set of channels (b, d) for the whole
// sequence and keeps their states in registers, looping over T in chunks.
// Steps past T and channels past di are masked in the kernel, so any T
// and any di work; N <= 16.
//
// The fused kernel (every Mamba layer of a model prefill).  What bounds
// it: each (t, d, n) needs one exponential, and the special-function
// units return 16 a clock per SM, which at Falcon-Mamba-7B's and
// Hymba-1.5B's prefill shapes takes slightly longer than moving the 12
// bytes a (t, d) of dt, x and y; every other operation must hide behind
// those two.  The design, step by step:
//   1. Fast exponent: A is multiplied by log2(e) once, when a thread
//      loads it into registers, and every decay is one FMA and one
//      ex2.approx.ftz (a single MUFU.EX2; the accurate expf is a range
//      reduction around it).  The FMA adds 1 to the argument, for
//      accuracy (see the kernel), at no cost.
//   2. No reduction in the step loop: a channel's 16 states sit on
//      `lanes` neighbouring lanes (2 or 4; 16 / lanes states each).
//      Each lane keeps its partial sums of `lanes` consecutive steps, and
//      one butterfly (lanes - 1 shuffles) leaves lane l with the whole
//      sum of step l, which it stores: no per-step shuffle, add or
//      predicated shared store.
//   3. Loads overlap the scan: dt, x (for the block's channels), B and C
//      (for all of them) of chunk k + 1 (32 steps) are copied into a
//      second shared-memory buffer with cp.async, 16 bytes a copy where
//      the shapes allow, while chunk k is scanned; one barrier a chunk.
//      Past-T steps are zero-filled (dt = 0: decay 1, bx 0), so every
//      chunk runs whole.
//   4. Warps at narrow widths: the wrapper picks `lanes` from B * di and
//      the card's SM count (fused.py:plan): 2 where the channels give
//      every SM's four schedulers a warp, else 4 (twice the warps).  At
//      Hymba-1.5B's di 3,200 two lanes still beat four, and one lane a
//      channel (16 states a thread) lost at both model shapes (measured
//      on an H100, PERF.md), so the kernel is built for 2 and 4.
// What it leaves: the exponentials themselves (only splitting them
// between the special-function units and a polynomial on the FMA pipe
// goes under that floor), and whatever keeps it from issuing one
// exponential every clock a scheduler (see PERF.md).
//
// v1 (no model path calls it, as in the reference).  What bounds it:
// it reads the N-fold bx, so a (t, d) moves 4 * (N + 2) bytes of dt, bx
// and y, 72 at N 16, against 16 exponentials; the special-function
// units' time for those is under a fifth of the bytes' at both model
// shapes.  So it is bound by bytes, and what it must do is keep enough
// of bx in flight.  The design:
//   1. A ring of `stages` stages in dynamic shared memory, each holding
//      dt, bx and C of 4 steps for the block's channels.  In the bulk
//      route (N 16, di % 4 == 0, dt, bx and C 16-byte aligned) thread 0
//      fills a stage with cp.async.bulk copies that complete on the
//      stage's `full` mbarrier: a step's bx for the block's channels is
//      one contiguous run of channels x 64 bytes, its dt one run, and
//      the stage's C one run.  While one stage is scanned the others are
//      in flight; each warp arrives on the stage's `empty` mbarrier when
//      it is done with it, and thread 0 refills a stage once every warp
//      has left it (the stage of the chunk before the current one, so
//      it rarely waits).
//   2. A balanced grid: the wrapper picks the channels a block (a
//      multiple of 8, so whole warps, up to 256) from B * di and the
//      card's SM count (selective_scan.py:plan), so that the busiest SM
//      carries the fewest channels, and the stages from the shared
//      memory an SM's blocks leave (at most 8).  At Hymba-1.5B's 12,800
//      channels that is 124 blocks of 104 channels with 8 stages, at
//      Falcon-Mamba-7B's 32,768 it is 128 blocks of 256 with 3: one
//      block an SM, the busiest SM 7% and 3% above the mean.
//   3. No reduction in the step loop: 4 lanes a channel, 4 states each;
//      a stage's 4 steps leave 4 partial sums a lane, and one butterfly
//      (reduce_scatter) leaves lane l with the whole y of step l.  Steps
//      past T in the last stage, and channels past di, are scanned on
//      whatever the stage holds and never stored: no other step or
//      channel reads them.
//   4. The accurate expf, as the plain version: it hides behind the
//      bytes.
// The scalar route (N < 16, di % 4 != 0, or an input not 16-byte
// aligned) runs the same ring, filled by every thread with 4-byte
// cp.async copies that arrive on the `full` mbarrier as they land; the
// ring is zeroed once, so states past N read 0 from bx and C.
//
// The launchers allocate nothing and do not synchronise; they launch on
// the caller's stream and return cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;                      // states a channel holds

// ------------------------------------------------------------- fused --
constexpr int kFusedThreads = 128;
constexpr int kFusedChunk = 32;                // steps a shared buffer holds
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 2^e for -126 <= e <= 127, exactly
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((127 + e) << 23);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (0 or the whole size) and zero-fill the rest; with 0 bytes
// nothing is read (the address is still a valid one).
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Sum each of the kL steps' partials over the kL lanes of a channel: lane
// l returns the whole sum of step l (kL - 1 shuffles, no more adds).
template <int kL>
__device__ __forceinline__ float reduce_scatter(const float (&p)[kL],
                                                int lane) {
  if constexpr (kL == 2) {
    const bool lo = lane & 1;
    return (lo ? p[1] : p[0]) +
           __shfl_xor_sync(0xffffffffu, lo ? p[0] : p[1], 1);
  } else {
    static_assert(kL == 4, "2 or 4 lanes a channel");
    const bool hi = lane & 2, lo = lane & 1;
    const float k0 = (hi ? p[2] : p[0]) +
                     __shfl_xor_sync(0xffffffffu, hi ? p[0] : p[2], 2);
    const float k1 = (hi ? p[3] : p[1]) +
                     __shfl_xor_sync(0xffffffffu, hi ? p[1] : p[3], 2);
    return (lo ? k1 : k0) + __shfl_xor_sync(0xffffffffu, lo ? k0 : k1, 1);
  }
}

// One block: kCh = 128 / kL channels d0 .. of batch row b, each over kL
// lanes of kS = 16 / kL states.  kVec: di % 4 == 0, N == 16 and every
// input 16-byte aligned, so dt, x, B and C are copied 16 bytes at a time.
//
// The decay is 0.5 * ex2(dt * A log2(e) + 1): the unit's argument then
// lies in [0, 1) wherever the decay is near 1, as in expf's own range
// reduction.  ex2 of the small negative argument itself rounds such
// decays low on average where expf rounds them high (tools/scan_cost.py
// --probe), and over 2,048 steps of a state whose decay is within an ulp
// of 1 that bias alone took y past 1e-4 of the plain version (which uses
// expf) in chip_smoke.py's phase 9.  The 0.5 costs nothing:
// inside a chunk the kernel carries u = 2^(tt + 1) * h after step tt,
// u = E * u + dt x * (2^(tt + 1) B_tt) with E = 2 * decay, and sums
// u * (2^-(tt + 1) C_tt); B and C are scaled once, when a chunk lands,
// and u back by 2^-kK at its end.  Powers of two scale exactly (away
// from overflow and subnormals), so this is the arithmetic of
// h = fma(h, 0.5 E, dt x B) bit for bit.
template <int kL, bool kVec>
__global__ void __launch_bounds__(kFusedThreads)
    selective_scan_fused_kernel(const float* __restrict__ dt,
                                const float* __restrict__ x,
                                const float* __restrict__ bm,
                                const float* __restrict__ c,
                                const float* __restrict__ a,
                                float* __restrict__ y, int t_len, int di,
                                int n) {
  constexpr int kCh = kFusedThreads / kL;
  constexpr int kS = kMaxN / kL;
  constexpr int kK = kFusedChunk;
  static_assert(kK % kL == 0 && kS % 4 == 0 && kK < 64, "chunk, states");
  __shared__ __align__(16) float s_dt[2][kK][kCh];
  __shared__ __align__(16) float s_x[2][kK][kCh];
  __shared__ __align__(16) float s_b[2][kK][kMaxN];
  __shared__ __align__(16) float s_c[2][kK][kMaxN];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int ch = threadIdx.x / kL;
  const int lane = threadIdx.x % kL;
  const int d = d0 + ch;
  const bool live = d < di;
  const size_t row0 = static_cast<size_t>(b) * t_len;   // (b, t = 0)

  float a2[kS], u[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int s = lane * kS + j;
    a2[j] = (live && s < n) ? a[static_cast<size_t>(d) * n + s] * kLog2e
                            : 0.f;
    u[j] = 0.f;
  }

  // Chunk `k` into buffer `buf`, one commit group a thread; then, once it
  // has landed, `scale` multiplies the B and C values this same thread
  // copied by 2^(tt + 1) and 2^-(tt + 1).
  auto stage = [&](int k, int buf) {
    const int t0 = k * kK;
    if constexpr (kVec) {
      constexpr int kQ = kCh / 4;
      for (int i = threadIdx.x; i < kK * kQ; i += kFusedThreads) {
        const int tt = i / kQ, q = (i % kQ) * 4;
        const bool ok = t0 + tt < t_len && d0 + q < di;
        const size_t g = ok ? (row0 + t0 + tt) * di + d0 + q : 0;
        cp_async16(&s_dt[buf][tt][q], dt + g, ok ? 16 : 0);
        cp_async16(&s_x[buf][tt][q], x + g, ok ? 16 : 0);
      }
      for (int i = threadIdx.x; i < kK * 4; i += kFusedThreads) {
        const int tt = i / 4, q = (i % 4) * 4;
        const bool ok = t0 + tt < t_len;
        const size_t g = ok ? (row0 + t0 + tt) * kMaxN + q : 0;
        cp_async16(&s_b[buf][tt][q], bm + g, ok ? 16 : 0);
        cp_async16(&s_c[buf][tt][q], c + g, ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < kK * kCh; i += kFusedThreads) {
        const int tt = i / kCh, cc = i % kCh;
        const bool ok = t0 + tt < t_len && d0 + cc < di;
        const size_t g = ok ? (row0 + t0 + tt) * di + d0 + cc : 0;
        cp_async4(&s_dt[buf][tt][cc], dt + g, ok ? 4 : 0);
        cp_async4(&s_x[buf][tt][cc], x + g, ok ? 4 : 0);
      }
      for (int i = threadIdx.x; i < kK * kMaxN; i += kFusedThreads) {
        const int tt = i / kMaxN, s = i % kMaxN;
        const bool ok = t0 + tt < t_len && s < n;
        const size_t g = ok ? (row0 + t0 + tt) * n + s : 0;
        cp_async4(&s_b[buf][tt][s], bm + g, ok ? 4 : 0);
        cp_async4(&s_c[buf][tt][s], c + g, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  auto scale = [&](int buf) {
    cp_async_wait_all();
    constexpr int kPer = kVec ? 4 : 1;          // floats a copy
    for (int i = threadIdx.x; i < kK * kMaxN / kPer; i += kFusedThreads) {
      const int tt = i / (kMaxN / kPer), s = (i % (kMaxN / kPer)) * kPer;
      const float up = pow2(tt + 1), down = pow2(-tt - 1);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s_b[buf][tt][s + j] *= up;
        s_c[buf][tt][s + j] *= down;
      }
    }
  };

  const int chunks = (t_len + kK - 1) / kK;
  stage(0, 0);
  scale(0);
  for (int k = 0; k < chunks; ++k) {
    const int buf = k & 1;
    // chunk k is in place and scaled, and every thread is done with
    // chunk k - 1, whose buffer chunk k + 1 now fills
    __syncthreads();
    if (k + 1 < chunks) stage(k + 1, buf ^ 1);
    const int t0 = k * kK;
#pragma unroll 4
    for (int g = 0; g < kK; g += kL) {
      float part[kL];
#pragma unroll
      for (int w = 0; w < kL; ++w) {
        const int tt = g + w;
        const float dtv = s_dt[buf][tt][ch];
        const float dtx = dtv * s_x[buf][tt][ch];
        const float4* bv4 =
            reinterpret_cast<const float4*>(&s_b[buf][tt][lane * kS]);
        const float4* cv4 =
            reinterpret_cast<const float4*>(&s_c[buf][tt][lane * kS]);
        float acc[kS / 4];
#pragma unroll
        for (int q = 0; q < kS / 4; ++q) {
          const float4 bq = bv4[q], cq = cv4[q];
          const float bj[4] = {bq.x, bq.y, bq.z, bq.w};
          const float cj[4] = {cq.x, cq.y, cq.z, cq.w};
          acc[q] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = 4 * q + j;
            u[s] = fmaf(u[s], ex2(fmaf(dtv, a2[s], 1.f)), dtx * bj[j]);
            acc[q] = fmaf(u[s], cj[j], acc[q]);
          }
        }
        float sum = acc[0];
#pragma unroll
        for (int q = 1; q < kS / 4; ++q) sum += acc[q];
        part[w] = sum;
      }
      const float yv = reduce_scatter<kL>(part, lane);
      const int t = t0 + g + lane;
      if (live && t < t_len) y[(row0 + t) * di + d] = yv;
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) u[j] *= pow2(-kK);
    if (k + 1 < chunks) scale(buf ^ 1);
  }
}

// ---------------------------------------------------------------- v1 --
constexpr int kV1Lanes = 4;                     // lanes a channel
constexpr int kV1States = kMaxN / kV1Lanes;     // states a lane
constexpr int kV1Steps = kV1Lanes;              // steps a stage
constexpr int kV1MaxThreads = 1024;
constexpr int kV1MaxStages = 8;
constexpr int kV1Header = 2 * kV1MaxStages * 8; // bytes of the mbarriers

// Floats of one stage of a block of `channels`: bx
// [kV1Steps][channels][16], dt [kV1Steps][channels], C [kV1Steps][16].
__host__ __device__ constexpr int v1_stage_floats(int channels) {
  return kV1Steps * (channels * (kMaxN + 1) + kMaxN);
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival, made when every cp.async this thread issued has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned done;
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
  } while (!done);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const float* src,
                                          int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One block: `channels` (blockDim.x / 4) channels d0 .. of batch row b,
// over a ring of `stages` stages of kV1Steps steps.  kBulk: the bulk
// route.
template <bool kBulk>
__global__ void __launch_bounds__(kV1MaxThreads, 1)
    selective_scan_kernel(const float* __restrict__ dt,
                          const float* __restrict__ bx,
                          const float* __restrict__ c,
                          const float* __restrict__ a, float* __restrict__ y,
                          int t_len, int di, int n, int stages) {
  extern __shared__ __align__(128) unsigned char v1_smem[];
  const int channels = blockDim.x / kV1Lanes;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * channels;
  const int width = min(channels, di - d0);      // channels held here
  const int ch = threadIdx.x / kV1Lanes;
  const int lane = threadIdx.x % kV1Lanes;
  const int d = d0 + ch;
  const bool live = ch < width;
  const size_t row0 = static_cast<size_t>(b) * t_len;   // (b, t = 0)
  const int chunks = (t_len + kV1Steps - 1) / kV1Steps;
  const int stage_floats = v1_stage_floats(channels);
  float* const ring = reinterpret_cast<float*>(v1_smem + kV1Header);
  const unsigned bars = smem_addr(v1_smem);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kV1MaxStages + s); };
  auto s_bx = [&](int s) { return ring + s * stage_floats; };
  auto s_dt = [&](int s) { return s_bx(s) + kV1Steps * channels * kMaxN; };
  auto s_c = [&](int s) { return s_dt(s) + kV1Steps * channels; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), kBulk ? 1 : blockDim.x);
      mbar_init(empty(s), blockDim.x / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (!kBulk)
    for (int i = threadIdx.x; i < stages * stage_floats; i += blockDim.x)
      ring[i] = 0.f;
  __syncthreads();

  float av[kV1States], h[kV1States];
#pragma unroll
  for (int j = 0; j < kV1States; ++j) {
    const int s = lane * kV1States + j;
    av[j] = (live && s < n) ? a[static_cast<size_t>(d) * n + s] : 0.f;
    h[j] = 0.f;
  }

  // Chunk k (steps k * kV1Steps ..) into stage k % stages: the bulk
  // route's thread 0 alone; in the scalar route every thread its share.
  auto issue = [&](int k) {
    const int s = k % stages, t0 = k * kV1Steps;
    const int steps = min(kV1Steps, t_len - t0);
    float* const sbx = s_bx(s);
    float* const sdt = s_dt(s);
    float* const sc = s_c(s);
    if constexpr (kBulk) {
      mbar_expect_tx(full(s), 4 * steps * (width * (kMaxN + 1) + kMaxN));
      for (int tt = 0; tt < steps; ++tt) {
        const size_t g = (row0 + t0 + tt) * di + d0;
        bulk_copy(sbx + tt * channels * kMaxN, bx + g * kMaxN,
                  4 * width * kMaxN, full(s));
        bulk_copy(sdt + tt * channels, dt + g, 4 * width, full(s));
      }
      bulk_copy(sc, c + (row0 + t0) * kMaxN, 4 * steps * kMaxN, full(s));
    } else {
      // a step's bx for the block's channels is one run of width * n
      for (int tt = 0; tt < steps; ++tt) {
        const size_t g = (row0 + t0 + tt) * di + d0;
        for (int r = threadIdx.x; r < width * n; r += blockDim.x) {
          const int cc = r / n;
          cp_async4(sbx + (tt * channels + cc) * kMaxN + r - cc * n,
                    bx + g * n + r, 4);
        }
        for (int cc = threadIdx.x; cc < width; cc += blockDim.x)
          cp_async4(sdt + tt * channels + cc, dt + g + cc, 4);
      }
      for (int i = threadIdx.x; i < steps * n; i += blockDim.x) {
        const int tt = i / n;
        cp_async4(sc + tt * kMaxN + i - tt * n, c + (row0 + t0) * n + i, 4);
      }
      mbar_arrive_cp_async(full(s));
    }
  };

  const bool producer = !kBulk || threadIdx.x == 0;
  if (producer)
    for (int k = 0; k < min(stages, chunks); ++k) issue(k);
  for (int k = 0; k < chunks; ++k) {
    const int s = k % stages;
    // the stage chunk k - 1 used takes chunk k - 1 + stages once every
    // warp has left it
    if (producer && k >= 1 && k - 1 + stages < chunks) {
      mbar_wait(empty((k - 1) % stages), ((k - 1) / stages) & 1);
      issue(k - 1 + stages);
    }
    mbar_wait(full(s), (k / stages) & 1);
    const float* const sbx = s_bx(s);
    const float* const sdt = s_dt(s);
    const float* const sc = s_c(s);
    float part[kV1Steps];
#pragma unroll
    for (int tt = 0; tt < kV1Steps; ++tt) {
      const float dtv = sdt[tt * channels + ch];
      const float4 bq = reinterpret_cast<const float4*>(
          sbx + (tt * channels + ch) * kMaxN)[lane];
      const float4 cq = reinterpret_cast<const float4*>(sc + tt * kMaxN)
          [lane];
      const float bj[kV1States] = {bq.x, bq.y, bq.z, bq.w};
      const float cj[kV1States] = {cq.x, cq.y, cq.z, cq.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kV1States; ++j) {
        h[j] = fmaf(h[j], expf(dtv * av[j]), bj[j]);
        acc = fmaf(h[j], cj[j], acc);
      }
      part[tt] = acc;
    }
    // every lane's reads of the stage are in `part` once the butterfly
    // has run
    const float yv = reduce_scatter<kV1Lanes>(part, lane);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty(s));
    const int t = k * kV1Steps + lane;
    if (live && t < t_len) y[(row0 + t) * di + d] = yv;
  }
}

dim3 grid_of(int b, int di, int channels) {
  return dim3((di + channels - 1) / channels, b);
}

template <int kL>
void launch_fused(const float* dt, const float* x, const float* bm,
                  const float* c, const float* a, float* y, int b, int t,
                  int di, int n, bool vec, cudaStream_t s) {
  const dim3 grid = grid_of(b, di, kFusedThreads / kL);
  if (vec)
    selective_scan_fused_kernel<kL, true>
        <<<grid, kFusedThreads, 0, s>>>(dt, x, bm, c, a, y, t, di, n);
  else
    selective_scan_fused_kernel<kL, false>
        <<<grid, kFusedThreads, 0, s>>>(dt, x, bm, c, a, y, t, di, n);
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// All tensors fp32 and contiguous; 1 <= N <= 16, B <= 65535, T and di >= 1
// (checked by the Python wrappers).  channels: a multiple of 8 from 8 to
// 256; stages: 1 to 8 (selective_scan.py:plan); anything else, or a ring
// past the 227 KiB a block may take, is refused before a launch.
extern "C" int selective_scan(const void* dt, const void* bx, const void* c,
                              const void* a, void* y, int b, int t, int di,
                              int n, int channels, int stages,
                              void* stream) {
  if (channels < 8 || channels % 8 != 0 ||
      channels * kV1Lanes > kV1MaxThreads || stages < 1 ||
      stages > kV1MaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = kV1Header + stages * v1_stage_floats(channels) * 4;
  const bool bulk = n == kMaxN && di % 4 == 0 && aligned16(dt) &&
                    aligned16(bx) && aligned16(c);
  auto* kernel =
      bulk ? selective_scan_kernel<true> : selective_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid_of(b, di, channels), channels * kV1Lanes, smem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(bx),
      static_cast<const float*>(c), static_cast<const float*>(a),
      static_cast<float*>(y), t, di, n, stages);
  return static_cast<int>(cudaGetLastError());
}

// lanes: 2 or 4 lanes a channel (fused.py:plan); anything else is refused
// with cudaErrorInvalidValue before a launch.
extern "C" int selective_scan_fused(const void* dt, const void* x,
                                    const void* bm, const void* c,
                                    const void* a, void* y, int b, int t,
                                    int di, int n, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dtf = static_cast<const float*>(dt);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bm);
  const auto* cf = static_cast<const float*>(c);
  const auto* af = static_cast<const float*>(a);
  auto* yf = static_cast<float*>(y);
  const bool vec = di % 4 == 0 && n == kMaxN && aligned16(dt) &&
                   aligned16(x) && aligned16(bm) && aligned16(c);
  if (lanes == 2)
    launch_fused<2>(dtf, xf, bf, cf, af, yf, b, t, di, n, vec, s);
  else if (lanes == 4)
    launch_fused<4>(dtf, xf, bf, cf, af, yf, b, t, di, n, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
