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
// The fused scan's backward (the training step of every Mamba layer).  It
// replaces no Pallas kernel: the reference trains through its jnp chunked
// scan (src/repro/models/layers.py, _ssm_scan_chunked, under jax.vjp),
// which XLA compiles for the TPU.  It computes, from the forward's inputs
// and dy, with decay_t = exp(dt_t A) and g_T = 0,
//
//   g_t   = dy_t C_t + decay_{t+1} g_{t+1}
//   dx_t  = dt_t sum_n g_t B_t       ddt_t = sum_n g_t (x_t B_t + A decay_t
//                                                        h_{t-1})
//   dB_t  = sum_d g_t dt_t x_t       dC_t  = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t decay_t h_{t-1}
//
// What bounds it: bytes, like the forward: dt, x and dy read and ddt and
// dx written, 20 bytes a (t, d), against one exponential a (t, d, n) if the
// states were kept; but the states are not kept, so each is recomputed.
// The design (selective_scan_fused_bwd_kernel, 4 lanes a channel, 32
// channels a block of one batch row, as the forward lays out its lanes):
//   1. Pass 1 runs the recurrence forward over T and stores the state at
//      the end of every 32-step chunk (scratch [B, ceil(T / 32), di, 16]).
//   2. Pass 2 walks the chunks back: it recomputes the chunk's 32 states
//      from the state before it into shared memory, each thread its own
//      (the forward's decay 0.5 ex2(dt A log2(e) + 1), so the states are
//      the forward's bit for bit), then runs g back through them.
//   3. dx and ddt are lane sums over the channel's states: one butterfly
//      every 4 steps, as the forward's y.  dB and dC are sums over the
//      block's channels: a butterfly over the warp's 8 channels every step
//      leaves each lane one of the 32 (dB, dC) values, then the 4 warps'
//      are added in shared memory into per-block partials [B, di blocks,
//      T, 32]; dA stays in registers over all of T, a partial per batch
//      row [B, di, 16].
//   4. Deterministic: no atomics; a second small kernel
//      (selective_scan_fused_bwd_reduce_kernel) adds the partials over the
//      di blocks and the batch in a fixed order, so a rerun gives the same
//      bits (the sharded train loop's checkpoints are held byte for byte
//      against the one-device loop's).
// It costs three exponentials a (t, d, n) (pass 1, the recompute, and the
// decay in the walk back) and a 7-shuffle butterfly a step, at two blocks
// an SM (96 KiB of shared memory each): see PERF.md for its time against
// the byte bound.
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

// ---------------------------------------------------------- backward --
constexpr int kBwdLanes = 4;                          // lanes a channel
constexpr int kBwdStates = kMaxN / kBwdLanes;         // states a lane
constexpr int kBwdCh = kFusedThreads / kBwdLanes;     // channels a block
constexpr int kBwdChunk = 32;                         // steps a chunk
constexpr int kBwdWarps = kFusedThreads / 32;
constexpr int kBC = 2 * kMaxN;                        // dB then dC, a step

struct BwdSmem {
  float dt[kBwdChunk][kBwdCh];
  float x[kBwdChunk][kBwdCh];
  float dy[kBwdChunk][kBwdCh];
  float b[kBwdChunk][kMaxN];
  float c[kBwdChunk][kMaxN];
  float h[kBwdChunk][kBwdStates][kFusedThreads];  // each thread its own
  float red[kBwdWarps][kBwdChunk][kBC];           // a warp's dB, dC sums
};

// The decay of the fused kernel, bit for bit: 0.5 * ex2(dt A log2(e) + 1).
__device__ __forceinline__ float fused_decay(float dtv, float a2) {
  return 0.5f * ex2(fmaf(dtv, a2, 1.f));
}

// Sum each of a lane's kV values over the kV channels of its warp (lanes
// kL apart): the lane of channel `chw` returns the whole sum of value chw
// (kV - 1 shuffles, halving the values at each of log2(kV) levels).
template <int kL>
__device__ __forceinline__ float reduce_scatter_channels(
    float (&v)[32 / kL], int chw) {
  constexpr int kV = 32 / kL;
#pragma unroll
  for (int half = kV / 2; half >= 1; half /= 2) {
    const bool up = chw & half;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, half * kL);
    }
  }
  return v[0];
}

// One block: kBwdCh channels d0 .. of batch row b over all of T, 4 lanes
// a channel.  Pass 1 runs the recurrence forward and keeps the state at
// the end of every chunk but the last in hbuf [B][chunks][di][16].  Pass
// 2 walks the chunks back: it recomputes the chunk's states from the
// state before it into shared memory (each thread its own), then runs
//   g_t = dy_t C_t + decay_{t+1} g_{t+1}
// back through them, with per step (t, d)
//   dx = dt sum_n g B          ddt = sum_n g (x B + A decay h_{t-1})
// (a butterfly over the channel's lanes every 4 steps), and per (t, n)
// the block's sums over its channels of dB = g dt x and dC = dy h_t (a
// butterfly over the warp's channels every step, then over the warps in
// shared memory) into part_bc [B][di blocks][T][32]; dA = sum_t g dt
// decay h_{t-1} stays in registers until the end, into part_a
// [B][di][16].  No atomics: the reduce kernel sums the partials in a
// fixed order.  kVec: the inputs are copied 16 bytes at a time.
template <bool kVec>
__global__ void __launch_bounds__(kFusedThreads)
    selective_scan_fused_bwd_kernel(
        const float* __restrict__ dt, const float* __restrict__ x,
        const float* __restrict__ bm, const float* __restrict__ c,
        const float* __restrict__ a, const float* __restrict__ dy,
        float* __restrict__ hbuf, float* __restrict__ ddt,
        float* __restrict__ dx, float* __restrict__ part_bc,
        float* __restrict__ part_a, int t_len, int di, int n) {
  constexpr int kL = kBwdLanes, kS = kBwdStates, kK = kBwdChunk;
  constexpr int kCh = kBwdCh;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(bwd_smem);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int tid = threadIdx.x;
  const int ch = tid / kL;
  const int lane = tid % kL;
  const int warp = tid / 32;
  const int chw = (tid % 32) / kL;              // channel within the warp
  const int d = d0 + ch;
  const bool live = d < di;
  const size_t row0 = static_cast<size_t>(b) * t_len;
  const int chunks = (t_len + kK - 1) / kK;

  float av[kS], a2[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int s = lane * kS + j;
    av[j] = (live && s < n) ? a[static_cast<size_t>(d) * n + s] : 0.f;
    a2[j] = av[j] * kLog2e;
  }

  // Chunk k into shared memory (dt, x, B; with `grads` also dy and C),
  // steps past T and channels past di zero-filled; one commit group.
  auto stage = [&](int k, bool grads) {
    const int t0 = k * kK;
    if constexpr (kVec) {
      constexpr int kQ = kCh / 4;
      for (int i = tid; i < kK * kQ; i += kFusedThreads) {
        const int tt = i / kQ, q = (i % kQ) * 4;
        const bool ok = t0 + tt < t_len && d0 + q < di;
        const size_t g = ok ? (row0 + t0 + tt) * di + d0 + q : 0;
        cp_async16(&sm.dt[tt][q], dt + g, ok ? 16 : 0);
        cp_async16(&sm.x[tt][q], x + g, ok ? 16 : 0);
        if (grads) cp_async16(&sm.dy[tt][q], dy + g, ok ? 16 : 0);
      }
      for (int i = tid; i < kK * 4; i += kFusedThreads) {
        const int tt = i / 4, q = (i % 4) * 4;
        const bool ok = t0 + tt < t_len;
        const size_t g = ok ? (row0 + t0 + tt) * kMaxN + q : 0;
        cp_async16(&sm.b[tt][q], bm + g, ok ? 16 : 0);
        if (grads) cp_async16(&sm.c[tt][q], c + g, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kK * kCh; i += kFusedThreads) {
        const int tt = i / kCh, cc = i % kCh;
        const bool ok = t0 + tt < t_len && d0 + cc < di;
        const size_t g = ok ? (row0 + t0 + tt) * di + d0 + cc : 0;
        cp_async4(&sm.dt[tt][cc], dt + g, ok ? 4 : 0);
        cp_async4(&sm.x[tt][cc], x + g, ok ? 4 : 0);
        if (grads) cp_async4(&sm.dy[tt][cc], dy + g, ok ? 4 : 0);
      }
      for (int i = tid; i < kK * kMaxN; i += kFusedThreads) {
        const int tt = i / kMaxN, s = i % kMaxN;
        const bool ok = t0 + tt < t_len && s < n;
        const size_t g = ok ? (row0 + t0 + tt) * n + s : 0;
        cp_async4(&sm.b[tt][s], bm + g, ok ? 4 : 0);
        if (grads) cp_async4(&sm.c[tt][s], c + g, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // this lane's kS states of channel d at the end of chunk k
  auto hrow = [&](int k) {
    return reinterpret_cast<float4*>(
        hbuf + ((static_cast<size_t>(b) * chunks + k) * di + d) * kMaxN +
        lane * kS);
  };
  // steps tt .. of the chunk in shared memory from the state h
  auto advance = [&](float (&h)[kS], int tt) {
    const float dtv = sm.dt[tt][ch];
    const float dtx = dtv * sm.x[tt][ch];
    const float4 bq = *reinterpret_cast<const float4*>(&sm.b[tt][lane * kS]);
    const float bj[kS] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
    for (int j = 0; j < kS; ++j)
      h[j] = fmaf(h[j], fused_decay(dtv, a2[j]), dtx * bj[j]);
  };

  // pass 1: the state at the end of every chunk but the last
  float h[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) h[j] = 0.f;
  for (int k = 0; k + 1 < chunks; ++k) {
    stage(k, false);
    cp_async_wait_all();
    __syncthreads();
    for (int tt = 0; tt < kK; ++tt) advance(h, tt);
    if (live) *hrow(k) = make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();                   // every thread done with chunk k
  }

  // pass 2: the chunks back
  float gc[kS], da[kS];                // decay_{t+1} g_{t+1}; dA's sums
#pragma unroll
  for (int j = 0; j < kS; ++j) gc[j] = da[j] = 0.f;
  for (int k = chunks - 1; k >= 0; --k) {
    stage(k, true);
    float h0[kS] = {0.f, 0.f, 0.f, 0.f};
    if (k > 0 && live) {
      const float4 hv = *hrow(k - 1);
      h0[0] = hv.x, h0[1] = hv.y, h0[2] = hv.z, h0[3] = hv.w;
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kS; ++j) h[j] = h0[j];
    for (int tt = 0; tt < kK; ++tt) {
      advance(h, tt);
#pragma unroll
      for (int j = 0; j < kS; ++j) sm.h[tt][j][tid] = h[j];
    }
    for (int grp = kK - kL; grp >= 0; grp -= kL) {
      float pdx[kL], pddt[kL];
#pragma unroll
      for (int w = kL - 1; w >= 0; --w) {
        const int tt = grp + w;
        const float dtv = sm.dt[tt][ch];
        const float xv = sm.x[tt][ch];
        const float dyv = sm.dy[tt][ch];
        const float dtx = dtv * xv;
        const float4 bq =
            *reinterpret_cast<const float4*>(&sm.b[tt][lane * kS]);
        const float4 cq =
            *reinterpret_cast<const float4*>(&sm.c[tt][lane * kS]);
        const float bj[kS] = {bq.x, bq.y, bq.z, bq.w};
        const float cj[kS] = {cq.x, cq.y, cq.z, cq.w};
        float gb = 0.f, gah = 0.f;
        float vals[2 * kS];
#pragma unroll
        for (int j = 0; j < kS; ++j) {
          const float hp = tt > 0 ? sm.h[tt - 1][j][tid] : h0[j];
          const float dec = fused_decay(dtv, a2[j]);
          const float g = fmaf(dyv, cj[j], gc[j]);
          const float hd = dec * hp;
          gb = fmaf(g, bj[j], gb);
          gah = fmaf(g * av[j], hd, gah);
          da[j] = fmaf(g * dtv, hd, da[j]);
          vals[j] = g * dtx;
          vals[kS + j] = dyv * sm.h[tt][j][tid];
          gc[j] = dec * g;
        }
        pdx[w] = dtv * gb;
        pddt[w] = fmaf(xv, gb, gah);
        const float r = reduce_scatter_channels<kL>(vals, chw);
        sm.red[warp][tt][chw < kS ? lane * kS + chw
                                  : kMaxN + lane * kS + chw - kS] = r;
      }
      const float dxv = reduce_scatter<kL>(pdx, lane);
      const float ddtv = reduce_scatter<kL>(pddt, lane);
      const int t = k * kK + grp + lane;
      if (live && t < t_len) {
        dx[(row0 + t) * di + d] = dxv;
        ddt[(row0 + t) * di + d] = ddtv;
      }
    }
    __syncthreads();                   // every warp's sums are in red
    for (int i = tid; i < kK * kBC; i += kFusedThreads) {
      const int tt = i / kBC, v = i % kBC;
      const int t = k * kK + tt;
      if (t >= t_len) continue;
      float sum = sm.red[0][tt][v];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) sum += sm.red[w][tt][v];
      part_bc[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * t_len +
               t) * kBC + v] = sum;
    }
    // the next chunk's stage writes dt .. c, not red, and its barrier
    // comes before anything writes red again
  }
  if (live)
    *reinterpret_cast<float4*>(
        part_a + (static_cast<size_t>(b) * di + d) * kMaxN + lane * kS) =
        make_float4(da[0], da[1], da[2], da[3]);
}

// dB and dC [B][T][N]: the sums of part_bc over the di blocks in order;
// dA [di][N]: the sums of part_a over the batch in order.  One thread an
// output.
__global__ void selective_scan_fused_bwd_reduce_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    float* __restrict__ dbm, float* __restrict__ dc, float* __restrict__ da,
    int bsz, int t_len, int di, int n, int blocks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long nbc = static_cast<long long>(bsz) * t_len * n;
  if (i < 2 * nbc) {
    const int which = i >= nbc;                  // 0: dB, 1: dC
    const long long r = i - which * nbc;
    const int s = static_cast<int>(r % n);
    const long long bt = r / n;
    const int t = static_cast<int>(bt % t_len);
    const long long bb = bt / t_len;
    const float* p = part_bc + (bb * blocks * t_len + t) * kBC +
                     which * kMaxN + s;
    float sum = 0.f;
    for (int k = 0; k < blocks; ++k)
      sum += p[static_cast<size_t>(k) * t_len * kBC];
    (which ? dc : dbm)[r] = sum;
  } else if (i < 2 * nbc + static_cast<long long>(di) * n) {
    const long long r = i - 2 * nbc;
    const int s = static_cast<int>(r % n);
    const long long dd = r / n;
    float sum = 0.f;
    for (int bb = 0; bb < bsz; ++bb)
      sum += part_a[(static_cast<size_t>(bb) * di + dd) * kMaxN + s];
    da[r] = sum;
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

// The fused scan's backward: ddt, dx [B, T, di], dB, dC [B, T, N] and dA
// [di, N] from the forward's inputs and dy [B, T, di], all fp32 and
// contiguous, 1 <= N <= 16, B <= 65535, T and di >= 1 (checked by the
// Python wrapper, which also allocates the scratch: hbuf [B, ceil(T /
// 32), di, 16], part_bc [B, ceil(di / 32), T, 32], part_a [B, di, 16]).
// Two launches on the stream: the scan, then the fixed-order sums.
extern "C" int selective_scan_fused_bwd(
    const void* dt, const void* x, const void* bm, const void* c,
    const void* a, const void* dy, void* hbuf, void* part_bc, void* part_a,
    void* ddt, void* dx, void* dbm, void* dc, void* da, int b, int t, int di,
    int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = di % 4 == 0 && n == kMaxN && aligned16(dt) &&
                   aligned16(x) && aligned16(bm) && aligned16(c) &&
                   aligned16(dy);
  auto* kernel = vec ? selective_scan_fused_bwd_kernel<true>
                     : selective_scan_fused_bwd_kernel<false>;
  const int smem = static_cast<int>(sizeof(BwdSmem));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = grid_of(b, di, kBwdCh);
  kernel<<<grid, kFusedThreads, smem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bm), static_cast<const float*>(c),
      static_cast<const float*>(a), static_cast<const float*>(dy),
      static_cast<float*>(hbuf), static_cast<float*>(ddt),
      static_cast<float*>(dx), static_cast<float*>(part_bc),
      static_cast<float*>(part_a), t, di, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2LL * b * t * n + static_cast<long long>(di) * n;
  constexpr int kReduceThreads = 256;
  selective_scan_fused_bwd_reduce_kernel<<<
      static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads),
      kReduceThreads, 0, s>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(part_a),
      static_cast<float*>(dbm), static_cast<float*>(dc),
      static_cast<float*>(da), b, t, di, n, static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}
