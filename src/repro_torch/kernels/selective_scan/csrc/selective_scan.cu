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
// What bounds it: not its bytes (dt, x, dy, B, C read and the gradients
// written, 20 bytes a (t, d), would take about as long as one exponential
// a (t, d, n)), but its work a (t, d, n): the forward does not keep the
// states, so each is computed twice, and each (t, d, n) also takes some
// fifteen FMAs and loads and its share of the dB, dC and dx, ddt sums
// across lanes, all at one or two blocks an SM (the issue slots and the
// shared-memory and shuffle pipe; see PERF.md for the measured split).
// The design (selective_scan_fused_bwd_kernel; 4 lanes a channel, 4
// states a lane, as the forward lays out its lanes):
//   1. Two exponentials a (t, d, n).  Pass 1 runs the recurrence forward
//      and stores the state at the end of every 8-step chunk (scratch
//      [B, ceil(T / 8), di, 16]).  Pass 2 walks the chunks back: it
//      recomputes the chunk's 8 states and their decays into registers
//      (the chunk fully unrolled, 64 registers a thread) and runs g back
//      through them: the walk computes no exponential.  The decay keeps
//      the forward's form 0.5 ex2(dt A log2(e) + 1).
//   2. Staging overlaps the scan: each pass streams its chunks through a
//      ring of cp.async stages (pass 1 eleven chunks ahead, pass 2 five),
//      each thread's copies fixed for the whole launch; one barrier a
//      chunk.  B and C arrive in the four state orders of step 4 from a
//      small kernel that writes them first (scratch [2, B, T, 4, 16]):
//      staging those orders straight from B and C by 4-byte copies, or
//      one copy read at permuted indices, was slower (PERF.md).
//   3. Blocks planned for the card (fused.py:bwd_plan): 8 to 128 channels
//      a block, a multiple of 8, so that the busiest SM carries the fewest
//      channels; at Hymba-1.5B's width (12,800 channels a launch) the plan
//      takes 31 x 4 blocks of 104 channels, one an SM, at
//      Falcon-Mamba-7B's 64 x 4 of 128, two an SM.  A thread keeps at
//      most 128 registers (__launch_bounds__); what the card holds of the
//      blocks at once, the compiled kernel's registers and spills, it
//      reports itself (selective_scan_fused_bwd_occupancy).
//   4. Sums across threads: dx and ddt with one butterfly over the
//      channel's 4 lanes every 4 steps (reduce_scatter); dB and dC with a
//      butterfly over the warp's 8 channels, 7 shuffles a step (8 values
//      a lane already fill a reduce-scatter over 8 lanes, so 4 steps at
//      once take 28: the fewest), issued for 4 steps together, with two
//      selects a step where a plain one needs fourteen (each lane holds
//      its states in an order of its own; see the kernel), then over the
//      block's warps in shared memory in a fixed tree once a chunk, into
//      per-block partials [B, di blocks, T, 32]; dA stays in registers
//      over all of T, a partial per batch row [B, di, 16].  Wider blocks
//      write fewer partials (31 blocks a row at Hymba's width, 100
//      before).
//   5. Deterministic: no atomics; a last small kernel
//      (selective_scan_fused_bwd_reduce_kernel) adds the partials over the
//      di blocks and the batch in a fixed order, so a rerun gives the same
//      bits (the sharded train loop's checkpoints are held byte for byte
//      against the one-device loop's).
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
constexpr int kBwdChunk = 8;                          // steps a chunk
constexpr int kBwdMaxThreads = 512;                   // 128 channels a block
constexpr int kBwdOrders = 4;                         // copies of B and C
constexpr int kBwdStages1 = 12;                       // pass 1's ring
constexpr int kBwdStages2 = 6;                        // pass 2's ring
constexpr int kBC = 2 * kMaxN;                        // dB then dC, a step

// One stage of a ring, in floats, for a block of `warps` warps: each
// warp's dt, x (with `grads` also dy) of a chunk [kBwdChunk][2 or 3][8];
// B (and C) of the chunk [1 or 2][kBwdChunk][kBwdOrders][16]; with
// `grads` the state each thread starts the chunk from [threads][4].
__host__ __device__ constexpr int bwd_stage_floats(int warps, bool grads) {
  return grads ? warps * (kBwdChunk * 3 * 8 + 32 * kBwdStates) +
                     2 * kBwdChunk * kBwdOrders * kMaxN
               : warps * kBwdChunk * 2 * 8 + kBwdChunk * kBwdOrders * kMaxN;
}

// A block's dynamic shared memory at `channels` channels, in floats: the
// larger of the two passes' rings, then the warps' dB, dC sums of two
// chunks [2][warps][kBwdChunk][32].
__host__ __device__ constexpr int bwd_smem_floats(int channels) {
  return (kBwdStages1 * bwd_stage_floats(channels / 8, false) >
                  kBwdStages2 * bwd_stage_floats(channels / 8, true)
              ? kBwdStages1 * bwd_stage_floats(channels / 8, false)
              : kBwdStages2 * bwd_stage_floats(channels / 8, true)) +
         2 * (channels / 8) * kBwdChunk * kBC;
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The decay as the fused kernel forms it, 0.5 * ex2(dt A log2(e) + 1),
// from dtl = dt log2(e) (a step's, once) and A: the argument rounds apart
// from the forward's dt (A log2(e)), and no thread keeps A log2(e).
__device__ __forceinline__ float bwd_decay(float dtl, float av) {
  return 0.5f * ex2(fmaf(dtl, av, 1.f));
}

__device__ __forceinline__ float shfl_xor(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

// B and C in the backward's four orders: bcp [2][B * T][4][16], copy o of
// a row holding state s at s ^ o (0 past N).  One thread a value.
__global__ void selective_scan_fused_bwd_orders_kernel(
    const float* __restrict__ bm, const float* __restrict__ c,
    float* __restrict__ bcp, long long rows, int n) {
  constexpr int kRow = kBwdOrders * kMaxN;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= 2 * rows * kRow) return;
  const int which = i >= rows * kRow;           // 0: B, 1: C
  const long long r = i - which * rows * kRow;
  const long long row = r / kRow;
  const int p = static_cast<int>(r % kRow);
  const int s = (p % kMaxN) ^ (p / kMaxN);
  bcp[i] = s < n ? (which ? c : bm)[row * n + s] : 0.f;
}

// One block: blockDim.x / 4 channels d0 .. of batch row b over all of T,
// 4 lanes a channel, 4 states a lane.  Pass 1 runs the recurrence forward
// and keeps the state at the end of every 8-step chunk but the last in
// hbuf [B][chunks][di][16] (in this lane's order of its states, below).
// Pass 2 walks the chunks back: it recomputes the chunk's 8 states and
// their decays into registers (the chunk fully unrolled), then runs
//   g_t = dy_t C_t + decay_{t+1} g_{t+1}
// back through them, with per step (t, d)
//   dx = dt sum_n g B          ddt = sum_n g (x B + A decay h_{t-1})
// (reduce_scatter over the channel's lanes every 4 steps), and per (t, n)
// the block's sums over its channels of dB = g dt x and dC = dy h_t: a
// butterfly over the warp's 8 channels a step (the 4 steps of a group
// level by level together) into shared memory,
// then over the warps, for each chunk once the next chunk's barrier has
// passed, into part_bc [B][di blocks][T][32]; dA = sum_t g dt decay
// h_{t-1} stays in registers until the end, into part_a [B][di][16].  Each
// pass streams its chunks through a ring of stages filled by cp.async up
// to kBwdStages1 - 1 (pass 1) or kBwdStages2 - 1 (pass 2) chunks ahead of
// the one scanned; the stage a chunk frees is refilled once it has been
// scanned, and one barrier a chunk orders both.
//
// The butterfly needs no selects but at its last level because each lane
// holds its states in an order of its own: slot r of the lane of channel
// chw (0..7 in its warp) holds state 4 lane + (r ^ perm), perm = (bit 2
// of chw) * 2 + (bit 1 of chw).  At the level that pairs chw with chw ^ 4
// every lane keeps slots 0, 1 and sends 2, 3, which hold the states its
// partner keeps; at chw ^ 2 it keeps slot 0 and sends slot 1; at chw ^ 1
// the pair splits dB from dC.  A lane then holds the warp's sum of one of
// the step's 32 values.  B and C are staged in the four orders (copy o
// holds state s at s ^ o), so a lane reads its slots as one float4.
// kVec: dt, x and dy are copied 16 bytes at a time.  No atomics: the
// reduce kernel sums the partials in a fixed order.
template <bool kVec>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
    selective_scan_fused_bwd_kernel(
        const float* __restrict__ dt, const float* __restrict__ x,
        const float* __restrict__ bcp, const float* __restrict__ a,
        const float* __restrict__ dy, float* hbuf, float* __restrict__ ddt,
        float* __restrict__ dx, float* __restrict__ part_bc,
        float* __restrict__ part_a, int t_len, int di, int n) {
  constexpr int kL = kBwdLanes, kS = kBwdStates, kK = kBwdChunk;
  constexpr int kRow = kBwdOrders * kMaxN;       // B or C floats a step
  extern __shared__ __align__(16) float bwd_smem[];
  const int threads = blockDim.x;
  const int warps = threads / 32;
  const int chans = threads / kL;                // channels a block
  float* const ring = bwd_smem;
  float* const s_red =                           // [2][warps][kK][32]
      ring + (bwd_smem_floats(chans) - 2 * warps * kK * kBC);

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * chans;
  const int tid = threadIdx.x;
  const int ch = tid / kL;
  const int lane = tid % kL;
  const int warp = tid / 32;
  const int chw = (tid % 32) / kL;              // channel within the warp
  const int d = d0 + ch;
  const bool live = d < di;
  const size_t row0 = static_cast<size_t>(b) * t_len;
  const int chunks = (t_len + kK - 1) / kK;
  const int perm = ((chw >> 2) & 1) * 2 + ((chw >> 1) & 1);
  const bool keep_c = chw & 1;                  // keeps dC at the last level
  const int vidx = (keep_c ? kMaxN : 0) + lane * kS + perm;

  float av[kS];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const int s = lane * kS + (j ^ perm);
    av[j] = (live && s < n) ? a[static_cast<size_t>(d) * n + s] : 0.f;
  }

  auto hrow = [&](int k) {
    return hbuf + ((static_cast<size_t>(b) * chunks + k) * di + d) * kMaxN +
           lane * kS;
  };
  // What this thread copies of every chunk, from the chunk's first step:
  // one 16-byte run of dt, x (dy) of 4 channels (the bulk of a chunk is
  // kK * chans / 4 runs: threads < threads / 2), or in the scalar route
  // two channels' floats; B and C rows in the orders go 16 bytes a copy.
  const int quads = chans / 4;
  const int v_tt = tid / quads, v_q = tid % quads;
  const int s_tt[2] = {tid / chans, (tid + threads) / chans};
  const int s_cc[2] = {tid % chans, (tid + threads) % chans};
  const size_t rows_all = static_cast<size_t>(gridDim.y) * t_len;
  // Chunk k into stage st: dt, x, B (with `grads` also dy, C and the state
  // the chunk starts from), steps past T, channels past di and states past
  // N zero-filled; one commit group.
  auto stage = [&](float* st, int k, bool grads) {
    const int t0 = k * kK;
    const int row = grads ? 24 : 16;             // a step of a warp's slab
    if constexpr (kVec) {
      if (v_tt < kK) {
        const bool ok = t0 + v_tt < t_len && d0 + 4 * v_q < di;
        const size_t g = ok ? (row0 + t0 + v_tt) * di + d0 + 4 * v_q : 0;
        float* const at = st + ((v_q / 2) * kK + v_tt) * row + (v_q % 2) * 4;
        cp_async16(at, dt + g, ok ? 16 : 0);
        cp_async16(at + 8, x + g, ok ? 16 : 0);
        if (grads) cp_async16(at + 16, dy + g, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int tt = s_tt[u], cc = s_cc[u];
        const bool ok = t0 + tt < t_len && d0 + cc < di;
        const size_t g = ok ? (row0 + t0 + tt) * di + d0 + cc : 0;
        float* const at = st + ((cc / 8) * kK + tt) * row + cc % 8;
        cp_async4(at, dt + g, ok ? 4 : 0);
        cp_async4(at + 8, x + g, ok ? 4 : 0);
        if (grads) cp_async4(at + 16, dy + g, ok ? 4 : 0);
      }
    }
    for (int i = tid; i < kK * kRow / 4; i += threads) {
      const int tt = i / (kRow / 4), at = (i % (kRow / 4)) * 4;
      float* const sb = st + warps * kK * row + tt * kRow + at;
      const bool ok = t0 + tt < t_len;
      const size_t g = ok ? (row0 + t0 + tt) * kRow + at : 0;
      cp_async16(sb, bcp + g, ok ? 16 : 0);
      if (grads)
        cp_async16(sb + kK * kRow, bcp + rows_all * kRow + g, ok ? 16 : 0);
    }
    if (grads) {
      const bool ok = live && k >= 1;
      cp_async16(st + warps * kK * row + 2 * kK * kRow + tid * kS,
                 ok ? hrow(k - 1) : hbuf, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // the block's dB, dC sums of chunk kc from its warps', in order
  auto sum_warps = [&](int kc) {
    const float* const red = s_red + (kc & 1) * warps * kK * kBC;
    for (int i = tid; i < kK * kBC; i += threads) {
      const int t = kc * kK + i / kBC;
      if (t >= t_len) continue;
      constexpr int kWarps = kBwdMaxThreads / 32;
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        v[w] = w < warps ? red[w * kK * kBC + i] : 0.f;
#pragma unroll
      for (int h = 1; h < kWarps; h *= 2)
#pragma unroll
        for (int w = 0; w < kWarps; w += 2 * h) v[w] += v[w + h];
      const float sum = v[0];
      part_bc[((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * t_len +
               t) * kBC + i % kBC] = sum;
    }
  };

  // pass 1: the state at the end of every chunk but the last
  {
    const int scans = chunks - 1;
    const int size = bwd_stage_floats(warps, false);
    for (int j = 0; j + 1 < kBwdStages1; ++j)
      if (j < scans) stage(ring + j * size, j, false);
      else cp_async_commit();
    float hr[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) hr[j] = 0.f;
    for (int k = 0; k < scans; ++k) {
      cp_async_wait<kBwdStages1 - 2>();
      __syncthreads();        // chunk k has landed; chunk k - 1 is done
      const float* const st = ring + (k % kBwdStages1) * size;
      const float* const sin = st + warp * kK * 16 + chw;
      const float* const sb = st + warps * kK * 16 + perm * kMaxN + lane * kS;
#pragma unroll
      for (int tt = 0; tt < kK; ++tt) {
        const float dtv = sin[tt * 16];
        const float dtx = dtv * sin[tt * 16 + 8];
        const float dtl = dtv * kLog2e;
        const float4 bq = *reinterpret_cast<const float4*>(sb + tt * kRow);
        const float bj[kS] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int j = 0; j < kS; ++j)
          hr[j] = fmaf(hr[j], bwd_decay(dtl, av[j]), dtx * bj[j]);
      }
      if (live)
        *reinterpret_cast<float4*>(hrow(k)) =
            make_float4(hr[0], hr[1], hr[2], hr[3]);
      const int next = k + kBwdStages1 - 1;
      if (next < scans) stage(ring + (next % kBwdStages1) * size, next, false);
      else cp_async_commit();
    }
    cp_async_wait_all();
    __syncthreads();          // the ring is free for pass 2
  }

  // pass 2: the chunks back
  float gc[kS], da[kS];                // decay_{t+1} g_{t+1}; dA's sums
#pragma unroll
  for (int j = 0; j < kS; ++j) gc[j] = da[j] = 0.f;
  const int size = bwd_stage_floats(warps, true);
  for (int j = 0; j + 1 < kBwdStages2; ++j)
    if (j < chunks) stage(ring + j * size, chunks - 1 - j, true);
    else cp_async_commit();
  for (int j = 0; j < chunks; ++j) {
    const int k = chunks - 1 - j;
    cp_async_wait<kBwdStages2 - 2>();
    __syncthreads();          // chunk k has landed; chunk k + 1 is done
    if (j > 0) sum_warps(k + 1);
    const float* const st = ring + (j % kBwdStages2) * size;
    const float* const sin = st + warp * kK * 24 + chw;
    const float* const sb = st + warps * kK * 24 + perm * kMaxN + lane * kS;
    const float* const sc = sb + kK * kRow;
    // the state before the chunk, read where a step needs it
    const float* const sh0 = st + warps * kK * 24 + 2 * kK * kRow + tid * kS;
    float hs[kK][kS], dec[kK][kS];     // the chunk's states and decays
#pragma unroll
    for (int tt = 0; tt < kK; ++tt) {
      const float dtv = sin[tt * 24];
      const float dtx = dtv * sin[tt * 24 + 8];
      const float dtl = dtv * kLog2e;
      const float4 bq = *reinterpret_cast<const float4*>(sb + tt * kRow);
      const float bj[kS] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int j2 = 0; j2 < kS; ++j2) {
        dec[tt][j2] = bwd_decay(dtl, av[j2]);
        hs[tt][j2] = fmaf(tt > 0 ? hs[tt - 1][j2] : sh0[j2], dec[tt][j2],
                          dtx * bj[j2]);
      }
    }
    float* const red = s_red + ((k & 1) * warps + warp) * kK * kBC + vidx;
#pragma unroll
    for (int grp = kK - kL; grp >= 0; grp -= kL) {
      float pdx[kL], pddt[kL], vb[kL][kS], vc[kL][kS];
#pragma unroll
      for (int w = kL - 1; w >= 0; --w) {
        const int tt = grp + w;
        const float dtv = sin[tt * 24];
        const float xv = sin[tt * 24 + 8];
        const float dyv = sin[tt * 24 + 16];
        const float dtx = dtv * xv;
        const float4 bq = *reinterpret_cast<const float4*>(sb + tt * kRow);
        const float4 cq = *reinterpret_cast<const float4*>(sc + tt * kRow);
        const float bj[kS] = {bq.x, bq.y, bq.z, bq.w};
        const float cj[kS] = {cq.x, cq.y, cq.z, cq.w};
        float gb = 0.f, gah = 0.f;
#pragma unroll
        for (int j2 = 0; j2 < kS; ++j2) {
          const float hp = tt > 0 ? hs[tt - 1][j2] : sh0[j2];
          const float g = fmaf(dyv, cj[j2], gc[j2]);
          gc[j2] = dec[tt][j2] * g;
          const float q = gc[j2] * hp;       // g decay h_{t-1}
          gb = fmaf(g, bj[j2], gb);
          gah = fmaf(av[j2], q, gah);
          da[j2] = fmaf(dtv, q, da[j2]);
          vb[w][j2] = g * dtx;
          vc[w][j2] = dyv * hs[tt][j2];
        }
        pdx[w] = dtv * gb;
        pddt[w] = fmaf(xv, gb, gah);
      }
      // the group's 4 butterflies over the warp's channels, level by level
#pragma unroll
      for (int w = 0; w < kL; ++w) {
        vb[w][0] += shfl_xor(vb[w][2], 4 * kL);
        vb[w][1] += shfl_xor(vb[w][3], 4 * kL);
        vc[w][0] += shfl_xor(vc[w][2], 4 * kL);
        vc[w][1] += shfl_xor(vc[w][3], 4 * kL);
      }
#pragma unroll
      for (int w = 0; w < kL; ++w) {
        vb[w][0] += shfl_xor(vb[w][1], 2 * kL);
        vc[w][0] += shfl_xor(vc[w][1], 2 * kL);
      }
#pragma unroll
      for (int w = 0; w < kL; ++w)
        red[(grp + w) * kBC] = (keep_c ? vc[w][0] : vb[w][0]) +
                               shfl_xor(keep_c ? vb[w][0] : vc[w][0], kL);
      const float dxv = reduce_scatter<kL>(pdx, lane);
      const float ddtv = reduce_scatter<kL>(pddt, lane);
      const int t = k * kK + grp + lane;
      if (live && t < t_len) {
        dx[(row0 + t) * di + d] = dxv;
        ddt[(row0 + t) * di + d] = ddtv;
      }
    }
    const int next = j + kBwdStages2 - 1;
    if (next < chunks)
      stage(ring + (next % kBwdStages2) * size, chunks - 1 - next, true);
    else cp_async_commit();
  }
  __syncthreads();                     // every warp's sums of chunk 0
  sum_warps(0);
  if (live)
#pragma unroll
    for (int j = 0; j < kS; ++j)
      part_a[(static_cast<size_t>(b) * di + d) * kMaxN + lane * kS +
             (j ^ perm)] = da[j];
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

// The backward's scan kernel for the route `vec`, its dynamic shared
// memory allowed at `smem` bytes and its carveout at the most shared
// memory, as every launch and the occupancy query below set them.
using BwdKernel = decltype(&selective_scan_fused_bwd_kernel<true>);

cudaError_t bwd_kernel(bool vec, int smem, BwdKernel* kernel) {
  *kernel = vec ? selective_scan_fused_bwd_kernel<true>
                : selective_scan_fused_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

bool bwd_channels_ok(int channels) {
  return channels >= 8 && channels % 8 == 0 &&
         channels * kBwdLanes <= kBwdMaxThreads;
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

// What the current card makes of the backward's scan kernel at `channels`
// a block on the route `vec` (1: 16-byte copies of dt, x, dy; 0: 4-byte):
// its dynamic shared memory a block, the blocks an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and the compiled
// kernel's registers a thread and local (spilled) bytes a thread.
extern "C" int selective_scan_fused_bwd_occupancy(int channels, int vec,
                                                  int* smem_bytes,
                                                  int* blocks_per_sm,
                                                  int* registers,
                                                  int* local_bytes) {
  if (!bwd_channels_ok(channels))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = 4 * bwd_smem_floats(channels);
  BwdKernel kernel;
  cudaError_t err = bwd_kernel(vec != 0, *smem_bytes, &kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, channels * kBwdLanes, *smem_bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    *registers = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
  }
  return static_cast<int>(err);
}

// The fused scan's backward: ddt, dx [B, T, di], dB, dC [B, T, N] and dA
// [di, N] from the forward's inputs and dy [B, T, di], all fp32 and
// contiguous, 1 <= N <= 16, B <= 65535, T and di >= 1 (checked by the
// Python wrapper, which also allocates the scratch: bcp [2, B, T, 4, 16],
// hbuf [B, ceil(T / 8), di, 16], part_bc [B, ceil(di / channels), T, 32],
// part_a [B, di, 16]).  channels: a multiple of 8 up to 128
// (fused.py:bwd_plan); anything else is refused with cudaErrorInvalidValue
// before a launch.  Three launches on the stream: B and C in the scan's
// orders, the scan, then the fixed-order sums.
extern "C" int selective_scan_fused_bwd(
    const void* dt, const void* x, const void* bm, const void* c,
    const void* a, const void* dy, void* bcp, void* hbuf, void* part_bc,
    void* part_a, void* ddt, void* dx, void* dbm, void* dc, void* da, int b,
    int t, int di, int n, int channels, void* stream) {
  if (!bwd_channels_ok(channels))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const long long rows = static_cast<long long>(b) * t;
  const long long values = 2 * rows * kBwdOrders * kMaxN;
  selective_scan_fused_bwd_orders_kernel<<<
      static_cast<unsigned>((values + kThreads - 1) / kThreads), kThreads, 0,
      s>>>(static_cast<const float*>(bm), static_cast<const float*>(c),
           static_cast<float*>(bcp), rows, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec =
      di % 4 == 0 && aligned16(dt) && aligned16(x) && aligned16(dy);
  const int smem = 4 * bwd_smem_floats(channels);
  BwdKernel kernel;
  err = bwd_kernel(vec, smem, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = grid_of(b, di, channels);
  kernel<<<grid, channels * kBwdLanes, smem, s>>>(
      static_cast<const float*>(dt), static_cast<const float*>(x),
      static_cast<const float*>(bcp), static_cast<const float*>(a),
      static_cast<const float*>(dy), static_cast<float*>(hbuf),
      static_cast<float*>(ddt), static_cast<float*>(dx),
      static_cast<float*>(part_bc), static_cast<float*>(part_a), t, di, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2LL * b * t * n + static_cast<long long>(di) * n;
  selective_scan_fused_bwd_reduce_kernel<<<
      static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
      s>>>(static_cast<const float*>(part_bc),
           static_cast<const float*>(part_a), static_cast<float*>(dbm),
           static_cast<float*>(dc), static_cast<float*>(da), b, t, di, n,
           static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}
