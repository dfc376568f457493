// The gradient of the Mamba-2 chunked SSD for Hopper (sm_90a).
//
// Replaces: no TPU kernel.  The Pallas ssd (repro/kernels/ssd.py) has no
// VJP; the JAX package trains Mamba-2 by XLA autodiff of its plain
// ssd_chunked (repro/kernels/ref.py:277).  This is that gradient, the one
// ref.ssd_chunked_bwd writes out: for each (batch b, head h) and chunk of Q
// rows, with a_cs the chunk's inclusive cumsum of A[h] dt, L[i,j] =
// exp(a_cs[i] - a_cs[j]) for i >= j, S = C B^T, dec[j] = exp(a_cs[Q-1] -
// a_cs[j]), h_prev the state entering the chunk and dh_next the gradient of
// the state leaving it (the final state's gradient, or zero, after the
// last chunk):
//   dh_prev  = exp(a_cs[Q-1]) dh_next + sum_i exp(a_cs[i]) dy_i (x) C_i
//   dxdt_j   = sum_{i>=j} S_ij L_ij dy_i + dec[j] dh_next B_j
//   dx_j     = dt_j dxdt_j + D dy_j,     dD = sum dy . x
//   dS_ij    = L_ij (dy_i . x_j dt_j)
//   dC_i     = sum_{j<=i} dS_ij B_j + exp(a_cs[i]) dy_i h_prev
//   dB_j     = sum_{i>=j} dS_ij C_i + dec[j] dt_j x_j dh_next
//   d a_cs   from L (rows +, columns -), from exp(a_cs) of the carried
//            state's output, from dec and from the state's decay; then d a
//            = its reverse cumsum, ddt = x . dxdt + A d a, dA = sum dt d a
// and dh0 = dh_prev of the first chunk.  B and C are shared by the H/G
// heads of a group, so dB and dC sum over those heads.
//
// What bounds it on the card: at mamba2's training shape (Bb = 2, S =
// 2048, H = 32, P = 64, N = 128, chunk 128, bf16) operations, 17.3 GFLOP
// at the bf16 tensor-core peak, ~0.0175 ms, where reading x, dy, dt, B, C
// once and writing dx, ddt, dB, dC once (~55 MB at 3.35 TB/s) takes
// 0.0164 ms; at zamba2's heads (H = 64, P = 64, N = 64) bytes, ~104 MB,
// ~0.031 ms.  On an NVIDIA H100 80GB HBM3 at a 700.00 W limit the bf16
// kernels below take 0.426 ms a layer at mamba2's heads (the state pass
// 0.125, the chunk pass 0.301) and 0.566 ms at zamba2's (0.156, 0.405);
// the first port's kernels, every product on the CUDA cores in f32 with
// per-head dB, dC and per-chunk f32 states in ~400 MB of scratch, took
// 4.50 and 5.99 ms (PERF.md section 6).  What holds them at 24x and 18x
// the bound:
//   * the chunk pass runs one 8-warp block an SM (255 registers a thread
//     fill the register file; ptxas -v reports 112-440 bytes spilled),
//     whose heads follow one another: each head's scan, its three block
//     barriers, its tile loads and the adds of its dB and dC into the
//     slice's rows wait on each other, with no second block to fill the
//     gaps;
//   * the state pass moves its f32 chunk states and their bf16 parts
//     through device memory (~300 MB of traffic at mamba2's shape), and
//     its scan walks the 16 chunks one after another.
//
// bf16: three kernels, every product on wgmma (building blocks in
// hopper.cuh), f32 sums, each gradient rounded once.  Products of two bf16
// inputs (C B^T, dy x^T) are exact; each f32 operand goes in as two bf16
// parts, hi = bf16(v) and lo = bf16(v - hi), one product each: x o wd and
// exp(a_cs) dy, the entering state and the leaving gradient, S o L and dS
// (ref.ssd_bwd_tc_emulated repeats these sums on the CPU; rounding any of
// them to bf16 once breaks the per-entry check, chip_smoke.py's shortcut
// line).  Products whose f32 factor is one per row (dec, dec dt, exp(a_cs)
// of dxdt's, dB's and dC's state terms) take the bf16 input and the parts
// of the state, and scale the accumulator's rows afterwards.
//   1. ssd_bwd_states_tc_kernel, a block per (chunk, head slice, b): each
//      chunk's state (x o wd)^T B and its gradient's share (exp(a_cs)
//      dy)^T C on wgmma (both operands MN-major, as they lie), every chunk
//      at once, to f32 scratch.
//   2. ssd_bwd_scan_kernel: the two recurrences across chunks, state by
//      state entry, forward from h0 and backward from the final state's
//      gradient; it writes each chunk's entering state and leaving
//      gradient as bf16 parts (TMA-ready, (P, N) a head), their product
//      by slab of entries, and dh0.  The state pass is kernels 1 and 2,
//      apart from the chunk pass: a chunk's gradients need the states of
//      every earlier chunk and the gradients of every later one, a
//      dependency across the whole grid; the states of all chunks are
//      formed in parallel on the tensor cores and only the elementwise
//      scan runs chunk after chunk.
//   3. ssd_bwd_chunk_tc_kernel, a block per (chunk, slice of HS heads of
//      one group, b): B and C of the chunk by TMA once; per head x, dy and
//      the state parts by TMA, S^T = B C^T and G^T = x dy^T (rows j), S o
//      L and dS packed from the accumulators as the register A operand of
//      dxdt's (S o L)^T dy and dB's dS^T C; then G = dy x^T (rows i) for
//      dC's dS B; warp 0 scans the log-decay and reverse-cumsums d a_cs.
//      HS is the fewest heads that keep the grid within one block an SM
//      (8 of mamba2's 32 heads, 16 of zamba2's 64 at the training shape),
//      so B and C are loaded once for HS heads (the scores are formed
//      again a head: kept, they would take 64 more registers a thread),
//      and the f32 dB, dC scratch is (Bb, S, H / HS, N): each head slice
//      adds its heads' terms into its own rows, in head order, the same
//      thread for an entry every head (a batch of loads issued before any
//      add, so their round trips overlap).
// Deterministic sums: no floating-point atomics.  A block adds its sums in
// a fixed order (per thread, shuffles down a warp, the warps in order).  A
// block counts itself done on an integer counter of its (b, chunk, group)
// and of its head slice (atomicAdd on ints, after a __threadfence); the
// block that finishes last of a (b, chunk, group) adds the group's slices'
// dB and dC in slice order, and the last of a slice its heads' dA and dD
// over (b, chunk) in order.  Which block is last varies from run to run;
// the order of every sum does not.
//
// float32 (the checks and the f32 parity arms): the first port's two
// kernels on the CUDA cores, f32 products throughout (TF32 would not meet
// the f32 checks).  Their log-decay a_cs is a float64 cumsum, and every
// exponent (L's a_cs[i] - a_cs[j], dec's, exp(a_cs)) is taken of a float64
// difference: at dt ~ 0.8 a chunk's a_cs reaches ~-100, where an f32 a_cs
// holds each difference only to ~1e-5 absolute, a relative error of L that
// put ddt beyond the f32 per-entry rule against the exact gradient (1.4x
// at zamba2's training shape on an H100).
//   1. ssd_bwd_state_kernel, a block per (b, h, 16 head dims p), walks the
//      chunks forward from h0 and writes the state entering each chunk
//      (h_prev, Bb x nc x H x P x N f32), then backward from the final
//      state's gradient and writes the gradient leaving each chunk
//      (dh_next), ending at dh0.
//   2. ssd_bwd_chunk_kernel, a block per (chunk, h, b): it stages B and C
//      (f32) and forms S o L, then in turn dxdt (writing dx and x . dxdt),
//      dS over S o L (the d a_cs row and column sums), dC and dB, staging
//      dh_next, x dt and h_prev in one reused region of shared memory.
//      dB and dC are written per head into f32 scratch and added over the
//      group's heads by the last block, as above.
// Neither path changes the forward kernel (ssd.cu): the serving path pays
// nothing for training.
// Contract: P a multiple of 16 up to 128, N a multiple of 32 up to 128,
// any chunk Q from 1 to 128 that divides S, float32 or bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PS = 16;                    // kernel 1: head dims per block
constexpr int QMAX = 128;
constexpr int NMAX = 128;
constexpr int PMAX = 128;
constexpr int PK = PS / WARPS;            // kernel 1: p rows per thread
constexpr int MMAX = NMAX / 32;           // n columns per lane
constexpr int KMAX = PMAX / 32;           // p columns per lane

__host__ __device__ inline int padded_rows(int Q) { return (Q + 3) / 4 * 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive cumsum of A dt over rows [0, Q) into acs in float64, by warp
// 0 (the f32 kernels' log-decay): each lane sums a run of rows, the
// lanes' totals are scanned with shuffles (as ssd.cu)
__device__ __forceinline__ void scan_rows_f64(const float* dts, float Ah, double* acs,
                                              int Q, int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  double run = 0.0;
  for (int i = lo; i < hi; ++i) {
    run += (double)Ah * (double)dts[i];
    acs[i] = run;
  }
  double tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += v;
  }
  // the lanes before this one's run: the previous lane's inclusive
  // total, so a row's a_cs sums the rows up to it and no later one
  // (tot - run rounds with the run's later rows: an output would
  // depend on later inputs in its last bits)
  double before = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) before = 0.0;
  for (int i = lo; i < hi; ++i) acs[i] += before;
}

// exp of a float64 log-decay difference, the exponent rounded once
__device__ __forceinline__ float exp_f64(double v) { return expf((float)v); }

// the sum of every thread's v in a fixed order; red holds WARPS floats
__device__ float block_sum(float v, float* red, int tid) {
  v = warp_sum(v);
  __syncthreads();
  if (tid % 32 == 0) red[tid / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

struct Args {
  const void *x, *dt, *B, *C, *dy;   // float32, as every tensor here
  const float *A, *D, *h0, *dstate;  // D, h0, dstate may be null
  void *dx, *ddt, *dB, *dC;
  float *dA, *dD, *dh0;              // dD, dh0 written iff D, h0 given
  float *hprev, *dhnext;             // (Bb, nc, H, P, N)
  float *dBh, *dCh;                  // (Bb, S, H, N): per-head dB, dC
  float *dA_part, *dD_part;          // (Bb nc, H)
  int* counters;                     // Bb nc G + H, zero at the launch
  int Bb, S, H, P, G, N, Q;
};

// ---------------------------------------------------------------------------
// 1. the states entering each chunk and the gradients leaving it
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t state_smem_floats(int Q, int N) {
  const size_t Qp = padded_rows(Q);
  return 2 * Qp + Qp * (N + 1) + Qp * PS + (size_t)PS * (N + 1) + 2 * Qp;
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_state_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, N = a.N, P = a.P, H = a.H, S = a.S, G = a.G;
  const int Qp = padded_rows(Q), ldn = N + 1, nc = S / Q;
  double* acs = reinterpret_cast<double*>(sm);   // Qp: a_cs, float64
  float* Vs = sm + 2 * Qp;         // Qp x ldn: B (forward), C (backward)
  float* Xs = Vs + Qp * ldn;       // Qp x PS: x (forward), dy (backward)
  float* St = Xs + Qp * PS;        // PS x ldn
  float* dts = St + PS * ldn;
  float* ws = dts + Qp;

  const int b = blockIdx.x, h = blockIdx.y, p0 = blockIdx.z * PS;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float Ah = a.A[h];
  const float* x = static_cast<const float*>(a.x);
  const float* dt = static_cast<const float*>(a.dt);
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;

  for (int i = tid; i < PS * N; i += THREADS)
    St[(i / N) * ldn + i % N] = a.h0 != nullptr ? a.h0[state_base + i] : 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const float* V = static_cast<const float*>(pass == 0 ? a.B : a.C);
    const float* X = pass == 0 ? x : static_cast<const float*>(a.dy);
    float* out = pass == 0 ? a.hprev : a.dhnext;
    if (pass == 1) {
      __syncthreads();
      for (int i = tid; i < PS * N; i += THREADS)
        St[(i / N) * ldn + i % N] = a.dstate != nullptr ? a.dstate[state_base + i] : 0.f;
    }
    for (int t = 0; t < nc; ++t) {
      const int c = pass == 0 ? t : nc - 1 - t;
      const int s0 = c * Q;
      for (int i = tid; i < Qp; i += THREADS)
        dts[i] = i < Q ? dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
      for (int i = tid; i < Qp * N; i += THREADS) {
        const int q = i / N, n = i % N;
        Vs[q * ldn + n] = q < Q ? V[(((size_t)b * S + s0 + q) * G + g) * N + n] : 0.f;
      }
      for (int i = tid; i < Qp * PS; i += THREADS) {
        const int q = i / PS, p = i % PS;
        Xs[i] = q < Q ? X[(((size_t)b * S + s0 + q) * H + h) * P + p0 + p] : 0.f;
      }
      __syncthreads();
      if (warp == 0) scan_rows_f64(dts, Ah, acs, Q, lane);
      __syncthreads();
      const double a_last = acs[Q - 1];
      // forward: x's weight dt exp(a_last - a_cs); backward: dy's exp(a_cs)
      for (int i = tid; i < Qp; i += THREADS)
        ws[i] = i >= Q ? 0.f : pass == 0 ? dts[i] * exp_f64(a_last - acs[i]) : exp_f64(acs[i]);
      // the state entering chunk c (forward) or the gradient leaving it
      const size_t out_base = ((((size_t)b * nc + c) * H + h) * P + p0) * N;
      for (int i = tid; i < PS * N; i += THREADS) out[out_base + i] = St[(i / N) * ldn + i % N];
      __syncthreads();
      // St[p][n] = St[p][n] exp(a_last) + sum_j X[j][p] ws[j] V[j][n];
      // thread (p = warp + 8 k, n = lane + 32 m)
      const int nm = N / 32;
      float acc[PK][MMAX];
#pragma unroll
      for (int k = 0; k < PK; ++k)
#pragma unroll
        for (int m = 0; m < MMAX; ++m) acc[k][m] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float w = ws[j];
        float xw[PK];
#pragma unroll
        for (int k = 0; k < PK; ++k) xw[k] = Xs[j * PS + warp + WARPS * k] * w;
#pragma unroll
        for (int m = 0; m < MMAX; ++m)
          if (m < nm) {
            const float v = Vs[j * ldn + lane + 32 * m];
#pragma unroll
            for (int k = 0; k < PK; ++k) acc[k][m] = fmaf(xw[k], v, acc[k][m]);
          }
      }
      const float decay = exp_f64(a_last);
#pragma unroll
      for (int k = 0; k < PK; ++k)
#pragma unroll
        for (int m = 0; m < MMAX; ++m)
          if (m < nm) {
            float* s = St + (warp + WARPS * k) * ldn + lane + 32 * m;
            *s = *s * decay + acc[k][m];
          }
      __syncthreads();
    }
  }
  if (a.dh0 != nullptr)
    for (int i = tid; i < PS * N; i += THREADS) a.dh0[state_base + i] = St[(i / N) * ldn + i % N];
}

// ---------------------------------------------------------------------------
// 2. every chunk's gradients
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t chunk_smem_floats(int Q, int P, int N) {
  const size_t Qp = padded_rows(Q);
  const size_t rows2 = Qp > (size_t)P ? Qp : P;
  const size_t ldr = (N > P ? N : P) + 1;
  return 2 * Qp + Qp * (N + 1) + rows2 * ldr + Qp * (Qp + 1) + 8 * Qp + WARPS * Qp + WARPS;
}

__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, N = a.N, P = a.P, H = a.H, S = a.S, G = a.G;
  const int Qp = padded_rows(Q), ldn = N + 1, ldm = Qp + 1;
  const int ldr = max(N, P) + 1, rows2 = max(Qp, P);
  double* acs = reinterpret_cast<double*>(sm);   // Qp: a_cs, float64
  float* Bs = sm + 2 * Qp;         // Qp x ldn: B, then C
  float* R2 = Bs + Qp * ldn;       // rows2 x ldr: C, dh_next, x dt, h_prev, dh_next
  float* Ms = R2 + rows2 * ldr;    // Qp x ldm: S o L, then dS
  float* dts = Ms + Qp * ldm;
  float* eas = dts + Qp;           // exp(a_cs)
  float* dec = eas + Qp;           // exp(a_cs[Q-1] - a_cs)
  float* roww = dec + Qp;          // d a_cs from L, rows
  float* colw = roww + Qp;         // ... columns
  float* dda = colw + Qp;          // d a_cs from exp(a_cs) and dec
  float* ddx = dda + Qp;           // x . dxdt
  float* rv = ddx + Qp;            // B_j . (the state's dB_j)
  float* colpart = rv + Qp;        // WARPS x Qp
  float* red = colpart + WARPS * Qp;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q, s0 = c * Q, rep = H / G, g = h / rep;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nm = N / 32, kp = (P + 31) / 32;
  const float Ah = a.A[h];
  const float Dh = a.D != nullptr ? a.D[h] : 0.f;
  const float* x = static_cast<const float*>(a.x);
  const float* dy = static_cast<const float*>(a.dy);
  const float* Bm = static_cast<const float*>(a.B);
  const float* Cm = static_cast<const float*>(a.C);
  const float* dt = static_cast<const float*>(a.dt);
  float* dx = static_cast<float*>(a.dx);
  auto row_hp = [&](int i) { return (((size_t)b * S + s0 + i) * H + h); };   // x, dy rows
  auto row_gn = [&](int i) { return (((size_t)b * S + s0 + i) * G + g) * N; };
  const size_t st_base = (((size_t)b * nc + c) * H + h) * (size_t)P * N;

  // 0. dt, the log-decay, B and C
  for (int i = tid; i < Qp; i += THREADS) {
    dts[i] = i < Q ? dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
    roww[i] = colw[i] = dda[i] = ddx[i] = rv[i] = 0.f;
  }
  for (int i = tid; i < Qp * N; i += THREADS) {
    const int q = i / N, n = i % N;
    Bs[q * ldn + n] = q < Q ? Bm[row_gn(q) + n] : 0.f;
    R2[q * ldr + n] = q < Q ? Cm[row_gn(q) + n] : 0.f;
  }
  __syncthreads();
  if (warp == 0) scan_rows_f64(dts, Ah, acs, Q, lane);
  __syncthreads();
  const double a_last = acs[Q - 1];
  for (int i = tid; i < Qp; i += THREADS) {
    eas[i] = i < Q ? exp_f64(acs[i]) : 0.f;
    dec[i] = i < Q ? exp_f64(a_last - acs[i]) : 0.f;
  }

  // 1. Ms[i][j] = (C_i . B_j) L_ij for j <= i < Q, zero elsewhere: 4-row
  //    strips taken by the warps in turn, lane covers j = lane + 32 cc
  for (int i0 = warp * 4; i0 < Qp; i0 += WARPS * 4) {
    const int cmax = min(i0 + 3, Q - 1) / 32;
    float acc[4][QMAX / 32];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < QMAX / 32; ++cc) acc[r][cc] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = R2[(i0 + r) * ldr + n];
#pragma unroll
      for (int cc = 0; cc < QMAX / 32; ++cc)
        if (cc <= cmax) {
          const float bv = Bs[min(lane + 32 * cc, Qp - 1) * ldn + n];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(cv[r], bv, acc[r][cc]);
        }
    }
#pragma unroll
    for (int cc = 0; cc < QMAX / 32; ++cc) {
      const int j = lane + 32 * cc;
      if (j < Qp)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r;
          Ms[i * ldm + j] = (i < Q && j <= i) ? acc[r][cc] * exp_f64(acs[i] - acs[j]) : 0.f;
        }
    }
  }
  __syncthreads();

  // 2. dxdt_j = sum_{i>=j} Ms[i][j] dy_i + dec_j (dh_next B_j); dx and
  //    x . dxdt; warp w takes rows j0 = 4 (w + 8 t) .. + 3, lane p = lane + 32 k
  for (int i = tid; i < P * N; i += THREADS) R2[(i / N) * ldr + i % N] = a.dhnext[st_base + i];
  __syncthreads();
  float dd = 0.f;   // this thread's part of dD
  for (int j0 = 4 * warp; j0 < Q; j0 += 4 * WARPS) {
    float t1[4][KMAX], t2[4][KMAX];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) t1[r][k] = t2[r][k] = 0.f;
    for (int i = j0; i < Q; ++i) {
      float s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r] = Ms[i * ldm + j0 + r];   // zero where j > i
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int p = lane + 32 * k;
        if (k < kp && p < P) {
          const float yv = dy[row_hp(i) * P + p];
#pragma unroll
          for (int r = 0; r < 4; ++r) t1[r][k] = fmaf(s[r], yv, t1[r][k]);
        }
      }
    }
    for (int n = 0; n < N; ++n) {
      float bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bs[(j0 + r) * ldn + n];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int p = lane + 32 * k;
        if (k < kp && p < P) {
          const float hv = R2[p * ldr + n];
#pragma unroll
          for (int r = 0; r < 4; ++r) t2[r][k] = fmaf(hv, bv[r], t2[r][k]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      if (j < Q) {   // the same for the whole warp
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const int p = lane + 32 * k;
          if (k < kp && p < P) {
            const float dxdt = t1[r][k] + dec[j] * t2[r][k];
            const size_t o = row_hp(j) * P + p;
            const float xv = x[o], yv = dy[o];
            dx[o] = dts[j] * dxdt + Dh * yv;
            part = fmaf(xv, dxdt, part);
            dd = fmaf(yv, xv, dd);
          }
        }
        part = warp_sum(part);
        if (lane == 0) ddx[j] = part;
      }
    }
  }
  __syncthreads();

  // 3. dS_ij = L_ij G_ij, G_ij = dy_i . x_j dt_j, and W_ij = Ms[i][j] G_ij
  //    (d a_cs: + row sums, - column sums); Ms becomes dS.  x dt staged.
  for (int i = tid; i < Qp * P; i += THREADS) {
    const int q = i / P, p = i % P;
    R2[q * ldr + p] = q < Q ? x[row_hp(q) * P + p] * dts[q] : 0.f;
  }
  __syncthreads();
  {
    float colacc[QMAX / 32];
#pragma unroll
    for (int cc = 0; cc < QMAX / 32; ++cc) colacc[cc] = 0.f;
    for (int i0 = warp * 4; i0 < Qp; i0 += WARPS * 4) {
      const int cmax = min(i0 + 3, Q - 1) / 32;
      float acc[4][QMAX / 32];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < QMAX / 32; ++cc) acc[r][cc] = 0.f;
      for (int p = 0; p < P; ++p) {
        float yv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) yv[r] = i0 + r < Q ? dy[row_hp(i0 + r) * P + p] : 0.f;
#pragma unroll
        for (int cc = 0; cc < QMAX / 32; ++cc)
          if (cc <= cmax) {
            const float xv = R2[min(lane + 32 * cc, Qp - 1) * ldr + p];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(yv[r], xv, acc[r][cc]);
          }
      }
      float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int cc = 0; cc < QMAX / 32; ++cc) {
        const int j = lane + 32 * cc;
        if (cc <= cmax)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            if (i < Q && j <= i) {
              const float gij = acc[r][cc];
              const float w = Ms[i * ldm + j] * gij;
              Ms[i * ldm + j] = exp_f64(acs[i] - acs[j]) * gij;
              rs[r] += w;
              colacc[cc] += w;
            }
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = warp_sum(rs[r]);
        if (lane == 0 && i0 + r < Q) roww[i0 + r] = v;
      }
    }
#pragma unroll
    for (int cc = 0; cc < QMAX / 32; ++cc) {
      const int j = lane + 32 * cc;
      if (j < Qp) colpart[warp * Qp + j] = colacc[cc];
    }
  }
  __syncthreads();
  for (int j = tid; j < Qp; j += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += colpart[w * Qp + j];
    colw[j] = s;
  }

  // 4. dC_i = sum_{j<=i} dS_ij B_j + exp(a_cs_i) dy_i h_prev (per head, to
  //    scratch) and d a_cs_i += C_i . (the second term); rows i0 .. + 3 a
  //    warp, lane n = lane + 32 m.  h_prev staged.
  for (int i = tid; i < P * N; i += THREADS) R2[(i / N) * ldr + i % N] = a.hprev[st_base + i];
  __syncthreads();
  for (int i0 = 4 * warp; i0 < Q; i0 += 4 * WARPS) {
    float acc1[4][MMAX], acc2[4][MMAX];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < MMAX; ++m) acc1[r][m] = acc2[r][m] = 0.f;
    const int imax = min(i0 + 3, Q - 1);
    for (int j = 0; j <= imax; ++j) {
      float s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r] = Ms[(i0 + r) * ldm + j];   // zero where j > i
#pragma unroll
      for (int m = 0; m < MMAX; ++m)
        if (m < nm) {
          const float bv = Bs[j * ldn + lane + 32 * m];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc1[r][m] = fmaf(s[r], bv, acc1[r][m]);
        }
    }
    for (int p = 0; p < P; ++p) {
      float yv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = i0 + r < Q ? dy[row_hp(i0 + r) * P + p] : 0.f;
#pragma unroll
      for (int m = 0; m < MMAX; ++m)
        if (m < nm) {
          const float hv = R2[p * ldr + lane + 32 * m];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc2[r][m] = fmaf(yv[r], hv, acc2[r][m]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      if (i < Q) {
        float part = 0.f;
#pragma unroll
        for (int m = 0; m < MMAX; ++m)
          if (m < nm) {
            const int n = lane + 32 * m;
            const float off = eas[i] * acc2[r][m];
            a.dCh[row_hp(i) * N + n] = acc1[r][m] + off;
            part = fmaf(Cm[row_gn(i) + n], off, part);
          }
        part = warp_sum(part);
        if (lane == 0) dda[i] += part;
      }
    }
  }
  __syncthreads();

  // 5. dB_j = sum_{i>=j} dS_ij C_i + dec_j dt_j x_j dh_next (per head, to
  //    scratch); r_j = B_j . (the second term) enters d a_cs at j (-) and
  //    at Q-1 (+).  C and dh_next staged.
  for (int i = tid; i < Qp * N; i += THREADS) {
    const int q = i / N, n = i % N;
    Bs[q * ldn + n] = q < Q ? Cm[row_gn(q) + n] : 0.f;
  }
  for (int i = tid; i < P * N; i += THREADS) R2[(i / N) * ldr + i % N] = a.dhnext[st_base + i];
  __syncthreads();
  float hd = 0.f;   // this thread's part of <h_prev, dh_next>
  for (int i = tid; i < P * N; i += THREADS)
    hd = fmaf(a.hprev[st_base + i], R2[(i / N) * ldr + i % N], hd);
  for (int j0 = 4 * warp; j0 < Q; j0 += 4 * WARPS) {
    float acc1[4][MMAX], acc2[4][MMAX];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < MMAX; ++m) acc1[r][m] = acc2[r][m] = 0.f;
    for (int i = j0; i < Q; ++i) {
      float s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r] = Ms[i * ldm + j0 + r];   // zero where j > i
#pragma unroll
      for (int m = 0; m < MMAX; ++m)
        if (m < nm) {
          const float cv = Bs[i * ldn + lane + 32 * m];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc1[r][m] = fmaf(s[r], cv, acc1[r][m]);
        }
    }
    for (int p = 0; p < P; ++p) {
      float xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = j0 + r < Q ? x[row_hp(j0 + r) * P + p] : 0.f;
#pragma unroll
      for (int m = 0; m < MMAX; ++m)
        if (m < nm) {
          const float dv = R2[p * ldr + lane + 32 * m];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc2[r][m] = fmaf(xv[r], dv, acc2[r][m]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      if (j < Q) {
        float part = 0.f;
#pragma unroll
        for (int m = 0; m < MMAX; ++m)
          if (m < nm) {
            const int n = lane + 32 * m;
            const float bst = dec[j] * dts[j] * acc2[r][m];
            a.dBh[row_hp(j) * N + n] = acc1[r][m] + bst;
            part = fmaf(Bm[row_gn(j) + n], bst, part);
          }
        part = warp_sum(part);
        if (lane == 0) {
          rv[j] = part;
          dda[j] -= part;
        }
      }
    }
  }
  const float dd_sum = block_sum(dd, red, tid);
  const float hd_sum = block_sum(hd, red, tid);   // its first barrier orders rv, dda

  // 6. d a_cs, its reverse cumsum d a, ddt and this block's dA (thread 0,
  //    rows in descending order)
  if (tid == 0) {
    float rsum = 0.f;
    for (int j = 0; j < Q; ++j) rsum += rv[j];
    float da = 0.f, dA = 0.f;
    float* ddt = static_cast<float*>(a.ddt);
    for (int k = Q - 1; k >= 0; --k) {
      float dacs = roww[k] - colw[k] + dda[k];
      if (k == Q - 1) dacs += rsum + exp_f64(a_last) * hd_sum;
      da += dacs;
      ddt[((size_t)b * S + s0 + k) * H + h] = ddx[k] + Ah * da;
      dA = fmaf(dts[k], da, dA);
    }
    a.dA_part[((size_t)b * nc + c) * H + h] = dA;
    a.dD_part[((size_t)b * nc + c) * H + h] = dd_sum;
  }

  // 7. the last block of a (b, chunk, group) sums its heads' dB and dC, the
  //    last of a head its (b, chunk) dA and dD, each in a fixed order
  __shared__ int last_group, last_head;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_group = atomicAdd(&a.counters[((size_t)b * nc + c) * G + g], 1) == rep - 1;
    last_head = atomicAdd(&a.counters[(size_t)a.Bb * nc * G + h], 1) == a.Bb * nc - 1;
  }
  __syncthreads();
  if (last_group) {
    __threadfence();
    float* dB = static_cast<float*>(a.dB);
    float* dC = static_cast<float*>(a.dC);
    for (int i = tid; i < Q * N; i += THREADS) {
      const int q = i / N, n = i % N;
      const size_t base = (((size_t)b * S + s0 + q) * H + (size_t)g * rep) * N + n;
      float sb = 0.f, sc = 0.f;
      for (int r = 0; r < rep; ++r) {
        sb += __ldcg(a.dBh + base + (size_t)r * N);
        sc += __ldcg(a.dCh + base + (size_t)r * N);
      }
      dB[row_gn(q) + n] = sb;
      dC[row_gn(q) + n] = sc;
    }
  }
  if (last_head && tid == 0) {
    __threadfence();
    float sa = 0.f, sd = 0.f;
    for (int bc = 0; bc < a.Bb * nc; ++bc) {
      sa += __ldcg(a.dA_part + (size_t)bc * H + h);
      sd += __ldcg(a.dD_part + (size_t)bc * H + h);
    }
    a.dA[h] = sa;
    if (a.dD != nullptr) a.dD[h] = sd;
  }
}

cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  auto k1 = ssd_bwd_state_kernel;
  auto k2 = ssd_bwd_chunk_kernel;
  static bool configured = false;   // above 48 KB only after opting in (one card)
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(state_smem_floats(QMAX, NMAX) * sizeof(float)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(chunk_smem_floats(QMAX, PMAX, NMAX) * sizeof(float)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nc = a.S / a.Q;
  k1<<<dim3(a.Bb, a.H, a.P / PS), THREADS, state_smem_floats(a.Q, a.N) * sizeof(float),
       stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k2<<<dim3(nc, a.H, a.Bb), THREADS, chunk_smem_floats(a.Q, a.P, a.N) * sizeof(float),
       stream>>>(a);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TQ = 128;             // rows of a chunk's tile (rows past Q masked)
constexpr int TC_THREADS = 256;     // two warpgroups, 64 rows of the tile each
constexpr int SCAN_SLAB = 1024;     // state entries a block of the scan
constexpr int MAX_SLABS = PMAX * NMAX / SCAN_SLAB;

struct TcArgs {
  const __nv_bfloat16 *x, *dt, *B, *C, *dy;
  const float *A, *D, *h0, *dstate;   // D, h0, dstate may be null
  __nv_bfloat16 *dx, *ddt, *dB, *dC;
  float *dA, *dD, *dh0;               // dD, dh0 written iff D, h0 given
  float *states, *ustates;            // (Bb nc H, P, N): each chunk's (x o wd)^T B, (e^a dy)^T C
  __nv_bfloat16* parts;               // (4, Bb nc H, P, N): h_prev hi, lo; dh_next hi, lo
  float *dBp, *dCp;                   // (Bb, S, H / HS, N): each head slice's dB, dC
  float* hd_part;                     // (Bb nc H, MAX_SLABS): <h_prev, dh_next> by slab
  float* alast;                       // (Bb nc H): a_cs[Q-1]
  float *dA_part, *dD_part;           // (Bb nc, H)
  int* counters;                      // Bb nc G + H / HS, zero at the launch
  int Bb, S, H, P, G, N, Q, HS;
};

// warp 0: the chunk's dt (rows < Q, zero past Q) into dts and the inclusive
// cumsum of A dt into acs (as ssd.cu's tensor-core kernel: a run of rows a
// lane, the runs' totals scanned with shuffles, so a row's sum holds no
// later row; rows past Q hold a_cs[Q-1]); returns a_cs[Q-1] to every lane
__device__ __forceinline__ float tc_scan(const __nv_bfloat16* dt, int stride, int Q, float Ah,
                                         float* dts, float* acs, int lane) {
  constexpr int PER = TQ / 32;
  float d[PER], cs[PER], run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k;
    d[k] = i < Q ? __bfloat162float(dt[(size_t)i * stride]) : 0.f;
    run += Ah * d[k];
    cs[k] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += v;
  }
  float before = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) before = 0.f;
  float mine = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lane * PER + k == Q - 1) mine = cs[k] + before;
  const float a_last = __shfl_sync(0xffffffffu, mine, (Q - 1) / PER);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = lane * PER + k;
    dts[i] = d[k];
    acs[i] = i < Q ? cs[k] + before : a_last;
  }
  return a_last;
}

// The bf16 pair at (row r, columns col, col + 1) of a rows x D tile in
// hopper.cuh's layout (col even), widened
template <int D>
__device__ __forceinline__ float2 tile_pair(const __nv_bfloat16* tile, int rows, int r, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      reinterpret_cast<const unsigned char*>(tile) + swizzled_byte<D>(rows, r, col / 8) +
      2 * (col % 8)));
}

// sum over the 4 lanes of a quad (the lanes holding one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- 1. each chunk's state products ---------------------------------------

template <int PT, int NT>
struct StatesLayout {
  static constexpr uint32_t BC = TQ * NT * 2;   // a B or C tile
  static constexpr uint32_t XP = TQ * PT * 2;   // one part of x o wd or e^a dy
  static constexpr size_t bytes = 2 * (size_t)BC + 4 * XP + 4 * TQ * 4 + 8 + 1024;
};

// A block per (chunk, slice of HS heads of one group, b): B and C of the
// chunk by TMA once; per head x o wd and exp(a_cs) dy as two bf16 parts
// each, then warpgroup 0 the chunk's state (x o wd)^T B and warpgroup 1
// its gradient's share (exp(a_cs) dy)^T C (P x N, f32), both operands
// MN-major; written to scratch with the chunk's a_cs[Q-1].
template <int PT, int NT>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_bwd_states_tc_kernel(const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap c_map, TcArgs a) {
  using bf16 = __nv_bfloat16;
  using L = StatesLayout<PT, NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* Bt = reinterpret_cast<bf16*>(base);
  bf16* Ct = reinterpret_cast<bf16*>(base + L::BC);
  bf16* xw_hi = reinterpret_cast<bf16*>(base + 2 * L::BC);
  bf16* xw_lo = xw_hi + TQ * PT;
  bf16* ey_hi = xw_lo + TQ * PT;
  bf16* ey_lo = ey_hi + TQ * PT;
  float* dts = reinterpret_cast<float*>(ey_lo + TQ * PT);
  float* acs = dts + TQ;
  float* wds = acs + TQ;   // dt exp(a_cs[Q-1] - a_cs), zero past Q
  float* eas = wds + TQ;   // exp(a_cs), zero past Q
  uint64_t* bar = reinterpret_cast<uint64_t*>(eas + TQ);

  const int c = blockIdx.x, h_first = blockIdx.y * a.HS, b = blockIdx.z;
  const int Q = a.Q, S = a.S, H = a.H, P = a.P, N = a.N, nc = S / Q;
  const int g = h_first / (H / a.G);
  const int tid = threadIdx.x, wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4, gq = lane / 4;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect(bar, 2 * L::BC);
#pragma unroll
    for (int box = 0; box < NT / 64; ++box) {
      tma_load(Bt + box * TQ * 64, &b_map, bar, 64 * box, g, c * Q, b);
      tma_load(Ct + box * TQ * 64, &c_map, bar, 64 * box, g, c * Q, b);
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);

  for (int hh = 0; hh < a.HS; ++hh) {
    const int h = h_first + hh;
    const size_t idx = ((size_t)b * nc + c) * H + h;
    const size_t row0 = ((size_t)b * S + (size_t)c * Q) * H + h;   // (b, c Q, h)
    if (tid < 32) {
      const float a_last = tc_scan(a.dt + row0, H, Q, a.A[h], dts, acs, lane);
      __syncwarp();
      for (int i = lane; i < TQ; i += 32) {
        wds[i] = i < Q ? dts[i] * expf(a_last - acs[i]) : 0.f;
        eas[i] = i < Q ? expf(acs[i]) : 0.f;
      }
      if (lane == 0) a.alast[idx] = a_last;
    }
    __syncthreads();
    // x o wd and exp(a_cs) dy as two bf16 parts, 8 columns a step, in the
    // tiles' layout (rows past Q and columns past P zero)
    for (int k = tid; k < TQ * PT / 8; k += TC_THREADS) {
      const int q = k / (PT / 8), cc = k % (PT / 8);
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv;
      if (q < Q && 8 * cc < P) {
        const size_t o = (row0 + (size_t)q * H) * P + 8 * cc;
        xv = *reinterpret_cast<const uint4*>(a.x + o);
        yv = *reinterpret_cast<const uint4*>(a.dy + o);
      }
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv);
      const float wq = wds[q], eq = eas[q];
      uint32_t xh[4], xl[4], yh[4], yl[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 xf = __bfloat1622float2(xp[u]), yf = __bfloat1622float2(yp[u]);
        split_pack(xf.x * wq, xf.y * wq, xh[u], xl[u]);
        split_pack(yf.x * eq, yf.y * eq, yh[u], yl[u]);
      }
      const uint32_t off = swizzled_byte<PT>(TQ, q, cc);
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xw_hi) + off) =
          make_uint4(xh[0], xh[1], xh[2], xh[3]);
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(xw_lo) + off) =
          make_uint4(xl[0], xl[1], xl[2], xl[3]);
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(ey_hi) + off) =
          make_uint4(yh[0], yh[1], yh[2], yh[3]);
      *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(ey_lo) + off) =
          make_uint4(yl[0], yl[1], yl[2], yl[3]);
    }
    fence_proxy_async();
    __syncthreads();

    // warpgroup 0: (x o wd)^T B; warpgroup 1: (e^a dy)^T C; 64 rows p a pass
    const bf16* hi = wg == 0 ? xw_hi : ey_hi;
    const bf16* lo = wg == 0 ? xw_lo : ey_lo;
    const bf16* V = wg == 0 ? Bt : Ct;
    float* out = (wg == 0 ? a.states : a.ustates) + idx * P * N;
    const int ksteps = (Q + 15) / 16;   // rows past Q are zero in both parts
#pragma unroll
    for (int pb = 0; pb < PT / 64; ++pb) {
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      reg_fence(acc);
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint64_t dv = mnmajor_desc<NT>(V, TQ, kk);
        wgmma_ss_mn(acc, mnmajor_desc<64>(hi + pb * TQ * 64, TQ, kk), dv, 1);
        wgmma_ss_mn(acc, mnmajor_desc<64>(lo + pb * TQ * 64, TQ, kk), dv, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      // acc[4j + 2i + e] = out[p = 64 pb + 16 w + gq + 8 i][n = 8 j + 2 t + e]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = 64 * pb + 16 * w + gq + 8 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
          const int n = 8 * j + 2 * t;
          if (n < N)
            *reinterpret_cast<float2*>(out + (size_t)p * N + n) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
    __syncthreads();   // the parts are read before the next head's are stored
  }
}

// ---- 2. the scans across chunks -------------------------------------------

// hi and lo bf16 parts of four floats, as two 8-byte words
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& lo) {
  split_pack(v.x, v.y, hi.x, lo.x);
  split_pack(v.z, v.w, hi.y, lo.y);
}

__device__ __forceinline__ float4 widen4(uint2 hi, uint2 lo) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi.y));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.x));
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo.y));
  return make_float4(a.x + c.x, a.y + c.y, b.x + d.x, b.y + d.y);
}

// A block per (slab of 1024 state entries, h, b), four entries a thread:
// forward from h0, the state entering each chunk (its two parts) and
// state = state e^{a_cs[Q-1]} + the chunk's; backward from the final
// state's gradient, the gradient leaving each chunk (its two parts), its
// product with the entering state's parts (summed over the slab in a
// fixed order) and dh = dh e^{a_cs[Q-1]} + the chunk's share; dh0 at the
// end.
__global__ void __launch_bounds__(TC_THREADS) ssd_bwd_scan_kernel(TcArgs a) {
  __shared__ float red[TC_THREADS / 32];
  const int slab = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int H = a.H, nc = a.S / a.Q, tid = threadIdx.x;
  const size_t PN = (size_t)a.P * a.N, plane = (size_t)a.Bb * nc * H * PN;
  const size_t e0 = (size_t)slab * SCAN_SLAB + 4 * tid;
  const bool on = e0 < PN;
  const size_t state0 = ((size_t)b * H + h) * PN + e0;
  __nv_bfloat16* hp_hi = a.parts;
  __nv_bfloat16* hp_lo = a.parts + plane;
  __nv_bfloat16* dn_hi = a.parts + 2 * plane;
  __nv_bfloat16* dn_lo = a.parts + 3 * plane;

  // each sweep loads the next chunk's operands before it uses this one's
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto at = [&](int c) { return (((size_t)b * nc + c) * H + h) * PN + e0; };
  float4 run = on && a.h0 != nullptr ? *reinterpret_cast<const float4*>(a.h0 + state0) : zero;
  float4 s_next = on ? *reinterpret_cast<const float4*>(a.states + at(0)) : zero;
  float al_next = a.alast[((size_t)b * nc) * H + h];
  for (int c = 0; c < nc; ++c) {
    const size_t o = at(c);
    const float4 s = s_next;
    const float d = expf(al_next);
    if (c + 1 < nc) {
      s_next = on ? *reinterpret_cast<const float4*>(a.states + at(c + 1)) : zero;
      al_next = a.alast[((size_t)b * nc + c + 1) * H + h];
    }
    if (on) {
      uint2 hi, lo;
      split4(run, hi, lo);
      *reinterpret_cast<uint2*>(hp_hi + o) = hi;
      *reinterpret_cast<uint2*>(hp_lo + o) = lo;
      run = make_float4(run.x * d + s.x, run.y * d + s.y, run.z * d + s.z, run.w * d + s.w);
    }
  }
  float4 dr = on && a.dstate != nullptr ? *reinterpret_cast<const float4*>(a.dstate + state0)
                                        : zero;
  auto load_back = [&](int c, float4& u, uint2& hh, uint2& hl, float& al) {
    const size_t o = at(c);
    if (on) {
      u = *reinterpret_cast<const float4*>(a.ustates + o);
      hh = *reinterpret_cast<const uint2*>(hp_hi + o);
      hl = *reinterpret_cast<const uint2*>(hp_lo + o);
    }
    al = a.alast[((size_t)b * nc + c) * H + h];
  };
  float4 u_next = zero;
  uint2 hh_next = make_uint2(0u, 0u), hl_next = hh_next;
  float bl_next;
  load_back(nc - 1, u_next, hh_next, hl_next, bl_next);
  for (int c = nc - 1; c >= 0; --c) {
    const size_t idx = ((size_t)b * nc + c) * H + h, o = at(c);
    const float4 u = u_next;
    const uint2 hh = hh_next, hl = hl_next;
    const float d = expf(bl_next);
    if (c > 0) load_back(c - 1, u_next, hh_next, hl_next, bl_next);
    float hd = 0.f;
    if (on) {
      uint2 hi, lo;
      split4(dr, hi, lo);
      *reinterpret_cast<uint2*>(dn_hi + o) = hi;
      *reinterpret_cast<uint2*>(dn_lo + o) = lo;
      const float4 hv = widen4(hh, hl), dv = widen4(hi, lo);
      hd = hv.x * dv.x + hv.y * dv.y + hv.z * dv.z + hv.w * dv.w;
      dr = make_float4(dr.x * d + u.x, dr.y * d + u.y, dr.z * d + u.z, dr.w * d + u.w);
    }
    hd = block_sum(hd, red, tid);
    if (tid == 0) a.hd_part[idx * MAX_SLABS + slab] = hd;
  }
  if (on && a.dh0 != nullptr) *reinterpret_cast<float4*>(a.dh0 + state0) = dr;
}

// ---- 3. every chunk's gradients -------------------------------------------

template <int PT, int NT>
struct ChunkLayout {
  static constexpr uint32_t BC = TQ * NT * 2;   // a B or C tile
  static constexpr uint32_t XY = TQ * PT * 2;   // an x or dy tile
  static constexpr uint32_t SP = PT * NT * 2;   // one part of a state tile
  static constexpr uint32_t X_OFF = 2 * BC, Y_OFF = X_OFF + XY, HI_OFF = Y_OFF + XY,
                            LO_OFF = HI_OFF + SP, F_OFF = LO_OFF + SP;
  // dts, acs, eas, dec, colw, rv, ddx, dda (TQ each); the row sums of W by
  // warp (8 x TQ); the warps' dD shares (8)
  static constexpr uint32_t NF = 16 * TQ + 8;
  static constexpr uint32_t BAR_OFF = F_OFF + NF * 4;
  static constexpr size_t bytes = BAR_OFF + 3 * 8 + 1024;
};

// A (b, chunk) block's rows r = 64 wg + 16 w + lane / 4 + 8 i of the
// 128-row tile: the entries [4 j + 2 i + e] of an m64 accumulator at
// column 8 j + 2 t + e.  Each S o L / dS entry (f32) as two bf16 parts,
// packed by k-step as wgmma's register A operand.
__device__ __forceinline__ void pack8(const float (&v)[8], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) split_pack(v[2 * u], v[2 * u + 1], hi[u], lo[u]);
}

// rows[r] += acc's rows r (columns 2t, 2t+1 of each 8; the first head
// stores), r = 0, 1, for a thread's two accumulator rows (null: past Q):
// the partials of 8 entry pairs are loaded together before any is added,
// so their round trips overlap
template <int NT>
__device__ __forceinline__ void add_rows(const float (&acc)[NT / 2], float* const (&rows)[2],
                                         int N, int t, bool first) {
#pragma unroll
  for (int q0 = 0; q0 < NT / 4; q0 += 8) {
    float2 o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u, r = q / (NT / 8), n = 8 * (q % (NT / 8)) + 2 * t;
      o[u] = make_float2(0.f, 0.f);
      if (!first && rows[r] != nullptr && n < N)
        o[u] = *reinterpret_cast<const float2*>(rows[r] + n);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u, r = q / (NT / 8), cc = q % (NT / 8), n = 8 * cc + 2 * t;
      if (rows[r] != nullptr && n < N)
        *reinterpret_cast<float2*>(rows[r] + n) =
            make_float2(o[u].x + acc[4 * cc + 2 * r], o[u].y + acc[4 * cc + 2 * r + 1]);
    }
  }
}

// A block per (chunk, slice of HS heads of one group, b).  B and C of the
// chunk by TMA once; per head x, dy and the parts of dh_next by TMA, then
//   phase A (warpgroup rows j): S^T = B C^T and G^T = x dy^T; S o L, dS and
//     W = S o L o G dt (its row and column sums) in registers, the first
//     two packed as two bf16 parts; dxdt = dec (B dh_next^T) + (S o L)^T
//     dy (dx, x . dxdt); dB = dec dt (x dh_next) + dS^T C;
//   the parts of h_prev by TMA into dh_next's place;
//   phase B (warpgroup rows i): G = dy x^T, dS packed; dC = e^a (dy
//     h_prev) + dS B;
//   warp 0: d a_cs, its reverse cumsum, ddt and the head's dA, dD shares.
// dB and dC add over the slice's heads in the slice's f32 scratch rows,
// each entry by one thread in head order.
template <int PT, int NT>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_bwd_chunk_tc_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap y_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map,
                        const __grid_constant__ CUtensorMap parts_map, TcArgs a) {
  using bf16 = __nv_bfloat16;
  using L = ChunkLayout<PT, NT>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last[2];
  unsigned char* base = align1024(smem_raw);
  bf16* Bt = reinterpret_cast<bf16*>(base);
  bf16* Ct = reinterpret_cast<bf16*>(base + L::BC);
  bf16* Xt = reinterpret_cast<bf16*>(base + L::X_OFF);
  bf16* Yt = reinterpret_cast<bf16*>(base + L::Y_OFF);
  bf16* Shi = reinterpret_cast<bf16*>(base + L::HI_OFF);   // dh_next, then h_prev
  bf16* Slo = reinterpret_cast<bf16*>(base + L::LO_OFF);
  float* dts = reinterpret_cast<float*>(base + L::F_OFF);
  float* acs = dts + TQ;
  float* eas = acs + TQ;    // exp(a_cs), zero past Q
  float* dec = eas + TQ;    // exp(a_cs[Q-1] - a_cs), zero past Q
  float* colw = dec + TQ;   // d a_cs from L, columns (-)
  float* rv = colw + TQ;    // B_j . (dB's state term): d a_cs at j (-), at Q-1 (+)
  float* ddx = rv + TQ;     // x . dxdt
  float* dda = ddx + TQ;    // C_i . (dC's state term)
  float* rowp = dda + TQ;   // 8 x TQ: d a_cs from L, rows (+), by warp
  float* ddp = rowp + 8 * TQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::BAR_OFF);   // B/C, head, h_prev

  const int c = blockIdx.x, sl = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, S = a.S, H = a.H, P = a.P, N = a.N, G = a.G, HS = a.HS;
  const int nc = S / Q, rep = H / G, h_first = sl * HS, g = h_first / rep, nsl = H / HS;
  const int tid = threadIdx.x, wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4, gq = lane / 4;
  const int rw[2] = {64 * wg + 16 * w + gq, 64 * wg + 16 * w + gq + 8};   // the thread's rows
  const size_t bc = (size_t)b * nc + c;
  const size_t plane = (size_t)a.Bb * nc * H;
  const int slabs = (P * N + SCAN_SLAB - 1) / SCAN_SLAB;

  auto load_head = [&](int h) {   // x, dy and the parts of dh_next
    mbar_expect(&bars[1], 2 * L::XY + 2 * L::SP);
#pragma unroll
    for (int box = 0; box < PT / 64; ++box) {
      tma_load(Xt + box * TQ * 64, &x_map, &bars[1], 64 * box, h, c * Q, b);
      tma_load(Yt + box * TQ * 64, &y_map, &bars[1], 64 * box, h, c * Q, b);
    }
    const int idx = (int)(bc * H + h);
#pragma unroll
    for (int box = 0; box < NT / 64; ++box) {
      tma_load_3d(Shi + box * PT * 64, &parts_map, &bars[1], 64 * box, 0, (int)(2 * plane) + idx);
      tma_load_3d(Slo + box * PT * 64, &parts_map, &bars[1], 64 * box, 0, (int)(3 * plane) + idx);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    mbar_expect(&bars[0], 2 * L::BC);
#pragma unroll
    for (int box = 0; box < NT / 64; ++box) {
      tma_load(Bt + box * TQ * 64, &b_map, &bars[0], 64 * box, g, c * Q, b);
      tma_load(Ct + box * TQ * 64, &c_map, &bars[0], 64 * box, g, c * Q, b);
    }
    load_head(h_first);
  }
  __syncthreads();
  mbar_wait(&bars[0], 0);

  for (int hh = 0; hh < HS; ++hh) {
    const int h = h_first + hh;
    const size_t idx = bc * H + h;
    const size_t xrow = ((size_t)b * S + (size_t)c * Q) * H + h;   // (b, c Q, h)
    const float Ah = a.A[h], Dh = a.D != nullptr ? a.D[h] : 0.f;
    float hd = 0.f;   // warp 0: <h_prev, dh_next> of the head's chunk
    if (tid < 32) {
      hd = warp_sum(lane < slabs ? a.hd_part[idx * MAX_SLABS + lane] : 0.f);
      const float a_last = tc_scan(a.dt + xrow, H, Q, Ah, dts, acs, lane);
      __syncwarp();
      for (int i = lane; i < TQ; i += 32) {
        eas[i] = i < Q ? expf(acs[i]) : 0.f;
        dec[i] = i < Q ? expf(a_last - acs[i]) : 0.f;
      }
    }
    mbar_wait(&bars[1], hh & 1);
    __syncthreads();   // (1) the scan; the head's tiles have landed

    // ---- phase A: this warpgroup's rows j, columns i ----
    uint32_t slh[8][4], sll[8][4], dsh[8][4], dsl[8][4];
    float aj[2], dj[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      aj[r] = acs[rw[r]];
      dj[r] = dts[rw[r]];
    }
    {
      float s[64], gt[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = gt[i] = 0.f;
      reg_fence(s);
      reg_fence(gt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk)
        wgmma_ss(s, kmajor_desc<NT>(Bt, TQ, 64 * wg, kk), kmajor_desc<NT>(Ct, TQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk)
        wgmma_ss(gt, kmajor_desc<PT>(Xt, TQ, 64 * wg, kk), kmajor_desc<PT>(Yt, TQ, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(gt);
      float cw[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float vs[8], vd[8], rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = (m >> 1) & 1, e = m & 1;
          const int i = 16 * kk + 8 * (m >> 2) + 2 * t + e, j = rw[r];
          const float Lij = j <= i && i < Q ? expf(acs[i] - aj[r]) : 0.f;
          const float slv = s[8 * kk + m] * Lij, gm = gt[8 * kk + m] * dj[r];
          const float wv = slv * gm;
          vs[m] = slv;
          vd[m] = Lij * gm;
          cw[r] += wv;
          rs[m >> 2][e] += wv;
        }
        pack8(vs, slh[kk], sll[kk]);
        pack8(vd, dsh[kk], dsl[kk]);
        // the column sums of W over this warp's 16 rows j
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v = rs[q][e];
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            v += __shfl_xor_sync(0xffffffffu, v, 8);
            v += __shfl_xor_sync(0xffffffffu, v, 16);
            if (gq == 0) rowp[(4 * wg + w) * TQ + 16 * kk + 8 * q + 2 * t + e] = v;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(cw[r]);
        if (t == 0) colw[rw[r]] = v;
      }
    }

    // dxdt = dec (B dh_next^T) + (S o L)^T dy; dx = dt dxdt + D dy
    float dd = 0.f;   // this thread's share of dy . x
    {
      float acc[PT / 2];
#pragma unroll
      for (int i = 0; i < PT / 2; ++i) acc[i] = 0.f;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 16; ++kk) {
        const uint64_t da = kmajor_desc<NT>(Bt, TQ, 64 * wg, kk);
        wgmma_ss(acc, da, kmajor_desc<NT>(Shi, PT, 0, kk), 1);
        wgmma_ss(acc, da, kmajor_desc<NT>(Slo, PT, 0, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int k = 0; k < PT / 2; ++k) acc[k] *= dec[rw[(k >> 1) & 1]];
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk >= 4 * wg) {   // i >= j: the second warpgroup's rows need i >= 64
          const uint64_t db = mnmajor_desc<PT>(Yt, TQ, kk);
          wgmma_rs(acc, slh[kk], db, 1);
          wgmma_rs(acc, sll[kk], db, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = rw[r];
        float px = 0.f;
        if (j < Q) {
          __nv_bfloat16* dxr = a.dx + (xrow + (size_t)j * H) * P;
          const float dtj = dts[j];
#pragma unroll
          for (int cc = 0; cc < PT / 8; ++cc) {
            const int p = 8 * cc + 2 * t;
            if (p >= P) continue;
            const float2 xv = tile_pair<PT>(Xt, TQ, j, p), yv = tile_pair<PT>(Yt, TQ, j, p);
            const float v0 = acc[4 * cc + 2 * r], v1 = acc[4 * cc + 2 * r + 1];
            *reinterpret_cast<__nv_bfloat162*>(dxr + p) =
                __floats2bfloat162_rn(dtj * v0 + Dh * yv.x, dtj * v1 + Dh * yv.y);
            px += xv.x * v0 + xv.y * v1;
            dd += yv.x * xv.x + yv.y * xv.y;
          }
        }
        px = quad_sum(px);
        if (t == 0) ddx[j] = px;
      }
    }
    {
      const float v = warp_sum(dd);
      if (lane == 0) ddp[tid / 32] = v;
    }

    // dB = dec dt (x dh_next) + dS^T C, added into the slice's rows
    {
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) {
        const uint64_t da = kmajor_desc<PT>(Xt, TQ, 64 * wg, kk);
        wgmma_ss_bmn(acc, da, mnmajor_desc<NT>(Shi, PT, kk), 1);
        wgmma_ss_bmn(acc, da, mnmajor_desc<NT>(Slo, PT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = rw[r];
        const float f = dec[j] * dts[j];
        float rr = 0.f;
#pragma unroll
        for (int cc = 0; cc < NT / 8; ++cc) {
          const float2 bv = tile_pair<NT>(Bt, TQ, j, 8 * cc + 2 * t);
          const float v0 = acc[4 * cc + 2 * r] * f, v1 = acc[4 * cc + 2 * r + 1] * f;
          acc[4 * cc + 2 * r] = v0;
          acc[4 * cc + 2 * r + 1] = v1;
          rr += bv.x * v0 + bv.y * v1;
        }
        rr = quad_sum(rr);
        if (t == 0) rv[j] = rr;
      }
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk >= 4 * wg) {
          const uint64_t db = mnmajor_desc<NT>(Ct, TQ, kk);
          wgmma_rs(acc, dsh[kk], db, 1);
          wgmma_rs(acc, dsl[kk], db, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      float* rows[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rows[r] = rw[r] < Q ? a.dBp + (((size_t)b * S + (size_t)c * Q + rw[r]) * nsl + sl) * N
                            : nullptr;
      add_rows<NT>(acc, rows, N, t, hh == 0);
    }
    __syncthreads();   // (2) dh_next is read; colw, rv, ddx, rowp, ddp are written
    if (tid == 0) {
      mbar_expect(&bars[2], 2 * L::SP);
#pragma unroll
      for (int box = 0; box < NT / 64; ++box) {
        tma_load_3d(Shi + box * PT * 64, &parts_map, &bars[2], 64 * box, 0, (int)idx);
        tma_load_3d(Slo + box * PT * 64, &parts_map, &bars[2], 64 * box, 0, (int)(plane + idx));
      }
    }

    // ---- phase B: this warpgroup's rows i, columns j ----
    uint32_t ph[8][4], pl[8][4];
    {
      float gg[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) gg[i] = 0.f;
      reg_fence(gg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk)
        wgmma_ss(gg, kmajor_desc<PT>(Yt, TQ, 64 * wg, kk), kmajor_desc<PT>(Xt, TQ, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(gg);
      float ai[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ai[r] = acs[rw[r]];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        float vd[8];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int r = (m >> 1) & 1, e = m & 1;
          const int j = 16 * kk + 8 * (m >> 2) + 2 * t + e, i = rw[r];
          const float Lij = j <= i && i < Q ? expf(ai[r] - acs[j]) : 0.f;
          vd[m] = Lij * gg[8 * kk + m] * dts[j];
        }
        pack8(vd, ph[kk], pl[kk]);
      }
    }
    mbar_wait(&bars[2], hh & 1);

    // dC = e^a (dy h_prev) + dS B, added into the slice's rows
    {
      float acc[NT / 2];
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PT / 16; ++kk) {
        const uint64_t da = kmajor_desc<PT>(Yt, TQ, 64 * wg, kk);
        wgmma_ss_bmn(acc, da, mnmajor_desc<NT>(Shi, PT, kk), 1);
        wgmma_ss_bmn(acc, da, mnmajor_desc<NT>(Slo, PT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = rw[r];
        const float f = eas[i];
        float cr = 0.f;
#pragma unroll
        for (int cc = 0; cc < NT / 8; ++cc) {
          const float2 cv = tile_pair<NT>(Ct, TQ, i, 8 * cc + 2 * t);
          const float v0 = acc[4 * cc + 2 * r] * f, v1 = acc[4 * cc + 2 * r + 1] * f;
          acc[4 * cc + 2 * r] = v0;
          acc[4 * cc + 2 * r + 1] = v1;
          cr += cv.x * v0 + cv.y * v1;
        }
        cr = quad_sum(cr);
        if (t == 0) dda[i] = cr;
      }
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk < 4 * (wg + 1)) {   // j <= i: the first warpgroup's rows need j < 64
          const uint64_t db = mnmajor_desc<NT>(Bt, TQ, kk);
          wgmma_rs(acc, ph[kk], db, 1);
          wgmma_rs(acc, pl[kk], db, 1);
        }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      float* rows[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        rows[r] = rw[r] < Q ? a.dCp + (((size_t)b * S + (size_t)c * Q + rw[r]) * nsl + sl) * N
                            : nullptr;
      add_rows<NT>(acc, rows, N, t, hh == 0);
    }
    __syncthreads();   // (3) x, dy, h_prev are read; dda is written
    if (tid == 0 && hh + 1 < HS) load_head(h + 1);

    // warp 0: d a_cs by row, its reverse cumsum d a (a run of rows a lane,
    // the later lanes' totals by shuffles), ddt, and the head's dA, dD
    if (tid < 32) {
      constexpr int PER = TQ / 32;
      float dcs[PER], rsum = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane * PER + k;
        float v = 0.f;
        if (i < Q) {
          float rowsum = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < 8; ++w8) rowsum += rowp[w8 * TQ + i];
          v = rowsum - colw[i] + dda[i] - rv[i];
          rsum += rv[i];
        }
        dcs[k] = v;
      }
      rsum = warp_sum(rsum);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (lane * PER + k == Q - 1) dcs[k] += rsum + expf(acs[Q - 1]) * hd;
      float suf[PER], run = 0.f;
#pragma unroll
      for (int k = PER - 1; k >= 0; --k) {
        run += dcs[k];
        suf[k] = run;
      }
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, tot, o);
        if (lane + o < 32) tot += v;
      }
      float after = __shfl_down_sync(0xffffffffu, tot, 1);
      if (lane == 31) after = 0.f;
      float dA = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane * PER + k;
        if (i < Q) {
          const float da = suf[k] + after;
          a.ddt[xrow + (size_t)i * H] = __float2bfloat16(ddx[i] + Ah * da);
          dA += dts[i] * da;
        }
      }
      dA = warp_sum(dA);
      if (lane == 0) {
        float ds = 0.f;
        for (int w8 = 0; w8 < 8; ++w8) ds += ddp[w8];
        a.dA_part[bc * H + h] = dA;
        a.dD_part[bc * H + h] = ds;
      }
    }
  }

  // the last block of a (b, chunk, group) adds the group's slices' dB and
  // dC, the last of a slice its heads' dA and dD over (b, chunk), each in a
  // fixed order
  __threadfence();
  __syncthreads();
  const int spg = rep / HS;   // slices a group
  if (tid == 0) {
    last[0] = atomicAdd(&a.counters[bc * G + g], 1) == spg - 1;
    last[1] = atomicAdd(&a.counters[(size_t)a.Bb * nc * G + sl], 1) == a.Bb * nc - 1;
  }
  __syncthreads();
  if (last[0]) {
    __threadfence();
    const int s0 = g * spg;
    for (int k = tid; k < Q * (N / 2); k += TC_THREADS) {
      const int q = k / (N / 2), n = 2 * (k % (N / 2));
      const size_t rowq = (size_t)b * S + (size_t)c * Q + q;
      float2 sb = make_float2(0.f, 0.f), sc = sb;
      for (int s2 = 0; s2 < spg; ++s2) {
        const size_t o = (rowq * nsl + s0 + s2) * N + n;
        const float2 vb = __ldcg(reinterpret_cast<const float2*>(a.dBp + o));
        const float2 vc = __ldcg(reinterpret_cast<const float2*>(a.dCp + o));
        sb = make_float2(sb.x + vb.x, sb.y + vb.y);
        sc = make_float2(sc.x + vc.x, sc.y + vc.y);
      }
      const size_t o = (rowq * G + g) * N + n;
      *reinterpret_cast<__nv_bfloat162*>(a.dB + o) = __floats2bfloat162_rn(sb.x, sb.y);
      *reinterpret_cast<__nv_bfloat162*>(a.dC + o) = __floats2bfloat162_rn(sc.x, sc.y);
    }
  }
  if (last[1]) {
    __threadfence();
    for (int k = tid; k < HS; k += TC_THREADS) {
      const int h = h_first + k;
      float sa = 0.f, sd = 0.f;
      for (int i = 0; i < a.Bb * nc; ++i) {
        sa += __ldcg(a.dA_part + (size_t)i * H + h);
        sd += __ldcg(a.dD_part + (size_t)i * H + h);
      }
      a.dA[h] = sa;
      if (a.dD != nullptr) a.dD[h] = sd;
    }
  }
}

// A map of a 4-D bf16 tensor (d3, d2, d1, d0), d0 contiguous, read in
// boxes of `rows` (along d2) x 64 (along d0) elements of one (d3, d1)
// index, 128-byte swizzled; elements past any edge are zero-filled
cudaError_t map_4d(CUtensorMap* map, const void* base, int d0, int d1, int d2, int d3,
                   int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d1 * d0 * 2,
                                 (cuuint64_t)d2 * d1 * d0 * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// heads a block: the fewest (a divisor of the group's H / G) that keep the
// chunk pass within one block an SM of the card's `sms`, so B and C and the
// chunk's scores are loaded and formed once for as many heads as the card
// leaves room for
int head_slice(int Bb, int nc, int H, int G, int sms) {
  const int rep = H / G;
  for (int hs = 1; hs < rep; ++hs)
    if (rep % hs == 0 && (long long)Bb * nc * (H / hs) <= sms) return hs;
  return rep;
}

// The work buffer's floats (ssd_bwd's `work`), for a call the entry point
// accepts; `hs` is the bf16 path's head slice (unused for float32).
//   float32: hprev, dhnext (Bb nc H P N each), per-head dB, dC (Bb S H N
//            each), dA_part, dD_part (Bb nc H each)
//   bf16:    states, ustates (Bb nc H P N each), the four bf16 planes of
//            parts (2 Bb nc H P N floats), each head slice's dB, dC (Bb S
//            (H / hs) N each), hd_part (Bb nc H MAX_SLABS), alast,
//            dA_part, dD_part (Bb nc H each)
size_t work_floats(int Bb, int S, int H, int P, int N, int Q, int dtype, int hs) {
  const size_t nc = S / Q, states = (size_t)Bb * nc * H * P * N;
  const size_t chunks = (size_t)Bb * nc * H;
  if (dtype == 0) return 2 * states + 2 * (size_t)Bb * S * H * N + 2 * chunks;
  return 4 * states + 2 * (size_t)Bb * S * (H / hs) * N + (MAX_SLABS + 3) * chunks;
}

template <int PT, int NT>
cudaError_t launch_tc(const TcArgs& a, cudaStream_t stream) {
  const int nc = a.S / a.Q;
  CUtensorMap xm, ym, bm, cm, pm;
  cudaError_t e = map_4d(&xm, a.x, a.P, a.H, a.S, a.Bb, TQ);
  if (e == cudaSuccess) e = map_4d(&ym, a.dy, a.P, a.H, a.S, a.Bb, TQ);
  if (e == cudaSuccess) e = map_4d(&bm, a.B, a.N, a.G, a.S, a.Bb, TQ);
  if (e == cudaSuccess) e = map_4d(&cm, a.C, a.N, a.G, a.S, a.Bb, TQ);
  if (e == cudaSuccess) e = tile_map_3d(&pm, a.parts, a.N, a.P, 4 * a.Bb * nc * a.H, PT);
  if (e != cudaSuccess) return e;
  auto k1 = ssd_bwd_states_tc_kernel<PT, NT>;
  auto k3 = ssd_bwd_chunk_tc_kernel<PT, NT>;
  static bool configured = false;   // once per instantiation (one card)
  if (!configured) {
    e = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)StatesLayout<PT, NT>::bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ChunkLayout<PT, NT>::bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(nc, a.H / a.HS, a.Bb);
  k1<<<grid, TC_THREADS, StatesLayout<PT, NT>::bytes, stream>>>(bm, cm, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_bwd_scan_kernel<<<dim3((a.P * a.N + SCAN_SLAB - 1) / SCAN_SLAB, a.H, a.Bb), TC_THREADS, 0,
                        stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k3<<<grid, TC_THREADS, ChunkLayout<PT, NT>::bytes, stream>>>(xm, ym, bm, cm, pm, a);
  return cudaGetLastError();
}

cudaError_t launch_tc_tiles(const TcArgs& a, cudaStream_t st) {
  if (a.P <= 64 && a.N <= 64) return launch_tc<64, 64>(a, st);
  if (a.P <= 64) return launch_tc<64, 128>(a, st);
  if (a.N <= 64) return launch_tc<128, 64>(a, st);
  return launch_tc<128, 128>(a, st);
}

bool valid(int Bb, int S, int H, int P, int G, int N, int Q, int dtype) {
  return Bb > 0 && Bb <= 65535 && S > 0 && H > 0 && H <= 65535 && P > 0 && P % PS == 0 &&
         P <= PMAX && G > 0 && H % G == 0 && N > 0 && N % 32 == 0 && N <= NMAX && Q >= 1 &&
         Q <= QMAX && S % Q == 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// The floats ssd_bwd's `work` must hold for these sizes and dtype (the
// bf16 path's dB, dC partials depend on the card's SM count); -1 for sizes
// ssd_bwd refuses or a failed query of the card.
extern "C" long long ssd_bwd_work_floats(int Bb, int S, int H, int P, int G, int N, int Q,
                                         int dtype) {
  if (!valid(Bb, S, H, P, G, N, Q, dtype)) return -1;
  int sms = 0;
  if (dtype == 1 && sm_count(&sms) != cudaSuccess) return -1;
  const int hs = dtype == 1 ? head_slice(Bb, S / Q, H, G, sms) : 1;
  return (long long)work_floats(Bb, S, H, P, N, Q, dtype, hs);
}

// dtype: 0 = float32, 1 = bfloat16, for x, dt, B, C, dy and dx, ddt, dB,
// dC alike; A, D, h0, dstate and dA, dD, dh0 are float32.  D, h0 and
// dstate may be null (no skip, a zero initial state, no gradient of the
// final state); dD and dh0 are written iff D and h0 are given.  work holds
// ssd_bwd_work_floats(...) floats (work_floats above); counters Bb (S/Q) G
// + H ints, zero.  bf16 launches three kernels, float32 two.  Returns the
// first launch's cudaError_t that is not 0.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* h0, const void* dy,
                       const void* dstate, void* dx, void* ddt, void* dA, void* dB, void* dC,
                       void* dD, void* dh0, void* work, void* counters, int Bb, int S, int H,
                       int P, int G, int N, int Q, int dtype, void* stream) {
  if (!valid(Bb, S, H, P, G, N, Q, dtype)) return (int)cudaErrorInvalidValue;
  const size_t nc = S / Q, states = (size_t)Bb * nc * H * P * N, heads = (size_t)Bb * S * H * N;
  const size_t chunks = (size_t)Bb * nc * H;
  float* w = static_cast<float*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args a{x, dt, B, C, dy,
           static_cast<const float*>(A), static_cast<const float*>(D),
           static_cast<const float*>(h0), static_cast<const float*>(dstate),
           dx, ddt, dB, dC,
           static_cast<float*>(dA), D != nullptr ? static_cast<float*>(dD) : nullptr,
           h0 != nullptr ? static_cast<float*>(dh0) : nullptr,
           w, w + states, w + 2 * states, w + 2 * states + heads,
           w + 2 * states + 2 * heads, w + 2 * states + 2 * heads + chunks,
           static_cast<int*>(counters), Bb, S, H, P, G, N, Q};
    return (int)launch_f32(a, st);
  }
  using bf16 = __nv_bfloat16;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int hs = head_slice(Bb, (int)nc, H, G, sms);
  const size_t slices = (size_t)Bb * S * (H / hs) * N;
  // states, ustates, the four bf16 planes of parts (2 states floats), dBp,
  // dCp, hd_part, alast, dA_part, dD_part (work_floats)
  float* hd = w + 4 * states + 2 * slices;
  TcArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
           static_cast<const bf16*>(B), static_cast<const bf16*>(C),
           static_cast<const bf16*>(dy),
           static_cast<const float*>(A), static_cast<const float*>(D),
           static_cast<const float*>(h0), static_cast<const float*>(dstate),
           static_cast<bf16*>(dx), static_cast<bf16*>(ddt), static_cast<bf16*>(dB),
           static_cast<bf16*>(dC),
           static_cast<float*>(dA), D != nullptr ? static_cast<float*>(dD) : nullptr,
           h0 != nullptr ? static_cast<float*>(dh0) : nullptr,
           w, w + states, reinterpret_cast<bf16*>(w + 2 * states),
           w + 4 * states, w + 4 * states + slices,
           hd, hd + chunks * MAX_SLABS, hd + chunks * (MAX_SLABS + 1),
           hd + chunks * (MAX_SLABS + 2),
           static_cast<int*>(counters), Bb, S, H, P, G, N, Q, hs};
  return (int)launch_tc_tiles(a, st);
}
