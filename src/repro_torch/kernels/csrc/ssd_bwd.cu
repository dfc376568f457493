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
// What bounds it on the card: bytes, ~0.026 ms at mamba2's training shape
// (Bb = 2, S = 2048, H = 32, P = 64, N = 128, chunk 128: x, dy and dx in
// bf16, ~88 MB at 3.35 TB/s), where the gradient's 17.3 GFLOP would take
// 0.017 ms at the bf16 tensor-core peak.  This kernel does its products on
// the CUDA cores in f32, where they take at least 0.26 ms (67 TFLOP/s); on
// an H100 80GB HBM3 at a 700 W limit it takes 4.5 ms a layer (6.0 ms at
// zamba2's heads), PERF.md section 6.  The tensor cores (as ssd.cu's
// forward) are the way down.
//
// Design: two kernels, every sum in float32 (bf16 inputs are widened when
// loaded; outputs are rounded once).
//   1. ssd_bwd_state_kernel, a block per (b, h, 16 head dims p), walks the
//      chunks forward from h0 and writes the state entering each chunk
//      (h_prev, Bb x nc x H x P x N f32), as the forward kernel carries it,
//      then backward from the final state's gradient and writes the
//      gradient leaving each chunk (dh_next), ending at dh0.  The forward
//      kernel writes none of this: the serving path pays nothing, and the
//      backward recomputes the states (a third of the forward's work).
//   2. ssd_bwd_chunk_kernel, a block per (chunk, h, b), every chunk at
//      once: it stages B and C (f32) and forms S o L, then in turn dxdt
//      (writing dx and x . dxdt), dS over S o L (the d a_cs row and column
//      sums), dC and dB, staging dh_next, x dt and h_prev in one reused
//      region of shared memory (at Q = N = 128: 207 KB, one block an SM).
//      dx and ddt are written per head.  dB and dC are written per head
//      into f32 scratch, and dA's and dD's per-block sums into a (Bb nc,
//      H) scratch.
// Deterministic sums: no floating-point atomics.  Each block adds its own
// sums in a fixed order (per thread, then shuffles down a warp, then the
// warps in order).  A block counts itself done on an integer counter of
// its (b, chunk, group) and of its head (atomicAdd on ints, after a
// __threadfence); the block that finishes last of a (b, chunk, group) adds
// the group's H/G heads' dB and dC scratch in head order, and the last of
// a head adds its Bb nc dA and dD sums in (b, chunk) order.  Which block is
// last varies from run to run; the order of every sum does not.
// Contract: P a multiple of 16 up to 128, N a multiple of 32 up to 128,
// any chunk Q from 1 to 128 that divides S, float32 or bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// inclusive cumsum of acs[0..Q) in place, by warp 0: each lane sums a run
// of rows, the lanes' totals are scanned with shuffles (as ssd.cu)
__device__ __forceinline__ void scan_rows(float* acs, int Q, int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += acs[i];
    acs[i] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += v;
  }
  // the lanes before this one's run: the previous lane's inclusive
  // total, so a row's a_cs sums the rows up to it and no later one
  // (tot - run rounds with the run's later rows: an output would
  // depend on later inputs in its last bits)
  float before = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) before = 0.f;
  for (int i = lo; i < hi; ++i) acs[i] += before;
}

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
  const void *x, *dt, *B, *C, *dy;   // x's dtype
  const float *A, *D, *h0, *dstate;  // D, h0, dstate may be null
  void *dx, *ddt, *dB, *dC;          // x's dtype
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
  return Qp * (N + 1) + Qp * PS + (size_t)PS * (N + 1) + 3 * Qp;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_state_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, N = a.N, P = a.P, H = a.H, S = a.S, G = a.G;
  const int Qp = padded_rows(Q), ldn = N + 1, nc = S / Q;
  float* Vs = sm;                  // Qp x ldn: B (forward), C (backward)
  float* Xs = Vs + Qp * ldn;       // Qp x PS: x (forward), dy (backward)
  float* St = Xs + Qp * PS;        // PS x ldn
  float* dts = St + PS * ldn;
  float* acs = dts + Qp;
  float* ws = acs + Qp;

  const int b = blockIdx.x, h = blockIdx.y, p0 = blockIdx.z * PS;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float Ah = a.A[h];
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;

  for (int i = tid; i < PS * N; i += THREADS)
    St[(i / N) * ldn + i % N] = a.h0 != nullptr ? a.h0[state_base + i] : 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const T* V = static_cast<const T*>(pass == 0 ? a.B : a.C);
    const T* X = pass == 0 ? x : static_cast<const T*>(a.dy);
    float* out = pass == 0 ? a.hprev : a.dhnext;
    if (pass == 1) {
      __syncthreads();
      for (int i = tid; i < PS * N; i += THREADS)
        St[(i / N) * ldn + i % N] = a.dstate != nullptr ? a.dstate[state_base + i] : 0.f;
    }
    for (int t = 0; t < nc; ++t) {
      const int c = pass == 0 ? t : nc - 1 - t;
      const int s0 = c * Q;
      for (int i = tid; i < Qp; i += THREADS) {
        const float d = i < Q ? widen(dt[((size_t)b * S + s0 + i) * H + h]) : 0.f;
        dts[i] = d;
        acs[i] = Ah * d;
      }
      for (int i = tid; i < Qp * N; i += THREADS) {
        const int q = i / N, n = i % N;
        Vs[q * ldn + n] = q < Q ? widen(V[(((size_t)b * S + s0 + q) * G + g) * N + n]) : 0.f;
      }
      for (int i = tid; i < Qp * PS; i += THREADS) {
        const int q = i / PS, p = i % PS;
        Xs[i] = q < Q ? widen(X[(((size_t)b * S + s0 + q) * H + h) * P + p0 + p]) : 0.f;
      }
      __syncthreads();
      if (warp == 0) scan_rows(acs, Q, lane);
      __syncthreads();
      const float a_last = acs[Q - 1];
      // forward: x's weight dt exp(a_last - a_cs); backward: dy's exp(a_cs)
      for (int i = tid; i < Qp; i += THREADS)
        ws[i] = i >= Q ? 0.f : pass == 0 ? dts[i] * expf(a_last - acs[i]) : expf(acs[i]);
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
      const float decay = expf(a_last);
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
  return Qp * (N + 1) + rows2 * ldr + Qp * (Qp + 1) + 9 * Qp + WARPS * Qp + WARPS;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int Q = a.Q, N = a.N, P = a.P, H = a.H, S = a.S, G = a.G;
  const int Qp = padded_rows(Q), ldn = N + 1, ldm = Qp + 1;
  const int ldr = max(N, P) + 1, rows2 = max(Qp, P);
  float* Bs = sm;                  // Qp x ldn: B, then C
  float* R2 = Bs + Qp * ldn;       // rows2 x ldr: C, dh_next, x dt, h_prev, dh_next
  float* Ms = R2 + rows2 * ldr;    // Qp x ldm: S o L, then dS
  float* dts = Ms + Qp * ldm;
  float* acs = dts + Qp;
  float* eas = acs + Qp;           // exp(a_cs)
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
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* Bm = static_cast<const T*>(a.B);
  const T* Cm = static_cast<const T*>(a.C);
  const T* dt = static_cast<const T*>(a.dt);
  T* dx = static_cast<T*>(a.dx);
  auto row_hp = [&](int i) { return (((size_t)b * S + s0 + i) * H + h); };   // x, dy rows
  auto row_gn = [&](int i) { return (((size_t)b * S + s0 + i) * G + g) * N; };
  const size_t st_base = (((size_t)b * nc + c) * H + h) * (size_t)P * N;

  // 0. dt, the log-decay, B and C
  for (int i = tid; i < Qp; i += THREADS) {
    const float d = i < Q ? widen(dt[((size_t)b * S + s0 + i) * H + h]) : 0.f;
    dts[i] = d;
    acs[i] = Ah * d;
    roww[i] = colw[i] = dda[i] = ddx[i] = rv[i] = 0.f;
  }
  for (int i = tid; i < Qp * N; i += THREADS) {
    const int q = i / N, n = i % N;
    Bs[q * ldn + n] = q < Q ? widen(Bm[row_gn(q) + n]) : 0.f;
    R2[q * ldr + n] = q < Q ? widen(Cm[row_gn(q) + n]) : 0.f;
  }
  __syncthreads();
  if (warp == 0) scan_rows(acs, Q, lane);
  __syncthreads();
  const float a_last = acs[Q - 1];
  for (int i = tid; i < Qp; i += THREADS) {
    eas[i] = i < Q ? expf(acs[i]) : 0.f;
    dec[i] = i < Q ? expf(a_last - acs[i]) : 0.f;
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
          Ms[i * ldm + j] = (i < Q && j <= i) ? acc[r][cc] * expf(acs[i] - acs[j]) : 0.f;
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
          const float yv = widen(dy[row_hp(i) * P + p]);
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
            const float xv = widen(x[o]), yv = widen(dy[o]);
            dx[o] = narrow<T>(dts[j] * dxdt + Dh * yv);
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
    R2[q * ldr + p] = q < Q ? widen(x[row_hp(q) * P + p]) * dts[q] : 0.f;
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
        for (int r = 0; r < 4; ++r) yv[r] = i0 + r < Q ? widen(dy[row_hp(i0 + r) * P + p]) : 0.f;
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
              Ms[i * ldm + j] = expf(acs[i] - acs[j]) * gij;
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
      for (int r = 0; r < 4; ++r) yv[r] = i0 + r < Q ? widen(dy[row_hp(i0 + r) * P + p]) : 0.f;
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
            part = fmaf(widen(Cm[row_gn(i) + n]), off, part);
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
    Bs[q * ldn + n] = q < Q ? widen(Cm[row_gn(q) + n]) : 0.f;
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
      for (int r = 0; r < 4; ++r) xv[r] = j0 + r < Q ? widen(x[row_hp(j0 + r) * P + p]) : 0.f;
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
            part = fmaf(widen(Bm[row_gn(j) + n]), bst, part);
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
    T* ddt = static_cast<T*>(a.ddt);
    for (int k = Q - 1; k >= 0; --k) {
      float dacs = roww[k] - colw[k] + dda[k];
      if (k == Q - 1) dacs += rsum + expf(a_last) * hd_sum;
      da += dacs;
      ddt[((size_t)b * S + s0 + k) * H + h] = narrow<T>(ddx[k] + Ah * da);
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
    T* dB = static_cast<T*>(a.dB);
    T* dC = static_cast<T*>(a.dC);
    for (int i = tid; i < Q * N; i += THREADS) {
      const int q = i / N, n = i % N;
      const size_t base = (((size_t)b * S + s0 + q) * H + (size_t)g * rep) * N + n;
      float sb = 0.f, sc = 0.f;
      for (int r = 0; r < rep; ++r) {
        sb += __ldcg(a.dBh + base + (size_t)r * N);
        sc += __ldcg(a.dCh + base + (size_t)r * N);
      }
      dB[row_gn(q) + n] = narrow<T>(sb);
      dC[row_gn(q) + n] = narrow<T>(sc);
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

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto k1 = ssd_bwd_state_kernel<T>;
  auto k2 = ssd_bwd_chunk_kernel<T>;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, for x, dt, B, C, dy and dx, ddt, dB,
// dC alike; A, D, h0, dstate and dA, dD, dh0 are float32.  D, h0 and
// dstate may be null (no skip, a zero initial state, no gradient of the
// final state); dD and dh0 are written iff D and h0 are given.  work holds
// 2 Bb (S/Q) H P N + 2 Bb S H N + 2 Bb (S/Q) H floats; counters Bb (S/Q) G
// + H ints, zero.  Returns the first launch's cudaError_t that is not 0.
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* B,
                       const void* C, const void* D, const void* h0, const void* dy,
                       const void* dstate, void* dx, void* ddt, void* dA, void* dB, void* dC,
                       void* dD, void* dh0, void* work, void* counters, int Bb, int S, int H,
                       int P, int G, int N, int Q, int dtype, void* stream) {
  if (Bb <= 0 || Bb > 65535 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || P % PS != 0 ||
      P > PMAX || G <= 0 || H % G != 0 || N <= 0 || N % 32 != 0 || N > NMAX || Q < 1 ||
      Q > QMAX || S % Q != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const size_t nc = S / Q, states = (size_t)Bb * nc * H * P * N, heads = (size_t)Bb * S * H * N;
  float* w = static_cast<float*>(work);
  Args a{x, dt, B, C, dy,
         static_cast<const float*>(A), static_cast<const float*>(D),
         static_cast<const float*>(h0), static_cast<const float*>(dstate),
         dx, ddt, dB, dC,
         static_cast<float*>(dA), D != nullptr ? static_cast<float*>(dD) : nullptr,
         h0 != nullptr ? static_cast<float*>(dh0) : nullptr,
         w, w + states, w + 2 * states, w + 2 * states + heads,
         w + 2 * states + 2 * heads, w + 2 * states + 2 * heads + (size_t)Bb * nc * H,
         static_cast<int*>(counters), Bb, S, H, P, G, N, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, st);
  return (int)launch<__nv_bfloat16>(a, st);
}
