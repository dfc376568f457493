// Mamba-2 chunked SSD (state-space duality) for Hopper (sm_90a).
//
// Replaces: repro/kernels/ssd.py::ssd (the Pallas TPU kernel _ssd_kernel).
// Same function as its oracle ssd_chunked (repro/kernels/ref.py): for each
// (batch b, head h) and each chunk of Q rows, in order,
//   a      = A[h] * dt,   a_cs = inclusive cumsum of a over the chunk
//   y_diag = ((C B^T) o L) (x dt),  L[i,j] = exp(a_cs[i] - a_cs[j]) for
//            i >= j, 0 above the diagonal (never exponentiated there)
//   y_off  = exp(a_cs) (C state^T)
//   y      = y_diag + y_off + D[h] x          (float32, rounded once)
//   state  = state exp(a_cs[Q-1]) + (x dt exp(a_cs[Q-1] - a_cs))^T B
// with x (Bb,S,H,P), dt (Bb,S,H), B/C (Bb,S,G,N) shared by the H/G heads
// of a group, A and D (H,) and the state (Bb,H,P,N) in float32.  The
// Pallas wrapper added D outside the kernel after rounding y once; here D
// is fused, as in ssd_chunked, so y is rounded once.  The TPU kernel
// carried the (P,N) state in VMEM across a sequential ("arbitrary") grid
// axis of chunks; blocks here run in no order, so one block loops over
// the chunks itself and carries its part of the state.
//
// What bounds it on the card: bytes.  At the serving shapes (a 256-row
// prefill chunk at batch 1; mamba2-370m H=32, P=64, N=128, zamba2-1.2b
// H=64, P=64, N=64) the function moves 4-6 MB (x and y in bf16, the f32
// state in and out), 1.3-1.9 us at 3.35 TB/s, and does 0.3-0.5 GFLOP,
// under 0.5 us at the bf16 tensor-core peak.  A chunk of the scan is a
// chain of dependent products, so what a kernel can reach is the chain's
// latency: the tail chunks of 2-64 rows move a few hundred KB.
//
// bf16: the tensor cores (ssd_tc_kernel; building blocks in hopper.cuh).
// A chunk is attention with a decay mask: S = C B^T is the score tile,
// M = S o L o dt is masked in registers where attention takes its
// softmax, y = M x + exp(a_cs) (C state^T) + D x, and the state update
// (x o wd)^T B is one more product with the reduction over the chunk.
//   * A block owns (b, h, 32 head dims p): y[:, p] needs only state[p, :]
//     and x[:, p], so the slices are independent; batch 1 gives 64 blocks
//     for mamba2 and 128 for zamba2.  Each block computes the chunk's
//     C B^T again (4 MFLOP at Q = N = 128, well under a microsecond).
//   * Thread 0 loads each chunk's C, B (N padded to 64 or 128 columns by
//     TMA's zero fill) and the block's 32 columns of x by TMA into a ring
//     of two stages on mbarriers, so chunk c+1's tiles land while chunk c
//     computes.  The tile is 64 rows for Q <= 64 and 128 above (on an
//     H100 a tail of 2 to 64 rows takes ~7 us on the 64-row tile and ~9
//     on the 128-row one, PERF.md section 6); rows past Q belong to the
//     next chunk and are masked (dt = 0 there).
//   * Two warpgroups own 64 rows of the chunk each: S from shared memory
//     (both K-major; the first 64 rows need only the first 64 columns),
//     and in the same wgmma group C state^T with the state as the MN-major
//     B operand; then M (f32) goes in from registers as hi = bf16(M) and
//     lo = bf16(M - hi) against x, MN-major.
//   * The state (N x 32 per block, transposed) lives in the f32
//     accumulators of the warpgroups (one per 64 rows of N): scaled by
//     exp(a_cs[Q-1]) in registers, then += B^T (x o wd) with B read
//     MN-major from its tile and x o wd stored by all threads as two bf16
//     parts.  Its two parts are stored for the next chunk's C state^T.
//     Rounding any of the three f32 operands (M, the state, x o wd) to
//     bf16 once breaks the per-entry check (ref.ssd_tc_emulated,
//     chip_smoke.py's shortcut line); two parts leave ~2^-18 a term.
//   * Warp 0 scans the log-decay (a run of rows a lane, shuffles across
//     lanes; a row's sum holds no later row, so y up to a row is the same
//     bit for bit whatever follows it) from dt loaded one chunk ahead.  Three block barriers a chunk:
//     after the scan, after the row products (the old state is read),
//     after the state update (the stage is free).
// Every bf16 chunk from 1 to 128 rows takes this kernel: on an H100 it is
// faster than the CUDA-core kernel below at every chunk size the serving
// path cuts (2 to 256 rows; PERF.md section 6), so nothing dispatches
// between the two by shape.  What bounds it now is one chunk's chain, not
// bytes: ~7 us for a tail of up to 64 rows, ~9 us for 128 rows.
// The gradient is ssd_bwd.cu.  It needs, per chunk, a_cs, S o L and the
// state entering the chunk, which this kernel keeps only in registers and
// shared memory: the backward recomputes them (the states in a scan of
// its own), so this kernel writes nothing more for training and the
// serving path pays nothing.
//
// float32 (the checks and the f32 parity arms): ssd_kernel on the CUDA
// cores (the first port of the kernel), f32 products throughout; TF32
// would not meet the f32 checks' 1e-5.  A block owns (b, h, a slice of
// PS=16 of the P state rows) and recomputes the chunk's C B^T; per chunk
// it stages dt, B, C (as f32, rows padded to N+1 floats) and its 16
// columns of x; warp 0 scans the log-decay; M = (C B^T) o L o dt is built
// in 4-row strips (only j <= i computed or exponentiated); then y and the
// state update.  At Q = N = 128 the staging takes 212 KB of shared
// memory: one block per SM.  In both kernels the final state goes to
// state_out, which may be h0 itself: every thread reads its own entries
// of h0 before it writes them, and no other thread touches them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PS = 16;                    // state rows (head dims p) per block
constexpr int QMAX = 128;                 // largest chunk
constexpr int NMAX = 128;                 // largest state size
constexpr int ROW_LANES = THREADS / PS;   // y: threads down the rows
constexpr int RMAX = QMAX / ROW_LANES;    // y: rows per thread
constexpr int PK = PS / WARPS;            // state update: p rows per thread
constexpr int MMAX = NMAX / 32;           // state update: n columns per lane

// rows of a chunk in shared memory: Q rounded up to a whole 4-row strip
__host__ __device__ inline int padded_rows(int Q) { return (Q + 3) / 4 * 4; }

// shared memory of one block, in floats
__host__ __device__ inline size_t smem_floats(int Q, int N) {
  const size_t Qp = padded_rows(Q);
  return 2 * Qp * (N + 1)     // B, C      [q][n]
         + Qp * (Qp + 1)      // M         [i][j]
         + Qp * PS            // x         [q][p]
         + (size_t)PS * (N + 1)  // state  [p][n]
         + 4 * Qp;            // dt, a_cs, dt exp(a_cs[Q-1] - a_cs), exp(a_cs)
}

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ Dv, const float* h0,
           float* __restrict__ y, float* state_out, int S, int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  const int Qp = padded_rows(Q);
  const int ldn = N + 1, ldm = Qp + 1;
  float* Bs = sm;                   // Qp x ldn
  float* Cs = Bs + Qp * ldn;        // Qp x ldn
  float* Ms = Cs + Qp * ldn;        // Qp x ldm
  float* Xs = Ms + Qp * ldm;        // Qp x PS
  float* St = Xs + Qp * PS;         // PS x ldn
  float* dts = St + PS * ldn;       // Qp
  float* acs = dts + Qp;            // Qp
  float* wds = acs + Qp;            // Qp
  float* eas = wds + Qp;            // Qp

  const int b = blockIdx.x, h = blockIdx.y, p0 = blockIdx.z * PS;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float Ah = A[h];
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;
  const size_t state_base = (((size_t)b * H + h) * P + p0) * N;

  // this block's rows of the carried state, read before any are written
  for (int i = tid; i < PS * N; i += THREADS) {
    const int p = i / N, n = i % N;
    St[p * ldn + n] = h0 != nullptr ? h0[state_base + (size_t)p * N + n] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += Q) {
    // stage the chunk; rows past Q are zeros
    for (int i = tid; i < Qp; i += THREADS) {
      const float d = i < Q ? dt[((size_t)b * S + s0 + i) * H + h] : 0.f;
      dts[i] = d;
      acs[i] = Ah * d;
    }
    for (int i = tid; i < Qp * N; i += THREADS) {
      const int q = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (q < Q) {
        const size_t off = (((size_t)b * S + s0 + q) * G + g) * N + n;
        bv = Bm[off];
        cv = Cm[off];
      }
      Bs[q * ldn + n] = bv;
      Cs[q * ldn + n] = cv;
    }
    for (int i = tid; i < Qp * PS; i += THREADS) {
      const int q = i / PS, p = i % PS;
      Xs[i] = q < Q ? x[(((size_t)b * S + s0 + q) * H + h) * P + p0 + p] : 0.f;
    }
    __syncthreads();

    // inclusive cumsum of the log-decay (warp 0): each lane sums a run of
    // rows, the lanes' totals are scanned with shuffles
    if (warp == 0) {
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
    __syncthreads();

    const float a_last = acs[Q - 1];
    for (int i = tid; i < Qp; i += THREADS) {
      wds[i] = i < Q ? dts[i] * expf(a_last - acs[i]) : 0.f;
      eas[i] = i < Q ? expf(acs[i]) : 0.f;
    }

    // M[i][j] = (C B^T)[i][j] exp(a_cs[i] - a_cs[j]) dt[j] for j <= i < Q:
    // 4-row strips taken by the warps in turn; lane covers j = lane + 32 c
    for (int i0 = warp * 4; i0 < Qp; i0 += WARPS * 4) {
      const int cmax = min(i0 + 3, Q - 1) / 32;   // last column group reaching j <= i
      float acc[4][QMAX / 32];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < QMAX / 32; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(i0 + r) * ldn + n];
#pragma unroll
        for (int c = 0; c < QMAX / 32; ++c) {
          if (c <= cmax) {
            const float bv = Bs[min(lane + 32 * c, Qp - 1) * ldn + n];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(cv[r], bv, acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < QMAX / 32; ++c) {
        const int j = lane + 32 * c;
        if (c <= cmax && j < Q) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + r;
            if (i < Q && j <= i) Ms[i * ldm + j] = acc[r][c] * expf(acs[i] - acs[j]) * dts[j];
          }
        }
      }
    }
    __syncthreads();

    // y[i][p] = sum_{j<=i} M[i][j] x[j][p] + exp(a_cs[i]) sum_n C[i][n]
    // state[p][n] + D x[i][p]; thread (p, rows i = i1 + 16 k)
    {
      const int p = tid % PS, i1 = tid / PS;
      float acc[RMAX], off[RMAX];
#pragma unroll
      for (int k = 0; k < RMAX; ++k) acc[k] = off[k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float xv = Xs[j * PS + p];
#pragma unroll
        for (int k = 0; k < RMAX; ++k) {
          const int i = i1 + ROW_LANES * k;
          if (i < Q && j <= i) acc[k] = fmaf(Ms[i * ldm + j], xv, acc[k]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float sv = St[p * ldn + n];
#pragma unroll
        for (int k = 0; k < RMAX; ++k) {
          const int i = i1 + ROW_LANES * k;
          if (i < Q) off[k] = fmaf(Cs[i * ldn + n], sv, off[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < RMAX; ++k) {
        const int i = i1 + ROW_LANES * k;
        if (i < Q) {
          const float v = acc[k] + eas[i] * off[k] + Dh * Xs[i * PS + p];
          y[(((size_t)b * S + s0 + i) * H + h) * P + p0 + p] = v;
        }
      }
    }
    __syncthreads();   // every read of the old state is done

    // state[p][n] = state[p][n] exp(a_cs[Q-1]) + sum_j x[j][p] wd[j] B[j][n];
    // thread (p = warp + 8 k, n = lane + 32 m)
    {
      const int nm = N / 32;
      float acc[PK][MMAX];
#pragma unroll
      for (int k = 0; k < PK; ++k)
#pragma unroll
        for (int m = 0; m < MMAX; ++m) acc[k][m] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float w = wds[j];
        float xw[PK];
#pragma unroll
        for (int k = 0; k < PK; ++k) xw[k] = Xs[j * PS + warp + WARPS * k] * w;
#pragma unroll
        for (int m = 0; m < MMAX; ++m) {
          if (m < nm) {
            const float bv = Bs[j * ldn + lane + 32 * m];
#pragma unroll
            for (int k = 0; k < PK; ++k) acc[k][m] = fmaf(xw[k], bv, acc[k][m]);
          }
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
    }
    __syncthreads();   // before the next chunk's staging and the final write
  }

  for (int i = tid; i < PS * N; i += THREADS) {
    const int p = i / N, n = i % N;
    state_out[state_base + (size_t)p * N + n] = St[p * ldn + n];
  }
}

cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* h0, void* y, void* state_out, int Bb, int S,
                   int H, int P, int G, int N, int Q, cudaStream_t stream) {
  // above 48 KB only after opting in; set once (one card)
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(QMAX, NMAX) * sizeof(float)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(Bb, H, P / PS);
  ssd_kernel<<<grid, THREADS, smem_floats(Q, N) * sizeof(float), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y), static_cast<float*>(state_out), S,
      H, P, G, N, Q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 256;   // two warpgroups
constexpr int TC_PS = 32;         // head dims p per block: y's columns, the state's rows

// shared memory of ssd_tc_kernel: a ring of two stages (C and B tiles of
// QT rows x NT columns, the block's QT x 32 tile of x), the two bf16 parts
// of x o wd (QT x 32) and of the state (NT x 32, stored [n][p]), the
// chunk's dt, a_cs, wd and exp(a_cs), and the stages' mbarriers; every
// tile a multiple of 1024 bytes, so each starts on a swizzle boundary
template <int QT, int NT>
struct TcLayout {
  static constexpr uint32_t CB = QT * NT * 2;       // a C or B tile
  static constexpr uint32_t XB = QT * TC_PS * 2;    // an x or x o wd tile
  static constexpr uint32_t SB = NT * TC_PS * 2;    // a part of the state
  static constexpr uint32_t STAGE = 2 * CB + XB;
  static constexpr size_t bytes = 2 * (size_t)STAGE + 2 * XB + 2 * SB + 4 * QT * 4 + 2 * 8 + 1024;
};

// the state's f32 fragment (rows n_row, n_row + 8 of the transposed
// state, columns 8j + 2t + e) as two bf16 parts, [n][p] in the MN-major
// layout wgmma reads as C state^T's B operand
template <int NT>
__device__ __forceinline__ void store_state_parts(const float (&st)[16], __nv_bfloat16* hi,
                                                  __nv_bfloat16* lo, int n_row, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t vh, vl;
      split_pack(st[4 * j + 2 * i], st[4 * j + 2 * i + 1], vh, vl);
      const uint32_t off = swizzled_byte<TC_PS>(NT, n_row + 8 * i, j) + 4 * t;
      *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(hi) + off) = vh;
      *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(lo) + off) = vl;
    }
  fence_proxy_async();
}

// One warpgroup's 64 rows of a chunk, rows r0 = 64 * (its index) on, over
// the first NJ columns of the score tile (the causal mask leaves no more):
// y = exp(a_cs) (C state^T) + M x + D x, stored for the rows below Q.
template <int QT, int NT, int NJ>
__device__ __forceinline__ void chunk_rows(const __nv_bfloat16* ct, const __nv_bfloat16* bt,
                                           const __nv_bfloat16* xt, const __nv_bfloat16* st_hi,
                                           const __nv_bfloat16* st_lo, const float* dts,
                                           const float* acs, const float* eas, int r0, int Q,
                                           float Dh, __nv_bfloat16* yrow, size_t row_stride,
                                           int p_left) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4, row = r0 + 16 * warp + lane / 4;   // rows row, row + 8

  float s[NJ / 2], yv[16];
#pragma unroll
  for (int i = 0; i < NJ / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) yv[i] = 0.f;
  reg_fence(s);
  reg_fence(yv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk)
    wgmma_ss(s, kmajor_desc<NT>(ct, QT, r0, kk), kmajor_desc<NT>(bt, QT, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < NT / 16; ++kk) {
    const uint64_t dc = kmajor_desc<NT>(ct, QT, r0, kk);
    wgmma_ss_bmn(yv, dc, mnmajor_desc<TC_PS>(st_hi, NT, kk), kk > 0);
    wgmma_ss_bmn(yv, dc, mnmajor_desc<TC_PS>(st_lo, NT, kk), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(s);
  reg_fence(yv);

  float ar[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ar[i] = acs[row + 8 * i];
    const float ea = eas[row + 8 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yv[4 * j + 2 * i] *= ea;
      yv[4 * j + 2 * i + 1] *= ea;
    }
  }
  // M[i][j] = S[i][j] exp(a_cs[i] - a_cs[j]) dt[j] for j <= i, else 0
#pragma unroll
  for (int jj = 0; jj < NJ / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * jj + 2 * t + e;
      const float aj = acs[j], dj = dts[j];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float& v = s[4 * jj + 2 * i + e];
        v = j <= row + 8 * i ? v * expf(ar[i] - aj) * dj : 0.f;
      }
    }

  // y += M x with M as hi + lo
  uint32_t ph[NJ / 16][4], pl[NJ / 16][4];
#pragma unroll
  for (int kk = 0; kk < NJ / 16; ++kk) {
    split_fragment(s, kk, ph[kk], pl[kk]);
    reg_fence(ph[kk]);
    reg_fence(pl[kk]);
  }
  reg_fence(yv);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NJ / 16; ++kk) {
    const uint64_t dx = mnmajor_desc<TC_PS>(xt, QT, kk);
    wgmma_rs(yv, ph[kk], dx, 1);
    wgmma_rs(yv, pl[kk], dx, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(yv);

  // + D x, rounded once; rows past Q and columns past P are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p_left) continue;
      const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          reinterpret_cast<const unsigned char*>(xt) + swizzled_byte<TC_PS>(QT, r, j) + 4 * t));
      *reinterpret_cast<__nv_bfloat162*>(yrow + r * row_stride + col) = __floats2bfloat162_rn(
          yv[4 * j + 2 * i] + Dh * xf.x, yv[4 * j + 2 * i + 1] + Dh * xf.y);
    }
  }
}

// QT: the chunk's tile, 64 rows for Q <= 64, else 128; NT: N rounded up
// to 64 or 128 (B and C columns past N arrive zero-filled)
template <int QT, int NT>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap b_map,
              const __grid_constant__ CUtensorMap c_map, const __nv_bfloat16* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Dv, const float* h0,
              __nv_bfloat16* __restrict__ y, float* state_out, int S, int H, int P, int G,
              int N, int Q) {
  using bf16 = __nv_bfloat16;
  using L = TcLayout<QT, NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* xw_hi = reinterpret_cast<bf16*>(base + 2 * L::STAGE);
  bf16* xw_lo = xw_hi + QT * TC_PS;
  bf16* st_hi = xw_lo + QT * TC_PS;
  bf16* st_lo = st_hi + NT * TC_PS;
  float* dts = reinterpret_cast<float*>(st_lo + NT * TC_PS);
  float* acs = dts + QT;   // a_cs; rows past Q hold a_cs[Q-1]
  float* wds = acs + QT;   // dt exp(a_cs[Q-1] - a_cs): 0 past Q
  float* eas = wds + QT;   // exp(a_cs)
  uint64_t* bars = reinterpret_cast<uint64_t*>(eas + QT);
  auto c_tile = [=](int stg) { return reinterpret_cast<bf16*>(base + stg * L::STAGE); };
  auto b_tile = [=](int stg) { return reinterpret_cast<bf16*>(base + stg * L::STAGE + L::CB); };
  auto x_tile = [=](int stg) {
    return reinterpret_cast<bf16*>(base + stg * L::STAGE + 2 * L::CB);
  };

  const int p0 = blockIdx.x * TC_PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int t = lane % 4, n_row = 64 * wg + 16 * warp + lane / 4;   // the state's rows
  const int n_chunks = S / Q;
  const bool owns_state = wg < NT / 64;
  const float Ah = A[h];
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;
  const CUtensorMap* xm = &x_map;
  const CUtensorMap* bm = &b_map;
  const CUtensorMap* cm = &c_map;

  // stage stg <- chunk c's rows [c Q, c Q + QT) of C, B and x
  auto load = [=](int stg, int c) {
    mbar_expect(&bars[stg], L::STAGE);
#pragma unroll
    for (int box = 0; box < NT / 64; ++box) {
      tma_load(c_tile(stg) + box * QT * 64, cm, &bars[stg], 64 * box, g, c * Q, b);
      tma_load(b_tile(stg) + box * QT * 64, bm, &bars[stg], 64 * box, g, c * Q, b);
    }
    tma_load(x_tile(stg), xm, &bars[stg], p0, h, c * Q, b);
  };
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
    load(0, 0);
    if (n_chunks > 1) load(1, 1);
  }

  // this block's part of the carried state, transposed: st[4j + 2i + e] =
  // state[p0 + 8j + 2t + e][n_row + 8i]; each thread reads its own
  // entries of h0 here and writes the same entries of state_out at the end
  float st[16];
  const size_t state_base = ((size_t)b * H + h) * P * N;
  if (owns_state) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_row + 8 * i, p = p0 + 8 * j + 2 * t + e;
          st[4 * j + 2 * i + e] =
              h0 != nullptr && n < N && p < P ? h0[state_base + (size_t)p * N + n] : 0.f;
        }
    store_state_parts<NT>(st, st_hi, st_lo, n_row, t);
  }

  // warp 0: the chunk's dt, a run of PER rows a lane, loaded a chunk ahead
  constexpr int PER = QT / 32;
  float dnext[PER];
  auto load_dt = [&](int c) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = lane * PER + k;
      dnext[k] = i < Q ? __bfloat162float(dt[((size_t)b * S + (size_t)c * Q + i) * H + h]) : 0.f;
    }
  };
  if (tid < 32) load_dt(0);
  __syncthreads();   // the barriers' init and the state's parts

  for (int c = 0; c < n_chunks; ++c) {
    const int stg = c & 1;
    if (tid < 32) {
      // inclusive cumsum of the log-decay: each lane sums its run, the
      // lanes' totals are scanned with shuffles; rows past Q (dt = 0) keep
      // a_cs[Q-1]
      float d[PER], cs[PER], run = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        d[k] = dnext[k];
        run += Ah * d[k];
        cs[k] = run;
      }
      if (c + 1 < n_chunks) load_dt(c + 1);
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
      float mine = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (lane * PER + k == Q - 1) mine = cs[k] + before;
      const float a_last = __shfl_sync(0xffffffffu, mine, (Q - 1) / PER);
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = lane * PER + k;
        const float a = i < Q ? cs[k] + before : a_last;
        dts[i] = d[k];
        acs[i] = a;
        wds[i] = d[k] * expf(a_last - a);
        eas[i] = expf(a);
      }
    }
    mbar_wait(&bars[stg], (c >> 1) & 1);
    __syncthreads();   // (a) the scan; the chunk's tiles have landed

    // x o wd as two bf16 parts, in x's layout (rows past Q: wd = 0)
    {
      const unsigned char* xt = reinterpret_cast<const unsigned char*>(x_tile(stg));
      for (int k = tid; k < QT * TC_PS / 2; k += TC_THREADS) {
        const int q = k / (TC_PS / 2), pr = k % (TC_PS / 2);
        const uint32_t off = swizzled_byte<TC_PS>(QT, q, pr / 4) + 4 * (pr % 4);
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xt + off));
        const float w = wds[q];
        uint32_t vh, vl;
        split_pack(xf.x * w, xf.y * w, vh, vl);
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(xw_hi) + off) = vh;
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(xw_lo) + off) = vl;
      }
      fence_proxy_async();
    }

    // y of the chunk's rows: 64 a warpgroup
    bf16* yrow = y + ((size_t)b * S + (size_t)c * Q) * H * P + (size_t)h * P + p0;
    if (wg == 0) {
      chunk_rows<QT, NT, 64>(c_tile(stg), b_tile(stg), x_tile(stg), st_hi, st_lo, dts, acs,
                             eas, 0, Q, Dh, yrow, (size_t)H * P, P - p0);
    } else if constexpr (QT == 128) {
      chunk_rows<QT, NT, 128>(c_tile(stg), b_tile(stg), x_tile(stg), st_hi, st_lo, dts, acs,
                              eas, 64, Q, Dh, yrow, (size_t)H * P, P - p0);
    }
    __syncthreads();   // (b) the state's parts are read; x o wd is stored

    // state^T = state^T exp(a_cs[Q-1]) + B^T (x o wd), x o wd as hi + lo
    if (owns_state) {
      const float decay = expf(acs[QT - 1]);
#pragma unroll
      for (int k = 0; k < 16; ++k) st[k] *= decay;
      const bf16* bt = b_tile(stg) + wg * QT * 64;   // the 64 columns n of this warpgroup
      reg_fence(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        const uint64_t db = mnmajor_desc<64>(bt, QT, kk);
        wgmma_ss_mn(st, db, mnmajor_desc<TC_PS>(xw_hi, QT, kk), 1);
        wgmma_ss_mn(st, db, mnmajor_desc<TC_PS>(xw_lo, QT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(st);
      store_state_parts<NT>(st, st_hi, st_lo, n_row, t);
    }
    __syncthreads();   // (c) stage stg is free; the new state's parts are stored
    if (tid == 0 && c + 2 < n_chunks) load(stg, c + 2);
  }

  if (owns_state) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n_row + 8 * i, p = p0 + 8 * j + 2 * t + e;
          if (n < N && p < P) state_out[state_base + (size_t)p * N + n] = st[4 * j + 2 * i + e];
        }
  }
}

// A map of a 4-D bf16 tensor (d3, d2, d1, d0), d0 contiguous, read in
// boxes of `rows` (along d2) x box0 (along d0) elements of one (d3, d1)
// index, with the swizzle of a box0-wide row (64 or 128 bytes); elements
// past any edge are zero-filled
cudaError_t ssd_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int d3,
                    int box0, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d1 * d0 * 2,
                                 (cuuint64_t)d2 * d1 * d0 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box0, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = 2 * box0 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int QT, int NT>
cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* B, const void* C,
                      const void* D, const void* h0, void* y, void* state_out, int Bb, int S,
                      int H, int P, int G, int N, int Q, cudaStream_t stream) {
  // x (Bb, S, H, P) in boxes of QT rows x 32 p; B, C (Bb, S, G, N) in
  // boxes of QT rows x 64 n
  CUtensorMap xm, bm, cm;
  cudaError_t e = ssd_map(&xm, x, P, H, S, Bb, TC_PS, QT);
  if (e == cudaSuccess) e = ssd_map(&bm, B, N, G, S, Bb, 64, QT);
  if (e == cudaSuccess) e = ssd_map(&cm, C, N, G, S, Bb, 64, QT);
  if (e != cudaSuccess) return e;
  auto kern = ssd_tc_kernel<QT, NT>;
  static bool configured = false;   // once per instantiation (one card)
  if (!configured) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TcLayout<QT, NT>::bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((P + TC_PS - 1) / TC_PS, H, Bb);
  kern<<<grid, TC_THREADS, TcLayout<QT, NT>::bytes, stream>>>(
      xm, bm, cm, static_cast<const __nv_bfloat16*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(D), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(state_out), S, H, P, G, N, Q);
  return cudaGetLastError();
}

cudaError_t launch_tc_tiles(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, const void* D, const void* h0, void* y,
                            void* state_out, int Bb, int S, int H, int P, int G, int N, int Q,
                            cudaStream_t st) {
  if (Bb > 65535) return cudaErrorInvalidValue;   // the grid's z
  if (Q <= 64 && N <= 64)
    return launch_tc<64, 64>(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
  if (Q <= 64)
    return launch_tc<64, 128>(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
  if (N <= 64)
    return launch_tc<128, 64>(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
  return launch_tc<128, 128>(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores), for x,
// dt, B, C and y alike; A, D, h0 and state_out are float32.  D and h0 may
// be null (no skip, a zero state); state_out may equal h0.  Q is any chunk
// from 1 to 128 dividing S; P is a multiple of 16; N a multiple of 32 up
// to 128; G divides H; every pointer is 16-byte aligned.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ssd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* h0, void* y, void* state_out, int Bb, int S, int H,
                   int P, int G, int N, int Q, int dtype, void* stream) {
  if (Bb <= 0 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || P % PS != 0 ||
      P / PS > 64 || G <= 0 || H % G != 0 || N <= 0 || N % 32 != 0 || N > NMAX || Q < 1 ||
      Q > QMAX || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
  if (dtype == 1)
    return (int)launch_tc_tiles(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
