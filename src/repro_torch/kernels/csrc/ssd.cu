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
// is fused, as in ssd_chunked, so y is rounded once.
//
// What bounds it on the card: at the serving shapes (a 256-row prefill
// chunk at batch 1; mamba2-370m H=32, P=64, N=128, zamba2-1.2b H=64, P=64,
// N=64) the function moves 4-6 MB (x and y in bf16, the f32 state in and
// out) and does ~1 GFLOP, so bytes bound it (1-2 us at 3.35 TB/s).  This
// first kernel is bound instead by its own CUDA-core f32 arithmetic and
// shared-memory traffic: each block recomputes the chunk's C B^T.
//
// Design.  The TPU kernel carried the (P,N) state in VMEM across a
// sequential ("arbitrary") grid axis of chunks; blocks here run in no
// order, so one block loops over the chunks itself and keeps the state in
// shared memory.  A block owns (b, h, a slice of PS=16 of the P state
// rows): y[:, p] needs only state[p, :] and x[:, p], so the slices are
// independent, and a batch-1 chunk still gives H * P/16 blocks (128 for
// mamba2, 256 for zamba2) instead of H.  The price is that each of the
// P/16 blocks of a head computes the chunk's scores C B^T again.  Per
// chunk the block stages dt, B, C (as f32, rows padded to N+1 floats so a
// warp's 32 rows fall in 32 banks) and its 16 columns of x; warp 0 scans
// the log-decay; the masked scores M = (C B^T) o L o dt are built in
// 4-row strips (lane j covers columns j, j+32, ...; only j <= i is
// computed or exponentiated); then y (16 row lanes x 16 columns per
// thread group) and the state update (lanes over N, warps over P) follow.
// At Q = N = 128 the staging takes 212 KB of shared memory: one block
// per SM.  The final state goes to state_out, which may be h0 itself:
// every block reads its own rows of h0 before it writes them, and no
// other block touches them.
//
// Not done yet (ROADMAP queue 2 item 7): tensor cores (mma.sync, then
// wgmma) for C B^T, M x and the state products; computing C B^T once per
// (b, chunk, group) instead of once per block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PS = 16;                    // state rows (head dims p) per block
constexpr int QMAX = 128;                 // largest chunk
constexpr int NMAX = 128;                 // largest state size
constexpr int ROW_LANES = THREADS / PS;   // y: threads down the rows
constexpr int RMAX = QMAX / ROW_LANES;    // y: rows per thread
constexpr int PK = PS / WARPS;            // state update: p rows per thread
constexpr int MMAX = NMAX / 32;           // state update: n columns per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
           const float* h0, T* __restrict__ y, float* state_out, int S, int H, int P, int G,
           int N, int Q) {
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
      const float d = i < Q ? to_f(dt[((size_t)b * S + s0 + i) * H + h]) : 0.f;
      dts[i] = d;
      acs[i] = Ah * d;
    }
    for (int i = tid; i < Qp * N; i += THREADS) {
      const int q = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (q < Q) {
        const size_t off = (((size_t)b * S + s0 + q) * G + g) * N + n;
        bv = to_f(Bm[off]);
        cv = to_f(Cm[off]);
      }
      Bs[q * ldn + n] = bv;
      Cs[q * ldn + n] = cv;
    }
    for (int i = tid; i < Qp * PS; i += THREADS) {
      const int q = i / PS, p = i % PS;
      Xs[i] = q < Q ? to_f(x[(((size_t)b * S + s0 + q) * H + h) * P + p0 + p]) : 0.f;
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
      const float before = tot - run;
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
          y[(((size_t)b * S + s0 + i) * H + h) * P + p0 + p] = from_f<T>(v);
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

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* h0, void* y, void* state_out, int Bb, int S,
                   int H, int P, int G, int N, int Q, cudaStream_t stream) {
  auto kern = ssd_kernel<T>;
  // above 48 KB only after opting in; set once per instantiation (one card)
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(smem_floats(QMAX, NMAX) * sizeof(float)));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(Bb, H, P / PS);
  kern<<<grid, THREADS, smem_floats(Q, N) * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(state_out), S,
      H, P, G, N, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y alike); A, D, h0 and
// state_out are float32.  D and h0 may be null (no skip, a zero state);
// state_out may equal h0.  Q is a power of two from 2 to 128 dividing S;
// P is a multiple of 16; N a multiple of 32 up to 128; G divides H.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd(const void* x, const void* dt, const void* A, const void* B, const void* C,
                   const void* D, const void* h0, void* y, void* state_out, int Bb, int S, int H,
                   int P, int G, int N, int Q, int dtype, void* stream) {
  if (Bb <= 0 || S <= 0 || H <= 0 || H > 65535 || P <= 0 || P % PS != 0 || P / PS > 64 ||
      G <= 0 || H % G != 0 || N <= 0 || N % 32 != 0 || N > NMAX || Q < 2 || Q > QMAX ||
      (Q & (Q - 1)) != 0 || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N, Q, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dt, A, B, C, D, h0, y, state_out, Bb, S, H, P, G, N,
                                      Q, st);
  return (int)cudaErrorInvalidValue;
}
