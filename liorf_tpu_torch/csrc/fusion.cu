// The IMU fusion correction (imu/fusion.py::fusion_step) in one launch, for
// NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/fusion_step.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package jits fusion_step
// (liorf_tpu/imu/fusion.py:98-213) into one XLA program: jax.jacfwd of a
// 36-row residual in 30 tangents, gn_iters column-scaled QR least-squares
// steps under lax.scan, then a Schur-complement marginalization and a
// Cholesky factor. Op by op on the card that was five torch.func.jacfwd
// passes, four library QRs and their solves a call, thousands of launches and
// ~235 ms of host time a frame. Here one thread block a lane runs all of it:
//
//   set-up: the IMU whitening (Cholesky of cov + 1e-10 I, its triangular
//     inverse; NaN where cov is not positive definite), the bias and
//     correction weights (the sigmas come by value), the IMU prediction of
//     state j;
//   gn_iters GN iterations: the residual and its 36 x 30 Jacobian in closed
//     form (jacfwd's own derivative: so3_log's branch by branch from
//     so3_log.cuh, so3_exp's at the bias-corrected rotation), the column
//     scale, a Householder QR of [J / d | r] (a warp a column), back
//     substitution on R + 1e-7 I (a warp a row), both retracts;
//   the marginalization, in float64 (in float32 it loses the information's
//     velocity block to ~1 %): H = J^T J, its Jacobi scaling, LU with partial
//     pivoting of [A | B], C - B^T A^-1 B, symmetrized, its Cholesky factor
//     (NaN on failure), W = chol(S)^T d_j rounded to float; then the
//     divergence flag.
//
// J (36 x 31 with r), H and the factorizations live in shared memory. A sum
// on a dependent chain (a QR column's dot, a substitution's row, a Cholesky
// entry, the whitening's triangular inverse) is one warp's halving tree
// (warp_tree: the tree's pairing is the shuffle-down order, so one warp
// gives tree_sum's bits with no serial chain and no array); the LU's pivot is
// a warp's arg-max. A sum of which hundreds are independent (H, the Schur
// complement, the system's whitened rows) stays one thread's tree_sum.
//
// The order contract (ops/fusion_step.py::fusion_step_plain spells it in
// torch ops; on the card the two agree bit for bit): every product, sum,
// quotient and square root is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn and their __d*_rn twins in the marginalization's
// float64: nvcc would contract to FMAs); a 3-term product sum
// is (a0 b0 + a1 b1) + a2 b2; every longer sum is the halving tree over all
// its terms, zeros padded to a power of two and masked terms +0.0; sin, cos
// and atan2 are taken in double and rounded to float, as the plain version
// takes them. No atomics: every order is fixed.
//
// What bounds it: neither bytes (~1.9 KB a lane) nor operations (~0.4 MFLOP
// a lane) but latency: the dependent chains (a QR column step, the back
// substitution's 30 rows, the 15 steps of the LU and of the Cholesky factor)
// and the block barriers between them. The QR keeps each column in one
// warp's registers; each step is one barrier: the owner of column k + 1
// reflects it and forms its reflector at once (into the next of three
// buffers) while the other warps reflect the later columns. One lane is one
// block of 16 warps on one SM; the lanes of a vmapped call run side by side. chip_smoke.py's fusion_profile phase times each phase by
// clock cycles (a build with -DLIORF_FUSION_PROFILE).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "so3_exp.cuh"
#include "so3_log.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 36;  // residual rows: prior 15, IMU 9, bias 6, lidar 6
constexpr int kTan = 30;   // tangents: state i 15, state j 15
constexpr int kCols = 31;  // J and r

__host__ __device__ constexpr int pow2ceil(int n) { return n <= 1 ? 1 : 2 * pow2ceil((n + 1) / 2); }

// the marginalization's float64 arithmetic, each operation rounded on its own
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double root(double x) { return __dsqrt_rn(x); }

// The sum of f(0..N-1) as a halving tree: zeros padded to a power of two P,
// element i added to element i + P/2, and so on down to one.
template <int N, class F>
__device__ __forceinline__ auto tree_sum(F f) -> decltype(f(0)) {
  using T = decltype(f(0));
  constexpr int P = pow2ceil(N);
  if constexpr (P == 1) {
    return f(0);
  } else {
    T y[P / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i)
      y[i] = add(i < N ? f(i) : T(0), i + P / 2 < N ? f(i + P / 2) : T(0));
#pragma unroll
    for (int h = P / 4; h >= 1; h >>= 1)
#pragma unroll
      for (int i = 0; i < h; ++i) y[i] = add(y[i], y[i + h]);
    return y[0];
  }
}

#ifdef LIORF_FUSION_PROFILE
// Development only (built with -DLIORF_FUSION_PROFILE): clock cycles thread 0
// of block 0 spends in each phase (set-up and whitening, build_system, the
// QR, back substitution and retracts, H, LU, A^-1 B and the Schur
// complement, the Cholesky factor and the outputs), summed over the GN
// iterations; each stamp follows a block barrier. The last entry holds the
// previous stamp.
constexpr int kProfPhases = 8;
__device__ long long g_prof[kProfPhases + 1];
__device__ __forceinline__ void prof(int n) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    const long long now = clock64();
    if (n >= 0) g_prof[n] += now - g_prof[kProfPhases];
    g_prof[kProfPhases] = now;
  }
}
__device__ __forceinline__ void prof_start() {
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int j = 0; j < kProfPhases; ++j) g_prof[j] = 0;
  prof(-1);
}
#else
__device__ __forceinline__ void prof(int) {}
__device__ __forceinline__ void prof_start() {}
#endif

// The same halving tree over f(0..N-1) (N <= 64) by one warp, every lane's
// result: lane l holds element l (and, for P = 64, element l + 32 added to
// it: the tree's first level), then the shuffle-down levels h = P/2 ... 1
// pair element i with i + h exactly as tree_sum does. No serial chain, no
// array: the same rounded additions of the same operands.
template <int N, class F>
__device__ __forceinline__ auto warp_tree(F f, int lane) -> decltype(f(0)) {
  using T = decltype(f(0));
  constexpr int P = pow2ceil(N);
  static_assert(P <= 64, "a warp's tree holds at most 64 terms");
  T v;
  if constexpr (P == 64) {
    v = add(f(lane), lane + 32 < N ? f(lane + 32) : T(0));
  } else {
    v = lane < N ? f(lane) : T(0);
  }
#pragma unroll
  for (int h = (P < 64 ? P : 32) / 2; h >= 1; h >>= 1) v = add(v, __shfl_down_sync(kFull, v, h));
  return __shfl_sync(kFull, v, 0);
}

// torch.clamp(x, min=lo): NaN stays NaN
template <class T>
__device__ __forceinline__ T clamp_min(T x, T lo) { return x < lo ? lo : x; }

struct Args {
  const float *R, *p, *v, *ba, *bg, *W;                    // the prior filter
  const float *dR, *dv, *dp, *dt, *dR_dbg, *dv_dba, *dv_dbg, *dp_dba, *dp_dbg, *cov;
  const float *ba_lin, *bg_lin;                            // the window's bias
  const float *lR, *lp;                                    // the lidar pose
  const uint8_t* deg;
  float *oR, *op, *ov, *oba, *obg, *oW;
  uint8_t* odiv;
  float acc_rw, gyr_rw, gravity, rot_sigma, trans_sigma, deg_sigma, max_v, max_b;
  int gn_iters, lanes;
};

struct State {
  float R[3][3], p[3], v[3], ba[3], bg[3];
};

struct Shared {
  State prior, si, sj;
  float Wp[15][15];
  float dR0[3][3], dv0[3], dp0[3], T, dRdbg[3][3], dvdba[3][3], dvdbg[3][3], dpdba[3][3],
      dpdbg[3][3], bal[3], bgl[3], lR[3][3], lp[3];
  float cov[9][9], L9[9][9], imuW[9][9];
  float bW[6], cW[6];
  // one system's pieces: the logs' values and derivatives (m, direction)
  float lpv[3], dlp[3][3], llv[3], dll[3][3], av[3], ap[3];
  float raw[9][kCols];   // the IMU rows before whitening (r in column 30)
  float A[kRows][kCols];  // J | r, then the QR in place
  float d[kTan];
  float hv[3][kRows];  // the Householder vectors of three successive columns
  float tau[3];
  float y[kTan];
  // the marginalization, in float64
  double H[kTan][kTan];
  double dh[kTan];
  double Mx[15][kTan];  // [A | B] of the Schur complement, eliminated in place
  double X[15][15];
  double S[15][15];
  double L[15][15];
  int fail;
};

__device__ __forceinline__ void load(float* dst, const float* src, int n, int tid) {
  for (int i = tid; i < n; i += kThreads) dst[i] = src[i];
}

// A^T x
__device__ __forceinline__ void mtv(const float A[3][3], const float x[3], float out[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = sum3(mul(A[0][c], x[0]), mul(A[1][c], x[1]), mul(A[2][c], x[2]));
}

// so3_exp's forward-mode derivative at w along dw, in the branch w takes
__device__ __forceinline__ void so3_exp_jvp(const float w[3], const Exp& e, const float dw[3],
                                            float dR[3][3]) {
  const float dth2 = mul(sum3(mul(w[0], dw[0]), mul(w[1], dw[1]), mul(w[2], dw[2])), 2.0f);
  const float dst = e.small ? 0.0f : dvd(dth2, mul(e.st, 2.0f));
  const float dA = e.small ? -dvd(dth2, 6.0f) : dvd(sub(mul(e.cs, dst), mul(e.A, dst)), e.st);
  const float dB = e.small ? -dvd(dth2, 24.0f)
                           : dvd(sub(dvd(mul(e.sn, dst), e.st), mul(mul(e.B, 2.0f), dst)), e.st);
  float W[3][3], dW[3][3], W2[3][3], dWW[3][3], WdW[3][3];
  hat3(w, W);
  hat3(dw, dW);
  mm(W, W, W2);
  mm(dW, W, dWW);
  mm(W, dW, WdW);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dR[a][c] = add(add(add(mul(dA, W[a][c]), mul(e.A, dW[a][c])), mul(dB, W2[a][c])),
                     mul(e.B, add(dWW[a][c], WdW[a][c])));
}

// The bias-corrected deltas at state i's biases: dR0 exp(dR_dbg dbg) and the
// exp's argument and scalars (for its derivative), dv and dp.
__device__ __forceinline__ void corrected(const Shared& s, const float ba[3], const float bg[3],
                                          float w[3], Exp& e, float dRc[3][3], float dvc[3],
                                          float dpc[3]) {
  float dba[3], dbg[3], Ew[3][3], t1[3], t2[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    dba[m] = sub(ba[m], s.bal[m]);
    dbg[m] = sub(bg[m], s.bgl[m]);
  }
  mv(s.dRdbg, dbg, w);
  exp_terms(w, e);
  so3_exp(w, Ew);
  mm(s.dR0, Ew, dRc);
  mv(s.dvdba, dba, t1);
  mv(s.dvdbg, dbg, t2);
#pragma unroll
  for (int m = 0; m < 3; ++m) dvc[m] = add(add(s.dv0[m], t1[m]), t2[m]);
  mv(s.dpdba, dba, t1);
  mv(s.dpdbg, dbg, t2);
#pragma unroll
  for (int m = 0; m < 3; ++m) dpc[m] = add(add(s.dp0[m], t1[m]), t2[m]);
}

__device__ __forceinline__ float gravity_at(const Args& a, int m) {
  return m == 2 ? -a.gravity : 0.0f;
}

// The IMU prediction of state j from the prior mean (preintegration.py::predict).
__device__ __forceinline__ void predict(const Args& a, Shared& s) {
  const State& P = s.prior;
  float w[3], dRc[3][3], dvc[3], dpc[3], t1[3], t2[3];
  Exp e;
  corrected(s, P.ba, P.bg, w, e, dRc, dvc, dpc);
  mv(P.R, dpc, t1);
  mv(P.R, dvc, t2);
  const float T = s.T;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float g = gravity_at(a, m);
    s.sj.p[m] = add(add(add(P.p[m], mul(P.v[m], T)), mul(mul(mul(0.5f, g), T), T)), t1[m]);
    s.sj.v[m] = add(add(P.v[m], mul(g, T)), t2[m]);
    s.sj.ba[m] = P.ba[m];
    s.sj.bg[m] = P.bg[m];
  }
  mm(P.R, dRc, s.sj.R);
}

// The block's lower Cholesky factor of M (N x N, its lower triangle read) into
// L (zeroed, *fail = 0 and synced by the caller), column by column, a warp an
// entry of the column; each entry's sum over the earlier columns a halving
// tree (warp_tree). *fail is set where a pivot is not > 0.
template <int N, class T>
__device__ __forceinline__ void cholesky(const T* M, T* L, int* fail) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  static_assert(N <= kWarps, "a warp an entry of a column");
  for (int j = 0; j < N; ++j) {
    const int i = j + warp;
    T sij = T(0);
    if (i < N) {
      sij = sub(M[i * N + j], warp_tree<N>([&](int k) {
                  return k < j ? mul(L[i * N + k], L[j * N + k]) : T(0);
                }, lane));
      if (i == j && lane == 0) {
        if (!(sij > T(0))) *fail = 1;
        L[j * N + j] = root(sij);
      }
    }
    __syncthreads();
    if (i < N && i > j && lane == 0) L[i * N + j] = dvd(sij, L[j * N + j]);
    __syncthreads();
  }
}

// so3_log's value at Q and its derivative along dQ -> dw
__device__ __forceinline__ void log_dir(const float Q[3][3], const float dQ[3][3], float w[3],
                                        float dw[3]) {
  Log L;
  log_value(Q, L);
  log_tangent(L, dQ, dw);
#pragma unroll
  for (int m = 0; m < 3; ++m) w[m] = L.w[m];
}

// The residual rows and their Jacobian at (si, sj) into s.A: three barriers.
__device__ __forceinline__ void build_system(const Args& a, Shared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const State &I = s.si, &J = s.sj, &P = s.prior;
  // 1. the rotation derivatives, one thread a direction, each kind of
  // direction on a warp of its own (so the kinds run side by side, not one
  // after the other in one warp); the IMU's linear rows
  if (warp == 0 && lane < 3) {  // prior: log at PR^T Ri along (PR^T Ri) hat(e_k)
    const int k = lane;
    float Q[3][3], dQ[3][3], w[3], dw[3];
    mtm(P.R, I.R, Q);
    q_hat(Q, k, dQ);
    log_dir(Q, dQ, w, dw);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      s.dlp[m][k] = dw[m];
      if (k == 0) s.lpv[m] = w[m];
    }
  } else if (warp >= 1 && warp <= 3 && lane < 3) {  // IMU rotation row: theta_i, theta_j, bg_i
    const int job = warp - 1, k = lane;
    float w[3], dRc[3][3], dvc[3], dpc[3], M[3][3], E[3][3], dE[3][3], X[3][3], lw[3], dw[3];
    Exp e;
    corrected(s, I.ba, I.bg, w, e, dRc, dvc, dpc);
    mtm(I.R, J.R, M);
    mtm(dRc, M, E);
    if (job == 0) {
      hat_p(M, k, X);
      mtm(dRc, X, dE);
    } else if (job == 1) {
      q_hat(E, k, dE);
    } else {
      const float dwk[3] = {s.dRdbg[0][k], s.dRdbg[1][k], s.dRdbg[2][k]};
      float dExp[3][3], Y[3][3];
      so3_exp_jvp(w, e, dwk, dExp);
      mm(s.dR0, dExp, Y);
      mtm(Y, M, dE);
    }
    log_dir(E, dE, lw, dw);
    const int col = job == 0 ? k : (job == 1 ? 15 + k : 12 + k);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      s.raw[m][col] = dw[m];
      if (job == 0 && k == 0) s.raw[m][kTan] = lw[m];
    }
  } else if (warp == 4 && lane < 3) {  // lidar: log at lR^T Rj along (lR^T Rj) hat(e_k)
    const int k = lane;
    float Q[3][3], dQ[3][3], w[3], dw[3];
    mtm(s.lR, J.R, Q);
    q_hat(Q, k, dQ);
    log_dir(Q, dQ, w, dw);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      s.dll[m][k] = dw[m];
      if (k == 0) s.llv[m] = w[m];
    }
  } else if (warp == 5 && lane == 0) {  // IMU velocity and position rows' values
    float w[3], dRc[3][3], dvc[3], dpc[3], uv[3], up[3];
    Exp e;
    corrected(s, I.ba, I.bg, w, e, dRc, dvc, dpc);
    const float T = s.T;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float g = gravity_at(a, m);
      uv[m] = sub(sub(J.v[m], I.v[m]), mul(g, T));
      up[m] = sub(sub(sub(J.p[m], I.p[m]), mul(I.v[m], T)), mul(mul(mul(0.5f, g), T), T));
    }
    mtv(I.R, uv, s.av);
    mtv(I.R, up, s.ap);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      s.raw[3 + m][kTan] = sub(s.av[m], dvc[m]);
      s.raw[6 + m][kTan] = sub(s.ap[m], dpc[m]);
    }
  }
  __syncthreads();
  // 2. the IMU rows' other entries; the prior, bias and lidar rows of A
  for (int e = tid; e < 9 * kTan; e += kThreads) {
    const int m = e / kTan, c = e % kTan, blk = c / 3, q = c % 3;
    if (m < 3) {
      if (blk != 0 && blk != 4 && blk != 5) s.raw[m][c] = 0.0f;
      continue;
    }
    const int r = (m - 3) % 3;
    const bool vel = m < 6;
    float x = 0.0f;
    if (blk == 0) {  // theta_i: hat(a)
      const float* av = vel ? s.av : s.ap;
      float H3[3][3];
      hat3(av, H3);
      x = H3[r][q];
    } else if (blk == 1 && !vel) {
      x = -I.R[q][r];
    } else if (blk == 2) {
      x = vel ? -I.R[q][r] : -mul(I.R[q][r], s.T);
    } else if (blk == 3) {
      x = vel ? -s.dvdba[r][q] : -s.dpdba[r][q];
    } else if (blk == 4) {
      x = vel ? -s.dvdbg[r][q] : -s.dpdbg[r][q];
    } else if ((blk == 7 && vel) || (blk == 6 && !vel)) {
      x = I.R[q][r];
    }
    s.raw[m][c] = x;
  }
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    const int row = e / kCols, c = e % kCols;
    if (row >= 15 && row < 24) continue;  // the IMU rows: step 3
    float x = 0.0f;
    if (row < 15) {  // prior
      if (c == kTan) {
        x = tree_sum<15>([&](int m) {
          float loc;
          if (m < 3) loc = s.lpv[m];
          else if (m < 6) loc = sub(I.p[m - 3], P.p[m - 3]);
          else if (m < 9) loc = sub(I.v[m - 6], P.v[m - 6]);
          else if (m < 12) loc = sub(I.ba[m - 9], P.ba[m - 9]);
          else loc = sub(I.bg[m - 12], P.bg[m - 12]);
          return mul(s.Wp[row][m], loc);
        });
      } else if (c < 3) {
        x = sum3(mul(s.Wp[row][0], s.dlp[0][c]), mul(s.Wp[row][1], s.dlp[1][c]),
                 mul(s.Wp[row][2], s.dlp[2][c]));
      } else if (c < 15) {
        x = s.Wp[row][c];
      }
    } else if (row < 30) {  // bias random walk
      const int m = row - 24;
      if (c == kTan) x = mul(s.bW[m], m < 3 ? sub(J.ba[m], I.ba[m]) : sub(J.bg[m - 3], I.bg[m - 3]));
      else if (c == 9 + m) x = -s.bW[m];
      else if (c == 24 + m) x = s.bW[m];
    } else {  // lidar
      const int m = row - 30;
      if (c == kTan) x = mul(s.cW[m], m < 3 ? s.llv[m] : sub(J.p[m - 3], s.lp[m - 3]));
      else if (m < 3 && c >= 15 && c < 18) x = mul(s.cW[m], s.dll[m][c - 15]);
      else if (m >= 3 && c == 15 + m) x = s.cW[m];
    }
    s.A[row][c] = x;
  }
  __syncthreads();
  // 3. the whitened IMU rows
  for (int e = tid; e < 9 * kCols; e += kThreads) {
    const int r = e / kCols, c = e % kCols;
    s.A[15 + r][c] = tree_sum<9>([&](int m) { return mul(s.imuW[r][m], s.raw[m][c]); });
  }
  __syncthreads();
  prof(1);
}

__device__ __forceinline__ void retract(State& st, const float* dx) {
  float E[3][3], R[3][3];
  so3_exp(dx, E);
  mm(st.R, E, R);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int c = 0; c < 3; ++c) st.R[a][c] = R[a][c];
    st.p[a] = add(st.p[a], dx[3 + a]);
    st.v[a] = add(st.v[a], dx[6 + a]);
    st.ba[a] = add(st.ba[a], dx[9 + a]);
    st.bg[a] = add(st.bg[a], dx[12 + a]);
  }
}

// The QR keeps each column in its warp's registers from the column scale to
// the back substitution: column j belongs to warp j % kWarps, lane l holds
// its rows l and l + 32 (the latter zero past row 35).
constexpr int kOwn = (kCols + kWarps - 1) / kWarps;  // columns a warp holds
using Column = float[2];

// The halving tree over the 36 rows of f(row, value of the row in c).
template <class F>
__device__ __forceinline__ float column_tree(const Column& c, F f, int lane) {
  return warp_tree<kRows>([&](int i) { return f(i, i < 32 ? c[0] : c[1]); }, lane);
}

// Householder reflector of column k (its owner; the column final on rows
// >= k): LAPACK's beta, tau and v (ops/fusion_step.py::householder_solve)
// into hv[buf] and tau[buf]; then R[k][k] = beta in the column.
__device__ __forceinline__ void reflector(Shared& s, Column& c, int k, int buf, int lane) {
  const float xn2 = column_tree(c, [&](int i, float x) { return i > k ? mul(x, x) : 0.0f; }, lane);
  const float alpha = __shfl_sync(kFull, k < 32 ? c[0] : c[1], k & 31);
  const bool nz = xn2 != 0.0f;
  const float norm = __fsqrt_rn(add(mul(alpha, alpha), xn2));
  const float beta = nz ? (alpha >= 0.0f ? -norm : norm) : alpha;
  const float tau = nz ? dvd(sub(beta, alpha), beta) : 0.0f;
  const float den = sub(alpha, beta);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = lane + 32 * h;
    if (i < kRows) s.hv[buf][i] = i > k ? (nz ? dvd(c[h], den) : 0.0f) : (i == k ? 1.0f : 0.0f);
  }
  if (lane == 0) s.tau[buf] = tau;
  if (k < 32) {
    if (lane == k) c[0] = beta;
  } else if (lane == k - 32) {
    c[1] = beta;
  }
}

// Step k on a later column: w = v^T a_j (the halving tree over all 36
// rows), a_j -= tau w v on rows k.. (v's rows h0, h1 of this lane).
__device__ __forceinline__ void reflect(Column& c, int k, float h0, float h1, float tau, int lane) {
  const float t = mul(tau, column_tree(c, [&](int i, float x) { return mul(i < 32 ? h0 : h1, x); }, lane));
  if (lane >= k) c[0] = sub(c[0], mul(t, h0));
  if (lane + 32 < kRows && lane + 32 >= k) c[1] = sub(c[1], mul(t, h1));
}

// Step k's reflector (buffer k % 3) on a later column, read from shared memory.
__device__ __forceinline__ void reflect_step(const Shared& s, Column& c, int k, int lane) {
  const int b = k % 3;
  reflect(c, k, s.hv[b][lane], lane + 32 < kRows ? s.hv[b][lane + 32] : 0.0f, s.tau[b], lane);
}

// One GN iteration on the system in s.A: column scale, Householder QR of
// [J / d | r], back substitution, both retracts. Each step k, the owner of
// column k + 1 reflects it and forms its reflector at once (into the next of
// three buffers) and leaves its other later column to the next step, where
// it takes reflectors k and k + 1 in turn; the other warps reflect the later
// columns: one block barrier a step, and the step's longest warp one
// reflection and one reflector.
__device__ __forceinline__ void gn_step(Shared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Column a[kOwn];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int j = warp + o * kWarps;
    a[o][0] = a[o][1] = 0.0f;
    if (j < kCols) {
      a[o][0] = s.A[lane][j];
      if (lane + 32 < kRows) a[o][1] = s.A[lane + 32][j];
    }
    if (j < kTan) {  // the column scale
      const float d = __fsqrt_rn(
          clamp_min(column_tree(a[o], [&](int, float x) { return mul(x, x); }, lane), 1e-16f));
      a[o][0] = dvd(a[o][0], d);
      a[o][1] = dvd(a[o][1], d);
      if (lane == 0) s.d[j] = d;
    }
  }
  if (warp == 0) reflector(s, a[0], 0, 0, lane);
  __syncthreads();
  for (int k = 0; k < kTan; ++k) {
    const bool lookahead = warp == (k + 1) % kWarps;  // owns column k + 1
    const bool owes = k >= 1 && warp == k % kWarps;   // left reflector k - 1 for now
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      if (warp + o * kWarps == k + 1) {
        reflect_step(s, a[o], k, lane);
        if (k + 1 < kTan) reflector(s, a[o], k + 1, (k + 1) % 3, lane);
      }
    }
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int j = warp + o * kWarps;
      if (j > k + 1 && j < kCols && !lookahead) {
        if (owes) reflect_step(s, a[o], k - 1, lane);
        reflect_step(s, a[o], k, lane);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int j = warp + o * kWarps;
    if (j < kCols) {
      s.A[lane][j] = a[o][0];
      if (lane + 32 < kRows) s.A[lane + 32][j] = a[o][1];
    }
  }
  __syncthreads();
  prof(2);
  if (warp == 0) {  // back substitution: row k's sum one warp tree; lane j holds y_j
    float yl = 0.0f;
    for (int k = kTan - 1; k >= 0; --k) {
      const float acc = warp_tree<kTan>([&](int j) { return j > k ? mul(s.A[k][j], yl) : 0.0f; }, lane);
      const float yk = dvd(sub(-s.A[k][kTan], acc), add(s.A[k][k], 1e-7f));
      if (lane == k) yl = yk;
    }
    if (lane < kTan) s.y[lane] = dvd(yl, s.d[lane]);
    __syncwarp();
    if (lane == 0) retract(s.si, s.y);
    if (lane == 1) retract(s.sj, s.y + 15);
  }
  __syncthreads();
  prof(3);
}

// The square-root information of state j once state i is marginalized out of
// H = J^T J (s.A), and the divergence flag; written to the lane's outputs. In
// float64 from J to W (ops/fusion_step.py::marginal_sqrt_info says why).
__device__ __forceinline__ void marginalize(const Args& a, Shared& s, long long b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // H = J^T J: a thread an entry of its upper triangle (465: one round),
  // mirrored (the products commute exactly, so H[c][r]'s tree is H[r][c]'s)
  for (int e = tid; e < kTan * (kTan + 1) / 2; e += kThreads) {
    int r = 0, c = e;
    while (c >= kTan - r) {
      c -= kTan - r;
      ++r;
    }
    c += r;
    const double h = tree_sum<kRows>([&](int m) { return mul((double)s.A[m][r], (double)s.A[m][c]); });
    s.H[r][c] = s.H[c][r] = h;
  }
  __syncthreads();
  if (tid < kTan) s.dh[tid] = root(clamp_min(s.H[tid][tid], 1e-12));
  __syncthreads();
  for (int e = tid; e < kTan * kTan; e += kThreads) {
    const int r = e / kTan, c = e % kTan;
    s.H[r][c] = add(dvd(s.H[r][c], mul(s.dh[r], s.dh[c])), r == c ? 1e-7 : 0.0);
    if (r < 15) s.Mx[r][c] = s.H[r][c];
  }
  if (tid < 225) s.L[tid / 15][tid % 15] = 0.0;
  if (tid == 0) s.fail = 0;
  __syncthreads();
  prof(4);
  // LU with partial pivoting of [A | B]: the first largest |pivot| (NaN first)
  for (int k = 0; k < 15; ++k) {
    if (warp == 0) {  // the first NaN |pivot| at or below k, else the first largest
      int best = k + lane;
      int ok = best < 15;
      double bv = ok ? fabs(s.Mx[best][k]) : 0.0;
#pragma unroll
      for (int h = 8; h >= 1; h >>= 1) {
        const double x = __shfl_down_sync(kFull, bv, h);
        const int i = __shfl_down_sync(kFull, best, h);
        const int other = __shfl_down_sync(kFull, ok, h);
        if (other) {
          const bool take = !ok || (isnan(x) ? (!isnan(bv) || i < best)
                                             : (!isnan(bv) && (x > bv || (x == bv && i < best))));
          if (take) {
            bv = x;
            best = i;
            ok = 1;
          }
        }
      }
      const int pv = __shfl_sync(kFull, best, 0);
      if (pv != k && lane < kTan) {  // the same warp swaps the rows
        const double t = s.Mx[k][lane];
        s.Mx[k][lane] = s.Mx[pv][lane];
        s.Mx[pv][lane] = t;
      }
    }
    __syncthreads();
    for (int e = tid; e < 15 * kTan; e += kThreads) {
      const int i = e / kTan, j = e % kTan;
      if (i > k && j > k) s.Mx[i][j] = sub(s.Mx[i][j], mul(dvd(s.Mx[i][k], s.Mx[k][k]), s.Mx[k][j]));
    }
    __syncthreads();
  }
  prof(5);
  if (warp < 15) {  // back substitution, a warp a column of A^-1 B; lane m holds X[m][c]
    const int c = warp;
    double xl = 0.0;
    for (int k = 14; k >= 0; --k) {
      const double acc = warp_tree<15>([&](int m) { return m > k ? mul(s.Mx[k][m], xl) : 0.0; }, lane);
      const double xk = dvd(sub(s.Mx[k][15 + c], acc), s.Mx[k][k]);
      if (lane == k) xl = xk;
    }
    if (lane < 15) s.X[lane][c] = xl;
  }
  __syncthreads();
  if (tid < 225) {
    const int r = tid / 15, c = tid % 15;
    s.S[r][c] = sub(s.H[15 + r][15 + c],
                    tree_sum<15>([&](int m) { return mul(s.H[m][15 + r], s.X[m][c]); }));
  }
  __syncthreads();
  if (tid < 225) {  // symmetrized, + 1e-7 I (into X, no longer needed)
    const int r = tid / 15, c = tid % 15;
    s.X[r][c] = add(mul(0.5, add(s.S[r][c], s.S[c][r])), r == c ? 1e-7 : 0.0);
  }
  __syncthreads();
  prof(6);
  cholesky<15>(&s.X[0][0], &s.L[0][0], &s.fail);
  bool bad = false;
  if (tid < 225) {  // W = chol(S)^T d_j, rounded to float once
    const int r = tid / 15, c = tid % 15;
    const double l = s.fail ? __longlong_as_double(0x7ff8000000000000ll) : s.L[c][r];
    const float w = (float)mul(l, s.dh[15 + c]);
    a.oW[b * 225 + tid] = w;
    bad = !isfinite(w);
  }
  bad = __syncthreads_or(bad);
  prof(7);
  if (tid == 0) {
    const State& J = s.sj;
    const float nv = __fsqrt_rn(sum3(mul(J.v[0], J.v[0]), mul(J.v[1], J.v[1]), mul(J.v[2], J.v[2])));
    const float na = __fsqrt_rn(sum3(mul(J.ba[0], J.ba[0]), mul(J.ba[1], J.ba[1]), mul(J.ba[2], J.ba[2])));
    const float ng = __fsqrt_rn(sum3(mul(J.bg[0], J.bg[0]), mul(J.bg[1], J.bg[1]), mul(J.bg[2], J.bg[2])));
    a.odiv[b] = (nv > a.max_v) || (na > a.max_b) || (ng > a.max_b) || bad;
  }
  if (tid < 9) a.oR[b * 9 + tid] = s.sj.R[tid / 3][tid % 3];
  if (tid < 3) {
    a.op[b * 3 + tid] = s.sj.p[tid];
    a.ov[b * 3 + tid] = s.sj.v[tid];
    a.oba[b * 3 + tid] = s.sj.ba[tid];
    a.obg[b * 3 + tid] = s.sj.bg[tid];
  }
}

__global__ void __launch_bounds__(kThreads, 1) fusion_kernel(Args a) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  prof_start();
  // the lane's inputs
  load(&s.prior.R[0][0], a.R + b * 9, 9, tid);
  load(s.prior.p, a.p + b * 3, 3, tid);
  load(s.prior.v, a.v + b * 3, 3, tid);
  load(s.prior.ba, a.ba + b * 3, 3, tid);
  load(s.prior.bg, a.bg + b * 3, 3, tid);
  load(&s.Wp[0][0], a.W + b * 225, 225, tid);
  load(&s.dR0[0][0], a.dR + b * 9, 9, tid);
  load(s.dv0, a.dv + b * 3, 3, tid);
  load(s.dp0, a.dp + b * 3, 3, tid);
  load(&s.T, a.dt + b, 1, tid);
  load(&s.dRdbg[0][0], a.dR_dbg + b * 9, 9, tid);
  load(&s.dvdba[0][0], a.dv_dba + b * 9, 9, tid);
  load(&s.dvdbg[0][0], a.dv_dbg + b * 9, 9, tid);
  load(&s.dpdba[0][0], a.dp_dba + b * 9, 9, tid);
  load(&s.dpdbg[0][0], a.dp_dbg + b * 9, 9, tid);
  load(&s.cov[0][0], a.cov + b * 81, 81, tid);
  load(s.bal, a.ba_lin + b * 3, 3, tid);
  load(s.bgl, a.bg_lin + b * 3, 3, tid);
  load(&s.lR[0][0], a.lR + b * 9, 9, tid);
  load(s.lp, a.lp + b * 3, 3, tid);
  if (tid < 81) s.L9[tid / 9][tid % 9] = 0.0f;
  if (tid == 0) s.fail = 0;
  __syncthreads();
  // the IMU whitening: chol(cov + 1e-10 I)^-1 (cov + 1e-10 I into imuW first)
  if (tid < 81) {
    const int r = tid / 9, c = tid % 9;
    s.imuW[r][c] = add(s.cov[r][c], r == c ? 1e-10f : 0.0f);
  }
  // the bias random walk and lidar prior weights
  if (tid < 6) {
    const float sqdt = __fsqrt_rn(clamp_min(s.T, 1e-6f));
    s.bW[tid] = dvd(1.0f, mul(tid < 3 ? a.acc_rw : a.gyr_rw, sqdt));
    const float sig = a.deg[b] ? a.deg_sigma : (tid < 3 ? a.rot_sigma : a.trans_sigma);
    s.cW[tid] = dvd(1.0f, sig);
  }
  __syncthreads();
  cholesky<9>(&s.imuW[0][0], &s.L9[0][0], &s.fail);
  if (s.fail && tid < 81) s.L9[tid / 9][tid % 9] = __int_as_float(0x7fc00000);
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  if (warp < 9) {  // forward substitution, a warp a column of the identity; lane m holds X[m][c]
    const int c = warp;
    float xl = 0.0f;
    for (int i = 0; i < 9; ++i) {
      const float acc = warp_tree<9>([&](int m) { return m < i ? mul(s.L9[i][m], xl) : 0.0f; }, lane);
      const float xi = dvd(sub(i == c ? 1.0f : 0.0f, acc), s.L9[i][i]);
      if (lane == i) xl = xi;
    }
    if (lane < 9) s.imuW[lane][c] = xl;
  }
  if (tid == kThreads - 32) {  // the last warp
    s.si = s.prior;
    predict(a, s);
  }
  __syncthreads();
  prof(0);
  for (int it = 0;; ++it) {  // gn_iters steps, then the system the marginalization reads
    build_system(a, s);
    if (it == a.gn_iters) break;
    gn_step(s);
  }
  marginalize(a, s, b);
}

}  // namespace

extern "C" {

#ifdef LIORF_FUSION_PROFILE
int liorf_fusion_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfPhases);
}
#endif

// One fusion correction for each of `lanes` lanes on `stream`. Pointers are
// contiguous device arrays with a leading lane axis, in the order of Args
// (ops/fusion_step.py::ARGS, then the seven outputs).
int liorf_fusion_step(const void* R, const void* p, const void* v, const void* ba,
                      const void* bg, const void* W, const void* dR, const void* dv,
                      const void* dp, const void* dt, const void* dR_dbg, const void* dv_dba,
                      const void* dv_dbg, const void* dp_dba, const void* dp_dbg,
                      const void* cov, const void* ba_lin, const void* bg_lin, const void* lR,
                      const void* lp, const void* deg, void* oR, void* op, void* ov, void* oba,
                      void* obg, void* oW, void* odiv, float acc_rw, float gyr_rw,
                      float gravity, float rot_sigma, float trans_sigma, float deg_sigma,
                      float max_v, float max_b, int gn_iters, int lanes, void* stream) {
  if (lanes == 0) return 0;
  Args a;
  a.R = (const float*)R; a.p = (const float*)p; a.v = (const float*)v;
  a.ba = (const float*)ba; a.bg = (const float*)bg; a.W = (const float*)W;
  a.dR = (const float*)dR; a.dv = (const float*)dv; a.dp = (const float*)dp;
  a.dt = (const float*)dt; a.dR_dbg = (const float*)dR_dbg; a.dv_dba = (const float*)dv_dba;
  a.dv_dbg = (const float*)dv_dbg; a.dp_dba = (const float*)dp_dba;
  a.dp_dbg = (const float*)dp_dbg; a.cov = (const float*)cov;
  a.ba_lin = (const float*)ba_lin; a.bg_lin = (const float*)bg_lin;
  a.lR = (const float*)lR; a.lp = (const float*)lp; a.deg = (const uint8_t*)deg;
  a.oR = (float*)oR; a.op = (float*)op; a.ov = (float*)ov; a.oba = (float*)oba;
  a.obg = (float*)obg; a.oW = (float*)oW; a.odiv = (uint8_t*)odiv;
  a.acc_rw = acc_rw; a.gyr_rw = gyr_rw; a.gravity = gravity; a.rot_sigma = rot_sigma;
  a.trans_sigma = trans_sigma; a.deg_sigma = deg_sigma; a.max_v = max_v; a.max_b = max_b;
  a.gn_iters = gn_iters; a.lanes = lanes;
  fusion_kernel<<<lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
