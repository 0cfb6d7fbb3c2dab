// IMU preintegration (imu/preintegration.py::preintegrate) in one launch, for
// NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/preintegrate.py with the flags of core/build.py and loaded
// with ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package jits preintegrate
// (liorf_tpu/imu/preintegration.py:56-162) into one XLA program of two
// lax.associative_scans, the rotations' prefix and the segments' monoid
// product. Op by op on the card that was a log-depth tree of batched eager
// products, a few hundred launches and 8-12 ms of host time a frame. Here one
// thread block a lane runs all of it, over the window in tiles of kTile
// samples:
//
//   the leaves: one thread a sample, a = acc - ba, w = gyr - bg, dt = mask ?
//     dts : 0, so3_exp(w dt) and Jr(w dt) (so3_exp.cuh);
//   the rotations' inclusive prefix over the tile, log2(kTile) rounds of
//     Hillis-Steele doubling, and the exclusive prefix pre_R = C (the
//     rotation carried from the tiles before) times it;
//   the leaf segments (dv, dp, the five bias Jacobians, the 9 x 9 A and Q =
//     B N B^T + q_int, one thread each), then the tile's pairwise tree:
//     log2(kTile) levels, neighbours composed in order (imu/preintegration.py's
//     formulas; Q' = (A_b Q_a) A_b^T + Q_b), every entry of a level's composes
//     one item spread over the block's threads;
//   the tile's segment composed onto the window's, and C carried on.
//
// A masked sample, and a sample past K in the last tile, is the identity
// segment (dt = 0: A = I, Q = 0), which composes exactly.
//
// The order contract (ops/preintegrate.py::preintegrate_plain spells it in
// torch ops; on the card the two agree bit for bit): every product, sum,
// quotient and square root is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn: nvcc would contract to FMAs); a 3-term product sum
// is (a0 b0 + a1 b1) + a2 b2; a 9 x 9 product's entry is its 9 terms summed
// in order, left to right; sin and cos are taken in double and rounded to
// float. No atomics: every order is fixed.
//
// What bounds it: neither bytes (~12 B a sample) nor operations (~5 kFLOP a
// sample) but latency: ~20 block barriers a tile and the dependent chain of
// a compose (a 9 x 9 product feeding the next). The window's segments live
// in shared memory (one tile of 64 leaves, ~57 KB, and the half-size buffer
// the tree's first level writes into); one lane is one block on one SM, and
// the lanes of a vmapped call run side by side.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "so3_exp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // samples a tile: the tree's leaves (a power of two)

// A segment: 223 floats in this order
constexpr int oR = 0;      // dR [3][3]
constexpr int oV = 9;      // dv [3]
constexpr int oP = 12;     // dp [3]
constexpr int oT = 15;     // T
constexpr int oRG = 16;    // dR_dbg [3][3]
constexpr int oVA = 25;    // dv_dba
constexpr int oVG = 34;    // dv_dbg
constexpr int oPA = 43;    // dp_dba
constexpr int oPG = 52;    // dp_dbg
constexpr int oA = 61;     // A [9][9]
constexpr int oQ = 142;    // Q [9][9]
constexpr int kSeg = 223;
constexpr int kM = kSeg;   // a compose's phase-1 items: every field but Q, then A_b Q_a
constexpr int kHalf = kTile / 2;

// the dynamic shared memory, in floats
constexpr int sX = 0;                      // kTile segments (the leaves, the tree)
constexpr int sY = sX + kTile * kSeg;      // kHalf segments (the tree's other half)
constexpr int sM = sY + kHalf * kSeg;      // kHalf x 81: A_b Q_a of each compose
constexpr int sI0 = sM + kHalf * 81;       // kTile x 9: the prefix, two buffers
constexpr int sI1 = sI0 + kTile * 9;
constexpr int sC = sI1 + kTile * 9;        // 9: the rotation carried from tile to tile
constexpr int sAcc = sC + 9;               // the window's segment
constexpr int sTmp = sAcc + kSeg;          // the window's next segment
constexpr int kSharedFloats = sTmp + kSeg;
constexpr size_t kSharedBytes = sizeof(float) * kSharedFloats;

struct Args {
  const float *acc, *gyr, *dts;
  const uint8_t* mask;
  const float *ba, *bg;
  float *oR_, *oV_, *oP_, *oT_, *oRG_, *oVA_, *oVG_, *oPA_, *oPG_, *oCov;
  float sg2, sa2, si2;
  int K;
};

// entry (r, c) of a 3 x 3 product from row-major pointers
__device__ __forceinline__ float mm_at(const float* A, const float* B, int r, int c) {
  return sum3(mul(A[3 * r], B[c]), mul(A[3 * r + 1], B[3 + c]), mul(A[3 * r + 2], B[6 + c]));
}

// entry (r, c) of A^T B
__device__ __forceinline__ float mtm_at(const float* A, const float* B, int r, int c) {
  return sum3(mul(A[r], B[c]), mul(A[3 + r], B[3 + c]), mul(A[6 + r], B[6 + c]));
}

// entry (r, c) of (R hat(v)) G: R hat(v)'s row r first, each a 3-term sum
__device__ __forceinline__ float rhat_g_at(const float* R, const float* v, const float* G, int r,
                                           int c) {
  const float h[3][3] = {{0.0f, -v[2], v[1]}, {v[2], 0.0f, -v[0]}, {-v[1], v[0], 0.0f}};
  float row[3];
#pragma unroll
  for (int l = 0; l < 3; ++l)
    row[l] = sum3(mul(R[3 * r], h[0][l]), mul(R[3 * r + 1], h[1][l]), mul(R[3 * r + 2], h[2][l]));
  return sum3(mul(row[0], G[c]), mul(row[1], G[3 + c]), mul(row[2], G[6 + c]));
}

// entry (r, c) of the 9 x 9 product X Y (Yt: Y transposed), its 9 terms in order
__device__ __forceinline__ float mm9_at(const float* X, const float* Y, int r, int c, bool Yt) {
  float s = mul(X[9 * r], Yt ? Y[9 * c] : Y[c]);
#pragma unroll
  for (int l = 1; l < 9; ++l) s = add(s, mul(X[9 * r + l], Yt ? Y[9 * c + l] : Y[9 * l + c]));
  return s;
}

// Phase-1 item e of compose(a, b) (a earlier): field e of the product for
// e < oQ, entry e - oQ of A_b Q_a into M otherwise.
__device__ __forceinline__ void compose_item(const float* a, const float* b, float* out,
                                             float* M, int e) {
  const float* Ra = a + oR;
  if (e < oV) {
    out[e] = mm_at(Ra, b + oR, e / 3, e % 3);
  } else if (e < oP) {
    const int r = e - oV;
    out[e] = add(a[oV + r], sum3(mul(Ra[3 * r], b[oV]), mul(Ra[3 * r + 1], b[oV + 1]),
                                 mul(Ra[3 * r + 2], b[oV + 2])));
  } else if (e < oT) {
    const int r = e - oP;
    out[e] = add(add(a[oP + r], mul(a[oV + r], b[oT])),
                 sum3(mul(Ra[3 * r], b[oP]), mul(Ra[3 * r + 1], b[oP + 1]),
                      mul(Ra[3 * r + 2], b[oP + 2])));
  } else if (e == oT) {
    out[e] = add(a[oT], b[oT]);
  } else if (e < oVA) {
    const int k = e - oRG, r = k / 3, c = k % 3;
    out[e] = add(mtm_at(b + oR, a + oRG, r, c), b[e]);
  } else if (e < oVG) {
    const int k = e - oVA, r = k / 3, c = k % 3;
    out[e] = add(a[e], mm_at(Ra, b + oVA, r, c));
  } else if (e < oPA) {
    const int k = e - oVG, r = k / 3, c = k % 3;
    out[e] = sub(add(a[e], mm_at(Ra, b + oVG, r, c)), rhat_g_at(Ra, b + oV, a + oRG, r, c));
  } else if (e < oPG) {
    const int k = e - oPA, r = k / 3, c = k % 3;
    out[e] = add(add(a[e], mul(a[oVA + k], b[oT])), mm_at(Ra, b + oPA, r, c));
  } else if (e < oA) {
    const int k = e - oPG, r = k / 3, c = k % 3;
    out[e] = sub(add(add(a[e], mul(a[oVG + k], b[oT])), mm_at(Ra, b + oPG, r, c)),
                 rhat_g_at(Ra, b + oP, a + oRG, r, c));
  } else if (e < oQ) {
    const int k = e - oA;
    out[e] = mm9_at(b + oA, a + oA, k / 9, k % 9, false);
  } else {
    const int k = e - oQ;
    M[k] = mm9_at(b + oA, a + oQ, k / 9, k % 9, false);
  }
}

// m composes of neighbours, src[2j] then src[2j + 1] into dst[j]; two phases,
// each closed by a barrier
__device__ void compose_level(const float* src, float* dst, float* M, int m, int tid) {
  for (int i = tid; i < m * kM; i += kThreads) {
    const int j = i / kM;
    compose_item(src + 2 * j * kSeg, src + (2 * j + 1) * kSeg, dst + j * kSeg, M + j * 81,
                 i - j * kM);
  }
  __syncthreads();
  for (int i = tid; i < m * 81; i += kThreads) {
    const int j = i / 81, k = i - j * 81;
    const float* b = src + (2 * j + 1) * kSeg;
    dst[j * kSeg + oQ + k] = add(mm9_at(M + j * 81, b + oA, k / 9, k % 9, true), b[oQ + k]);
  }
  __syncthreads();
}

// One thread's leaf: sample s of the lane (a masked one, or one past K, has
// dt = 0), its exclusive prefix rotation P; written into seg.
__device__ void leaf(const float a[3], float dt, const float Rinc[3][3], const float Jr[3][3],
                     const float P[3][3], const Args& g, float* seg) {
  const float h = mul(dt, dt);
#pragma unroll
  for (int k = 0; k < 9; ++k) seg[oR + k] = Rinc[k / 3][k % 3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float dv = mul(a[r], dt);
    seg[oV + r] = dv;
    seg[oP + r] = mul(mul(dv, dt), 0.5f);
  }
  seg[oT] = dt;
  float Ra[3][3], Ah[3][3];  // P hat(a)
  hat3(a, Ah);
  mm(P, Ah, Ra);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int r = k / 3, c = k % 3;
    const float I = r == c ? 1.0f : 0.0f;
    seg[oRG + k] = -mul(Jr[r][c], dt);
    seg[oVA + k] = -mul(I, dt);
    seg[oVG + k] = 0.0f;
    seg[oPA + k] = -mul(I, mul(h, 0.5f));
    seg[oPG + k] = 0.0f;
  }
  // A: [[Rinc^T, 0, 0], [-(Ra dt), I, 0], [-((Ra h) 0.5), I dt, I]]
  float* A = seg + oA;
#pragma unroll
  for (int k = 0; k < 81; ++k) A[k] = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float I = r == c ? 1.0f : 0.0f;
      A[9 * r + c] = Rinc[c][r];
      A[9 * (3 + r) + c] = -mul(Ra[r][c], dt);
      A[9 * (3 + r) + 3 + c] = I;
      A[9 * (6 + r) + c] = -mul(mul(Ra[r][c], h), 0.5f);
      A[9 * (6 + r) + 3 + c] = mul(I, dt);
      A[9 * (6 + r) + 6 + c] = I;
    }
  }
  // B = [[Jr dt, 0], [0, P dt], [0, (P h) 0.5]], N = (sg2 / dt, sa2 / dt) (dt
  // <= 0: 1); Q = B N B^T blockwise, each entry (b0 n b0' + b1 n b1') + b2 n b2'
  const float sdt = dt > 0.0f ? dt : 1.0f;
  const float ng = dvd(g.sg2, sdt), na = dvd(g.sa2, sdt);
  float B1[3][3], B2[3][3], B3[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      B1[r][c] = mul(Jr[r][c], dt);
      B2[r][c] = mul(P[r][c], dt);
      B3[r][c] = mul(mul(P[r][c], h), 0.5f);
    }
  float* Q = seg + oQ;
  const float qi = mul(dt, g.si2);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#define BNB(X, Y, n) sum3(mul(mul(X[r][0], n), Y[c][0]), mul(mul(X[r][1], n), Y[c][1]), \
                          mul(mul(X[r][2], n), Y[c][2]))
      Q[9 * r + c] = BNB(B1, B1, ng);
      Q[9 * r + 3 + c] = 0.0f;
      Q[9 * r + 6 + c] = 0.0f;
      Q[9 * (3 + r) + c] = 0.0f;
      Q[9 * (3 + r) + 3 + c] = BNB(B2, B2, na);
      Q[9 * (3 + r) + 6 + c] = BNB(B2, B3, na);
      Q[9 * (6 + r) + c] = 0.0f;
      Q[9 * (6 + r) + 3 + c] = BNB(B3, B2, na);
      Q[9 * (6 + r) + 6 + c] = add(BNB(B3, B3, na), r == c ? qi : 0.0f);
#undef BNB
    }
}

__global__ void __launch_bounds__(kThreads, 1) preintegrate_kernel(Args g) {
  extern __shared__ float sh[];
  float* X = sh + sX;
  float* Y = sh + sY;
  float* M = sh + sM;
  float* C = sh + sC;
  float* acc = sh + sAcc;
  float* tmp = sh + sTmp;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const long long K = g.K;
  if (tid < 9) C[tid] = (tid % 4 == 0) ? 1.0f : 0.0f;
  const int tiles = (int)((K + kTile - 1) / kTile);
  for (int t = 0; t < tiles; ++t) {
    // the leaves' rotations: one thread a sample
    float a[3] = {0.0f, 0.0f, 0.0f}, dt = 0.0f, Rinc[3][3], Jr[3][3];
    if (tid < kTile) {
      const long long s = (long long)t * kTile + tid;
      float ac[3] = {0.0f, 0.0f, 0.0f}, gy[3] = {0.0f, 0.0f, 0.0f};
      if (s < K) {
        const long long i = b * K + s;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          ac[m] = g.acc[3 * i + m];
          gy[m] = g.gyr[3 * i + m];
        }
        dt = g.mask[i] ? g.dts[i] : 0.0f;
      }
      float w[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        a[m] = sub(ac[m], g.ba[3 * b + m]);
        w[m] = mul(sub(gy[m], g.bg[3 * b + m]), dt);
      }
      Exp e;
      exp_terms(w, e);
      float W[3][3], W2[3][3];
      hat3(w, W);
      mm(W, W, W2);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          Rinc[r][c] = add(add(r == c ? 1.0f : 0.0f, mul(e.A, W[r][c])), mul(e.B, W2[r][c]));
      so3_right_jacobian(e, W, W2, Jr);
#pragma unroll
      for (int k = 0; k < 9; ++k) sh[sI0 + 9 * tid + k] = Rinc[k / 3][k % 3];
    }
    __syncthreads();
    // the inclusive prefix of the tile's rotations, Hillis-Steele doubling
    int cur = sI0, nxt = sI1;
    for (int d = 1; d < kTile; d *= 2) {
      if (tid < kTile) {
        const float* in = sh + cur;
        float* o = sh + nxt;
        if (tid >= d) {
#pragma unroll
          for (int k = 0; k < 9; ++k) o[9 * tid + k] = mm_at(in + 9 * (tid - d), in + 9 * tid, k / 3, k % 3);
        } else {
#pragma unroll
          for (int k = 0; k < 9; ++k) o[9 * tid + k] = in[9 * tid + k];
        }
      }
      __syncthreads();
      const int x = cur;
      cur = nxt;
      nxt = x;
    }
    const float* incl = sh + cur;
    // the leaves, each with its exclusive prefix C incl[i - 1] (C at i = 0)
    if (tid < kTile) {
      float P[3][3];
#pragma unroll
      for (int k = 0; k < 9; ++k)
        P[k / 3][k % 3] = tid == 0 ? C[k] : mm_at(C, incl + 9 * (tid - 1), k / 3, k % 3);
      leaf(a, dt, Rinc, Jr, P, g, X + tid * kSeg);
    }
    __syncthreads();
    if (tid == 0) {
      float Cn[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) Cn[k] = mm_at(C, incl + 9 * (kTile - 1), k / 3, k % 3);
#pragma unroll
      for (int k = 0; k < 9; ++k) C[k] = Cn[k];
    }
    // the tile's tree: X -> Y -> X ... until one segment, in X
    float* src = X;
    float* dst = Y;
    for (int m = kTile / 2; m >= 1; m /= 2) {
      compose_level(src, dst, M, m, tid);
      float* x = src;
      src = dst;
      dst = x;
    }
    // src holds the tile's segment; onto the window's
    if (t == 0) {
      for (int k = tid; k < kSeg; k += kThreads) acc[k] = src[k];
    } else {
      for (int i = tid; i < kM; i += kThreads) compose_item(acc, src, tmp, M, i);
      __syncthreads();
      for (int k = tid; k < 81; k += kThreads)
        tmp[oQ + k] = add(mm9_at(M, src + oA, k / 9, k % 9, true), src[oQ + k]);
      __syncthreads();
      for (int k = tid; k < kSeg; k += kThreads) acc[k] = tmp[k];
    }
    __syncthreads();
  }
  // the window's segment out (A stays behind)
  for (int k = tid; k < 9; k += kThreads) {
    g.oR_[9 * b + k] = acc[oR + k];
    g.oRG_[9 * b + k] = acc[oRG + k];
    g.oVA_[9 * b + k] = acc[oVA + k];
    g.oVG_[9 * b + k] = acc[oVG + k];
    g.oPA_[9 * b + k] = acc[oPA + k];
    g.oPG_[9 * b + k] = acc[oPG + k];
  }
  if (tid < 3) {
    g.oV_[3 * b + tid] = acc[oV + tid];
    g.oP_[3 * b + tid] = acc[oP + tid];
  }
  if (tid == 0) g.oT_[b] = acc[oT];
  for (int k = tid; k < 81; k += kThreads) g.oCov[81 * b + k] = acc[oQ + k];
}

}  // namespace

extern "C" {

// The preintegrated window of each of `lanes` lanes on `stream`. Pointers are
// contiguous device arrays with a leading lane axis: acc, gyr [lanes, K, 3],
// dts [lanes, K] (float), mask [lanes, K] (bool), ba, bg [lanes, 3]; then the
// ten outputs of ops/preintegrate.py::FIELDS. sg2, sa2, si2: the gyro, accel
// and integration noise densities squared.
int liorf_preintegrate(const void* acc, const void* gyr, const void* dts, const void* mask,
                       const void* ba, const void* bg, void* oR, void* oV, void* oP, void* oT,
                       void* oRG, void* oVA, void* oVG, void* oPA, void* oPG, void* oCov,
                       float sg2, float sa2, float si2, int K, int lanes, void* stream) {
  if (lanes == 0) return 0;
  if (K < 1) return (int)cudaErrorInvalidValue;
  // the opt-in is per device context: set it on every call (the current
  // device may change between calls), as csrc/pcg.cu does
  const cudaError_t err = cudaFuncSetAttribute(
      preintegrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  Args g;
  g.acc = (const float*)acc; g.gyr = (const float*)gyr; g.dts = (const float*)dts;
  g.mask = (const uint8_t*)mask; g.ba = (const float*)ba; g.bg = (const float*)bg;
  g.oR_ = (float*)oR; g.oV_ = (float*)oV; g.oP_ = (float*)oP; g.oT_ = (float*)oT;
  g.oRG_ = (float*)oRG; g.oVA_ = (float*)oVA; g.oVG_ = (float*)oVG; g.oPA_ = (float*)oPA;
  g.oPG_ = (float*)oPG; g.oCov = (float*)oCov;
  g.sg2 = sg2; g.sa2 = sa2; g.si2 = si2; g.K = K;
  preintegrate_kernel<<<lanes, kThreads, kSharedBytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
