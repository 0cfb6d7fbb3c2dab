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
// samples, and only as far as the lane's last valid sample:
//
//   the window's end: a ballot of the mask a warp finds the last valid
//     sample (slot 0 when none is); its tile is the last one run, and there
//     the tree covers the power of two of slots that reaches it (the cover);
//     samples past it are left out, not composed in as identity segments;
//   the leaves' rotations: one thread a sample, a = acc - ba, w = gyr - bg,
//     dt = mask ? dts : 0, so3_exp(w dt) and Jr(w dt) (so3_exp.cuh);
//   the rotations' inclusive prefix over the tile, Hillis-Steele doubling:
//     on one warp's registers by shuffles when the tile's tree covers 32
//     slots or fewer (no barrier), else over the two warps' shared memory
//     behind a barrier of those 64 threads; the exclusive prefix pre_R = C
//     (the rotation carried from the tiles before) times it;
//   the leaf segments (dv, dp, the five bias Jacobians, the 9 x 9 A and Q =
//     B N B^T + q_int), each leaf's fields in four parts on four threads;
//   the tile's pairwise tree: a level's composes of neighbours in order
//     (imu/preintegration.py's formulas; Q' = (A_b Q_a) A_b^T + Q_b), every
//     entry of a level's composes one item over the block's threads;
//   the tile's segment composed onto the window's, and C carried on.
//
// A masked sample before the window's end, and a sample past K inside the
// cover, is the identity segment (dt = 0: A = I, Q = 0). Composing a segment
// with it keeps every value but not always the sign of a zero (and x 0 of an
// infinite x is NaN), so the slots past the cover are not composed at all:
// the plain version (ops/preintegrate.py::window_cut) leaves out the same.
//
// The order contract (ops/preintegrate.py::preintegrate_plain spells it in
// torch ops; on the card the two agree bit for bit): every product, sum,
// quotient and square root is rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn: nvcc would contract to FMAs); a 3-term product sum
// is (a0 b0 + a1 b1) + a2 b2; a 9 x 9 product's entry is its 9 terms summed
// in order, left to right; sin and cos are taken in double and rounded to
// float. No atomics on values: every order is fixed.
//
// What bounds it: neither bytes (~12 B a sample) nor operations (~5 kFLOP a
// sample) but latency: the dependent chain of the prefix and of each tree
// level's composes (a 9 x 9 product feeding the next), and the barriers
// between them. Its design shortens both: the work stops at the window's end
// (on the main path 10 valid samples of 64 slots: a tree of 16 leaves, four
// levels, in place of 64 and six), the prefix of a short window runs on one
// warp with no barrier, and the leaves' fields are spread over four threads
// a leaf. The window's segments live in shared memory (one tile of 64
// leaves, ~57 KB, the half-size buffer the tree's first level writes into,
// the leaves' inputs); one lane is one block of 512 threads on one SM, and
// the lanes of a vmapped call run side by side.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "so3_exp.cuh"

namespace {

constexpr int kThreads = 512;  // a block's threads
constexpr int kTile = 64;  // samples a tile: the tree's leaves (a power of two)
constexpr unsigned kFull = 0xffffffffu;

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

// A leaf's inputs, written by its sample's thread: Rinc, Jr, the exclusive
// prefix P (each 3 x 3 row-major), a = acc - ba, dt
constexpr int iR = 0, iJ = 9, iP = 18, iA = 27, iDt = 30, kIn = 31;
constexpr int kLeafParts = 4;  // threads a leaf: fields 0-60, A, Q's block rows 0-1, Q's row 2

// the dynamic shared memory, in floats
constexpr int sX = 0;                      // kTile segments (the leaves, the tree)
constexpr int sY = sX + kTile * kSeg;      // kHalf segments (the tree's other half)
constexpr int sM = sY + kHalf * kSeg;      // kHalf x 81: A_b Q_a of each compose
constexpr int sIn = sM + kHalf * 81;       // kTile x kIn: the leaves' inputs
constexpr int sI0 = sIn + kTile * kIn;     // kTile x 9: a full tile's prefix, two buffers
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

#ifdef LIORF_PREINTEGRATE_PROFILE
// Development only (built with -DLIORF_PREINTEGRATE_PROFILE): clock cycles a
// phase of lane 0's thread 0 (summed over the tiles), each lap taken after
// the phase's results are used; slots 0-3 the window's end with the first
// tile's rotations, the later tiles' rotations, the prefix with the leaves'
// inputs, the leaf segments; 4-9 the
// tree's levels from the leaves up; 10 the window's compose, 11 the outputs;
// 12-13 the launch's span by the global timer (ns).
constexpr int kProfSlots = 14;
__device__ long long g_prof[kProfSlots] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                          0x7fffffffffffffffLL, 0};
__device__ volatile float g_sink;
__device__ __forceinline__ long long gtimer() {
  long long t = 0;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
#endif
  return t;
}
__device__ __forceinline__ long long stamp() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct Laps {
  long long t;
  bool on;
  __device__ explicit Laps(bool on_) : t(stamp()), on(on_) {}
  template <class T>
  __device__ void lap(int slot, T dep) {
    if (on) g_sink = (float)dep;
    const long long now = stamp();
    if (on) g_prof[slot] += now - t;
    t = now;
  }
};
__device__ __forceinline__ void span(int slot, bool end) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long now = (unsigned long long)gtimer();
    if (end) atomicMax((unsigned long long*)&g_prof[slot], now);
    else atomicMin((unsigned long long*)&g_prof[slot], now);
  }
}
#else
struct Laps {
  __device__ explicit Laps(bool) {}
  template <class T>
  __device__ void lap(int, T) {}
};
__device__ __forceinline__ void span(int, bool) {}
#endif

// the first 64 threads' barrier (the two warps of a full tile's prefix)
__device__ __forceinline__ void bar64() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

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

// Part `part` of a leaf's segment from its inputs (a masked sample, or one
// past K, has dt = 0): 0 the fields before A, 1 A, 2 Q's block rows 0 and 1,
// 3 Q's block row 2.
__device__ void leaf_part(int part, const float* in, const Args& g, float* seg) {
  const float dt = in[iDt];
  const float h = mul(dt, dt);
  if (part == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) seg[oR + k] = in[iR + k];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float dv = mul(in[iA + r], dt);
      seg[oV + r] = dv;
      seg[oP + r] = mul(mul(dv, dt), 0.5f);
    }
    seg[oT] = dt;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int r = k / 3, c = k % 3;
      const float I = r == c ? 1.0f : 0.0f;
      seg[oRG + k] = -mul(in[iJ + 3 * r + c], dt);
      seg[oVA + k] = -mul(I, dt);
      seg[oVG + k] = 0.0f;
      seg[oPA + k] = -mul(I, mul(h, 0.5f));
      seg[oPG + k] = 0.0f;
    }
    return;
  }
  float P[3][3];
#pragma unroll
  for (int k = 0; k < 9; ++k) P[k / 3][k % 3] = in[iP + k];
  if (part == 1) {
    // A: [[Rinc^T, 0, 0], [-(Ra dt), I, 0], [-((Ra h) 0.5), I dt, I]], Ra = P hat(a)
    float a[3] = {in[iA], in[iA + 1], in[iA + 2]}, Ra[3][3], Ah[3][3];
    hat3(a, Ah);
    mm(P, Ah, Ra);
    float* A = seg + oA;
#pragma unroll
    for (int k = 0; k < 81; ++k) A[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float I = r == c ? 1.0f : 0.0f;
        A[9 * r + c] = in[iR + 3 * c + r];
        A[9 * (3 + r) + c] = -mul(Ra[r][c], dt);
        A[9 * (3 + r) + 3 + c] = I;
        A[9 * (6 + r) + c] = -mul(mul(Ra[r][c], h), 0.5f);
        A[9 * (6 + r) + 3 + c] = mul(I, dt);
        A[9 * (6 + r) + 6 + c] = I;
      }
    }
    return;
  }
  // B = [[Jr dt, 0], [0, P dt], [0, (P h) 0.5]], N = (sg2 / dt, sa2 / dt) (dt
  // <= 0: 1); Q = B N B^T blockwise, each entry (b0 n b0' + b1 n b1') + b2 n b2'
  const float sdt = dt > 0.0f ? dt : 1.0f;
  const float na = dvd(g.sa2, sdt);
  float B2[3][3], B3[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      B2[r][c] = mul(P[r][c], dt);
      B3[r][c] = mul(mul(P[r][c], h), 0.5f);
    }
  float* Q = seg + oQ;
#define BNB(X, Y, n) sum3(mul(mul(X[r][0], n), Y[c][0]), mul(mul(X[r][1], n), Y[c][1]), \
                          mul(mul(X[r][2], n), Y[c][2]))
  if (part == 2) {
    const float ng = dvd(g.sg2, sdt);
    float B1[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) B1[r][c] = mul(in[iJ + 3 * r + c], dt);
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Q[9 * r + c] = BNB(B1, B1, ng);
        Q[9 * r + 3 + c] = 0.0f;
        Q[9 * r + 6 + c] = 0.0f;
        Q[9 * (3 + r) + c] = 0.0f;
        Q[9 * (3 + r) + 3 + c] = BNB(B2, B2, na);
        Q[9 * (3 + r) + 6 + c] = BNB(B2, B3, na);
      }
    return;
  }
  const float qi = mul(dt, g.si2);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Q[9 * (6 + r) + c] = 0.0f;
      Q[9 * (6 + r) + 3 + c] = BNB(B3, B2, na);
      Q[9 * (6 + r) + 6 + c] = add(BNB(B3, B3, na), r == c ? qi : 0.0f);
    }
#undef BNB
}

// Sample s of lane b: a = acc - ba, dt (0 when masked or past K), so3_exp(w
// dt) and Jr(w dt) for w = gyr - bg; returns whether the sample is valid.
__device__ __forceinline__ bool leaf_rotation(const Args& g, long long b, long long s, float a[3],
                                              float& dt, float Rinc[9], float Jr[3][3]) {
  const long long K = g.K;
  float ac[3] = {0.0f, 0.0f, 0.0f}, gy[3] = {0.0f, 0.0f, 0.0f};
  bool valid = false;
  dt = 0.0f;
  if (s < K) {
    const long long i = b * K + s;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      ac[m] = g.acc[3 * i + m];
      gy[m] = g.gyr[3 * i + m];
    }
    valid = g.mask[i] != 0;
    dt = valid ? g.dts[i] : 0.0f;
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
      Rinc[3 * r + c] = add(add(r == c ? 1.0f : 0.0f, mul(e.A, W[r][c])), mul(e.B, W2[r][c]));
  so3_right_jacobian(e, W, W2, Jr);
  return valid;
}

__global__ void __launch_bounds__(kThreads, 1) preintegrate_kernel(Args g) {
  extern __shared__ float sh[];
  __shared__ int s_last;
  float* X = sh + sX;
  float* Y = sh + sY;
  float* M = sh + sM;
  float* In = sh + sIn;
  float* C = sh + sC;
  float* acc = sh + sAcc;
  float* tmp = sh + sTmp;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long b = blockIdx.x;
  const long long K = g.K;
  span(12, false);
  Laps laps(b == 0 && tid == 0);
  if (tid < 9) C[tid] = (tid % 4 == 0) ? 1.0f : 0.0f;
  if (tid == 0) s_last = 0;
  __syncthreads();
  // the window's end, the last valid sample, by a ballot a warp: the first
  // two warps ballot the first tile's mask as they load its samples and
  // form their rotations (which do not wait for it), the others the rest
  float a[3] = {0.0f, 0.0f, 0.0f}, dt = 0.0f, Rinc[9] = {}, Jr[3][3] = {};
  {
    int last = -1;
    if (tid < kTile) {
      const bool valid = leaf_rotation(g, b, tid, a, dt, Rinc, Jr);
      const unsigned bal = __ballot_sync(kFull, valid);
      if (bal) last = (tid - lane) + 31 - __clz((int)bal);
    } else {
      for (long long base = kTile + (long long)(tid - kTile - lane); base < K;
           base += kThreads - kTile) {
        const long long s = base + lane;
        const unsigned bal = __ballot_sync(kFull, s < K && g.mask[b * K + s]);
        if (bal) last = (int)(base + 31 - __clz((int)bal));
      }
    }
    if (lane == 0 && last > 0) atomicMax(&s_last, last);
  }
  __syncthreads();
  const int last = s_last;
  const int last_tile = last / kTile;
  int cover = 1;
  while (cover < last - last_tile * kTile + 1) cover *= 2;
  laps.lap(0, last);

  const float* win = acc;  // the window's segment
  for (int t = 0; t <= last_tile; ++t) {
    const int n = t < last_tile ? kTile : cover;  // the tile's leaves
    // the leaves' rotations: one thread a sample (the first tile's are formed)
    if (t > 0 && tid < n) leaf_rotation(g, b, (long long)t * kTile + tid, a, dt, Rinc, Jr);
    laps.lap(1, Rinc[0]);
    // the tile's inclusive rotation prefix (Hillis-Steele doubling), then
    // the leaf's exclusive prefix P = C incl[i - 1] (C at i = 0)
    float P[9];
    int incl_at = sI0;  // where a full tile's inclusive prefix ends up
    if (n <= 32) {
      if (tid < 32) {  // one warp, registers and shuffles
        float incl[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) incl[k] = Rinc[k];
        for (int d = 1; d < n; d *= 2) {
          float v[9], o[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) v[k] = __shfl_up_sync(kFull, incl[k], d);
#pragma unroll
          for (int k = 0; k < 9; ++k) o[k] = mm_at(v, incl, k / 3, k % 3);
          if (tid >= d) {
#pragma unroll
            for (int k = 0; k < 9; ++k) incl[k] = o[k];
          }
        }
        float prev[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) prev[k] = __shfl_up_sync(kFull, incl[k], 1);
#pragma unroll
        for (int k = 0; k < 9; ++k) P[k] = tid == 0 ? C[k] : mm_at(C, prev, k / 3, k % 3);
      }
    } else if (tid < kTile) {  // two warps, shared memory behind their own barrier
      int cur = sI0, nxt = sI1;
#pragma unroll
      for (int k = 0; k < 9; ++k) sh[cur + 9 * tid + k] = Rinc[k];
      bar64();
      for (int d = 1; d < kTile; d *= 2) {
        const float* in = sh + cur;
        float* o = sh + nxt;
        if (tid >= d) {
#pragma unroll
          for (int k = 0; k < 9; ++k) o[9 * tid + k] = mm_at(in + 9 * (tid - d), in + 9 * tid, k / 3, k % 3);
        } else {
#pragma unroll
          for (int k = 0; k < 9; ++k) o[9 * tid + k] = in[9 * tid + k];
        }
        bar64();
        const int x = cur;
        cur = nxt;
        nxt = x;
      }
      const float* incl = sh + cur;
      incl_at = cur;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        P[k] = tid == 0 ? C[k] : mm_at(C, incl + 9 * (tid - 1), k / 3, k % 3);
    }
    if (tid < n) {
      float* in = In + kIn * tid;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        in[iR + k] = Rinc[k];
        in[iJ + k] = Jr[k / 3][k % 3];
        in[iP + k] = P[k];
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) in[iA + m] = a[m];
      in[iDt] = dt;
    }
    __syncthreads();
    laps.lap(2, In[iP]);
    if (tid == 0 && t < last_tile) {  // C carried on (every reader of C is past the barrier)
      float Cn[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) Cn[k] = mm_at(C, sh + incl_at + 9 * (kTile - 1), k / 3, k % 3);
#pragma unroll
      for (int k = 0; k < 9; ++k) C[k] = Cn[k];
    }
    // the leaf segments, four threads a leaf
    for (int i = tid; i < n * kLeafParts; i += kThreads) {
      const int part = i / n, leaf = i - part * n;
      leaf_part(part, In + kIn * leaf, g, X + leaf * kSeg);
    }
    __syncthreads();
    laps.lap(3, X[oQ]);
    // the tile's tree: X -> Y -> X ... until one segment
    float* src = X;
    float* dst = Y;
    for (int m = n / 2, lvl = 4; m >= 1; m /= 2, ++lvl) {
      compose_level(src, dst, M, m, tid);
      laps.lap(lvl, dst[oQ]);
      float* x = src;
      src = dst;
      dst = x;
    }
    // src holds the tile's segment; onto the window's
    if (last_tile == 0) {
      win = src;  // one tile: its segment is the window's
    } else if (t == 0) {
      for (int k = tid; k < kSeg; k += kThreads) acc[k] = src[k];
      __syncthreads();
    } else {
      for (int i = tid; i < kM; i += kThreads) compose_item(acc, src, tmp, M, i);
      __syncthreads();
      for (int k = tid; k < 81; k += kThreads)
        tmp[oQ + k] = add(mm9_at(M, src + oA, k / 9, k % 9, true), src[oQ + k]);
      __syncthreads();
      for (int k = tid; k < kSeg; k += kThreads) acc[k] = tmp[k];
      __syncthreads();
    }
    laps.lap(10, win[oQ]);
  }
  // the window's segment out (A stays behind)
  if (tid < 9) {
    g.oR_[9 * b + tid] = win[oR + tid];
    g.oRG_[9 * b + tid] = win[oRG + tid];
    g.oVA_[9 * b + tid] = win[oVA + tid];
    g.oVG_[9 * b + tid] = win[oVG + tid];
    g.oPA_[9 * b + tid] = win[oPA + tid];
    g.oPG_[9 * b + tid] = win[oPG + tid];
  }
  if (tid < 3) {
    g.oV_[3 * b + tid] = win[oV + tid];
    g.oP_[3 * b + tid] = win[oP + tid];
  }
  if (tid == 0) g.oT_[b] = win[oT];
  if (tid < 81) g.oCov[81 * b + tid] = win[oQ + tid];
  laps.lap(11, win[0]);
  span(13, true);
}

// Kernels this library launched (host side): a caller counts a call's.
long long g_launches = 0;
// The opt-in to more than 48 KB of dynamic shared memory is per device
// context: set once per device.
bool g_opted_in[256] = {};

}  // namespace

extern "C" {

long long liorf_preintegrate_kernel_launches() { return g_launches; }

#ifdef LIORF_PREINTEGRATE_PROFILE
// The last launch's slots (kProfSlots), then every slot reset.
int liorf_preintegrate_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfSlots);
  if (err != cudaSuccess) return (int)err;
  long long reset[kProfSlots] = {};
  reset[12] = 0x7fffffffffffffffLL;
  return (int)cudaMemcpyToSymbol(g_prof, reset, sizeof(reset));
}
#endif

// The preintegrated window of each of `lanes` lanes on `stream` of
// `device`. `ptrs` holds 16 addresses of contiguous device arrays with a
// leading lane axis: acc, gyr [lanes, K, 3], dts [lanes, K] (float), mask
// [lanes, K] (bool), ba, bg [lanes, 3]; then the ten outputs of
// ops/preintegrate.py::FIELDS. sg2, sa2, si2: the gyro, accel and
// integration noise densities squared.
int liorf_preintegrate(const long long* ptrs, float sg2, float sa2, float si2, int K, int lanes,
                       int device, void* stream) {
  if (lanes == 0) return 0;
  if (K < 1 || device < 0 || device >= 256) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!g_opted_in[device]) {
    err = cudaFuncSetAttribute(preintegrate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSharedBytes);
    g_opted_in[device] = err == cudaSuccess;
  }
  if (err == cudaSuccess) {
    Args g;
    const float* const* f = reinterpret_cast<const float* const*>(ptrs);
    g.acc = f[0]; g.gyr = f[1]; g.dts = f[2];
    g.mask = reinterpret_cast<const uint8_t*>(ptrs[3]);
    g.ba = f[4]; g.bg = f[5];
    float* const* o = reinterpret_cast<float* const*>(ptrs + 6);
    g.oR_ = o[0]; g.oV_ = o[1]; g.oP_ = o[2]; g.oT_ = o[3]; g.oRG_ = o[4]; g.oVA_ = o[5];
    g.oVG_ = o[6]; g.oPA_ = o[7]; g.oPG_ = o[8]; g.oCov = o[9];
    g.sg2 = sg2; g.sa2 = sa2; g.si2 = si2; g.K = K;
    preintegrate_kernel<<<lanes, kThreads, kSharedBytes, (cudaStream_t)stream>>>(g);
    ++g_launches;
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
