// The pose graph's linearization and normal-equation sums of one
// Gauss-Newton step, for NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/linearize.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing (the wrapper
// hands it its scratch), never synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package jits _build_normal_terms
// (liorf_tpu/graph/pose_graph.py:99-117,141-202: jacfwd of every factor's
// residual under vmap, whitening, the Cauchy weight, masks, then .at[].add of
// J^T r and J^T J per node) into a few fused XLA programs. Op by op on the
// card that was thousands of launches a GN step (jacfwd under vmap, ~45 ms
// of host time), and the sums behind it (csrc/segment_sum.cu) walked the
// unused slots of node 0 one thread a column. Here two kernels back to back
// on the stream (the step between them is the grid-wide barrier):
//
//   phase A (factors_kernel), one thread a factor slot (between, GPS, the
//     prior), every lane's slots in one grid: gather both endpoints, form
//     the residual and the Jacobians in closed form, whiten, weight (Cauchy)
//     and mask them, zero a frozen endpoint's columns, write the J blocks the
//     PCG kernel (csrc/pcg.cu) reads, and at each endpoint the factor's
//     row of 42 terms: -J^T r (6) and J^T J (36), with a flag saying whether
//     any of them is nonzero;
//   phase B (sums_kernel), one warp a node: its first and last sorted rows
//     found once (binary search of the plan's keys), then its rows in the
//     plan's stable sorted order in chunks of 32 (a ballot of the flags),
//     each lane summing one or two of the 42 elements from 0.0f.
//
// The Jacobians (at the zero tangent, right-perturbation retraction): the
// rotation rows are the derivative of so3_log's formula (the branch the
// value takes: theta < 1e-5, generic, theta > pi - 1e-2 with the axis
// rebuilt from the symmetric part) along the directions jacfwd perturbs its
// argument in: Q hat(e_k) for w_j (and the prior), Rm^T (-hat(e_k) P) for
// w_i, with Q = Rm^T P, P = Ri^T Rj; d r_t / d w_i = [Ri^T (tj - ti)]x,
// d r_t / d v_i = -I, d r_t / d v_j = P. GPS: [0 | Ri]. Prior: [[dlog, 0],
// [0, Ri]].
//
// The order contract (ops/linearize.py::linearize_normal_plain spells it in
// torch ops; on the card the two agree bit for bit wherever the operations
// are IEEE-rounded): every product, sum, quotient and square root is
// rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: nvcc
// would contract to FMAs); a 3-term product sum is (a0 b0 + a1 b1) + a2 b2;
// a factor's J^T r and J^T J add its residual rows in index order from the
// first product; a node's sums add its rows in the plan's sorted order from
// 0.0f. atan2 is the one library-rounded function, taken in double and
// rounded to float as the plain version takes it. A row whose 42 terms
// are all zero adds an exact +0.0 to a sum that starts at +0.0 and is never
// -0.0, so phase B skips it: no bit changes, and the unused slots, which all
// name node 0, no longer make node 0's walk hundreds of rows long.
//
// What bounds it: neither bytes (about 0.5 MB at the resident default's
// full solve) nor operations (about 2 MFLOP) but latency: one thread's
// chain of a few thousand dependent operations for a between factor, then
// a node's walk of its rows through L2. Two launches, no host round trip.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRow = 42;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNearPi = (float)(3.14159265358979323846 - 1e-2);
constexpr float kSixth = (float)(1.0 / 6.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, b), c); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Args {
  const float* Rs;        // [B, K, 3, 3]
  const float* ts;        // [B, K, 3]
  const int64_t* ei;      // [B, E]
  const int64_t* ej;      // [B, E]
  const float* eRm;       // [B, E, 3, 3]
  const float* etm;       // [B, E, 3]
  const float* esi;       // [B, E, 6]
  const float* ecauchy;   // [B, E]
  const uint8_t* emask;   // [B, E]
  const int64_t* gi;      // [B, G]
  const float* gt;        // [B, G, 3]
  const float* gsi;       // [B, G, 3]
  const uint8_t* gmask;   // [B, G]
  const int64_t* pi;      // [B, 1]
  const float* pR;        // [B, 3, 3]
  const float* pt;        // [B, 3]
  const float* psi;       // [B, 6]
  const uint8_t* free_;   // [B, K]
  const int64_t* keys;    // [B, M] sorted node of each plan row
  const int64_t* perm;    // [B, M] plan row (Ji rows, Jj rows, GPS, prior)
  float* rhs;             // [B, K, 6] out
  float* diag;            // [B, K, 6, 6] out
  float* Ji;              // [B, E, 6, 6] out
  float* Jj;              // [B, E, 6, 6] out
  float* Jg;              // [B, G, 3, 6] out
  float* Jp;              // [B, 6, 6] out
  float* rows;            // [B, M, 42] scratch
  int32_t* flags;         // [B, M] scratch
  int B, K, E, G;
};

__device__ __forceinline__ void load33(const float* p, float A[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) A[a][c] = __ldg(p + 3 * a + c);
}

// A^T B
__device__ __forceinline__ void mtm(const float A[3][3], const float B[3][3], float out[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[a][c] = sum3(mul(A[0][a], B[0][c]), mul(A[1][a], B[1][c]), mul(A[2][a], B[2][c]));
}

// Q hat(e_k): columns (0, Q2, -Q1), (-Q2, 0, Q0), (Q1, -Q0, 0)
__device__ __forceinline__ void q_hat(const float Q[3][3], int k, float out[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float q0 = Q[a][0], q1 = Q[a][1], q2 = Q[a][2];
    if (k == 0) { out[a][0] = 0.0f; out[a][1] = q2; out[a][2] = -q1; }
    else if (k == 1) { out[a][0] = -q2; out[a][1] = 0.0f; out[a][2] = q0; }
    else { out[a][0] = q1; out[a][1] = -q0; out[a][2] = 0.0f; }
  }
}

// -hat(e_k) P: rows (0, P2, -P1), (-P2, 0, P0), (P1, -P0, 0)
__device__ __forceinline__ void hat_p(const float P[3][3], int k, float out[3][3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p0 = P[0][c], p1 = P[1][c], p2 = P[2][c];
    if (k == 0) { out[0][c] = 0.0f; out[1][c] = p2; out[2][c] = -p1; }
    else if (k == 1) { out[0][c] = -p2; out[1][c] = 0.0f; out[2][c] = p0; }
    else { out[0][c] = p1; out[1][c] = -p0; out[2][c] = 0.0f; }
  }
}

// so3_log's value and what its derivative needs (core/se3.py::so3_log).
struct Log {
  float w[3];
  float cos_, sin_, theta, scale, safe;
  float ws[3];
  bool cin, small_s, small, near, tiny;
  float den, ax2[3], aabs[3], sg[3], ax[3], nrm, axn[3];
  bool den_in, pos[3], a_pos;
};

__device__ __forceinline__ void log_value(const float Q[3][3], Log& L) {
  const float tr = sum3(Q[0][0], Q[1][1], Q[2][2]);
  const float cr = mul(sub(tr, 1.0f), 0.5f);
  L.cin = cr >= -1.0f && cr <= 1.0f;
  L.cos_ = clampf(cr, -1.0f, 1.0f);
  L.ws[0] = mul(sub(Q[2][1], Q[1][2]), 0.5f);
  L.ws[1] = mul(sub(Q[0][2], Q[2][0]), 0.5f);
  L.ws[2] = mul(sub(Q[1][0], Q[0][1]), 0.5f);
  const float s2 = sum3(mul(L.ws[0], L.ws[0]), mul(L.ws[1], L.ws[1]), mul(L.ws[2], L.ws[2]));
  L.small_s = s2 < 1e-12f;
  L.sin_ = L.small_s ? 0.0f : __fsqrt_rn(s2);
  L.theta = (float)atan2((double)L.sin_, (double)L.cos_);  // as the plain version
  L.small = L.theta < 1e-5f;
  L.near = L.theta > kNearPi;
  L.tiny = L.sin_ < 1e-9f;
  L.safe = L.tiny ? 1.0f : L.sin_;
  L.scale = L.small ? add(1.0f, mul(s2, kSixth)) : dvd(L.theta, L.safe);
  if (!L.near) {
#pragma unroll
    for (int c = 0; c < 3; ++c) L.w[c] = mul(L.ws[c], L.scale);
    return;
  }
  // near pi: the axis from the diagonal of M = (Q + Q^T) / 2 - cos I
  const float d[3] = {sub(Q[0][0], L.cos_), sub(Q[1][1], L.cos_), sub(Q[2][2], L.cos_)};
  const float omc = sub(1.0f, L.cos_);
  L.den_in = omc >= 1e-9f;
  L.den = fmaxf(omc, 1e-9f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    L.ax2[a] = dvd(d[a], L.den);
    L.pos[a] = L.ax2[a] > 1e-12f;
    L.aabs[a] = L.pos[a] ? __fsqrt_rn(L.ax2[a]) : 0.0f;
  }
  int r = 0;  // the first largest diagonal
  if (d[1] > d[r]) r = 1;
  if (d[2] > d[r]) r = 2;
  float row[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float m0 = c == 0 ? d[0] : mul(add(Q[0][c], Q[c][0]), 0.5f);
    const float m1 = c == 1 ? d[1] : mul(add(Q[1][c], Q[c][1]), 0.5f);
    const float m2 = c == 2 ? d[2] : mul(add(Q[2][c], Q[c][2]), 0.5f);
    row[c] = r == 0 ? m0 : (r == 1 ? m1 : m2);
  }
  const float skew_r = r == 0 ? L.ws[0] : (r == 1 ? L.ws[1] : L.ws[2]);
  const float sgr = skew_r >= 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    L.sg[c] = mul(row[c] >= 0.0f ? 1.0f : -1.0f, sgr);
    L.ax[c] = mul(L.aabs[c], L.sg[c]);
  }
  const float a2 = sum3(mul(L.ax[0], L.ax[0]), mul(L.ax[1], L.ax[1]), mul(L.ax[2], L.ax[2]));
  L.a_pos = a2 > 1e-12f;
  L.nrm = L.a_pos ? __fsqrt_rn(a2) : 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    L.axn[c] = dvd(L.ax[c], L.nrm);
    L.w[c] = mul(L.axn[c], L.theta);
  }
}

// The derivative of so3_log at L's rotation along dQ.
__device__ __forceinline__ void log_tangent(const Log& L, const float dQ[3][3], float dw[3]) {
  const float dcos = L.cin ? mul(sum3(dQ[0][0], dQ[1][1], dQ[2][2]), 0.5f) : 0.0f;
  const float dws[3] = {mul(sub(dQ[2][1], dQ[1][2]), 0.5f), mul(sub(dQ[0][2], dQ[2][0]), 0.5f),
                        mul(sub(dQ[1][0], dQ[0][1]), 0.5f)};
  const float ds2 =
      mul(sum3(mul(L.ws[0], dws[0]), mul(L.ws[1], dws[1]), mul(L.ws[2], dws[2])), 2.0f);
  const float dsin = L.small_s ? 0.0f : dvd(ds2, mul(L.sin_, 2.0f));
  const float dtheta = dvd(sub(mul(L.cos_, dsin), mul(L.sin_, dcos)),
                           add(mul(L.sin_, L.sin_), mul(L.cos_, L.cos_)));
  if (!L.near) {
    const float dsafe = L.tiny ? 0.0f : dsin;
    const float dscale =
        L.small ? mul(ds2, kSixth) : dvd(sub(dtheta, mul(L.scale, dsafe)), L.safe);
#pragma unroll
    for (int c = 0; c < 3; ++c) dw[c] = add(mul(dws[c], L.scale), mul(L.ws[c], dscale));
    return;
  }
  const float dden = L.den_in ? -dcos : 0.0f;
  float dax[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dax2 = dvd(sub(sub(dQ[a][a], dcos), mul(L.ax2[a], dden)), L.den);
    const float daabs = L.pos[a] ? dvd(dax2, mul(L.aabs[a], 2.0f)) : 0.0f;
    dax[a] = mul(daabs, L.sg[a]);
  }
  const float da2 =
      mul(sum3(mul(L.ax[0], dax[0]), mul(L.ax[1], dax[1]), mul(L.ax[2], dax[2])), 2.0f);
  const float dnrm = L.a_pos ? dvd(da2, mul(L.nrm, 2.0f)) : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float daxn = dvd(sub(dax[c], mul(L.axn[c], dnrm)), L.nrm);
    dw[c] = add(mul(daxn, L.theta), mul(L.axn[c], dtheta));
  }
}

// A factor's row at one endpoint: -J^T r (6) and J^T J (36), each over the R
// residual rows in index order; its flag says whether any term is nonzero.
template <int R>
__device__ __forceinline__ void write_row(const float J[R][6], const float rw[R], float* out,
                                          int32_t* flag) {
  bool nz = false;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float acc = mul(J[0][c], rw[0]);
#pragma unroll
    for (int s = 1; s < R; ++s) acc = add(acc, mul(J[s][c], rw[s]));
    out[c] = -acc;
    nz |= acc != 0.0f;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float acc = mul(J[0][a], J[0][c]);
#pragma unroll
      for (int s = 1; s < R; ++s) acc = add(acc, mul(J[s][a], J[s][c]));
      out[6 + 6 * a + c] = acc;
      nz |= acc != 0.0f;
    }
  *flag = nz;
}

template <int R>
__device__ __forceinline__ void store_J(const float J[R][6], float* out) {
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int c = 0; c < 6; ++c) out[6 * s + c] = J[s][c];
}

__device__ void between(const Args& a, long long b, int e) {
  const int K = a.K, E = a.E, M = 2 * a.E + a.G + 1;
  const long long f = b * E + e;
  const long long i = b * K + __ldg(reinterpret_cast<const long long*>(a.ei) + f);
  const long long j = b * K + __ldg(reinterpret_cast<const long long*>(a.ej) + f);
  float Ri[3][3], Rj[3][3], Rm[3][3];
  load33(a.Rs + i * 9, Ri);
  load33(a.Rs + j * 9, Rj);
  load33(a.eRm + f * 9, Rm);
  float P[3][3], Q[3][3];
  mtm(Ri, Rj, P);
  mtm(Rm, P, Q);
  float dt[3], u[3], r[6], si[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) dt[c] = sub(__ldg(a.ts + j * 3 + c), __ldg(a.ts + i * 3 + c));
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = sum3(mul(Ri[0][c], dt[0]), mul(Ri[1][c], dt[1]), mul(Ri[2][c], dt[2]));
  Log L;
  log_value(Q, L);
  float A[3][6];  // d r_R / d (w_i, w_j)
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float X[3][3], dQ[3][3], dw[3];
    hat_p(P, k, X);
    mtm(Rm, X, dQ);
    log_tangent(L, dQ, dw);
#pragma unroll
    for (int s = 0; s < 3; ++s) A[s][k] = dw[s];
    q_hat(Q, k, dQ);
    log_tangent(L, dQ, dw);
#pragma unroll
    for (int s = 0; s < 3; ++s) A[s][3 + k] = dw[s];
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    r[s] = L.w[s];
    r[3 + s] = sub(u[s], __ldg(a.etm + f * 3 + s));
  }
  float rw[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    si[s] = __ldg(a.esi + f * 6 + s);
    rw[s] = mul(r[s], si[s]);
  }
  float rn2 = mul(rw[0], rw[0]);
#pragma unroll
  for (int s = 1; s < 6; ++s) rn2 = add(rn2, mul(rw[s], rw[s]));
  const float c = __ldg(a.ecauchy + f);
  float w_rob = 1.0f;
  if (c > 0.0f) w_rob = dvd(1.0f, add(1.0f, dvd(rn2, fmaxf(mul(c, c), 1e-12f))));
  const float w = mul(__fsqrt_rn(w_rob), a.emask[f] ? 1.0f : 0.0f);
#pragma unroll
  for (int s = 0; s < 6; ++s) rw[s] = mul(rw[s], w);

  // Ji = [[A_i, 0], [u x, -I]], Jj = [[A_j, 0], [0, P]], rows whitened and
  // weighted, columns of a frozen endpoint zeroed
  const float fi = a.free_[i] ? 1.0f : 0.0f, fj = a.free_[j] ? 1.0f : 0.0f;
  const float ux[3][3] = {{0.0f, -u[2], u[1]}, {u[2], 0.0f, -u[0]}, {-u[1], u[0], 0.0f}};
  float J[6][6];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      J[s][q] = A[s][q];
      J[s][3 + q] = 0.0f;
      J[3 + s][q] = ux[s][q];
      J[3 + s][3 + q] = s == q ? -1.0f : 0.0f;
    }
#pragma unroll
  for (int s = 0; s < 6; ++s)
#pragma unroll
    for (int q = 0; q < 6; ++q) J[s][q] = mul(mul(mul(J[s][q], si[s]), w), fi);
  store_J<6>(J, a.Ji + f * 36);
  write_row<6>(J, rw, a.rows + (b * M + e) * kRow, a.flags + b * M + e);
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      J[s][q] = A[s][3 + q];
      J[s][3 + q] = 0.0f;
      J[3 + s][q] = 0.0f;
      J[3 + s][3 + q] = P[s][q];
    }
#pragma unroll
  for (int s = 0; s < 6; ++s)
#pragma unroll
    for (int q = 0; q < 6; ++q) J[s][q] = mul(mul(mul(J[s][q], si[s]), w), fj);
  store_J<6>(J, a.Jj + f * 36);
  write_row<6>(J, rw, a.rows + (b * M + E + e) * kRow, a.flags + b * M + E + e);
}

__device__ void gps(const Args& a, long long b, int g) {
  const int K = a.K, G = a.G, M = 2 * a.E + a.G + 1;
  const long long f = b * G + g;
  const long long i = b * K + __ldg(reinterpret_cast<const long long*>(a.gi) + f);
  float Ri[3][3];
  load33(a.Rs + i * 9, Ri);
  const float m = a.gmask[f] ? 1.0f : 0.0f, fi = a.free_[i] ? 1.0f : 0.0f;
  float rw[3], J[3][6];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float si = __ldg(a.gsi + f * 3 + s);
    rw[s] = mul(mul(sub(__ldg(a.ts + i * 3 + s), __ldg(a.gt + f * 3 + s)), si), m);
#pragma unroll
    for (int q = 0; q < 6; ++q) J[s][q] = mul(mul(mul(q < 3 ? 0.0f : Ri[s][q - 3], si), m), fi);
  }
  store_J<3>(J, a.Jg + f * 18);
  const int row = 2 * a.E + g;
  write_row<3>(J, rw, a.rows + (b * M + row) * kRow, a.flags + b * M + row);
}

__device__ void prior(const Args& a, long long b) {
  const int K = a.K, M = 2 * a.E + a.G + 1;
  const long long i = b * K + __ldg(reinterpret_cast<const long long*>(a.pi) + b);
  float Ri[3][3], R0[3][3], Q[3][3];
  load33(a.Rs + i * 9, Ri);
  load33(a.pR + b * 9, R0);
  mtm(R0, Ri, Q);
  Log L;
  log_value(Q, L);
  const float fi = a.free_[i] ? 1.0f : 0.0f;
  float J[6][6], rw[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dQ[3][3], dw[3];
    q_hat(Q, k, dQ);
    log_tangent(L, dQ, dw);
#pragma unroll
    for (int s = 0; s < 3; ++s) J[s][k] = dw[s];
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      J[s][3 + q] = 0.0f;
      J[3 + s][q] = 0.0f;
      J[3 + s][3 + q] = Ri[s][q];
    }
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const float psi = __ldg(a.psi + b * 6 + s);
    const float r = s < 3 ? L.w[s] : sub(__ldg(a.ts + i * 3 + s - 3), __ldg(a.pt + b * 3 + s - 3));
    rw[s] = mul(r, psi);
#pragma unroll
    for (int q = 0; q < 6; ++q) J[s][q] = mul(mul(J[s][q], psi), fi);
  }
  store_J<6>(J, a.Jp + b * 36);
  write_row<6>(J, rw, a.rows + (b * M + M - 1) * kRow, a.flags + b * M + M - 1);
}

__global__ void __launch_bounds__(128) factors_kernel(Args a) {
  const int F = a.E + a.G + 1;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)a.B * F) return;
  const long long b = t / F;
  const int f = (int)(t - b * F);
  if (f < a.E) between(a, b, f);
  else if (f < a.E + a.G) gps(a, b, f - a.E);
  else prior(a, b);
}

__device__ __forceinline__ int lower_bound(const int64_t* __restrict__ keys, int m, long long v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(reinterpret_cast<const long long*>(keys) + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One warp a (lane, node): its 42 sums over its nonzero rows in sorted order.
__global__ void __launch_bounds__(256) sums_kernel(Args a) {
  const long long wid = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)a.B * a.K) return;  // the whole warp
  const int M = 2 * a.E + a.G + 1;
  const long long b = wid / a.K;
  const int k = (int)(wid - b * a.K);
  const int64_t* keys = a.keys + b * M;
  const long long* perm = reinterpret_cast<const long long*>(a.perm + b * M);
  const int32_t* flags = a.flags + b * M;
  const float* rows = a.rows + b * M * kRow;
  const int lo = lower_bound(keys, M, k), hi = lower_bound(keys, M, k + 1);
  float acc0 = 0.0f, acc1 = 0.0f;  // elements lane and 32 + lane
  for (int base = lo; base < hi; base += 32) {
    const int s = base + lane;
    int row = 0;
    bool keep = false;
    if (s < hi) {
      row = (int)__ldg(perm + s);
      keep = flags[row] != 0;
    }
    unsigned ballot = __ballot_sync(kFull, keep);
    while (ballot) {
      const int src = __ffs(ballot) - 1;
      ballot &= ballot - 1;
      const float* v = rows + (long long)__shfl_sync(kFull, row, src) * kRow;
      acc0 = add(acc0, v[lane]);
      if (lane < kRow - 32) acc1 = add(acc1, v[32 + lane]);
    }
  }
  const long long node = b * a.K + k;
  if (lane < 6) a.rhs[node * 6 + lane] = acc0;
  else a.diag[node * 36 + lane - 6] = acc0;
  if (lane < kRow - 32) a.diag[node * 36 + 26 + lane] = acc1;
}

}  // namespace

extern "C" {

// Every lane's linearization and node sums: phase A then phase B on
// `stream`. Pointers are contiguous device arrays in the order of Args;
// rows [lanes, 2E+G+1, 42] f32 and flags [lanes, 2E+G+1] i32 are scratch.
int liorf_linearize(const void* Rs, const void* ts, const void* ei, const void* ej,
                    const void* eRm, const void* etm, const void* esi, const void* ecauchy,
                    const void* emask, const void* gi, const void* gt, const void* gsi,
                    const void* gmask, const void* pi, const void* pR, const void* pt,
                    const void* psi, const void* free_, const void* keys, const void* perm,
                    void* rhs, void* diag, void* Ji, void* Jj, void* Jg, void* Jp, void* rows,
                    void* flags, int lanes, int K, int E, int G, void* stream) {
  if (lanes == 0 || K == 0) return 0;
  Args a;
  a.Rs = (const float*)Rs; a.ts = (const float*)ts;
  a.ei = (const int64_t*)ei; a.ej = (const int64_t*)ej;
  a.eRm = (const float*)eRm; a.etm = (const float*)etm; a.esi = (const float*)esi;
  a.ecauchy = (const float*)ecauchy; a.emask = (const uint8_t*)emask;
  a.gi = (const int64_t*)gi; a.gt = (const float*)gt; a.gsi = (const float*)gsi;
  a.gmask = (const uint8_t*)gmask; a.pi = (const int64_t*)pi;
  a.pR = (const float*)pR; a.pt = (const float*)pt; a.psi = (const float*)psi;
  a.free_ = (const uint8_t*)free_;
  a.keys = (const int64_t*)keys; a.perm = (const int64_t*)perm;
  a.rhs = (float*)rhs; a.diag = (float*)diag; a.Ji = (float*)Ji; a.Jj = (float*)Jj;
  a.Jg = (float*)Jg; a.Jp = (float*)Jp; a.rows = (float*)rows; a.flags = (int32_t*)flags;
  a.B = lanes; a.K = K; a.E = E; a.G = G;
  cudaStream_t s = (cudaStream_t)stream;
  const long long slots = (long long)lanes * (E + G + 1);
  factors_kernel<<<(unsigned)((slots + 127) / 128), 128, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)lanes * K * 32;
  sums_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
