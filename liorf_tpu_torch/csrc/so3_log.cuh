// so3_log and its forward-mode derivative, branch by branch, in IEEE float32
// with every operation rounded on its own; included by csrc/linearize.cu (the
// pose graph's factors) and csrc/fusion.cu (the IMU fusion correction).
// Python spells the same operations in core/so3_jvp.py::log_jvp, which the
// two kernels' plain versions import, so each kernel equals its plain version
// bit for bit on the card.
//
// The derivative is the one torch.func.jacfwd takes of core/se3.py::so3_log's
// formula (not the textbook one): in the branch the value takes (theta <
// 1e-5, generic, or theta > pi - 1e-2 with the axis rebuilt from the
// symmetric part). atan2 is the one library-rounded function, taken in double
// and rounded to float as the plain version takes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

}  // namespace
