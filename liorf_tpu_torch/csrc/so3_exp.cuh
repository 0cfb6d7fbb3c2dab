// so3_exp and the right Jacobian of SO(3) in IEEE float32 with every
// operation rounded on its own, and the 3 x 3 products they are made of;
// included by csrc/fusion.cu (the IMU fusion correction) and
// csrc/preintegrate.cu (IMU preintegration). Python spells the same
// operations in core/so3_jvp.py (mm, mv, exp_terms, so3_exp, jr_term), which
// the two kernels' plain versions import, so each kernel equals its plain
// version bit for bit on the card. sin and cos are taken in double and
// rounded to float, as the plain versions take them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "so3_log.cuh"

namespace {

// A B
__device__ __forceinline__ void mm(const float A[3][3], const float B[3][3], float out[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[a][c] = sum3(mul(A[a][0], B[0][c]), mul(A[a][1], B[1][c]), mul(A[a][2], B[2][c]));
}

// A x
__device__ __forceinline__ void mv(const float A[3][3], const float x[3], float out[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = sum3(mul(A[a][0], x[0]), mul(A[a][1], x[1]), mul(A[a][2], x[2]));
}

__device__ __forceinline__ void hat3(const float w[3], float W[3][3]) {
  W[0][0] = 0.0f; W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2]; W[1][1] = 0.0f; W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0]; W[2][2] = 0.0f;
}

// so3_exp's scalars (core/se3.py::_rodrigues_terms)
struct Exp {
  float th2, st, sn, cs, A, B;
  bool small;
};

__device__ __forceinline__ void exp_terms(const float w[3], Exp& e) {
  e.th2 = sum3(mul(w[0], w[0]), mul(w[1], w[1]), mul(w[2], w[2]));
  const float th = __fsqrt_rn(e.th2);
  e.small = th < 1e-5f;
  e.st = e.small ? 1.0f : th;
  e.sn = (float)sin((double)e.st);  // as the plain version
  e.cs = (float)cos((double)e.st);
  e.A = e.small ? sub(1.0f, dvd(e.th2, 6.0f)) : dvd(e.sn, e.st);
  e.B = e.small ? sub(0.5f, dvd(e.th2, 24.0f)) : dvd(sub(1.0f, e.cs), mul(e.st, e.st));
}

// I + A W + B W^2
__device__ __forceinline__ void so3_exp(const float w[3], float R[3][3]) {
  Exp e;
  exp_terms(w, e);
  float W[3][3], W2[3][3];
  hat3(w, W);
  mm(W, W, W2);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      R[a][c] = add(add(a == c ? 1.0f : 0.0f, mul(e.A, W[a][c])), mul(e.B, W2[a][c]));
}

// (theta - sin theta) / theta^3, the W^2 coefficient of the left and right
// Jacobians (core/se3.py::_rodrigues_terms): 1/6 - theta^2 / 120 below 1e-5
__device__ __forceinline__ float jr_term(const Exp& e) {
  return e.small ? sub(kSixth, mul(e.th2, (float)(1.0 / 120.0)))
                 : dvd(sub(e.st, e.sn), mul(mul(e.st, e.st), e.st));
}

// Jr(w) = Jl(-w) = I - B W + C W^2, from w's scalars, hat and W^2
__device__ __forceinline__ void so3_right_jacobian(const Exp& e, const float W[3][3],
                                                   const float W2[3][3], float J[3][3]) {
  const float C = jr_term(e);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      J[a][c] = add(sub(a == c ? 1.0f : 0.0f, mul(e.B, W[a][c])), mul(C, W2[a][c]));
}

}  // namespace
