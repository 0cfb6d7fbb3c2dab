// Device helpers shared by the scan matcher's Gauss-Newton kernels
// (scan_gn.cu), ICP's alignment kernel (icp_align.cu) and the deskew
// (deskew.cu, the rounded ops and the euler rotation): every operation
// rounded on its own, the halving-tree sum, cyclic Jacobi rotations, the
// rotation of an euler pose, the transform of a point by it, and two small
// kernels: the points of every lane moved by its pose, and the one flag a
// loop's host reads.
//
// The order contract these keep is spelled in torch ops by
// ops/scan_gn.py (and ops/plane_fit.py for the Jacobi sweeps); on the card
// the two agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {

// points a tile: the first level of every point sum (ops/scan_gn.py::TILE)
constexpr int kTile = 128;

__host__ __device__ constexpr int pow2ceil(int n) { return n <= 1 ? 1 : 2 * pow2ceil((n + 1) / 2); }

// each operation rounded on its own (nvcc would contract a * b + c to an FMA)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ float absv(float x) { return fabsf(x); }
__device__ __forceinline__ double absv(double x) { return fabs(x); }

// (a0 b0 + a1 b1) + a2 b2
template <class T>
__device__ __forceinline__ T dot3(T a0, T a1, T a2, T b0, T b1, T b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

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

// One Jacobi rotation of the symmetric a (both triangles kept) in the plane
// (p, q), accumulated into the columns of v: tau = (a_qq - a_pp) / (2 a_pq),
// t = sign(tau) / (|tau| + sqrt(tau^2 + 1)) (sign(0) = 1; t = 0 where
// a_pq = 0), c = 1 / sqrt(t^2 + 1), s = t c; a_pp -= t a_pq, a_qq += t a_pq,
// a_pq = 0, a_rp = c a_rp - s a_rq and a_rq = s a_rp + c a_rq for the other
// rows, the same on v's columns p and q for every row.
template <int N, class T>
__device__ __forceinline__ void rotate(T (&a)[N][N], T (&v)[N][N], int p, int q) {
  const T apq = a[p][q];
  T t = T(0);
  if (apq != T(0)) {
    const T tau = dvd(sub(a[q][q], a[p][p]), mul(T(2), apq));
    t = dvd(tau >= T(0) ? T(1) : T(-1), add(absv(tau), root(add(mul(tau, tau), T(1)))));
  }
  const T c = dvd(T(1), root(add(mul(t, t), T(1))));
  const T s = mul(t, c);
  const T app = sub(a[p][p], mul(t, apq));
  const T aqq = add(a[q][q], mul(t, apq));
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r == p || r == q) continue;
    const T arp = a[r][p], arq = a[r][q];
    a[r][p] = a[p][r] = sub(mul(c, arp), mul(s, arq));
    a[r][q] = a[q][r] = add(mul(s, arp), mul(c, arq));
  }
  a[p][p] = app;
  a[q][q] = aqq;
  a[p][q] = a[q][p] = T(0);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const T vrp = v[r][p], vrq = v[r][q];
    v[r][p] = sub(mul(c, vrp), mul(s, vrq));
    v[r][q] = add(mul(s, vrp), mul(c, vrq));
  }
}

// Cyclic Jacobi: `sweeps` sweeps over the pairs (p, q), p < q, row by row.
// a ends diagonal (its eigenvalues, unsorted), v holds the eigenvectors in
// its columns.
template <int N, int SWEEPS, class T>
__device__ __forceinline__ void jacobi(T (&a)[N][N], T (&v)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) v[r][c] = r == c ? T(1) : T(0);
#pragma unroll
  for (int sweep = 0; sweep < SWEEPS; ++sweep)
#pragma unroll
    for (int p = 0; p < N - 1; ++p)
#pragma unroll
      for (int q = p + 1; q < N; ++q) rotate<N, T>(a, v, p, q);
}

// cos and sin of a float pose's euler angles, taken in double and rounded
// to float (torch and the kernels then agree on the card)
__device__ __forceinline__ void trig(const float* rpy, float (&c)[3], float (&s)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = (float)cos((double)rpy[k]);
    s[k] = (float)sin((double)rpy[k]);
  }
}

// R = Rz(yaw) Ry(pitch) Rx(roll) (core/se3.py::euler_to_rot's products)
__device__ __forceinline__ void rot_from_trig(const float (&c)[3], const float (&s)[3],
                                              float (&R)[3][3]) {
  const float cr = c[0], cp = c[1], cy = c[2], sr = s[0], sp = s[1], sy = s[2];
  R[0][0] = mul(cy, cp);
  R[0][1] = sub(mul(mul(cy, sp), sr), mul(sy, cr));
  R[0][2] = add(mul(mul(cy, sp), cr), mul(sy, sr));
  R[1][0] = mul(sy, cp);
  R[1][1] = add(mul(mul(sy, sp), sr), mul(cy, cr));
  R[1][2] = sub(mul(mul(sy, sp), cr), mul(cy, sr));
  R[2][0] = -sp;
  R[2][1] = mul(cp, sr);
  R[2][2] = mul(cp, cr);
}

__device__ __forceinline__ void rot_f32(const float* rpy, float (&R)[3][3]) {
  float c[3], s[3];
  trig(rpy, c, s);
  rot_from_trig(c, s, R);
}

// R p + t: ((R_r0 p0 + R_r1 p1) + R_r2 p2) + t_r
__device__ __forceinline__ void transform(const float (&R)[3][3], const float* t, const float* p,
                                          float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = add(dot3(R[r][0], R[r][1], R[r][2], p[0], p[1], p[2]), t[r]);
}

// The points xyz [lanes, n, 3] of every lane moved by the lane's pose
// [lanes, 6] (out may not alias xyz): a grid of (point blocks, lanes), one
// thread a point; a block forms its lane's rotation once.
constexpr int kMoveThreads = 256;

__global__ void __launch_bounds__(kMoveThreads) transform_kernel(const float* pose, const float* xyz,
                                                                  float* out, int n) {
  const int b = blockIdx.y;
  __shared__ float sR[3][3], st[3];
  if (threadIdx.x == 0) {
    rot_f32(pose + b * 6, sR);
#pragma unroll
    for (int i = 0; i < 3; ++i) st[i] = pose[b * 6 + 3 + i];
  }
  __syncthreads();
  float R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = st[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = sR[i][j];
  }
  const long long i = (long long)blockIdx.x * kMoveThreads + threadIdx.x;
  if (i < n) transform(R, t, xyz + ((long long)b * n + i) * 3, out + ((long long)b * n + i) * 3);
}

inline int launch_transform(const float* pose, const float* xyz, float* out, int lanes, int n,
                            cudaStream_t s) {
  if (n <= 0 || lanes <= 0) return 0;
  transform_kernel<<<dim3((n + kMoveThreads - 1) / kMoveThreads, lanes), kMoveThreads, 0, s>>>(
      pose, xyz, out, n);
  return (int)cudaGetLastError();
}

// One flag for the host: every lane's done flag set.
__global__ void all_done_kernel(const uint8_t* done, int lanes, uint8_t* out) {
  if (threadIdx.x != 0) return;
  uint8_t all = 1;
  for (int b = 0; b < lanes; ++b) all = all && done[b];
  *out = all;
}

}  // namespace gn
