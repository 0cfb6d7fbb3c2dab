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
// [0, Ri]]. so3_log's value and derivative are in so3_log.cuh, shared with
// csrc/fusion.cu.
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

#include "so3_log.cuh"

namespace {

constexpr int kRow = 42;
constexpr unsigned kFull = 0xffffffffu;

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
