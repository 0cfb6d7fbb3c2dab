// IMU-aided deskew of a scan (ops/deskew.py::deskew) in one launch, for
// NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/deskew.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package jits integrate_gyro and deskew_scan
// (liorf_tpu/ops/deskew.py:35-108) into its frame program. Op by op on the
// card that was ~70 eager launches a frame. Here a grid of (point blocks,
// lanes) does all of it; each block:
//
//   rebuilds its lane's timeline in shared memory: dt[i] = t[i] - t[i-1]
//     where sample i and i-1 are valid (else 0), the increments gyr dt (0
//     where invalid), their inclusive prefix by Hillis-Steele doubling in
//     double (log2 K rounds, two buffers), rounded to float once; the count
//     of valid samples; the times, +inf where invalid;
//   forms R0, the rotation at the scan's start (one thread);
//   then one thread a point: t = scan_start + rel_t, the upper bound of t in
//     the times (torch.searchsorted(right=True)'s binary search), every clamp
//     of ops/deskew.py::interp_rotation, the lerp, R = Rz Ry Rx of the angles
//     (gn_common.cuh::rot_f32: sin and cos in double, rounded to float), and
//     out = R0^T (R p); a masked-out point is copied.
//
// The order contract (ops/deskew.py::deskew_plain spells it in torch ops; on
// the card the two agree bit for bit): every product, sum and quotient is
// rounded on its own (gn_common.cuh's mul / add / sub / dvd: nvcc would
// contract to FMAs); a 3-term product sum is (a0 b0 + a1 b1) + a2 b2; the
// clamp of the ratio keeps a NaN, as torch.clamp does. No atomics but the
// integer count.
//
// What bounds it: the points' bytes, ~29 a point (xyz in and out, the time,
// the mask), and behind them the six double-precision sin / cos of a point.
// The timeline costs each block K loads and log2 K barriers, small beside
// 256 points for K up to a few hundred.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using gn::add;
using gn::dot3;
using gn::dvd;
using gn::mul;
using gn::sub;

constexpr int kThreads = 256;
constexpr int kMaxK = 2048;  // ops/deskew.py::MAX_K
// shared bytes a sample: the prefix's two double buffers (48), the times and
// the angles (16)
constexpr int kBytesPerSample = 64;

struct Args {
  const float* xyz;        // [lanes, N, 3]
  const float* rel_t;      // [lanes, N]
  const uint8_t* mask;     // [lanes, N]
  const float* start;      // [lanes]
  const float* times;      // [lanes, K]
  const float* gyr;        // [lanes, K, 3]
  const uint8_t* imask;    // [lanes, K]
  float* out;              // [lanes, N, 3]
  int N, K;
};

// torch.searchsorted(times, v, right=True): the first index whose time is
// greater than v, by the same binary search (any order of the times)
__device__ __forceinline__ int upper_bound(const float* times, int K, float v) {
  int start = 0, end = K;
  while (start < end) {
    const int mid = start + ((end - start) >> 1);
    if (!(times[mid] > v)) start = mid + 1;
    else end = mid;
  }
  return start;
}

// ops/deskew.py::interp_rotation at one time t
__device__ __forceinline__ void interp(const float* times, const float* ang, int K, int count,
                                       float t, float* a) {
  int hi = upper_bound(times, K, t);
  hi = min(max(hi, 1), max(count, 1));
  const int lo = hi - 1;
  hi = min(hi, max(count - 1, 0));
  const float t_lo = times[lo];
  const float t_hi = times[hi];
  const float denom = hi == lo ? 1.0f : sub(t_hi, t_lo);
  float ratio = dvd(sub(t, t_lo), denom == 0.0f ? 1.0f : denom);
  ratio = isnan(ratio) ? ratio : fminf(fmaxf(ratio, 0.0f), 1.0f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a_lo = ang[3 * lo + k];
    a[k] = add(a_lo, mul(sub(ang[3 * hi + k], a_lo), ratio));
  }
}

__global__ void __launch_bounds__(kThreads) deskew_kernel(Args g) {
  extern __shared__ double smem[];
  const int K = g.K;
  double* x0 = smem;                          // [K][3] the prefix, two buffers
  double* x1 = x0 + 3 * K;
  float* times = (float*)(x1 + 3 * K);        // [K]
  float* ang = times + K;                     // [K][3]
  __shared__ int count;
  __shared__ float R0[3][3];

  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const float* t_in = g.times + (size_t)lane * K;
  const float* w_in = g.gyr + (size_t)lane * K * 3;
  const uint8_t* v_in = g.imask + (size_t)lane * K;
  if (tid == 0) count = 0;
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < K; i += kThreads) {
    const bool valid = v_in[i] != 0;
    const bool both = valid && i > 0 && v_in[i - 1] != 0;
    const float ti = t_in[i];
    const float dt = both ? sub(ti, t_in[i - 1]) : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) x0[3 * i + k] = valid ? (double)mul(w_in[3 * i + k], dt) : 0.0;
    times[i] = valid ? ti : INFINITY;
    mine += valid;
  }
  atomicAdd(&count, mine);
  double* src = x0;
  double* dst = x1;
  for (int d = 1; d < K; d *= 2) {
    __syncthreads();
    for (int j = tid; j < 3 * K; j += kThreads)
      dst[j] = j >= 3 * d ? __dadd_rn(src[j], src[j - 3 * d]) : src[j];
    double* s = src;
    src = dst;
    dst = s;
  }
  __syncthreads();
  for (int j = tid; j < 3 * K; j += kThreads) ang[j] = (float)src[j];
  __syncthreads();
  const float start = g.start[lane];
  if (tid == 0) {
    float a[3];
    interp(times, ang, K, count, start, a);
    gn::rot_f32(a, R0);
  }
  __syncthreads();

  const int n = blockIdx.x * kThreads + tid;
  if (n >= g.N) return;
  const size_t p = (size_t)lane * g.N + n;
  const float px = g.xyz[3 * p], py = g.xyz[3 * p + 1], pz = g.xyz[3 * p + 2];
  float* o = g.out + 3 * p;
  if (!g.mask[p]) {
    o[0] = px;
    o[1] = py;
    o[2] = pz;
    return;
  }
  float a[3], R[3][3];
  interp(times, ang, K, count, add(start, g.rel_t[p]), a);
  gn::rot_f32(a, R);
  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = dot3(R[i][0], R[i][1], R[i][2], px, py, pz);
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = dot3(R0[0][c], R0[1][c], R0[2][c], r[0], r[1], r[2]);
}

}  // namespace

extern "C" {

// The deskewed points of each of `lanes` lanes on `stream`. Pointers are
// contiguous device arrays with a leading lane axis: xyz [lanes, N, 3], rel_t
// [lanes, N] (float), mask [lanes, N] (bool), start [lanes], times [lanes, K],
// gyr [lanes, K, 3], imask [lanes, K] (bool); out [lanes, N, 3].
int liorf_deskew(const void* xyz, const void* rel_t, const void* mask, const void* start,
                 const void* times, const void* gyr, const void* imask, void* out, int N, int K,
                 int lanes, void* stream) {
  if (lanes == 0 || N == 0) return 0;
  if (K < 1 || K > kMaxK || lanes > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)K * kBytesPerSample;
  // the opt-in is per device context: set it on every call (the current
  // device may change between calls), as csrc/pcg.cu does
  const cudaError_t err =
      cudaFuncSetAttribute(deskew_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  Args g;
  g.xyz = (const float*)xyz; g.rel_t = (const float*)rel_t; g.mask = (const uint8_t*)mask;
  g.start = (const float*)start; g.times = (const float*)times; g.gyr = (const float*)gyr;
  g.imask = (const uint8_t*)imask; g.out = (float*)out; g.N = N; g.K = K;
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)lanes);
  deskew_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
