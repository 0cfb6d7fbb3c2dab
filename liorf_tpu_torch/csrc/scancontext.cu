// The ScanContext descriptor (ops/scancontext.py::descriptors) in one launch,
// for NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/scancontext.py with the flags of core/build.py and loaded
// with ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package jits make_descriptor
// (liorf_tpu/ops/scancontext.py:34-53), a scatter-max into 20 x 60 polar
// bins, into its frame program. Op by op on the card that was ~15 eager
// launches. Here one cluster of kCluster thread blocks a lane does all of it:
//
//   one thread a point (a block takes every kCluster-th slice of
//     kThreads points): z + 2, r = sqrt(x x + y y), theta = atan2(y, x) in
//     degrees (+360 below 0), the ring ceil(r / 80 * 20) and the sector
//     ceil(theta / 360 * 60), each clamped to [1, n] less one; a point that is
//     masked in and within 80 m takes the max of its bin's z in the block's
//     1200 shared bins, by atomicMax on an order-preserving integer image of
//     the float (NaN as +inf);
//   after a cluster barrier, block q takes bins [150 q, 150 q + 150): the max
//     over the cluster's blocks (distributed shared memory), -inf (an empty
//     bin) and every other non-finite value written as 0.
//
// A max is exact, so the result has the same bits in any order of the
// atomics and repeats run to run. The order contract
// (ops/scancontext.py::make_descriptor_plain spells it in torch ops; on the
// card the two agree bit for bit): every product, sum, quotient and square
// root is rounded on its own, IEEE's (a quotient by a tensor, not torch's
// product with a scalar's reciprocal); atan2 is CUDA's atan2f, which torch's
// atan2 calls on the card; degrees are a product with float(180 / pi), as
// torch.rad2deg's.
//
// What bounds it: the points' bytes (13 a point) and, behind them, atan2f's
// ~40 operations a point; the shared atomics collide where many points
// share a bin (the ground near the sensor).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRing = 20;
constexpr int kSector = 60;
constexpr int kBins = kRing * kSector;
constexpr int kCluster = 8;                 // blocks a lane
constexpr int kThreads = 512;
constexpr int kOwn = kBins / kCluster;      // bins a block writes
static_assert(kOwn * kCluster == kBins, "the bins split evenly over the cluster");
constexpr float kMaxRadius = 80.0f;
constexpr float kLidarHeight = 2.0f;
// torch.rad2deg's constant, a double rounded to float as torch's product
// with a scalar rounds it
constexpr float kRad2Deg = (float)57.295779513082320876798154814105170332405472466564321549160243861;

// order-preserving image of a float: a < b <=> key(a) < key(b) (-0 < +0)
__device__ __forceinline__ unsigned key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unkey(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// torch.clamp(x, lo, hi) of a float: a NaN stays NaN
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
descriptor_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ mask,
                  float* __restrict__ out, int N) {
  __shared__ unsigned bins[kBins];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const unsigned empty = key(-INFINITY);
  for (int b = tid; b < kBins; b += kThreads) bins[b] = empty;
  __syncthreads();

  const float* p = xyz + (size_t)lane * N * 3;
  const uint8_t* m = mask + (size_t)lane * N;
  for (int n = rank * kThreads + tid; n < N; n += kCluster * kThreads) {
    if (!m[n]) continue;
    const float x = p[3 * n], y = p[3 * n + 1];
    const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
    if (!(r <= kMaxRadius)) continue;
    float z = __fadd_rn(p[3 * n + 2], kLidarHeight);
    if (isnan(z)) z = INFINITY;  // a NaN's bin reads 0, as torch's NaN-propagating amax gives
    float theta = __fmul_rn(atan2f(y, x), kRad2Deg);
    if (theta < 0.0f) theta = __fadd_rn(theta, 360.0f);
    const int ring = (int)clampf(ceilf(__fmul_rn(__fdiv_rn(r, kMaxRadius), (float)kRing)),
                                 1.0f, (float)kRing) - 1;
    const int sector = (int)clampf(ceilf(__fmul_rn(__fdiv_rn(theta, 360.0f), (float)kSector)),
                                   1.0f, (float)kSector) - 1;
    atomicMax(&bins[ring * kSector + sector], key(z));
  }
  cluster.sync();
  for (int b = rank * kOwn + tid; b < (rank + 1) * kOwn; b += kThreads) {
    unsigned k = empty;
    for (int q = 0; q < kCluster; ++q) k = max(k, cluster.map_shared_rank(bins, q)[b]);
    const float v = unkey(k);
    out[(size_t)lane * kBins + b] = isfinite(v) ? v : 0.0f;
  }
  cluster.sync();  // every block's bins stay alive until the others have read them
}

}  // namespace

extern "C" {

// The descriptors [lanes, 20, 60] of xyz [lanes, N, 3] (float) under mask
// [lanes, N] (bool), contiguous device arrays, on `stream`.
int liorf_scancontext(const void* xyz, const void* mask, void* out, int N, int lanes,
                      void* stream) {
  if (lanes == 0) return 0;
  if (N < 0 || (long long)lanes * kCluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  descriptor_kernel<<<lanes * kCluster, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const uint8_t*)mask, (float*)out, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
