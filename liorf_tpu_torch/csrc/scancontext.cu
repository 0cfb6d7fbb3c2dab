// The ScanContext descriptor (ops/scancontext.py::descriptors) in one launch,
// for NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/scancontext.py with the flags of core/build.py and loaded
// with ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launch's error code. The caller hands it the
// lanes' merge scratch (ops/scancontext.py::lane_scratch): 1200 keys a lane,
// the empty bin's key between launches, and an arrival counter a lane, 0
// between launches.
//
// Not a TPU kernel: the JAX package jits make_descriptor
// (liorf_tpu/ops/scancontext.py:34-53), a scatter-max into 20 x 60 polar
// bins, into its frame program. Op by op on the card that was ~15 eager
// launches. Here a grid of (point blocks, lanes) does all of it, a point a
// thread:
//
//   every thread loads its point before anything else; z + 2, r = sqrt(x x +
//     y y), theta = atan2(y, x) in degrees (+360 below 0), the ring ceil(r /
//     80 * 20) and the sector ceil(theta / 360 * 60), each clamped to [1, n]
//     less one; a point that is masked in and within 80 m bids the
//     order-preserving integer image of its height (NaN as +inf) for its bin;
//   each bid goes into the block's 1200 shared bins by a shared atomicMax;
//   each block's non-empty bins merge into the lane's scratch by a global
//     atomicMax; the lane's last block to arrive (its counter) writes the
//     1200 floats, -inf (an empty bin) and every other non-finite value as 0,
//     and sets the scratch and the counter back.
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
// ~40 operations a point; at the main path's 32768 points both are far below
// a launch's latency, so the design spreads a lane over the card (128 blocks
// there) with one point's chain a thread and one barrier before the merge.
// Measured and dropped (PERF.md §6): the warp's bids for one bin
// agreed first (__match_any_sync, __reduce_max_sync; the match cost more than
// the colliding atomics it saved), clusters of 16 blocks merged through
// distributed shared memory, fewer blocks with several points a thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRing = 20;
constexpr int kSector = 60;
constexpr int kBins = kRing * kSector;
static_assert(kBins % 4 == 0, "a block's bins merge four at a time");
constexpr int kThreads = 256;
constexpr float kMaxRadius = 80.0f;
constexpr float kLidarHeight = 2.0f;
// torch.rad2deg's constant, a double rounded to float as torch's product
// with a scalar rounds it
constexpr float kRad2Deg = (float)57.295779513082320876798154814105170332405472466564321549160243861;

struct Args {
  const float* xyz;      // [lanes, N, 3]
  const uint8_t* mask;   // [lanes, N]
  float* out;            // [lanes, 20, 60]
  unsigned* keys;        // [lanes, 1200] the merged bins, key(-inf) between launches
  unsigned* arrived;     // [lanes] the blocks arrived, 0 between launches
  int N;
};

#ifdef LIORF_SCANCONTEXT_PROFILE
// Development only (built with -DLIORF_SCANCONTEXT_PROFILE): clock cycles a
// phase of lane 0's block 0's thread 0, each lap taken after the phase's
// results are used; 8-9 the launch's span by the global timer (ns).
constexpr int kProfSlots = 10;
__device__ long long g_prof[kProfSlots] = {0, 0, 0, 0, 0, 0, 0, 0, 0x7fffffffffffffffLL, 0};
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

struct Point {
  float x, y, z;
  bool in;
};

__device__ __forceinline__ Point load(const Args& a, int lane, int n) {
  Point q{0.0f, 0.0f, 0.0f, false};
  if (n < a.N) {
    const size_t p = (size_t)lane * a.N + n;
    q.x = a.xyz[3 * p];
    q.y = a.xyz[3 * p + 1];
    q.z = a.xyz[3 * p + 2];
    q.in = a.mask[p] != 0;
  }
  return q;
}

// the point's bin (-1: masked out or beyond 80 m) and its height's key
__device__ __forceinline__ int bin_of(const Point& q, unsigned* k) {
  const float r = __fsqrt_rn(__fadd_rn(__fmul_rn(q.x, q.x), __fmul_rn(q.y, q.y)));
  if (!q.in || !(r <= kMaxRadius)) return -1;
  float z = __fadd_rn(q.z, kLidarHeight);
  if (isnan(z)) z = INFINITY;  // a NaN's bin reads 0, as torch's NaN-propagating amax gives
  float theta = __fmul_rn(atan2f(q.y, q.x), kRad2Deg);
  if (theta < 0.0f) theta = __fadd_rn(theta, 360.0f);
  const int ring = (int)clampf(ceilf(__fmul_rn(__fdiv_rn(r, kMaxRadius), (float)kRing)),
                               1.0f, (float)kRing) - 1;
  const int sector = (int)clampf(ceilf(__fmul_rn(__fdiv_rn(theta, 360.0f), (float)kSector)),
                                 1.0f, (float)kSector) - 1;
  *k = key(z);
  return ring * kSector + sector;
}

__global__ void __launch_bounds__(kThreads) descriptor_kernel(Args a) {
  __shared__ __align__(16) unsigned bins[kBins];
  __shared__ bool last;
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  span(8, false);
  Laps laps(blockIdx.x == 0 && lane == 0 && tid == 0);
  const Point q = load(a, lane, blockIdx.x * kThreads + tid);  // before anything else
  const unsigned empty = key(-INFINITY);
  for (int b = tid; b < kBins; b += kThreads) bins[b] = empty;
  __syncthreads();
  laps.lap(0, bins[0]);
  laps.lap(1, q.x + q.y + q.z + q.in);
  unsigned k = 0;
  const int bin = bin_of(q, &k);
  laps.lap(2, bin);
  if (bin >= 0) atomicMax(&bins[bin], k);
  laps.lap(3, 0);
  __syncthreads();
  laps.lap(4, 0);
  // the block's bins into the lane's, four a thread from one 16-byte read
  unsigned* keys = a.keys + (size_t)lane * kBins;
  for (int b = 4 * tid; b < kBins; b += 4 * kThreads) {
    const uint4 v = *reinterpret_cast<const uint4*>(bins + b);
    if (v.x != empty) atomicMax(keys + b, v.x);
    if (v.y != empty) atomicMax(keys + b + 1, v.y);
    if (v.z != empty) atomicMax(keys + b + 2, v.z);
    if (v.w != empty) atomicMax(keys + b + 3, v.w);
  }
  laps.lap(5, 0);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.arrived + lane, 1u) == gridDim.x - 1;
  __syncthreads();
  laps.lap(6, last);
  if (last) {
    // every other block's atomics are done and visible (each fenced before
    // it arrived): read them from L2, write the outputs, set the scratch back
    __threadfence();
    float v = 0.0f;
    for (int b = tid; b < kBins; b += kThreads) {
      v = unkey(__ldcg(keys + b));
      a.out[(size_t)lane * kBins + b] = isfinite(v) ? v : 0.0f;
      keys[b] = empty;
    }
    if (tid == 0) a.arrived[lane] = 0;
    laps.lap(7, v);
  }
  span(9, true);
}

long long g_launches = 0;

}  // namespace

extern "C" {

long long liorf_scancontext_kernel_launches() { return g_launches; }

#ifdef LIORF_SCANCONTEXT_PROFILE
// The last launch's slots (kProfSlots), then every slot reset.
int liorf_scancontext_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfSlots);
  if (err != cudaSuccess) return (int)err;
  long long reset[kProfSlots] = {};
  reset[8] = 0x7fffffffffffffffLL;
  return (int)cudaMemcpyToSymbol(g_prof, reset, sizeof(reset));
}
#endif

// The descriptors [lanes, 20, 60] of xyz [lanes, N, 3] (float) under mask
// [lanes, N] (bool) on `stream` of `device`. `ptrs` holds 5 addresses of
// contiguous device arrays: xyz, mask, out, then the lanes' scratch: keys
// [lanes, 1200] (u32, key(-inf) between launches) and arrival counters
// [lanes] (u32, 0 between launches).
int liorf_scancontext(const long long* ptrs, int N, int lanes, int device, void* stream) {
  if (lanes == 0) return 0;
  if (N < 0 || lanes > 65535 || device < 0) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  const void* const* p = reinterpret_cast<const void* const*>(ptrs);
  a.xyz = (const float*)p[0]; a.mask = (const uint8_t*)p[1]; a.out = (float*)p[2];
  a.keys = (unsigned*)p[3]; a.arrived = (unsigned*)p[4]; a.N = N;
  // a point a thread (N >= 0 points: at least one block writes the lane's bins)
  const long long blocks = max(1LL, ((long long)N + kThreads - 1) / kThreads);
  descriptor_kernel<<<dim3((unsigned)blocks, (unsigned)lanes), kThreads, 0,
                       (cudaStream_t)stream>>>(a);
  const int e = (int)cudaGetLastError();
  if (e == 0) ++g_launches;
  if (current != device) cudaSetDevice(current);
  return e;
}

}  // extern "C"
