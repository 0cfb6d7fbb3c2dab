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
// lanes) does all of it. In each block:
//
//   every thread first issues the loads of its point (xyz, the time, the
//     mask): they do not wait for the timeline;
//   warp 0 builds the lane's timeline in its registers (a window of up to 64
//     samples, every path's; a longer one the whole block does, in shared
//     memory, a barrier a step): lane t holds samples t and t + 32; dt[i] =
//     t[i] - t[i-1] where sample i and i-1 are valid (else 0), the increments
//     gyr dt (0 where invalid), their inclusive prefix by Hillis-Steele
//     doubling in double (step d adds x[i - d] to x[i] for i >= d: for
//     d < 32 the term comes from lane (t - d) mod 32 by a shuffle, its slot j
//     where t >= d, else its slot j - 1; for d = 32 from the lane's own slot
//     0), rounded to float once; the count of valid samples by ballots; the
//     times, +inf where invalid. The prefix stops where the window's last
//     valid sample is covered: interp_rotation reads no angle past it (its
//     index is at most count - 1), and a later step adds nothing below it,
//     so the angles it reads are the plain version's;
//   one barrier publishes the timeline;
//   then each point: t = scan_start + rel_t, the upper bound of t in the
//     times (torch.searchsorted(right=True)'s binary search), every clamp of
//     ops/deskew.py::interp_rotation, the lerp, R = Rz Ry Rx of the angles
//     (gn_common.cuh::rot_f32: sin and cos in double, rounded to float), R0
//     the same at the scan's start, and out = R0^T (R p); a masked-out point
//     is copied.
//
// A float64 sin or cos is a call that the compiler does not overlap with the
// next (its slow path's branch), ~400 cycles each on the card: six a point
// and six for R0 were most of a block's chain. So the trigonometry is spread
// over lanes: up to kSplitPoints points a launch, lanes 9 k + p of a warp
// take angle k's cos and sin of the warp's point p (k < 3, p < 9) and lanes
// 27 + k angle k of R0, and shuffles bring each point's six and R0's six to
// lane p (a point's chain: two evaluations); past it (the card no longer
// holds every warp at once, and the float64 pipe, not the chain, is the
// limit), a lane takes a point's three angles, and R0's three come from
// three lanes of warp 0 before the barrier.
//
// The order contract (ops/deskew.py::deskew_plain spells it in torch ops; on
// the card the two agree bit for bit): every product, sum and quotient is
// rounded on its own (gn_common.cuh's mul / add / sub / dvd: nvcc would
// contract to FMAs); the prefix's every sum is the plain version's x[i] +
// x[i - d] at the same step; a 3-term product sum is (a0 b0 + a1 b1) + a2 b2;
// the clamp of the ratio keeps a NaN, as torch.clamp does. No atomics but a
// long window's count and end (integers).
//
// What bounds it: the points' bytes, ~29 a point (xyz in and out, the time,
// the mask), and behind them the six double-precision sin / cos of a point;
// at the main path's 32768 points both are far below a launch's latency, so
// the design shortens each block's dependent chain: one barrier, the point's
// loads under the timeline's, the prefix in one warp's registers (at K = 64
// two slots a lane and six rounds of shuffles), the trigonometry three lanes
// wide.

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
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 2048;  // ops/deskew.py::MAX_K
// Points a launch (lanes x N) up to which three lanes take a point (the
// main path's 32768: 456 blocks, every one resident at once).
constexpr long long kSplitPoints = 65536;

// Shared bytes of a window of K samples past 64: the prefix's two buffers
// (three doubles a sample each), the times and the angles (float).
__host__ __device__ constexpr size_t shared_bytes(int K) {
  return (size_t)K * (6 * sizeof(double) + 4 * sizeof(float));
}

// The inputs' lanes lie any number of elements apart (`*_lane`: slices of a
// packed frame buffer, or 0 where a vmap broadcast one lane), each lane's
// block contiguous; the output is contiguous.
struct Args {
  const float* xyz;        // [lanes, N, 3]
  const float* rel_t;      // [lanes, N]
  const uint8_t* mask;     // [lanes, N]
  const float* start;      // [lanes]
  const float* times;      // [lanes, K]
  const float* gyr;        // [lanes, K, 3]
  const uint8_t* imask;    // [lanes, K]
  float* out;              // [lanes, N, 3]
  long long xyz_lane, rel_t_lane, mask_lane, start_lane, times_lane, gyr_lane, imask_lane;
  int N, K;
};

#ifdef LIORF_DESKEW_PROFILE
// Development only (built with -DLIORF_DESKEW_PROFILE): clock cycles a phase
// of the last lane's block 0, its thread 0 (slots 0-4 and 6: the
// timeline's lane 0, R0 where warp 0 takes it, and a point's) and its last
// warp's lane 0 (5, 7: a point's alone), each lap taken after the phase's
// results are used; by the global timer (ns), 8-9 the first block's start
// and the last block's end, 10-11 the last block's start and the first
// block's end.
constexpr int kProfSlots = 12;
constexpr long long kNever = 0x7fffffffffffffffLL;
__device__ long long g_prof[kProfSlots] = {0, 0, 0, 0, 0, 0, 0, 0, kNever, 0, 0, kNever};
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
__device__ __forceinline__ void span(bool end) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long now = (unsigned long long)gtimer();
    atomicMin((unsigned long long*)&g_prof[end ? 11 : 8], now);
    atomicMax((unsigned long long*)&g_prof[end ? 9 : 10], now);
  }
}
#else
struct Laps {
  __device__ explicit Laps(bool) {}
  template <class T>
  __device__ void lap(int, T) {}
};
__device__ __forceinline__ void span(bool) {}
#endif

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

// cos and sin of one angle, taken in double and rounded to float
// (gn_common.cuh::trig's)
__device__ __forceinline__ void trig1(float a, float& c, float& s) {
  c = (float)cos((double)a);
  s = (float)sin((double)a);
}

// A window of up to 64 samples on warp 0, in its registers: the times of
// the K samples, the angles of the first Kc (through the last valid sample,
// at least one), the count. Lane t holds samples t and t + 32.
__device__ __forceinline__ void timeline_warp(const Args& g, int lane, float* times, float* ang,
                                              int& count, Laps& laps) {
  const unsigned all = 0xffffffffu;
  const int t = threadIdx.x;
  const int K = g.K;
  const float* t_in = g.times + lane * g.times_lane;
  const float* w_in = g.gyr + lane * g.gyr_lane;
  const uint8_t* v_in = g.imask + lane * g.imask_lane;
  // both samples' loads before either is used
  bool valid[2], prev[2];
  float ti[2], tp[2], w[2][3];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + 32 * j;
    const bool at = i < K, after = at && i > 0;
    valid[j] = at && v_in[i] != 0;
    prev[j] = after && v_in[i - 1] != 0;
    ti[j] = at ? t_in[i] : 0.0f;
    tp[j] = after ? t_in[i - 1] : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) w[j][k] = at ? w_in[3 * i + k] : 0.0f;
  }
  double x[2][3];
  int c = 0, last = -1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + 32 * j;
    const float dt = valid[j] && prev[j] ? sub(ti[j], tp[j]) : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) x[j][k] = valid[j] ? (double)mul(w[j][k], dt) : 0.0;
    if (i < K) times[i] = valid[j] ? ti[j] : INFINITY;
    const unsigned b = __ballot_sync(all, valid[j]);
    c += __popc(b);
    if (b) last = 32 * j + 31 - __clz(b);
  }
  const int Kc = max(last + 1, 1);
  laps.lap(1, c);
  // steps d < 32: lane (t - d) mod 32's sample t + 32 j - d: its slot j where
  // t >= d, else its slot j - 1 (none for slot 0, where t + 32 j < d); every
  // term the step's old value
#pragma unroll
  for (int e = 0; e < 5; ++e) {
    const int d = 1 << e;
    if (d >= Kc) break;
    const int src = (t - d) & 31;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double lo = __shfl_sync(all, x[0][k], src);
      const double hi = __shfl_sync(all, x[1][k], src);
      if (t >= d) {
        x[0][k] = __dadd_rn(x[0][k], lo);
        x[1][k] = __dadd_rn(x[1][k], hi);
      } else {
        x[1][k] = __dadd_rn(x[1][k], lo);
      }
    }
  }
  // step d = 32: the lane's own slot 0
  if (32 < Kc)
#pragma unroll
    for (int k = 0; k < 3; ++k) x[1][k] = __dadd_rn(x[1][k], x[0][k]);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + 32 * j;
    if (i < Kc)
#pragma unroll
      for (int k = 0; k < 3; ++k) ang[3 * i + k] = (float)x[j][k];
  }
  if (t == 0) count = c;
  laps.lap(2, c);
}

// A longer window on the whole block: the same, the prefix's steps over the
// block's threads in shared memory (two buffers of 3 Kc doubles), a barrier
// a step. Ends at a barrier.
__device__ __forceinline__ void timeline_block(const Args& g, int lane, double* x0, float* times,
                                               float* ang, int& count, int& cut, Laps& laps) {
  const int tid = threadIdx.x;
  const int K = g.K;
  const float* t_in = g.times + lane * g.times_lane;
  const float* w_in = g.gyr + lane * g.gyr_lane;
  const uint8_t* v_in = g.imask + lane * g.imask_lane;
  if (tid == 0) count = cut = 0;
  __syncthreads();
  int mine = 0, end = 0;
  for (int i = tid; i < K; i += kThreads) {
    const bool valid = v_in[i] != 0;
    const bool both = valid && i > 0 && v_in[i - 1] != 0;
    const float ti = t_in[i];
    const float dt = both ? sub(ti, t_in[i - 1]) : 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) x0[3 * i + k] = valid ? (double)mul(w_in[3 * i + k], dt) : 0.0;
    times[i] = valid ? ti : INFINITY;
    mine += valid;
    if (valid) end = i + 1;
  }
  if (mine) {
    atomicAdd(&count, mine);
    atomicMax(&cut, end);
  }
  __syncthreads();
  laps.lap(1, mine);
  const int Kc = max(cut, 1);
  double* src = x0;
  double* dst = x0 + 3 * K;
  for (int d = 1; d < Kc; d *= 2) {
    for (int j = tid; j < 3 * Kc; j += kThreads)
      dst[j] = j >= 3 * d ? __dadd_rn(src[j], src[j - 3 * d]) : src[j];
    double* tmp = src;
    src = dst;
    dst = tmp;
    __syncthreads();
  }
  for (int j = tid; j < 3 * Kc; j += kThreads) ang[j] = (float)src[j];
  __syncthreads();
  laps.lap(2, Kc);
}

// R0's cosines and sines on warp 0 (lane k < 3 takes angle k) from the
// published timeline
__device__ __forceinline__ void r0_trig(const float* times, const float* ang, int K, int count,
                                        float start, float (&trig0)[2][3], Laps& laps) {
  const int t = threadIdx.x;
  float a0[3], cm, sm;
  interp(times, ang, K, count, start, a0);
  trig1(t == 0 ? a0[0] : (t == 1 ? a0[1] : a0[2]), cm, sm);
  if (t < 3) {
    trig0[0][t] = cm;
    trig0[1][t] = sm;
  }
  laps.lap(3, cm + sm);
}

// R0^T (R p) of a point from its angles' and R0's cosines and sines
__device__ __forceinline__ void deskew_point(const float (&c)[3], const float (&s)[3],
                                             const float (&c0)[3], const float (&s0)[3],
                                             float px, float py, float pz, float* o) {
  float R[3][3], R0[3][3], r[3];
  gn::rot_from_trig(c, s, R);
  gn::rot_from_trig(c0, s0, R0);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = dot3(R[i][0], R[i][1], R[i][2], px, py, pz);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = dot3(R0[0][k], R0[1][k], R0[2][k], r[0], r[1], r[2]);
}

template <bool kRegs, bool kSplit>
__global__ void __launch_bounds__(kThreads) deskew_kernel(Args g) {
  extern __shared__ double smem[];
  double* x = smem;  // past 64 samples: the prefix's two buffers, 3 K doubles each
  float* times = (float*)(smem + (kRegs ? 0 : 6 * g.K));  // [K]
  float* ang = times + g.K;                                // [K][3]
  __shared__ int count, cut;
  __shared__ float trig0[2][3];  // R0's cosines and sines (without kSplit)

  const unsigned all = 0xffffffffu;
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const int l = tid & 31;
  span(false);
  const bool first = blockIdx.x == 0 && lane == (int)gridDim.y - 1;
  Laps laps(first && tid == 0), lapsp(first && tid == kThreads - 32);
  // the warp's points: split, lane 9 k + p takes angle k of point p and
  // lanes 27 + k angle k of R0; else lane l takes point l
  constexpr int kPerWarp = kSplit ? 9 : 32;
  const int p = kSplit ? l % 9 : l;
  const int k = kSplit ? (l < 27 ? l / 9 : min(l - 27, 2)) : 0;
  const int n = (blockIdx.x * kWarps + (tid >> 5)) * kPerWarp + p;
  const bool has = (!kSplit || l < 27) && n < g.N;
  const bool owner = has && (!kSplit || l < 9);  // the lane that writes the point
  const long long at = has ? n : 0;
  // the loads first: they do not wait for the timeline
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  bool in = false;
  if (owner) {
    const float* q = g.xyz + lane * g.xyz_lane + 3 * at;
    px = q[0];
    py = q[1];
    pz = q[2];
    in = g.mask[lane * g.mask_lane + at] != 0;
  }
  const float rt = has ? g.rel_t[lane * g.rel_t_lane + at] : 0.0f;
  const float start = g.start[lane * g.start_lane];
  laps.lap(0, start + rt);
  // the timeline: warp 0 alone up to 64 samples, else the whole block;
  // then (without kSplit) R0 on warp 0
  if constexpr (kRegs) {
    if (tid < 32) timeline_warp(g, lane, times, ang, count, laps);
  } else {
    timeline_block(g, lane, x, times, ang, count, cut, laps);
  }
  if constexpr (!kSplit) {
    if (tid < 32) {
      __syncwarp();
      r0_trig(times, ang, g.K, count, start, trig0, laps);
    }
  }
  __syncthreads();
  laps.lap(4, count);
  lapsp.lap(5, count + rt);

  const int K = g.K;
  float a[3], c[3], s[3], c0[3], s0[3];
  if constexpr (kSplit) {
    // one angle a lane: the point's at its time, R0's at the start
    interp(times, ang, K, count, has ? add(start, rt) : start, a);
    float cm, sm;
    trig1(k == 0 ? a[0] : (k == 1 ? a[1] : a[2]), cm, sm);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c[j] = __shfl_sync(all, cm, 9 * j + p);
      s[j] = __shfl_sync(all, sm, 9 * j + p);
      c0[j] = __shfl_sync(all, cm, 27 + j);
      s0[j] = __shfl_sync(all, sm, 27 + j);
    }
  } else {
    // the point's three angles; R0's from warp 0
    interp(times, ang, K, count, add(start, rt), a);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      trig1(a[j], c[j], s[j]);
      c0[j] = trig0[0][j];
      s0[j] = trig0[1][j];
    }
  }
  float last = 0.0f;
  if (owner) {
    float* o = g.out + 3 * ((long long)lane * g.N + at);
    if (in) {
      deskew_point(c, s, c0, s0, px, py, pz, o);
      last = o[0];
    } else {
      o[0] = px;
      o[1] = py;
      o[2] = pz;
    }
  }
  laps.lap(6, last);
  lapsp.lap(7, last);
  span(true);
}

long long g_launches = 0;

bool g_opted_in[256] = {};  // a device's opt-in past 48 KB of shared memory

// the shared-memory kernels opted in to the longest window's shared memory
cudaError_t opt_in() {
  const int bytes = (int)shared_bytes(kMaxK);
  cudaError_t err = cudaFuncSetAttribute(deskew_kernel<false, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(deskew_kernel<false, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err;
}

template <bool kRegs, bool kSplit>
int launch(const Args& g, int lanes, cudaStream_t stream) {
  const int per_block = kWarps * (kSplit ? 9 : 32);
  const dim3 grid((unsigned)((g.N + per_block - 1) / per_block), (unsigned)lanes);
  const size_t bytes = kRegs ? (size_t)g.K * 4 * sizeof(float) : shared_bytes(g.K);
  deskew_kernel<kRegs, kSplit><<<grid, kThreads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

long long liorf_deskew_kernel_launches() { return g_launches; }

#ifdef LIORF_DESKEW_PROFILE
// The last launch's slots (kProfSlots), then every slot reset.
int liorf_deskew_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfSlots);
  if (err != cudaSuccess) return (int)err;
  long long reset[kProfSlots] = {};
  reset[8] = reset[11] = kNever;
  return (int)cudaMemcpyToSymbol(g_prof, reset, sizeof(reset));
}
#endif

// The deskewed points of each of `lanes` lanes on `stream` of `device`.
// `ptrs` holds 8 addresses of device arrays with a leading lane axis: xyz
// [lanes, N, 3], rel_t [lanes, N] (float), mask [lanes, N] (bool), start
// [lanes], times [lanes, K], gyr [lanes, K, 3], imask [lanes, K] (bool), each
// lane's block contiguous; out [lanes, N, 3], contiguous; then the seven
// inputs' lane strides in elements. Past 48 KB of shared memory (windows of more
// than 768 samples) the kernels are opted in once a device.
int liorf_deskew(const long long* ptrs, int N, int K, int lanes, int device, void* stream) {
  if (lanes == 0 || N == 0) return 0;
  if (K < 1 || K > kMaxK || lanes > 65535 || device < 0 || device >= 256)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args g;
  const void* const* p = reinterpret_cast<const void* const*>(ptrs);
  g.xyz = (const float*)p[0]; g.rel_t = (const float*)p[1]; g.mask = (const uint8_t*)p[2];
  g.start = (const float*)p[3]; g.times = (const float*)p[4]; g.gyr = (const float*)p[5];
  g.imask = (const uint8_t*)p[6]; g.out = (float*)p[7]; g.N = N; g.K = K;
  g.xyz_lane = ptrs[8]; g.rel_t_lane = ptrs[9]; g.mask_lane = ptrs[10]; g.start_lane = ptrs[11];
  g.times_lane = ptrs[12]; g.gyr_lane = ptrs[13]; g.imask_lane = ptrs[14];
  if (shared_bytes(K) > 48 * 1024 && !g_opted_in[device]) {
    err = opt_in();
    g_opted_in[device] = err == cudaSuccess;
  }
  int e = (int)err;
  if (!e) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool split = (long long)N * lanes <= kSplitPoints;
    if (K <= 64) e = split ? launch<true, true>(g, lanes, s) : launch<true, false>(g, lanes, s);
    else e = split ? launch<false, true>(g, lanes, s) : launch<false, false>(g, lanes, s);
  }
  if (e == 0) ++g_launches;
  if (current != device) cudaSetDevice(current);
  return e;
}

}  // extern "C"
