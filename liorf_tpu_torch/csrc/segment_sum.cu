// Fixed-order segment sum for NVIDIA Hopper (sm_90a), plain C interface.
//
// Built by ops/segment_sum.py with the flags of core/build.py and loaded
// with ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns cudaGetLastError().
//
// Not a TPU kernel: it takes the place of the card's atomic scatter-add
// (index_add) in the voxel filter's sums and the pose graph's normal
// equations, whose accumulation order changed from run to run. Here every
// output element is summed by ONE thread, in the order of its rows, starting
// from 0.0f: the result is the same on every run, and equal to the CPU's
// sequential index_add over the same rows in the same order.
//
//   out[b, s, c] = sum over p in [lo, hi) of src[b, perm[b, p], c]
//   lo, hi = first p with keys[b, p] >= s, and >= s + 1
//
// keys[b] is sorted (non-decreasing, >= 0); perm (optional) maps a sorted
// position to a row of src (a stable argsort of the unsorted keys, so equal
// keys keep their rows' order). The segment bounds are found by binary
// search of keys, so no offsets array is built; rows keyed >= s are never
// read (the voxel filter's dump slot: one long run a single thread would
// otherwise walk).
//
// What bounds it: the bytes (src read once, keys / perm once per bound
// search and row, out written once); the rows a thread walks are
// contiguous in src for the voxel filter (perm null), gathered through perm
// for the pose graph. One thread per (segment, column): neighbouring threads
// read neighbouring columns of one row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ keys, int64_t m,
                                               int64_t v) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void segment_sum_kernel(const float* __restrict__ src,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ keys,
                                   float* __restrict__ out,
                                   int64_t m, int c, int64_t s) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s * c) return;
  const int64_t b = blockIdx.y;
  const int64_t seg = t / c;
  const int col = (int)(t - seg * c);
  const int64_t* kb = keys + b * m;
  const int64_t* pb = perm == nullptr ? nullptr : perm + b * m;
  const float* sb = src + b * m * c;
  const int64_t lo = lower_bound(kb, m, seg);
  const int64_t hi = lower_bound(kb, m, seg + 1);
  float acc = 0.0f;
  for (int64_t p = lo; p < hi; ++p) {
    const int64_t row = pb == nullptr ? p : pb[p];
    acc = __fadd_rn(acc, sb[row * c + col]);
  }
  out[b * s * c + t] = acc;
}

}  // namespace

extern "C" {

// src [lanes, m, c] f32, perm [lanes, m] i64 or null, keys [lanes, m] i64
// sorted per lane -> out [lanes, s, c] f32. All contiguous device pointers;
// one launch serves every lane.
int liorf_segment_sum(const void* src, const void* perm, const void* keys, void* out,
                      int lanes, long long m, int c, long long s, void* stream) {
  const int threads = 256;
  const long long work = s * (long long)c;
  if (work == 0 || lanes == 0) return 0;
  const dim3 grid((unsigned)((work + threads - 1) / threads), (unsigned)lanes);
  segment_sum_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int64_t*)perm, (const int64_t*)keys, (float*)out,
      (int64_t)m, c, (int64_t)s);
  return (int)cudaGetLastError();
}

}  // extern "C"
