// Fixed-order segment sum for NVIDIA Hopper (sm_90a), plain C interface.
//
// Built by ops/segment_sum.py with the flags of core/build.py and loaded
// with ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns cudaGetLastError().
//
// Not a TPU kernel: it takes the place of the card's atomic scatter-add
// (index_add) in the distributed pose-graph solver's matvec
// (dist/shard_map_solver.py), whose accumulation order changed from run to
// run (the voxel filter's sums moved into csrc/voxel_filter.cu, the
// single-device solve's into csrc/linearize.cu and csrc/pcg.cu). Here every
// output element is summed by ONE thread, in the order of its rows, starting
// from 0.0f: the result is the same on every run, and equal to the CPU's
// sequential index_add over the same rows in the same order.
//
//   out[b, s, c] = sum over p in [offsets[b, s], offsets[b, s + 1]) of
//                  src[b, perm[b, p], c]
//
// keys[b] is sorted (non-decreasing, >= 0) and offsets[b, s] is the first
// position whose key is >= s (one searchsorted, which SegmentPlan makes once
// a solve, next to its sort); perm (optional) maps a sorted position to a
// row of src (a stable argsort of the unsorted keys, so equal keys keep their
// rows' order). Rows keyed >= S lie past offsets[b, S] and are never read.
//
// What bounds it: the bytes (src read once, perm once per row, out written
// once); the rows a thread walks are contiguous in src without perm,
// gathered through perm for the distributed solver's matvec. One thread per
// (segment, column): neighbouring threads read neighbouring columns of one
// row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_sum_kernel(const float* __restrict__ src,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ offsets,
                                   float* __restrict__ out,
                                   int64_t m, int c, int64_t s) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s * c) return;
  const int64_t b = blockIdx.y;
  const int64_t seg = t / c;
  const int col = (int)(t - seg * c);
  const int64_t* pb = perm == nullptr ? nullptr : perm + b * m;
  const float* sb = src + b * m * c;
  const int64_t lo = offsets[b * (s + 1) + seg];
  const int64_t hi = offsets[b * (s + 1) + seg + 1];
  float acc = 0.0f;
  for (int64_t p = lo; p < hi; ++p) {
    const int64_t row = pb == nullptr ? p : pb[p];
    acc = __fadd_rn(acc, sb[row * c + col]);
  }
  out[b * s * c + t] = acc;
}

}  // namespace

extern "C" {

// src [lanes, m, c] f32, perm [lanes, m] i64 or null, offsets [lanes, s + 1]
// i64 -> out [lanes, s, c] f32. All contiguous device pointers; one launch
// serves every lane.
int liorf_segment_sum(const void* src, const void* perm, const void* offsets, void* out,
                      int lanes, long long m, int c, long long s, void* stream) {
  const int threads = 256;
  const long long work = s * (long long)c;
  if (work == 0 || lanes == 0) return 0;
  const dim3 grid((unsigned)((work + threads - 1) / threads), (unsigned)lanes);
  segment_sum_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int64_t*)perm, (const int64_t*)offsets, (float*)out,
      (int64_t)m, c, (int64_t)s);
  return (int)cudaGetLastError();
}

}  // extern "C"
