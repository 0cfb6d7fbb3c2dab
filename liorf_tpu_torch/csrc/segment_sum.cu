// Fixed-order segment sum and dot product for NVIDIA Hopper (sm_90a), plain
// C interface.
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

// Fixed-order dot product, one block a lane: the products a[i] * c[i] are
// summed in chunks of 32 elements (sequentially, from 0.0f), and the chunk
// sums by a tree of ADJACENT pairs over the chunks padded with zeros to a
// power of two, `pow2`. Neither the chunks nor the tree depend on n beyond
// the last element: zeros after it (the unused slots of a ring) change no
// bit of the result, so a solve over a grown ring gives the bits of the large
// ring's. (torch.sum picks its reduction's shape by n.)
//
// The chunk sums are held in dynamic shared memory, `width` = min(pow2,
// kMaxWidth) floats at a time: the tree's lower levels over each aligned
// run of `width` chunks are that run's own tree, so the runs are reduced one
// after another and their sums (`pow2 / width` of them, in `scratch`, global
// memory, when there is more than one) by the upper levels of the same tree.
// Any n gives the plain version's order of additions.
constexpr int kMaxWidth = 8192;

__device__ __forceinline__ void pair_tree(float* v, int64_t len) {
  for (int64_t w = 1; w < len; w <<= 1) {
    for (int64_t k = (int64_t)threadIdx.x * 2 * w; k < len; k += (int64_t)blockDim.x * 2 * w)
      v[k] = __fadd_rn(v[k], v[k + w]);
    __syncthreads();
  }
}

__global__ void fixed_dot_kernel(const float* __restrict__ a, const float* __restrict__ c,
                                 float* __restrict__ out, float* __restrict__ scratch,
                                 int64_t n, int64_t pow2) {
  extern __shared__ float part[];
  const int64_t b = blockIdx.x;
  const float* ab = a + b * n;
  const float* cb = c + b * n;
  const int64_t chunks = (n + 31) / 32;
  const int64_t width = pow2 < kMaxWidth ? pow2 : kMaxWidth;
  const int64_t runs = pow2 / width;
  float* sums = scratch == nullptr ? nullptr : scratch + b * runs;
  for (int64_t run = 0; run < runs; ++run) {
    for (int64_t k = threadIdx.x; k < width; k += blockDim.x) {
      const int64_t chunk = run * width + k;
      float acc = 0.0f;
      if (chunk < chunks) {
        const int64_t lo = chunk * 32;
        const int64_t hi = lo + 32 < n ? lo + 32 : n;
        for (int64_t i = lo; i < hi; ++i) acc = __fadd_rn(acc, __fmul_rn(ab[i], cb[i]));
      }
      part[k] = acc;
    }
    __syncthreads();
    pair_tree(part, width);
    if (threadIdx.x == 0) {
      if (runs == 1) out[b] = part[0]; else sums[run] = part[0];
    }
    __syncthreads();  // part is refilled by the next run
  }
  if (runs == 1) return;
  pair_tree(sums, runs);  // __syncthreads makes the block's global writes visible to it
  if (threadIdx.x == 0) out[b] = sums[0];
}

}  // namespace

extern "C" {

// Chunk sums fixed_dot holds in shared memory at a time.
int liorf_fixed_dot_max_width() { return kMaxWidth; }

// a, c [lanes, n] f32 -> out [lanes] f32: the fixed-order dot product of each
// lane; pow2 = the smallest power of two >= ceil(n / 32); scratch [lanes,
// pow2 / max_width] f32 when pow2 > max_width, else null.
int liorf_fixed_dot(const void* a, const void* c, void* out, void* scratch, int lanes,
                    long long n, long long pow2, void* stream) {
  if (lanes == 0) return 0;
  const long long width = pow2 < kMaxWidth ? pow2 : kMaxWidth;
  fixed_dot_kernel<<<lanes, 256, width * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)a, (const float*)c, (float*)out, (float*)scratch, (int64_t)n,
      (int64_t)pow2);
  return (int)cudaGetLastError();
}

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
