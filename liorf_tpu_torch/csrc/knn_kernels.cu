// Hand-written k-NN kernels for NVIDIA Hopper (sm_90a), plain C interface.
//
// Built by ops/knn_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC
// and loaded with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Both kernels compute squared distances by direct differences,
//   d2 = ((dx*dx + dy*dy) + dz*dz),
// each operation rounded on its own (__fmul_rn / __fadd_rn keep the compiler
// from contracting them into FMAs), so the result is bit-identical to the
// plain PyTorch versions in ops/knn_cuda.py and index comparisons against
// them are exact. The TPU kernel of K2 used |q|^2 + |t|^2 - 2 q.t because
// that form rides its matrix unit; a depth-3 contraction is too thin for
// tensor cores here, direct differences cost the same on the CUDA cores and
// do not cancel.
//
// Tie-break everywhere: the lower candidate position / target index wins.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
// d2 at or above this (inf included: 1e30^2 overflows f32) means "missing".
constexpr float kMissing = 0.5e30f;
constexpr int kNoPos = 0x7fffffff;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float x, float y, float z) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  const float dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Sorted insertion into a register-resident ascending list. The caller has
// checked that (d, i) beats the last entry. Candidates arrive in increasing
// index order, so the strict '<' keeps the lower index ahead on equal d.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int i) {
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s] < bd[s - 1]) {
      const float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
      const int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
    }
  }
}

// Same, ordered by (d, i): used where entries do not arrive in index order.
template <int K>
__device__ __forceinline__ void insert_sorted_lex(float (&bd)[K], int (&bi)[K],
                                                  float d, int i) {
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (lex_less(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      const float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
      const int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
    }
  }
}

// ---------------------------------------------------------------------------
// K1: top-k over per-query candidate lists.
//
// Replaces liorf_tpu/ops/knn_pallas.py: _cand_kernel / topk_candidates_pallas.
// Memory-bound: streams the N*C*12 bytes of candidate coordinates once, at
// ~8 flop per 12 bytes, and reads cand_idx for the k winners of a row only.
// One warp owns one query; lanes stride over the C candidates of the
// contiguous row, each lane keeps a private sorted top-k in registers, then
// k rounds of a warp arg-min over (d2, position) with __shfl_xor_sync pick
// the row's winners; the winning lane pops its head.
// Nothing but the k results goes back to device memory.
// ---------------------------------------------------------------------------
constexpr int kCandWarps = 8;  // queries per block

template <int K>
__global__ void __launch_bounds__(kCandWarps * 32)
topk_candidates_kernel(const float* __restrict__ queries,
                       const float* __restrict__ cand_xyz,
                       const int* __restrict__ cand_idx,
                       float* __restrict__ out_d, int* __restrict__ out_i,
                       int n, int c) {
  const int row = blockIdx.x * kCandWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // the whole warp leaves together

  const float qx = queries[3 * (size_t)row + 0];
  const float qy = queries[3 * (size_t)row + 1];
  const float qz = queries[3 * (size_t)row + 2];
  const float* __restrict__ cand = cand_xyz + (size_t)row * c * 3;

  float bd[K];
  int bp[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { bd[s] = CUDART_INF_F; bp[s] = kNoPos; }

  for (int p = lane; p < c; p += 32) {
    const float d = sq_dist(qx, qy, qz, cand[3 * p], cand[3 * p + 1],
                            cand[3 * p + 2]);
    if (d < kMissing && d < bd[K - 1]) insert_sorted<K>(bd, bp, d, p);
  }

#pragma unroll
  for (int r = 0; r < K; ++r) {
    float d = bd[0];
    int p = bp[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int op = __shfl_xor_sync(0xffffffffu, p, off);
      if (lex_less(od, op, d, p)) { d = od; p = op; }
    }
    // (d, p) is now the same on every lane; position p belongs to lane p%32
    if (p != kNoPos && lane == (p & 31)) {
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) { bd[s] = bd[s + 1]; bp[s] = bp[s + 1]; }
      bd[K - 1] = CUDART_INF_F;
      bp[K - 1] = kNoPos;
    }
    if (lane == 0) {
      const bool missing = (p == kNoPos);
      out_d[(size_t)row * K + r] = missing ? CUDART_INF_F : d;
      out_i[(size_t)row * K + r] = missing ? 0 : cand_idx[(size_t)row * c + p];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: streaming exact k-NN of N queries against M masked targets.
//
// Replaces liorf_tpu/ops/knn_pallas.py: _kernel / knn_bruteforce_pallas.
// Compute-bound on the CUDA cores: N*M pairs x 8 flop, against only
// (N+M)*13 bytes in and N*k*8 out. A block owns 32 queries; its 8 warps each
// walk one eighth of every target chunk (lane = query, warp = slice, so a
// warp reads one shared-memory address at a time: a broadcast). Chunks of
// 1024 targets + validity are staged through shared memory as float4; each
// thread keeps its running top-k in registers; the 8 slices of a query are
// merged through shared memory at the end, ordered by (d2, index). The ragged
// edges of N and M are masked here, the inputs are not padded.
// ---------------------------------------------------------------------------
constexpr int kBfQueries = 32;
constexpr int kBfSlices = 8;
constexpr int kBfChunk = 1024;

template <int K>
__global__ void __launch_bounds__(kBfQueries * kBfSlices)
knn_bruteforce_kernel(const float* __restrict__ map_xyz,
                      const uint8_t* __restrict__ map_mask,
                      const float* __restrict__ queries,
                      const uint8_t* __restrict__ query_mask,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int n, int m) {
  __shared__ float4 tile[kBfChunk];
  __shared__ float merge_d[kBfSlices][K][kBfQueries];
  __shared__ int merge_i[kBfSlices][K][kBfQueries];

  const int lane = threadIdx.x;   // query within the block
  const int slice = threadIdx.y;  // share of every chunk
  const int tid = slice * kBfQueries + lane;
  const int row = blockIdx.x * kBfQueries + lane;
  const bool live = row < n;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = queries[3 * (size_t)row + 0];
    qy = queries[3 * (size_t)row + 1];
    qz = queries[3 * (size_t)row + 2];
  }

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { bd[s] = CUDART_INF_F; bi[s] = 0; }

  for (int base = 0; base < m; base += kBfChunk) {
    __syncthreads();  // the previous chunk has been consumed
    for (int j = tid; j < kBfChunk; j += kBfQueries * kBfSlices) {
      const int g = base + j;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < m) {
        t.x = map_xyz[3 * (size_t)g + 0];
        t.y = map_xyz[3 * (size_t)g + 1];
        t.z = map_xyz[3 * (size_t)g + 2];
        t.w = map_mask[g] ? 1.f : 0.f;
      }
      tile[j] = t;
    }
    __syncthreads();
    const int lim = min(kBfChunk, m - base);
    for (int j = slice; j < lim; j += kBfSlices) {
      const float4 t = tile[j];
      const float d = sq_dist(qx, qy, qz, t.x, t.y, t.z);
      if (t.w != 0.f && d < bd[K - 1]) insert_sorted<K>(bd, bi, d, base + j);
    }
  }

#pragma unroll
  for (int s = 0; s < K; ++s) {
    merge_d[slice][s][lane] = bd[s];
    merge_i[slice][s][lane] = bi[s];
  }
  __syncthreads();
  if (slice != 0 || !live) return;

  for (int sl = 1; sl < kBfSlices; ++sl) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float d = merge_d[sl][s][lane];
      const int i = merge_i[sl][s][lane];
      if (d < kMissing && lex_less(d, i, bd[K - 1], bi[K - 1]))
        insert_sorted_lex<K>(bd, bi, d, i);
    }
  }
  const bool q_ok = query_mask[row] != 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool missing = !q_ok || !(bd[s] < kMissing);
    out_d[(size_t)row * K + s] = missing ? CUDART_INF_F : bd[s];
    out_i[(size_t)row * K + s] = missing ? 0 : bi[s];
  }
}

template <int K>
int launch_topk(const float* q, const float* cx, const int* ci, float* od,
                int* oi, int n, int c, cudaStream_t stream) {
  const int blocks = (n + kCandWarps - 1) / kCandWarps;
  topk_candidates_kernel<K><<<blocks, kCandWarps * 32, 0, stream>>>(
      q, cx, ci, od, oi, n, c);
  return (int)cudaGetLastError();
}

template <int K>
int launch_bf(const float* mx, const uint8_t* mm, const float* q,
              const uint8_t* qm, float* od, int* oi, int n, int m,
              cudaStream_t stream) {
  const int blocks = (n + kBfQueries - 1) / kBfQueries;
  knn_bruteforce_kernel<K><<<blocks, dim3(kBfQueries, kBfSlices), 0, stream>>>(
      mx, mm, q, qm, od, oi, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

#define LIORF_DISPATCH_K(k, CALL)                                   \
  switch (k) {                                                      \
    case 1: return CALL(1);                                         \
    case 2: return CALL(2);                                         \
    case 3: return CALL(3);                                         \
    case 4: return CALL(4);                                         \
    case 5: return CALL(5);                                         \
    case 6: return CALL(6);                                         \
    case 7: return CALL(7);                                         \
    case 8: return CALL(8);                                         \
    default: return (int)cudaErrorInvalidValue;                     \
  }

extern "C" {

// Largest k either kernel takes.
int liorf_knn_max_k() { return kMaxK; }

// queries [n,3] f32, cand_xyz [n,c,3] f32, cand_idx [n,c] i32 ->
// out_d [n,k] f32, out_i [n,k] i32. All contiguous device pointers.
int liorf_topk_candidates(const void* queries, const void* cand_xyz,
                          const void* cand_idx, void* out_d, void* out_i,
                          int n, int c, int k, void* stream) {
#define CALL(KK)                                                           \
  launch_topk<KK>((const float*)queries, (const float*)cand_xyz,           \
                  (const int*)cand_idx, (float*)out_d, (int*)out_i, n, c,  \
                  (cudaStream_t)stream)
  LIORF_DISPATCH_K(k, CALL)
#undef CALL
}

// map_xyz [m,3] f32, map_mask [m] u8, queries [n,3] f32, query_mask [n] u8 ->
// out_d [n,k] f32, out_i [n,k] i32. All contiguous device pointers.
int liorf_knn_bruteforce(const void* map_xyz, const void* map_mask,
                         const void* queries, const void* query_mask,
                         void* out_d, void* out_i, int n, int m, int k,
                         void* stream) {
#define CALL(KK)                                                            \
  launch_bf<KK>((const float*)map_xyz, (const uint8_t*)map_mask,            \
                (const float*)queries, (const uint8_t*)query_mask,          \
                (float*)out_d, (int*)out_i, n, m, (cudaStream_t)stream)
  LIORF_DISPATCH_K(k, CALL)
#undef CALL
}

}  // extern "C"
