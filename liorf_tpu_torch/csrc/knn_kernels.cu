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
// tensor cores here, and the expansion would change results against the
// plain version.
//
// Tie-break everywhere: the lower candidate position / target index wins.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
// d2 at or above this (inf included: 1e30^2 overflows f32) means "missing".
constexpr float kMissing = 0.5e30f;
constexpr int kNoIdx = 0x7fffffff;

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
// K1: knn_grid in one launch — cell of the query, its 27 neighbour runs in
// the sorted grid, and the k nearest of their points.
//
// Replaces liorf_tpu/ops/knn_pallas.py: _cand_kernel / topk_candidates_pallas
// together with the gather in front of it (liorf_tpu/ops/knn.py:147-173): the
// TPU kernel read a pre-gathered [N, 27*bucket, 3] candidate tensor; here the
// candidates are read straight from the sorted grid (M * 16 B: ~2 MB at the
// bench point, resident in the 50 MB L2), so neither that tensor nor the
// [N, 27*bucket] index tensor is ever written.
//
// Bound: the bytes the function must move are ~3 MB (queries, grid, outputs),
// well under a microsecond of HBM time; what it really pays is L2 latency —
// ~17 dependent probes of the binary searches, then one coordinate load per
// candidate (sum of the run lengths). The design hides latency rather than
// bandwidth: one warp per query, 8 warps per block, many warps resident;
// the searches of one (dx, dy) column run interleaved in one lane, and
// four candidate loads are in flight before any is consumed.
//
// Work of one warp (one query):
//  * lane 0..8 owns column (dx, dy) = (lane/3 - 1, lane%3 - 1). Cells
//    (x, y, z-1), (x, y, z), (x, y, z+1) are adjacent keys, so the column's
//    three runs are bounded by 4 lower-bound searches sharing one probe
//    schedule. Keys are int32 that wrap exactly as the reference's do
//    (uint32 arithmetic here); where a wrap splits a column (only for the
//    sentinel key of an out-of-range query), the split key gets its own search.
//  * each run is cut at `bucket` points, as torch.clamp(ends - starts,
//    max=bucket) does; a warp scan lays the 27 runs end to end.
//  * lanes stride over that list; each keeps a private sorted top-k in
//    registers; k rounds of a warp arg-min over (d2, grid index) pick the
//    winners and the owning lane pops its head.
//
// Tie-break: the reference breaks ties by position in its candidate list
// (27 runs of `bucket` slots in _NEIGHBOR_OFFSETS order). The 27 neighbour
// keys increase strictly in that order and each run is a sorted stretch of
// the grid, so for every candidate that is not masked out "lower position"
// is "lower grid index"; the kernel breaks ties by grid index. (An
// out-of-range query has one non-empty run, the sentinel run.)
//
// The query's cell is computed as ops/knn_cuda.py::_cell_coords does on the
// card: IEEE subtract and divide (no fast math), floor, the saturating
// float->int conversion of torch's .to(int32), +512 with int32 wrap, the
// range test, the clamp.
// ---------------------------------------------------------------------------
constexpr int kBits = 10;
constexpr int kHalf = 1 << (kBits - 1);
constexpr int kCellsPerAxis = 1 << kBits;
constexpr int kSentinel = 0x7fffffff;
constexpr int kGridWarps = 8;    // queries per block
constexpr int kGridBatch = 4;    // candidate loads in flight per lane

// For each s: first i in [0, m) with keys[i] >= t[s] (int64 compare), or m.
// m >= 1. The probe schedule depends on m only, so the S searches advance in
// lock step and their loads overlap.
template <int S>
__device__ __forceinline__ void lower_bounds(const int* __restrict__ keys, int m,
                                             const long long (&t)[S], int (&out)[S]) {
  int base[S];
#pragma unroll
  for (int s = 0; s < S; ++s) base[s] = 0;
  int len = m;
  while (len > 1) {
    const int half = len >> 1;
#pragma unroll
    for (int s = 0; s < S; ++s)
      base[s] = ((long long)__ldg(keys + base[s] + half) < t[s]) ? base[s] + half : base[s];
    len -= half;
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    out[s] = base[s] + ((long long)__ldg(keys + base[s]) < t[s] ? 1 : 0);
}

__device__ __forceinline__ int lower_bound1(const int* __restrict__ keys, int m, long long t) {
  const long long tt[1] = {t};
  int out[1];
  lower_bounds<1>(keys, m, tt, out);
  return out[0];
}

__device__ __forceinline__ int cell_of(float q, float o, float cs, bool& in_range) {
  const float rel = __fdiv_rn(__fsub_rn(q, o), cs);
  int c = __float2int_rz(floorf(rel));  // saturates; NaN -> 0 (as cvt.rzi)
  c = (int)((uint32_t)c + (uint32_t)kHalf);
  in_range = in_range && c >= 0 && c < kCellsPerAxis;
  return min(max(c, 0), kCellsPerAxis - 1);
}

template <int K>
__global__ void __launch_bounds__(kGridWarps * 32)
knn_grid_kernel(const float* __restrict__ xyz, const int* __restrict__ keys,
                const float* __restrict__ origin, const float* __restrict__ cell_size,
                const float* __restrict__ queries, const uint8_t* __restrict__ query_mask,
                float* __restrict__ out_d, int* __restrict__ out_i,
                int n, int m, int bucket) {
  __shared__ int run_start[kGridWarps][27];
  __shared__ int run_first[kGridWarps][27];  // flat position of each run's first point

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGridWarps + warp;
  if (row >= n) return;  // the whole warp leaves together

  // lane axis (blockIdx.y): every stacked input is contiguous per session,
  // so a session's pointers are its block of each; the rest of the body is
  // the one-session kernel
  const size_t b = blockIdx.y;
  xyz += b * 3 * (size_t)m;
  keys += b * (size_t)m;
  origin += b * 3;
  cell_size += b;
  queries += b * 3 * (size_t)n;
  query_mask += b * (size_t)n;
  out_d += b * (size_t)n * K;
  out_i += b * (size_t)n * K;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { bd[s] = CUDART_INF_F; bi[s] = kNoIdx; }

  if (query_mask[row] != 0 && m > 0) {  // warp-uniform
    const float qx = queries[3 * (size_t)row + 0];
    const float qy = queries[3 * (size_t)row + 1];
    const float qz = queries[3 * (size_t)row + 2];

    if (lane < 9) {
      const float cs = __ldg(cell_size);
      bool in_range = true;
      const int cx = cell_of(qx, __ldg(origin + 0), cs, in_range);
      const int cy = cell_of(qy, __ldg(origin + 1), cs, in_range);
      const int cz = cell_of(qz, __ldg(origin + 2), cs, in_range);
      const uint32_t base = in_range
          ? ((uint32_t)cx << (2 * kBits)) | ((uint32_t)cy << kBits) | (uint32_t)cz
          : (uint32_t)kSentinel;
      const int dx = lane / 3 - 1, dy = lane % 3 - 1;
      const uint32_t centre =
          base + ((uint32_t)dx << (2 * kBits)) + ((uint32_t)dy << kBits);
      // the column's keys as the reference's int32 arithmetic gives them
      const long long w0 = (int)(centre - 1u), w1 = (int)centre, w2 = (int)(centre + 1u);
      const long long t[4] = {w0, w0 + 1, w1 + 1, w2 + 1};
      int b[4];
      lower_bounds<4>(keys, m, t, b);
      const int s0 = b[0];
      const int s1 = (w1 == w0 + 1) ? b[1] : lower_bound1(keys, m, w1);
      const int s2 = (w2 == w1 + 1) ? b[2] : lower_bound1(keys, m, w2);
      run_start[warp][3 * lane + 0] = s0;
      run_start[warp][3 * lane + 1] = s1;
      run_start[warp][3 * lane + 2] = s2;
      run_first[warp][3 * lane + 0] = min(b[1] - s0, bucket);
      run_first[warp][3 * lane + 1] = min(b[2] - s1, bucket);
      run_first[warp][3 * lane + 2] = min(b[3] - s2, bucket);
    }
    __syncwarp();
    // lay the 27 truncated runs end to end (exclusive warp scan)
    const int len = lane < 27 ? run_first[warp][lane] : 0;
    int incl = len;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    __syncwarp();
    if (lane < 27) run_first[warp][lane] = incl - len;
    __syncwarp();

    int run = 0;  // this lane's cursor over the runs; its positions only grow
    for (int f0 = lane; f0 < total; f0 += 32 * kGridBatch) {
      int g[kGridBatch];
#pragma unroll
      for (int u = 0; u < kGridBatch; ++u) {
        const int f = f0 + 32 * u;
        g[u] = -1;
        if (f < total) {
          while (run < 26 && run_first[warp][run + 1] <= f) ++run;
          g[u] = run_start[warp][run] + (f - run_first[warp][run]);
        }
      }
      float px[kGridBatch], py[kGridBatch], pz[kGridBatch];
#pragma unroll
      for (int u = 0; u < kGridBatch; ++u) {
        const int gg = g[u] < 0 ? 0 : g[u];
        px[u] = __ldg(xyz + 3 * (size_t)gg + 0);
        py[u] = __ldg(xyz + 3 * (size_t)gg + 1);
        pz[u] = __ldg(xyz + 3 * (size_t)gg + 2);
      }
#pragma unroll
      for (int u = 0; u < kGridBatch; ++u) {
        if (g[u] >= 0) {
          const float d = sq_dist(qx, qy, qz, px[u], py[u], pz[u]);
          if (d < kMissing && d < bd[K - 1]) insert_sorted<K>(bd, bi, d, g[u]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < K; ++r) {
    float d = bd[0];
    int i = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (lex_less(od, oi, d, i)) { d = od; i = oi; }
    }
    // (d, i) is the same on every lane; a grid index is a candidate of one
    // lane only, so exactly one lane holds it at its head
    if (i != kNoIdx && bi[0] == i) {
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) { bd[s] = bd[s + 1]; bi[s] = bi[s + 1]; }
      bd[K - 1] = CUDART_INF_F;
      bi[K - 1] = kNoIdx;
    }
    if (lane == 0) {
      const bool missing = (i == kNoIdx);
      out_d[(size_t)row * K + r] = missing ? CUDART_INF_F : d;
      out_i[(size_t)row * K + r] = missing ? 0 : i;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: streaming exact k-NN of N queries against M masked targets.
//
// Replaces liorf_tpu/ops/knn_pallas.py: _kernel / knn_bruteforce_pallas.
// Compute-bound on the CUDA cores: N*M pairs, against only (N+M)*13 bytes in
// and N*k*8 out. The operations bound counts 8 flop a pair at 67 TFLOP/s;
// the instruction floor is higher: with every operation rounded on its own a pair
// is 8 FP32 instructions (3 sub, 3 mul, 2 add) plus a compare and selects,
// ~11 instruction slots, and an SM dispatches 128 lanes a clock — 0.088 ms at
// 16384 x 16384 on an H100 SXM at 1.98 GHz.
//
// Design (register tiling):
//  * a thread owns QPT queries (lane + 32*q of its block's 32*QPT queries;
//    QPT = 8 at k = 1); one broadcast float4 shared-memory load of a target
//    feeds QPT distances.
//  * the 8 warps of a block split every staged chunk by target (j % 8), and
//    blockIdx.y splits the targets into ranges so that every SM gets several
//    blocks (bf_split); a thread sees its targets in increasing index order.
//  * k = 1 is a predicated compare-select (FSETP, FSEL, SEL: no branch, no
//    insertion loop). k > 1 keeps a sorted register list per query and
//    branches into the insertion when a pair beats its last entry; there one
//    query a thread and long target streams (one range) keep the threshold
//    tight. Tried and slower on the card: testing a group of 4 pairs at once
//    before inserting, 2 queries a thread at k > 1, and (k = 1) a running
//    minimum per group of targets with the winner's index found afterwards.
//  * targets are staged through shared memory in chunks (BfShape) with a
//    double-buffered cp.async (zero-fill at the ragged end), so loading chunk
//    c+1 overlaps computing chunk c; one pass turns each chunk into float4
//    (x, y, z, 0), a masked or absent target getting NaN coordinates: its
//    distance is NaN and never compares less than anything.
//  * the warps' lists of a query merge through shared memory ordered by
//    (d2, index); with one target range the block writes the result, else
//    each range writes a partial list and knn_bf_merge_kernel merges them.
// ---------------------------------------------------------------------------
constexpr int kBfWarps = 8;
constexpr int kBfThreads = kBfWarps * 32;
constexpr int kBfBlocksPerSm = 4;  // k = 1 launch: blocks wanted per SM

template <int K>
struct BfShape {
  static constexpr int kQpt = K == 1 ? 8 : 1;         // queries per thread
  static constexpr int kQueries = 32 * kQpt;          // queries per block
  static constexpr int kChunk = K == 1 ? 256 : 1024;  // targets per staged chunk
};

template <int K>
struct __align__(16) BfShared {
  static constexpr int CH = BfShape<K>::kChunk;
  union {
    struct {
      float4 tile[CH];
      float raw_xyz[2][CH * 3];
      uint8_t raw_mask[2][CH];
    } stage;
    struct {
      float d[kBfWarps][K][BfShape<K>::kQueries];
      int i[kBfWarps][K][BfShape<K>::kQueries];
    } merge;
  };
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy targets [t0, t0 + cnt) (t0 % 16 == 0) into raw buffers.
__device__ __forceinline__ void stage_chunk(float* raw_xyz, uint8_t* raw_mask,
                                            const float* map_xyz, const uint8_t* map_mask,
                                            int t0, int cnt) {
  const int xyz_bytes = cnt * 12;
  const char* gx = reinterpret_cast<const char*>(map_xyz + 3 * (size_t)t0);
  for (int g = threadIdx.x; 16 * g < xyz_bytes; g += kBfThreads)
    cp_async16(reinterpret_cast<char*>(raw_xyz) + 16 * g, gx + 16 * g, min(16, xyz_bytes - 16 * g));
  for (int g = threadIdx.x; 16 * g < cnt; g += kBfThreads)
    cp_async16(raw_mask + 16 * g, map_mask + t0 + 16 * g, min(16, cnt - 16 * g));
}

template <int K>
__device__ __forceinline__ void finalize(float (&bd)[K], int (&bi)[K], bool q_ok, size_t row,
                                         float* out_d, int* out_i) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool missing = !q_ok || !(bd[s] < kMissing);
    out_d[row * K + s] = missing ? CUDART_INF_F : bd[s];
    out_i[row * K + s] = missing ? 0 : bi[s];
  }
}

template <int K>
__global__ void __launch_bounds__(kBfThreads)
knn_bf_kernel(const float* __restrict__ map_xyz, const uint8_t* __restrict__ map_mask,
              const float* __restrict__ queries, const uint8_t* __restrict__ query_mask,
              float* __restrict__ out_d, int* __restrict__ out_i,
              float* __restrict__ part_d, int* __restrict__ part_i,
              int n, int m, int mstride, int range_len) {
  constexpr int QPT = BfShape<K>::kQpt;
  constexpr int QB = BfShape<K>::kQueries;
  constexpr int CH = BfShape<K>::kChunk;
  __shared__ BfShared<K> sm;

  // lane axis, folded into blockIdx.x (qblocks query blocks per lane):
  // session b's targets start at b * mstride (mstride % 16 == 0 keeps the
  // cp.async sources 16-byte aligned), its queries, outputs and partial
  // lists at its own block of each
  const int qblocks = (n + QB - 1) / QB;
  const size_t b = blockIdx.x / qblocks;
  map_xyz += b * 3 * (size_t)mstride;
  map_mask += b * (size_t)mstride;
  queries += b * 3 * (size_t)n;
  query_mask += b * (size_t)n;
  out_d += b * (size_t)n * K;
  out_i += b * (size_t)n * K;
  part_d += b * (size_t)gridDim.y * n * K;
  part_i += b * (size_t)gridDim.y * n * K;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x % qblocks) * QB;

  float qx[QPT], qy[QPT], qz[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int row = row0 + 32 * q + lane;
    const bool live = row < n;
    qx[q] = live ? queries[3 * (size_t)row + 0] : 0.f;
    qy[q] = live ? queries[3 * (size_t)row + 1] : 0.f;
    qz[q] = live ? queries[3 * (size_t)row + 2] : 0.f;
  }
  float bd[QPT][K];
  int bi[QPT][K];
#pragma unroll
  for (int q = 0; q < QPT; ++q)
#pragma unroll
    for (int s = 0; s < K; ++s) { bd[q][s] = CUDART_INF_F; bi[q][s] = 0; }

  const int r0 = blockIdx.y * range_len;
  const int r1 = min(m, r0 + range_len);
  const int chunks = r1 > r0 ? (r1 - r0 + CH - 1) / CH : 0;

  if (chunks > 0) {
    stage_chunk(sm.stage.raw_xyz[0], sm.stage.raw_mask[0], map_xyz, map_mask, r0,
                min(CH, r1 - r0));
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    const int t0 = r0 + c * CH;
    const int cnt = min(CH, r1 - t0);
    if (c + 1 < chunks) {
      // this buffer held chunk c-1, converted before the last barrier
      stage_chunk(sm.stage.raw_xyz[(c + 1) & 1], sm.stage.raw_mask[(c + 1) & 1], map_xyz,
                  map_mask, t0 + CH, min(CH, r1 - t0 - CH));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c has landed; every warp is done with the tile
    const float* rx = sm.stage.raw_xyz[c & 1];
    const uint8_t* rm = sm.stage.raw_mask[c & 1];
    for (int j = threadIdx.x; j < CH; j += kBfThreads) {
      float4 t = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
      if (j < cnt && rm[j] != 0) t = make_float4(rx[3 * j], rx[3 * j + 1], rx[3 * j + 2], 0.f);
      sm.stage.tile[j] = t;
    }
    __syncthreads();

    if constexpr (K == 1) {
#pragma unroll 8
      for (int jj = 0; jj < CH / kBfWarps; ++jj) {
        const int j = jj * kBfWarps + warp;
        const float4 t = sm.stage.tile[j];
        const int gi = t0 + j;
#pragma unroll
        for (int q = 0; q < QPT; ++q) {
          const float d = sq_dist(qx[q], qy[q], qz[q], t.x, t.y, t.z);
          const bool p = d < bd[q][0];
          bd[q][0] = p ? d : bd[q][0];
          bi[q][0] = p ? gi : bi[q][0];
        }
      }
    } else {
      for (int jj = 0; jj < CH / kBfWarps; ++jj) {
        const int j = jj * kBfWarps + warp;
        const float4 t = sm.stage.tile[j];
#pragma unroll
        for (int q = 0; q < QPT; ++q) {
          const float d = sq_dist(qx[q], qy[q], qz[q], t.x, t.y, t.z);
          if (d < bd[q][K - 1]) insert_sorted<K>(bd[q], bi[q], d, t0 + j);
        }
      }
    }
  }

  __syncthreads();  // the merge buffers overlay the staging buffers
#pragma unroll
  for (int q = 0; q < QPT; ++q)
#pragma unroll
    for (int s = 0; s < K; ++s) {
      sm.merge.d[warp][s][32 * q + lane] = bd[q][s];
      sm.merge.i[warp][s][32 * q + lane] = bi[q][s];
    }
  __syncthreads();

  for (int slot = threadIdx.x; slot < QB; slot += kBfThreads) {
    const int row = row0 + slot;
    if (row >= n) break;
    float md[K];
    int mi[K];
#pragma unroll
    for (int s = 0; s < K; ++s) { md[s] = sm.merge.d[0][s][slot]; mi[s] = sm.merge.i[0][s][slot]; }
    for (int w = 1; w < kBfWarps; ++w) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float d = sm.merge.d[w][s][slot];
        const int i = sm.merge.i[w][s][slot];
        if (d < kMissing && lex_less(d, i, md[K - 1], mi[K - 1])) insert_sorted_lex<K>(md, mi, d, i);
      }
    }
    if (gridDim.y == 1) {
      finalize<K>(md, mi, query_mask[row] != 0, (size_t)row, out_d, out_i);
    } else {
      const size_t at = ((size_t)blockIdx.y * n + row) * K;
#pragma unroll
      for (int s = 0; s < K; ++s) { part_d[at + s] = md[s]; part_i[at + s] = mi[s]; }
    }
  }
}

// One thread per query: merge the partial lists of the target ranges.
template <int K>
__global__ void __launch_bounds__(256)
knn_bf_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                    const uint8_t* __restrict__ query_mask, float* __restrict__ out_d,
                    int* __restrict__ out_i, int n, int ranges) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const size_t b = blockIdx.y;  // lane axis
  part_d += b * (size_t)ranges * n * K;
  part_i += b * (size_t)ranges * n * K;
  query_mask += b * (size_t)n;
  out_d += b * (size_t)n * K;
  out_i += b * (size_t)n * K;
  float md[K];
  int mi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) { md[s] = CUDART_INF_F; mi[s] = 0; }
  for (int r = 0; r < ranges; ++r) {
    const size_t at = ((size_t)r * n + row) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const float d = part_d[at + s];
      const int i = part_i[at + s];
      if (d < kMissing && lex_less(d, i, md[K - 1], mi[K - 1])) insert_sorted_lex<K>(md, mi, d, i);
    }
  }
  finalize<K>(md, mi, query_mask[row] != 0, (size_t)row, out_d, out_i);
}

template <int K>
int launch_grid(const float* xyz, const int* keys, const float* origin, const float* cs,
                const float* q, const uint8_t* qm, float* od, int* oi, int lanes, int n,
                int m, int bucket, cudaStream_t stream) {
  const dim3 blocks((n + kGridWarps - 1) / kGridWarps, lanes);
  knn_grid_kernel<K><<<blocks, kGridWarps * 32, 0, stream>>>(xyz, keys, origin, cs, q, qm, od,
                                                             oi, n, m, bucket);
  return (int)cudaGetLastError();
}

// How `lanes` n x m searches on a card of `sms` SMs split the targets: the
// number of target ranges and the targets in each (whole chunks). Enough
// blocks (over all lanes) to give every SM several at k = 1; one range for
// k > 1, where a long target stream per thread keeps the list's threshold
// tight and insertions rare. The split does not change a result: each range
// keeps its exact top-k and the merge orders by (d2, index).
struct BfSplit {
  int ranges;
  int range_len;
};

template <int K>
BfSplit bf_split(int lanes, int n, int m, int sms) {
  constexpr int CH = BfShape<K>::kChunk;
  const int chunks = (m + CH - 1) / CH;
  if (chunks <= 0) return {1, CH};
  const int qblocks = lanes * ((n + BfShape<K>::kQueries - 1) / BfShape<K>::kQueries);
  const int want = (K == 1 ? kBfBlocksPerSm : 1) * sms;
  const int r = min(chunks, max(1, (want + qblocks - 1) / qblocks));
  const int per = (chunks + r - 1) / r;  // chunks per range
  return {(chunks + per - 1) / per, per * CH};
}

template <int K>
int launch_bf(const float* mx, const uint8_t* mm, const float* q, const uint8_t* qm, float* od,
              int* oi, float* pd, int* pi, int lanes, int n, int m, int mstride, int sms,
              cudaStream_t stream) {
  const BfSplit split = bf_split<K>(lanes, n, m, sms);
  const dim3 grid(lanes * ((n + BfShape<K>::kQueries - 1) / BfShape<K>::kQueries), split.ranges);
  knn_bf_kernel<K><<<grid, kBfThreads, 0, stream>>>(mx, mm, q, qm, od, oi, pd, pi, n, m,
                                                    mstride, split.range_len);
  int err = (int)cudaGetLastError();
  if (err != 0 || split.ranges == 1) return err;
  const dim3 mgrid((n + 255) / 256, lanes);
  knn_bf_merge_kernel<K><<<mgrid, 256, 0, stream>>>(pd, pi, qm, od, oi, n, split.ranges);
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

// For `lanes` sessions stacked on a leading axis: xyz [lanes,m,3] f32 and
// keys [lanes,m] i32 of the sorted grids, origin [lanes,3] f32, cell_size
// [lanes] f32, queries [lanes,n,3] f32, query_mask [lanes,n] u8 ->
// out_d [lanes,n,k] f32, out_i [lanes,n,k] i32. All contiguous device
// pointers; one launch serves every lane (lanes = 1: one session).
int liorf_knn_grid_topk(const void* xyz, const void* keys, const void* origin,
                        const void* cell_size, const void* queries, const void* query_mask,
                        void* out_d, void* out_i, int lanes, int n, int m, int k, int bucket,
                        void* stream) {
#define CALL(KK)                                                                     \
  launch_grid<KK>((const float*)xyz, (const int*)keys, (const float*)origin,         \
                  (const float*)cell_size, (const float*)queries,                    \
                  (const uint8_t*)query_mask, (float*)out_d, (int*)out_i, lanes, n,  \
                  m, bucket, (cudaStream_t)stream)
  LIORF_DISPATCH_K(k, CALL)
#undef CALL
}

// Number of target ranges knn_bruteforce uses for `lanes` n x m searches on
// a card of `sms` SMs (the partial buffers hold lanes * ranges * n * k
// entries when it is above 1). Host arithmetic only.
int liorf_knn_bruteforce_ranges(int lanes, int n, int m, int k, int sms) {
#define CALL(KK) bf_split<KK>(lanes, n, m, sms).ranges
  LIORF_DISPATCH_K(k, CALL)
#undef CALL
}

// For `lanes` sessions stacked on a leading axis: map_xyz [lanes,mstride,3]
// f32 and map_mask [lanes,mstride] u8 (both 16-byte aligned, mstride % 16 == 0
// when lanes > 1; the first m targets of each lane are searched), queries
// [lanes,n,3] f32, query_mask [lanes,n] u8 -> out_d [lanes,n,k] f32,
// out_i [lanes,n,k] i32; part_d / part_i: [lanes, ranges, n, k] f32 / i32
// scratch, ranges as liorf_knn_bruteforce_ranges gives it for the same
// lanes, n, m, k, sms (unused when that is 1).
int liorf_knn_bruteforce(const void* map_xyz, const void* map_mask, const void* queries,
                         const void* query_mask, void* out_d, void* out_i, void* part_d,
                         void* part_i, int lanes, int n, int m, int mstride, int k, int sms,
                         void* stream) {
#define CALL(KK)                                                                     \
  launch_bf<KK>((const float*)map_xyz, (const uint8_t*)map_mask,                     \
                (const float*)queries, (const uint8_t*)query_mask, (float*)out_d,    \
                (int*)out_i, (float*)part_d, (int*)part_i, lanes, n, m, mstride, sms, \
                (cudaStream_t)stream)
  LIORF_DISPATCH_K(k, CALL)
#undef CALL
}

}  // extern "C"
