// The voxel filter's reduction after its sort, for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// Built by ops/voxel_reduce.py with the flags of core/build.py and loaded
// with ctypes; launches on the stream it is given, allocates nothing (the
// wrapper hands it one scratch buffer), never synchronises, returns
// cudaGetLastError().
//
// Not a TPU kernel: it takes the place of the eager ops that follow the sort
// in core/voxel.py (the gathers, the segment flags and their cumsum, the
// fixed-order segment sum of csrc/segment_sum.cu that stood in for the
// card's atomic index_add, scatter_reduce(amin), the division and the
// padding), about 35 launches a call; the JAX package's .at[].add lies
// outside any Pallas kernel (liorf_tpu/core/voxel.py:57-61).
//
// For each lane b, with o = order[b] (a permutation of the lane's M points,
// cells non-decreasing and invalid points last):
//   sorted position p starts a segment when p = 0, or point o[p] or o[p-1]
//   is invalid, or their cells differ; a segment's slot is its rank among
//   the starts. Slot k < S of a segment of valid points gets
//     centroid = (sum of xyz) / count, intensity = (sum of intensity) / count,
//     valid = 1, rep = the smallest o[p] in the segment,
//   every sum from 0.0f in sorted order, one rounded add at a time (the
//   order of the CPU's sequential index_add); any other slot gets
//   (PAD_COORD, 0, 0, M).
//
// What bounds it: bytes (37 a point read, 25 a slot written) and, at the
// scan voxel's 32768 points, latency. Two launches, every lane in each:
//   1. voxel_scan_kernel: a block takes a tile of 1024 sorted positions
//      (ticketed in launch order; small tiles keep more blocks in flight at
//      the scan voxel's 32768 points), stages their cells and masks through
//      `order` in shared memory, every thread's loads in flight at once
//      (first its rows' order, then their cells), flags the starts by warp
//      ballot, scans the counts in the block, and carries the prefix across
//      tiles by a decoupled look-back on one status word a tile (no second
//      scan pass).
//      Position M counts as a start (it closes the last segment). The block
//      writes offsets[b, slot] = p for every start p with slot <= S, and
//      M's slot, the number of segments.
//   2. voxel_sum_kernel: a thread takes an output slot; a block's 256 slots
//      cover one contiguous run of sorted positions, whose rows (order, xyz,
//      intensity gathered through it) the block stages in shared memory
//      (coalesced reads of order, each thread's gathers in flight at once);
//      each thread then adds its own rows from there in
//      order, reading a segment's tail past the staged run from memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_ITEMS = 4;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;  // sorted positions a scan block
constexpr int PER_LANE = SCAN_ITEMS * SCAN_WARPS / 32;  // counts warp 0 scans a lane
static_assert(SCAN_ITEMS * SCAN_WARPS % 32 == 0, "warp 0 scans whole counts a lane");

constexpr int SUM_THREADS = 256;  // output slots a sum block
constexpr int STAGE = 2048;       // sorted positions a sum block stages

constexpr float PAD_COORD = 1.0e7f;  // core/pointcloud.py

// A tile's status word: the flag in the high half, the count in the low.
constexpr unsigned long long FLAG_AGGREGATE = 1ull << 32;  // the tile's own starts
constexpr unsigned long long FLAG_PREFIX = 2ull << 32;     // starts up to and with the tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__global__ void __launch_bounds__(SCAN_THREADS)
voxel_scan_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ cell,
                  const int64_t* __restrict__ order, int* __restrict__ offsets,
                  int* __restrict__ nseg, unsigned long long* __restrict__ status,
                  unsigned int* __restrict__ ticket, int m, int s, int tiles) {
  // (x, y, z, valid) of the tile's positions; [0] is the position before it
  __shared__ int4 key[TILE + 1];
  __shared__ int count[SCAN_ITEMS * SCAN_WARPS];
  __shared__ int tile_id, tile_prefix;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Tiles in the order blocks start: every tile a block looks back on
  // belongs to a block that is running or done, so the look-back ends.
  if (tid == 0) tile_id = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = tile_id / tiles, tile = tile_id - b * tiles;
  const int64_t base = (int64_t)tile * TILE;
  const int64_t* ob = order + (int64_t)b * m;
  const uint8_t* mb = mask + (int64_t)b * m;
  const int* cb = cell + (int64_t)b * m * 3;

  // the tile and the position before it
  constexpr int STAGED = (TILE + 1 + SCAN_THREADS - 1) / SCAN_THREADS;
  int64_t row[STAGED];
#pragma unroll
  for (int j = 0; j < STAGED; ++j) {
    const int64_t p = base - 1 + j * SCAN_THREADS + tid;
    row[j] = (p >= 0 && p < m && j * SCAN_THREADS + tid <= TILE) ? ob[p] : -1;
  }
#pragma unroll
  for (int j = 0; j < STAGED; ++j) {
    const int64_t r = row[j];
    int4 k = make_int4(0, 0, 0, 0);  // outside [0, m): invalid
    if (r >= 0) k = make_int4(cb[r * 3], cb[r * 3 + 1], cb[r * 3 + 2], mb[r] != 0);
    if (j * SCAN_THREADS + tid <= TILE) key[j * SCAN_THREADS + tid] = k;
  }
  __syncthreads();

  // Position p of the tile is r * SCAN_THREADS + tid: the counts are in the
  // order (r, warp), which is the positions' order. Position m (invalid)
  // always starts: the slot after the last segment.
  unsigned ballot[SCAN_ITEMS];
#pragma unroll
  for (int r = 0; r < SCAN_ITEMS; ++r) {
    const int i = r * SCAN_THREADS + tid;
    const int4 a = key[i + 1], c = key[i];
    const bool start = base + i <= m &&
                       (a.w == 0 || c.w == 0 || a.x != c.x || a.y != c.y || a.z != c.z);
    ballot[r] = __ballot_sync(FULL, start);
    if (lane == 0) count[r * SCAN_WARPS + warp] = __popc(ballot[r]);
  }
  __syncthreads();

  if (warp == 0) {
    int v[PER_LANE], own = 0;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) own += (v[j] = count[PER_LANE * lane + j]);
    int incl = own;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - own;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      count[PER_LANE * lane + j] = run;
      run += v[j];
    }
    const int aggregate = __shfl_sync(FULL, incl, 31);
    unsigned long long* st = status + (int64_t)b * tiles;
    if (lane == 0)
      atomicExch(st + tile, (tile == 0 ? FLAG_PREFIX : FLAG_AGGREGATE) | (unsigned)aggregate);
    int prefix = 0;
    if (tile > 0) {
      // a window of 32 predecessors, nearest in lane 0; before tile 0 a
      // prefix of 0
      for (int j = tile - 1;;) {
        const int q = j - lane;
        const unsigned long long word = q >= 0 ? load_status(st + q) : FLAG_PREFIX;
        if (__any_sync(FULL, (word >> 32) == 0)) continue;  // not published yet
        const unsigned done = __ballot_sync(FULL, (word >> 32) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        int x = lane <= stop ? (int)(unsigned)word : 0;
        for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
        prefix += x;
        if (done) break;
        j -= 32;
      }
      if (lane == 0) atomicExch(st + tile, FLAG_PREFIX | (unsigned)(prefix + aggregate));
    }
    if (lane == 0) tile_prefix = prefix;
  }
  __syncthreads();

  int* ofs = offsets + (int64_t)b * (s + 1);
#pragma unroll
  for (int r = 0; r < SCAN_ITEMS; ++r) {
    if (!((ballot[r] >> lane) & 1u)) continue;
    const int slot = tile_prefix + count[r * SCAN_WARPS + warp] +
                     __popc(ballot[r] & ((1u << lane) - 1u));
    const int64_t p = base + r * SCAN_THREADS + tid;
    if (slot <= s) ofs[slot] = (int)p;
    if (p == m) nseg[b] = slot;
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
voxel_sum_kernel(const float* __restrict__ xyz, const float* __restrict__ intensity,
                 const uint8_t* __restrict__ mask, const int64_t* __restrict__ order,
                 const int* __restrict__ offsets, const int* __restrict__ nseg,
                 float* __restrict__ out_xyz, float* __restrict__ out_intensity,
                 uint8_t* __restrict__ out_valid, int64_t* __restrict__ out_rep, int m, int s) {
  __shared__ float4 row[STAGE];  // x, y, z, intensity
  __shared__ int row_idx[STAGE];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * SUM_THREADS;
  const int k = s0 + threadIdx.x;
  const int* ofs = offsets + (int64_t)b * (s + 1);
  const int64_t* ob = order + (int64_t)b * m;
  const float* xb = xyz + (int64_t)b * m * 3;
  const float* ib = intensity + (int64_t)b * m;
  const uint8_t* mb = mask + (int64_t)b * m;

  // slots below `present` hold a segment; offsets[present] is written
  const int present = min(nseg[b], s);
  const int kend = min(s0 + SUM_THREADS, present);
  int lo_blk = 0, run = 0;
  if (kend > s0) {
    lo_blk = ofs[s0];
    run = min(ofs[kend] - lo_blk, STAGE);
  }
  constexpr int PER_THREAD = STAGE / SUM_THREADS;
  int64_t staged[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = j * SUM_THREADS + threadIdx.x;
    staged[j] = i < run ? ob[lo_blk + i] : -1;
  }
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = j * SUM_THREADS + threadIdx.x;
    const int64_t r = staged[j];
    if (r >= 0) {
      row_idx[i] = (int)r;
      row[i] = make_float4(xb[r * 3], xb[r * 3 + 1], xb[r * 3 + 2], ib[r]);
    }
  }
  __syncthreads();
  if (k >= s) return;

  float sx = 0.0f, sy = 0.0f, sz = 0.0f, si = 0.0f, cnt = 0.0f;
  int64_t rep = m;
  bool valid = false;
  if (k < present) {
    const int lo = ofs[k], hi = ofs[k + 1];
    // a segment is valid points only, or one invalid point
    valid = mb[ob[lo]] != 0;
    for (int p = lo; valid && p < hi; ++p) {
      int r;
      float4 v;
      if (p - lo_blk < run) {
        r = row_idx[p - lo_blk];
        v = row[p - lo_blk];
      } else {
        r = (int)ob[p];
        v = make_float4(xb[(int64_t)r * 3], xb[(int64_t)r * 3 + 1], xb[(int64_t)r * 3 + 2], ib[r]);
      }
      sx = __fadd_rn(sx, v.x);
      sy = __fadd_rn(sy, v.y);
      sz = __fadd_rn(sz, v.z);
      si = __fadd_rn(si, v.w);
      cnt = __fadd_rn(cnt, 1.0f);
      rep = r < rep ? r : rep;
    }
  }
  const int64_t o = (int64_t)b * s + k;
  out_xyz[o * 3] = valid ? __fdiv_rn(sx, cnt) : PAD_COORD;
  out_xyz[o * 3 + 1] = valid ? __fdiv_rn(sy, cnt) : PAD_COORD;
  out_xyz[o * 3 + 2] = valid ? __fdiv_rn(sz, cnt) : PAD_COORD;
  out_intensity[o] = valid ? __fdiv_rn(si, cnt) : 0.0f;
  out_valid[o] = valid;
  out_rep[o] = valid ? rep : (int64_t)m;
}

int scan_tiles(int m) { return (m + 1 + TILE - 1) / TILE; }

long long status_bytes(int lanes, int m) {
  return ((long long)lanes * scan_tiles(m) + 1) * 8;  // + the ticket
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer liorf_voxel_reduce takes for `lanes` lanes of
// m points into s slots.
long long liorf_voxel_reduce_scratch_bytes(int lanes, int m, int s) {
  return status_bytes(lanes, m) + ((long long)lanes * (s + 1) + lanes) * 4;
}

// xyz [lanes, m, 3] f32, intensity [lanes, m] f32, mask [lanes, m] u8 (bool),
// cell [lanes, m, 3] i32, order [lanes, m] i64 -> out_xyz [lanes, s, 3] f32,
// out_intensity [lanes, s] f32, out_valid [lanes, s] u8, out_rep [lanes, s]
// i64. All contiguous device pointers; scratch of
// liorf_voxel_reduce_scratch_bytes, 8-byte aligned. m < 2^31 - 1.
int liorf_voxel_reduce(const void* xyz, const void* intensity, const void* mask,
                       const void* cell, const void* order, void* scratch, void* out_xyz,
                       void* out_intensity, void* out_valid, void* out_rep, int lanes, int m,
                       int s, void* stream) {
  if (lanes == 0 || s == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = scan_tiles(m);
  char* base = (char*)scratch;
  unsigned long long* status = (unsigned long long*)base;
  unsigned int* ticket = (unsigned int*)(status + (long long)lanes * tiles);
  int* offsets = (int*)(base + status_bytes(lanes, m));
  int* nseg = offsets + (long long)lanes * (s + 1);
  cudaError_t err = cudaMemsetAsync(base, 0, status_bytes(lanes, m), st);
  if (err != cudaSuccess) return (int)err;
  voxel_scan_kernel<<<(unsigned)(lanes * tiles), SCAN_THREADS, 0, st>>>(
      (const uint8_t*)mask, (const int*)cell, (const int64_t*)order, offsets, nseg, status,
      ticket, m, s, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((s + SUM_THREADS - 1) / SUM_THREADS), (unsigned)lanes);
  voxel_sum_kernel<<<grid, SUM_THREADS, 0, st>>>(
      (const float*)xyz, (const float*)intensity, (const uint8_t*)mask, (const int64_t*)order,
      offsets, nseg, (float*)out_xyz, (float*)out_intensity, (uint8_t*)out_valid,
      (int64_t*)out_rep, m, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
