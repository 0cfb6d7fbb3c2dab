// The whole voxel filter for NVIDIA Hopper (sm_90a), plain C interface: the
// cells, a stable radix sort of compact keys over only the digits that vary,
// and the reduction of each run of equal cells into a slot, in one launch.
//
// Built by ops/voxel_filter.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing (the wrapper
// hands it one scratch buffer and the lanes' arrival counters, which are 0
// between launches), never synchronises, returns the launch's error.
//
// Not a TPU kernel. It takes the place of the eager filter of
// core/voxel.py on the card: `_cells` (where, multiply, floor, cast), the
// `lexsort` of (x, y, z, invalid) cells, four stable library radix sorts over
// every bit of their keys with their gathers, and the two reduction kernels
// behind a memset (the JAX package's filter, liorf_tpu/core/voxel.py:38-69,
// is XLA's lexsort and scatter-add, outside any Pallas kernel).
//
// For each lane b of m points (xyz, intensity, mask) and s slots:
//   cell = (int)floor(where(mask, xyz, PAD_COORD) * inv_leaf), the multiply
//   rounded once in float32 (torch's product by a Python scalar), the cast
//   cvt.rzi.s32.f32 (torch's on the card: saturating, NaN to 0);
//   the key of a valid point packs (z - z_min, y - y_min, x - x_min) at the
//   bit widths the lane's valid cells need (`w = bitlen(max - min)` an axis),
//   with the invalid bit above them; an invalid point's key is that bit alone
//   (every invalid point has PAD_COORD's cell). Equal keys are equal cells, so
//   a stable sort of the keys is numpy.lexsort((x, y, z, ~mask)) of the cells,
//   ties in input order;
//   a sorted position starts a segment at 0, where its key differs from the
//   previous one, or at an invalid point; valid segment k < s becomes slot k:
//     centroid = (sum of xyz) / count, intensity = (sum of intensity) / count,
//     valid = 1, rep = its first point's input index (the smallest: the sort
//     is stable), each sum from 0.0f in sorted order, one rounded add at a
//     time; every other slot (PAD_COORD, 0, 0, m).
//
// What bounds it: latency. The bytes (17 a point read, 25 a slot written)
// take 0.3 us at a scan's 32768 points; the sort's passes, each a prefix
// across blocks and a scatter, are what cost. The design:
//   * one cooperative launch for every lane; a lane's blocks are co-resident
//     and meet at barriers of their own (an arrival counter a lane), so the
//     keys stay in device memory between phases and no host step sits between
//     them. The lane's last block to leave sets its counters back to 0.
//   * the key is at most 97 bits (the invalid bit and three 32-bit fields),
//     but the passes of 8-bit digits run only over the lane's own key width:
//     each field's top bit varies (the width is max - min's), and the invalid
//     bit where the lane holds both kinds of point; every digit above is 0
//     and its pass would leave the order as it is. ~4 passes at leaf 0.3 over
//     a scan or a local map, 13 at most. The host never reads a width.
//   * a pass: each block finds its digits' offsets from the lane's counts a
//     block and digit, ranks each tile of its keys stably by warp multi-split
//     (__match_any_sync: a warp's keys in order, each warp's count a digit in
//     shared memory) and scatters them, counting each key's next digit into
//     the block it lands in (warp-aggregated atomics on three rotating count
//     tables), so the next pass's counts are ready at the one barrier a pass.
//     The first pass's counts come with the keys. A lane of more than GROUP
//     blocks (the map site's 256) also counts into its groups of GROUP
//     blocks, so a block reads the groups' counts and those of the blocks
//     before it in its group, not every block's; a smaller lane reads every
//     block's (the groups' atomics cost it more than they save).
//   * the reduction: a warp holds 32 consecutive sorted positions an item,
//     so a segment's start sums the rows of its run by warp shuffles (one
//     add at a time, in order); a run past the warp's last lane (a dense
//     voxel near the sensor holds hundreds of points) is read on by the
//     whole warp, 32 positions a round trip. The sums go to scratch in the
//     order of the block's starts; after one barrier the lane's prefix of
//     starts turns them into slots, written coalesced.
//   * every loop over a tile of 1024 positions loads all of a thread's items
//     before it uses one, so a phase costs a round trip to L2 or two, not one
//     an item; a block takes one tile, or more where a lane's blocks would
//     not all be resident at once.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
constexpr int ITEMS = 4;                  // a thread's positions a tile
constexpr int TILE = THREADS * ITEMS;     // positions a block takes at once
constexpr int PER_LANE = ITEMS * WARPS / 32;  // start counts warp 0 scans a lane
static_assert(ITEMS * WARPS % 32 == 0, "warp 0 scans whole counts a lane");
constexpr int GROUP = 32;  // blocks whose counts a count table also sums, in a wider lane
// ints a block publishes: [0, 6) its valid cells' min and max, 6 its
// invalid points, 7 its valid segment starts
constexpr int PART = 8;
constexpr float PAD_COORD = 1.0e7f;  // core/pointcloud.py
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == RADIX, "a thread a digit");

struct Args {
  const float* xyz;        // [lanes, m, 3]
  const float* intensity;  // [lanes, m], or null: 0 a point
  const uint8_t* mask;     // [lanes, m]
  float* out_xyz;          // [lanes, s, 3]
  float* out_intensity;    // [lanes, s]
  uint8_t* out_valid;      // [lanes, s]
  int64_t* out_rep;        // [lanes, s]
  int64_t* order;          // [lanes, m] the sorted permutation, or null
  ulonglong2* key[2];      // [lanes, m] ping-pong (low, high 64 bits)
  int* idx[2];             // [lanes, m] ping-pong
  float4* sums;            // [lanes, m] a block's segments' (x, y, z, intensity) sums, in order
  int2* count_rep;         // [lanes, m] their count (float bits) and representative
  int* part;               // [lanes, blocks, PART]
  int* hist;               // [3, lanes, blocks + groups, RADIX] rotating count tables
  unsigned* arrive;        // [lanes]
  unsigned* leave;         // [lanes]
  float inv_leaf;
  int m, s, lanes, blocks, groups, chunk;  // blocks and groups (0: none) a lane, tiles a block
};

__device__ __forceinline__ int cell_of(float v, float inv_leaf) {
  return (int)floorf(__fmul_rn(v, inv_leaf));
}

// v < 2^32 at bit `off` (<= 96) of the 128-bit key (lo, hi)
__device__ __forceinline__ void put(u64& lo, u64& hi, uint32_t v, int off) {
  const u64 x = v;
  if (off < 64) {
    lo |= x << off;
    if (off > 32) hi |= x >> (64 - off);
  } else {
    hi |= x << (off - 64);
  }
}

__device__ __forceinline__ unsigned digit_of(ulonglong2 k, int p) {
  const int o = 8 * p;
  return (unsigned)((o < 64 ? k.x >> o : k.y >> (o - 64)) & 0xffu);
}

__device__ __forceinline__ bool bit_of(ulonglong2 k, int off) {
  return ((off < 64 ? k.x >> off : k.y >> (off - 64)) & 1u) != 0;
}

__device__ __forceinline__ bool same(ulonglong2 a, ulonglong2 b) { return a.x == b.x && a.y == b.y; }

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// Every block of the lane arrives before any leaves (the lane's blocks are
// co-resident: a cooperative launch). `target` counts the lane's arrivals.
__device__ __forceinline__ void lane_barrier(unsigned* arrive, unsigned& target, int blocks) {
  __syncthreads();
  target += (unsigned)blocks;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(arrive, 1u);
    while (load_volatile(arrive) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
  for (int d = 16; d; d >>= 1) v = op(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

struct Min { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct Max { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct Sum { __device__ int operator()(int a, int b) const { return a + b; } };

// the block's sum of v (every thread gets it); `red` holds WARPS ints
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_reduce(v, Sum());
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r += red[w];
  return r;
}

// the block's min of v[0..3), max of v[3..6) and sum of v[6] (every thread
// gets them); `red` holds 7 WARPS ints
__device__ __forceinline__ void block_reduce7(int (&v)[7], int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    v[c] = c < 3 ? warp_reduce(v[c], Min()) : c < 6 ? warp_reduce(v[c], Max())
                                                    : warp_reduce(v[c], Sum());
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 7; ++c) red[c * WARPS + warp] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 7; ++c) {
    int r = red[c * WARPS];
    for (int w = 1; w < WARPS; ++w) {
      const int x = red[c * WARPS + w];
      r = c < 3 ? min(r, x) : c < 6 ? max(r, x) : r + x;
    }
    v[c] = r;
  }
}

// exclusive prefix of v over the block's threads in order; `red` WARPS ints
__device__ __forceinline__ int block_exclusive(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += red[w];
  return before + incl - v;
}

#ifdef LIORF_VOXEL_PROFILE
// development build: block 0's thread 0 sums the global timer's ns by part,
// read and reset by liorf_voxel_filter_profile
enum { P_CELLS, P_KEYS, P_OFFSETS, P_SCATTER, P_SEGMENTS, P_SLOTS, P_BARRIERS, P_PASSES, kProfParts };
__device__ long long g_prof[kProfParts];
__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROF_INIT                                   \
  const bool prof_on = blockIdx.x == 0 && tid == 0; \
  long long prof_t = prof_on ? now_ns() : 0
#define PROF(part)                 \
  if (prof_on) {                   \
    const long long t_ = now_ns(); \
    g_prof[part] += t_ - prof_t;   \
    prof_t = t_;                   \
  }
#else
#define PROF_INIT
#define PROF(part)
#endif

__global__ void __launch_bounds__(THREADS, 2)
voxel_filter_kernel(Args a) {
  __shared__ int s_cnt[WARPS][RADIX];  // a pass: each warp's count a digit, then its offset
  __shared__ int s_off[RADIX];         // a pass: the block's next position a digit
  __shared__ int s_hist[RADIX];
  __shared__ int s_tile[ITEMS * WARPS];  // the reduction: starts a (round, warp)
  __shared__ int s_red[8 * WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.blocks, NG = a.groups;
  const int b = blockIdx.x / G, j = blockIdx.x - b * G;
  const int m = a.m, s = a.s;
  const int range = a.chunk * TILE;  // positions a block
  const int64_t lo = (int64_t)j * range;
  const int64_t end = lo + range, hi = end < m ? end : m;
  const int64_t base = (int64_t)b * m;
  const uint8_t* mask = a.mask + base;
  const float* xyz = a.xyz + base * 3;
  const float* inten = a.intensity ? a.intensity + base : nullptr;
  int* part = a.part + (int64_t)b * G * PART;
  // a count table: the lane's rows of RADIX counts, its blocks', then its
  // groups'; table t at hist + t * table
  const int64_t table = (int64_t)a.lanes * (G + NG) * RADIX;
  int* hist = a.hist + (int64_t)b * (G + NG) * RADIX;
  const int grp = j / GROUP;
  const bool leader = NG > 0 && j % GROUP == 0;  // zeroes its group's rows
  unsigned* arrive = a.arrive + b;
  unsigned target = 0;
  const unsigned lt = (1u << lane) - 1u;
  PROF_INIT;

  // 1. the valid cells' min and max and the invalid points' count over the
  // block's range; a position of a tile is t0 + i THREADS + tid
  int r7[7] = {INT_MAX, INT_MAX, INT_MAX, INT_MIN, INT_MIN, INT_MIN, 0};
  for (int64_t t0 = lo; t0 < hi; t0 += TILE) {
    bool mk[ITEMS], live[ITEMS];
    float v[ITEMS][3];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t p = t0 + i * THREADS + tid;
      live[i] = p < hi;
      mk[i] = live[i] && mask[p];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[i][c] = live[i] ? xyz[p * 3 + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      r7[6] += live[i] && !mk[i];
      if (!mk[i]) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int x = cell_of(v[i][c], a.inv_leaf);
        r7[c] = min(r7[c], x);
        r7[3 + c] = max(r7[3 + c], x);
      }
    }
  }
  block_reduce7(r7, s_red);
  if (tid < 7) part[j * PART + tid] = r7[tid];
  if (leader) hist[(G + grp) * RADIX + tid] = 0;
  PROF(P_CELLS);
  lane_barrier(arrive, target, G);
  PROF(P_BARRIERS);

  // 2. the lane's widths; the block's keys in input order and its count a
  // digit of the first pass; the second pass's table zeroed
  r7[0] = r7[1] = r7[2] = INT_MAX;
  r7[3] = r7[4] = r7[5] = INT_MIN;
  r7[6] = 0;
  for (int k = tid; k < G; k += THREADS) {
#pragma unroll
    for (int c = 0; c < 7; ++c) {
      const int x = __ldcg(part + k * PART + c);
      r7[c] = c < 3 ? min(r7[c], x) : c < 6 ? max(r7[c], x) : r7[c] + x;
    }
  }
  block_reduce7(r7, s_red);
  const bool any_valid = r7[0] <= r7[3];
  int off[4], mn[3];
  off[0] = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const unsigned span = any_valid ? (unsigned)r7[3 + c] - (unsigned)r7[c] : 0u;
    mn[c] = any_valid ? r7[c] : 0;
    off[c + 1] = off[c] + (span ? 32 - __clz(span) : 0);
  }
  const int inv_bit = off[3];
  // the bits that vary in the lane: each field's top bit does (its width is
  // max - min's), and the invalid bit where both kinds of point are
  const int nbits = any_valid ? inv_bit + (r7[6] > 0) : 0;
  const int passes = (nbits + 7) / 8;
  s_hist[tid] = 0;
  hist[table + j * RADIX + tid] = 0;
  if (leader) hist[table + (G + grp) * RADIX + tid] = 0;
  __syncthreads();
  for (int64_t t0 = lo; t0 < hi; t0 += TILE) {
    bool mk[ITEMS], live[ITEMS];
    float v[ITEMS][3];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t p = t0 + i * THREADS + tid;
      live[i] = p < hi;
      mk[i] = live[i] && mask[p];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[i][c] = live[i] ? xyz[p * 3 + c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t p = t0 + i * THREADS + tid;
      u64 klo = 0, khi = 0;
      if (mk[i]) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          put(klo, khi, (unsigned)cell_of(v[i][c], a.inv_leaf) - (unsigned)mn[c], off[c]);
      } else {
        put(klo, khi, 1u, inv_bit);
      }
      if (live[i]) {
        a.key[0][base + p] = make_ulonglong2(klo, khi);
        a.idx[0][base + p] = (int)p;
      }
      const unsigned d = live[i] ? (unsigned)(klo & 0xffu) : RADIX;
      const unsigned peers = __match_any_sync(FULL, d);
      if (live[i] && lane == __ffs(peers) - 1) atomicAdd(&s_hist[d], __popc(peers));
    }
  }
  __syncthreads();
  hist[j * RADIX + tid] = s_hist[tid];
  if (NG > 0 && s_hist[tid]) atomicAdd(hist + (G + grp) * RADIX + tid, s_hist[tid]);
  PROF(P_KEYS);
  lane_barrier(arrive, target, G);
  PROF(P_BARRIERS);

  // 3. the passes, least significant digit first; pass p reads count table
  // p % 3, counts into (p + 1) % 3 and zeroes (p + 2) % 3, which every block
  // read in pass p - 1
  int cur = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const ulonglong2* key = a.key[cur] + base;
    const int* idx = a.idx[cur] + base;
    ulonglong2* key_out = a.key[cur ^ 1] + base;
    int* idx_out = a.idx[cur ^ 1] + base;
    const int* counts = hist + (pass % 3) * table;
    int* next = hist + ((pass + 1) % 3) * table;
    const bool more = pass + 1 < passes;

    // a. the block's first position a digit: every smaller digit of the
    // lane, and this digit in the blocks before it (with groups: the groups
    // before its group, then its group's blocks before it)
    int before = 0, total = 0;
    const int rows = NG > 0 ? NG : G, first = NG > 0 ? G : 0, until = NG > 0 ? grp : j;
#pragma unroll 8
    for (int k = 0; k < rows; ++k) {
      const int h = __ldcg(counts + (first + k) * RADIX + tid);
      total += h;
      before += k < until ? h : 0;
    }
    if (NG > 0) {
#pragma unroll 4
      for (int k = grp * GROUP; k < j; ++k) before += __ldcg(counts + k * RADIX + tid);
    }
    s_off[tid] = block_exclusive(total, s_red) + before;
    int* spent = hist + ((pass + 2) % 3) * table;
    spent[j * RADIX + tid] = 0;
    if (leader) spent[(G + grp) * RADIX + tid] = 0;
    PROF(P_OFFSETS);

    // b. each tile ranked stably and scattered: a warp's items in position
    // order (i-major), the warps in order
    for (int64_t t0 = lo; t0 < hi; t0 += TILE) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s_cnt[w][tid] = 0;
      __syncthreads();
      ulonglong2 kv[ITEMS];
      int iv[ITEMS], rank[ITEMS];
      unsigned dv[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int64_t p = t0 + warp * (32 * ITEMS) + i * 32 + lane;
        kv[i] = make_ulonglong2(0, 0);
        iv[i] = 0;
        if (p < hi) {
          kv[i] = __ldcg(key + p);
          iv[i] = __ldcg(idx + p);
        }
        dv[i] = p < hi ? digit_of(kv[i], pass) : RADIX;
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const unsigned peers = __match_any_sync(FULL, dv[i]);
        const bool live = dv[i] < RADIX;
        const int prior = live ? s_cnt[warp][dv[i]] : 0;
        __syncwarp();
        if (live && lane == __ffs(peers) - 1) s_cnt[warp][dv[i]] = prior + __popc(peers);
        __syncwarp();
        rank[i] = prior + __popc(peers & lt);
      }
      __syncthreads();
      int run = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = s_cnt[w][tid];
        s_cnt[w][tid] = run;
        run += c;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const bool live = dv[i] < RADIX;
        int dst = 0;
        if (live) {
          dst = s_off[dv[i]] + s_cnt[warp][dv[i]] + rank[i];
          key_out[dst] = kv[i];
          idx_out[dst] = iv[i];
        }
        if (more) {
          // the next pass's counts: the block and the group the key lands
          // in, its next digit
          const unsigned to = (unsigned)(dst / range), d = digit_of(kv[i], pass + 1);
          const unsigned at = live ? to * RADIX + d : ~0u;
          unsigned peers = __match_any_sync(FULL, at);
          if (live && lane == __ffs(peers) - 1) atomicAdd(next + at, __popc(peers));
          if (NG > 0) {
            const unsigned gat = live ? (G + to / GROUP) * RADIX + d : ~0u;
            peers = __match_any_sync(FULL, gat);
            if (live && lane == __ffs(peers) - 1) atomicAdd(next + gat, __popc(peers));
          }
        }
      }
      __syncthreads();
      s_off[tid] += run;
    }
    PROF(P_SCATTER);
    lane_barrier(arrive, target, G);
    PROF(P_BARRIERS);
    cur ^= 1;
  }

  // 4. each valid segment's sums, in the block's order of starts: a warp
  // holds 32 consecutive positions an item (its row: t0 + i THREADS + 32 warp)
  const ulonglong2* key = a.key[cur] + base;
  const int* idx = a.idx[cur] + base;
  float4* sums = a.sums + base;
  int2* count_rep = a.count_rep + base;
  int starts = 0;  // the block's valid starts so far
  for (int64_t t0 = lo; t0 < hi; t0 += TILE) {
    ulonglong2 kv[ITEMS];
    int r[ITEMS];
    unsigned vstart[ITEMS], cont[ITEMS];
    {
      ulonglong2 prev[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int64_t p = t0 + i * THREADS + tid;
        kv[i] = prev[i] = make_ulonglong2(0, 0);
        r[i] = 0;
        if (p < hi) {
          kv[i] = __ldcg(key + p);
          r[i] = __ldcg(idx + p);
          if (lane == 0 && p > 0) prev[i] = __ldcg(key + p - 1);
        }
      }
      // starts and runs; a position past the lane's end is an invalid start
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int64_t p = t0 + i * THREADS + tid;
        const u64 px = __shfl_up_sync(FULL, kv[i].x, 1), py = __shfl_up_sync(FULL, kv[i].y, 1);
        if (lane > 0) prev[i] = make_ulonglong2(px, py);
        const bool live = p < hi, invalid = !live || bit_of(kv[i], inv_bit);
        const bool start = p == 0 || invalid || !same(prev[i], kv[i]);
        vstart[i] = __ballot_sync(FULL, live && start && !invalid);
        cont[i] = __ballot_sync(FULL, live && !start);
        if (lane == 0) s_tile[i * WARPS + warp] = __popc(vstart[i]);
        if (a.order && live) a.order[base + p] = r[i];
      }
    }
    float4 v[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int64_t p = t0 + i * THREADS + tid;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (p < hi) {
        const float* x = xyz + (int64_t)r[i] * 3;
        v[i] = make_float4(x[0], x[1], x[2], inten ? inten[r[i]] : 0.0f);
      }
    }
    __syncthreads();
    if (warp == 0) {
      int c[PER_LANE], own = 0;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) own += (c[u] = s_tile[PER_LANE * lane + u]);
      int incl = own;
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      int run = incl - own;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        s_tile[PER_LANE * lane + u] = run;
        run += c[u];
      }
      if (lane == 31) s_red[0] = incl;
    }
    // the runs within the warp's row, by shuffles in order
    float4 acc[ITEMS];
    float cnt[ITEMS];
    bool tail[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const bool mine = (vstart[i] >> lane) & 1u;
      // positions lane + 1 .. lane + len continue this one's run
      const unsigned after = lane < 31 ? cont[i] >> (lane + 1) : 0u;
      const int len = mine ? __ffs(~after) - 1 : 0;
      tail[i] = mine && lane + len == 31;
      acc[i] = make_float4(__fadd_rn(0.0f, v[i].x), __fadd_rn(0.0f, v[i].y),
                           __fadd_rn(0.0f, v[i].z), __fadd_rn(0.0f, v[i].w));
      cnt[i] = 1.0f;
      const int most = (int)__reduce_max_sync(FULL, (unsigned)len);
      for (int t = 1; t <= most; ++t) {
        const float x = __shfl_down_sync(FULL, v[i].x, t), y = __shfl_down_sync(FULL, v[i].y, t);
        const float z = __shfl_down_sync(FULL, v[i].z, t), w = __shfl_down_sync(FULL, v[i].w, t);
        if (t <= len) {
          acc[i].x = __fadd_rn(acc[i].x, x);
          acc[i].y = __fadd_rn(acc[i].y, y);
          acc[i].z = __fadd_rn(acc[i].z, z);
          acc[i].w = __fadd_rn(acc[i].w, w);
          cnt[i] = __fadd_rn(cnt[i], 1.0f);
        }
      }
    }
    // a run past the row's last lane (one an item at most): the warp reads
    // on 32 positions at a time, every item's at once, and the run's start
    // lane adds them in order
    bool more[ITEMS];
    int src[ITEMS];
    ulonglong2 run_key[ITEMS];
    int64_t q0[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const unsigned who = __ballot_sync(FULL, tail[i]);
      more[i] = who != 0;
      src[i] = more[i] ? __ffs(who) - 1 : 0;
      run_key[i] = make_ulonglong2(__shfl_sync(FULL, kv[i].x, src[i]),
                                   __shfl_sync(FULL, kv[i].y, src[i]));
      q0[i] = t0 + i * THREADS + warp * 32 + 32;
    }
    for (;;) {
      bool go = false;
      ulonglong2 kq[ITEMS];
      int rq[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int64_t pos = q0[i] + lane;
        kq[i] = make_ulonglong2(0, 0);
        rq[i] = 0;
        if (more[i] && pos < m) {
          kq[i] = __ldcg(key + pos);
          rq[i] = __ldcg(idx + pos);
        }
      }
      float4 vq[ITEMS];
      unsigned runs[ITEMS];
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const bool in = more[i] && q0[i] + lane < m && same(kq[i], run_key[i]);
        runs[i] = __ballot_sync(FULL, in);  // a prefix of the lanes: equal keys are adjacent
        vq[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (in) {
          const float* x = xyz + (int64_t)rq[i] * 3;
          vq[i] = make_float4(x[0], x[1], x[2], inten ? inten[rq[i]] : 0.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (!more[i]) continue;
        const int n = runs[i] == FULL ? 32 : __ffs(~runs[i]) - 1;
        for (int t = 0; t < n; ++t) {
          const float x = __shfl_sync(FULL, vq[i].x, t), y = __shfl_sync(FULL, vq[i].y, t);
          const float z = __shfl_sync(FULL, vq[i].z, t), w = __shfl_sync(FULL, vq[i].w, t);
          if (lane == src[i]) {
            acc[i].x = __fadd_rn(acc[i].x, x);
            acc[i].y = __fadd_rn(acc[i].y, y);
            acc[i].z = __fadd_rn(acc[i].z, z);
            acc[i].w = __fadd_rn(acc[i].w, w);
            cnt[i] = __fadd_rn(cnt[i], 1.0f);
          }
        }
        more[i] = n == 32;
        q0[i] += 32;
        go = go || more[i];
      }
      if (!go) break;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (!((vstart[i] >> lane) & 1u)) continue;
      const int64_t u = lo + starts + s_tile[i * WARPS + warp] + __popc(vstart[i] & lt);
      sums[u] = acc[i];
      count_rep[u] = make_int2(__float_as_int(cnt[i]), r[i]);
    }
    starts += s_red[0];
    __syncthreads();
  }
  if (tid == 0) part[j * PART + 7] = starts;
  PROF(P_SEGMENTS);
  lane_barrier(arrive, target, G);
  PROF(P_BARRIERS);

  // 5. the block's segments into their slots, then the empty slots
  int slot0 = 0, total = 0;
  for (int k = tid; k < G; k += THREADS) {
    const int c = __ldcg(part + k * PART + 7);
    total += c;
    if (k < j) slot0 += c;
  }
  slot0 = block_sum(slot0, s_red);
  total = block_sum(total, s_red);
  float* ox = a.out_xyz + (int64_t)b * s * 3;
  float* oi = a.out_intensity + (int64_t)b * s;
  uint8_t* ov = a.out_valid + (int64_t)b * s;
  int64_t* orep = a.out_rep + (int64_t)b * s;
  const int mine = min(starts, s - slot0);  // this block's segments with a slot
  for (int u0 = 0; u0 < mine; u0 += TILE) {
    float4 acc[ITEMS];
    int2 cr[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int u = u0 + i * THREADS + tid;
      if (u < mine) {
        acc[i] = __ldcg(sums + lo + u);
        cr[i] = __ldcg(count_rep + lo + u);
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int u = u0 + i * THREADS + tid;
      if (u >= mine) continue;
      const int64_t k = slot0 + u;
      const float c = __int_as_float(cr[i].x);
      ox[k * 3] = __fdiv_rn(acc[i].x, c);
      ox[k * 3 + 1] = __fdiv_rn(acc[i].y, c);
      ox[k * 3 + 2] = __fdiv_rn(acc[i].z, c);
      oi[k] = __fdiv_rn(acc[i].w, c);
      ov[k] = 1;
      orep[k] = cr[i].y;
    }
  }
  const int filled = min(total, s);
  for (int64_t k = filled + (int64_t)j * THREADS + tid; k < s; k += (int64_t)G * THREADS) {
    ox[k * 3] = PAD_COORD;
    ox[k * 3 + 1] = PAD_COORD;
    ox[k * 3 + 2] = PAD_COORD;
    oi[k] = 0.0f;
    ov[k] = 0;
    orep[k] = m;
  }
  PROF(P_SLOTS);
#ifdef LIORF_VOXEL_PROFILE
  if (prof_on) g_prof[P_PASSES] += passes;
#endif

  // the lane's last block to leave sets its counters back to 0
  __syncthreads();
  if (tid == 0 && atomicAdd(a.leave + b, 1u) == (unsigned)G - 1) {
    *arrive = 0;
    a.leave[b] = 0;
  }
}

long long g_launches = 0;
int g_max_blocks[256] = {};  // co-resident blocks of the kernel a device, once found

int max_blocks(int device, int* out) {
  if (g_max_blocks[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, voxel_filter_kernel,
                                                                    THREADS, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    g_max_blocks[device] = per_sm * sms;
  }
  *out = g_max_blocks[device];
  return 0;
}

struct Plan {
  int blocks, groups, chunk;  // blocks and groups a lane, tiles a block
};

// as many blocks as tiles, fewer (each over more tiles) where the lanes'
// blocks would not all be resident at once
int plan(int lanes, int m, int device, Plan* p) {
  int most = 0;
  const int err = max_blocks(device, &most);
  if (err) return err;
  const int per_lane = most / lanes;
  if (per_lane < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = m > 0 ? (m + TILE - 1) / TILE : 1;
  const int spread = tiles < per_lane ? tiles : per_lane;
  p->chunk = (tiles + spread - 1) / spread;
  p->blocks = (tiles + p->chunk - 1) / p->chunk;
  p->groups = p->blocks > GROUP ? (p->blocks + GROUP - 1) / GROUP : 0;
  return 0;
}

long long align16(long long n) { return (n + 15) & ~15ll; }

// the scratch's parts in order: key[0], key[1], sums, count_rep, idx[0],
// idx[1], part, hist
void layout(int lanes, int m, const Plan& p, long long* at) {
  const long long n = (long long)lanes * m;
  const long long size[8] = {16 * n, 16 * n, 16 * n, 8 * n, 4 * n, 4 * n,
                             4ll * lanes * p.blocks * PART,
                             3 * 4ll * lanes * (p.blocks + p.groups) * RADIX};
  long long o = 0;
  for (int i = 0; i < 8; ++i) {
    at[i] = o;
    o += align16(size[i]);
  }
  at[8] = o;
}

int with_device(int device, int* previous) {
  if (device < 0 || device >= 256) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetDevice(previous);
  if (err == cudaSuccess && *previous != device) err = cudaSetDevice(device);
  return (int)err;
}

}  // namespace

extern "C" {

long long liorf_voxel_filter_kernel_launches() { return g_launches; }

#ifdef LIORF_VOXEL_PROFILE
// The profiling build's sums (kProfParts: ns a part since the last read,
// then the passes), then every sum reset.
int liorf_voxel_filter_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfParts);
  if (err != cudaSuccess) return (int)err;
  const long long zero[kProfParts] = {};
  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}
#endif

// Bytes of the scratch liorf_voxel_filter takes for `lanes` lanes of m
// points on `device`, or -(CUDA error).
long long liorf_voxel_filter_scratch_bytes(int lanes, int m, int device) {
  int previous = 0;
  Plan p;
  int err = with_device(device, &previous);
  if (!err) err = plan(lanes, m, device, &p);
  if (previous != device) cudaSetDevice(previous);
  if (err) return -(long long)err;
  long long at[9];
  layout(lanes, m, p, at);
  return at[8];
}

// Every lane's filter in one launch on `stream` of `device`. `ptrs` holds 10
// addresses: xyz [lanes, m, 3] f32, intensity [lanes, m] f32 (or 0: zeros),
// mask [lanes, m] u8, the scratch (16-byte aligned,
// liorf_voxel_filter_scratch_bytes), out_xyz [lanes, s, 3] f32, out_intensity
// [lanes, s] f32, out_valid [lanes, s] u8, out_rep [lanes, s] i64, the
// sorted permutation [lanes, m] i64 (or 0), and 2 lanes u32 counters, 0
// between launches. m < 2^31 - 1.
int liorf_voxel_filter(const long long* ptrs, float inv_leaf, int lanes, int m, int s, int device,
                       void* stream) {
  if (lanes == 0 || s == 0) return 0;
  int previous = 0;
  int err = with_device(device, &previous);
  Plan plan_;
  if (!err) err = plan(lanes, m, device, &plan_);
  if (!err) {
    const void* const* p = reinterpret_cast<const void* const*>(ptrs);
    Args a;
    a.xyz = (const float*)p[0];
    a.intensity = (const float*)p[1];
    a.mask = (const uint8_t*)p[2];
    char* scratch = (char*)p[3];
    a.out_xyz = (float*)p[4];
    a.out_intensity = (float*)p[5];
    a.out_valid = (uint8_t*)p[6];
    a.out_rep = (int64_t*)p[7];
    a.order = (int64_t*)p[8];
    a.arrive = (unsigned*)p[9];
    a.leave = a.arrive + lanes;
    long long at[9];
    layout(lanes, m, plan_, at);
    a.key[0] = (ulonglong2*)(scratch + at[0]);
    a.key[1] = (ulonglong2*)(scratch + at[1]);
    a.sums = (float4*)(scratch + at[2]);
    a.count_rep = (int2*)(scratch + at[3]);
    a.idx[0] = (int*)(scratch + at[4]);
    a.idx[1] = (int*)(scratch + at[5]);
    a.part = (int*)(scratch + at[6]);
    a.hist = (int*)(scratch + at[7]);
    a.inv_leaf = inv_leaf;
    a.m = m;
    a.s = s;
    a.lanes = lanes;
    a.blocks = plan_.blocks;
    a.groups = plan_.groups;
    a.chunk = plan_.chunk;
    void* args[] = {&a};
    err = (int)cudaLaunchCooperativeKernel((const void*)voxel_filter_kernel,
                                           dim3((unsigned)(lanes * plan_.blocks)), dim3(THREADS),
                                           args, 0, (cudaStream_t)stream);
    if (!err) {
      ++g_launches;
      err = (int)cudaGetLastError();
    }
  }
  if (previous != device) cudaSetDevice(previous);
  return err;
}

}  // extern "C"
