// The pose graph's block-Jacobi preconditioned conjugate gradients, every
// iteration in one launch, for NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/pcg.py with the flags of core/build.py and loaded with ctypes;
// launches on the stream it is given, allocates nothing (the wrapper hands
// it its scratch), never synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package runs this loop as one lax.scan
// (liorf_tpu/graph/pose_graph.py:220-253), one device program with no host
// in it. Op by op on the card the loop issued ~59 launches an iteration
// (two fixed-order dots, a segment sum, the products around them), each
// ~8 us of host time for microseconds of work. Here one thread-block
// cluster per lane runs all `iters` iterations: the scalars (rz, denom,
// alpha, beta) never leave the chip, and nothing returns to the host.
//
// It solves (H + damping I) x = rhs, H = sum over factors of J^T J, with
// the block-Jacobi preconditioner Minv [K,6,6] (inverted by the caller):
//
//   x = 0, r = rhs, z = Minv r, p = z, rz = <r, z>
//   repeat iters times:
//     Ap = H p + damping p;  denom = <p, Ap>
//     alpha = |denom| > 1e-20 ? rz / denom : 0
//     x += alpha p;  r -= alpha Ap;  z = Minv r;  rz' = <r, z>
//     beta = |rz| > 1e-20 ? rz' / rz : 0;  p = z + beta p;  rz = rz'
//
// The order contract (ops/pcg.py::pcg_solve_plain spells it in torch ops,
// which on CPU tensors round every operation as this kernel does, so the
// two are equal bit for bit): every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn: nvcc would contract to FMAs); each per-factor
// product (J x, J^T y, Minv r) accumulates from 0.0f over its 6 (GPS: 3)
// terms in index order; each node's sum of the matvec walks its rows in the
// SegmentPlan's stable sorted order from 0.0f (csrc/segment_sum.cu's
// contract); each dot is fixed_dot's: chunks of 32 consecutive products
// summed in order from 0.0f, then an adjacent-pair tree over the chunk sums
// padded with zeros to a power of two. No sum depends on the thread
// schedule, the cluster size or the capacity: a ring's unused slots (zero
// rows, zero nodes) change no bit.
//
// Layout of one lane's work over a cluster of C blocks:
//   * factors (edges, GPS, the prior) in C contiguous blocks: the owner of
//     a factor computes y = J p and its rows' contributions J^T y, 8 lanes
//     of a warp a factor (6 used; y passes between them by shuffles);
//   * nodes in C contiguous blocks of a multiple of 16 nodes (96 elements,
//     3 chunks of the dot): a block's elements start on a chunk, and with
//     blockDim a multiple of 32 every warp holds exactly one chunk, whose
//     ordered sum is 32 shuffles. The owner of a node sums its matvec rows,
//     updates x, r, z, p there, and writes its chunk sums;
//   * every warp of every block reduces all chunk sums by the same tree
//     (each lane an aligned run, then 5 shuffle levels), so each holds the
//     same scalars without a second exchange.
// Where a lane's arrays live (one kernel instantiation a layout): on chip
// where the lane fits a block's shared memory (the main window, the
// resident full solve at clusters of 8), z, p and the chunk sums are
// replicated in every block of the cluster (the owner writes each element to
// all of them through distributed shared memory, cluster.map_shared_rank),
// so every read of them is local; each block's own x, r, Ap, node indices and
// preconditioner blocks, its factors' Jacobians and nodes, loaded once a
// launch, and its nodes' matvec rows sit in its own shared memory: a
// factor's owner stores J^T y into the node owner's row buffer through
// distributed shared memory, at the slot the owner gave it when it compacted
// its rows. Else (a grown ring) one copy of each vector lives in device
// memory and is read through L2 (__ldcg, never a stale L1 line), the factors
// are read through L1 (__ldg) and the rows go through device memory. Both
// layouts give the same bits.
// A factor row whose Jacobian is all zero (an unused ring slot, a masked or
// frozen factor) adds an exact +0.0 to its node (a sum from +0.0 is never
// -0.0), so once a launch each node's sorted rows are compacted to those
// with a nonzero Jacobian, in order (a warp a node, by ballots): the walk
// skips nothing that could change a bit, and the unused slots, which all
// name node 0, no longer make node 0's walk thousands of rows long. Zero
// factors are skipped in the factor phase as well. (With non-finite inputs
// a zero row would add NaN; the solve never sees them.)
// A node with no nonzero row and a zero right-hand side (an unused slot, a
// frozen node) stays +0.0 in x, r, z, p and Ap, and its chunks add +0.0 to
// both dots, so on chip a warp skips a chunk with no live node after the
// start.
// Per iteration three cluster barriers: after the factors (the matvec's
// rows), after the node sums (<p, Ap>), after the preconditioner (<r, z>);
// each warp reduces the dots' chunk sums itself, with no block barrier.
// The next direction p is made where it is read: a factor's owner forms
// z + beta p at its endpoints from z and the previous p (double-buffered),
// the same rounded operations as the node's owner, so no fourth barrier.
//
// What bounds it: neither bytes nor operations (about 10 MFLOP and 0.6 MB
// a solve at the resident default's arguments, well under a microsecond at
// the card's rates) but the chain of dependent phases an iteration: three
// cluster barriers, the factor phase (each lane forms both endpoints'
// directions and two 6x6 products), the node sums, the two dots' trees and
// the replication of z and p (8 remote stores an element). chip_smoke.py's
// pcg_profile phase times every cluster size, then each phase by clock
// cycles (a build with -DLIORF_PCG_PROFILE), with z and p replicated and,
// in a build with -DLIORF_PCG_REMOTE_P, read at a factor's endpoints from
// their owner's shared memory instead; clusters of 8 were the fastest or
// tied at every size it measured (ops/pcg.py::CLUSTER).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // fixed_dot's chunk (ops/segment_sum.py)
constexpr int kNodeQuantum = 16;  // 16 nodes = 96 elements = 3 chunks
constexpr int kLiveChunks = 512;  // a block's chunks whose liveness it keeps
constexpr unsigned kFull = 0xffffffffu;
// A block's shared memory (232448 bytes on an H100) less room for the
// kernel's static shared memory (the chunks' liveness, kLiveChunks bytes).
constexpr long long kMaxDynamicShared = 232448 - 1024;

struct Args {
  const float* Ji;    // [B, E, 6, 6]
  const float* Jj;    // [B, E, 6, 6]
  const float* Jg;    // [B, G, 3, 6]
  const float* Jp;    // [B, 6, 6]
  const int64_t* ei;  // [B, E]
  const int64_t* ej;  // [B, E]
  const int64_t* gi;  // [B, G]
  const int64_t* pi;  // [B, 1]
  const int64_t* keys;  // [B, M] sorted node of each plan row
  const int64_t* perm;  // [B, M] plan row (Ji rows, Jj rows, GPS, prior)
  const float* Minv;  // [B, K, 6, 6]
  const float* rhs;   // [B, K, 6]
  float* x;           // [B, K, 6] out
  float* scratch;     // [B, scratch_floats(K, E, G)]
  int32_t* iscratch;  // [B, iscratch_ints(K, E, G)]
  int K, E, G, iters;
  float damping;
};

// Where a lane's arrays live (lane_layout): everything in shared memory (the
// vectors, the block's factors, their nodes and the matvec's rows), or
// nothing (device memory).
constexpr int kDeviceMemory = 0, kOnChip = 1;

__host__ __device__ inline long long chunks_of(long long K) { return (6 * K + kChunk - 1) / kChunk; }

__host__ __device__ inline long long pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// One lane's scratch in device memory, in floats: z, p (two buffers) [6K
// each], the chunk sums of both dots [nch each], r, Ap [6K each] (all these
// used only when the lane does not fit in shared memory), and the matvec's
// rows [6M].
__host__ __device__ inline long long scratch_floats(long long K, long long E, long long G) {
  return 5 * 6 * K + 2 * chunks_of(K) + 6 * (2 * E + G + 1);
}

// One lane's integer scratch: each node's first sorted row [K + 1] and
// count of nonzero rows [K]; a flag a plan row (nonzero Jacobian) [M]; the
// compacted rows [M] (node k's at [first[k], first[k] + count[k])).
__host__ __device__ inline long long iscratch_ints(long long K, long long E, long long G) {
  return 2 * K + 1 + 2 * (2 * E + G + 1);
}

// Nodes a block owns: a multiple of 16, the same in every block.
__host__ __device__ inline long long node_block(long long K, int C) {
  return (K + (long long)kNodeQuantum * C - 1) / ((long long)kNodeQuantum * C) * kNodeQuantum;
}

// A block's shared memory, when the lane fits (offsets in 4-byte words):
// replicated in every block of the cluster, z [6K], p [2][6K] and the chunk
// sums of both dots [nch each]; the block's own x, r, Ap [6 Kb each]; its
// nodes' first sorted rows [Kb + 1] and counts [Kb], its compacted rows
// [M], its factors' flags [2 Eb + Gb + 1]; its factors' Jacobians (Ji [Eb][36], Jj [Eb][36], Jg [Gb][18],
// the prior's [36]), their nodes (i [Eb], j [Eb], GPS [Gb]), where each of
// their rows goes [2 Eb + Gb + 1] (8 x its place in its node owner's row
// buffer + that block's rank; -1: a zero row), the row buffer of its own
// nodes' compacted rows [6 M] and its nodes' preconditioner blocks [36 Kb].
struct Layout {
  long long z, p0, p1, cs_pap, cs_rz, x, r, ap, first, count, crow, nzf;
  long long jac, fnode, fdest, rows, minv, words;
};

__host__ __device__ inline Layout shared_layout(long long K, long long E, long long G, int C) {
  const long long Kb = node_block(K, C), Eb = (E + C - 1) / C, Gb = (G + C - 1) / C;
  const long long n6 = 6 * K, nch = chunks_of(K);
  Layout l;
  l.z = 0;
  l.p0 = n6;
  l.p1 = 2 * n6;
  l.cs_pap = 3 * n6;
  l.cs_rz = l.cs_pap + nch;
  l.x = l.cs_rz + nch;
  l.r = l.x + 6 * Kb;
  l.ap = l.r + 6 * Kb;
  l.first = l.ap + 6 * Kb;
  l.count = l.first + Kb + 1;
  l.crow = l.count + Kb;
  l.nzf = l.crow + 2 * E + G + 1;
  l.jac = (l.nzf + 2 * Eb + Gb + 1 + 3) & ~3LL;
  l.fnode = l.jac + 72 * Eb + 18 * Gb + 36;
  l.fdest = l.fnode + 2 * Eb + Gb;
  l.rows = l.fdest + 2 * Eb + Gb + 1;
  l.minv = l.rows + 6 * (2 * E + G + 1);
  l.words = l.minv + 36 * Kb;
  return l;
}

// On chip where the lane's shared memory fits a block, else device memory.
inline int lane_layout(long long K, long long E, long long G, int C) {
  return shared_layout(K, E, G, C).words * 4 <= kMaxDynamicShared ? kOnChip : kDeviceMemory;
}

// A block's dynamic shared memory in bytes (0 in device memory).
inline long long shared_bytes(long long K, long long E, long long G, int C) {
  return lane_layout(K, E, G, C) == kOnChip ? 4 * shared_layout(K, E, G, C).words : 0;
}

#ifdef LIORF_PCG_REMOTE_P
// Development only (built with -DLIORF_PCG_REMOTE_P): on chip, z and p are
// written only to their owner's block and read at a factor's endpoints from
// there through distributed shared memory, in place of their replication
// (the same values, so the same bits).
constexpr bool kRemoteP = true;
#else
constexpr bool kRemoteP = false;
#endif

// A read-only index (int64_t is long here; __ldg takes long long).
__device__ __forceinline__ long long ld_index(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int lower_bound(const int64_t* __restrict__ keys, int m, long long v) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ld_index(keys + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The ordered sum of one warp's 32 values, lane 0's first, from 0.0f: a
// chunk of fixed_dot. Every lane gets it.
__device__ __forceinline__ float chunk_sum(float v) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) acc = __fadd_rn(acc, __shfl_sync(kFull, v, j));
  return acc;
}

// The adjacent-pair tree over the 32 lanes' values (lane 0 gets it).
__device__ __forceinline__ float warp_tree(float v, int lane) {
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) {
    const float o = __shfl_down_sync(kFull, v, w);
    if ((lane & (2 * w - 1)) == 0) v = __fadd_rn(v, o);
  }
  return v;
}

// fixed_dot's tree over the chunk sums cs[0, nch) padded with zeros to P (a
// power of two), by one warp; lane 0 gets the result. When P <= 32 * 16
// (K <= 2730 nodes) lane l reads its aligned run of L = P / 32 sums at once
// (L <= 16; or one sum, zero past P, when P < 32), reduces it in registers
// padded with zeros to 16, and 5 shuffle levels join the lanes: zeros past
// an aligned power-of-two run join by exact additions of 0. Past that,
// rows of 32 consecutive sums (aligned subtrees) are read by the 32 lanes
// four rows at a time, reduced by the shuffle levels, and joined by lane 0
// as a binary counter (each completed pair of equal subtrees merges).
__device__ float chunk_tree(const float* cs, long long nch, long long P, int lane, bool sh) {
  constexpr int kRun = 16;
  if (P <= 32 * kRun) {
    const int L = P >= 32 ? (int)(P / 32) : 1;
    float v[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const long long at = (long long)lane * L + j;
      v[j] = (j < L && at < nch) ? (sh ? cs[at] : __ldcg(cs + at)) : 0.0f;
    }
#pragma unroll
    for (int w = 1; w < kRun; w <<= 1)
#pragma unroll
      for (int j = 0; j < kRun; j += 2 * w) v[j] = __fadd_rn(v[j], v[j + w]);
    return warp_tree(v[0], lane);
  }
  const long long rows = P / 32;
  float stack[40];
  float top = 0.0f;
  for (long long j0 = 0; j0 < rows; j0 += 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long at = (j0 + u) * 32 + lane;
      v[u] = (j0 + u < rows && at < nch) ? (sh ? cs[at] : __ldcg(cs + at)) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u >= rows) break;
      float t = warp_tree(v[u], lane);
      if (lane == 0) {
        const long long j = j0 + u;
        int level = 0;
        while ((j >> level) & 1) {
          t = __fadd_rn(stack[level], t);
          ++level;
        }
        stack[level] = t;
        top = t;  // after the last row (rows a power of two): the whole tree
      }
    }
  }
  return top;
}

// The tree's result in every thread of the block: each warp reduces the
// chunk sums itself (the same tree, so the same bits), with no barrier.
__device__ __forceinline__ float block_dot(const float* cs, long long nch, long long P, bool sh) {
  const int lane = threadIdx.x & 31;
  return __shfl_sync(kFull, chunk_tree(cs, nch, P, lane, sh), 0);
}

#ifdef LIORF_PCG_PROFILE
// Development only (built with -DLIORF_PCG_PROFILE): clock cycles thread 0
// of block 0 spends in each phase, summed over the iterations.
__device__ long long g_prof[16];
#define PROF(n)                                               \
  do {                                                        \
    const long long now_ = clock64();                         \
    prof_[n] += now_ - prof_last_;                            \
    prof_last_ = now_;                                        \
  } while (0)
#else
#define PROF(n) \
  do {          \
  } while (0)
#endif

// One instantiation a layout: each carries only its own loads and stores.
template <int kLayout>
__global__ void __launch_bounds__(kThreads) pcg_kernel(Args a) {
  extern __shared__ __align__(16) float pcg_smem[];
#ifdef LIORF_PCG_PROFILE
  long long prof_[16] = {0};
  long long prof_last_ = clock64();
#endif
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long b = blockIdx.x / C;  // the lane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, E = a.E, G = a.G;
  const int M = 2 * E + G + 1;
  const long long n6 = 6LL * K;
  const long long nch = chunks_of(K);
  const long long P = pow2_at_least(nch);
  constexpr bool chip = kLayout == kOnChip, remote = chip && kRemoteP;

  // this lane's arrays
  const float* Ji = a.Ji + b * E * 36;
  const float* Jj = a.Jj + b * E * 36;
  const float* Jg = a.Jg + b * G * 18;
  const float* Jp = a.Jp + b * 36;
  const int64_t* ei = a.ei + b * E;
  const int64_t* ej = a.ej + b * E;
  const int64_t* gi = a.gi + b * G;
  const long long pnode = ld_index(a.pi + b);
  const int64_t* keys = a.keys + b * M;
  const int64_t* perm = a.perm + b * M;
  const float* Minv = a.Minv + b * n6 * 6;
  const float* rhs = a.rhs + b * n6;
  float* x = a.x + b * n6;

  // this block's nodes [k0, k1), and the whole chunks [c0, c1) of elements
  // that hold them (c0 and c1 multiples of 32: a warp a chunk)
  const int Kb = (int)node_block(K, C);
  const int k0 = min(rank * Kb, K), k1 = min(rank * Kb + Kb, K);
  const long long c0 = 6LL * rank * Kb;
  const long long c1 = min(c0 + 6LL * Kb, nch * kChunk);
  const long long e0 = 6LL * k0, e1 = 6LL * k1;  // its elements
  // this block's factors
  const int Eb = (E + C - 1) / C, Gb = (G + C - 1) / C;
  const int f0 = min(rank * Eb, E), f1 = min(f0 + Eb, E);
  const int g0 = min(rank * Gb, G), g1 = min(g0 + Gb, G);
  const int n_prior = rank == 0 ? 1 : 0;
  // the first sorted row of its first node
  const int s0 = lower_bound(keys, M, k0);

  // Where things live. In device memory always: every plan row's flag. On
  // chip: z, p and the chunk sums replicated in every block (written to all
  // of them through distributed shared memory, so every read is local), the
  // block's own vectors and indices, its factors (their Jacobians, nodes and
  // row destinations) and its nodes' rows; else one copy of each vector in
  // device memory, read through L2, the factors read through L1 and the
  // rows through device memory. Own arrays are indexed from the block's
  // first element / node / sorted row / factor.
  float* gs = a.scratch + b * scratch_floats(K, E, G);
  int32_t* gi32 = a.iscratch + b * iscratch_ints(K, E, G);
  float* rows = gs + 5 * n6 + 2 * nch;
  int32_t* nz = gi32 + 2 * K + 1;
  float *zr, *pr[2], *cs_pap, *cs_rz, *xo, *ro, *apo;
  int32_t *first_o, *count_o, *crow_o, *nz_i, *nz_j, *nz_g;
  float *jac = nullptr, *rowbuf = nullptr, *minv = nullptr;
  int32_t *fnode = nullptr, *fdest = nullptr;
  if (chip) {
    const Layout l = shared_layout(K, E, G, C);
    float* f = pcg_smem;
    int32_t* w = reinterpret_cast<int32_t*>(pcg_smem);
    zr = f + l.z; pr[0] = f + l.p0; pr[1] = f + l.p1; cs_pap = f + l.cs_pap; cs_rz = f + l.cs_rz;
    xo = f + l.x; ro = f + l.r; apo = f + l.ap;
    first_o = w + l.first; count_o = w + l.count; crow_o = w + l.crow;
    nz_i = w + l.nzf; nz_j = nz_i + Eb; nz_g = nz_j + Eb;
    jac = f + l.jac; fnode = w + l.fnode; fdest = w + l.fdest; rowbuf = f + l.rows;
    minv = f + l.minv;
  } else {
    zr = gs; pr[0] = gs + n6; pr[1] = gs + 2 * n6; cs_pap = gs + 3 * n6; cs_rz = cs_pap + nch;
    xo = x + e0; ro = cs_rz + nch + e0; apo = cs_rz + nch + n6 + e0;
    first_o = gi32 + k0; count_o = gi32 + K + 1 + k0; crow_o = nz + M + s0;
    nz_i = nz + f0; nz_j = nz + E + f0; nz_g = nz + 2 * E + g0;
  }
  // a read of what other blocks write, and a write every block reads
  auto ld = [&](const float* q) { return chip ? *q : __ldcg(q); };
  auto put_all = [&](float* base, long long i, float v) {
    if (chip) {
      for (int q = 0; q < C; ++q) cluster.map_shared_rank(base, q)[i] = v;
    } else {
      base[i] = v;
    }
  };
  // z or p: to every block, or (remote) to the owner's alone
  auto put_vec = [&](float* base, long long i, float v) {
    if (remote) base[i] = v; else put_all(base, i, v);
  };
  // element i of z or p at a factor's endpoint (remote: from its owner)
  auto ld_vec = [&](const float* base, long long i) {
    if (remote) return *cluster.map_shared_rank(base + i, (int)(i / (6LL * Kb)));
    return ld(base + i);
  };
  // a read of a factor's Jacobian (on chip: the block's own copy)
  auto ldJ = [&](const float* q) { return chip ? *q : __ldg(q); };
  // a row of J^T y into its node owner's row buffer (d: fdest's entry)
  auto put_row = [&](int d, int q, float v) {
    if (d >= 0) cluster.map_shared_rank(rowbuf, d & 7)[(d >> 3) * 6 + q] = v;
  };

  // --- start: x = 0, r = rhs, each node's first sorted row, each factor
  // row's flag (a nonzero Jacobian)
  for (long long i = e0 + tid; i < e1; i += kThreads) {
    xo[i - e0] = 0.0f;
    ro[i - e0] = __ldg(rhs + i);
  }
  for (int k = k0 + tid; k <= k1; k += kThreads) first_o[k - k0] = lower_bound(keys, M, k);
  if (chip) {  // the block's factors, once a launch
    const int ne = f1 - f0, ng = g1 - g0;
    for (int j = tid; j < ne * 36; j += kThreads) {
      jac[j] = __ldg(Ji + (long long)f0 * 36 + j);
      jac[Eb * 36 + j] = __ldg(Jj + (long long)f0 * 36 + j);
    }
    for (int j = tid; j < ng * 18; j += kThreads) jac[72 * Eb + j] = __ldg(Jg + (long long)g0 * 18 + j);
    if (n_prior && tid < 36) jac[72 * Eb + 18 * Gb + tid] = __ldg(Jp + tid);
    for (int e = tid; e < ne; e += kThreads) {
      fnode[e] = (int)ld_index(ei + f0 + e);
      fnode[Eb + e] = (int)ld_index(ej + f0 + e);
    }
    for (int g = tid; g < ng; g += kThreads) fnode[2 * Eb + g] = (int)ld_index(gi + g0 + g);
    for (int j = tid; j < 2 * Eb + Gb + 1; j += kThreads) fdest[j] = -1;
    for (int j = tid; j < (k1 - k0) * 36; j += kThreads) minv[j] = __ldg(Minv + (long long)k0 * 36 + j);
  }
  // a factor's flags, a warp a factor: its Jacobian's n entries read at once
  auto nonzero = [&](const float* J, int n) {
    return __any_sync(kFull, (lane < n && __ldg(J + lane) != 0.0f) ||
                                 (lane + 32 < n && __ldg(J + lane + 32) != 0.0f));
  };
  for (int e = f0 + warp; e < f1; e += kWarps) {
    const bool ni = nonzero(Ji + (long long)e * 36, 36), nj = nonzero(Jj + (long long)e * 36, 36);
    if (lane == 0) {
      nz[e] = nz_i[e - f0] = ni;
      nz[E + e] = nz_j[e - f0] = nj;
    }
  }
  for (int g = g0 + warp; g < g1; g += kWarps) {
    const bool n = nonzero(Jg + (long long)g * 18, 18);
    if (lane == 0) nz[2 * E + g] = nz_g[g - g0] = n;
  }
  if (n_prior && warp == 0) {
    const bool n = nonzero(Jp, 36);
    if (lane == 0) nz[2 * E + G] = n;
  }
  // the replicated p and <p, Ap>'s chunk sums start at +0.0: an element or a
  // chunk that never changes (below) is never written again
  if (chip) {
    for (long long i = tid; i < n6; i += kThreads) pr[0][i] = pr[1][i] = 0.0f;
    for (long long i = tid; i < nch; i += kThreads) cs_pap[i] = 0.0f;
  }
  cluster.sync();
  // each node's nonzero rows in sorted order, a warp a node; on chip each
  // kept row's place in this block's row buffer goes to its factor's owner
  for (int k = k0 + warp; k < k1; k += kWarps) {
    const int lo = first_o[k - k0], hi = first_o[k - k0 + 1];
    int n = 0;
    for (int base = lo; base < hi; base += 32) {
      const int s = base + lane;
      const int row = s < hi ? (int)ld_index(perm + s) : 0;
      const bool keep = s < hi && __ldcg(nz + row) != 0;
      const unsigned ballot = __ballot_sync(kFull, keep);
      if (keep) {
        const int at = lo - s0 + n + __popc(ballot & ((1u << lane) - 1u));
        crow_o[at] = row;
        if (chip) {  // the factor's owner and the row's slot among its rows
          int q = 0, slot = 2 * Eb + Gb;  // the prior: block 0
          if (row < E) {
            q = row / Eb; slot = row - q * Eb;
          } else if (row < 2 * E) {
            q = (row - E) / Eb; slot = Eb + row - E - q * Eb;
          } else if (row < 2 * E + G) {
            q = (row - 2 * E) / Gb; slot = 2 * Eb + row - 2 * E - q * Gb;
          }
          cluster.map_shared_rank(fdest, q)[slot] = at * 8 + rank;
        }
      }
      n += __popc(ballot);
    }
    if (lane == 0) count_o[k - k0] = n;
  }
  __syncthreads();
  // A node with no nonzero row and a zero right-hand side keeps x, r, z, p
  // and Ap at +0.0 through every iteration (each update adds a +-0.0 to a
  // +0.0), and a chunk of such nodes adds +0.0 to both dots: so a chunk
  // (a warp's 32 elements) with no live node is skipped after the start,
  // its values left as the start made them (an unused ring slot, a frozen
  // node). Kept on chip.
  __shared__ unsigned char s_live[kLiveChunks];
  const bool skip = chip && (c1 - c0) / kChunk <= kLiveChunks;
  if (skip)
    for (long long i = c0 + tid; i < c1; i += kThreads) {
      bool live = false;
      if (i < e1) {
        const long long k = i / 6;
        live = count_o[k - k0] > 0;
#pragma unroll
        for (int c = 0; c < 6; ++c) live |= ro[6 * k + c - e0] != 0.0f;
      }
      const unsigned any = __ballot_sync(kFull, live);
      if (lane == 0) s_live[(i - c0) / kChunk] = any != 0;
    }
  __syncthreads();
  // a warp's chunk of this block's elements that can be skipped
  auto dead = [&](long long i) { return skip && !s_live[(i - c0) / kChunk]; };

  auto precondition = [&](bool skipping) {  // z = Minv r on this block's nodes, <r, z>'s chunks
    for (long long i = c0 + tid; i < c1; i += kThreads) {
      if (skipping && dead(i)) continue;
      float prod = 0.0f;
      if (i < n6) {
        const long long k = i / 6;
        const int c = (int)(i - 6 * k);
        const float* Mk = chip ? minv + (k - k0) * 36 + c * 6 : Minv + k * 36 + c * 6;
        const float* rk = ro + 6 * k - e0;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) acc = __fadd_rn(acc, __fmul_rn(ldJ(Mk + j), rk[j]));
        put_vec(zr, i, acc);
        prod = __fmul_rn(ro[i - e0], acc);
      }
      const float s = chunk_sum(prod);
      if (lane == 0) put_all(cs_rz, i / kChunk, s);
    }
  };
  precondition(false);
  cluster.sync();
  PROF(11);

  float rz = 0.0f, beta = 0.0f;
  for (int it = 0; it < a.iters; ++it) {
    const bool it0 = it == 0;
    float* p = pr[it & 1];
    const float* p_prev = pr[(it + 1) & 1];
    // element i of this iteration's direction, made from z and the previous
    // p exactly as the node's owner makes it (own: one of this block's)
    auto direction = [&](long long i, bool own = false) {
      const float zi = own ? ld(zr + i) : ld_vec(zr, i);
      return it0 ? zi : __fadd_rn(zi, __fmul_rn(beta, own ? ld(p_prev + i) : ld_vec(p_prev, i)));
    };

    // --- phase 1: rz' and beta; p on this block's nodes; the matvec's rows
    const float t = block_dot(cs_rz, nch, P, chip);
    PROF(0);
    if (it0) {
      rz = t;
    } else {
      beta = fabsf(rz) > 1e-20f ? __fdiv_rn(t, rz) : 0.0f;
      rz = t;
    }
    for (long long i = e0 + tid; i < e1; i += kThreads)
      if (!dead(i)) put_vec(p, i, direction(i, true));
    PROF(1);

    const int grp = lane >> 3, q = lane & 7;
    // between factors: y = Ji p_i + Jj p_j; rows e and E + e are Ji^T y, Jj^T y
    for (int base = f0 + warp * 4; base < f1; base += kWarps * 4) {
      const int e = base + grp;
      const bool valid = e < f1 && (nz_i[e - f0] | nz_j[e - f0]);
      const int el = valid ? e - f0 : 0;
      float y = 0.0f;
      const float* Je_i = chip ? jac + el * 36 : Ji + (long long)(f0 + el) * 36;
      const float* Je_j = chip ? jac + (Eb + el) * 36 : Jj + (long long)(f0 + el) * 36;
      long long ni = 0, nj = 0;
      if (valid && q < 6) {
        ni = chip ? fnode[el] : ld_index(ei + e);
        nj = chip ? fnode[Eb + el] : ld_index(ej + e);
        float pi_[6], pj_[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          pi_[c] = direction(ni * 6 + c);
          pj_[c] = direction(nj * 6 + c);
        }
        float yi = 0.0f, yj = 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c) yi = __fadd_rn(yi, __fmul_rn(ldJ(Je_i + q * 6 + c), pi_[c]));
#pragma unroll
        for (int c = 0; c < 6; ++c) yj = __fadd_rn(yj, __fmul_rn(ldJ(Je_j + q * 6 + c), pj_[c]));
        y = __fadd_rn(yi, yj);
      }
      float yr[6];
#pragma unroll
      for (int s = 0; s < 6; ++s) yr[s] = __shfl_sync(kFull, y, s, 8);
      if (valid && q < 6) {
        float ci = 0.0f, cj = 0.0f;
#pragma unroll
        for (int s = 0; s < 6; ++s) ci = __fadd_rn(ci, __fmul_rn(ldJ(Je_i + s * 6 + q), yr[s]));
#pragma unroll
        for (int s = 0; s < 6; ++s) cj = __fadd_rn(cj, __fmul_rn(ldJ(Je_j + s * 6 + q), yr[s]));
        if (chip) {  // into the node owners' row buffers (a zero row has no slot)
          put_row(fdest[el], q, ci);
          put_row(fdest[Eb + el], q, cj);
        } else {
          rows[(long long)e * 6 + q] = ci;
          rows[(long long)(E + e) * 6 + q] = cj;
        }
      }
    }
    PROF(2);
    // GPS factors: y = Jg p (3 rows); row 2E + g is Jg^T y (from the last
    // warp down, so a block's few GPS slots and its edges take other warps)
    for (int base = g0 + (kWarps - 1 - warp) * 4; base < g1; base += kWarps * 4) {
      const int g = base + grp;
      const bool valid = g < g1 && nz_g[g - g0];
      const int gl = valid ? g - g0 : 0;
      const float* Jq = chip ? jac + 72 * Eb + gl * 18 : Jg + (long long)(g0 + gl) * 18;
      const long long ng = valid ? (chip ? fnode[2 * Eb + gl] : ld_index(gi + g)) : 0;
      float y = 0.0f;
      if (valid && q < 3) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
          y = __fadd_rn(y, __fmul_rn(ldJ(Jq + q * 6 + c), direction(ng * 6 + c)));
      }
      float yr[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) yr[s] = __shfl_sync(kFull, y, s, 8);
      if (valid && q < 6) {
        float cgv = 0.0f;
#pragma unroll
        for (int s = 0; s < 3; ++s) cgv = __fadd_rn(cgv, __fmul_rn(ldJ(Jq + s * 6 + q), yr[s]));
        if (chip) {
          put_row(fdest[2 * Eb + gl], q, cgv);
        } else {
          rows[(long long)(2 * E + g) * 6 + q] = cgv;
        }
      }
    }
    // the prior: y = Jp p; row 2E + G is Jp^T y (block 0's middle warp)
    if (n_prior && warp == kWarps / 2) {
      const float* Jq = chip ? jac + 72 * Eb + 18 * Gb : Jp;
      float y = 0.0f;
      if (grp == 0 && q < 6) {
        const long long np = pnode * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c)
          y = __fadd_rn(y, __fmul_rn(ldJ(Jq + q * 6 + c), direction(np + c)));
      }
      float yr[6];
#pragma unroll
      for (int s = 0; s < 6; ++s) yr[s] = __shfl_sync(kFull, y, s, 8);
      if (grp == 0 && q < 6) {
        float cpv = 0.0f;
#pragma unroll
        for (int s = 0; s < 6; ++s) cpv = __fadd_rn(cpv, __fmul_rn(ldJ(Jq + s * 6 + q), yr[s]));
        if (chip) {
          put_row(fdest[2 * Eb + Gb], q, cpv);
        } else {
          rows[(long long)(2 * E + G) * 6 + q] = cpv;
        }
      }
    }
    PROF(3);
    cluster.sync();
    PROF(4);

    // --- phase 2: Ap = (sum of the node's rows) + damping p; <p, Ap>'s chunks
    for (long long i = c0 + tid; i < c1; i += kThreads) {
      if (dead(i)) continue;
      float prod = 0.0f;
      if (i < n6) {
        const long long k = i / 6;
        const int c = (int)(i - 6 * k);
        const int lo = first_o[k - k0] - s0, hi = lo + count_o[k - k0];
        float acc = 0.0f;
        for (int s1 = lo; s1 < hi; s1 += 4) {  // four rows' loads in flight
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = s1 + u >= hi ? 0.0f
                   : chip ? rowbuf[(s1 + u) * 6 + c]
                          : __ldcg(rows + (long long)crow_o[s1 + u] * 6 + c);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (s1 + u < hi) acc = __fadd_rn(acc, v[u]);
        }
        const float pi_ = p[i];
        const float ap = __fadd_rn(acc, __fmul_rn(a.damping, pi_));
        apo[i - e0] = ap;
        prod = __fmul_rn(pi_, ap);
      }
      const float s = chunk_sum(prod);
      if (lane == 0) put_all(cs_pap, i / kChunk, s);
    }
    PROF(5);
    cluster.sync();
    PROF(6);

    // --- phase 3: alpha; x, r on this block's nodes; z = Minv r; <r, z>'s chunks
    const float denom = block_dot(cs_pap, nch, P, chip);
    PROF(7);
    const float alpha = fabsf(denom) > 1e-20f ? __fdiv_rn(rz, denom) : 0.0f;
    for (long long i = e0 + tid; i < e1; i += kThreads) {
      if (dead(i)) continue;
      xo[i - e0] = __fadd_rn(xo[i - e0], __fmul_rn(alpha, p[i]));
      ro[i - e0] = __fsub_rn(ro[i - e0], __fmul_rn(alpha, apo[i - e0]));
    }
    __syncthreads();
    PROF(8);
    precondition(true);
    PROF(9);
    cluster.sync();
    PROF(10);
  }
  if (chip)
    for (long long i = e0 + tid; i < e1; i += kThreads) x[i] = xo[i - e0];
#ifdef LIORF_PCG_PROFILE
  if (blockIdx.x == 0 && tid == 0)
    for (int j = 0; j < 16; ++j) g_prof[j] = prof_[j];
#endif
}

}  // namespace

extern "C" {

// Floats of scratch one lane needs.
long long liorf_pcg_scratch_floats(long long K, long long E, long long G) {
  return scratch_floats(K, E, G);
}

#ifdef LIORF_PCG_PROFILE
int liorf_pcg_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
}
#endif

// Ints of integer scratch one lane needs.
long long liorf_pcg_iscratch_ints(long long K, long long E, long long G) {
  return iscratch_ints(K, E, G);
}

// Every lane's PCG in one launch: one cluster of `cluster` blocks (1 to 8)
// a lane. Pointers are contiguous device arrays as in Args; scratch [lanes,
// liorf_pcg_scratch_floats(K, E, G)] f32, iscratch [lanes,
// liorf_pcg_iscratch_ints(K, E, G)] i32. The lane runs on chip where it
// fits a block's shared memory, else in device memory; the result is the
// same bits in both layouts.
int liorf_pcg_solve(const void* Ji, const void* Jj, const void* Jg, const void* Jp,
                    const void* ei, const void* ej, const void* gi, const void* pi,
                    const void* keys, const void* perm, const void* Minv, const void* rhs,
                    void* x, void* scratch, void* iscratch, int lanes, int K, int E, int G,
                    int iters, float damping, int cluster, void* stream) {
  if (lanes == 0 || K == 0) return 0;
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  Args a;
  a.Ji = (const float*)Ji; a.Jj = (const float*)Jj; a.Jg = (const float*)Jg;
  a.Jp = (const float*)Jp;
  a.ei = (const int64_t*)ei; a.ej = (const int64_t*)ej; a.gi = (const int64_t*)gi;
  a.pi = (const int64_t*)pi;
  a.keys = (const int64_t*)keys; a.perm = (const int64_t*)perm;
  a.Minv = (const float*)Minv; a.rhs = (const float*)rhs;
  a.x = (float*)x; a.scratch = (float*)scratch; a.iscratch = (int32_t*)iscratch;
  a.K = K; a.E = E; a.G = G; a.iters = iters; a.damping = damping;

  const long long bytes = shared_bytes(K, E, G, cluster);
  void (*kernel)(Args) =
      lane_layout(K, E, G, cluster) == kOnChip ? pcg_kernel<kOnChip> : pcg_kernel<kDeviceMemory>;
  if (bytes > 0) {  // the opt-in is per device context: set it on every call
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The layout a launch at these sizes takes (1 on chip, 0 device memory),
// and its dynamic shared memory in bytes.
int liorf_pcg_layout(long long K, long long E, long long G, int cluster) {
  return lane_layout(K, E, G, cluster);
}

long long liorf_pcg_shared_bytes(long long K, long long E, long long G, int cluster) {
  return shared_bytes(K, E, G, cluster);
}

}  // extern "C"
