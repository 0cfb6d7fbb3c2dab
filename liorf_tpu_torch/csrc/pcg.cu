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
//   * every block reduces all chunk sums by the same tree (one warp: each
//     lane an aligned run, then 5 shuffle levels), so each holds the same
//     scalars without a second exchange.
// Where the vectors live: when the lane fits in a block's shared memory
// (about 100 KB at the resident default, 1024 node slots, clusters of 8),
// z, p and the chunk sums are replicated in every block of the cluster (the
// owner writes each element to all of them through distributed shared
// memory, cluster.map_shared_rank), so every read of them is local, and
// each block's own x, r, Ap and node indices sit in its own shared memory;
// else (a grown ring) one copy of each lives in device memory and is read
// through L2 (__ldcg, never a stale L1 line). The same code runs either
// way, through generic pointers, and gives the same bits. The matvec's rows
// always go through device memory (L2). The factors and the preconditioner
// are read-only for the launch (__ldg): a block's share stays in its L1.
// A factor row whose Jacobian is all zero (an unused ring slot, a masked or
// frozen factor) adds an exact +0.0 to its node (a sum from +0.0 is never
// -0.0), so once a launch each node's sorted rows are compacted to those
// with a nonzero Jacobian, in order (a warp a node, by ballots): the walk
// skips nothing that could change a bit, and the unused slots, which all
// name node 0, no longer make node 0's walk thousands of rows long. Zero
// factors are skipped in the factor phase as well. (With non-finite inputs
// a zero row would add NaN; the solve never sees them.)
// Per iteration three cluster barriers: after the factors (the matvec's
// rows), after the node sums (<p, Ap>), after the preconditioner (<r, z>).
// The next direction p is made where it is read: a factor's owner forms
// z + beta p at its endpoints from z and the previous p (double-buffered),
// the same rounded operations as the node's owner, so no fourth barrier.
//
// What bounds it: neither bytes nor operations (about 10 MFLOP and 0.6 MB
// a solve at the resident default's arguments, well under a microsecond at
// the card's rates) but the chain of dependent phases an iteration: three
// cluster barriers, the factor phase (each lane forms both endpoints'
// directions and two 6x6 products), the node sums' L2 reads, and the
// replication of z and p (8 remote stores an element). chip_smoke.py's
// pcg_profile phase times each phase by clock cycles (a build with
// -DLIORF_PCG_PROFILE).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // fixed_dot's chunk (ops/segment_sum.py)
constexpr int kNodeQuantum = 16;  // 16 nodes = 96 elements = 3 chunks
constexpr unsigned kFull = 0xffffffffu;
// A block's shared memory (232448 bytes on an H100) less room for the
// kernel's static shared memory.
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
  int shared;         // the lane's vectors in shared memory (shared_layout)
};

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
// [M], its factors' flags [2 Eb + Gb + 1].
struct Layout {
  long long z, p0, p1, cs_pap, cs_rz, x, r, ap, first, count, crow, nzf, words;
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
  l.words = l.nzf + 2 * Eb + Gb + 1;
  return l;
}

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

// The tree's result in every thread of the block.
__device__ __forceinline__ float block_dot(const float* cs, long long nch, long long P,
                                           bool sh, float* s_scalar) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const float t = chunk_tree(cs, nch, P, lane, sh);
    if (lane == 0) *s_scalar = t;
  }
  __syncthreads();
  return *s_scalar;
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
  const bool sh = a.shared != 0;

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

  // Where things live. In device memory always: the matvec's rows and every
  // plan row's flag. In shared memory when the lane fits (sh): z, p and the
  // chunk sums replicated in every block (written to all of them through
  // distributed shared memory, so every read is local), and the block's own
  // vectors and indices; else one copy of each in device memory, read
  // through L2. Own arrays are indexed from the block's first element /
  // node / sorted row.
  float* gs = a.scratch + b * scratch_floats(K, E, G);
  int32_t* gi32 = a.iscratch + b * iscratch_ints(K, E, G);
  float* rows = gs + 5 * n6 + 2 * nch;
  int32_t* nz = gi32 + 2 * K + 1;
  float *zr, *pr[2], *cs_pap, *cs_rz, *xo, *ro, *apo;
  int32_t *first_o, *count_o, *crow_o, *nz_i, *nz_j, *nz_g;
  if (sh) {
    const Layout l = shared_layout(K, E, G, C);
    float* f = pcg_smem;
    int32_t* w = reinterpret_cast<int32_t*>(pcg_smem);
    zr = f + l.z; pr[0] = f + l.p0; pr[1] = f + l.p1; cs_pap = f + l.cs_pap; cs_rz = f + l.cs_rz;
    xo = f + l.x; ro = f + l.r; apo = f + l.ap;
    first_o = w + l.first; count_o = w + l.count; crow_o = w + l.crow;
    nz_i = w + l.nzf; nz_j = nz_i + Eb; nz_g = nz_j + Eb;
  } else {
    zr = gs; pr[0] = gs + n6; pr[1] = gs + 2 * n6; cs_pap = gs + 3 * n6; cs_rz = cs_pap + nch;
    xo = x + e0; ro = cs_rz + nch + e0; apo = cs_rz + nch + n6 + e0;
    first_o = gi32 + k0; count_o = gi32 + K + 1 + k0; crow_o = nz + M + s0;
    nz_i = nz + f0; nz_j = nz + E + f0; nz_g = nz + 2 * E + g0;
  }
  // a read of what other blocks write, and a write every block reads
  auto ld = [&](const float* q) { return sh ? *q : __ldcg(q); };
  auto put_all = [&](float* base, long long i, float v) {
    if (sh) {
      for (int q = 0; q < C; ++q) cluster.map_shared_rank(base, q)[i] = v;
    } else {
      base[i] = v;
    }
  };

  __shared__ float s_scalar;

  // --- start: x = 0, r = rhs, each node's first sorted row, each factor
  // row's flag (a nonzero Jacobian)
  for (long long i = e0 + tid; i < e1; i += kThreads) {
    xo[i - e0] = 0.0f;
    ro[i - e0] = __ldg(rhs + i);
  }
  for (int k = k0 + tid; k <= k1; k += kThreads) first_o[k - k0] = lower_bound(keys, M, k);
  for (int e = f0 + tid; e < f1; e += kThreads) {
    bool ni = false, nj = false;
    for (int j = 0; j < 36; ++j) {
      ni |= __ldg(Ji + (long long)e * 36 + j) != 0.0f;
      nj |= __ldg(Jj + (long long)e * 36 + j) != 0.0f;
    }
    nz[e] = nz_i[e - f0] = ni;
    nz[E + e] = nz_j[e - f0] = nj;
  }
  for (int g = g0 + tid; g < g1; g += kThreads) {
    bool n = false;
    for (int j = 0; j < 18; ++j) n |= __ldg(Jg + (long long)g * 18 + j) != 0.0f;
    nz[2 * E + g] = nz_g[g - g0] = n;
  }
  if (n_prior && tid == 0) {
    bool n = false;
    for (int j = 0; j < 36; ++j) n |= __ldg(Jp + j) != 0.0f;
    nz[2 * E + G] = n;
  }
  cluster.sync();
  // each node's nonzero rows in sorted order, a warp a node
  for (int k = k0 + warp; k < k1; k += kWarps) {
    const int lo = first_o[k - k0], hi = first_o[k - k0 + 1];
    int n = 0;
    for (int base = lo; base < hi; base += 32) {
      const int s = base + lane;
      const int row = s < hi ? (int)ld_index(perm + s) : 0;
      const bool keep = s < hi && __ldcg(nz + row) != 0;
      const unsigned ballot = __ballot_sync(kFull, keep);
      if (keep) crow_o[lo - s0 + n + __popc(ballot & ((1u << lane) - 1u))] = row;
      n += __popc(ballot);
    }
    if (lane == 0) count_o[k - k0] = n;
  }
  __syncthreads();

  auto precondition = [&]() {  // z = Minv r on this block's nodes, <r, z>'s chunks
    for (long long i = c0 + tid; i < c1; i += kThreads) {
      float prod = 0.0f;
      if (i < n6) {
        const long long k = i / 6;
        const int c = (int)(i - 6 * k);
        const float* Mk = Minv + k * 36 + c * 6;
        const float* rk = ro + 6 * k - e0;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) acc = __fadd_rn(acc, __fmul_rn(__ldg(Mk + j), rk[j]));
        put_all(zr, i, acc);
        prod = __fmul_rn(ro[i - e0], acc);
      }
      const float s = chunk_sum(prod);
      if (lane == 0) put_all(cs_rz, i / kChunk, s);
    }
  };
  precondition();
  cluster.sync();
  PROF(11);

  float rz = 0.0f, beta = 0.0f;
  for (int it = 0; it < a.iters; ++it) {
    const bool it0 = it == 0;
    float* p = pr[it & 1];
    const float* p_prev = pr[(it + 1) & 1];
    // element i of this iteration's direction, made from z and the previous
    // p exactly as the node's owner makes it
    auto direction = [&](long long i) {
      const float zi = ld(zr + i);
      return it0 ? zi : __fadd_rn(zi, __fmul_rn(beta, ld(p_prev + i)));
    };

    // --- phase 1: rz' and beta; p on this block's nodes; the matvec's rows
    const float t = block_dot(cs_rz, nch, P, sh, &s_scalar);
    PROF(0);
    if (it0) {
      rz = t;
    } else {
      beta = fabsf(rz) > 1e-20f ? __fdiv_rn(t, rz) : 0.0f;
      rz = t;
    }
    for (long long i = e0 + tid; i < e1; i += kThreads) put_all(p, i, direction(i));
    PROF(1);

    const int grp = lane >> 3, q = lane & 7;
    // between factors: y = Ji p_i + Jj p_j; rows e and E + e are Ji^T y, Jj^T y
    for (int base = f0 + warp * 4; base < f1; base += kWarps * 4) {
      const int e = base + grp;
      const bool valid = e < f1 && (nz_i[e - f0] | nz_j[e - f0]);
      float y = 0.0f;
      const float* Je_i = Ji + (long long)(valid ? e : f0) * 36;
      const float* Je_j = Jj + (long long)(valid ? e : f0) * 36;
      if (valid && q < 6) {
        const long long ni = ld_index(ei + e) * 6, nj = ld_index(ej + e) * 6;
        float pi_[6], pj_[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          pi_[c] = direction(ni + c);
          pj_[c] = direction(nj + c);
        }
        float yi = 0.0f, yj = 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c) yi = __fadd_rn(yi, __fmul_rn(__ldg(Je_i + q * 6 + c), pi_[c]));
#pragma unroll
        for (int c = 0; c < 6; ++c) yj = __fadd_rn(yj, __fmul_rn(__ldg(Je_j + q * 6 + c), pj_[c]));
        y = __fadd_rn(yi, yj);
      }
      float yr[6];
#pragma unroll
      for (int s = 0; s < 6; ++s) yr[s] = __shfl_sync(kFull, y, s, 8);
      if (valid && q < 6) {
        float ci = 0.0f, cj = 0.0f;
#pragma unroll
        for (int s = 0; s < 6; ++s) ci = __fadd_rn(ci, __fmul_rn(__ldg(Je_i + s * 6 + q), yr[s]));
#pragma unroll
        for (int s = 0; s < 6; ++s) cj = __fadd_rn(cj, __fmul_rn(__ldg(Je_j + s * 6 + q), yr[s]));
        rows[(long long)e * 6 + q] = ci;
        rows[(long long)(E + e) * 6 + q] = cj;
      }
    }
    PROF(2);
    // GPS factors: y = Jg p (3 rows); row 2E + g is Jg^T y
    for (int base = g0 + warp * 4; base < g1; base += kWarps * 4) {
      const int g = base + grp;
      const bool valid = g < g1 && nz_g[g - g0];
      const float* Jq = Jg + (long long)(valid ? g : g0) * 18;
      float y = 0.0f;
      if (valid && q < 3) {
        const long long ng = ld_index(gi + g) * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c)
          y = __fadd_rn(y, __fmul_rn(__ldg(Jq + q * 6 + c), direction(ng + c)));
      }
      float yr[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) yr[s] = __shfl_sync(kFull, y, s, 8);
      if (valid && q < 6) {
        float cgv = 0.0f;
#pragma unroll
        for (int s = 0; s < 3; ++s) cgv = __fadd_rn(cgv, __fmul_rn(__ldg(Jq + s * 6 + q), yr[s]));
        rows[(long long)(2 * E + g) * 6 + q] = cgv;
      }
    }
    // the prior: y = Jp p; row 2E + G is Jp^T y (block 0's first warp)
    if (n_prior && warp == 0) {
      float y = 0.0f;
      if (grp == 0 && q < 6) {
        const long long np = pnode * 6;
#pragma unroll
        for (int c = 0; c < 6; ++c)
          y = __fadd_rn(y, __fmul_rn(__ldg(Jp + q * 6 + c), direction(np + c)));
      }
      float yr[6];
#pragma unroll
      for (int s = 0; s < 6; ++s) yr[s] = __shfl_sync(kFull, y, s, 8);
      if (grp == 0 && q < 6) {
        float cpv = 0.0f;
#pragma unroll
        for (int s = 0; s < 6; ++s) cpv = __fadd_rn(cpv, __fmul_rn(__ldg(Jp + s * 6 + q), yr[s]));
        rows[(long long)(2 * E + G) * 6 + q] = cpv;
      }
    }
    PROF(3);
    cluster.sync();
    PROF(4);

    // --- phase 2: Ap = (sum of the node's rows) + damping p; <p, Ap>'s chunks
    for (long long i = c0 + tid; i < c1; i += kThreads) {
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
            v[u] = s1 + u < hi ? __ldcg(rows + (long long)crow_o[s1 + u] * 6 + c) : 0.0f;
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
    const float denom = block_dot(cs_pap, nch, P, sh, &s_scalar);
    PROF(7);
    const float alpha = fabsf(denom) > 1e-20f ? __fdiv_rn(rz, denom) : 0.0f;
    for (long long i = e0 + tid; i < e1; i += kThreads) {
      xo[i - e0] = __fadd_rn(xo[i - e0], __fmul_rn(alpha, p[i]));
      ro[i - e0] = __fsub_rn(ro[i - e0], __fmul_rn(alpha, apo[i - e0]));
    }
    __syncthreads();
    PROF(8);
    precondition();
    PROF(9);
    cluster.sync();
    PROF(10);
  }
  if (sh)
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
// liorf_pcg_iscratch_ints(K, E, G)] i32. With `shared` the lane's vectors
// live in shared memory when they fit in a block's (else, or without it, in
// scratch); the result is the same bits either way.
int liorf_pcg_solve(const void* Ji, const void* Jj, const void* Jg, const void* Jp,
                    const void* ei, const void* ej, const void* gi, const void* pi,
                    const void* keys, const void* perm, const void* Minv, const void* rhs,
                    void* x, void* scratch, void* iscratch, int lanes, int K, int E, int G,
                    int iters, float damping, int cluster, int shared, void* stream) {
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

  const long long bytes = shared_layout(K, E, G, cluster).words * 4;
  a.shared = shared && bytes <= kMaxDynamicShared;
  if (a.shared) {
    const cudaError_t err = cudaFuncSetAttribute(
        pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.shared ? (size_t)bytes : 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pcg_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Whether a launch at these sizes keeps the lane in shared memory.
int liorf_pcg_fits_shared(long long K, long long E, long long G, int cluster) {
  return shared_layout(K, E, G, cluster).words * 4 <= kMaxDynamicShared;
}

}  // extern "C"
