// The pose graph's linearization and normal-equation sums of one
// Gauss-Newton step, for NVIDIA Hopper (sm_90a), in one launch; plain C
// interface.
//
// Built by ops/linearize.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing (the wrapper
// hands it its scratch), never synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package jits _build_normal_terms
// (liorf_tpu/graph/pose_graph.py:99-117,141-202: jacfwd of every factor's
// residual under vmap, whitening, the Cauchy weight, masks, then .at[].add of
// J^T r and J^T J per node) into a few fused XLA programs. Op by op on the
// card that was thousands of launches a GN step (jacfwd under vmap, ~45 ms
// of host time). Here one cluster of kCluster blocks a lane runs all of it:
//
//   phase A, one group of kGroup threads a factor slot (between, GPS, the
//     prior), the lane's slots shared out over the cluster's blocks: every
//     thread of the group forms the factor's residual, rotations and
//     weight (the same operations, so the same bits, on each), the six
//     directions of so3_log's derivative go one to a thread and come back
//     by shuffles, the J blocks (whitened, weighted, masked, a frozen
//     endpoint's columns zeroed) go to the group's shared memory and from
//     there, coalesced, to the output the PCG kernel (csrc/pcg.cu) reads,
//     and each of the 27 distinct terms of the factor's row at an endpoint
//     (-J^T r: 6, J^T J's entries p <= q: 21, written to both places of the
//     symmetric 36) is one thread's whole sum over the residual rows in
//     index order; a flag says whether any term is nonzero;
//   meanwhile each block's last warp finds the block's run of sorted rows
//     (the plan's keys in its nodes' range) by two 32-way searches, its
//     nodes' ranges in one pass over the run where the key changes, and
//     copies the run's plan rows (perm) into shared memory;
//   the cluster's barrier (rows and flags in device memory, read past L1);
//   phase B: the run's flags become bits in shared memory (a ballot a warp,
//     in the plan's sorted order); one group a node walks its bits eight
//     words at a time and adds every nonzero row, two rows' loads at once,
//     each thread owning whole sums of the 42 from 0.0f.
//
// The Jacobians (at the zero tangent, right-perturbation retraction): the
// rotation rows are the derivative of so3_log's formula (the branch the
// value takes: theta < 1e-5, generic, theta > pi - 1e-2 with the axis
// rebuilt from the symmetric part) along the directions jacfwd perturbs its
// argument in: Q hat(e_k) for w_j (and the prior), Rm^T (-hat(e_k) P) for
// w_i, with Q = Rm^T P, P = Ri^T Rj; d r_t / d w_i = [Ri^T (tj - ti)]x,
// d r_t / d v_i = -I, d r_t / d v_j = P. GPS: [0 | Ri]. Prior: [[dlog, 0],
// [0, Ri]]. so3_log's value and derivative are in so3_log.cuh, shared with
// csrc/fusion.cu.
//
// The order contract (ops/linearize.py::linearize_normal_plain spells it in
// torch ops; on the card the two agree bit for bit wherever the operations
// are IEEE-rounded): every product, sum, quotient and square root is
// rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn: nvcc
// would contract to FMAs); a 3-term product sum is (a0 b0 + a1 b1) + a2 b2;
// a factor's J^T r and J^T J add its residual rows in index order from the
// first product; a node's sums add its rows in the plan's sorted order from
// 0.0f. atan2 is the one library-rounded function, taken in double and
// rounded to float as the plain version takes it. A row whose 42 terms
// are all zero adds an exact +0.0 to a sum that starts at +0.0 and is never
// -0.0, so phase B skips it: no bit changes, and the unused slots, which all
// name node 0, cost node 0's group a pass over a few words of bits.
//
// What bounds it: neither bytes (about 0.5 MB at the resident default's
// full solve) nor operations (about 2 MFLOP) but latency: a between
// factor's chain (the loads, so3_log, a direction of its derivative, the
// weight, then seven sums of six products a thread), one barrier, a node's
// walk; at the resident full solve a block's 177 factor slots take three
// rounds of its 60 groups. The design before ran a factor on one thread (a
// few thousand dependent operations and 78 scattered stores) and the node
// sums as a second launch that found each node's rows by binary search.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "so3_log.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRow = 42;
constexpr int kGroup = 8;             // threads a factor (phase A) and a node (phase B)
constexpr int kTerms = 6;             // terms a thread of a row: ceil(42 / kGroup)
constexpr int kCluster = 8;           // blocks a lane
constexpr int kMaxThreads = 512;      // a block's threads, at most

struct Args {
  const float* Rs;        // [B, K, 3, 3]
  const float* ts;        // [B, K, 3]
  const int64_t* ei;      // [B, E]
  const int64_t* ej;      // [B, E]
  const float* eRm;       // [B, E, 3, 3]
  const float* etm;       // [B, E, 3]
  const float* esi;       // [B, E, 6]
  const float* ecauchy;   // [B, E]
  const uint8_t* emask;   // [B, E]
  const int64_t* gi;      // [B, G]
  const float* gt;        // [B, G, 3]
  const float* gsi;       // [B, G, 3]
  const uint8_t* gmask;   // [B, G]
  const int64_t* pi;      // [B, 1]
  const float* pR;        // [B, 3, 3]
  const float* pt;        // [B, 3]
  const float* psi;       // [B, 6]
  const uint8_t* free_;   // [B, K]
  const int64_t* keys;    // [B, M] sorted node of each plan row
  const int64_t* perm;    // [B, M] plan row (Ji rows, Jj rows, GPS, prior)
  float* rhs;             // [B, K, 6] out
  float* diag;            // [B, K, 6, 6] out
  float* Ji;              // [B, E, 6, 6] out
  float* Jj;              // [B, E, 6, 6] out
  float* Jg;              // [B, G, 3, 6] out
  float* Jp;              // [B, 6, 6] out
  float* rows;            // [B, M, 42] scratch
  int32_t* flags;         // [B, M] scratch
  int K, E, G;
  int fpb, npb;           // factor slots and nodes a block
};

#ifdef LIORF_LINEARIZE_PROFILE
// Development only (built with -DLIORF_LINEARIZE_PROFILE): clock cycles a
// phase of lane 0's first thread (its group takes factor slot 0, a between
// factor, and node 0, the node the unused slots name), each lap taken after
// the phase's results are used; slots 0-5 the factor (loads with P, Q and
// u; so3_log; its derivative's direction with the shuffles; the weights;
// both endpoints' J stored; both rows' sums), 6 the thread's later factor
// slots, 7 the key warp's pass and copy (its own lane 0, beside phase A), 8
// the wait at the cluster barrier, 9 the flags' bits, 10 node 0's walk and
// sums; 11-12 the launch's span by the global timer (ns).
constexpr int kProfSlots = 13;
__device__ long long g_prof[kProfSlots] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                          0x7fffffffffffffffLL, 0};
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
    if (on) g_prof[slot] = now - t;
    t = now;
  }
};
__device__ __forceinline__ void span(int slot, bool end) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long now = (unsigned long long)gtimer();
    if (end) atomicMax((unsigned long long*)&g_prof[slot], now);
    else atomicMin((unsigned long long*)&g_prof[slot], now);
  }
}
#else
struct Laps {
  __device__ explicit Laps(bool) {}
  template <class T>
  __device__ void lap(int, T) {}
};
__device__ __forceinline__ void span(int, bool) {}
#endif

// A thread's place in its group: index g, the group's lanes as a mask.
struct Group {
  int g;
  unsigned mask;
};

// The group's J [n] from its scratch to device memory, coalesced.
__device__ __forceinline__ void store_J(const float* js, float* jout, int n, Group gr) {
  for (int i = gr.g; i < n; i += kGroup) jout[i] = js[i];
}

// The 27 sums of a row (-J^T r: 6, J^T J's 21 entries p <= q), as the
// block's shared table holds them: 128 | c for column c of -J^T r, p << 4 | q
// for J^T J's (p, q).
constexpr int kRowTasks = 27;
constexpr int kTaskSlots = (2 * kRowTasks + kGroup - 1) / kGroup;  // a thread's, two rows
__device__ __forceinline__ unsigned char row_task(int t) {
  if (t < 6) return (unsigned char)(128 | t);
  int p = 0, q = t - 6;  // the (t - 6)-th entry of the upper triangle, row by row
  while (q >= 6 - p) {
    q -= 6 - p;
    ++p;
  }
  return (unsigned char)(p << 4 | (p + q));
}

// The rows of `sides` endpoints (J in js, 36 floats a side, after a
// __syncwarp of the group): each row's 42 terms, -J^T r (6) and J^T J (36),
// every term one thread's whole sum over the R residual rows in index order
// from the first product. J^T J's entry (q, p) is its entry (p, q): the same
// products (IEEE products commute) summed in the same order, so a thread
// takes the 21 entries p <= q and writes both places; 27 sums a row, task
// g + kGroup m of the group's thread g (`tasks`: row_task's table). The flag
// says whether any term is nonzero.
template <int R>
__device__ __forceinline__ void row_sums(const float* js, const float rw[R], int sides,
                                         float* row0, float* row1, int32_t* flag0,
                                         int32_t* flag1, const unsigned char* tasks, Group gr) {
  bool nz0 = false, nz1 = false;
#pragma unroll
  for (int m = 0; m < kTaskSlots; ++m) {
    const int task = gr.g + kGroup * m;
    if (task >= sides * kRowTasks) continue;
    const int side = task >= kRowTasks ? 1 : 0;
    const int cd = tasks[task - side * kRowTasks];
    const int p = (cd >> 4) & 7, q = cd & 7;
    const bool rhs = (cd & 128) != 0;
    const float* J = js + 36 * side;
    // -J^T r: column q times rw; J^T J: columns p and q
    float acc = mul(J[rhs ? q : p], rhs ? rw[0] : J[q]);
#pragma unroll
    for (int s = 1; s < R; ++s) acc = add(acc, mul(J[6 * s + (rhs ? q : p)], rhs ? rw[s] : J[6 * s + q]));
    float* row = side ? row1 : row0;
    if (rhs) {
      row[q] = -acc;
    } else {
      row[6 + 6 * p + q] = acc;
      row[6 + 6 * q + p] = acc;
    }
    if (side) nz1 |= acc != 0.0f;
    else nz0 |= acc != 0.0f;
  }
  const bool any0 = (__ballot_sync(gr.mask, nz0) & gr.mask) != 0u;
  const bool any1 = (__ballot_sync(gr.mask, nz1) & gr.mask) != 0u;
  if (gr.g == 0) {
    *flag0 = any0;
    if (sides > 1) *flag1 = any1;
  }
  __syncwarp(gr.mask);  // js is the next factor's
}

__device__ void between(const Args& a, long long b, int e, float* js, const unsigned char* tasks,
                        Group gr, Laps& laps) {
  const int K = a.K, E = a.E, M = 2 * a.E + a.G + 1;
  const long long f = b * E + e;
  const long long i = b * K + __ldg(reinterpret_cast<const long long*>(a.ei) + f);
  const long long j = b * K + __ldg(reinterpret_cast<const long long*>(a.ej) + f);
  float Ri[3][3], Rj[3][3], Rm[3][3];
  load33(a.Rs + i * 9, Ri);
  load33(a.Rs + j * 9, Rj);
  load33(a.eRm + f * 9, Rm);
  float P[3][3], Q[3][3];
  mtm(Ri, Rj, P);
  mtm(Rm, P, Q);
  float dt[3], u[3], r[6], si[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) dt[c] = sub(__ldg(a.ts + j * 3 + c), __ldg(a.ts + i * 3 + c));
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = sum3(mul(Ri[0][c], dt[0]), mul(Ri[1][c], dt[1]), mul(Ri[2][c], dt[2]));
  laps.lap(0, Q[0][0] + Q[2][2] + u[0]);
  Log L;
  log_value(Q, L);
  laps.lap(1, L.w[0]);
  // d r_R / d (w_i, w_j): direction g of the six on thread g, then shared
  float dw[3] = {0.0f, 0.0f, 0.0f};
  if (gr.g < 6) {
    const int k = gr.g % 3;
    float dQ[3][3];
    if (gr.g < 3) {
      float X[3][3];
      hat_p(P, k, X);
      mtm(Rm, X, dQ);
    } else {
      q_hat(Q, k, dQ);
    }
    log_tangent(L, dQ, dw);
  }
  float A[3][6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int s = 0; s < 3; ++s) A[s][k] = __shfl_sync(gr.mask, dw[s], k, kGroup);
  laps.lap(2, A[0][0] + A[2][5]);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    r[s] = L.w[s];
    r[3 + s] = sub(u[s], __ldg(a.etm + f * 3 + s));
  }
  float rw[6];
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    si[s] = __ldg(a.esi + f * 6 + s);
    rw[s] = mul(r[s], si[s]);
  }
  float rn2 = mul(rw[0], rw[0]);
#pragma unroll
  for (int s = 1; s < 6; ++s) rn2 = add(rn2, mul(rw[s], rw[s]));
  const float c = __ldg(a.ecauchy + f);
  float w_rob = 1.0f;
  if (c > 0.0f) w_rob = dvd(1.0f, add(1.0f, dvd(rn2, fmaxf(mul(c, c), 1e-12f))));
  const float w = mul(__fsqrt_rn(w_rob), a.emask[f] ? 1.0f : 0.0f);
#pragma unroll
  for (int s = 0; s < 6; ++s) rw[s] = mul(rw[s], w);
  laps.lap(3, rw[5]);

  // Ji = [[A_i, 0], [u x, -I]], Jj = [[A_j, 0], [0, P]], rows whitened and
  // weighted, columns of a frozen endpoint zeroed, into the group's scratch
  // (every thread writes every entry: the same value)
  const float fi = a.free_[i] ? 1.0f : 0.0f, fj = a.free_[j] ? 1.0f : 0.0f;
  const float ux[3][3] = {{0.0f, -u[2], u[1]}, {u[2], 0.0f, -u[0]}, {-u[1], u[0], 0.0f}};
#pragma unroll
  for (int s = 0; s < 6; ++s)
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float ji = s < 3 ? (q < 3 ? A[s][q] : 0.0f)
                             : (q < 3 ? ux[s - 3][q] : (s == q ? -1.0f : 0.0f));
      const float jj = s < 3 ? (q < 3 ? A[s][3 + q] : 0.0f) : (q < 3 ? 0.0f : P[s - 3][q - 3]);
      js[6 * s + q] = mul(mul(mul(ji, si[s]), w), fi);
      js[36 + 6 * s + q] = mul(mul(mul(jj, si[s]), w), fj);
    }
  __syncwarp(gr.mask);
  store_J(js, a.Ji + f * 36, 36, gr);
  store_J(js + 36, a.Jj + f * 36, 36, gr);
  laps.lap(4, js[0] + js[71]);
  row_sums<6>(js, rw, 2, a.rows + (b * M + e) * kRow, a.rows + (b * M + E + e) * kRow,
              a.flags + b * M + e, a.flags + b * M + E + e, tasks, gr);
  laps.lap(5, js[0]);
}

__device__ void gps(const Args& a, long long b, int g, float* js, const unsigned char* tasks,
                    Group gr) {
  const int K = a.K, G = a.G, M = 2 * a.E + a.G + 1;
  const long long f = b * G + g;
  const long long i = b * K + __ldg(reinterpret_cast<const long long*>(a.gi) + f);
  float Ri[3][3];
  load33(a.Rs + i * 9, Ri);
  const float m = a.gmask[f] ? 1.0f : 0.0f, fi = a.free_[i] ? 1.0f : 0.0f;
  float rw[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float si = __ldg(a.gsi + f * 3 + s);
    rw[s] = mul(mul(sub(__ldg(a.ts + i * 3 + s), __ldg(a.gt + f * 3 + s)), si), m);
#pragma unroll
    for (int q = 0; q < 6; ++q) js[6 * s + q] = mul(mul(mul(q < 3 ? 0.0f : Ri[s][q - 3], si), m), fi);
  }
  const int row = 2 * a.E + g;
  __syncwarp(gr.mask);
  store_J(js, a.Jg + f * 18, 18, gr);
  row_sums<3>(js, rw, 1, a.rows + (b * M + row) * kRow, nullptr, a.flags + b * M + row, nullptr,
              tasks, gr);
}

__device__ void prior(const Args& a, long long b, float* js, const unsigned char* tasks,
                      Group gr) {
  const int K = a.K, M = 2 * a.E + a.G + 1;
  const long long i = b * K + __ldg(reinterpret_cast<const long long*>(a.pi) + b);
  float Ri[3][3], R0[3][3], Q[3][3];
  load33(a.Rs + i * 9, Ri);
  load33(a.pR + b * 9, R0);
  mtm(R0, Ri, Q);
  Log L;
  log_value(Q, L);
  const float fi = a.free_[i] ? 1.0f : 0.0f;
  float dw[3] = {0.0f, 0.0f, 0.0f};
  if (gr.g < 3) {
    float dQ[3][3];
    q_hat(Q, gr.g, dQ);
    log_tangent(L, dQ, dw);
  }
  // [[d log, 0], [0, Ri]], rows whitened, the columns zeroed when frozen
  float D[3][3], rw[6];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int s = 0; s < 3; ++s) D[s][k] = __shfl_sync(gr.mask, dw[s], k, kGroup);
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const float psi = __ldg(a.psi + b * 6 + s);
    const float r = s < 3 ? L.w[s] : sub(__ldg(a.ts + i * 3 + s - 3), __ldg(a.pt + b * 3 + s - 3));
    rw[s] = mul(r, psi);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const float j0 = s < 3 ? (q < 3 ? D[s][q] : 0.0f) : (q < 3 ? 0.0f : Ri[s - 3][q - 3]);
      js[6 * s + q] = mul(mul(j0, psi), fi);
    }
  }
  __syncwarp(gr.mask);
  store_J(js, a.Jp + b * 36, 36, gr);
  row_sums<6>(js, rw, 1, a.rows + (b * M + M - 1) * kRow, nullptr, a.flags + b * M + M - 1,
              nullptr, tasks, gr);
}

// The first s in [0, M) with keys[s] >= v (M when none), on one warp: 32
// probes a round, each the last of 32 equal chunks of the range.
__device__ int warp_lower_bound(const long long* keys, int M, long long v, int lane) {
  int lo = 0, hi = M;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int s = lo + (lane + 1) * step - 1;
    const bool ge = s >= hi || __ldg(keys + s) >= v;
    const int j = __ffs(__ballot_sync(0xffffffffu, ge)) - 1;  // lane 31 probes at or past hi
    hi = min(hi, lo + (j + 1) * step - 1);
    lo += j * step;
  }
  const int s = lo + lane;
  const unsigned ge = __ballot_sync(0xffffffffu, s < hi && __ldg(keys + s) >= v);
  return ge ? lo + __ffs(ge) - 1 : hi;
}

// The dynamic shared memory of a block: the node ranges (lo, hi a node),
// the groups' J scratch (two endpoints, 72 floats a group), the run's plan
// rows and its flags as bits.
__host__ __device__ __forceinline__ long long shared_bytes(int threads, int npb, int M) {
  return 4LL * (2 * npb + (threads / kGroup) * 72 + M + (M + 31) / 32);
}

// One cluster a lane: block rank c takes factor slots [c fpb, (c + 1) fpb)
// on all its warps but the last, and nodes [c npb, (c + 1) npb) on all. The
// last warp meanwhile finds the nodes' ranges of sorted rows (where the key
// changes) and copies their plan rows.
__global__ void __launch_bounds__(kMaxThreads) normal_terms_kernel(Args a) {
  extern __shared__ float sh[];
  __shared__ int s_run[2];  // the block's run of sorted rows, [first, end)
  __shared__ unsigned char s_tasks[kRowTasks];  // a row's sums (row_task)
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const long long b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, T = blockDim.x, groups = T / kGroup;
  const int lane = tid & 31, key_warp = T / 32 - 1;
  const int M = 2 * a.E + a.G + 1, F = a.E + a.G + 1;
  const Group gr{tid & (kGroup - 1), 0xffu << (tid & 24)};
  const int group = tid / kGroup;
  int* lo = reinterpret_cast<int*>(sh);
  int* hi = lo + a.npb;
  float* js = reinterpret_cast<float*>(hi + a.npb) + 72 * group;
  int* run_row = hi + a.npb + 72 * groups;
  unsigned* run_bits = reinterpret_cast<unsigned*>(run_row + M);
  const int n0 = c * a.npb, n1 = min(a.K, n0 + a.npb);
  span(11, false);
  Laps laps(b == 0 && c == 0 && tid == 0);
  if (tid < kRowTasks) s_tasks[tid] = row_task(tid);
  __syncthreads();

  if (tid / 32 == key_warp) {
    Laps key_laps(b == 0 && c == 0 && lane == 0);
    // the block's run of sorted rows (keys in [n0, n1)) by two searches,
    // then its nodes' ranges where the key changes (a node without rows
    // keeps lo = hi = 0) and its plan rows
    for (int k = lane; k < a.npb; k += 32) lo[k] = hi[k] = 0;
    const long long* keys = reinterpret_cast<const long long*>(a.keys) + b * M;
    const long long* perm = reinterpret_cast<const long long*>(a.perm) + b * M;
    const int first = warp_lower_bound(keys, M, n0, lane);
    const int end = n1 < a.K ? warp_lower_bound(keys, M, n1, lane) : M;
    if (lane == 0) {
      s_run[0] = first;
      s_run[1] = end;
    }
    __syncwarp();
    constexpr int kU = 4;  // chunks of 32 rows a lane loads at once
    for (int s0 = first; s0 < end; s0 += 32 * kU) {
      long long k[kU], prev[kU], next[kU];
      int row[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = s0 + 32 * u + lane;
        k[u] = s < end ? __ldg(keys + s) : n1;
        row[u] = s < end ? (int)__ldg(perm + s) : 0;
        // the neighbours at a chunk's edges (the run's own edges are node edges)
        prev[u] = lane == 0 && s > first && s < end ? __ldg(keys + s - 1) : n0 - 1;
        next[u] = lane == 31 && s + 1 < end ? __ldg(keys + s + 1) : n1;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int s = s0 + 32 * u + lane;
        const long long up = __shfl_up_sync(0xffffffffu, k[u], 1);
        const long long down = __shfl_down_sync(0xffffffffu, k[u], 1);
        if (lane > 0) prev[u] = s > first ? up : n0 - 1;
        if (lane < 31) next[u] = s + 1 < end ? down : n1;
        if (s < end) {
          if (prev[u] != k[u]) lo[k[u] - n0] = s;
          if (next[u] != k[u]) hi[k[u] - n0] = s + 1;
          run_row[s - first] = row[u];
        }
      }
    }
    key_laps.lap(7, run_row[0]);
  } else {
    // phase A: a group a factor slot
    for (int f = c * a.fpb + group; f < min(F, (c + 1) * a.fpb); f += groups - 4) {
      if (f < a.E) between(a, b, f, js, s_tasks, gr, laps);
      else if (f < a.E + a.G) gps(a, b, f - a.E, js, s_tasks, gr);
      else prior(a, b, js, s_tasks, gr);
    }
  }
  laps.lap(6, tid);
  cluster.sync();  // every row and flag of the lane written; the ranges found
  laps.lap(8, s_run[0]);
  const int first = s_run[0], len = s_run[1] - s_run[0];
  // the run's flags as bits, 32 sorted rows a word
  const int32_t* flags = a.flags + b * M;
  for (int w = tid / 32; w < (len + 31) / 32; w += T / 32) {
    const int r = 32 * w + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, r < len && __ldcg(flags + run_row[r]) != 0);
    if (lane == 0) run_bits[w] = bits;
  }
  __syncthreads();
  laps.lap(9, run_bits[0]);
  // phase B: a group a node, its nonzero rows in the plan's sorted order
  const float* rows = a.rows + b * M * kRow;
  for (int k = group; k < n1 - n0; k += groups) {
    float acc[kTerms];
#pragma unroll
    for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
    const int p = lo[k] - first, q = hi[k] - first;  // the node's rows in the run
    if (p < q) {
      const int w_first = p >> 5, w_last = (q - 1) >> 5;
      for (int w0 = w_first; w0 <= w_last; w0 += kGroup) {
        const int w = w0 + gr.g;
        unsigned bits = 0u;
        if (w <= w_last) {
          bits = run_bits[w];
          if (w == w_first) bits &= 0xffffffffu << (p & 31);
          if (w == w_last && (q & 31)) bits &= (1u << (q & 31)) - 1u;
        }
        unsigned words = (__ballot_sync(gr.mask, bits != 0u) & gr.mask) >> (tid & 24);
        while (words) {
          const int j = __ffs(words) - 1;
          words &= words - 1;
          unsigned wb = __shfl_sync(gr.mask, bits, j, kGroup);
          while (wb) {  // two rows at a time: their loads issued together
            const int r0 = 32 * (w0 + j) + __ffs(wb) - 1;
            wb &= wb - 1;
            const int r1 = wb ? 32 * (w0 + j) + __ffs(wb) - 1 : -1;
            if (wb) wb &= wb - 1;
            const float* v0 = rows + (long long)run_row[r0] * kRow;
            const float* v1 = rows + (long long)run_row[r1 < 0 ? r0 : r1] * kRow;
            float x0[kTerms], x1[kTerms];
#pragma unroll
            for (int m = 0; m < kTerms; ++m) {
              const int e = gr.g + kGroup * m;
              x0[m] = e < kRow ? __ldcg(v0 + e) : 0.0f;
              x1[m] = e < kRow ? __ldcg(v1 + e) : 0.0f;
            }
#pragma unroll
            for (int m = 0; m < kTerms; ++m) acc[m] = add(acc[m], x0[m]);
            if (r1 >= 0) {
#pragma unroll
              for (int m = 0; m < kTerms; ++m) acc[m] = add(acc[m], x1[m]);
            }
          }
        }
      }
    }
    const long long node = b * a.K + n0 + k;
#pragma unroll
    for (int m = 0; m < kTerms; ++m) {
      const int e = gr.g + kGroup * m;
      if (e < 6) a.rhs[node * 6 + e] = acc[m];
      else if (e < kRow) a.diag[node * 36 + e - 6] = acc[m];
    }
    if (k == 0) laps.lap(10, acc[0]);
  }
  span(12, true);
}

// Kernels this library launched (host side): a caller counts a call's.
long long g_launches = 0;
// The dynamic shared memory a launch may take, opted in once per device.
long long g_opted_in[256] = {};

}  // namespace

extern "C" {

long long liorf_linearize_kernel_launches() { return g_launches; }

#ifdef LIORF_LINEARIZE_PROFILE
// The last launch's slots (kProfSlots), then every slot reset.
int liorf_linearize_profile(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfSlots);
  if (err != cudaSuccess) return (int)err;
  long long reset[kProfSlots] = {};
  reset[11] = 0x7fffffffffffffffLL;
  return (int)cudaMemcpyToSymbol(g_prof, reset, sizeof(reset));
}
#endif

// Every lane's linearization and node sums in one launch on `stream` of
// `device`. `ptrs` holds 28 addresses of contiguous device arrays in the
// order of Args (rows [lanes, 2E+G+1, 42] f32 and flags [lanes, 2E+G+1] i32
// are scratch).
int liorf_linearize(const long long* ptrs, int lanes, int K, int E, int G, int device,
                    void* stream) {
  if (lanes == 0 || K == 0) return 0;
  if (device < 0 || device >= 256) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  const void* const* p = reinterpret_cast<const void* const*>(ptrs);
  a.Rs = (const float*)p[0]; a.ts = (const float*)p[1];
  a.ei = (const int64_t*)p[2]; a.ej = (const int64_t*)p[3];
  a.eRm = (const float*)p[4]; a.etm = (const float*)p[5]; a.esi = (const float*)p[6];
  a.ecauchy = (const float*)p[7]; a.emask = (const uint8_t*)p[8];
  a.gi = (const int64_t*)p[9]; a.gt = (const float*)p[10]; a.gsi = (const float*)p[11];
  a.gmask = (const uint8_t*)p[12]; a.pi = (const int64_t*)p[13];
  a.pR = (const float*)p[14]; a.pt = (const float*)p[15]; a.psi = (const float*)p[16];
  a.free_ = (const uint8_t*)p[17];
  a.keys = (const int64_t*)p[18]; a.perm = (const int64_t*)p[19];
  a.rhs = (float*)p[20]; a.diag = (float*)p[21]; a.Ji = (float*)p[22]; a.Jj = (float*)p[23];
  a.Jg = (float*)p[24]; a.Jp = (float*)p[25]; a.rows = (float*)p[26];
  a.flags = (int32_t*)p[27];
  a.K = K; a.E = E; a.G = G;
  const int F = E + G + 1, M = 2 * E + G + 1;
  a.fpb = (F + kCluster - 1) / kCluster;
  a.npb = (K + kCluster - 1) / kCluster;
  int threads = ((kGroup * a.fpb + 31) / 32) * 32;  // phase A's warps
  threads = (threads > kMaxThreads - 32 ? kMaxThreads - 32 : threads) + 32;  // and the key warp
  const long long bytes = shared_bytes(threads, a.npb, M);
  if (bytes > g_opted_in[device]) {
    err = cudaFuncSetAttribute(normal_terms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess) g_opted_in[device] = bytes;
  }
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(lanes * kCluster));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, normal_terms_kernel, a);
    if (err == cudaSuccess) {
      ++g_launches;
      err = cudaGetLastError();
    }
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
