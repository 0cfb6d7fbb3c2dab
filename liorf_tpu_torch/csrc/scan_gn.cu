// The scan matcher's Gauss-Newton iteration (ops/scan_match.py::
// scan_to_map_lanes) as two calls for NVIDIA Hopper (sm_90a), one kernel
// launch each; plain C interface.
//
// Built by ops/scan_gn.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launch's error code.
//
// Not a TPU kernel: the JAX package does this work in XLA
// (liorf_tpu/ops/scan_match.py:83-121, :164-195; liorf_tpu/ops/plane_fit.py:
// 22-55). Op by op on the card a GN iteration was ~40 eager launches, a
// cuSOLVER batched eigh of the [N, 3, 3] scatter matrices and a solve of the
// [B, 6, 6] systems, each of which made the host wait for the card.
//
// liorf_scan_linearize, after kernel K1 (the 5-NN search, its own launch):
//   linearize_kernel, a grid of (tiles, lanes), a block a tile of kTile
//     points, one thread a point on warps 0-3: the point's 5 neighbours read
//     from the grid by K1's indices (no [B, N, 5, 3] tensor is written), the
//     5th-NN gate, their centroid and scatter matrix, the plane's normal by
//     cyclic Jacobi (float32, kSweeps3 sweeps: the smallest eigenvalue's
//     eigenvector; the middle eigenvalue judges collinearity), the residual
//     gate; meanwhile warp 4 forms the lane's rotation and its derivatives
//     (the six cos / sin on six lanes); then the point's world position, its
//     weight, its row J = [n . (dR_k p), n] s and share of b, and the tile's
//     halving tree over the 28 sums (H's upper triangle, g, the count): its
//     first two levels in one pass over shared memory, the last five a warp's
//     shuffle-down, each warp 7 of the terms. The lane's last tile to arrive
//     (a counter the wrapper keeps at 0 between launches; that tile sets it
//     back) takes the halving tree over the tiles in tile order, the same
//     way, and writes H, g, count. Fixed order, no atomic sum: a lane's bits
//     depend on its point count alone, not on the other lanes or on which
//     tile arrived last.
//   An eigenvector's sign does not change H or g: with (-n, -d) the residual,
//   J and b change sign together, and J_i J_j and J_i b keep their bits.
// liorf_scan_update, after the sums (and, with a mesh, their all-reduce):
//   update_kernel, a grid of (point blocks, lanes), each block taking the
//     lane's GN step in float64 itself (the same bits in every block, so no
//     block waits on another): on the first iteration warp 0 takes the
//     Jacobi eigen-decomposition of H (kSweeps6 cyclic sweeps in their order
//     of operations, as a straight-line program of waves, jacobi6_waves.cuh:
//     a rotation waits only for the rotations that last touched its rows, so
//     the 120 rotations' chains run in 51 waves of up to three, on three
//     lanes at once, the matrix in every lane's registers) while warp 1 takes the
//     LU with partial pivoting of [H + 1e-6 I | g] (the first largest pivot,
//     as LAPACK's getrf) and its back substitution; then the good
//     directions' projection P and the degenerate flag (36 threads), the
//     projection, the frozen lane, the convergence test; warp 0 forms the new
//     pose's rotation (cos / sin on six lanes) and the block moves its points
//     of the scan (K1's queries of the next iteration), loaded while the step
//     ran. The lane's first block writes the state; its warp 1 writes the
//     lane's done flag and counts the lane in, and the lanes not done, with
//     one atomic (a counter the wrapper keeps at 0): the last lane to arrive
//     writes the one flag the host reads, every lane done, and sets the
//     counter back. An AND does not depend on the order of arrival.
// liorf_scan_transform: gn_common.cuh's transform_kernel, the first K1's
//   queries.
//
// The order contract (ops/scan_gn.py spells it in torch ops; on the card the
// two agree bit for bit): every operation rounded on its own; a 3-term
// product sum (a0 b0 + a1 b1) + a2 b2; sums over neighbours, over a row's
// entries and over the points (tile, then tiles) halving trees, masked terms
// +0.0; sin and cos in double rounded to float. A shuffle-down tree pairs
// element j with element j + h, the halving tree's pairing; a reciprocal
// (__drcp_rn) is the IEEE quotient 1 / x.
//
// What bounds it: neither bytes (~136 a point: the scan, mask, |p|^(1/4),
// K1's d2 and idx, and the 5 neighbours' coordinates gathered from the
// grid, which sits in L2) nor operations, but latency: a point's chain of 15
// float32 Jacobi rotations (a quotient, 2 square roots and 2 reciprocals
// each), and in the update, on the first iteration, 51 waves of float64
// rotation chains, on a later one the LU's chain. chip_smoke.py's
// scan_gn_profile phase times each phase by clock cycles (a build with
// -DLIORF_SCAN_GN_PROFILE).

#include <utility>

#include "gn_common.cuh"
#include "jacobi6_waves.cuh"

namespace {

using namespace gn;

constexpr int kTerms = 28;    // H's upper triangle (21, row by row), g (6), the count
constexpr int kSweeps3 = 5;   // ops/plane_fit.py::JACOBI3_SWEEPS
constexpr int kSweeps6 = 8;   // ops/scan_gn.py::JACOBI6_SWEEPS
constexpr int kLinWarps = kTile / 32;       // each reduces kTerms / kLinWarps terms
constexpr int kLinThreads = kTile + 32;     // and a warp for the pose's terms
constexpr int kUpdThreads = 256;            // a block of the update
constexpr int kMovePoints = 8;              // points a thread of the update moves
constexpr int kBlockPoints = kUpdThreads * kMovePoints;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 128 && kTerms % kLinWarps == 0, "the tile's tree takes 128 points");

#ifdef LIORF_SCAN_GN_PROFILE
// Development only (built with -DLIORF_SCAN_GN_PROFILE): clock cycles a
// phase of the profiling thread of lane 0's first block, each lap taken
// after the phase's results are used. Slots 0-5 the linearization's
// (prologue, loads and gathers, plane Jacobi, row and terms, the tile's
// tree, the tiles' tree), 6-13 the update's (Jacobi, LU, back
// substitution, P, projection and step, writes, moved scan, all-done flag),
// 14 the tiles' loads (within slot 5).
constexpr int kProfSlots = 15;
__device__ long long g_prof[kProfSlots];
__device__ volatile float g_sink;
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
  __device__ void lap(int slot) {
    const long long now = stamp();
    if (on) g_prof[slot] = now - t;
    t = now;
  }
  template <class T>
  __device__ void lap(int slot, T dep) {
    if (on) g_sink = (float)dep;
    lap(slot);
  }
  __device__ void restart() { t = stamp(); }
};
#else
struct Laps {
  __device__ explicit Laps(bool) {}
  __device__ void lap(int) {}
  template <class T>
  __device__ void lap(int, T) {}
  __device__ void restart() {}
};
#endif

// The halving tree's last five levels over a warp: lane j holds element j
// (j < min(n, 32)); element j + h is added to element j for h = min(n, 32)/2
// ... 1. Lane 0 holds the sum.
__device__ __forceinline__ float warp_levels(float x, int n) {
  for (int h = (n < 32 ? n : 32) / 2; h >= 1; h >>= 1) x = add(x, __shfl_down_sync(kFull, x, h));
  return x;
}

// The same over 32 or more elements, unrolled.
__device__ __forceinline__ float warp_levels32(float x) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) x = add(x, __shfl_down_sync(kFull, x, h));
  return x;
}

// 1 / x rounded once: the IEEE quotient dvd(1.0, x), a shorter sequence
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

struct LinArgs {
  const float* pose;      // [B, 6]
  const float* scan;      // [B, N, 3] sensor frame
  const uint8_t* mask;    // [B, N]
  const float* normq;     // [B, N] |p|^(1/4)
  const float* d2;        // [B, N, 5]
  const int* idx;         // [B, N, 5] into the lane's sorted grid
  const float* grid;      // [B, M, 3]
  float* partial;         // [B, tiles_p2, kTerms] the tiles' sums
  unsigned* arrivals;     // [B] tiles arrived: 0 on entry and on exit
  float* H;               // [B, 6, 6]
  float* g;               // [B, 6]
  int* count;             // [B]
  float corr2, max_resid, min_weight;
  int lanes, n, m, tiles, tiles_p2;
};

// What a point's share needs besides the pose (ops/plane_fit.py::fit_planes,
// the gates): its coordinates, its plane and whether it is selected so far.
struct Fit {
  float p[3], n[3], dpl, normq;
  bool pre;  // mask, 5th-NN gate and a valid plane
};

__device__ __forceinline__ void fit_point(const LinArgs& a, long long pi, const float (&dd)[5],
                                          const int (&id)[5], Fit& f, Laps& laps) {
  const bool gate = dd[4] < a.corr2;
  bool nm[5];
  float wk[5], nb[5][3];
  const long long lane = pi / a.n;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    nm[k] = isfinite(dd[k]) && gate;
    wk[k] = nm[k] ? 1.0f : 0.0f;
    const float* q = a.grid + (lane * a.m + id[k]) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) nb[k][c] = q[c];
  }
  laps.lap(1, nb[0][0] + nb[4][2] + f.p[0]);
  // the plane: centroid, scatter matrix, Jacobi
  float cnt = tree_sum<5>([&](int k) { return wk[k]; });
  cnt = cnt < 1.0f ? 1.0f : cnt;
  float cen[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) cen[c] = dvd(tree_sum<5>([&](int k) { return mul(nb[k][c], wk[k]); }), cnt);
  float cd[5][3];
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) cd[k][c] = mul(sub(nb[k][c], cen[c]), wk[k]);
  float S[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j)
      S[i][j] = S[j][i] = dvd(tree_sum<5>([&](int k) { return mul(cd[k][i], cd[k][j]); }), cnt);
  jacobi<3, kSweeps3>(S, V);
  // the smallest eigenvalue's index (the first on a tie) and the middle one
  const float l0 = S[0][0], l1 = S[1][1], l2 = S[2][2];
  const bool lt = l1 < l0;
  const float low = lt ? l1 : l0;
  int im = lt ? 1 : 0;
  im = l2 < low ? 2 : im;
  const float hi01 = l1 > l0 ? l1 : l0;
  const float m2 = l2 < hi01 ? l2 : hi01;
  const float mid = m2 > low ? m2 : low;
#pragma unroll
  for (int c = 0; c < 3; ++c) f.n[c] = im == 0 ? V[c][0] : (im == 1 ? V[c][1] : V[c][2]);
  laps.lap(2, f.n[0] + f.n[1] + f.n[2] + mid);
  f.dpl = -dot3(f.n[0], f.n[1], f.n[2], cen[0], cen[1], cen[2]);
  bool ok_resid = true, have_all = true;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float resid = fabsf(add(dot3(nb[k][0], nb[k][1], nb[k][2], f.n[0], f.n[1], f.n[2]), f.dpl));
    ok_resid = ok_resid && ((nm[k] ? resid : 0.0f) <= a.max_resid);
    have_all = have_all && nm[k];
  }
  const bool valid = ok_resid && have_all && (mid > (float)2.5e-3);
  f.pre = a.mask[pi] && gate && valid;
}

// The point's share (ops/scan_gn.py::point_terms): its world position, the
// residual, its weight and row; term[] left +0.0 when it is not selected.
__device__ __forceinline__ void row_terms(const LinArgs& a, const Fit& f, const float (&R)[3][3],
                                          const float (&dR)[3][3][3], const float (&t)[3],
                                          float (&term)[kTerms]) {
  float w[3];
  transform(R, t, f.p, w);
  const float pd2 = add(dot3(f.n[0], f.n[1], f.n[2], w[0], w[1], w[2]), f.dpl);
  const float s = sub(1.0f, dvd(mul((float)0.9, fabsf(pd2)), f.normq));
  if (!(f.pre && (s > a.min_weight))) return;
  float J[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) v[r] = dot3(dR[k][r][0], dR[k][r][1], dR[k][r][2], f.p[0], f.p[1], f.p[2]);
    J[k] = mul(dot3(f.n[0], f.n[1], f.n[2], v[0], v[1], v[2]), s);
    J[3 + k] = mul(f.n[k], s);
  }
  const float b = -mul(s, pd2);
  int e = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) term[e++] = mul(J[i], J[j]);
#pragma unroll
  for (int i = 0; i < 6; ++i) term[21 + i] = mul(J[i], b);
  term[27] = 1.0f;
}

// The lane's rotation and its derivatives (ops/scan_gn.py::rot_derivatives)
// into shared memory, by one warp: lanes 0-5 take cos / sin of the three
// angles, lane 0 forms the 39 entries.
__device__ __forceinline__ void pose_terms(const float* pose, int lane, float (&sR)[3][3],
                                           float (&sdR)[3][3][3], float (&st)[3]) {
  float tv = 0.0f;
  if (lane < 6) tv = lane < 3 ? (float)cos((double)pose[lane]) : (float)sin((double)pose[lane - 3]);
  float c[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = __shfl_sync(kFull, tv, k);
    s[k] = __shfl_sync(kFull, tv, 3 + k);
  }
  if (lane != 0) return;
  float R[3][3];
  rot_from_trig(c, s, R);
  const float cr = c[0], cp = c[1], cy = c[2], sr = s[0], sp = s[1], sy = s[2];
  const float dP[3][3] = {{-mul(cy, sp), mul(mul(cy, cp), sr), mul(mul(cy, cp), cr)},
                          {-mul(sy, sp), mul(mul(sy, cp), sr), mul(mul(sy, cp), cr)},
                          {-cp, -mul(sp, sr), -mul(sp, cr)}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sdR[0][i][0] = 0.0f;  // d/droll: [0, R_i2, -R_i1]
    sdR[0][i][1] = R[i][2];
    sdR[0][i][2] = -R[i][1];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sR[i][j] = R[i][j];
      sdR[1][i][j] = dP[i][j];
      // d/dyaw: [-R_1, R_0, 0] by rows
      sdR[2][i][j] = i == 0 ? -R[1][j] : (i == 1 ? R[0][j] : 0.0f);
    }
    st[i] = pose[3 + i];
  }
}

// The halving tree over the lane's tiles, in tile order (the last tile to
// arrive; ops/scan_gn.py::tiled_sum's outer tree), then H, g and count.
__device__ void tiles_tree(const LinArgs& a, int b, float (&red)[kTerms][kTile + 1]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Laps laps(b == 0 && tid == 0);
  const int T = a.tiles_p2;
  float* x = a.partial + (long long)b * T * kTerms;
  if (T > kTile) {
    // the tiles past the points hold zeros; the levels h >= kTile in place
    for (int j = a.tiles * kTerms + tid; j < T * kTerms; j += kLinThreads) x[j] = 0.0f;
    __syncthreads();
    for (int h = T / 2; h >= kTile; h >>= 1) {
      for (int j = tid; j < h * kTerms; j += kLinThreads)
        x[j] = add(__ldcg(x + j), __ldcg(x + j + h * kTerms));
      __syncthreads();
    }
  }
  const int n = T < kTile ? T : kTile;  // elements left: a tile's sums a thread
  const int have = (T > kTile ? kTile : a.tiles) * kTerms;
  // coalesced, every load in flight at once: entry e of the [n, kTerms] sums
  // is tile e / kTerms's term e % kTerms
  constexpr int kPer = (kTile * kTerms + kLinThreads - 1) / kLinThreads;
  float buf[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tid + u * kLinThreads;
    buf[u] = e < have ? __ldcg(x + e) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = tid + u * kLinThreads;
    if (e < n * kTerms) red[e % kTerms][e / kTerms] = buf[u];
  }
  __syncthreads();
  laps.lap(14);
  if (warp >= kLinWarps) return;
  float sum[kTerms / kLinWarps];
  if (n == kTile) {  // the main path's 128 tiles: the tile tree's levels
#pragma unroll
    for (int k = 0; k < kTerms / kLinWarps; ++k) {
      const float* r = red[warp + kLinWarps * k];
      sum[k] = warp_levels32(add(add(r[lane], r[lane + 64]), add(r[lane + 32], r[lane + 96])));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kTerms / kLinWarps; ++k) {
      const float* r = red[warp + kLinWarps * k];
      sum[k] = warp_levels(n == 64 ? add(r[lane], r[lane + 32]) : r[lane], n);
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int k = 0; k < kTerms / kLinWarps; ++k) {
    const int v = warp + kLinWarps * k;
    const float s = sum[k];
    if (v < 21) {
      int i = 0, e = v;
      while (e >= 6 - i) {
        e -= 6 - i;
        ++i;
      }
      const int j = i + e;
      a.H[b * 36 + i * 6 + j] = s;
      a.H[b * 36 + j * 6 + i] = s;
    } else if (v < 27) {
      a.g[b * 6 + v - 21] = s;
    } else {
      a.count[b] = (int)s;
    }
  }
}

__global__ void __launch_bounds__(kLinThreads) linearize_kernel(LinArgs a) {
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  __shared__ float sR[3][3], sdR[3][3][3], st[3];
  __shared__ float red[kTerms][kTile + 1];  // padded: a tile's terms load without bank conflicts
  __shared__ bool last;
  Laps laps(tile == 0 && b == 0 && tid == 0);
  const int i = tile * kTile + tid;
  const bool in = tid < kTile && i < a.n;
  const long long pi = (long long)b * a.n + i;
  // warps 0-3 a point a thread, warp 4 the pose's terms meanwhile
  Fit f;
  float dd[5];
  int id[5];
  if (in) {
#pragma unroll
    for (int c = 0; c < 3; ++c) f.p[c] = a.scan[pi * 3 + c];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      dd[k] = a.d2[pi * 5 + k];
      id[k] = a.idx[pi * 5 + k];
    }
    f.normq = a.normq[pi];
  }
  if (warp == kLinWarps) {
    Laps pro(tile == 0 && b == 0 && lane == 0);
    pose_terms(a.pose + b * 6, lane, sR, sdR, st);
    pro.lap(0);
  }
  f.pre = false;
  if (in) fit_point(a, pi, dd, id, f, laps);
  __syncthreads();
  float term[kTerms];
#pragma unroll
  for (int v = 0; v < kTerms; ++v) term[v] = 0.0f;
  if (f.pre) {
    float R[3][3], dR[3][3][3], t[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      t[r] = st[r];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        R[r][c] = sR[r][c];
#pragma unroll
        for (int k = 0; k < 3; ++k) dR[k][r][c] = sdR[k][r][c];
      }
    }
    row_terms(a, f, R, dR, t, term);
  }
  laps.lap(3, term[0] + term[20] + term[27]);
  if (tid < kTile)
#pragma unroll
    for (int v = 0; v < kTerms; ++v) red[v][tid] = term[v];
  __syncthreads();
  // the tile's halving tree: levels 64 and 32 from shared memory, the last
  // five by shuffle; warp w takes the terms w, w + 4, ...
  if (warp < kLinWarps) {
#pragma unroll
    for (int k = 0; k < kTerms / kLinWarps; ++k) {
      const int v = warp + kLinWarps * k;
      const float* r = red[v];
      const float s = warp_levels32(add(add(r[lane], r[lane + 64]), add(r[lane + 32], r[lane + 96])));
      if (lane == 0) a.partial[((long long)b * a.tiles_p2 + tile) * kTerms + v] = s;
    }
    if (lane == 0) __threadfence();  // the writers' sums before the tile counts itself in
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.arrivals + b, 1u) == (unsigned)(a.tiles - 1);
  __syncthreads();
  laps.lap(4);
  if (!last) return;
  __threadfence();
  if (tid == 0) a.arrivals[b] = 0u;
  Laps tail(b == 0 && tid == 0);
  tiles_tree(a, b, red);
  tail.lap(5);
}

struct UpdArgs {
  const float *H, *g;
  const int* cnt;
  const float* pose;
  const double* P;
  const uint8_t *deg, *done;
  const int *count, *iters;
  const float* scan;
  float* opose;
  double* oP;
  uint8_t *odeg, *odone;
  int *ocount, *oiters;
  float* world;
  uint8_t* all_done;
  unsigned* arrivals;  // [1] lanes arrived: 0 on entry and on exit
  double eigen_thresh;
  float conv_rot, conv_trans;
  int min_points, first, lanes, n;
};

// Named barriers (0 is __syncthreads): `n` threads, whole warps; an arrive
// publishes the arriving threads' prior shared-memory writes to the threads
// that sync.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// |x| of three floats: sqrt((x0 x0 + x1 x1) + x2 x2)
__device__ __forceinline__ float norm3(const float* x) {
  return root(dot3(x[0], x[1], x[2], x[0], x[1], x[2]));
}

// The float64 Jacobi of the lane's H (gn_common.cuh::jacobi's order and
// rotate's operations) as the straight-line wave program of
// jacobi6_waves.cuh: every lane of warp 0 keeps the whole matrix (its
// diagonal d, its upper triangle o) in registers, and the (c, s) of the
// rotations still needed in kSlots register slots; a wave's rotations form
// their (t, c) on lanes 0-2 at once and pass them round by shuffle, and
// every lane applies the row updates; lane r keeps row r of the
// eigenvectors.
namespace waves {
constexpr jacobi6::Program kProgram = jacobi6::build<kSweeps6>();
static_assert(kProgram.n > 0, "the Jacobi program does not fit its table");
constexpr int kRot = jacobi6::kPairs * kSweeps6;
constexpr int kSlots = jacobi6::slots(kProgram, kRot);  // rotation k's (c, s) in slot k % kSlots
// scalar views of the program, which device code may read at compile time
JACOBI6_HD constexpr int ops() { return kProgram.n; }
JACOBI6_HD constexpr int kind(int i) { return kProgram.kind[i]; }
JACOBI6_HD constexpr int count(int i) { return kProgram.count[i]; }
JACOBI6_HD constexpr int rot(int i, int j) { return kProgram.rot[i][j]; }
JACOBI6_HD constexpr int row(int i) { return kProgram.row[i]; }
}  // namespace waves

struct JacobiRegs {
  double d[6], o[jacobi6::kPairs], c[waves::kSlots], s[waves::kSlots], v[6];
};

struct TC {
  double t, c;
};

// A rotation's t and c (rotate's chain: a quotient, two square roots, two
// reciprocals): one copy of the code for every wave (inlined 51 times the
// first iteration measured 30 % slower: the straight-line code is fetched
// cold once a launch).
__device__ __noinline__ TC rotation_tc(double app, double aqq, double apq) {
  double t = 0.0;
  if (apq != 0.0) {
    const double tau = dvd(sub(aqq, app), mul(2.0, apq));
    const double y = rcp(add(absv(tau), root(add(mul(tau, tau), 1.0))));
    t = tau >= 0.0 ? y : -y;
  }
  return TC{t, rcp(root(add(mul(t, t), 1.0)))};
}

// Rotation K's (t, c) from lane `src`; its s and its pair's own entries.
template <int K>
__device__ __forceinline__ void wave_apply(JacobiRegs& g, const TC& tc, int src) {
  constexpr int p = jacobi6::pair_p(K), q = jacobi6::pair_q(K), o = jacobi6::off(p, q);
  constexpr int slot = K % waves::kSlots;
  const double t = __shfl_sync(kFull, tc.t, src), c = __shfl_sync(kFull, tc.c, src);
  const double apq = g.o[o];
  g.c[slot] = c;
  g.s[slot] = mul(t, c);
  g.d[p] = sub(g.d[p], mul(t, apq));
  g.d[q] = add(g.d[q], mul(t, apq));
  g.o[o] = 0.0;
}

template <int I>
__device__ __forceinline__ void jacobi_op(JacobiRegs& g, int lane) {
  using jacobi6::off;
  using jacobi6::pair_p;
  using jacobi6::pair_q;
  constexpr int kind = waves::kind(I);
  if constexpr (kind == jacobi6::kWave) {
    constexpr int n = waves::count(I);
    constexpr int k0 = waves::rot(I, 0);
    constexpr int k1 = n > 1 ? waves::rot(I, 1) : k0, k2 = n > 2 ? waves::rot(I, 2) : k0;
    // lane j < n forms rotation k_j's coefficients
    const int j = lane < n ? lane : 0;
    const double app = j == 1 ? g.d[pair_p(k1)] : (j == 2 ? g.d[pair_p(k2)] : g.d[pair_p(k0)]);
    const double aqq = j == 1 ? g.d[pair_q(k1)] : (j == 2 ? g.d[pair_q(k2)] : g.d[pair_q(k0)]);
    const double apq = j == 1 ? g.o[off(pair_p(k1), pair_q(k1))]
                              : (j == 2 ? g.o[off(pair_p(k2), pair_q(k2))]
                                        : g.o[off(pair_p(k0), pair_q(k0))]);
    const TC tc = rotation_tc(app, aqq, apq);
    wave_apply<k0>(g, tc, 0);
    if constexpr (n > 1) wave_apply<k1>(g, tc, 1);
    if constexpr (n > 2) wave_apply<k2>(g, tc, 2);
  } else if constexpr (kind == jacobi6::kRow) {
    constexpr int k = waves::rot(I, 0), r = waves::row(I), slot = k % waves::kSlots;
    constexpr int a = off(r, pair_p(k)), b = off(r, pair_q(k));
    const double x = g.o[a], y = g.o[b], c = g.c[slot], s = g.s[slot];
    g.o[a] = sub(mul(c, x), mul(s, y));
    g.o[b] = add(mul(s, x), mul(c, y));
  } else {
    constexpr int k = waves::rot(I, 0), p = pair_p(k), q = pair_q(k), slot = k % waves::kSlots;
    const double vp = g.v[p], vq = g.v[q], c = g.c[slot], s = g.s[slot];
    g.v[p] = sub(mul(c, vp), mul(s, vq));
    g.v[q] = add(mul(s, vp), mul(c, vq));
  }
}

template <int... I>
__device__ __forceinline__ void jacobi_ops(JacobiRegs& g, int lane, std::integer_sequence<int, I...>) {
  (jacobi_op<I>(g, lane), ...);
}

// The eigenvalues (unsorted) into lam, the eigenvectors into V's columns.
__device__ void jacobi_warp(const float* H, int lane, double (&V)[6][6], double (&lam)[6]) {
  JacobiRegs g;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    g.d[i] = (double)H[i * 6 + i];
    g.v[i] = lane == i ? 1.0 : 0.0;
#pragma unroll
    for (int j = i + 1; j < 6; ++j)
      g.o[jacobi6::off(i, j)] = (double)(i == 0 && j == 1 ? H[1] : H[j * 6 + i]);
  }
  jacobi_ops(g, lane, std::make_integer_sequence<int, waves::ops()>{});
  if (lane < 6) {
    lam[lane] = g.d[lane];
#pragma unroll
    for (int c = 0; c < 6; ++c) V[lane][c] = g.v[c];
  }
}

// x = solve(H + 1e-6 I, g): LU with partial pivoting on [A | g] (the first
// largest pivot, as LAPACK's getrf), then back substitution, each row's sum
// a halving tree; one thread. (Rows on a warp's lanes measured slower: the
// chain is the pivot step's quotients, and the shuffles lengthen it.)
__device__ void lu_solve(const float* H, const float* g, double (&sx)[6], Laps& laps) {
  double M[6][7];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) M[i][j] = (double)H[i * 6 + j];
    M[i][i] = add(M[i][i], 1e-6);
    M[i][6] = (double)g[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    double best = fabs(M[k][k]);
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const double v = fabs(M[r][k]);
      if (v > best) {
        piv = r;
        best = v;
      }
    }
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      if (r != piv) continue;
#pragma unroll
      for (int c = 0; c < 7; ++c) {
        const double tmp = M[k][c];
        M[k][c] = M[r][c];
        M[r][c] = tmp;
      }
    }
#pragma unroll
    for (int r = k + 1; r < 6; ++r) {
      const double l = dvd(M[r][k], M[k][k]);
#pragma unroll
      for (int c = k + 1; c < 7; ++c) M[r][c] = sub(M[r][c], mul(l, M[k][c]));
    }
  }
  laps.lap(7, M[5][5] + M[5][6]);
  double x[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    const double s = tree_sum<6>([&](int j) { return j > k ? mul(M[k][j], x[j]) : 0.0; });
    x[k] = dvd(sub(M[k][6], s), M[k][k]);
  }
  laps.lap(8, x[0]);
#pragma unroll
  for (int k = 0; k < 6; ++k) sx[k] = x[k];
}

// The lane's GN step (ops/scan_gn.py::scan_update_plain) and its block of
// the moved scan.
__global__ void __launch_bounds__(kUpdThreads) update_kernel(UpdArgs a) {
  const int blk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  __shared__ double sV[6][6], sLam[6], sX[6], sP[36];
  __shared__ float sR[3][3], st[3];
  __shared__ uint8_t sDone;
  Laps laps(blk == 0 && b == 0 && tid == 0);
  Laps laps1(blk == 0 && b == 0 && tid == 32);
  const float* H = a.H + b * 36;
  // the block's points, loaded now and moved once the new pose is known
  const long long base = (long long)b * a.n + (long long)blk * kBlockPoints + tid;
  const long long left = (long long)a.n - (long long)blk * kBlockPoints - tid;
  float px[kMovePoints][3];
#pragma unroll
  for (int k = 0; k < kMovePoints; ++k)
    if (k * kUpdThreads < left)
#pragma unroll
      for (int c = 0; c < 3; ++c) px[k][c] = a.scan[(base + k * kUpdThreads) * 3 + c];
  if (warp == 0) {
    if (a.first) jacobi_warp(H, lane, sV, sLam);
  } else if (warp == 1) {
    if (lane == 0) lu_solve(H, a.g + b * 6, sX, laps1);
  } else if (!a.first && tid >= 64 && tid < 100) {
    sP[tid - 64] = a.P[b * 36 + tid - 64];
  }
  laps.lap(6);
  __syncthreads();
  if (a.first) {
    // P = V_good V_good^T, each entry a halving tree over the eigenvectors
    if (tid >= 64 && tid < 100) {
      const int i = (tid - 64) / 6, j = (tid - 64) % 6;
      sP[tid - 64] = tree_sum<6>([&](int k) {
        return sLam[k] >= a.eigen_thresh ? mul(sV[i][k], sV[j][k]) : 0.0;
      });
    }
    __syncthreads();
  }
  laps.lap(9);
  if (blk == 0 && tid >= 64 && tid < 100) a.oP[b * 36 + tid - 64] = sP[tid - 64];
  // Warp 0 takes the step and the new pose's rotation; in the lane's first
  // block warp 1 counts the lane in as soon as its done flag is known
  // (barrier 1), while the rotation is formed; warps 2-7 (barrier 2) and
  // warp 1 (barrier 3) wait only for the rotation.
  if (warp == 0) {
    float pose[6];
    if (lane == 0) {
      bool degenerate = false;
      if (a.first) {
#pragma unroll
        for (int k = 0; k < 6; ++k) degenerate = degenerate || !(sLam[k] >= a.eigen_thresh);
      } else {
        degenerate = a.deg[b];
      }
      double x[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = sX[k];
      if (degenerate) {
        double y[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) y[i] = tree_sum<6>([&](int j) { return mul(sP[i * 6 + j], x[j]); });
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = y[i];
      }
      const int cnt = a.cnt[b];
      const bool enough = cnt >= a.min_points;
      float xf[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) xf[i] = enough ? (float)x[i] : 0.0f;
      const bool live = !a.done[b];
#pragma unroll
      for (int i = 0; i < 6; ++i) pose[i] = live ? add(a.pose[b * 6 + i], xf[i]) : a.pose[b * 6 + i];
      const float drot = mul(norm3(xf), (float)57.29577951308232);
      const float dtrans = mul(norm3(xf + 3), 100.0f);
      const bool converged = (drot < a.conv_rot) && (dtrans < a.conv_trans);
      sDone = !live || converged || !enough;
      laps.lap(10, pose[0]);
      if (blk == 0) {
#pragma unroll
        for (int i = 0; i < 6; ++i) a.opose[b * 6 + i] = pose[i];
        a.odeg[b] = degenerate;
        a.ocount[b] = live ? cnt : a.count[b];
        a.oiters[b] = a.iters[b] + (live ? 1 : 0);
      }
      laps.lap(11);
    }
    __syncwarp();
    if (blk == 0) bar_arrive(1, 64);
    // the new pose's rotation: cos / sin on lanes 0-5
#pragma unroll
    for (int i = 0; i < 6; ++i) pose[i] = __shfl_sync(kFull, pose[i], 0);
    float tv = 0.0f;
    if (lane < 6) tv = lane < 3 ? (float)cos((double)pose[lane]) : (float)sin((double)pose[lane - 3]);
    float c[3], s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = __shfl_sync(kFull, tv, k);
      s[k] = __shfl_sync(kFull, tv, 3 + k);
    }
    if (lane == 0) {
      rot_from_trig(c, s, sR);
#pragma unroll
      for (int k = 0; k < 3; ++k) st[k] = pose[3 + k];
    }
    __syncwarp();
    bar_arrive(2, kUpdThreads - 32);
    bar_arrive(3, 64);
  } else if (warp == 1) {
    if (blk == 0) {
      bar_sync(1, 64);
      laps1.restart();
      if (lane == 0) {
        // the lane's done flag; the lane counts itself in (low half) and,
        // when it is not done, into the lanes not done (high half) with one
        // atomic, so the last lane to arrive knows every lane's AND without
        // reading their flags; it writes the flag and sets the counter back
        a.odone[b] = sDone;
        const unsigned mine = 1u + (sDone ? 0u : 1u << 16);
        const unsigned old = atomicAdd(a.arrivals, mine) + mine;
        if ((old & 0xffffu) == (unsigned)a.lanes) {
          *a.all_done = (old >> 16) == 0u;
          atomicExch(a.arrivals, 0u);
        }
        laps1.lap(13);
      }
    }
    bar_sync(3, 64);
  } else {
    bar_sync(2, kUpdThreads - 32);
  }
  float R[3][3], t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    t[r] = st[r];
#pragma unroll
    for (int c = 0; c < 3; ++c) R[r][c] = sR[r][c];
  }
#pragma unroll
  for (int k = 0; k < kMovePoints; ++k)
    if (k * kUpdThreads < left) transform(R, t, px[k], a.world + (base + k * kUpdThreads) * 3);
  laps.lap(12);
}

}  // namespace

// Kernels this library launched (host side): chip_smoke.py counts a call's.
static long long g_launches = 0;

extern "C" {

long long liorf_scan_gn_kernel_launches() { return g_launches; }

#ifdef LIORF_SCAN_GN_PROFILE
// The last launches' cycles a phase (kProfSlots entries).
int liorf_scan_gn_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * kProfSlots);
}
#endif

// (H, g, count) of `lanes` lanes of `n` points on `stream`; `partial` is
// scratch of [lanes, pow2ceil(ceil(n / kTile)), kTerms] floats, `arrivals`
// [lanes] counters that are 0 (and are 0 again after the launch).
int liorf_scan_linearize(const void* pose, const void* scan, const void* mask, const void* normq,
                         const void* d2, const void* idx, const void* grid, void* partial, void* H,
                         void* g, void* count, void* arrivals, float corr2, float max_resid,
                         float min_weight, int lanes, int n, int m, void* stream) {
  if (lanes == 0) return 0;
  LinArgs a;
  a.pose = (const float*)pose; a.scan = (const float*)scan; a.mask = (const uint8_t*)mask;
  a.normq = (const float*)normq; a.d2 = (const float*)d2; a.idx = (const int*)idx;
  a.grid = (const float*)grid; a.partial = (float*)partial; a.arrivals = (unsigned*)arrivals;
  a.H = (float*)H; a.g = (float*)g; a.count = (int*)count; a.corr2 = corr2;
  a.max_resid = max_resid; a.min_weight = min_weight; a.lanes = lanes; a.n = n; a.m = m;
  a.tiles = n <= 0 ? 1 : (n + gn::kTile - 1) / gn::kTile;
  a.tiles_p2 = gn::pow2ceil(a.tiles);
  linearize_kernel<<<dim3(a.tiles, lanes), kLinThreads, 0, (cudaStream_t)stream>>>(a);
  ++g_launches;
  return (int)cudaGetLastError();
}

// The GN step of `lanes` lanes and their scans of `n` points moved by the new
// poses, on `stream`. Pointers in the order of UpdArgs; `arrivals` is one
// counter that is 0 (and is 0 again after the launch).
int liorf_scan_update(const void* H, const void* g, const void* cnt, const void* pose,
                      const void* P, const void* deg, const void* done, const void* count,
                      const void* iters, const void* scan, void* opose, void* oP, void* odeg,
                      void* odone, void* ocount, void* oiters, void* world, void* all_done,
                      void* arrivals, double eigen_thresh, float conv_rot, float conv_trans,
                      int min_points, int first, int lanes, int n, void* stream) {
  if (lanes == 0) return 0;
  UpdArgs a;
  a.H = (const float*)H; a.g = (const float*)g; a.cnt = (const int*)cnt;
  a.pose = (const float*)pose; a.P = (const double*)P; a.deg = (const uint8_t*)deg;
  a.done = (const uint8_t*)done; a.count = (const int*)count; a.iters = (const int*)iters;
  a.scan = (const float*)scan; a.opose = (float*)opose; a.oP = (double*)oP;
  a.odeg = (uint8_t*)odeg; a.odone = (uint8_t*)odone; a.ocount = (int*)ocount;
  a.oiters = (int*)oiters; a.world = (float*)world; a.all_done = (uint8_t*)all_done;
  a.arrivals = (unsigned*)arrivals;
  a.eigen_thresh = eigen_thresh; a.conv_rot = conv_rot; a.conv_trans = conv_trans;
  a.min_points = min_points; a.first = first; a.lanes = lanes; a.n = n;
  const int blocks = n <= 0 ? 1 : (n + kBlockPoints - 1) / kBlockPoints;
  update_kernel<<<dim3(blocks, lanes), kUpdThreads, 0, (cudaStream_t)stream>>>(a);
  ++g_launches;
  return (int)cudaGetLastError();
}

// The points [lanes, n, 3] of every lane moved by its pose [lanes, 6], on
// `stream`: the first K1's queries of a match (later ones come from the
// update).
int liorf_scan_transform(const void* pose, const void* xyz, void* out, int lanes, int n,
                         void* stream) {
  if (n > 0 && lanes > 0) ++g_launches;
  return gn::launch_transform((const float*)pose, (const float*)xyz, (float*)out, lanes, n,
                              (cudaStream_t)stream);
}

}  // extern "C"
