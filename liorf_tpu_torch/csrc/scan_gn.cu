// The scan matcher's Gauss-Newton iteration (ops/scan_match.py::
// scan_to_map_lanes) as two calls for NVIDIA Hopper (sm_90a); plain C
// interface.
//
// Built by ops/scan_gn.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launches' error code.
//
// Not a TPU kernel: the JAX package does this work in XLA
// (liorf_tpu/ops/scan_match.py:83-121, :164-195; liorf_tpu/ops/plane_fit.py:
// 22-55). Op by op on the card a GN iteration was ~40 eager launches, a
// cuSOLVER batched eigh of the [N, 3, 3] scatter matrices and a solve of the
// [B, 6, 6] systems, each of which made the host wait for the card.
//
// liorf_scan_linearize, after kernel K1 (the 5-NN search, its own launch):
//   linearize_kernel, one thread a scan point, one block a tile of kTile
//     points, a grid of (tiles, lanes): the point's world position, the 5th-NN
//     gate, its 5 neighbours read from the grid by K1's indices (no
//     [B, N, 5, 3] tensor is written), their centroid and scatter matrix, the
//     plane's normal by cyclic Jacobi (float32, kSweeps3 sweeps: the
//     smallest eigenvalue's eigenvector; the middle eigenvalue judges
//     collinearity), the residual gate, the weight, the point's row
//     J = [n . (dR_k p), n] s and share of b; then the block's halving tree
//     over its tile of the 28 sums (H's upper triangle, g, the count). dR_k
//     is formed once a block.
//   sums_kernel, one block a lane: the halving tree over the tiles; H, g,
//     count. Fixed order, no atomics: a lane's bits depend on its point count
//     alone, not on the other lanes.
//   An eigenvector's sign does not change H or g: with (-n, -d) the residual,
//   J and b change sign together, and J_i J_j and J_i b keep their bits.
// liorf_scan_update, after the sums (and, with a mesh, their all-reduce):
//   update_kernel, one warp a lane: its thread 0 takes the lane's GN step in
//     float64 (on the first iteration the Jacobi eigen-decomposition of H,
//     kSweeps6 sweeps, the good directions' projection P and the degenerate
//     flag; then LU with partial pivoting of [H + 1e-6 I | g], the first
//     largest pivot, as LAPACK's getrf; the projection), the frozen lane,
//     the convergence test;
//   transform_kernel (gn_common.cuh), one thread a point: the scan moved by
//     the new poses, K1's queries of the next iteration;
//   all_done_kernel: the one flag the host reads.
// liorf_scan_transform: transform_kernel alone, the first K1's queries.
//
// The order contract (ops/scan_gn.py spells it in torch ops; on the card the
// two agree bit for bit): every operation rounded on its own; a 3-term
// product sum (a0 b0 + a1 b1) + a2 b2; sums over neighbours, over a row's
// entries and over the points (tile, then tiles) halving trees, masked terms
// +0.0; sin and cos in double rounded to float.
//
// What bounds it: bytes, at ~136 a point (the scan, mask, |p|^(1/4), K1's
// d2 and idx, and the 5 neighbours' coordinates gathered from the grid,
// which sits in L2); the Jacobi rotations (15 a point, 2 square roots and 2
// divisions each) are the operations. The update is latency: one thread's
// dependent chain, 120 float64 Jacobi rotations on the first iteration.

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int kTerms = 28;    // H's upper triangle (21, row by row), g (6), the count
constexpr int kSweeps3 = 5;   // ops/plane_fit.py::JACOBI3_SWEEPS
constexpr int kSweeps6 = 8;   // ops/scan_gn.py::JACOBI6_SWEEPS
constexpr int kSumThreads = 256;
constexpr int kUpdThreads = 32;  // one warp a lane; its thread 0 takes the step

struct LinArgs {
  const float* pose;      // [B, 6]
  const float* scan;      // [B, N, 3] sensor frame
  const uint8_t* mask;    // [B, N]
  const float* normq;     // [B, N] |p|^(1/4)
  const float* d2;        // [B, N, 5]
  const int* idx;         // [B, N, 5] into the lane's sorted grid
  const float* grid;      // [B, M, 3]
  float* partial;         // [B, tiles, kTerms]
  float* H;               // [B, 6, 6]
  float* g;               // [B, 6]
  int* count;             // [B]
  float corr2, max_resid, min_weight;
  int lanes, n, m, tiles;
};

// A point's share of the sums (ops/scan_gn.py::point_terms after
// ops/plane_fit.py::fit_planes); term[] left +0.0 when it is not selected.
__device__ __forceinline__ void point_terms(const LinArgs& a, long long pi, const float (&R)[3][3],
                                            const float (&dR)[3][3][3], const float (&t)[3],
                                            float (&term)[kTerms]) {
  const float p[3] = {a.scan[pi * 3], a.scan[pi * 3 + 1], a.scan[pi * 3 + 2]};
  float w[3];
  transform(R, t, p, w);
  float dd[5];
  int id[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    dd[k] = a.d2[pi * 5 + k];
    id[k] = a.idx[pi * 5 + k];
  }
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
  float n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = im == 0 ? V[c][0] : (im == 1 ? V[c][1] : V[c][2]);
  const float dpl = -dot3(n[0], n[1], n[2], cen[0], cen[1], cen[2]);
  bool ok_resid = true, have_all = true;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float resid = fabsf(add(dot3(nb[k][0], nb[k][1], nb[k][2], n[0], n[1], n[2]), dpl));
    ok_resid = ok_resid && ((nm[k] ? resid : 0.0f) <= a.max_resid);
    have_all = have_all && nm[k];
  }
  const bool valid = ok_resid && have_all && (mid > (float)2.5e-3);
  // the residual, its weight and the row
  const float pd2 = add(dot3(n[0], n[1], n[2], w[0], w[1], w[2]), dpl);
  const float s = sub(1.0f, dvd(mul((float)0.9, fabsf(pd2)), a.normq[pi]));
  const bool sel = a.mask[pi] && gate && valid && (s > a.min_weight);
  if (!sel) return;
  float J[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) v[r] = dot3(dR[k][r][0], dR[k][r][1], dR[k][r][2], p[0], p[1], p[2]);
    J[k] = mul(dot3(n[0], n[1], n[2], v[0], v[1], v[2]), s);
    J[3 + k] = mul(n[k], s);
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

__global__ void __launch_bounds__(kTile) linearize_kernel(LinArgs a) {
  const int tile = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  __shared__ float sR[3][3], sdR[3][3][3], st[3];
  __shared__ float red[kTerms][kTile];
  if (tid == 0) {
    // the lane's rotation and its derivatives (ops/scan_gn.py::rot_derivatives)
    const float* pose = a.pose + b * 6;
    float c[3], s[3], R[3][3];
    trig(pose, c, s);
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
  __syncthreads();
  float R[3][3], dR[3][3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = st[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      R[i][j] = sR[i][j];
#pragma unroll
      for (int k = 0; k < 3; ++k) dR[k][i][j] = sdR[k][i][j];
    }
  }
  float term[kTerms];
#pragma unroll
  for (int v = 0; v < kTerms; ++v) term[v] = 0.0f;
  const int i = tile * kTile + tid;
  if (i < a.n) point_terms(a, (long long)b * a.n + i, R, dR, t, term);
#pragma unroll
  for (int v = 0; v < kTerms; ++v) red[v][tid] = term[v];
  __syncthreads();
  // the tile's halving tree: element j + h added to element j
#pragma unroll
  for (int h = kTile / 2; h >= 1; h >>= 1) {
    if (tid < h)
#pragma unroll
      for (int v = 0; v < kTerms; ++v) red[v][tid] = add(red[v][tid], red[v][tid + h]);
    __syncthreads();
  }
  if (tid < kTerms) a.partial[((long long)b * a.tiles + tile) * kTerms + tid] = red[tid][0];
}

__global__ void __launch_bounds__(kSumThreads) sums_kernel(LinArgs a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  float* x = a.partial + (long long)b * a.tiles * kTerms;
  // the halving tree over the tiles (a.tiles is a power of two; the tiles
  // past the points hold zeros), in place
  for (int h = a.tiles / 2; h >= 1; h >>= 1) {
    for (int j = tid; j < h * kTerms; j += kSumThreads) {
      const int t = j / kTerms, v = j % kTerms;
      x[t * kTerms + v] = add(x[t * kTerms + v], x[(t + h) * kTerms + v]);
    }
    __syncthreads();
  }
  if (tid < 21) {
    int i = 0, e = tid;
    while (e >= 6 - i) {
      e -= 6 - i;
      ++i;
    }
    const int j = i + e;
    a.H[b * 36 + i * 6 + j] = x[tid];
    a.H[b * 36 + j * 6 + i] = x[tid];
  } else if (tid < 27) {
    a.g[b * 6 + tid - 21] = x[tid];
  } else if (tid == 27) {
    a.count[b] = (int)x[27];
  }
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
  double eigen_thresh;
  float conv_rot, conv_trans;
  int min_points, first, lanes, n;
};

// |x| of three floats: sqrt((x0 x0 + x1 x1) + x2 x2)
__device__ __forceinline__ float norm3(const float* x) {
  return root(dot3(x[0], x[1], x[2], x[0], x[1], x[2]));
}

// The lane's GN step (ops/scan_gn.py::scan_update_plain), one thread.
__device__ void gn_step(const UpdArgs& a, int b) {
  double P[6][6];
  bool degenerate;
  if (a.first) {
    double E[6][6], V[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) E[i][j] = (double)a.H[b * 36 + i * 6 + j];
    jacobi<6, kSweeps6>(E, V);
    bool good[6];
    degenerate = false;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      good[k] = E[k][k] >= a.eigen_thresh;
      degenerate = degenerate || !good[k];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        P[i][j] = tree_sum<6>([&](int k) { return good[k] ? mul(V[i][k], V[j][k]) : 0.0; });
  } else {
#pragma unroll
    for (int i = 0; i < 36; ++i) P[i / 6][i % 6] = a.P[b * 36 + i];
    degenerate = a.deg[b];
  }
  // x = solve(H + 1e-6 I, g): LU with partial pivoting on [A | g]
  double M[6][7];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) M[i][j] = (double)a.H[b * 36 + i * 6 + j];
    M[i][i] = add(M[i][i], 1e-6);
    M[i][6] = (double)a.g[b * 6 + i];
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
  double x[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    const double s = tree_sum<6>([&](int j) { return j > k ? mul(M[k][j], x[j]) : 0.0; });
    x[k] = dvd(sub(M[k][6], s), M[k][k]);
  }
  if (degenerate) {
    double y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) y[i] = tree_sum<6>([&](int j) { return mul(P[i][j], x[j]); });
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = y[i];
  }
  const int cnt = a.cnt[b];
  const bool enough = cnt >= a.min_points;
  float xf[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xf[i] = enough ? (float)x[i] : 0.0f;
  const bool live = !a.done[b];
  float pose[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    pose[i] = live ? add(a.pose[b * 6 + i], xf[i]) : a.pose[b * 6 + i];
    a.opose[b * 6 + i] = pose[i];
  }
  const float drot = mul(norm3(xf), (float)57.29577951308232);
  const float dtrans = mul(norm3(xf + 3), 100.0f);
  const bool converged = (drot < a.conv_rot) && (dtrans < a.conv_trans);
#pragma unroll
  for (int i = 0; i < 36; ++i) a.oP[b * 36 + i] = P[i / 6][i % 6];
  a.odeg[b] = degenerate;
  a.odone[b] = !live || converged || !enough;
  a.ocount[b] = live ? cnt : a.count[b];
  a.oiters[b] = a.iters[b] + (live ? 1 : 0);
}

__global__ void __launch_bounds__(kUpdThreads) update_kernel(UpdArgs a) {
  if (threadIdx.x == 0) gn_step(a, blockIdx.x);
}

}  // namespace

extern "C" {

// (H, g, count) of `lanes` lanes of `n` points on `stream`; `partial` is
// scratch of [lanes, pow2ceil(ceil(n / kTile)), kTerms] floats.
int liorf_scan_linearize(const void* pose, const void* scan, const void* mask, const void* normq,
                         const void* d2, const void* idx, const void* grid, void* partial, void* H,
                         void* g, void* count, float corr2, float max_resid, float min_weight,
                         int lanes, int n, int m, void* stream) {
  if (lanes == 0) return 0;
  LinArgs a;
  a.pose = (const float*)pose; a.scan = (const float*)scan; a.mask = (const uint8_t*)mask;
  a.normq = (const float*)normq; a.d2 = (const float*)d2; a.idx = (const int*)idx;
  a.grid = (const float*)grid; a.partial = (float*)partial; a.H = (float*)H; a.g = (float*)g;
  a.count = (int*)count; a.corr2 = corr2; a.max_resid = max_resid; a.min_weight = min_weight;
  a.lanes = lanes; a.n = n; a.m = m;
  a.tiles = gn::pow2ceil(n <= 0 ? 1 : (n + gn::kTile - 1) / gn::kTile);
  cudaStream_t s = (cudaStream_t)stream;
  linearize_kernel<<<dim3(a.tiles, lanes), gn::kTile, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sums_kernel<<<lanes, kSumThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The GN step of `lanes` lanes and their scans of `n` points moved by the new
// poses, on `stream`. Pointers in the order of UpdArgs.
int liorf_scan_update(const void* H, const void* g, const void* cnt, const void* pose,
                      const void* P, const void* deg, const void* done, const void* count,
                      const void* iters, const void* scan, void* opose, void* oP, void* odeg,
                      void* odone, void* ocount, void* oiters, void* world, void* all_done,
                      double eigen_thresh, float conv_rot, float conv_trans, int min_points,
                      int first, int lanes, int n, void* stream) {
  if (lanes == 0) return 0;
  UpdArgs a;
  a.H = (const float*)H; a.g = (const float*)g; a.cnt = (const int*)cnt;
  a.pose = (const float*)pose; a.P = (const double*)P; a.deg = (const uint8_t*)deg;
  a.done = (const uint8_t*)done; a.count = (const int*)count; a.iters = (const int*)iters;
  a.scan = (const float*)scan; a.opose = (float*)opose; a.oP = (double*)oP;
  a.odeg = (uint8_t*)odeg; a.odone = (uint8_t*)odone; a.ocount = (int*)ocount;
  a.oiters = (int*)oiters; a.world = (float*)world; a.all_done = (uint8_t*)all_done;
  a.eigen_thresh = eigen_thresh; a.conv_rot = conv_rot; a.conv_trans = conv_trans;
  a.min_points = min_points; a.first = first; a.lanes = lanes; a.n = n;
  cudaStream_t s = (cudaStream_t)stream;
  update_kernel<<<lanes, kUpdThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the scan moved by the new poses: the next K1's queries
  const int terr = gn::launch_transform(a.opose, a.scan, a.world, lanes, n, s);
  if (terr != 0) return terr;
  gn::all_done_kernel<<<1, 32, 0, s>>>(a.odone, lanes, a.all_done);
  return (int)cudaGetLastError();
}

// The points [lanes, n, 3] of every lane moved by its pose [lanes, 6], on
// `stream`: the first K1's queries of a match (later ones come from the
// update).
int liorf_scan_transform(const void* pose, const void* xyz, void* out, int lanes, int n,
                         void* stream) {
  return gn::launch_transform((const float*)pose, (const float*)xyz, (float*)out, lanes, n,
                              (cudaStream_t)stream);
}

}  // extern "C"
