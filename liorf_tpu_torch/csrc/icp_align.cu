// ICP's alignment step (ops/icp.py::icp_point2point_lanes) in one call for
// NVIDIA Hopper (sm_90a); plain C interface.
//
// Built by ops/icp_align.py with the flags of core/build.py and loaded with
// ctypes; launches on the stream it is given, allocates nothing, never
// synchronises, returns the launches' error code.
//
// Not a TPU kernel: the JAX package does this step in XLA
// (liorf_tpu/ops/icp.py:73-91). Op by op on the card it was ~30 eager
// launches and a library SVD (with a determinant) an ICP iteration, each of
// which made the host wait for the card.
//
// liorf_icp_align, after kernel K2 (the 1-NN search, its own launch):
//   align_kernel, one block a lane: each warp sums tiles of kTile points (4 a
//     thread, in the halving tree's pairs, then shuffles), first the
//     correspondences within max_d2 (their count, the moved source's and the
//     matched targets' coordinates), then, from the means, the 3x3
//     cross-covariance S of their deviations; the tiles' halving tree in
//     shared memory after each pass. Thread 0 then finds the optimal proper
//     rotation by Horn's quaternion method (the eigenvector of the largest
//     eigenvalue of the 4x4 symmetric matrix built from S, cyclic Jacobi in
//     double: the same minimizer as Kabsch's U diag(1, 1, det) V^T, the
//     reflection case included, with no SVD), the translation, the
//     composition with the lane's pose, rot_to_euler with its gimbal branch
//     (all in double, rounded to float once), the change and the lane's done
//     flag;
//   transform_kernel (gn_common.cuh), one thread a point: the source moved by
//     the new poses, K2's queries of the next iteration;
//   all_done_kernel: the one flag the host reads.
//
// The order contract is ops/scan_gn.py's (ops/icp_align.py spells this
// kernel's in torch ops; on the card the two agree bit for bit); asin and
// atan2 in double.
//
// What bounds it: bytes (~57 a point: the moved source, d2, idx, the mask, the
// matched target gathered from L2, the source and the moved source written),
// the sums' read twice by one block a lane (the lanes side by side).

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSweeps4 = 6;  // ops/icp_align.py::JACOBI4_SWEEPS
constexpr int kSums = 9;     // the widest pass: S's 9 entries

struct Args {
  const float* pose;       // [B, 6]
  const uint8_t* done;     // [B]
  const int* iters;        // [B]
  const float* moved;      // [B, N, 3]
  const float* d2;         // [B, N]
  const int* idx;          // [B, N] into the lane's target
  const float* target;     // [B, M, 3]
  const uint8_t* mask;     // [B, N] the source's
  const float* source;     // [B, N, 3]
  float* opose;
  uint8_t* odone;
  int* oiters;
  float* moved_next;       // [B, N, 3]
  uint8_t* all_done;
  float max_d2, epsilon;
  int lanes, n, m, tiles;
};

// A warp's sum of K terms over the tile `tt`: lane l holds the points l,
// l + 32, l + 64, l + 96 and adds them in the halving tree's pairs
// ((x_l + x_{l+64}) + (x_{l+32} + x_{l+96})), then the shuffles add lane
// l + h to lane l. Lane 0 writes the tile's sums.
template <int K, class F>
__device__ __forceinline__ void warp_tile(int tt, int lane, float* out, F terms) {
  float x[4][K];
#pragma unroll
  for (int j = 0; j < 4; ++j) terms(tt * kTile + lane + 32 * j, x[j]);
  float acc[K];
#pragma unroll
  for (int v = 0; v < K; ++v) acc[v] = add(add(x[0][v], x[2][v]), add(x[1][v], x[3][v]));
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1)
#pragma unroll
    for (int v = 0; v < K; ++v) acc[v] = add(acc[v], __shfl_down_sync(0xffffffffu, acc[v], h));
  if (lane == 0)
#pragma unroll
    for (int v = 0; v < K; ++v) out[tt * K + v] = acc[v];
}

// The halving tree over the tiles' sums part[tiles][K] (tiles a power of
// two), in place; the block's threads share each level.
template <int K>
__device__ __forceinline__ void tile_tree(float* part, int tiles) {
  for (int h = tiles / 2; h >= 1; h >>= 1) {
    for (int j = threadIdx.x; j < h * K; j += kThreads) {
      const int t = j / K, v = j % K;
      part[t * K + v] = add(part[t * K + v], part[(t + h) * K + v]);
    }
    __syncthreads();
  }
}

// (a0 b0 + a1 b1) + a2 b2 of rows and columns of 3x3 doubles
__device__ __forceinline__ void matmul3(const double (&A)[3][3], const double (&B)[3][3],
                                        double (&C)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = dot3(A[i][0], A[i][1], A[i][2], B[0][j], B[1][j], B[2][j]);
}

// The lane's new pose from the sums (ops/icp_align.py::icp_align_plain after
// the point sums), one thread.
__device__ void align(const Args& a, int b, const float (&mu_s)[3], const float (&mu_t)[3],
                      const float* Sf) {
  // Horn's matrix, h(a, b) = S[b][a]
  double S[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) S[i / 3][i % 3] = (double)Sf[i];
  auto h = [&](int x, int y) { return S[y][x]; };
  const double xx = h(0, 0), yy = h(1, 1), zz = h(2, 2);
  const double yz = h(1, 2), zy = h(2, 1), zx = h(2, 0), xz = h(0, 2), xy = h(0, 1), yx = h(1, 0);
  double N[4][4] = {
      {add(add(xx, yy), zz), sub(yz, zy), sub(zx, xz), sub(xy, yx)},
      {sub(yz, zy), sub(sub(xx, yy), zz), add(xy, yx), add(zx, xz)},
      {sub(zx, xz), add(xy, yx), sub(sub(yy, xx), zz), add(yz, zy)},
      {sub(xy, yx), add(zx, xz), add(yz, zy), add(sub(-xx, yy), zz)}};
  double V[4][4];
  jacobi<4, kSweeps4>(N, V);
  int k = 0;
  double best = N[0][0];
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (N[j][j] > best) {
      k = j;
      best = N[j][j];
    }
  double q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = k == 0 ? V[r][0] : (k == 1 ? V[r][1] : (k == 2 ? V[r][2] : V[r][3]));
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  const double Rd[3][3] = {
      {sub(1.0, mul(2.0, add(mul(y, y), mul(z, z)))), mul(2.0, sub(mul(x, y), mul(w, z))),
       mul(2.0, add(mul(x, z), mul(w, y)))},
      {mul(2.0, add(mul(x, y), mul(w, z))), sub(1.0, mul(2.0, add(mul(x, x), mul(z, z)))),
       mul(2.0, sub(mul(y, z), mul(w, x)))},
      {mul(2.0, sub(mul(x, z), mul(w, y))), mul(2.0, add(mul(y, z), mul(w, x))),
       sub(1.0, mul(2.0, add(mul(x, x), mul(y, y))))}};
  // the translation and the composition with the rotation that moved the source
  const float* pose = a.pose + b * 6;
  float R0f[3][3];
  rot_f32(pose, R0f);
  double R0[3][3], Rn[3][3], tn[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R0[i / 3][i % 3] = (double)R0f[i / 3][i % 3];
  matmul3(Rd, R0, Rn);
  const double ms[3] = {(double)mu_s[0], (double)mu_s[1], (double)mu_s[2]};
  const double t0[3] = {(double)pose[3], (double)pose[4], (double)pose[5]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double td = sub((double)mu_t[i], dot3(Rd[i][0], Rd[i][1], Rd[i][2], ms[0], ms[1], ms[2]));
    tn[i] = add(dot3(Rd[i][0], Rd[i][1], Rd[i][2], t0[0], t0[1], t0[2]), td);
  }
  // rot_to_euler in double, its gimbal branch kept
  double sp = -Rn[2][0];
  sp = sp < -1.0 ? -1.0 : (sp > 1.0 ? 1.0 : sp);
  const double pitch = asin(sp);
  double cc = sub(1.0, mul(sp, sp));
  cc = cc < 0.0 ? 0.0 : cc;
  const bool safe = root(cc) > 1e-6;
  const double roll = safe ? atan2(Rn[2][1], Rn[2][2]) : 0.0;
  const double yaw = safe ? atan2(Rn[1][0], Rn[0][0]) : atan2(-Rn[0][1], Rn[1][1]);
  const float np[6] = {(float)roll, (float)pitch, (float)yaw, (float)tn[0], (float)tn[1], (float)tn[2]};
  const float delta = tree_sum<6>([&](int i) {
    const float d = sub(np[i], pose[i]);
    return mul(d, d);
  });
  const bool live = !a.done[b];
#pragma unroll
  for (int i = 0; i < 6; ++i) a.opose[b * 6 + i] = live ? np[i] : pose[i];
  a.odone[b] = !live || delta < a.epsilon;
  a.oiters[b] = a.iters[b] + (live ? 1 : 0);
}

__global__ void __launch_bounds__(kThreads) align_kernel(Args a) {
  extern __shared__ float part[];  // [tiles][kSums]
  __shared__ float smu_s[3], smu_t[3];
  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long base = (long long)b * a.n;
  auto matched = [&](long long pi, float (&mt)[3]) {
    const float* q = a.target + ((long long)b * a.m + a.idx[pi]) * 3;
    mt[0] = q[0];
    mt[1] = q[1];
    mt[2] = q[2];
  };
  auto ok = [&](long long pi) {
    const float d = a.d2[pi];
    return a.mask[pi] && isfinite(d) && d < a.max_d2;
  };
  // pass 1: the count, the moved source's and the matched targets' sums
  for (int tt = warp; tt < a.tiles; tt += kWarps)
    warp_tile<7>(tt, lane, part, [&](int i, float (&x)[7]) {
      for (int v = 0; v < 7; ++v) x[v] = 0.0f;
      if (i >= a.n || !ok(base + i)) return;
      float mt[3];
      matched(base + i, mt);
      x[0] = 1.0f;
      for (int c = 0; c < 3; ++c) {
        x[1 + c] = a.moved[(base + i) * 3 + c];
        x[4 + c] = mt[c];
      }
    });
  __syncthreads();
  tile_tree<7>(part, a.tiles);
  if (tid == 0) {
    const float ws = part[0] < 1.0f ? 1.0f : part[0];
    for (int c = 0; c < 3; ++c) {
      smu_s[c] = dvd(part[1 + c], ws);
      smu_t[c] = dvd(part[4 + c], ws);
    }
  }
  __syncthreads();
  float mu_s[3], mu_t[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = smu_s[c];
    mu_t[c] = smu_t[c];
  }
  // pass 2: the cross-covariance S[i][j] = sum (mt_i - mu_t_i)(ms_j - mu_s_j)
  for (int tt = warp; tt < a.tiles; tt += kWarps)
    warp_tile<9>(tt, lane, part, [&](int i, float (&x)[9]) {
      for (int v = 0; v < 9; ++v) x[v] = 0.0f;
      if (i >= a.n || !ok(base + i)) return;
      float mt[3], dt[3], ds[3];
      matched(base + i, mt);
      for (int c = 0; c < 3; ++c) {
        dt[c] = sub(mt[c], mu_t[c]);
        ds[c] = sub(a.moved[(base + i) * 3 + c], mu_s[c]);
      }
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) x[r * 3 + c] = mul(dt[r], ds[c]);
    });
  __syncthreads();
  tile_tree<9>(part, a.tiles);
  if (tid == 0) align(a, b, mu_s, mu_t, part);
}

}  // namespace

extern "C" {

// One ICP iteration of `lanes` lanes of `n` source points against `m` target
// points on `stream`. Pointers in the order of Args.
int liorf_icp_align(const void* pose, const void* done, const void* iters, const void* moved,
                    const void* d2, const void* idx, const void* target, const void* mask,
                    const void* source, void* opose, void* odone, void* oiters, void* moved_next,
                    void* all_done, float max_d2, float epsilon, int lanes, int n, int m,
                    void* stream) {
  if (lanes == 0) return 0;
  Args a;
  a.pose = (const float*)pose; a.done = (const uint8_t*)done; a.iters = (const int*)iters;
  a.moved = (const float*)moved; a.d2 = (const float*)d2; a.idx = (const int*)idx;
  a.target = (const float*)target; a.mask = (const uint8_t*)mask;
  a.source = (const float*)source; a.opose = (float*)opose; a.odone = (uint8_t*)odone;
  a.oiters = (int*)oiters; a.moved_next = (float*)moved_next; a.all_done = (uint8_t*)all_done;
  a.max_d2 = max_d2; a.epsilon = epsilon; a.lanes = lanes; a.n = n; a.m = m;
  a.tiles = gn::pow2ceil(n <= 0 ? 1 : (n + gn::kTile - 1) / gn::kTile);
  cudaStream_t s = (cudaStream_t)stream;
  align_kernel<<<lanes, kThreads, a.tiles * kSums * sizeof(float), s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the source moved by the new poses: the next K2's queries
  const int terr = gn::launch_transform(a.opose, a.source, a.moved_next, lanes, n, s);
  if (terr != 0) return terr;
  gn::all_done_kernel<<<1, 32, 0, s>>>(a.odone, lanes, a.all_done);
  return (int)cudaGetLastError();
}

}  // extern "C"
