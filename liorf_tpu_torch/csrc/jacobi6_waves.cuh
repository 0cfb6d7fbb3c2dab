// The cyclic 6x6 Jacobi sweeps of csrc/scan_gn.cu as a straight-line
// program of waves, built at compile time (C++17 constexpr).
//
// The sweeps' order of operations is kept: rotation k = (p, q) (the pairs
// p < q row by row, sweep after sweep) forms (t, c, s) from a_pp, a_qq and
// a_pq and sets a_pp, a_qq and a_pq (task C_k), turns the entries a_rp, a_rq
// of every other row r (task U_k,r) and the columns p, q of the eigenvectors
// (task V_k). Every entry of the matrix is read and rewritten by its tasks in
// the sequential order, and the eigenvectors' updates run in the sequential
// order, so a task can run as soon as the last earlier task on each of its
// entries has: the same operations on the same values, the same bits. A
// rotation waits only for the rotations that last touched its rows p and q,
// so the 120 coefficient chains (three quotients and two square roots each)
// line up in 51 waves of up to three disjoint rotations.
//
// The program is the tasks in an order that keeps every dependence: a wave
// (its rotations' C tasks, which the kernel runs on three lanes at once),
// then every row update that is ready, and again, until the next wave is
// ready; an eigenvector update as soon as every earlier one has run and its
// coefficients are known.
//
// A rotation's (c, s) is needed from its wave to its last update; at most a
// few are needed at once, so they take slots k % slots() (7 for 8 sweeps).
//
// Off the diagonal the matrix is kept once, the upper triangle (off(i, j));
// the input's entry (i, j), i < j, is read from its lower triangle (j, i),
// but (0, 1) from (0, 1): the triangle the sequential sweeps read first.

#pragma once

#ifdef __CUDACC__
#define JACOBI6_HD __host__ __device__
#else
#define JACOBI6_HD
#endif

namespace jacobi6 {

constexpr int kN = 6;
constexpr int kPairs = kN * (kN - 1) / 2;
constexpr int kMaxOps = 1024;
enum Kind { kWave = 0, kRow = 1, kVectors = 2 };

// the pair of rotation k: (p, q), p < q, row by row
JACOBI6_HD constexpr int pair_p(int k) {
  int p = 0;
  for (int m = k % kPairs, w = kN - 1; m >= w; m -= w--) ++p;
  return p;
}
JACOBI6_HD constexpr int pair_q(int k) {
  int p = 0, m = k % kPairs;
  for (int w = kN - 1; m >= w; m -= w--) ++p;
  return p + 1 + m;
}
// the upper-triangle index of {i, j}, i != j
JACOBI6_HD constexpr int off(int i, int j) {
  const int a = i < j ? i : j, b = i < j ? j : i;
  int id = 0;
  for (int x = 0; x < a; ++x) id += kN - 1 - x;
  return id + (b - a - 1);
}

struct Program {
  int n = 0;                     // ops; -1: the table is too small
  int kind[kMaxOps] = {};
  int count[kMaxOps] = {};       // a wave's rotations (1 to 3)
  int rot[kMaxOps][3] = {};      // the rotations (a row or eigenvector update: [0])
  int row[kMaxOps] = {};         // a row update's row
};

template <int SWEEPS>
JACOBI6_HD constexpr Program build() {
  constexpr int kRot = kPairs * SWEEPS;
  constexpr int kTasks = kRot * (kN - 1);  // C_k (5k) and its row updates (5k + 1 .. 4)
  constexpr int kEntries = kN + kPairs;    // the diagonal, then the upper triangle
  Program out{};
  int dep[kTasks][3] = {};
  int ndep[kTasks] = {};
  int rot_of[kTasks] = {};
  int row_of[kTasks] = {};
  int last[kEntries] = {};
  for (int e = 0; e < kEntries; ++e) last[e] = -1;
  for (int k = 0; k < kRot; ++k) {
    const int p = pair_p(k), q = pair_q(k), c = 5 * k;
    const int ins[3] = {p, q, kN + off(p, q)};
    for (int j = 0; j < 3; ++j) {
      if (last[ins[j]] >= 0) dep[c][ndep[c]++] = last[ins[j]];
      last[ins[j]] = c;
    }
    rot_of[c] = k;
    row_of[c] = -1;
    int u = c;
    for (int r = 0; r < kN; ++r) {
      if (r == p || r == q) continue;
      ++u;
      const int a = kN + off(r, p), b = kN + off(r, q);
      dep[u][ndep[u]++] = c;
      if (last[a] >= 0) dep[u][ndep[u]++] = last[a];
      if (last[b] >= 0 && last[b] != last[a]) dep[u][ndep[u]++] = last[b];
      last[a] = last[b] = u;
      rot_of[u] = k;
      row_of[u] = r;
    }
  }
  bool done[kTasks] = {};
  bool known[kRot] = {};  // coefficients formed
  int left = kTasks, vectors = 0;
  while (left > 0) {
    bool ready[kTasks] = {};
    int nrow = 0, ncoef = 0;
    for (int t = 0; t < kTasks; ++t) {
      if (done[t]) continue;
      bool ok = true;
      for (int j = 0; j < ndep[t]; ++j) ok = ok && done[dep[t][j]];
      ready[t] = ok;
      if (ok) ++(row_of[t] < 0 ? ncoef : nrow);
    }
    const bool wave = nrow == 0;
    if ((wave && (ncoef == 0 || ncoef > 3)) || out.n + (wave ? 1 + kRot : nrow) > kMaxOps) {
      out.n = -1;
      return out;
    }
    if (wave) {
      const int i = out.n++;
      out.kind[i] = kWave;
      for (int t = 0; t < kTasks; ++t) {
        if (!ready[t] || row_of[t] >= 0) continue;
        out.rot[i][out.count[i]++] = rot_of[t];
        known[rot_of[t]] = true;
        done[t] = true;
        --left;
      }
      while (vectors < kRot && known[vectors]) {
        out.kind[out.n] = kVectors;
        out.rot[out.n++][0] = vectors++;
      }
    } else {
      for (int t = 0; t < kTasks; ++t) {
        if (!ready[t] || row_of[t] < 0) continue;
        out.kind[out.n] = kRow;
        out.rot[out.n][0] = rot_of[t];
        out.row[out.n++] = row_of[t];
        done[t] = true;
        --left;
      }
    }
  }
  return out;
}

// The fewest slots S such that rotation k's (c, s) can live in slot k % S:
// no two rotations of one slot are needed at once (a rotation is needed from
// its wave to its last row or eigenvector update).
JACOBI6_HD constexpr int slots(const Program& p, int rotations) {
  int first[kMaxOps] = {}, last[kMaxOps] = {};
  for (int k = 0; k < rotations; ++k) first[k] = last[k] = -1;
  for (int i = 0; i < p.n; ++i) {
    if (p.kind[i] == kWave) {
      for (int j = 0; j < p.count[i]; ++j) first[p.rot[i][j]] = i;
    } else {
      last[p.rot[i][0]] = i;
    }
  }
  for (int S = 1; S <= rotations; ++S) {
    bool ok = true;
    for (int a = 0; a < rotations && ok; ++a)
      for (int b = a + S; b < rotations && ok; b += S)
        ok = last[a] < first[b] || last[b] < first[a];
    if (ok) return S;
  }
  return rotations;
}

}  // namespace jacobi6
