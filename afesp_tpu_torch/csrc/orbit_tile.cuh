// Orbit tiles: the reductions of the restricted (spatial) triples kernels
// K3 (triples_fused_spatial.cu), K4 (triples_tiled_spatial.cu) and K5
// (triples_finale_spatial.cu) read every element of a (v, v, v)
// cube together with its permuted partners u[sigma(a,b,c)], and the same
// of the z3 numerator zn.  A block
// takes one sorted triple of 8-wide tiles A <= B <= C and stages the
// tiles of all six orders of (A, B, C) in shared memory, each distinct
// tile once, coalesced; every element of each distinct tile then reads
// its partners from the staged tile that composing the two permutations
// names.  Over all sorted tile triples every cube element is read from
// device memory once and visited once.  Each .cu is built into its own
// shared library, so every symbol here is static, inline or a template.
#pragma once

#include "triples_spatial_common.cuh"

namespace orbit {

using spatial::kSums;
using spatial::kThreads;

constexpr int OT = 8;                   // tile edge
constexpr int S2 = OT + 1;              // shared strides of a staged tile (k: 1):
constexpr int S1 = OT * S2 + 1;         // odd, so permuted reads spread over the banks
constexpr int SLOT = OT * S1;
constexpr int kSlots = 6;

// The six orders of a tile triple, as permutations of positions: slot s
// holds tile (T[perm_at(s, 0)], T[perm_at(s, 1)], T[perm_at(s, 2)]).  The
// same list orders the permuted reads of an element: abc, bac, acb, cba,
// bca, cab.  Every index below is a constant once the slot loops unroll.
__host__ __device__ constexpr int perm_at(int s, int n) {
  return s == 0   ? n
         : s == 1 ? (n == 0 ? 1 : n == 1 ? 0 : 2)
         : s == 2 ? (n == 0 ? 0 : n == 1 ? 2 : 1)
         : s == 3 ? 2 - n
         : s == 4 ? (n + 1) % 3
                  : (n + 2) % 3;
}
__host__ __device__ constexpr int perm_index(int p0, int p1) {
  return p0 == 0 ? (p1 == 1 ? 0 : 2) : p0 == 1 ? (p1 == 0 ? 1 : 4) : (p1 == 1 ? 3 : 5);
}
// the slot holding the tile of an element of slot s read in order r
__host__ __device__ constexpr int compose(int s, int r) {
  return perm_index(perm_at(s, perm_at(r, 0)), perm_at(s, perm_at(r, 1)));
}
// element n of (u0, u1, u2) by selects, never a run-time-indexed array
__device__ __forceinline__ int sel3(int n, int u0, int u1, int u2) {
  return n == 0 ? u0 : n == 1 ? u1 : u2;
}
// Local offset of the element of order r of local element (i, j, k).
__device__ __forceinline__ int local_off(int r, int i, int j, int k) {
  return sel3(perm_at(r, 0), i, j, k) * S1 + sel3(perm_at(r, 1), i, j, k) * S2 +
         sel3(perm_at(r, 2), i, j, k);
}

// smap[s] = the first slot holding the same tile as slot s, for the tile
// triple (T0, T1, T2); written by threads 0..5, read after a barrier.
__device__ __forceinline__ void slot_map(int T0, int T1, int T2, int* smap) {
  if (threadIdx.x < kSlots) {
    const int s = threadIdx.x;
    int first = s;
    for (int q = s - 1; q >= 0; --q) {
      bool same = true;
      for (int n = 0; n < 3; ++n)
        same = same && sel3(perm_at(q, n), T0, T1, T2) == sel3(perm_at(s, n), T0, T1, T2);
      if (same) first = q;
    }
    smap[s] = first;
  }
}

// ---- the six sums on one tile triple (K3, K4, K5) ---------------------------

// The operator a kernel applies to the cubes: K3 and K4 the class operator
//   M(u)     = 8 u[abc] - 4 (u[bac] + u[acb] + u[cba]) + 2 (u[bca] + u[cab]),
// K5 three times xbar,
//   xbar3(u) = 4 u[abc] - 6 u[acb] + 2 u[bca],
// on the six permuted reads in the order of perm_at.
enum class Op { M, Xbar };

template <Op OP>
__device__ __forceinline__ double op_of(const double (&u)[kSlots]) {
  if (OP == Op::M) return 8.0 * u[0] - 4.0 * (u[1] + u[2] + u[3]) + 2.0 * (u[4] + u[5]);
  return 4.0 * u[0] - 6.0 * u[2] + 2.0 * u[4];
}

// x and zn staged: two arrays of kSlots tiles
constexpr int kOrbitSmem = 2 * kSlots * SLOT * 8;

// One block's contribution to the six sums of one cube (a triple's for
// K3 and K4, a panel's for K5) over the sorted tile triple (T0, T1, T2):
//   s0 = x.O(x)/D   s1 = x.O(zn)/D
//   s2 = y.O(x)/D   s3 = y.O(zn)/D
//   s4 = m.O(x)/D   s5 = m.O(zn)/D
// with O = M or xbar3, D[abc] = eo - ev[a] - ev[b] - ev[c], the z3
// numerator
//   zn[a,b,c] = ti[a] W1[b,c] + tj[b] W2[a,c] + tk[c] W3[a,b]
// and y = ti[a] (tj[b] tk[c] + U1[b,c]) + tj[b] U2[a,c] + tk[c] U3[a,b].
// Each distinct tile of x is staged once, read from device memory in
// rows of 8, and zn is built once a staged element and staged beside it;
// O(x) and O(zn) take their permuted reads from shared memory; y is
// built and m read at each element (at abc only).  ev, ti, tj and tk at
// the three tiles are staged first.  Every thread owns the same
// kPer elements of each of the six slots and issues their device reads
// unconditionally (at a clamped address where an element lies past v or
// a slot repeats an earlier one), so the reads of all slots can be in
// flight together; only the stores and sums are conditional.  Local
// indices are shifts and masks of the 8-wide tile: no division in the
// walk.  x and m may each be given as NP parts (the numerator GEMM's
// groups), summed as they are read.  W1..W3, U1..U3 and m must be
// readable (m may be x when has_m is false).  smem: kOrbitSmem bytes of
// dynamic shared memory.
constexpr int kPer = OT * OT * OT / kThreads;  // elements of a tile a thread owns
static_assert(kPer * kThreads == OT * OT * OT, "tile elements");

// The element at g of a cube given as NP parts, part_stride elements
// apart, summed in part order.
template <int NP>
__device__ __forceinline__ double parts_at(const double* __restrict__ u, long long g,
                                           long long part_stride) {
  double val = u[g];
#pragma unroll
  for (int q = 1; q < NP; ++q) val += u[g + q * part_stride];
  return val;
}

template <Op OP, int NP>
__device__ __forceinline__ void tile_triple_sums(
    const double* __restrict__ x, const double* __restrict__ m, long long part_stride,
    const double* __restrict__ ti,
    const double* __restrict__ tj, const double* __restrict__ tk,
    const double* __restrict__ W1, const double* __restrict__ W2,
    const double* __restrict__ W3, const double* __restrict__ U1,
    const double* __restrict__ U2, const double* __restrict__ U3,
    const double* __restrict__ ev, double eo, int v, int T0, int T1, int T2, bool has_z,
    bool has_y, bool has_m, double* smem, double (&acc)[kSums]) {
  __shared__ int smap[kSlots];             // the first slot holding the same tile
  __shared__ double vec[4][3 * OT];        // ev, ti, tj, tk at tile n: [n OT + l]
  double* Xs = smem;
  double* Zs = smem + kSlots * SLOT;
  slot_map(T0, T1, T2, smap);
  if (threadIdx.x < 4 * 3 * OT) {
    const int w = threadIdx.x / (3 * OT), n = (threadIdx.x / OT) % 3, l = threadIdx.x % OT;
    const int idx = sel3(n, T0, T1, T2) * OT + l;
    const double* src = w == 0 ? ev : w == 1 ? ti : w == 2 ? tj : tk;
    vec[w][n * OT + l] = idx < v ? src[idx] : 0.0;
  }
  __syncthreads();
  const long long v2 = (long long)v * v;

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const bool distinct = smap[s] == s;
    const int A0 = sel3(perm_at(s, 0), T0, T1, T2) * OT;
    const int B0 = sel3(perm_at(s, 1), T0, T1, T2) * OT;
    const int C0 = sel3(perm_at(s, 2), T0, T1, T2) * OT;
#pragma unroll
    for (int l = 0; l < kPer; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int li = e / (OT * OT), lj = (e / OT) % OT, lk = e % OT;
      const int a = A0 + li, b = B0 + lj, c = C0 + lk;
      const bool in = a < v && b < v && c < v;
      const int ac = in ? a : 0, bc = in ? b : 0, cc = in ? c : 0;
      const double xv = parts_at<NP>(x, ac * v2 + (long long)bc * v + cc, part_stride);
      const double zv = vec[1][perm_at(s, 0) * OT + li] * W1[bc * v + cc] +
                        vec[2][perm_at(s, 1) * OT + lj] * W2[ac * v + cc] +
                        vec[3][perm_at(s, 2) * OT + lk] * W3[ac * v + bc];
      if (distinct) {
        const int off = s * SLOT + li * S1 + lj * S2 + lk;
        Xs[off] = in ? xv : 0.0;
        if (has_z) Zs[off] = in ? zv : 0.0;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const bool distinct = smap[s] == s;
    const int A0 = sel3(perm_at(s, 0), T0, T1, T2) * OT;
    const int B0 = sel3(perm_at(s, 1), T0, T1, T2) * OT;
    const int C0 = sel3(perm_at(s, 2), T0, T1, T2) * OT;
    int base[kSlots];  // slot offsets of the six orders' tiles
#pragma unroll
    for (int r = 0; r < kSlots; ++r) base[r] = smap[compose(s, r)] * SLOT;
#pragma unroll
    for (int l = 0; l < kPer; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int li = e / (OT * OT), lj = (e / OT) % OT, lk = e % OT;
      const int a = A0 + li, b = B0 + lj, c = C0 + lk;
      const bool in = a < v && b < v && c < v;
      const int ac = in ? a : 0, bc = in ? b : 0, cc = in ? c : 0;
      const double tia = vec[1][perm_at(s, 0) * OT + li];
      const double tjb = vec[2][perm_at(s, 1) * OT + lj];
      const double tkc = vec[3][perm_at(s, 2) * OT + lk];
      const double yv = tia * (tjb * tkc + U1[bc * v + cc]) + tjb * U2[ac * v + cc] +
                        tkc * U3[ac * v + bc];
      const double mv = parts_at<NP>(m, ac * v2 + (long long)bc * v + cc, part_stride);
      if (!(distinct && in)) continue;
      double u[kSlots], z[kSlots];
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int off = base[r] + local_off(r, li, lj, lk);
        u[r] = Xs[off];
        z[r] = has_z ? Zs[off] : 0.0;
      }
      const double d = eo - vec[0][perm_at(s, 0) * OT + li] - vec[0][perm_at(s, 1) * OT + lj] -
                       vec[0][perm_at(s, 2) * OT + lk];
      const double rd = 1.0 / d;  // one division an element
      const double t = op_of<OP>(u) * rd;
      const double zt = has_z ? op_of<OP>(z) * rd : 0.0;
      acc[0] += u[0] * t;
      if (has_z) acc[1] += u[0] * zt;
      if (has_y) {
        acc[2] += yv * t;
        if (has_z) acc[3] += yv * zt;
      }
      if (has_m) {
        acc[4] += mv * t;
        if (has_z) acc[5] += mv * zt;
      }
    }
  }
}

}  // namespace orbit
