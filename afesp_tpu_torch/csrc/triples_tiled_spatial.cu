// K4: the tiled restricted (spatial) triples tier, hand-written for
// Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_tiled.py:triples_tiled_spatial: stage 1
// (_chunk_cubes, batched XLA einsums there) and stage 2 (kernel body
// _tiled_kernel, dispatched by _pallas_partials).  For each sorted triple
// t = (i, j, k) with orbit weight w[t] it reduces
//   s0 = x.M(t3)  s1 = x.M(z3)  s2 = y.M(t3)  s3 = y.M(z3)
//   s4 = m.M(t3)  s5 = m.M(z3)
// with x = t3_D, m = m3 (the twelve-term numerator cubes, CR only for
// m), t3 = x / D, z3 = zn / D, zn and y the rank-structured numerators
// (Piecuch Eqs. 60, 66) and the class operator M of
// triples_spatial_common.cuh, into per-block partials; a last pass sums
// the weighted partials of all chunks in a fixed order.  f64 throughout,
// f64 accumulation, no nvirt cap.
//
// Stage 1, cube_gemm_kernel: the numerator cubes on the f64 tensor cores,
// with dmma_tile.cuh's tile and K loop (shared with K1's numerator).  The
// twelve terms of a cube fall into three groups of four by the cube axis
// their single index lands on (ops/triples_spatial_cuda.py
// fused_term_groups, as K3 groups them); a group is one GEMM a triple,
//   rows (MMA M) = the other two axes (p, q), flattened,
//   cols (MMA N) = the group's axis, padded to a multiple of 8,
//   depth       = the group's two t2 terms (K = v each) and two m terms
//                 (K = o each), one after another, each padded to even,
// over operand tables the wrapper lays out once a call
// (tiled_operands): the right-hand tables in both (p, q) orders, so every
// operand row is contiguous, and the m terms' left-hand tables negated,
// so one accumulator takes all four.  A table of each triple's term
// offsets replaces index logic.  The epilogue writes each element of the
// group's tile to its place in the cube, x[a,b,c] at a v^2 + b v + c:
// group 0 (rows b c, cols a) writes, groups 1 (rows a c, cols b) and 2
// (rows a b, cols c) add, three launches in a fixed order.  No permuted
// copy of any term is ever made.  Block tile: 16 warps of 32 rows by 32
// or 40 columns (256 x 64 or 256 x 80, whichever pads the group axis
// least; chosen among the tiles measured in PERF.md §6), two cp.async
// stages of 32 K rows; the column tiles of a row tile are neighbours in
// the grid, so they meet the same right-hand rows in L2.
//
// Stage 2, orbit_kernel: a block takes one sorted triple of 8-wide tiles
// A <= B <= C of a triple's cube and stages, coalesced, the tiles of all
// six orders of (A, B, C) in shared memory (each distinct tile once), so
// every cube element is read from device memory once and M(x)[abc] takes
// its five permuted elements from shared memory.  zn is built per staged
// element from t1 and the triple's three v_oovv planes and staged beside
// x; y is built at each element from t1 and t2 planes; m is read at each
// element.  Each thread sums in a fixed order, each block reduces in a
// fixed tree and writes one partial row of six sums.
//
// Bound on the H100: operations, for the whole tier.  2 v^3 (2 v + 2 o)
// flops per group, three groups a cube, x and m: 1.14e13 flops for the
// 680 sorted triples of the 174-bf trimer (o = 15, v = 159), 171 ms at
// the 67 TFLOP/s f64 tensor-core peak; the cubes cross device memory
// five times in stage 1 (one write, two read-modify-writes) and once in
// stage 2.
//
// What it leaves on the table (times in PERF.md §6): stage 1 runs at
// about 40% of the DMMA peak at the trimer's shape, one block an SM
// whose epilogue leaves the tensor cores idle; groups 1 and 2 read back
// and rewrite the cube; stage 2 rebuilds zn once a staged tile and
// reads y's planes through the caches at every element.

#include "dmma_tile.cuh"
#include "triples_spatial_common.cuh"

namespace {

using spatial::kSums;
using spatial::kThreads;

// ---- stage 1: the numerator cubes --------------------------------------
constexpr int BK = 32;                  // K rows of a shared-memory stage
constexpr int kTerms = 4;               // two t2 terms, two m terms

// A block tile: WARPS_M x WARPS_N warps of 32 (p, q) rows (two m16
// tiles) by 8 NT group-axis columns, STAGES shared-memory stages.
template <int WARPS_M_, int WARPS_N_, int NT_, int STAGES_>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, NT = NT_, STAGES = STAGES_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = 32, MT = WM / 16;
  static constexpr int WN = 8 * NT;
  static constexpr int BM = WM * WARPS_M;   // (p, q) rows of a block tile (MMA M)
  static constexpr int BN = WN * WARPS_N;   // group-axis columns (MMA N)
  // shared strides, 4 (mod 16) doubles, as K1's
  static constexpr int LDA = BM + 4;        // As[k][m]
  static constexpr int LDB = BK + 4;        // Bs[n][k]
  static constexpr int A_STAGE = BK * LDA, B_STAGE = BN * LDB;
  static constexpr int kSmem = STAGES * (A_STAGE + B_STAGE) * 8;
  static_assert(BM * BK / 2 % kThreads == 0, "A stage copies");
  static_assert(LDA % 16 == 4, "A stride");
};

// K geometry of a group: terms 0, 1 have Kv rows (L row stride Kv), terms
// 2, 3 Ko rows; all four in that order along the concatenated K axis.
struct KGeom {
  int Kv, Ko;
  __device__ __forceinline__ int total() const { return 2 * Kv + 2 * Ko; }
  __device__ __forceinline__ int term(int kg) const {
    return (kg >= Kv) + (kg >= 2 * Kv) + (kg >= 2 * Kv + Ko);
  }
  __device__ __forceinline__ int start(int t) const {
    return t < 2 ? t * Kv : 2 * Kv + (t - 2) * Ko;
  }
  __device__ __forceinline__ int ld(int t) const { return t < 2 ? Kv : Ko; }
};

// Grid (ceil(Np / BN), ceil(NNp / BM), C), one launch a group: the
// column tiles of a row tile run side by side, so the second reads the R
// rows the first brought into L2.  L, R: the flat operand tables; desc:
// (C, 3, 8) int64, per triple and group the element offsets (L, R) of
// its four terms; cube (C, v, v, v).  group: the cube axis of the
// group's single index; accumulate: add to the cube (groups 1, 2).
template <class G>
__global__ void __launch_bounds__(G::kThreads, 1)
cube_gemm_kernel(const double* __restrict__ L, const double* __restrict__ R,
                 const long long* __restrict__ desc, int group, int v, KGeom kg_,
                 int Np, long long NNp, int accumulate, double* __restrict__ cube) {
  extern __shared__ double smem[];
  // the term offsets (L0, R0, .., L3, R3) in shared memory: in registers
  // they would crowd out the accumulators
  __shared__ long long off[2 * kTerms];
  double* As = smem;
  double* Bs = smem + G::STAGES * G::A_STAGE;
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  if (threadIdx.x < 2 * kTerms)
    off[threadIdx.x] = desc[((long long)p * 3 + group) * 2 * kTerms + threadIdx.x];
  __syncthreads();
  const KGeom K = kg_;
  const int Ktot = K.total();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = (warp % G::WARPS_M) * G::WM, wn = (warp / G::WARPS_M) * G::WN;

  double acc[G::MT][G::NT][4];
  dmma::mainloop<G::MT, G::NT, BK, G::LDA, G::LDB, G::STAGES>(
      acc, As, Bs, G::A_STAGE, G::B_STAGE, (Ktot + BK - 1) / BK, wm, wn,
      [&](double* as, double* bs, int k0) {
#pragma unroll
        for (int l = 0; l < G::BM * BK / 2 / G::kThreads; ++l) {
          const int c = threadIdx.x + l * G::kThreads;
          const int r = c / (G::BM / 2), col = (c % (G::BM / 2)) * 2;
          const int kg = k0 + r;
          const bool ok = kg < Ktot && m0 + col < NNp;
          const int t = K.term(kg);
          const double* src =
              ok ? R + off[2 * t + 1] + (long long)(kg - K.start(t)) * NNp + m0 + col : R;
          dmma::cp_async16(as + r * G::LDA + col, src, ok);
        }
        for (int c = threadIdx.x; c < G::BN * BK / 2; c += G::kThreads) {
          const int n = c / (BK / 2), kq = (c % (BK / 2)) * 2;
          const int kg = k0 + kq;
          const bool ok = kg < Ktot && n0 + n < Np;
          const int t = K.term(kg);
          const double* src =
              ok ? L + off[2 * t] + (long long)(n0 + n) * K.ld(t) + (kg - K.start(t)) : L;
          dmma::cp_async16(bs + n * G::LDB + kq, src, ok);
        }
      });

  // C[m][n]: row g + 8 (q >> 1), col 2 tg + (q & 1); m = p v + q over the
  // two other axes, n the group's axis
  const long long NN = (long long)v * v;
  double* out = cube + (long long)p * v * NN;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mt * 16 + g + 8 * h;
      if (m >= NN) continue;
      const int mp = m / v, mq = m - mp * v;
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + nt * 8 + 2 * tg + e;
          if (n >= v) continue;
          const long long o = group == 0   ? (long long)n * NN + m
                              : group == 1 ? (long long)mp * NN + (long long)n * v + mq
                                           : (long long)m * v + n;
          const double val = acc[mt][nt][2 * h + e];
          out[o] = accumulate ? out[o] + val : val;
        }
    }
}

// ---- stage 2: the six sums over orbit tiles ----------------------------
constexpr int OT = 8;                   // tile edge
constexpr int S2 = OT + 1;              // shared strides of a staged tile (k: 1):
constexpr int S1 = OT * S2 + 1;         // odd, so permuted reads spread over the banks
constexpr int SLOT = OT * S1;
constexpr int kSlots = 6;
constexpr int kOrbitSmem = 2 * kSlots * SLOT * 8;

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

// Grid (nT, C): tiles (nT, 3) int32 the sorted tile triples; one
// partial row of six sums a block at (t nT + tile triple).  x, m: the
// chunk's cubes (m null without CR); t1 (o, v); t2, W = v_oovv (o, o, v,
// v); eo (C,) the chunk's e_i + e_j + e_k; ii/jj/kk the chunk's triples.
__global__ void __launch_bounds__(kThreads)
orbit_kernel(const double* __restrict__ x, const double* __restrict__ m,
             const double* __restrict__ t1, const double* __restrict__ t2,
             const double* __restrict__ W, const double* __restrict__ ev,
             const double* __restrict__ eo, const int* __restrict__ ii,
             const int* __restrict__ jj, const int* __restrict__ kk,
             const int* __restrict__ tiles, int o, int v, int has_z, int has_y,
             double* __restrict__ partials) {
  extern __shared__ double smem[];
  double* Xs = smem;
  double* Zs = smem + kSlots * SLOT;
  __shared__ int smap[kSlots];  // the first slot holding the same tile
  const int t = blockIdx.y;
  const int i = ii[t], j = jj[t], k = kk[t];
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const double* xt = x + t * v3;
  const double* mt = m ? m + t * v3 : nullptr;
  const double *ti = t1 + (long long)i * v, *tj = t1 + (long long)j * v,
               *tk = t1 + (long long)k * v;
  const spatial::Rank3 zn{ti, tj, tk, W + (long long)(j * o + k) * v2,
                          W + (long long)(i * o + k) * v2, W + (long long)(i * o + j) * v2, v};
  const double* Ujk = t2 + (long long)(j * o + k) * v2;
  const double* Uik = t2 + (long long)(i * o + k) * v2;
  const double* Uij = t2 + (long long)(i * o + j) * v2;
  const int T0 = tiles[3 * blockIdx.x], T1 = tiles[3 * blockIdx.x + 1],
            T2 = tiles[3 * blockIdx.x + 2];
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
  __syncthreads();

  // stage each distinct tile of x (and zn), zeros past v
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (smap[s] != s) continue;
    const int A0 = sel3(perm_at(s, 0), T0, T1, T2) * OT;
    const int B0 = sel3(perm_at(s, 1), T0, T1, T2) * OT;
    const int C0 = sel3(perm_at(s, 2), T0, T1, T2) * OT;
    for (int e = threadIdx.x; e < OT * OT * OT; e += kThreads) {
      const int li = e / (OT * OT), lj = (e / OT) % OT, lk = e % OT;
      const int a = A0 + li, b = B0 + lj, c = C0 + lk;
      const bool in = a < v && b < v && c < v;
      const int off = s * SLOT + li * S1 + lj * S2 + lk;
      Xs[off] = in ? xt[a * v2 + (long long)b * v + c] : 0.0;
      if (has_z) Zs[off] = in ? zn.at(a, b, c) : 0.0;
    }
  }
  __syncthreads();

  const double eot = eo[t];
  double acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (smap[s] != s) continue;
    const int A0 = sel3(perm_at(s, 0), T0, T1, T2) * OT;
    const int B0 = sel3(perm_at(s, 1), T0, T1, T2) * OT;
    const int C0 = sel3(perm_at(s, 2), T0, T1, T2) * OT;
    int base[kSlots];  // slot offsets of the six orders' tiles
#pragma unroll
    for (int r = 0; r < kSlots; ++r) base[r] = smap[compose(s, r)] * SLOT;
    for (int e = threadIdx.x; e < OT * OT * OT; e += kThreads) {
      const int li = e / (OT * OT), lj = (e / OT) % OT, lk = e % OT;
      const int a = A0 + li, b = B0 + lj, c = C0 + lk;
      if (a >= v || b >= v || c >= v) continue;
      double u[kSlots], z[kSlots];
#pragma unroll
      for (int r = 0; r < kSlots; ++r) {
        const int off = base[r] + local_off(r, li, lj, lk);
        u[r] = Xs[off];
        z[r] = has_z ? Zs[off] : 0.0;
      }
      // M(u) = 8 u[abc] - 4 (u[bac] + u[acb] + u[cba]) + 2 (u[bca] + u[cab])
      const double mx = 8.0 * u[0] - 4.0 * (u[1] + u[2] + u[3]) + 2.0 * (u[4] + u[5]);
      const double mz = 8.0 * z[0] - 4.0 * (z[1] + z[2] + z[3]) + 2.0 * (z[4] + z[5]);
      const double yv = has_y ? ti[a] * (tj[b] * tk[c] + Ujk[b * v + c]) +
                                    tj[b] * Uik[a * v + c] + tk[c] * Uij[a * v + b]
                              : 0.0;
      const double mv = mt ? mt[a * v2 + (long long)b * v + c] : 0.0;
      const double d = eot - ev[a] - ev[b] - ev[c];
      spatial::add_m_terms(acc, u[0], yv, mv, mx, mz, d, has_z != 0, has_y != 0,
                           mt != nullptr);
    }
  }
  spatial::block_reduce6(acc, partials + ((long long)t * gridDim.x + blockIdx.x) * kSums);
}

template <class G>
int launch_cube(const double* L, const double* R, const long long* desc, int C, int v,
                KGeom K, int Np, long long NNp, double* cube, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(cube_gemm_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Np + G::BN - 1) / G::BN), (unsigned)((NNp + G::BM - 1) / G::BM),
            (unsigned)C);
  for (int group = 0; group < 3; ++group) {
    cube_gemm_kernel<G><<<grid, G::kThreads, G::kSmem, s>>>(L, R, desc, group, v, K, Np, NNp,
                                                             group > 0, cube);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Stage 1 of one chunk of C triples for one cube: its three group GEMMs
// into cube (C, v, v, v).  desc: (C, 3, 8) int64 term offsets into the
// flat tables L and R (ops/triples_spatial_cuda.py tiled_term_offsets);
// Kv, Ko: the padded K of the t2 and m terms; Np, NNp: the padded group
// axis and (p, q) rows; tile: the block tile (TILE_CONFIGS there).
extern "C" int triples_tiled_spatial_cube_launch(const void* L, const void* R,
                                                 const void* desc, int C, int v, int Kv,
                                                 int Ko, int Np, long long NNp, int tile,
                                                 void* cube, void* stream) {
  const auto* l = static_cast<const double*>(L);
  const auto* r = static_cast<const double*>(R);
  const auto* d = static_cast<const long long*>(desc);
  auto* out = static_cast<double*>(cube);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KGeom K{Kv, Ko};
  switch (tile) {
    case 0: return launch_cube<Cfg<8, 2, 4, 2>>(l, r, d, C, v, K, Np, NNp, out, s);
    case 1: return launch_cube<Cfg<8, 2, 5, 2>>(l, r, d, C, v, K, Np, NNp, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Stage 2 of one chunk: nT * C partial rows of six sums (row t nT + tile
// triple).  m null without CR.
extern "C" int triples_tiled_spatial_orbit_launch(const void* x, const void* m,
                                                  const void* t1, const void* t2,
                                                  const void* W, const void* ev,
                                                  const void* eo, const void* ii,
                                                  const void* jj, const void* kk,
                                                  const void* tiles, int nT, int C, int o,
                                                  int v, int has_z, int has_y,
                                                  void* partials, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(orbit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kOrbitSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nT, (unsigned)C);
  orbit_kernel<<<grid, kThreads, kOrbitSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(t1), static_cast<const double*>(t2),
      static_cast<const double*>(W), static_cast<const double*>(ev),
      static_cast<const double*>(eo), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<const int*>(kk),
      static_cast<const int*>(tiles), o, v, has_z, has_y, static_cast<double*>(partials));
  return (int)cudaGetLastError();
}

// out[0:6] = sum over the n partial rows of w[row / nT] * partials[row].
extern "C" int triples_spatial_weighted_sum_launch(const void* partials, long long n,
                                                   const void* w, int nT, void* out,
                                                   void* stream) {
  return spatial::launch_weighted_sum6(static_cast<const double*>(partials), n,
                                       static_cast<const double*>(w), nT, 1.0,
                                       static_cast<double*>(out),
                                       static_cast<cudaStream_t>(stream));
}
