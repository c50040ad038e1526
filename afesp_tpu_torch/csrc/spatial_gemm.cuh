// The numerator GEMM of the restricted (spatial) triples kernels K3
// (triples_fused_spatial.cu) and K4 (triples_tiled_spatial.cu): the
// twelve terms of a numerator cube (x = t3_D or m = m3) on the f64
// tensor cores, with dmma_tile.cuh's tile and K loop.  The terms fall
// into three groups of four by the cube axis their single index lands on
// (ops/triples_spatial_cuda.py fused_term_groups); a group is one GEMM a
// triple,
//   rows (MMA M) = the other two axes (p, q), flattened,
//   cols (MMA N) = the group's axis, padded to a multiple of 8,
//   depth       = the group's two t2 terms (K = v each) and two m terms
//                 (K = o each), one after another, each padded to even,
// over operand tables that layout_kernel lays out once a call
// (ops/triples_spatial_cuda.py tiled_layout): the right-hand tables in
// both (p, q) orders, so every operand row is contiguous, and the m
// terms' left-hand tables negated, so one accumulator takes all four.
// The same launch writes each triple's term offsets, which replace index
// logic in the GEMM.  16-byte copies need rows of even length at even
// offsets, which the inputs' rows of length v or o are not, so the
// tables cannot be read in place.  The epilogue writes each element of
// the group's tile to its place in the group's own cube, x[a,b,c] at
// a v^2 + b v + c (group 0: rows b c, cols a; group 1: rows a c, cols b;
// group 2: rows a b, cols c); the reduction sums the three groups' cubes
// as it reads them.  (Adding groups 1 and 2 into group 0's cube in the
// epilogue instead made those groups half as slow again, PERF.md §6.)
// Block tile: 16 warps of 32 rows by 32 or 40 columns (256 x 64 or
// 256 x 80), two cp.async stages of 32 K rows; the column tiles of a row
// tile are neighbours in the grid, so they meet the same right-hand rows
// in L2.  One launch may cover several cubes (x and m) of a chunk of C
// triples.  Each .cu is built into its own shared library, so every
// symbol here is static, inline or a template.
#pragma once

#include "dmma_tile.cuh"

namespace sgemm {

constexpr int BK = 32;                  // K rows of a shared-memory stage
constexpr int kTerms = 4;               // two t2 terms, two m terms
constexpr int kLayoutThreads = 256;

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

// Grid (ceil(Np / BN), ceil(NNp / BM), ncube * C), one launch a group:
// blockIdx.z = cube * C + triple.  L, R: the flat operand tables; desc:
// per cube (desc_cube elements apart) (C, 3, 8) int64, per triple and
// group the element offsets (L, R) of its four terms; cube: per cube
// (cube_stride elements apart) (C, v, v, v).  group: the cube axis of
// the group's single index.
template <class G>
__global__ void __launch_bounds__(G::kThreads, 1)
cube_gemm_kernel(const double* __restrict__ L, const double* __restrict__ R,
                 const long long* __restrict__ desc, long long desc_cube, int group, int v,
                 KGeom kg_, int Np, long long NNp, int C, long long cube_stride,
                 double* __restrict__ cube) {
  extern __shared__ double smem[];
  // the term offsets (L0, R0, .., L3, R3) in shared memory: in registers
  // they would crowd out the accumulators
  __shared__ long long off[2 * kTerms];
  double* As = smem;
  double* Bs = smem + G::STAGES * G::A_STAGE;
  const int q = blockIdx.z / C, p = blockIdx.z - q * C;
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;
  if (threadIdx.x < 2 * kTerms)
    off[threadIdx.x] =
        desc[q * desc_cube + ((long long)p * 3 + group) * 2 * kTerms + threadIdx.x];
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
  double* out = cube + q * cube_stride + (long long)p * v * NN;
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
          out[o] = acc[mt][nt][2 * h + e];
        }
    }
}

// One group's launch over ncube cubes of C triples each.
template <class G>
int launch_group(const double* L, const double* R, const long long* desc, long long desc_cube,
                 int ncube, int C, int v, KGeom K, int Np, long long NNp, long long cube_stride,
                 int group, double* cube, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(cube_gemm_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((Np + G::BN - 1) / G::BN), (unsigned)((NNp + G::BM - 1) / G::BM),
            (unsigned)(ncube * C));
  cube_gemm_kernel<G><<<grid, G::kThreads, G::kSmem, s>>>(L, R, desc, desc_cube, group, v, K,
                                                          Np, NNp, C, cube_stride, cube);
  return (int)cudaGetLastError();
}

// The block tiles (ops/triples_spatial_cuda.py TILE_CONFIGS): 0 is
// 256 x 64, 1 is 256 x 80.
inline int launch_group_tile(int tile, const double* L, const double* R, const long long* desc,
                             long long desc_cube, int ncube, int C, int v, KGeom K, int Np,
                             long long NNp, long long cube_stride, int group, double* cube,
                             cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch_group<Cfg<8, 2, 4, 2>>(L, R, desc, desc_cube, ncube, C, v, K, Np, NNp,
                                           cube_stride, group, cube, s);
    case 1:
      return launch_group<Cfg<8, 2, 5, 2>>(L, R, desc, desc_cube, ncube, C, v, K, Np, NNp,
                                           cube_stride, group, cube, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Element offsets of the tables in the flat buffers: lbase[t] for the
// left tables t2, VoL, JoT; rbase[2 u + (y_first ? 0 : 1)] for the right
// tables VvF, t2M2, IvF (ops/triples_spatial_cuda.py tiled_layout).
struct Layout {
  long long lbase[3];
  long long rbase[6];
};

// One grid-stride pass over Lbuf (lsize), Rbuf (rsize) and desc
// (ndesc = ncube * n * 24), each element from its source:
//   Lbuf  t2 (o, o, Np, Kv) = t2[p, q, x, k];  VoL (o, o, Np, Ko) =
//         -v_oovo[p, q, x, k];  JoT = -Jo[p, q, k, x]
//   Rbuf  (o, K, NNp), n = y v + z in the (y, z) order or its transpose:
//         VvF[r, f, y, z] = v_vvov[z, y, r, f];  t2M2[r, m, y, z] =
//         t2[m, r, z, y];  IvF[r, f, y, z] = Iv[f, r, y, z]
//   desc  (ncube, n, 3, 8) = base + sum_n idx[n] coef[n] of the triple
// zero where the padding lies.
static __global__ void __launch_bounds__(kLayoutThreads)
layout_kernel(const double* __restrict__ t2, const double* __restrict__ vvov,
              const double* __restrict__ oovo, const double* __restrict__ Iv,
              const double* __restrict__ Jo, const long long* __restrict__ dbase,
              const long long* __restrict__ dcoef, const int* __restrict__ ii,
              const int* __restrict__ jj, const int* __restrict__ kk, Layout lay, int nleft,
              int nright, long long lsize, long long rsize, long long ndesc, int n, int o,
              int v, int Np, int Kv, int Ko, long long NNp, double* __restrict__ Lbuf,
              double* __restrict__ Rbuf, long long* __restrict__ desc) {
  const long long total = lsize + rsize + ndesc;
  for (long long e = (long long)blockIdx.x * kLayoutThreads + threadIdx.x; e < total;
       e += (long long)gridDim.x * kLayoutThreads) {
    if (e < lsize) {
      const int t = (e >= lay.lbase[1]) + (nleft > 2 && e >= lay.lbase[2]);
      const int K = t == 0 ? Kv : Ko;
      const long long rel = e - lay.lbase[t];
      const int k = (int)(rel % K);
      const long long rest = rel / K;
      const int x = (int)(rest % Np);
      const int pq = (int)(rest / Np);
      double val = 0.0;
      if (x < v) {
        if (t == 0 && k < v) val = t2[((long long)pq * v + x) * v + k];
        else if (t == 1 && k < o) val = -oovo[((long long)pq * v + x) * o + k];
        else if (t == 2 && k < o) val = -Jo[((long long)pq * o + k) * v + x];
      }
      Lbuf[e] = val;
    } else if (e < lsize + rsize) {
      const long long er = e - lsize;
      int u = 0;
      for (int q = 1; q < 2 * nright; ++q) u += er >= lay.rbase[q];
      const int name = u / 2;
      const int K = name == 1 ? Ko : Kv;
      const long long rel = er - lay.rbase[u];
      const long long nn = rel % NNp;
      const long long rk = rel / NNp;
      const int k = (int)(rk % K), r = (int)(rk / K);
      double val = 0.0;
      if (nn < (long long)v * v && k < (name == 1 ? o : v)) {
        const int yy = (int)(nn / v), zz = (int)(nn % v);
        const int Y = (u % 2 == 0) ? yy : zz, Z = (u % 2 == 0) ? zz : yy;
        if (name == 0) val = vvov[(((long long)Z * v + Y) * o + r) * v + k];
        else if (name == 1) val = t2[(((long long)k * o + r) * v + Z) * v + Y];
        else val = Iv[(((long long)k * o + r) * v + Y) * v + Z];
      }
      Rbuf[er] = val;
    } else {
      const long long ed = e - lsize - rsize;
      const int slot = (int)(ed % 24);              // (group, term offset)
      const long long qp = ed / 24;
      const int p = (int)(qp % n), q = (int)(qp / n);
      const long long row = (long long)q * 24 + slot;
      desc[ed] = dbase[row] + ii[p] * dcoef[3 * row] + jj[p] * dcoef[3 * row + 1] +
                 kk[p] * dcoef[3 * row + 2];
    }
  }
}

// One call's operand tables and term offsets: layout_kernel over Lbuf,
// Rbuf and the (ncube, n, 3, 8) offsets, a grid-stride walk of at most
// 16 blocks an SM.
inline int launch_layout(const double* t2, const double* vvov, const double* oovo,
                         const double* Iv, const double* Jo, const long long* dbase,
                         const long long* dcoef, const int* ii, const int* jj, const int* kk,
                         const Layout& lay, int nleft, int nright, long long lsize,
                         long long rsize, int ncube, int n, int o, int v, int Np, int Kv, int Ko,
                         long long NNp, double* Lbuf, double* Rbuf, long long* desc,
                         cudaStream_t s) {
  const long long ndesc = (long long)ncube * n * 24;
  const long long total = lsize + rsize + ndesc;
  const long long blocks = (total + kLayoutThreads - 1) / kLayoutThreads;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  layout_kernel<<<grid, kLayoutThreads, 0, s>>>(t2, vvov, oovo, Iv, Jo, dbase, dcoef, ii, jj, kk,
                                                 lay, nleft, nright, lsize, rsize, ndesc, n, o, v,
                                                 Np, Kv, Ko, NNp, Lbuf, Rbuf, desc);
  return (int)cudaGetLastError();
}

}  // namespace sgemm
