// The numerator GEMM of the restricted (spatial) triples kernels K3
// (triples_fused_spatial.cu) and K4 (triples_tiled_spatial.cu): the
// twelve terms of a numerator cube (x = t3_D or m = m3) on the f64
// tensor cores (mma.sync m16n8k4 .f64; Hopper's wgmma has no f64 type).
// The terms fall into three groups of four by the cube axis their single
// index lands on (ops/triples_spatial_cuda.py fused_term_groups); a group
// is one GEMM a triple,
//   rows (MMA M) = the other two axes (p, q), flattened,
//   cols (MMA N) = the group's axis,
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
// as it reads them.
//
// What bounds it on the H100 (PERF.md §6): under sustained load the card
// sits at its 700 W limit and its clock falls to 1.5-1.9 GHz, where every
// design measured (the previous 256 x 64 one and the forms tried for this
// one) settled near 34 TFLOP/s of *issued* DMMA work; in short runs below
// the limit all of them were held near 11 bytes a clock an SM of operands
// staged through cp.async.  So the design issues few MMAs that multiply
// padding, and stages few bytes a multiply-add.  The column tile (the
// group axis) is wide and fitted to v by the wrapper's tile rule
// (ops/triples_spatial_cuda.py tiled_tile_dims: the tile of TILE_CONFIGS
// that issues the fewest multiply-adds), e.g. two tiles of 136 over the
// pentamer's 265 columns (272 issued) instead of five of 64 (320); a
// 128 x 136 tile stages 8.2 multiply-adds a byte (the previous 256 x 64,
// 6.6), and a stage's 8-deep step wholly past K is skipped.  Its warps:
// WARPS_M rows of MT m16 tiles by WARPS_N columns that share the tile's
// n8 tiles (9 and 8 for 136).
//
// group_gemm_kernel is persistent: about one block an SM walks the
// launch's (cube triple, row tile, column tile) list, column tile
// fastest, so the blocks in flight share their right-hand rows in L2.
// Its K loop is one stream over all its tiles: a ring of STAGES shared
// stages of BK = 16 K rows, each guarded by two mbarriers (full: every
// thread's copies of it have landed; empty: every warp has read it), and
// no block-wide barrier.  Each warp, at stage it, copies its share of
// stage it + STAGES - 2 (16-byte cp.async, the term offsets read through
// L1) into the slot that stage it - 2 left, then multiplies stage it; so
// a warp waits only on a warp two stages behind, and the next tile's
// first stages load while a tile's last stages are multiplied and its
// epilogue stores from registers.  A warp reads its fragments as 16-byte
// shared loads: it takes row g of an m16 tile as (p, q) row 2g and row
// g + 8 as 2g + 1, and lane t's two K columns of an 8-deep step as rows
// 2t and 2t + 1, so a lane's A and B operands of two m16n8k4 MMAs lie
// side by side; the shared strides (A: 2 mod 8 doubles, B: 8 mod 16)
// keep each quarter warp's reads on distinct banks.  (m16n8k8 and
// m16n8k16 run at the same 66 TFLOP/s as m16n8k4 from registers and were
// no faster here.)  Each accumulator takes its K terms in one fixed
// order, so two launches agree bit for bit; no split K, no atomics.  One
// launch may cover several cubes (x and m) of a chunk of C triples.
//
// What it leaves on the table: a warp holds 208-254 registers, so a
// block has eight warps, two an SM sub-partition (the 12- and 16-warp
// forms tried spilled); at the power limit the GEMM still runs near half
// the DMMA peak.  Each .cu is built into its own shared library, so
// every symbol here is static, inline or a template.
#pragma once

#include <cuda_runtime.h>

namespace sgemm {

constexpr int KC = 8;                   // K rows of one fragment step
constexpr int kTerms = 4;               // two t2 terms, two m terms
constexpr int kLayoutThreads = 256;

// mma.sync m16n8k4 .f64, D += A B: a0 = A[g][t], a1 = A[g + 8][t],
// b0 = B[t][g]; d[q] = D[g + 8 (q >> 1)][2 t + (q & 1)] (g = lane / 4,
// t = lane % 4)
__device__ __forceinline__ void mma_k4(double (&d)[4], double a0, double a1, double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(double* smem, const double* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// mbarriers in shared memory
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// arrive once the calling thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_on_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// wait until the barrier's phase of this parity has completed (a fresh
// barrier's preceding phase, parity 1, counts as completed)
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra WAIT;\n"
      "DONE:\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A block: WARPS_M x WARPS_N warps.  Warp row r covers (p, q) rows
// 16 MT r ..; the tile's N8 n8 tiles of group-axis columns are split over
// the WARPS_N warp columns, NT0 each to the first R of them and NT0 - 1
// to the rest; STAGES shared-memory stages, stage it + DIST loaded while
// stage it is multiplied.
template <int WARPS_M_, int MT_, int WARPS_N_, int N8_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, MT = MT_, WARPS_N = WARPS_N_, N8 = N8_;
  static constexpr int BK = BK_;             // K rows of a shared-memory stage
  static constexpr int STAGES = STAGES_, DIST = STAGES - 2;
  static constexpr int NT0 = (N8 + WARPS_N - 1) / WARPS_N;
  static constexpr int R = N8 - (NT0 - 1) * WARPS_N;
  static constexpr int kWarps = WARPS_M * WARPS_N;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int WM = 16 * MT;
  static constexpr int BM = WM * WARPS_M;    // (p, q) rows of a tile (MMA M)
  static constexpr int BN = 8 * N8;          // group-axis columns (MMA N)
  static constexpr int LDA = BM + 2;         // As[k][m]
  static constexpr int LDB = BK % 16 == 8 ? BK : BK + 8;  // Bs[n][k]
  static constexpr int A_STAGE = BK * LDA, B_STAGE = BN * LDB;
  static constexpr int kSmem = STAGES * (A_STAGE + B_STAGE) * 8;
  // a thread's 16-byte copies of a stage: A rows r0 + A_ROWS l at its
  // column pair, B columns n0 + B_COLS l at its K row pair
  static constexpr int A_ROWS = kThreads / (BM / 2);
  static constexpr int A_COPIES = (BK + A_ROWS - 1) / A_ROWS;
  static constexpr int B_COLS = kThreads / (BK / 2);
  static constexpr int B_COPIES = (BN + B_COLS - 1) / B_COLS;
  // the first n8 tile and the count of warp column c
  static __device__ __forceinline__ int col_start(int c) {
    return c < R ? c * NT0 : R * NT0 + (c - R) * (NT0 - 1);
  }
  static_assert(LDA % 8 == 2 && LDB % 16 == 8, "shared strides");
  static_assert(BK % KC == 0 && N8 >= WARPS_N && DIST >= 1, "tile");
  static_assert(kThreads % (BM / 2) == 0 && kThreads % (BK / 2) == 0, "copies");
  static_assert(kSmem + 2 * STAGES * 8 <= 232448, "shared memory");
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

// What a launch covers: ntn column tiles by ntm row tiles by ncube * C
// (cube, triple) pairs, column tile fastest.
struct Grid {
  int ntn, ntm, C;
  long long ntiles;
  __device__ __forceinline__ void at(long long tile, int& n0, int& m0, int& q, int& p,
                                     int BM, int BN) const {
    const long long rest = tile / ntn;
    n0 = (int)(tile - rest * ntn) * BN;
    const long long z = rest / ntm;
    m0 = (int)(rest - z * ntm) * BM;
    q = (int)(z / C);
    p = (int)(z - (long long)q * C);
  }
};

// The tile a thread is copying: its term offsets d (L0, R0, .., L3, R3),
// read through L1 at each copy, and its corner.
struct Loader {
  const long long* d;
  int m0, n0;
};

// Issue, without committing, this thread's copies of K rows k0 .. k0 +
// BK of its tile into the stage at (as, bs): A[k][m] from the right-hand
// tables, B[n][k] from the left-hand ones; zeros past K, past NNp rows
// and past Np columns.
template <class G>
__device__ __forceinline__ void load_stage(double* as, double* bs, const double* L,
                                           const double* R, const Loader& ld, KGeom K,
                                           int k0, int Np, long long NNp) {
  const int Ktot = K.total();
  const int col = 2 * (threadIdx.x % (G::BM / 2)), r0 = threadIdx.x / (G::BM / 2);
  const bool col_ok = ld.m0 + col < NNp;
#pragma unroll
  for (int l = 0; l < G::A_COPIES; ++l) {
    const int r = r0 + l * G::A_ROWS;
    if (G::BK % G::A_ROWS != 0 && r >= G::BK) break;
    const int kg = k0 + r;
    const int t = K.term(kg);
    const bool ok = col_ok && kg < Ktot;
    const long long row = __ldg(ld.d + 2 * t + 1) + (long long)(kg - K.start(t)) * NNp;
    cp_async16(as + r * G::LDA + col, ok ? R + row + ld.m0 + col : R, ok);
  }
  const int kq = 2 * (threadIdx.x % (G::BK / 2)), nb = threadIdx.x / (G::BK / 2);
  const int kg = k0 + kq;
  const int t = K.term(kg);
  const int ldt = K.ld(t);
  const double* b =
      L + __ldg(ld.d + 2 * t) + (long long)(ld.n0 + nb) * ldt + (kg - K.start(t));
#pragma unroll
  for (int l = 0; l < G::B_COPIES; ++l) {
    const int n = nb + l * G::B_COLS;
    if (n < G::BN) {
      const bool ok = kg < Ktot && ld.n0 + n < Np;
      cp_async16(bs + n * G::LDB + kq, ok ? b + (long long)(l * G::B_COLS) * ldt : L, ok);
    }
  }
}

// One stage of a warp's tile: NT of its n8 tiles (NT0 or NT0 - 1), two
// m16n8k4 MMAs (K rows kc + 2t + h, h = 0, 1) over each 8-deep step that
// holds any of the stage's krows rows inside K (the rest are zeros).
template <class G, int NT>
__device__ __forceinline__ void mma_stage(double (&acc)[G::MT][G::NT0][4], const double* as,
                                          const double* bs, int krows) {
#pragma unroll
  for (int kc = 0; kc < G::BK; kc += KC) {
    if (kc >= krows) break;
    double2 a[G::MT][2], b[NT];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mt][h] = *reinterpret_cast<const double2*>(as + (kc + h) * G::LDA + 16 * mt);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      b[nt] = *reinterpret_cast<const double2*>(bs + 8 * nt * G::LDB + kc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
          mma_k4(acc[mt][nt], h ? a[mt][1].x : a[mt][0].x, h ? a[mt][1].y : a[mt][0].y,
                 h ? b[nt].y : b[nt].x);
  }
}

// A warp's tile out of registers, its accumulators zeroed: with (m0, n0)
// the warp's corner, acc[mt][nt][2h + e] is C[m][n] at m = m0 + 16 mt +
// 2g + h, n = n0 + 8 nt + 2t + e; m = p v + q over the two other axes, n
// the group's axis.
template <class G, int NT>
__device__ __forceinline__ void store_tile(double (&acc)[G::MT][G::NT0][4], double* out,
                                           int group, int v, int m0, int n0) {
  const int lane = threadIdx.x % 32, g = lane / 4, tg = lane % 4;
  const long long NN = (long long)v * v;
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 16 * mt + 2 * g + h;
      const int mp = m / v, mq = m - mp * v;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * nt + 2 * tg + e;
          if (m < NN && n < v) {
            const long long o = group == 0   ? n * NN + m
                                : group == 1 ? mp * NN + (long long)n * v + mq
                                             : (long long)m * v + n;
            out[o] = acc[mt][nt][2 * h + e];
          }
          acc[mt][nt][2 * h + e] = 0.0;
        }
    }
}

// Grid (blocks): each block takes tiles blockIdx.x, + gridDim.x, ... of
// the launch's list.  L, R: the flat operand tables; desc: per cube
// (desc_cube elements apart) (C, 3, 8) int64, per triple and group the
// element offsets (L, R) of its four terms; cube: per cube (cube_stride
// elements apart) (C, v, v, v).  group: the cube axis of the group's
// single index.
template <class G>
__global__ void __launch_bounds__(G::kThreads, 1)
group_gemm_kernel(const double* __restrict__ L, const double* __restrict__ R,
                  const long long* __restrict__ desc, long long desc_cube, int group, int v,
                  KGeom K, int Np, long long NNp, Grid tiles, long long cube_stride,
                  double* __restrict__ cube) {
  extern __shared__ __align__(16) double smem[];
  __shared__ unsigned long long full[G::STAGES], empty[G::STAGES];
  double* As = smem;
  double* Bs = smem + G::STAGES * G::A_STAGE;
  const int nk = (K.total() + G::BK - 1) / G::BK;
  const long long first = blockIdx.x;
  const int step = gridDim.x;
  // the block's tiles, and its stages tile after tile
  const int mine = first < tiles.ntiles ? (int)((tiles.ntiles - 1 - first) / step) + 1 : 0;
  const int total = mine * nk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], G::kThreads);
      mbar_init(&empty[s], G::kWarps);
    }
  }
  __syncthreads();

  // the copy stream: stage `lit` (tile lj, K block lkb) into slot ls,
  // once every warp has read the stage it held, STAGES earlier; DIST
  // stages ahead of the stage multiplied
  Loader ld;
  int lit = 0, lj = 0, lkb = 0, ls = 0;
  unsigned lphase = 0;
  auto load_next = [&]() {
    if (lit < total) {
      if (lkb == 0) {
        int q, p;
        tiles.at(first + (long long)lj * step, ld.n0, ld.m0, q, p, G::BM, G::BN);
        ld.d = desc + q * desc_cube + ((long long)p * 3 + group) * 2 * kTerms;
      }
      mbar_wait(&empty[ls], lphase ^ 1);
      load_stage<G>(As + ls * G::A_STAGE, Bs + ls * G::B_STAGE, L, R, ld, K, lkb * G::BK, Np,
                    NNp);
      // every thread arrives once a stage, whatever it copied
      mbar_arrive_on_copies(&full[ls]);
    }
    ++lit;
    if (++lkb == nk) {
      lkb = 0;
      ++lj;
    }
    if (++ls == G::STAGES) {
      ls = 0;
      lphase ^= 1;
    }
  };
#pragma unroll 1
  for (int s = 0; s < G::DIST; ++s) load_next();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = (warp % G::WARPS_M) * G::WM, wc = warp / G::WARPS_M;
  const int wn = 8 * G::col_start(wc);
  const bool wide = wc < G::R;  // NT0 n8 tiles, else NT0 - 1
  // this lane's fragment reads in a stage: A rows 2g, 2g + 1 of each m16
  // tile at K rows kc + 2t + h (h = 0, 1); B K rows kc + 2t, kc + 2t + 1
  // of column g of each n8 tile
  const int a_off = 2 * tg * G::LDA + wm + 2 * g;
  const int b_off = (wn + g) * G::LDB + 2 * tg;

  double acc[G::MT][G::NT0][4];
#pragma unroll
  for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < G::NT0; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;

  int s = 0;
  unsigned phase = 0;
  for (int j = 0; j < mine; ++j) {
    for (int kb = 0; kb < nk; ++kb) {
      load_next();
      mbar_wait(&full[s], phase);
      const double* as = As + s * G::A_STAGE + a_off;
      const double* bs = Bs + s * G::B_STAGE + b_off;
      const int krows = K.total() - kb * G::BK;
      if (wide)
        mma_stage<G, G::NT0>(acc, as, bs, krows);
      else
        mma_stage<G, (G::NT0 > 1 ? G::NT0 - 1 : 1)>(acc, as, bs, krows);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == G::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    // the tile's epilogue, while the next tile's first stages load
    int n0, m0, q, p;
    tiles.at(first + (long long)j * step, n0, m0, q, p, G::BM, G::BN);
    double* out = cube + q * cube_stride + (long long)p * v * ((long long)v * v);
    if (wide)
      store_tile<G, G::NT0>(acc, out, group, v, m0 + wm, n0 + wn);
    else
      store_tile<G, (G::NT0 > 1 ? G::NT0 - 1 : 1)>(acc, out, group, v, m0 + wm, n0 + wn);
  }
}

// One group's launch over ncube cubes of C triples each: a persistent
// grid of as many blocks as the card keeps resident, at most one a tile.
template <class G>
int launch_group(const double* L, const double* R, const long long* desc, long long desc_cube,
                 int ncube, int C, int v, KGeom K, int Np, long long NNp, long long cube_stride,
                 int group, double* cube, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(group_gemm_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_gemm_kernel<G>,
                                                           G::kThreads, G::kSmem)) !=
      cudaSuccess)
    return (int)err;
  Grid tiles;
  tiles.ntn = (Np + G::BN - 1) / G::BN;
  tiles.ntm = (int)((NNp + G::BM - 1) / G::BM);
  tiles.C = C;
  tiles.ntiles = (long long)tiles.ntn * tiles.ntm * ncube * C;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(tiles.ntiles < resident ? tiles.ntiles : resident);
  group_gemm_kernel<G><<<grid, G::kThreads, G::kSmem, s>>>(L, R, desc, desc_cube, group, v, K,
                                                           Np, NNp, tiles, cube_stride, cube);
  return (int)cudaGetLastError();
}

// The tiles (ops/triples_spatial_cuda.py TILE_CONFIGS, same order).
using Tile0 = Cfg<4, 2, 2, 17, 16, 3>;   // 128 x 136
using Tile1 = Cfg<2, 4, 4, 20, 16, 4>;   // 128 x 160
using Tile2 = Cfg<4, 2, 2, 14, 16, 3>;   // 128 x 112
using Tile3 = Cfg<4, 2, 2, 7, 16, 3>;    // 128 x 56

inline int launch_group_tile(int tile, const double* L, const double* R, const long long* desc,
                             long long desc_cube, int ncube, int C, int v, KGeom K, int Np,
                             long long NNp, long long cube_stride, int group, double* cube,
                             cudaStream_t s) {
  switch (tile) {
    case 0:
      return launch_group<Tile0>(L, R, desc, desc_cube, ncube, C, v, K, Np, NNp, cube_stride,
                                 group, cube, s);
    case 1:
      return launch_group<Tile1>(L, R, desc, desc_cube, ncube, C, v, K, Np, NNp, cube_stride,
                                 group, cube, s);
    case 2:
      return launch_group<Tile2>(L, R, desc, desc_cube, ncube, C, v, K, Np, NNp, cube_stride,
                                 group, cube, s);
    case 3:
      return launch_group<Tile3>(L, R, desc, desc_cube, ncube, C, v, K, Np, NNp, cube_stride,
                                 group, cube, s);
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
