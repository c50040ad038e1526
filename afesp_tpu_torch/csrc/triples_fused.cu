// K1: the fused spin-orbital (T) over strict i<j<k triples, over the
// Sz-allowed spin blocks only, hand-written for Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_fused (kernel body
// _fused_kernel).  For each triple p = (i, j, k) it forms the connected
// numerator — no cuBLAS —
//   t3c[a, bc] =   sum_K L[j,k][a,K] R[i][K,bc]
//                - sum_K L[i,k][a,K] R[j][K,bc]
//                - sum_K L[j,i][a,K] R[k][K,bc]
//   with L[y,z][a,:] = [ t2[y,z,a,f] (f < v) | ovoo[m,a,y,z] (m < o) ]
//        R[x][:,bc]  = [ vovv[f,x,b,c]       ; t2[m,x,b,c]          ]
// (the six connected GEMMs of ccsd.f90:1883-1890 as three K-concatenated
// dots, K = v + o, the TPU kernel's pairing), the disconnected
//   t3d[a, bc] = t1[i,a] W[j,k,bc] - t1[j,a] W[i,k,bc] + t1[k,a] W[i,j,bc]
// with W = oovv (ccsd.f90:1878), and
//   sum_{a,b,c} P(t3c) (P(t3c) + P(t3d)) / D,  P(x) = x[abc] - x[bac] - x[cba],
//   D = e_i + e_j + e_k - e_a - e_b - e_c.
// The caller applies the strict-grid 1/6.
//
// Spin blocks.  The operands come in block spin order (ops/spin.py: alpha
// then beta within o and within v; a spin is p >= o/2, a >= v/2) from an
// RHF reference, so every Sz-forbidden block of t1, t2, vovv, ovoo and
// oovv is an exact zero (the wrapper checks this, in the readback it
// makes anyway, and raises otherwise).  Then t3 is zero outside the
// output blocks (sa, sb, sc) with sa + sb + sc = si + sj + sk: 1 of 8 for
// an aaa or bbb triple, 3 of 8 for the others.  In an allowed block each
// term's K axis keeps one spin s of f and of m, s = sy + sz - sa
// = sb + sc - sx; where s is -1 or 2 the term is zero and is not issued
// (one term of 9 in a mixed triple's three blocks).  A block's GEMM is
// (v/2)^2 x v/2 x (terms)(v/2 + o/2).  The partners of P(x), x[bac] and
// x[cba], lie in the blocks (sb, sa, sc) and (sc, sb, sa) of the same
// triple, which are allowed too.  The wrapper's plan
// (ops/triples_cuda.py fused_block_plan) lists one row a (triple, block).
//
// Bound on the H100: operations.  The allowed blocks' multiply-adds:
// 1.09e12 over the 1140 strict triples of the water dimer/cc-pVTZ
// (o = 20, v = 212 spin orbitals; 16.1% of the dense cube's 6.8e12 with
// every term, 14.5% without the zero ones), 32.7 ms at the 67 TFLOP/s
// f64 tensor-core peak, 33.4 ms with the energy pass's ~16 flops an
// allowed element (gpubench's count).  The compact t3c is 28 GB written
// and read once at least, 8.4 ms each at 3.35 TB/s.
//
// Design.  Two launches a chunk of rows, then one fixed-order sum.
//  1. numerator_kernel: one GEMM a row on the f64 tensor cores
//     (warp-level mma.sync, DMMA; Hopper's wgmma has no f64 type).  The
//     long bc axis ((v/2)^2) is the MMA's M, a (v/2) its N and the row's
//     terms are concatenated along K (Kp = v/2 + o/2 rounded up to even a
//     term), so one accumulator takes them all.  The wrapper lays the
//     operands out by spin block (fused_tile_operands): L[y,z] per sa,
//     with a padded to a multiple of 8 and a negated copy for the two
//     minus terms; R[x] per allowed (sb, sc), bc padded to a multiple of
//     BM.  A BM x BN = 192 x 112 block tile (the whole of a at v = 212),
//     twelve warps of 32 x 56, two shared-memory stages of BK = 32 K rows
//     (165 KB) filled by 16-byte cp.async, zero-filled past the end of K
//     and of a.  One block an SM walks the tiles (row-major over the
//     rows, bc fastest, so the blocks in flight share a row's L and R);
//     it issues the next tile's first stage before it writes the last
//     tile out, so the epilogue's stores overlap the next loads.  The
//     tile is written once into the chunk's compact t3c scratch,
//     (rows, v/2, v/2, v/2).
//  2. energy_kernel: triples_common.cuh's energy walk (shared with K2)
//     over the allowed blocks: a block takes one row, a 32 x 32 tile of
//     (a, c) and a range of 16 b; x[abc] and x[bac] (from the partner
//     block) are read along c, x[cba] (from the other partner) along a
//     and turned through shared memory, so every read of t3c is
//     coalesced.  t3d is never stored: its three permutations are rebuilt
//     from t1 and the triple's three W planes (v^2 each, cache-resident).
//     Fixed per-thread order, a fixed tree per block, one partial per
//     block, in the plan's row order.
// The GEMM's tile and K loop are dmma_tile.cuh's; the sum of the partials
// is triples_common.cuh's.  Every output element is written by one thread
// and every sum has a fixed order: two runs agree bit for bit.  No nvirt
// cap.
//
// What it leaves on the table (times in PERF.md §6): t3c is antisymmetric
// in (b, c), which would halve the GEMM again (the blocks (sb, sc) and
// (sc, sb) are each other's transposes); a bbb block is the aaa block of
// the spin-flipped triple, but reusing it does less work than the
// benchmark counts, which would first need a re-count there; the energy
// pass reads t3c three times.

#include <cuda_runtime.h>

#include "dmma_tile.cuh"
#include "triples_common.cuh"

namespace {

// ---- numerator GEMM ----------------------------------------------------
constexpr int BM = 192;                 // bc rows of a block tile (MMA M)
constexpr int BN = 112;                 // a columns of a block tile (MMA N)
constexpr int BK = 32;                  // K rows of a shared-memory stage
constexpr int STAGES = 2;
constexpr int WARPS_M = 6, WARPS_N = 2;
constexpr int kGemmThreads = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;        // 32: two m16 tiles a warp
constexpr int WN = BN / WARPS_N;        // 56: seven n8 tiles a warp
constexpr int MT = WM / 16, NT = WN / 8;
// shared strides, 4 (mod 16) doubles: the fragment loads of a warp touch
// every bank pair twice, the least two wavefronts of 8-byte loads allow
constexpr int LDA = BM + 4;             // As[k][m]
constexpr int LDB = BK + 4;             // Bs[n][k]
constexpr int A_STAGE = BK * LDA, B_STAGE = BN * LDB;
constexpr int kGemmSmem = STAGES * (A_STAGE + B_STAGE) * 8;
constexpr int kDesc = 8;                // a plan row: (L, R) x 3, terms, 0
static_assert(BM * BK / 2 % kGemmThreads == 0, "A stage copies");
static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % dmma::MMA_K == 0, "tiles");

// Row kg of the concatenated K axis lies in term kg / Kp at row kg % Kp.
__device__ __forceinline__ int term_of(int kg, int Kp) { return (kg >= Kp) + (kg >= 2 * Kp); }

// One stage: the A tile (BK rows of R, bc m0..m0+BM) and the B tile
// (BN rows a0.. of L, BK columns of K) of K rows k0..k0+BK of the row
// whose plan entry is d (in shared memory).
__device__ __forceinline__ void load_stage(double* As, double* Bs, const double* __restrict__ L,
                                           const double* __restrict__ R, const long long* d,
                                           int k0, int Ktot, int Kp, int Np, long long MMp,
                                           int m0, int a0) {
#pragma unroll
  for (int l = 0; l < BM * BK / 2 / kGemmThreads; ++l) {
    const int c = threadIdx.x + l * kGemmThreads;
    const int r = c / (BM / 2), col = (c % (BM / 2)) * 2;
    const int kg = k0 + r;
    const bool ok = kg < Ktot;
    const int t = term_of(kg, Kp);
    const double* src = ok ? R + d[2 * t + 1] + (long long)(kg - t * Kp) * MMp + m0 + col : R;
    dmma::cp_async16(As + r * LDA + col, src, ok);
  }
  for (int c = threadIdx.x; c < BN * BK / 2; c += kGemmThreads) {
    const int n = c / (BK / 2), kq = (c % (BK / 2)) * 2;
    const int kg = k0 + kq;
    const bool ok = kg < Ktot && a0 + n < Np;
    const int t = term_of(kg, Kp);
    const double* src = ok ? L + d[2 * t] + (long long)(a0 + n) * Kp + (kg - t * Kp) : L;
    dmma::cp_async16(Bs + n * LDB + kq, src, ok);
  }
}

// Grid: at most one block an SM, each walking tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... of the chunk's rows * (MMp / BM) *
// ceil(Np / BN) tiles.  Lbuf: (2, o, o, 2, Np, Kp); Rbuf: (o, 3, Kp,
// MMp); desc: (rows, kDesc) int64, the plan's rows of the chunk; t3c:
// (rows, h, h * h) with h = v / 2.
__global__ void __launch_bounds__(kGemmThreads, 1)
numerator_kernel(const double* __restrict__ L, const double* __restrict__ R,
                 const long long* __restrict__ desc, int rows, int h, int Kp, int Np,
                 long long MMp, double* __restrict__ t3c) {
  extern __shared__ double smem[];
  __shared__ long long sd[2][kDesc];    // the plan rows of this tile and the next
  double* As = smem;
  double* Bs = smem + STAGES * A_STAGE;
  const int mtiles = (int)(MMp / BM);
  const long long per_row = (long long)mtiles * ((Np + BN - 1) / BN);
  const long long total = rows * per_row;
  long long t = blockIdx.x;
  if (t >= total) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M) * WN;
  const long long hh = (long long)h * h;

  // tile -> its plan row in sd[buf], published to every thread
  auto fetch = [&](long long tile, int buf) {
    if (threadIdx.x < kDesc) sd[buf][threadIdx.x] = desc[(tile / per_row) * kDesc + threadIdx.x];
    __syncthreads();
  };
  auto stages = [&](int buf) { return (int)((sd[buf][6] * Kp + BK - 1) / BK); };
  auto loader = [&](long long tile, int buf) {
    const long long rem = tile % per_row;
    const int m0 = (int)(rem % mtiles) * BM, a0 = (int)(rem / mtiles) * BN;
    const int Ktot = (int)sd[buf][6] * Kp;
    const long long* d = sd[buf];
    return [=](double* as, double* bs, int k0) {
      load_stage(as, bs, L, R, d, k0, Ktot, Kp, Np, MMp, m0, a0);
    };
  };

  int buf = 0;
  fetch(t, buf);
  int nk = stages(buf);
  dmma::prologue<BK, STAGES>(As, Bs, A_STAGE, B_STAGE, nk, loader(t, buf));
  double acc[MT][NT][4];
  for (;;) {
    dmma::mainloop<MT, NT, BK, LDA, LDB, STAGES>(acc, As, Bs, A_STAGE, B_STAGE, nk, wm, wn,
                                                 loader(t, buf));
    const long long next = t + gridDim.x;
    const bool more = next < total;
    if (more) {
      // fetch's barrier also orders every warp's last read of the stages
      // before the next tile's first copies
      fetch(next, buf ^ 1);
      nk = stages(buf ^ 1);
      dmma::prologue<BK, STAGES>(As, Bs, A_STAGE, B_STAGE, nk, loader(next, buf ^ 1));
    }
    // C[m][n]: row g + 8 (q >> 1), col 2 tg + (q & 1); t3c[row][a = n][bc = m]
    const long long rem = t % per_row;
    const int m0 = (int)(rem % mtiles) * BM, a0 = (int)(rem / mtiles) * BN;
    double* out = t3c + (t / per_row) * h * hh;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + wm + mt * 16 + g + 8 * (q >> 1);
          const int n = a0 + wn + nt * 8 + 2 * tg + (q & 1);
          if (m < hh && n < h) out[(long long)n * hh + m] = acc[mt][nt][q];
        }
    if (!more) break;
    t = next;
    buf ^= 1;
  }
}

// ---- energy pass -------------------------------------------------------
using triples::kER;
using triples::kET;
using triples::kRPT;

// P(t3d) at (a, b, c) of one spin block for the energy walk, t3d's three
// permutations rebuilt from t1 and the triple's three W planes (a, b, c
// local to the block; t1 and the W planes' rows start at b's spin half,
// the W columns of a and c lie at aoff and cc - c further): what does not
// change with b sits in shared memory (t1 at the tile's a, the W planes
// at (a, c)), so a thread keeps few registers.
struct RebuiltT3d {
  const double* Wjk;
  const double* Wik;
  const double* Wij;
  const double* t1i;
  const double* t1j;
  const double* t1k;
  const double (*va)[kET];              // t1[i], t1[j], t1[k] at a
  const double (*Wac)[kET][kET + 1];    // W_jk, W_ik, W_ij at [a - a0][c - c0]
  int v, cc, tx, aoff;
  bool cok;
  double t1ic, t1jc, t1kc;
  double t1ib, t1jb, t1kb, wjk_bc, wik_bc, wij_bc;
  long long bv;

  __device__ __forceinline__ void begin(int b) {
    t1ib = t1i[b];
    t1jb = t1j[b];
    t1kb = t1k[b];
    bv = (long long)b * v;
    wjk_bc = cok ? Wjk[bv + cc] : 0.0;
    wik_bc = cok ? Wik[bv + cc] : 0.0;
    wij_bc = cok ? Wij[bv + cc] : 0.0;
  }
  __device__ __forceinline__ double p(const double (&)[1], int row, int a, int) const {
    const double y_abc = va[0][row] * wjk_bc - va[1][row] * wik_bc + va[2][row] * wij_bc;
    const double y_bac = t1ib * Wac[0][row][tx] - t1jb * Wac[1][row][tx] +
                         t1kb * Wac[2][row][tx];
    const long long ba = bv + aoff + a;
    const double y_cba = t1ic * Wjk[ba] - t1jc * Wik[ba] + t1kc * Wij[ba];
    return y_abc - y_bac - y_cba;
  }
};

// triples_common.cuh's walk over one allowed block of t3c with t3d
// rebuilt.  Grid (tiles, tiles, rows nb) over blocks of side h = v / 2;
// x = the chunk's compact t3c (rows, h, h, h); edesc: the chunk's plan
// rows (triple, sa, sb, sc, partner rows (sb, sa, sc) and (sc, sb, sa),
// numbered from the plan's start, the chunk's first being `base`);
// eo[p] = e_i + e_j + e_k of triple p.
__global__ void __launch_bounds__(triples::kEnergyThreads, triples::kEnergyBlocksPerSM)
energy_kernel(const double* __restrict__ x, const int* __restrict__ edesc, int base,
              const double* __restrict__ W, const double* __restrict__ t1,
              const int* __restrict__ ii, const int* __restrict__ jj,
              const int* __restrict__ kk, const double* __restrict__ eo, int o, int v, int h,
              const double* __restrict__ ev, double* __restrict__ partials) {
  __shared__ double Wac[3][kET][kET + 1];
  __shared__ double va[3][kET];
  const int nb = triples::energy_b_ranges(h);
  const int r = blockIdx.z / nb;
  const int b0 = (blockIdx.z - r * nb) * triples::kEB, b1 = min(b0 + triples::kEB, h);
  const int* d = edesc + r * kDesc;
  const int p = d[0];
  const int i = ii[p], j = jj[p], k = kk[p];
  const long long v2 = (long long)v * v, h3 = (long long)h * h * h;
  const int tx = threadIdx.x % kET, ty = threadIdx.x / kET;
  const int a0 = blockIdx.y * kET, c0 = blockIdx.x * kET;
  const int c = c0 + tx;
  const bool cok = c < h;
  const int aoff = d[1] * h, boff = d[2] * h, coff = d[3] * h;
  const double* Wjk = W + (long long)(j * o + k) * v2;
  const double* Wik = W + (long long)(i * o + k) * v2;
  const double* Wij = W + (long long)(i * o + j) * v2;
  const double* t1i = t1 + (long long)i * v;
  const double* t1j = t1 + (long long)j * v;
  const double* t1k = t1 + (long long)k * v;
  RebuiltT3d y;
  y.Wjk = Wjk + (long long)boff * v;
  y.Wik = Wik + (long long)boff * v;
  y.Wij = Wij + (long long)boff * v;
  y.t1i = t1i + boff;
  y.t1j = t1j + boff;
  y.t1k = t1k + boff;
  y.va = va;
  y.Wac = Wac;
  y.v = v;
  y.cc = coff + c;
  y.tx = tx;
  y.aoff = aoff;
  y.cok = cok;
  y.t1ic = cok ? t1i[coff + c] : 0.0;
  y.t1jc = cok ? t1j[coff + c] : 0.0;
  y.t1kc = cok ? t1k[coff + c] : 0.0;
  if (ty < 3) {
    const int a = a0 + tx;
    const double* src = ty == 0 ? t1i : ty == 1 ? t1j : t1k;
    va[ty][tx] = a < h ? src[aoff + a] : 0.0;
  }
#pragma unroll
  for (int q = 0; q < kRPT; ++q) {
    const int row = ty + kER * q, a = a0 + row;
    const bool in = a < h && cok;
    const long long ac = (long long)(aoff + a) * v + coff + c;
    Wac[0][row][tx] = in ? Wjk[ac] : 0.0;
    Wac[1][row][tx] = in ? Wik[ac] : 0.0;
    Wac[2][row][tx] = in ? Wij[ac] : 0.0;
  }
  const double* const xabc[1] = {x + r * h3};
  const double* const xbac[1] = {x + (d[4] - base) * h3};
  const double* const xcba[1] = {x + (d[5] - base) * h3};
  const double acc = triples::energy_walk<1>(xabc, xbac, xcba, y, ev + aoff, ev + boff,
                                             ev + coff, eo[p], h, a0, c0, b0, b1);
  triples::energy_block_partial(acc, partials);
}

}  // namespace

// The numerator of a chunk of `rows` plan rows into t3c (rows, h, h, h).
extern "C" int triples_fused_numerator_launch(const void* Lbuf, const void* Rbuf,
                                              const void* desc, int rows, int h, int Kp,
                                              int Np, long long MMp, void* t3c,
                                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      numerator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)rows * (MMp / BM) * ((Np + BN - 1) / BN);
  // one block an SM (its shared memory holds one), each walking tiles
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  numerator_kernel<<<grid, kGemmThreads, kGemmSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(Lbuf), static_cast<const double*>(Rbuf),
      static_cast<const long long*>(desc), rows, h, Kp, Np, MMp, static_cast<double*>(t3c));
  return (int)cudaGetLastError();
}

// The energy pass of a chunk: rows * nb * tiles^2 partials, tiles =
// ceil(h / 32), nb = ceil(h / 16), in row-major order.
extern "C" int triples_fused_energy_launch(const void* t3c, const void* edesc, const void* W,
                                           const void* t1, const void* ii, const void* jj,
                                           const void* kk, const void* eo, int base, int rows,
                                           int o, int v, int h, const void* ev,
                                           void* partials, void* stream) {
  const unsigned tiles = (unsigned)((h + kET - 1) / kET);
  dim3 grid(tiles, tiles, (unsigned)(rows * ((h + triples::kEB - 1) / triples::kEB)));
  energy_kernel<<<grid, triples::kEnergyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t3c), static_cast<const int*>(edesc), base,
      static_cast<const double*>(W), static_cast<const double*>(t1),
      static_cast<const int*>(ii), static_cast<const int*>(jj), static_cast<const int*>(kk),
      static_cast<const double*>(eo), o, v, h, static_cast<const double*>(ev),
      static_cast<double*>(partials));
  return (int)cudaGetLastError();
}

// The fixed-order sum of n partials into out[0].
extern "C" int triples_sum_launch(const void* partials, long long n, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  triples::sum_partials_kernel<<<1, triples::kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), n, static_cast<double*>(out));
  return (int)cudaGetLastError();
}
