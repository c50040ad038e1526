// K1: the fused spin-orbital (T) over strict i<j<k triples, hand-written
// for Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_fused (kernel body
// _fused_kernel).  For each triple p = (i, j, k) it forms the connected
// numerator — no cuBLAS —
//   t3c[a, bc] =   sum_K L[j,k][a,K] R[i][K,bc]
//                - sum_K L[i,k][a,K] R[j][K,bc]
//                - sum_K L[j,i][a,K] R[k][K,bc]
//   with L[p,q][a,:] = [ t2[p,q,a,f] (f < v) | ovoo[m,a,p,q] (m < o) ]
//        R[x][:,bc]  = [ vovv[f,x,b,c]       ; t2[m,x,b,c]          ]
// (the six connected GEMMs of ccsd.f90:1883-1890 as three K-concatenated
// dots, K = v + o, the TPU kernel's pairing), the disconnected
//   t3d[a, bc] = t1[i,a] W[j,k,bc] - t1[j,a] W[i,k,bc] + t1[k,a] W[i,j,bc]
// with W = oovv (ccsd.f90:1878), and
//   sum_{a,b,c} P(t3c) (P(t3c) + P(t3d)) / D,  P(x) = x[abc] - x[bac] - x[cba],
//   D = e_i + e_j + e_k - e_a - e_b - e_c.
// The caller applies the strict-grid 1/6.
//
// Bound on the H100: operations.  2 v^3 * 3(v + o) flops a triple:
// 1.0e11 for the 120 strict triples of H2O/cc-pVTZ (o = 10, v = 106),
// 1.5 ms at the 67 TFLOP/s f64 tensor-core peak; its inputs are ~0.2 GB.
//
// Design.  Two launches a chunk of triples, then one fixed-order sum.
//  1. numerator_kernel: the three products as ONE GEMM per triple on the
//     f64 tensor cores (warp-level mma.sync, DMMA; Hopper's wgmma has no
//     f64 type).  The long bc axis (v^2) is the MMA's M, a is its N and
//     the three terms are concatenated along K (3 K' rows, K' = v + o
//     rounded up to even), so one accumulator takes all three.  The
//     wrapper lays the operands out for the tiles (ops/triples_cuda.py
//     fused_tile_operands): R with bc padded to a multiple of BM, L with a
//     padded to a multiple of 8 and a negated copy for the two minus
//     terms, and a table of each triple's three (L, R) block offsets.  The
//     padding wastes 0.8% of M and 5.7% of N at v = 106, 0.4% and 1.9%
//     at v = 212.  A BM x BN = 192 x 112 block tile (the whole of a at
//     v = 106, so each R row is read once a triple), twelve warps of
//     32 x 56, two shared-memory stages of BK = 32 K rows (165 KB of
//     dynamic shared memory) filled by 16-byte cp.async, zero-filled past
//     the end of K and of a.  The operands stream from L2; a taller tile
//     re-reads each L block fewer times.  The tile is written once into
//     the chunk's t3c scratch, (C, v, v, v).
//  2. energy_kernel: triples_common.cuh's energy walk (shared with K2):
//     a block takes one triple, a 32 x 32 tile of (a, c) and walks a
//     range of 16 b; x[abc] and x[bac] are read along c, x[cba] along a
//     and turned through shared memory, so every read of t3c is
//     coalesced.  t3d is never stored: its three permutations are rebuilt
//     from t1 and the triple's three W planes (v^2 each, cache-resident).
//     Fixed per-thread order, a fixed tree per block, one partial per
//     block.
// The GEMM's tile and K loop are dmma_tile.cuh's (shared with K4's
// stage 1); the sum of the partials is triples_common.cuh's.
// Every output element is written by one thread and every sum has a
// fixed order: two runs agree bit for bit.  No nvirt cap.
//
// What it leaves on the table (times in PERF.md §6): the numerator runs
// at about half the DMMA peak; the energy pass reads t3c three times;
// t3c is antisymmetric in (b, c), which would halve the GEMM.

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
static_assert(BM * BK / 2 % kGemmThreads == 0, "A stage copies");
static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % dmma::MMA_K == 0, "tiles");

// Row kg of the concatenated K axis lies in term kg / Kp at row kg % Kp.
__device__ __forceinline__ int term_of(int kg, int Kp) { return (kg >= Kp) + (kg >= 2 * Kp); }
// off[t] by selects: an array indexed at run time would live in local memory
__device__ __forceinline__ long long pick(const long long (&off)[3], int t) {
  return t == 0 ? off[0] : (t == 1 ? off[1] : off[2]);
}

// One stage: the A tile (BK rows of R, bc m0..m0+BM) and the B tile
// (BN rows a0.. of L, BK columns of K) of K rows k0..k0+BK.
__device__ __forceinline__ void load_stage(double* As, double* Bs, const double* __restrict__ L,
                                           const double* __restrict__ R,
                                           const long long (&loff)[3],
                                           const long long (&roff)[3], int k0, int Kp,
                                           int Np, long long NNp, int m0, int a0) {
  const int Ktot = 3 * Kp;
#pragma unroll
  for (int l = 0; l < BM * BK / 2 / kGemmThreads; ++l) {
    const int c = threadIdx.x + l * kGemmThreads;
    const int r = c / (BM / 2), col = (c % (BM / 2)) * 2;
    const int kg = k0 + r;
    const bool ok = kg < Ktot;
    const int t = term_of(kg, Kp);
    const double* src =
        ok ? R + pick(roff, t) + (long long)(kg - t * Kp) * NNp + m0 + col : R;
    dmma::cp_async16(As + r * LDA + col, src, ok);
  }
  for (int c = threadIdx.x; c < BN * BK / 2; c += kGemmThreads) {
    const int n = c / (BK / 2), kq = (c % (BK / 2)) * 2;
    const int kg = k0 + kq;
    const bool ok = kg < Ktot && a0 + n < Np;
    const int t = term_of(kg, Kp);
    const double* src =
        ok ? L + pick(loff, t) + (long long)(a0 + n) * Kp + (kg - t * Kp) : L;
    dmma::cp_async16(Bs + n * LDB + kq, src, ok);
  }
}

// Grid (NNp / BM, ceil(Np / BN), C).  Lbuf: (2, o, o, Np, Kp) = [L | -L];
// Rbuf: (o, Kp, NNp); desc: (C, 6) int64 element offsets (L, R) of the
// three terms of each triple; t3c: (C, v, v*v).
__global__ void __launch_bounds__(kGemmThreads, 1)
numerator_kernel(const double* __restrict__ L, const double* __restrict__ R,
                 const long long* __restrict__ desc, int v, int Kp, int Np, long long NNp,
                 double* __restrict__ t3c) {
  extern __shared__ double smem[];
  double* As = smem;
  double* Bs = smem + STAGES * A_STAGE;
  const int p = blockIdx.z;
  const int m0 = blockIdx.x * BM, a0 = blockIdx.y * BN;
  long long loff[3], roff[3];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    loff[t] = desc[p * 6 + 2 * t];
    roff[t] = desc[p * 6 + 2 * t + 1];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int wm = (warp % WARPS_M) * WM, wn = (warp / WARPS_M) * WN;

  double acc[MT][NT][4];
  dmma::mainloop<MT, NT, BK, LDA, LDB, STAGES>(
      acc, As, Bs, A_STAGE, B_STAGE, (3 * Kp + BK - 1) / BK, wm, wn,
      [&](double* as, double* bs, int k0) {
        load_stage(as, bs, L, R, loff, roff, k0, Kp, Np, NNp, m0, a0);
      });

  // C[m][n]: row g + 8 (q >> 1), col 2 tg + (q & 1); t3c[p][a = n][bc = m]
  const long long NN = (long long)v * v;
  double* out = t3c + (long long)p * v * NN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + mt * 16 + g + 8 * (q >> 1);
        const int n = a0 + wn + nt * 8 + 2 * tg + (q & 1);
        if (m < NN && n < v) out[(long long)n * NN + m] = acc[mt][nt][q];
      }
}

// ---- energy pass -------------------------------------------------------
using triples::kER;
using triples::kET;
using triples::kRPT;

// P(t3d) at (a, b, c) for the energy walk, t3d's three permutations
// rebuilt from t1 and the triple's three W planes: what does not change
// with b sits in shared memory (t1 at the tile's a, the W planes at
// (a, c)), so a thread keeps few registers.
struct RebuiltT3d {
  const double* Wjk;
  const double* Wik;
  const double* Wij;
  const double* t1i;
  const double* t1j;
  const double* t1k;
  const double (*va)[kET];              // t1[i], t1[j], t1[k] at a
  const double (*Wac)[kET][kET + 1];    // W_jk, W_ik, W_ij at [a - a0][c - c0]
  int v, c, tx;
  bool cok;
  double t1ic, t1jc, t1kc;
  double t1ib, t1jb, t1kb, wjk_bc, wik_bc, wij_bc;
  long long bv;

  __device__ __forceinline__ void begin(int b) {
    t1ib = t1i[b];
    t1jb = t1j[b];
    t1kb = t1k[b];
    bv = (long long)b * v;
    wjk_bc = cok ? Wjk[bv + c] : 0.0;
    wik_bc = cok ? Wik[bv + c] : 0.0;
    wij_bc = cok ? Wij[bv + c] : 0.0;
  }
  __device__ __forceinline__ double p(const double (&)[1], int row, int a, int) const {
    const double y_abc = va[0][row] * wjk_bc - va[1][row] * wik_bc + va[2][row] * wij_bc;
    const double y_bac = t1ib * Wac[0][row][tx] - t1jb * Wac[1][row][tx] +
                         t1kb * Wac[2][row][tx];
    const double y_cba = t1ic * Wjk[bv + a] - t1jc * Wik[bv + a] + t1kc * Wij[bv + a];
    return y_abc - y_bac - y_cba;
  }
};

// triples_common.cuh's walk over t3c with t3d rebuilt.  Grid (tiles,
// tiles, C nb); x = t3c (C, v, v, v) of the chunk; eo[p] = e_i + e_j + e_k.
__global__ void __launch_bounds__(triples::kEnergyThreads, triples::kEnergyBlocksPerSM)
energy_kernel(const double* __restrict__ x, const double* __restrict__ W,
              const double* __restrict__ t1, const int* __restrict__ ii,
              const int* __restrict__ jj, const int* __restrict__ kk,
              const double* __restrict__ eo, const double* __restrict__ ev, int o, int v,
              double* __restrict__ partials) {
  __shared__ double Wac[3][kET][kET + 1];
  __shared__ double va[3][kET];
  const int nb = triples::energy_b_ranges(v);
  const int p = blockIdx.z / nb;
  const int b0 = (blockIdx.z - p * nb) * triples::kEB, b1 = min(b0 + triples::kEB, v);
  const int i = ii[p], j = jj[p], k = kk[p];
  const long long v2 = (long long)v * v;
  const int tx = threadIdx.x % kET, ty = threadIdx.x / kET;
  const int a0 = blockIdx.y * kET, c0 = blockIdx.x * kET;
  const int c = c0 + tx;
  const bool cok = c < v;
  RebuiltT3d y;
  y.Wjk = W + (long long)(j * o + k) * v2;
  y.Wik = W + (long long)(i * o + k) * v2;
  y.Wij = W + (long long)(i * o + j) * v2;
  y.t1i = t1 + (long long)i * v;
  y.t1j = t1 + (long long)j * v;
  y.t1k = t1 + (long long)k * v;
  y.va = va;
  y.Wac = Wac;
  y.v = v;
  y.c = c;
  y.tx = tx;
  y.cok = cok;
  y.t1ic = cok ? y.t1i[c] : 0.0;
  y.t1jc = cok ? y.t1j[c] : 0.0;
  y.t1kc = cok ? y.t1k[c] : 0.0;
  if (ty < 3) {
    const int a = a0 + tx;
    const double* src = ty == 0 ? y.t1i : ty == 1 ? y.t1j : y.t1k;
    va[ty][tx] = a < v ? src[a] : 0.0;
  }
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int row = ty + kER * r, a = a0 + row;
    const bool in = a < v && cok;
    Wac[0][row][tx] = in ? y.Wjk[a * v + c] : 0.0;
    Wac[1][row][tx] = in ? y.Wik[a * v + c] : 0.0;
    Wac[2][row][tx] = in ? y.Wij[a * v + c] : 0.0;
  }
  const double* const panels[1] = {x + (long long)p * v2 * v};
  const double acc = triples::energy_walk<1>(panels, y, ev, eo[p], v, a0, c0, b0, b1);
  triples::energy_block_partial(acc, partials);
}

}  // namespace

// The numerator of a chunk of C triples into t3c (C, v, v, v).
extern "C" int triples_fused_numerator_launch(const void* Lbuf, const void* Rbuf,
                                              const void* desc, int C, int v, int Kp,
                                              int Np, long long NNp, void* t3c,
                                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      numerator_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(NNp / BM), (unsigned)((Np + BN - 1) / BN), (unsigned)C);
  numerator_kernel<<<grid, kGemmThreads, kGemmSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(Lbuf), static_cast<const double*>(Rbuf),
      static_cast<const long long*>(desc), v, Kp, Np, NNp, static_cast<double*>(t3c));
  return (int)cudaGetLastError();
}

// The energy pass of a chunk: C * nb * tiles^2 partials, tiles =
// ceil(v / 32), nb = ceil(v / 16), in triple-major order.
extern "C" int triples_fused_energy_launch(const void* t3c, const void* W, const void* t1,
                                           const void* ii, const void* jj, const void* kk,
                                           const void* eo, const void* ev, int C, int o,
                                           int v, void* partials, void* stream) {
  const unsigned tiles = (unsigned)((v + kET - 1) / kET);
  dim3 grid(tiles, tiles, (unsigned)(C * ((v + triples::kEB - 1) / triples::kEB)));
  energy_kernel<<<grid, triples::kEnergyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t3c), static_cast<const double*>(W),
      static_cast<const double*>(t1), static_cast<const int*>(ii), static_cast<const int*>(jj),
      static_cast<const int*>(kk), static_cast<const double*>(eo),
      static_cast<const double*>(ev), o, v, static_cast<double*>(partials));
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
