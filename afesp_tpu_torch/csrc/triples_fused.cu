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
//  2. energy_kernel: a block takes one triple, a 32 x 32 tile of (a, c)
//     and walks a range of 16 b.  x[abc] and x[bac] are read along c, x[cba]
//     along a and turned through shared memory, so every read of t3c is
//     coalesced.  t3d is never stored: its three permutations are rebuilt
//     from t1 and the triple's three W planes (v^2 each, cache-resident).
//     No element's index is recovered by division.  Fixed per-thread
//     order, a fixed tree per block, one partial per block.
// The sum of the partials is triples_common.cuh's (shared with K2).
// Every output element is written by one thread and every sum has a
// fixed order: two runs agree bit for bit.  No nvirt cap.
//
// What it leaves on the table (times in PERF.md §6): the numerator runs
// at about half the DMMA peak; the energy pass reads t3c three times;
// t3c is antisymmetric in (b, c), which would halve the GEMM.

#include <cuda_runtime.h>

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
constexpr int MMA_K = 4;                // mma.sync m16n8k4 .f64
constexpr int NA = 16 * MMA_K / 32, NB = MMA_K * 8 / 32;
// shared strides, 4 (mod 16) doubles: the fragment loads of a warp touch
// every bank pair twice, the least two wavefronts of 8-byte loads allow
constexpr int LDA = BM + 4;             // As[k][m]
constexpr int LDB = BK + 4;             // Bs[n][k]
constexpr int A_STAGE = BK * LDA, B_STAGE = BN * LDB;
constexpr int kGemmSmem = STAGES * (A_STAGE + B_STAGE) * 8;
static_assert(BM * BK / 2 % kGemmThreads == 0, "A stage copies");
static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % MMA_K == 0, "tiles");

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[NA],
                                        const double (&b)[NB]) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(double* smem, const double* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
    cp_async16(As + r * LDA + col, src, ok);
  }
  for (int c = threadIdx.x; c < BN * BK / 2; c += kGemmThreads) {
    const int n = c / (BK / 2), kq = (c % (BK / 2)) * 2;
    const int kg = k0 + kq;
    const bool ok = kg < Ktot && a0 + n < Np;
    const int t = term_of(kg, Kp);
    const double* src =
        ok ? L + pick(loff, t) + (long long)(a0 + n) * Kp + (kg - t * Kp) : L;
    cp_async16(Bs + n * LDB + kq, src, ok);
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
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0;

  const int nk = (3 * Kp + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage(As + s * A_STAGE, Bs + s * B_STAGE, L, R, loff, roff, s * BK, Kp, Np, NNp, m0,
                 a0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < nk)
      load_stage(As + (pre % STAGES) * A_STAGE, Bs + (pre % STAGES) * B_STAGE, L, R, loff, roff,
                 pre * BK, Kp, Np, NNp, m0, a0);
    cp_async_commit();
    const double* as = As + (kt % STAGES) * A_STAGE;
    const double* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int ko = 0; ko < BK; ko += MMA_K) {
      double af[MT][NA], bf[NT][NB];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < NA; ++q)  // A[m][k]: row g + 8 (q & 1), col tg + 4 (q >> 1)
          af[mt][q] = as[(ko + tg + 4 * (q >> 1)) * LDA + wm + mt * 16 + g + 8 * (q & 1)];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < NB; ++q)  // B[k][n]: row tg + 4 q, col g
          bf[nt][q] = bs[(wn + nt * 8 + g) * LDB + ko + tg + 4 * q];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_f64(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

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
constexpr int ET = 32;                  // a and c extent of a tile
constexpr int ER = 8;                   // a rows of threads; ET / ER rows each
constexpr int RPT = ET / ER;
constexpr int kEnergyThreads = ET * ER;
constexpr int kEnergyBlocksPerSM = 4;   // 32 warps an SM hide the loads' latency
constexpr int EB = 16;                  // b values a block walks

// Grid (tiles, tiles, C nb), tiles = ceil(v / ET), nb = ceil(v / EB);
// blockIdx.x the c tile, blockIdx.y the a tile, blockIdx.z = p nb + the
// b range.  Short b ranges give a triple many blocks, so the blocks in
// flight share few triples and their three reads of an element meet in
// L2.  x = t3c (C, v, v, v) of the chunk; eo[p] = e_i + e_j + e_k.  One
// partial a block, at ((p nb + range) tiles + at) tiles + ct.
// What does not change with b sits in shared memory (t1 and e at the
// tile's a, the W planes at (a, c)), so a thread keeps few registers.
__global__ void __launch_bounds__(kEnergyThreads, kEnergyBlocksPerSM)
energy_kernel(const double* __restrict__ x, const double* __restrict__ W,
              const double* __restrict__ t1, const int* __restrict__ ii,
              const int* __restrict__ jj, const int* __restrict__ kk,
              const double* __restrict__ eo, const double* __restrict__ ev, int o, int v,
              double* __restrict__ partials) {
  __shared__ double S[2][ET][ET + 1];   // x[c', b, a'] at [c' - c0][a' - a0], two b's
  __shared__ double Wac[3][ET][ET + 1]; // W_jk, W_ik, W_ij at [a - a0][c - c0]
  __shared__ double va[4][ET];          // t1[i], t1[j], t1[k], e_v at a
  __shared__ double red[kEnergyThreads];
  const int nb = (v + EB - 1) / EB;
  const int p = blockIdx.z / nb;
  const int b0 = (blockIdx.z - p * nb) * EB, b1 = min(b0 + EB, v);
  const int i = ii[p], j = jj[p], k = kk[p];
  const long long v2 = (long long)v * v;
  const double* xp = x + (long long)p * v2 * v;
  const double* Wjk = W + (long long)(j * o + k) * v2;
  const double* Wik = W + (long long)(i * o + k) * v2;
  const double* Wij = W + (long long)(i * o + j) * v2;
  const double* t1i = t1 + (long long)i * v;
  const double* t1j = t1 + (long long)j * v;
  const double* t1k = t1 + (long long)k * v;
  const int tx = threadIdx.x % ET, ty = threadIdx.x / ET;
  const int a0 = blockIdx.y * ET, c0 = blockIdx.x * ET;
  const int c = c0 + tx;
  const bool cok = c < v;
  const double ep = eo[p];
  const double t1ic = cok ? t1i[c] : 0.0, t1jc = cok ? t1j[c] : 0.0,
               t1kc = cok ? t1k[c] : 0.0, evc = cok ? ev[c] : 0.0;

  if (ty < 4) {
    const int a = a0 + tx;
    const double* src = ty == 0 ? t1i : ty == 1 ? t1j : ty == 2 ? t1k : ev;
    va[ty][tx] = a < v ? src[a] : 0.0;
  }
  double nxt[RPT];  // x[c', b, a'] of the next b, read ahead of its use
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = ty + ER * r, a = a0 + row, cr = c0 + row, ar = a0 + tx;
    const bool in = a < v && cok;
    Wac[0][row][tx] = in ? Wjk[a * v + c] : 0.0;
    Wac[1][row][tx] = in ? Wik[a * v + c] : 0.0;
    Wac[2][row][tx] = in ? Wij[a * v + c] : 0.0;
    nxt[r] = (cr < v && ar < v) ? xp[((long long)cr * v + b0) * v + ar] : 0.0;
  }

  double acc = 0.0;
  for (int b = b0; b < b1; ++b) {
    double (*Sb)[ET + 1] = S[b & 1];
#pragma unroll
    for (int r = 0; r < RPT; ++r) Sb[ty + ER * r][tx] = nxt[r];
    // one barrier a step: S[b & 1] was last read two steps ago
    __syncthreads();
    if (b + 1 < b1) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int cr = c0 + ty + ER * r, ar = a0 + tx;
        nxt[r] = (cr < v && ar < v) ? xp[((long long)cr * v + b + 1) * v + ar] : 0.0;
      }
    }
    const double t1ib = t1i[b], t1jb = t1j[b], t1kb = t1k[b];
    const double evb = ev[b];
    const long long bv = (long long)b * v;
    const double wjk_bc = cok ? Wjk[bv + c] : 0.0, wik_bc = cok ? Wik[bv + c] : 0.0,
                 wij_bc = cok ? Wij[bv + c] : 0.0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ty + ER * r, a = a0 + row;
      if (!cok || a >= v) continue;
      const double x_abc = xp[((long long)a * v + b) * v + c];
      const double x_bac = xp[(bv + a) * v + c];
      const double x_cba = Sb[tx][row];
      const double y_abc = va[0][row] * wjk_bc - va[1][row] * wik_bc + va[2][row] * wij_bc;
      const double y_bac = t1ib * Wac[0][row][tx] - t1jb * Wac[1][row][tx] +
                           t1kb * Wac[2][row][tx];
      const double y_cba = t1ic * Wjk[bv + a] - t1jc * Wik[bv + a] + t1kc * Wij[bv + a];
      const double px = x_abc - x_bac - x_cba;
      const double py = y_abc - y_bac - y_cba;
      const double d = ep - va[3][row] - evb - evc;
      acc += px * (px + py) / d;
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kEnergyThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = red[0];
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
  const unsigned tiles = (unsigned)((v + ET - 1) / ET);
  dim3 grid(tiles, tiles, (unsigned)(C * ((v + EB - 1) / EB)));
  energy_kernel<<<grid, kEnergyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
