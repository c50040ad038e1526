// The f64 tensor-core GEMM tile of K1's numerator (triples_fused.cu):
// warp-level mma.sync m16n8k4 (DMMA; Hopper's wgmma has no f64 type, and
// m8n8k4 runs at half the rate of m16n8k4 on the H100, PERF.md §6), fed
// from a ring of shared-memory stages filled by 16-byte cp.async.
//
// A block computes a tile of C = A B with A[m][k] staged as As[k][m]
// (row stride LDA) and B[k][n] as Bs[n][k] (row stride LDB); each warp
// holds MT x NT m16n8 accumulators at (wm, wn) of the tile.  The kernel
// brings its own stage loader (where each K row of A and B lies) and its
// own epilogue (where C goes).  The first STAGES - 1 stages are issued by
// `prologue`, apart from the K loop, so that a block walking many tiles
// can issue the next tile's first stages before it writes out the last
// one.  Every accumulator takes its K terms in a fixed order, so two runs
// agree bit for bit.  Each .cu is built into its own shared library, so
// every symbol here is static or inline.
#pragma once

#include <cuda_runtime.h>

namespace dmma {

constexpr int MMA_K = 4;  // mma.sync m16n8k4 .f64

__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[2],
                                        const double (&b)[1]) {
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

// The first STAGES - 1 stages of a tile's K loop: load(as, bs, k0)
// issues, without committing, the copies of K rows k0 .. k0 + BK into
// the stage at (as, bs).  The stages must no longer be read.
template <int BK, int STAGES, class Load>
__device__ __forceinline__ void prologue(double* As, double* Bs, int a_stage, int b_stage,
                                         int nk, Load&& load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(As + s * a_stage, Bs + s * b_stage, s * BK);
    cp_async_commit();
  }
}

// The K loop of a block, after its prologue: STAGES - 1 stages in flight
// ahead of the one in use.  On return acc holds the warp's MT x NT tiles
// over all nk stages, and every copy has landed; fragment element q of
// tile (mt, nt) is C[wm + 16 mt + g + 8 (q >> 1)][wn + 8 nt + 2 tg + (q & 1)]
// with g = lane / 4, tg = lane % 4.
template <int MT, int NT, int BK, int LDA, int LDB, int STAGES, class Load>
__device__ __forceinline__ void mainloop(double (&acc)[MT][NT][4], double* As, double* Bs,
                                         int a_stage, int b_stage, int nk, int wm, int wn,
                                         Load&& load) {
  static_assert(BK % MMA_K == 0, "BK");
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pre = kt + STAGES - 1;
    if (pre < nk) load(As + (pre % STAGES) * a_stage, Bs + (pre % STAGES) * b_stage, pre * BK);
    cp_async_commit();
    const double* as = As + (kt % STAGES) * a_stage;
    const double* bs = Bs + (kt % STAGES) * b_stage;
#pragma unroll
    for (int ko = 0; ko < BK; ko += MMA_K) {
      double af[MT][2], bf[NT][1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int q = 0; q < 2; ++q)  // A[m][k]: row g + 8 (q & 1), col tg + 4 (q >> 1)
          af[mt][q] = as[(ko + tg + 4 * (q >> 1)) * LDA + wm + mt * 16 + g + 8 * (q & 1)];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)  // B[k][n]: row tg, col g
        bf[nt][0] = bs[(wn + nt * 8 + g) * LDB + ko + tg];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_f64(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();
}

}  // namespace dmma
