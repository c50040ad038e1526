// Shared device code of the spin-orbital triples kernels K1
// (triples_fused.cu, its energy pass over spin blocks) and K2
// (triples_finale.cu): the walk of the energy reduction over (v, v, v)
// numerator panels and the fixed-order sum of its per-block partials.
// Each .cu is built into its own shared library, so every symbol here is
// static.
//
// Reduction (ccsd.f90:1897-1910, afesp_tpu/ops/triples_pallas.py
// _finale_kernel), per panel p of a triple:
//   sum_{a,b,c} P(x)[a,b,c] * (P(x) + P(y))[a,b,c] / D[a,b,c]
//   P(x)[a,b,c] = x[a,b,c] - x[b,a,c] - x[c,b,a]
//   D[a,b,c]    = eo[p] - ev[a] - ev[b] - ev[c]
// in f64 with f64 accumulation.
//
// The walk: a block takes one panel, a 32 x 32 tile of (a, c) and a range
// of 16 b.  x[abc] and x[bac] are read along c, x[cba] along a and turned
// through a double-buffered shared-memory tile, so every read of a panel
// is coalesced, and the next b's transposed rows are read a step ahead.
// No element's index is recovered by division.  Each thread sums its
// elements in a fixed order, each block reduces in a fixed tree and
// writes one partial, and one block sums the partials in a fixed order:
// no atomics, so two runs on the same inputs agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace triples {

constexpr int kReduceThreads = 256;

// ---- the energy walk -----------------------------------------------------
constexpr int kET = 32;                 // a and c extent of a tile
constexpr int kER = 8;                  // a rows of threads; kET / kER rows each
constexpr int kRPT = kET / kER;
constexpr int kEnergyThreads = kET * kER;
constexpr int kEnergyBlocksPerSM = 4;   // 32 warps an SM hide the loads' latency
constexpr int kEB = 16;                 // b values a block walks
static_assert(kEnergyThreads == kReduceThreads, "one reduction tree");

// Blocks of a panel: ceil(v / kET)^2 (a, c) tiles times ceil(v / kEB)
// b ranges.  Grid (tiles, tiles, panels * nb): blockIdx.x the c tile,
// blockIdx.y the a tile, blockIdx.z = panel * nb + the b range.  Short
// b ranges give a panel many blocks, so the blocks in flight share few
// panels and their three reads of an element meet in L2.
static __device__ __forceinline__ int energy_b_ranges(int v) { return (v + kEB - 1) / kEB; }

// The walk of one block over the NP panels (each (v, v, v), read as
// above), b from b0 to b1 in the (a, c) tile at (a0, c0).  P(x) of panel
// q is xabc[q][a,b,c] - xbac[q][b,a,c] - xcba[q][c,b,a]: K2 reads all
// three from one panel, K1 from the three spin blocks of t3c that hold
// them (each (v, v, v) with v the spin half), with the virtual levels of
// a, b and c at ev_a, ev_b and ev_c.  P(x) is that of panel 0, and P(y)
// is y.p(px, row, a, b): K2 reads y as a second panel (px[1]), K1
// rebuilds it from t1 and W.  y.begin(b) runs once a b step, after the
// barrier that publishes the step's shared tile (and anything y staged
// before the walk).  Returns this thread's sum.
template <int NP, class Y>
static __device__ __forceinline__ double energy_walk(
    const double* const (&xabc)[NP], const double* const (&xbac)[NP],
    const double* const (&xcba)[NP], Y& y, const double* __restrict__ ev_a,
    const double* __restrict__ ev_b, const double* __restrict__ ev_c, double ep, int v, int a0,
    int c0, int b0, int b1) {
  __shared__ double S[NP][2][kET][kET + 1];  // x[c', b, a'] at [c' - c0][a' - a0], two b's
  __shared__ double eva[kET];                // e_v at the tile's a
  const int tx = threadIdx.x % kET, ty = threadIdx.x / kET;
  const int c = c0 + tx;
  const bool cok = c < v;
  const double evc = cok ? ev_c[c] : 0.0;
  if (ty == kER - 1) eva[tx] = a0 + tx < v ? ev_a[a0 + tx] : 0.0;

  double nxt[NP][kRPT];  // x[c', b, a'] of the next b, read ahead of its use
#pragma unroll
  for (int q = 0; q < NP; ++q)
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int cr = c0 + ty + kER * r, ar = a0 + tx;
      nxt[q][r] = (cr < v && ar < v) ? xcba[q][((long long)cr * v + b0) * v + ar] : 0.0;
    }

  double acc = 0.0;
  for (int b = b0; b < b1; ++b) {
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int r = 0; r < kRPT; ++r) S[q][b & 1][ty + kER * r][tx] = nxt[q][r];
    // one barrier a step: S[.][b & 1] was last read two steps ago
    __syncthreads();
    if (b + 1 < b1) {
#pragma unroll
      for (int q = 0; q < NP; ++q)
#pragma unroll
        for (int r = 0; r < kRPT; ++r) {
          const int cr = c0 + ty + kER * r, ar = a0 + tx;
          nxt[q][r] =
              (cr < v && ar < v) ? xcba[q][((long long)cr * v + b + 1) * v + ar] : 0.0;
        }
    }
    y.begin(b);
    const double evb = ev_b[b];
    const long long bv = (long long)b * v;
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int row = ty + kER * r, a = a0 + row;
      if (!cok || a >= v) continue;
      double px[NP];
#pragma unroll
      for (int q = 0; q < NP; ++q)
        px[q] = xabc[q][((long long)a * v + b) * v + c] - xbac[q][(bv + a) * v + c] -
                S[q][b & 1][tx][row];
      const double py = y.p(px, row, a, b);
      const double d = ep - eva[row] - evb - evc;
      acc += px[0] * (px[0] + py) / d;
    }
  }
  return acc;
}

// The walk with each permutation read from the panel itself (K2).
template <int NP, class Y>
static __device__ __forceinline__ double energy_walk(const double* const (&xp)[NP], Y& y,
                                                     const double* __restrict__ ev, double ep,
                                                     int v, int a0, int c0, int b0, int b1) {
  return energy_walk<NP>(xp, xp, xp, y, ev, ev, ev, ep, v, a0, c0, b0, b1);
}

// Fixed-tree sum of the block's kEnergyThreads values; thread 0 writes
// it to partials at ((z * gridDim.y + y) * gridDim.x + x).
static __device__ __forceinline__ void energy_block_partial(double acc,
                                                            double* __restrict__ partials) {
  __shared__ double red[kEnergyThreads];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kEnergyThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partials[((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = red[0];
}

static __global__ void __launch_bounds__(kReduceThreads)
sum_partials_kernel(const double* __restrict__ partials, long long n,
                    double* __restrict__ out) {
  double acc = 0.0;
  for (long long q = threadIdx.x; q < n; q += kReduceThreads) acc += partials[q];
  __shared__ double sh[kReduceThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = sh[0];
}

}  // namespace triples
