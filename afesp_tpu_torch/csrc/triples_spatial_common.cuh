// Shared device code of the restricted (spatial) triples kernels K3
// (triples_fused_spatial.cu), K4 (triples_tiled_spatial.cu) and K5
// (triples_finale_spatial.cu): the fixed-order reduction of six sums per
// block and the fixed-order weighted sum of all blocks' partials.
// Each .cu is built into its own shared library, so every symbol here is
// static.
//
// Cube layout: u[a * v^2 + b * v + c], one (v, v, v) cube per triple or
// panel.  The operators of the reductions read permuted elements
// u[sigma(a,b,c)] (orbit_tile.cuh stages them):
//
//   xbar(u)[abc] = 4 u[abc] - 6 u[acb] + 2 u[bca]       (x3 of make_x_bar,
//                  ccsd.f90:2313-2318; the caller applies the 1/3)
//   M(u)[abc]    = 8 u[abc] - 4 (u[bac] + u[acb] + u[cba])
//                  + 2 (u[bca] + u[cab])
//
// M is the conjugacy-class operator of afesp_tpu/ops/triples_pallas.py
// _fused_spatial_kernel: summed over sorted triples i<=j<=k with the
// orbit weights 1, 1/2, 1/6, G . M(u) reproduces the full-cube xbar
// reductions (strict_spatial_plan).  The denominator D[abc] =
// eo - ev[a] - ev[b] - ev[c] is symmetric under every permutation, so
// M(u / D) = M(u) / D and xbar(u / D) = xbar(u) / D exactly (as reals).
//
// Every reduction is a fixed-order tree and the partials are summed by
// one block in a fixed order: no atomics, so two runs on the same inputs
// agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace spatial {

constexpr int kThreads = 256;
constexpr int kSums = 6;

// Fixed-tree reduction of each thread's six sums over the block: each
// warp by shuffles, then thread q < 6 sums the warps' q-th values in
// warp order and writes out[q].
static __device__ __forceinline__ void block_reduce6(double (&acc)[kSums],
                                                     double* __restrict__ out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ double sh[kSums][kWarps];
#pragma unroll
  for (int q = 0; q < kSums; ++q) {
    double val = acc[q];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) val += __shfl_down_sync(0xffffffffu, val, d);
    if (threadIdx.x % 32 == 0) sh[q][threadIdx.x / 32] = val;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sh[threadIdx.x][w];
    out[threadIdx.x] = sum;
  }
}

// out[q] = scale * sum_r w[r / rows_per_weight] * partials[r * 6 + q]
// over n rows (w == nullptr: every weight is 1), by one block in a fixed
// order.
static __global__ void __launch_bounds__(kThreads)
weighted_sum6_kernel(const double* __restrict__ partials, long long n,
                     const double* __restrict__ w, int rows_per_weight, double scale,
                     double* __restrict__ out) {
  double acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
  for (long long r = threadIdx.x; r < n; r += kThreads) {
    const double wr = w ? w[r / rows_per_weight] : 1.0;
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] += wr * partials[r * kSums + q];
  }
  __shared__ double res[kSums];
  block_reduce6(acc, res);
  __syncthreads();
  if (threadIdx.x < kSums) out[threadIdx.x] = scale * res[threadIdx.x];
}

static inline int launch_weighted_sum6(const double* partials, long long n, const double* w,
                                       int rows_per_weight, double scale, double* out,
                                       cudaStream_t s) {
  weighted_sum6_kernel<<<1, kThreads, 0, s>>>(partials, n, w, rows_per_weight, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace spatial
