// Shared device code of the restricted (spatial) triples kernels K3
// (triples_fused_spatial.cu), K4 (triples_tiled_spatial.cu) and K5
// (triples_finale_spatial.cu): the class operator M, the xbar numerator,
// the rank-structured z3/y numerators, the fixed-order reduction of six
// sums per block and the fixed-order weighted sum of all blocks' partials.
// Each .cu is built into its own shared library, so every symbol here is
// static.
//
// Cube layout: u[a * v^2 + b * v + c], one (v, v, v) cube per triple or
// panel.  The permuted reads u[sigma(a,b,c)] are what both operators need:
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

// Offsets of the six permutations of (a, b, c) in a (v, v, v) cube.
struct Perm6 {
  long long abc, bac, acb, cba, bca, cab;
};

static __device__ __forceinline__ Perm6 perm6(int a, int b, int c, int v) {
  const long long v2 = (long long)v * v;
  Perm6 p;
  p.abc = a * v2 + (long long)b * v + c;
  p.bac = b * v2 + (long long)a * v + c;
  p.acb = a * v2 + (long long)c * v + b;
  p.cba = c * v2 + (long long)b * v + a;
  p.bca = b * v2 + (long long)c * v + a;
  p.cab = c * v2 + (long long)a * v + b;
  return p;
}

static __device__ __forceinline__ double m_op(const double* __restrict__ u, const Perm6& p) {
  return 8.0 * u[p.abc] - 4.0 * (u[p.bac] + u[p.acb] + u[p.cba]) +
         2.0 * (u[p.bca] + u[p.cab]);
}

static __device__ __forceinline__ double xbar3(const double* __restrict__ u, const Perm6& p) {
  return 4.0 * u[p.abc] - 6.0 * u[p.acb] + 2.0 * u[p.bca];
}

// The rank-structured numerator of z3 (Piecuch Eq. 60) and of y
// (Eq. 66) at one element:
//   r(a,b,c) = ti[a] X1[b,c] + tj[b] X2[a,c] + tk[c] X3[a,b]
// with (v, v) matrices X1, X2, X3 (for y, X1 already holds
// outer(tj, tk) + t2[j,k]).
struct Rank3 {
  const double* ti;
  const double* tj;
  const double* tk;
  const double* X1;
  const double* X2;
  const double* X3;
  int v;
  __device__ __forceinline__ double at(int a, int b, int c) const {
    return ti[a] * X1[b * v + c] + tj[b] * X2[a * v + c] + tk[c] * X3[a * v + b];
  }
  __device__ __forceinline__ double m_op(int a, int b, int c) const {
    return 8.0 * at(a, b, c) - 4.0 * (at(b, a, c) + at(a, c, b) + at(c, b, a)) +
           2.0 * (at(b, c, a) + at(c, a, b));
  }
  __device__ __forceinline__ double xbar3(int a, int b, int c) const {
    return 4.0 * at(a, b, c) - 6.0 * at(a, c, b) + 2.0 * at(b, c, a);
  }
};

// Fixed-tree reduction of each thread's six sums over the block; thread
// 0 writes them to out[0:6].
static __device__ __forceinline__ void block_reduce6(double (&acc)[kSums],
                                                     double* __restrict__ out) {
  __shared__ double sh[kSums][kThreads];
#pragma unroll
  for (int q = 0; q < kSums; ++q) sh[q][threadIdx.x] = acc[q];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
#pragma unroll
      for (int q = 0; q < kSums; ++q) sh[q][threadIdx.x] += sh[q][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kSums; ++q) out[q] = sh[q][0];
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

// The M-operator contributions of one element to the six sorted-triple
// sums (K3 and K4):
//   s0 = x . M(t3)  s1 = x . M(z3)  s2 = y . M(t3)
//   s3 = y . M(z3)  s4 = m . M(t3)  s5 = m . M(z3)
// with t3 = x / D and z3 = zn / D; mx = M(x)[abc], mz = M(zn)[abc].
static __device__ __forceinline__ void add_m_terms(double (&acc)[kSums], double x, double y,
                                                   double m, double mx, double mz, double d,
                                                   bool has_z, bool has_y, bool has_m) {
  const double mt = mx / d;
  acc[0] += x * mt;
  if (has_z) acc[1] += x * (mz / d);
  if (has_y) {
    acc[2] += y * mt;
    if (has_z) acc[3] += y * (mz / d);
  }
  if (has_m) {
    acc[4] += m * mt;
    if (has_z) acc[5] += m * (mz / d);
  }
}

}  // namespace spatial
