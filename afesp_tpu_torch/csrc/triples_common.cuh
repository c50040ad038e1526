// Shared device code of the spin-orbital triples kernels: the energy
// reduction over (P, v, v, v) numerator panels and the fixed-order sum of
// its per-block partials.  Included by triples_finale.cu and
// triples_fused.cu; each is built into its own shared library, so every
// symbol here is static.
//
// Reduction (ccsd.f90:1897-1910, afesp_tpu/ops/triples_pallas.py
// _finale_kernel):
//   sum_{p,a,b,c} P(x)[p,a,b,c] * (P(x) + P(y))[p,a,b,c] / D[p,a,b,c]
//   P(x)[a,b,c] = x[a,b,c] - x[b,a,c] - x[c,b,a]
//   D[p,a,b,c]  = eo[p] - ev[a] - ev[b] - ev[c]
// in f64 with f64 accumulation.  Every thread walks a fixed grid-stride
// sequence, every block reduces in a fixed tree and the partials are
// summed by one block in a fixed order: no atomics, so two runs on the
// same inputs agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace triples {

constexpr int kReduceThreads = 256;

static __global__ void __launch_bounds__(kReduceThreads)
finale_partials_kernel(const double* __restrict__ x, const double* __restrict__ y,
                       const double* __restrict__ eo, const double* __restrict__ ev,
                       long long P, int v, double* __restrict__ partials) {
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const long long total = P * v3;
  const long long stride = (long long)gridDim.x * kReduceThreads;
  double acc = 0.0;
  for (long long g = (long long)blockIdx.x * kReduceThreads + threadIdx.x; g < total;
       g += stride) {
    const long long p = g / v3;
    const long long r = g - p * v3;
    const int a = (int)(r / v2);
    const int rem = (int)(r - (long long)a * v2);
    const int b = rem / v;
    const int c = rem - b * v;
    const long long bac = (long long)b * v2 + (long long)a * v + c;
    const long long cba = (long long)c * v2 + (long long)b * v + a;
    const double* xp = x + p * v3;
    const double* yp = y + p * v3;
    const double px = xp[r] - xp[bac] - xp[cba];
    const double py = yp[r] - yp[bac] - yp[cba];
    const double d = eo[p] - ev[a] - ev[b] - ev[c];
    acc += px * (px + py) / d;
  }
  __shared__ double sh[kReduceThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) partials[blockIdx.x] = sh[0];
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
