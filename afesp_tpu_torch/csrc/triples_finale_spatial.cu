// K5: the restricted (spatial) triples finale, hand-written for Hopper
// (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_finale_spatial
// (kernel body _make_spatial_kernel).  For each (j,k) panel p of one
// i-slab, given the numerator cubes t3_D (x) and m3 (m), it forms in
// registers, element by element,
//   t3 = x / D,  t_bar = xbar(t3),  z3 = zn / D,  z_bar = xbar(z3),  y
// with D = eo[p] - ev[a] - ev[b] - ev[c], the z3 numerator
//   zn[a,b,c] = t1_i[a] W[j,k][b,c] + t1[j,b] W[i,k][a,c] + t1[k,c] W[i,j][a,b]
// (W = v_oovv, Piecuch Eq. 60) and y (Eq. 66) from its (v,v)/(v,)
// factors, and reduces the six sums
//   s0 = t_bar.x  s1 = z_bar.x  s2 = t_bar.y  s3 = z_bar.y
//   s4 = t_bar.m  s5 = z_bar.m
// each divided by 3 (xbar's common factor), in f64 with f64 accumulation.
// One grid row of blocks per panel, a fixed-stride walk over its v^3
// elements, a fixed-tree block reduction, then one block sums all
// partials in a fixed order (triples_spatial_common.cuh).
//
// Bound on the H100: bytes.  It reads the x and m cubes once (2 P v^3
// f64; 60 MB for one i-slab of H2O/cc-pVTZ, P = 25 panels at v = 53:
// 18 us at 3.35 TB/s) and the (v,v) factor panels (6 P v^2), and does
// ~45 flops an element (2.5 us at the 67 TFLOP/s f64 peak).
//
// What the simple design leaves on the table: xbar reads x at three
// permuted positions, two of them with a stride of v or v^2 between
// neighbouring threads (served from L2, not coalesced), and the z3
// numerator is rebuilt at three positions for every element instead of
// once per (v,v) tile in shared memory; every element's (a, b, c) comes
// from integer division.

#include "triples_spatial_common.cuh"

namespace {

using spatial::kSums;
using spatial::kThreads;

__global__ void __launch_bounds__(kThreads)
finale_spatial_kernel(const double* __restrict__ x, const double* __restrict__ m,
                      const double* __restrict__ mats, const double* __restrict__ vecs,
                      const double* __restrict__ eo, const double* __restrict__ t1i,
                      const double* __restrict__ ev, int v, int has_z, int has_y,
                      int has_m, double* __restrict__ partials) {
  const int p = blockIdx.y;
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const double* xp = x + p * v3;
  const double* mp = has_m ? m + p * v3 : nullptr;
  const double* mat = mats + (long long)p * 6 * v2;
  const double* vec = vecs + (long long)p * 2 * v;
  const double* t1j = vec;
  const double* t1k = vec + v;
  // z3: t1_i (x) W[j,k], t1[j] (x) W[i,k], t1[k] (x) W[i,j]
  const spatial::Rank3 zn{t1i, t1j, t1k, mat, mat + v2, mat + 2 * v2, v};
  const double* ujk = mat + 3 * v2;
  const double* uik = mat + 4 * v2;
  const double* uij = mat + 5 * v2;
  const double eop = eo[p];

  double acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < v3; e += stride) {
    const int a = (int)(e / v2);
    const int rem = (int)(e - a * v2);
    const int b = rem / v;
    const int c = rem - b * v;
    const spatial::Perm6 pm = spatial::perm6(a, b, c, v);
    const double d = eop - ev[a] - ev[b] - ev[c];
    const double xv = xp[e];
    const double tb = spatial::xbar3(xp, pm) / d;
    acc[0] += tb * xv;
    double zb = 0.0;
    if (has_z) {
      zb = zn.xbar3(a, b, c) / d;
      acc[1] += zb * xv;
    }
    if (has_y) {
      const double yv = t1i[a] * (t1j[b] * t1k[c] + ujk[b * v + c]) +
                        t1j[b] * uik[a * v + c] + uij[a * v + b] * t1k[c];
      acc[2] += tb * yv;
      if (has_z) acc[3] += zb * yv;
    }
    if (has_m) {
      const double mv = mp[e];
      acc[4] += tb * mv;
      if (has_z) acc[5] += zb * mv;
    }
  }
  spatial::block_reduce6(acc, partials + ((long long)p * gridDim.x + blockIdx.x) * kSums);
}

}  // namespace

// P panels of (v, v, v) cubes: x = t3_D, m = m3 (ignored unless has_m;
// may be null then); mats (P, 6, v, v) = [W[j,k], W[i,k], W[i,j], t2[j,k],
// t2[i,k], t2[i,j]]; vecs (P, 2, v) = [t1[j], t1[k]]; eo (P,); t1i, ev
// (v,).  partials holds P * nb * 6 doubles; out[0:6] receives the six
// sums, each divided by 3.
extern "C" int triples_finale_spatial_launch(const void* x, const void* m, const void* mats,
                                             const void* vecs, const void* eo,
                                             const void* t1i, const void* ev, int P, int v,
                                             int has_z, int has_y, int has_m, int nb,
                                             void* partials, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)nb, (unsigned)P);
  finale_spatial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(mats), static_cast<const double*>(vecs),
      static_cast<const double*>(eo), static_cast<const double*>(t1i),
      static_cast<const double*>(ev), v, has_z, has_y, has_m,
      static_cast<double*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return spatial::launch_weighted_sum6(static_cast<const double*>(partials),
                                       (long long)P * nb, nullptr, 1, 1.0 / 3.0,
                                       static_cast<double*>(out), s);
}
