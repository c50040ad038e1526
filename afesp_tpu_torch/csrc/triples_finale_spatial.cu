// K5: the restricted (spatial) triples finale, hand-written for Hopper
// (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_finale_spatial
// (kernel body _make_spatial_kernel).  For each (j,k) panel p of one
// i-slab, given the numerator cubes t3_D (x) and m3 (m), it reduces
//   s0 = t_bar.x  s1 = z_bar.x  s2 = t_bar.y  s3 = z_bar.y
//   s4 = t_bar.m  s5 = z_bar.m
// with t_bar = xbar(x / D), z_bar = xbar(zn / D),
// D = eo[p] - ev[a] - ev[b] - ev[c], the z3 numerator
//   zn[a,b,c] = t1_i[a] W[j,k][b,c] + t1[j,b] W[i,k][a,c] + t1[k,c] W[i,j][a,b]
// (W = v_oovv, Piecuch Eq. 60) and y (Eq. 66) from their (v,v)/(v,)
// factors, each divided by 3 (xbar's common factor), in f64 with f64
// accumulation.
//
// The walk: orbit_tile.cuh's tiles over each panel's full cube (shared
// with K3 and K4).  A block takes one sorted triple of 8-wide
// tiles of one panel and stages each distinct tile of its six orders
// once — x read from device memory in rows of 8, zn built there from its
// factors — and takes xbar3(x) = 4 x[abc] - 6 x[acb] + 2 x[bca] and
// xbar3(zn) from shared memory; y is built and m read at abc.  zn is
// evaluated once an element, not at three points.  Local indices are
// shifts and masks of the 8-wide tile: no division in the walk.  Each thread
// sums in a fixed order, each block reduces in a fixed tree and writes
// one partial row, and one block sums all partials in a fixed order
// (triples_spatial_common.cuh): two runs agree bit for bit.
//
// Bound on the H100: bytes.  It reads the x and m cubes once (2 P v^3
// f64; 60 MB for one i-slab of H2O/cc-pVTZ, P = 25 panels at v = 53:
// 18 us at 3.35 TB/s) and the (v,v) factor panels (6 P v^2), and does
// ~45 flops an element (2.5 us at the 67 TFLOP/s f64 peak).  What it
// leaves on the table (PERF.md §6): rows of 8 doubles (64 bytes) per
// tile row, and a block's staging and its sums take turns (3 blocks an
// SM, 55 KB of staged tiles each).

#include "orbit_tile.cuh"
#include "triples_spatial_common.cuh"

namespace {

using spatial::kSums;
using spatial::kThreads;

// Grid (nT, P): one block a sorted tile triple (tiles (nT, 3)) of a
// panel; one partial row of six sums a block at (p nT + tile triple).
__global__ void __launch_bounds__(kThreads, 3)
finale_orbit_kernel(const double* __restrict__ x, const double* __restrict__ m,
                    const double* __restrict__ mats, const double* __restrict__ vecs,
                    const double* __restrict__ eo, const double* __restrict__ t1i,
                    const double* __restrict__ ev, const int* __restrict__ tiles, int v,
                    int has_z, int has_y, int has_m, double* __restrict__ partials) {
  extern __shared__ double smem[];
  const int p = blockIdx.y;
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const double* mat = mats + (long long)p * 6 * v2;
  const double* t1j = vecs + (long long)p * 2 * v;
  const double* t1k = t1j + v;
  double acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
  // zn: t1_i (x) W[j,k], t1[j] (x) W[i,k], t1[k] (x) W[i,j]; y likewise
  // over t2[j,k] (plus t1_i t1[j] t1[k]), t2[i,k], t2[i,j]
  orbit::tile_triple_sums<orbit::Op::Xbar, 1>(
      x + p * v3, has_m ? m + p * v3 : x + p * v3, 0, t1i, t1j, t1k, mat, mat + v2, mat + 2 * v2,
      mat + 3 * v2, mat + 4 * v2, mat + 5 * v2, ev, eo[p], v, tiles[3 * blockIdx.x],
      tiles[3 * blockIdx.x + 1], tiles[3 * blockIdx.x + 2], has_z != 0, has_y != 0,
      has_m != 0, smem, acc);
  spatial::block_reduce6(acc, partials + ((long long)p * gridDim.x + blockIdx.x) * kSums);
}

}  // namespace

// P panels of (v, v, v) cubes: x = t3_D, m = m3 (ignored unless has_m;
// may be null then); mats (P, 6, v, v) = [W[j,k], W[i,k], W[i,j], t2[j,k],
// t2[i,k], t2[i,j]]; vecs (P, 2, v) = [t1[j], t1[k]]; eo (P,); t1i, ev
// (v,); tiles (nT, 3) int32 the sorted tile triples.  partials holds
// P * nT * 6 doubles; out[0:6] receives the six sums, each divided by 3.
extern "C" int triples_finale_spatial_launch(const void* x, const void* m, const void* mats,
                                             const void* vecs, const void* eo,
                                             const void* t1i, const void* ev,
                                             const void* tiles, int nT, int P, int v,
                                             int has_z, int has_y, int has_m, void* partials,
                                             void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(finale_orbit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         orbit::kOrbitSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nT, (unsigned)P);
  finale_orbit_kernel<<<grid, kThreads, orbit::kOrbitSmem, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(mats), static_cast<const double*>(vecs),
      static_cast<const double*>(eo), static_cast<const double*>(t1i),
      static_cast<const double*>(ev), static_cast<const int*>(tiles), v, has_z, has_y, has_m,
      static_cast<double*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return spatial::launch_weighted_sum6(static_cast<const double*>(partials),
                                       (long long)P * nT, nullptr, 1, 1.0 / 3.0,
                                       static_cast<double*>(out), s);
}
