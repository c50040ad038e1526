// The restricted (spatial) triples over sorted i<=j<=k triples on the
// H100: the C entry points of K3 (triples_fused_spatial.cu) and K4
// (triples_tiled_spatial.cu), which run the same kernels.  For each
// sorted triple t = (i, j, k) with orbit weight w[t] they reduce
//   s0 = x.M(t3)  s1 = x.M(z3)  s2 = y.M(t3)  s3 = y.M(z3)
//   s4 = m.M(t3)  s5 = m.M(z3)
// with x = t3_D and m = m3 the twelve-term numerator cubes (m for CR
// only; ccsd.f90:2168-2173 / 2188-2193), t3 = x / D, z3 = zn / D, zn and
// y the rank-structured numerators (Piecuch Eqs. 60, 66) and the class
// operator M of triples_spatial_common.cuh.  Four kinds of launch, in
// the order ops/triples_spatial_cuda.py issues them:
//
// 1. spatial_layout_launch, once a call: spatial_gemm.cuh's layout_kernel
//    lays out the numerator GEMM's operand tables straight from the
//    inputs, and each triple's term offsets from the per-shape tables.
// 2. spatial_group_launch, three a chunk: spatial_gemm.cuh's persistent
//    group GEMM on the f64 tensor cores (mma.sync m16n8k4), one launch a
//    group for the x and m cubes of a chunk of triples, each group writing
//    cubes of its own.
// 3. spatial_orbit_launch, one a chunk: sorted_orbit_kernel below, with
//    orbit_tile.cuh's tile_triple_sums (shared with K5), stages each
//    distinct 8-wide tile of a sorted tile triple's six orders once,
//    summing the three groups' elements in group order as it reads them
//    in rows of 8, builds zn once an element, and takes M(x) and M(zn)
//    from shared memory; y is built and m read at abc.  One partial row
//    of six sums a block.
// 4. triples_spatial_weighted_sum_launch: the weighted sum of all blocks'
//    partial rows, one block, fixed order.
//
// f64 throughout, f64 accumulation (the TPU kernels are f32 because
// Mosaic has no f64).  Fixed-order sums and trees, no atomics: two
// launches on the same inputs agree bit for bit.  No nvirt cap.
//
// This header defines the entry points: each .cu that includes it is
// built into its own shared library, and no library includes it twice.
#pragma once

#include "orbit_tile.cuh"
#include "spatial_gemm.cuh"
#include "triples_spatial_common.cuh"

namespace orbit {

// The six sums of a chunk of C sorted triples.  Grid (nT, C): one block
// a sorted tile triple (tiles (nT, 3) int32) of a triple of the chunk;
// one partial row of six sums a block at (t nT + tile triple).  x, m:
// the chunk's (C, v, v, v) cubes, each as the numerator GEMM's kGroups
// parts, part_stride elements apart (m null without CR); t1 (o, v);
// t2, W = v_oovv (o, o, v, v); e_o (o,), ev (v,); ii/jj/kk the chunk's
// triples.
constexpr int kGroups = 3;

static __global__ void __launch_bounds__(kThreads, 3)
sorted_orbit_kernel(const double* __restrict__ x, const double* __restrict__ m,
                    long long part_stride, const double* __restrict__ t1,
                    const double* __restrict__ t2, const double* __restrict__ W,
                    const double* __restrict__ ev, const double* __restrict__ e_o,
                    const int* __restrict__ ii, const int* __restrict__ jj,
                    const int* __restrict__ kk, const int* __restrict__ tiles, int o, int v,
                    int has_z, int has_y, double* __restrict__ partials) {
  extern __shared__ double smem[];
  const int t = blockIdx.y;
  const int i = ii[t], j = jj[t], k = kk[t];
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const long long jk = (long long)(j * o + k) * v2, ik = (long long)(i * o + k) * v2,
                  ij = (long long)(i * o + j) * v2;
  double acc[kSums];
#pragma unroll
  for (int q = 0; q < kSums; ++q) acc[q] = 0.0;
  // zn over v_oovv's [j,k], [i,k], [i,j] planes, y over t2's
  tile_triple_sums<Op::M, kGroups>(
      x + t * v3, m ? m + t * v3 : x + t * v3, part_stride, t1 + (long long)i * v,
      t1 + (long long)j * v, t1 + (long long)k * v, W + jk, W + ik, W + ij, t2 + jk, t2 + ik,
      t2 + ij, ev, e_o[i] + e_o[j] + e_o[k], v, tiles[3 * blockIdx.x],
      tiles[3 * blockIdx.x + 1], tiles[3 * blockIdx.x + 2], has_z != 0, has_y != 0,
      m != nullptr, smem, acc);
  spatial::block_reduce6(acc, partials + ((long long)t * gridDim.x + blockIdx.x) * kSums);
}

inline int launch_sorted_orbit(const void* x, const void* m, long long part_stride,
                               const void* t1, const void* t2, const void* W, const void* ev,
                               const void* e_o, const void* ii, const void* jj, const void* kk,
                               const void* tiles, int nT, int C, int o, int v, int has_z,
                               int has_y, void* partials, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(sorted_orbit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kOrbitSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nT, (unsigned)C);
  sorted_orbit_kernel<<<grid, kThreads, kOrbitSmem, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(m), part_stride,
      static_cast<const double*>(t1), static_cast<const double*>(t2),
      static_cast<const double*>(W), static_cast<const double*>(ev),
      static_cast<const double*>(e_o), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<const int*>(kk),
      static_cast<const int*>(tiles), o, v, has_z, has_y, static_cast<double*>(partials));
  return (int)cudaGetLastError();
}

}  // namespace orbit

// The operand tables and term offsets of one call.  bases: 9 int64 in
// host memory (sgemm::Layout); dbase (ncube, 3, 8), dcoef (ncube, 3, 8, 3)
// int64 the per-shape offset tables; ii/jj/kk (n,) int32; Iv, Jo null
// without CR (nleft 2, nright 2).
extern "C" int spatial_layout_launch(const void* t2, const void* vvov, const void* oovo,
                                     const void* Iv, const void* Jo, const void* dbase,
                                     const void* dcoef, const void* ii, const void* jj,
                                     const void* kk, const void* bases, int nleft, int nright,
                                     long long lsize, long long rsize, int ncube, int n, int o,
                                     int v, int Np, int Kv, int Ko, long long NNp, void* Lbuf,
                                     void* Rbuf, void* desc, void* stream) {
  sgemm::Layout lay;
  const long long* b = static_cast<const long long*>(bases);
  for (int q = 0; q < 3; ++q) lay.lbase[q] = b[q];
  for (int q = 0; q < 6; ++q) lay.rbase[q] = b[3 + q];
  return sgemm::launch_layout(
      static_cast<const double*>(t2), static_cast<const double*>(vvov),
      static_cast<const double*>(oovo), static_cast<const double*>(Iv),
      static_cast<const double*>(Jo), static_cast<const long long*>(dbase),
      static_cast<const long long*>(dcoef), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<const int*>(kk), lay, nleft, nright, lsize, rsize,
      ncube, n, o, v, Np, Kv, Ko, NNp, static_cast<double*>(Lbuf), static_cast<double*>(Rbuf),
      static_cast<long long*>(desc), static_cast<cudaStream_t>(stream));
}

// One group's GEMM for the ncube cubes of a chunk of C triples, written
// to the group's own cubes: desc points at the chunk's first triple of
// cube 0 (cubes desc_cube elements apart), cube at the group's cube 0
// (cubes cube_stride elements apart); tile: the block tile (TILE_CONFIGS
// of ops/triples_spatial_cuda.py, picked from the shape by its
// tiled_tile_dims).
extern "C" int spatial_group_launch(const void* L, const void* R, const void* desc,
                                    long long desc_cube, int ncube, int C, int v, int Kv, int Ko,
                                    int Np, long long NNp, int tile, int group,
                                    long long cube_stride, void* cube, void* stream) {
  return sgemm::launch_group_tile(
      tile, static_cast<const double*>(L), static_cast<const double*>(R),
      static_cast<const long long*>(desc), desc_cube, ncube, C, v, sgemm::KGeom{Kv, Ko}, Np,
      NNp, cube_stride, group, static_cast<double*>(cube), static_cast<cudaStream_t>(stream));
}

// The six sums of each of the chunk's C triples into nT * C partial rows
// (row t nT + tile triple), over the sums of the three groups' cubes
// (part_stride elements apart); m null without CR.
extern "C" int spatial_orbit_launch(const void* x, const void* m, long long part_stride,
                                    const void* t1, const void* t2, const void* W,
                                    const void* ev, const void* e_o, const void* ii,
                                    const void* jj, const void* kk, const void* tiles, int nT,
                                    int C, int o, int v, int has_z, int has_y, void* partials,
                                    void* stream) {
  return orbit::launch_sorted_orbit(x, m, part_stride, t1, t2, W, ev, e_o, ii, jj, kk, tiles,
                                    nT, C, o, v, has_z, has_y, partials,
                                    static_cast<cudaStream_t>(stream));
}

// out[0:6] = sum over the n partial rows of w[row / nT] * partials[row].
extern "C" int triples_spatial_weighted_sum_launch(const void* partials, long long n,
                                                   const void* w, int nT, void* out,
                                                   void* stream) {
  return spatial::launch_weighted_sum6(static_cast<const double*>(partials), n,
                                       static_cast<const double*>(w), nT, 1.0,
                                       static_cast<double*>(out),
                                       static_cast<cudaStream_t>(stream));
}
