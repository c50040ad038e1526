// K4: the tiled restricted (spatial) triples tier, stage 2, hand-written
// for Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_tiled.py:triples_tiled_spatial (stage 2:
// kernel body _tiled_kernel, dispatched by _pallas_partials).  Stage 1,
// the 24 numerator GEMMs of a chunk of sorted triples (_chunk_cubes), runs
// as batched torch matmuls in f64 (ops/triples_spatial_cuda.py), as the
// JAX package runs it in XLA.  Given the chunk's per-triple cubes
//   x = t3_D, m = m3, zn = z3 numerator, y        (B, v, v, v)
// this kernel reduces, for every triple t with orbit weight w[t],
//   s0 = x.M(t3)  s1 = x.M(z3)  s2 = y.M(t3)  s3 = y.M(z3)
//   s4 = m.M(t3)  s5 = m.M(z3)
// with t3 = x / D, z3 = zn / D and the class operator M of
// triples_spatial_common.cuh, into per-block partials; a last pass sums
// the weighted partials of all chunks in a fixed order.  f64 throughout.
//
// Design: the TPU kernel tiles the cube into PA-row a-panels and keeps
// every S3 permutation panel-local through a second, b-leading "swap"
// copy of each cube (the identity of triples_tiled.py:31-47), because a
// VMEM block cannot reach outside its panel.  A block on the H100 can
// read any element of a cube in device memory (through L2), so this
// kernel reads the six permuted elements directly and stage 1 builds one
// orientation only: half the cube bytes and no transposes.
//
// Bound on the H100: this stage-2 kernel by bytes.  Per triple it reads
// the x, zn, y and m cubes once (4 v^3 f64): 88 GB for the 680 triples of
// the 174-bf trimer (o = 15, v = 159), 26 ms at 3.35 TB/s, against ~70
// flops an element (2.9 ms at 67 TFLOP/s).  The whole tier, stage 1's 24
// GEMMs included, is bound by operations, as K3 is.
//
// What the simple design leaves on the table: M(x) and M(zn) gather five
// permuted elements each, with strides of v or v^2 between neighbouring
// threads (served from L2, not coalesced); a (v,v) tile of all six
// permutations staged in shared memory would read each cube once.  And
// stage 1 round-trips the cubes through device memory, which K3 would
// avoid by consuming its GEMM tiles on chip.

#include "triples_spatial_common.cuh"

namespace {

using spatial::kSums;
using spatial::kThreads;

__global__ void __launch_bounds__(kThreads)
tiled_spatial_kernel(const double* __restrict__ x, const double* __restrict__ m,
                     const double* __restrict__ zn, const double* __restrict__ y,
                     const double* __restrict__ eo, const double* __restrict__ ev, int v,
                     double* __restrict__ partials) {
  const int t = blockIdx.y;
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const double* xt = x + t * v3;
  const double* mt = m ? m + t * v3 : nullptr;
  const double* zt = zn ? zn + t * v3 : nullptr;
  const double* yt = y ? y + t * v3 : nullptr;
  const double eot = eo[t];

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
    const double d = eot - ev[a] - ev[b] - ev[c];
    spatial::add_m_terms(acc, xt[e], yt ? yt[e] : 0.0, mt ? mt[e] : 0.0,
                         spatial::m_op(xt, pm), zt ? spatial::m_op(zt, pm) : 0.0, d,
                         zt != nullptr, yt != nullptr, mt != nullptr);
  }
  spatial::block_reduce6(acc, partials + ((long long)t * gridDim.x + blockIdx.x) * kSums);
}

}  // namespace

// One chunk of B triples: cubes (B, v, v, v) — x always; m, zn, y null
// when their sums are off; eo (B,) their e_i + e_j + e_k.  Writes
// B * nb * 6 partials (row t * nb + block).
extern "C" int triples_tiled_spatial_chunk_launch(const void* x, const void* m, const void* zn,
                                                  const void* y, const void* eo,
                                                  const void* ev, int B, int v, int nb,
                                                  void* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)nb, (unsigned)B);
  tiled_spatial_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(zn), static_cast<const double*>(y),
      static_cast<const double*>(eo), static_cast<const double*>(ev), v,
      static_cast<double*>(partials));
  return (int)cudaGetLastError();
}

// out[0:6] = sum over the n partial rows of w[row / nb] * partials[row].
extern "C" int triples_spatial_weighted_sum_launch(const void* partials, long long n,
                                                   const void* w, int nb, void* out,
                                                   void* stream) {
  return spatial::launch_weighted_sum6(static_cast<const double*>(partials), n,
                                       static_cast<const double*>(w), nb, 1.0,
                                       static_cast<double*>(out),
                                       static_cast<cudaStream_t>(stream));
}
