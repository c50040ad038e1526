// K2: the spin-orbital triples finale, hand-written for Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_finale (kernel body
// _finale_kernel).  Given the (P, v, v, v) numerator panels t3c (x) and
// t3d (y) of a chunk of triples, their occupied sums eo (P,) and the
// virtual levels ev (v,), it returns
//   sum_{p,a,b,c} P(x) * (P(x) + P(y)) / (eo[p] - ev[a] - ev[b] - ev[c])
// with P(x)[a,b,c] = x[a,b,c] - x[b,a,c] - x[c,b,a].
//
// Precision: f64 throughout, with f64 accumulation.  The TPU kernel is
// f32 with Kahan-compensated plane sums only because Mosaic has no f64
// (triples_pallas.py:11-13); the H100 has, and the contract is the 1e-8 Ha
// physics.
//
// Bound on the H100: bytes.  It reads 2 * P * v^3 * 8 bytes once (0.67 GB
// for a chunk of 35 panels at v = 106, the "pallas" tier's chunk on
// H2O/cc-pVTZ: 0.19 ms at 3.35 TB/s) and does ~12 flops per element.
//
// Design: the energy walk of triples_common.cuh, which K1's energy pass
// also runs, over two panels: a block takes one panel, a 32 x 32 tile of
// (a, c) and a range of 16 b; x[abc], x[bac], y[abc] and y[bac] are read
// coalesced along c, x[cba] and y[cba] coalesced along a and turned
// through a shared-memory transpose.  No integer division per element.
// Each thread sums in a fixed order, each block reduces in a fixed tree
// and writes one partial, and sum_partials_kernel sums the partials in a
// fixed order.
//
// What it leaves on the table: each element is read three times (once
// along c as abc, once as bac, once through the transpose as cba); the
// second and third reads are served from L2 (PERF.md §6).

#include "triples_common.cuh"

namespace {

// P(y) of the walk's second panel, formed beside P(x)
struct SecondPanel {
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ double p(const double (&px)[2], int, int, int) const {
    return px[1];
  }
};

// Grid (tiles, tiles, P nb): panel p0 + blockIdx.z / nb.
__global__ void __launch_bounds__(triples::kEnergyThreads, triples::kEnergyBlocksPerSM)
finale_kernel(const double* __restrict__ x, const double* __restrict__ y,
              const double* __restrict__ eo, const double* __restrict__ ev, int v,
              double* __restrict__ partials) {
  const int nb = triples::energy_b_ranges(v);
  const int p = blockIdx.z / nb;
  const int b0 = (blockIdx.z - p * nb) * triples::kEB, b1 = min(b0 + triples::kEB, v);
  const long long v3 = (long long)v * v * v;
  const double* const panels[2] = {x + p * v3, y + p * v3};
  SecondPanel py;
  const double acc = triples::energy_walk<2>(panels, py, ev, eo[p], v, blockIdx.y * triples::kET,
                                             blockIdx.x * triples::kET, b0, b1);
  triples::energy_block_partial(acc, partials);
}

}  // namespace

// P * nb * tiles^2 partials, tiles = ceil(v / 32), nb = ceil(v / 16), in
// panel-major order, then their fixed-order sum into out[0].  The panels
// go in launches of at most 65535 / nb (the grid's z limit).
extern "C" int triples_finale_launch(const void* x, const void* y, const void* eo,
                                     const void* ev, long long P, int v, void* partials,
                                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (v + triples::kET - 1) / triples::kET;
  const int nb = (v + triples::kEB - 1) / triples::kEB;
  const long long per_panel = (long long)nb * tiles * tiles;
  const long long step = 65535 / nb;
  const long long v3 = (long long)v * v * v;
  for (long long p0 = 0; p0 < P; p0 += step) {
    const long long n = P - p0 < step ? P - p0 : step;
    dim3 grid((unsigned)tiles, (unsigned)tiles, (unsigned)(n * nb));
    finale_kernel<<<grid, triples::kEnergyThreads, 0, s>>>(
        static_cast<const double*>(x) + p0 * v3, static_cast<const double*>(y) + p0 * v3,
        static_cast<const double*>(eo) + p0, static_cast<const double*>(ev), v,
        static_cast<double*>(partials) + p0 * per_panel);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  triples::sum_partials_kernel<<<1, triples::kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), P * per_panel, static_cast<double*>(out));
  return (int)cudaGetLastError();
}
