// K1: the fused spin-orbital (T) over strict i<j<k triples, hand-written
// for Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_fused (kernel body
// _fused_kernel).  For each triple p = (i, j, k) it forms the numerator
// panels in its own body — no cuBLAS —
//   t3c[a, bc] =   sum_K L[j,k][a,K] R[i][K,bc]
//                - sum_K L[i,k][a,K] R[j][K,bc]
//                - sum_K L[j,i][a,K] R[k][K,bc]
//   with L[p,q][a,:] = [ t2[p,q,a,f] (f < v) | ovoo[m,a,p,q] (m < o) ]
//        R[x][:,bc]  = [ vovv[f,x,b,c]       ; t2[m,x,b,c]          ]
// (the six connected GEMMs of ccsd.f90:1883-1890 as three K-concatenated
// dots, K = v + o, exactly the TPU kernel's pairing), and
//   t3d[a, bc] = t1[i,a] W[j,k,bc] - t1[j,a] W[i,k,bc] + t1[k,a] W[i,j,bc]
// with W = oovv (ccsd.f90:1878).  The energy reduction over the panels is
// the finale of triples_common.cuh (shared with K2), then one fixed-order
// sum of the per-block partials of all chunks.  The caller applies the
// strict-grid 1/6.
//
// Precision: f64 throughout, f64 accumulation (the TPU kernel is f32
// because Mosaic has no f64, triples_pallas.py:11-13).  No nvirt cap and
// no padding to 128: ragged tiles are masked.
//
// Bound on the H100: operations.  2 * v * v^2 * 3(v + o) flops per
// triple: 1.0e11 for the 120 strict triples of H2O/cc-pVTZ (o = 10,
// v = 106), 1.5 ms at the 67 TFLOP/s f64 tensor-core peak.  Its inputs
// are ~0.2 GB.
//
// What the simple design leaves on the table: the GEMM runs on the f64
// FMA pipes (half the tensor-core rate at best) from a 64x64x16
// shared-memory tile with no double buffering; the t3c and t3d panels of
// a chunk go through device memory (2 * C * v^3 * 8 bytes, written once
// and read three times) instead of staying on chip as the TPU kernel's
// VMEM cubes do; and a tile of the a-dimension is padded from 106 to 128.

#include "triples_common.cuh"

namespace {

constexpr int TM = 64;   // a-rows of a tile
constexpr int TN = 64;   // bc-columns of a tile
constexpr int TK = 16;   // K-depth of a shared-memory stage
constexpr int kThreads = 256;  // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
numerator_kernel(const double* __restrict__ L, const double* __restrict__ R,
                 const double* __restrict__ W, const double* __restrict__ t1,
                 const int* __restrict__ ii, const int* __restrict__ jj,
                 const int* __restrict__ kk, int o, int v,
                 double* __restrict__ t3c, double* __restrict__ t3d) {
  const int KK = v + o;
  const long long NN = (long long)v * v;
  const int p = blockIdx.z;
  const int i = ii[p], j = jj[p], k = kk[p];
  const int a0 = blockIdx.y * TM;
  const long long n0 = (long long)blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  __shared__ double As[TK][TM + 1];
  __shared__ double Bs[TK][TN];
  double acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0;

  for (int term = 0; term < 3; ++term) {
    const int lp = term == 1 ? i : j;
    const int lq = term == 0 ? k : (term == 1 ? k : i);
    const int rx = term == 0 ? i : (term == 1 ? j : k);
    const double sign = term == 0 ? 1.0 : -1.0;
    const double* Lp = L + (long long)(lp * o + lq) * v * KK;  // (v, KK)
    const double* Rp = R + (long long)rx * KK * NN;            // (KK, NN)
    for (int k0 = 0; k0 < KK; k0 += TK) {
#pragma unroll
      for (int l = 0; l < TM * TK / kThreads; ++l) {
        const int idx = threadIdx.x + l * kThreads;
        const int m = idx / TK, kq = idx % TK;
        const int a = a0 + m, kg = k0 + kq;
        As[kq][m] = (a < v && kg < KK) ? sign * Lp[(long long)a * KK + kg] : 0.0;
      }
#pragma unroll
      for (int l = 0; l < TN * TK / kThreads; ++l) {
        const int idx = threadIdx.x + l * kThreads;
        const int kq = idx / TN, nq = idx % TN;
        const long long n = n0 + nq;
        const int kg = k0 + kq;
        Bs[kq][nq] = (n < NN && kg < KK) ? Rp[(long long)kg * NN + n] : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int kq = 0; kq < TK; ++kq) {
        double av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = As[kq][ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[kq][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fma(av[r], bv[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

  const double* Wjk = W + (long long)(j * o + k) * NN;
  const double* Wik = W + (long long)(i * o + k) * NN;
  const double* Wij = W + (long long)(i * o + j) * NN;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int a = a0 + ty + 16 * r;
    if (a >= v) continue;
    const double t1i = t1[i * v + a], t1j = t1[j * v + a], t1k = t1[k * v + a];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long n = n0 + tx + 16 * c;
      if (n >= NN) continue;
      const long long out = ((long long)p * v + a) * NN + n;
      t3c[out] = acc[r][c];
      t3d[out] = t1i * Wjk[n] - t1j * Wik[n] + t1k * Wij[n];
    }
  }
}

}  // namespace

// One chunk of C triples: numerator panels into the caller's scratch
// (t3c, t3d: (C, v, v, v)), then the finale's per-block partials into
// partials[0 : nblocks].
extern "C" int triples_fused_chunk_launch(const void* L, const void* R, const void* W,
                                          const void* t1, const void* ii,
                                          const void* jj, const void* kk, int C,
                                          int o, int v, const void* eo,
                                          const void* ev, void* t3c, void* t3d,
                                          void* partials, int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long NN = (long long)v * v;
  dim3 grid((unsigned)((NN + TN - 1) / TN), (unsigned)((v + TM - 1) / TM), (unsigned)C);
  numerator_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const double*>(L), static_cast<const double*>(R),
      static_cast<const double*>(W), static_cast<const double*>(t1),
      static_cast<const int*>(ii), static_cast<const int*>(jj),
      static_cast<const int*>(kk), o, v, static_cast<double*>(t3c),
      static_cast<double*>(t3d));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  triples::finale_partials_kernel<<<nblocks, triples::kReduceThreads, 0, s>>>(
      static_cast<const double*>(t3c), static_cast<const double*>(t3d),
      static_cast<const double*>(eo), static_cast<const double*>(ev), C, v,
      static_cast<double*>(partials));
  return (int)cudaGetLastError();
}

// The fixed-order sum of n partials into out[0].
extern "C" int triples_sum_launch(const void* partials, long long n, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  triples::sum_partials_kernel<<<1, triples::kReduceThreads, 0, s>>>(
      static_cast<const double*>(partials), n, static_cast<double*>(out));
  return (int)cudaGetLastError();
}
