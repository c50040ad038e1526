// K3: the fused restricted (spatial) triples over sorted i<=j<=k triples,
// hand-written for Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_fused_spatial (kernel
// body _fused_spatial_kernel).  For each triple p = (i, j, k) it forms
// the twelve t3_D numerator terms and, for CR, the twelve m3 terms
// (ccsd.f90:2168-2173 / 2188-2193; the term tables _SPATIAL_F_TERMS,
// _SPATIAL_M_TERMS, _SPATIAL_M3M_TERMS) in its own GEMM body — no cuBLAS
// — and then the six M-operator sums
//   s0 = x.M(t3)  s1 = x.M(z3)  s2 = y.M(t3)  s3 = y.M(z3)
//   s4 = m.M(t3)  s5 = m.M(z3)
// with t3 = x / D, z3 = zn / D, and zn and y rebuilt on the fly from their
// (v,v)/(v,) factors, as the TPU kernel does.  The orbit weights
// (1, 1/2, 1/6) are applied in f64 by the last, fixed-order pass.
//
// The GEMMs.  Each of the twelve terms is a rank-K product
//   term[a,b,c] = sign * sum_K A[x][K] B[K][y,z]
// whose single index x is one of a, b, c and whose pair (y, z) are the
// other two in either order.  Grouped by the cube axis x lands on, the
// terms form three groups of four; a group is one GEMM of
//   rows  = that axis (64-row tile),
//   cols  = the other two axes, flattened (64-column tile),
//   depth = the four terms' K one after another (K = v or o each),
// with each term's operand offsets and strides in a descriptor that the
// wrapper derives from the term tables (ops/triples_spatial_cuda.py
// fused_term_groups).  The three groups run as three launches into the
// chunk's cube in device scratch, the first writing and the next two
// adding, so every element is written by one thread per launch and the
// sum is in a fixed order.  The reduction then walks the cubes.
//
// Precision: f64 throughout, f64 accumulation (the TPU kernel is f32
// because Mosaic has no f64).  No nvirt cap and no padding to 128 lanes:
// ragged tiles are masked.
//
// Bound on the H100: operations.  2 v^3 (2 v + 2 o) flops per cube per
// group, 3 groups, x2 for CR: 7.2e9 for the 35 sorted triples of
// H2O/cc-pVTZ (o = 5, v = 53), 0.11 ms at the 67 TFLOP/s f64 tensor-core
// peak; the inputs are ~13 MB.
//
// What the simple design leaves on the table: the GEMMs run on the f64
// FMA pipes (half the tensor-core rate at best) from a 64x64x16
// shared-memory tile with no double buffering, and two of the three
// groups write their tile with a stride of v or v^2 (uncoalesced); the
// cubes go through device memory (written three times, read nine) where
// the TPU kernel keeps them in VMEM; the 64-row tile pads v = 53 to 64.

#include "triples_spatial_common.cuh"

namespace {

using spatial::kSums;
using spatial::kThreads;

constexpr int TM = 64;  // rows (the group's axis) of a tile
constexpr int TN = 64;  // flattened (p, q) columns of a tile
constexpr int TK = 16;  // K-depth of a shared-memory stage
constexpr int kMaxTerms = 4;

// One term: A[x][K] at A + pair_off + x * a_x + K * a_k, with
// pair_off = (idx[pa] * o + idx[pb]) * a_pair; B[K][p, q] at
// B + idx[r] * b_r + K * b_k + p * b_p + q * b_q, where (p, q) are the two
// cube axes other than the group's, in ascending order.
struct Term {
  const double* A;
  const double* B;
  long long a_pair, a_x, a_k;
  long long b_r, b_k, b_p, b_q;
  double sign;
  int K, pa, pb, r;
};

struct Group {
  Term t[kMaxTerms];
  int nterms;
  int axis;  // 0: rows are a; 1: b; 2: c
};

__global__ void __launch_bounds__(kThreads)
group_gemm_kernel(Group g, const int* __restrict__ ii, const int* __restrict__ jj,
                  const int* __restrict__ kk, int o, int v, int accumulate,
                  double* __restrict__ cube) {
  const long long NN = (long long)v * v;
  const int p = blockIdx.z;
  const int idx[3] = {ii[p], jj[p], kk[p]};
  const int r0 = blockIdx.y * TM;
  const long long n0 = (long long)blockIdx.x * TN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  __shared__ double As[TK][TM + 1];
  __shared__ double Bs[TK][TN];
  double acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0;

  for (int t = 0; t < g.nterms; ++t) {
    const Term& T = g.t[t];
    const double* Ap = T.A + (long long)(idx[T.pa] * o + idx[T.pb]) * T.a_pair;
    const double* Bp = T.B + (long long)idx[T.r] * T.b_r;
    for (int k0 = 0; k0 < T.K; k0 += TK) {
#pragma unroll
      for (int l = 0; l < TM * TK / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int mq = e / TK, kq = e % TK;
        const int row = r0 + mq, kg = k0 + kq;
        As[kq][mq] = (row < v && kg < T.K) ? T.sign * Ap[row * T.a_x + kg * T.a_k] : 0.0;
      }
#pragma unroll
      for (int l = 0; l < TN * TK / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int kq = e / TN, nq = e % TN;
        const long long n = n0 + nq;
        const int kg = k0 + kq;
        double val = 0.0;
        if (n < NN && kg < T.K) {
          const int pp = (int)(n / v), qq = (int)(n - (long long)pp * v);
          val = Bp[kg * T.b_k + pp * T.b_p + qq * T.b_q];
        }
        Bs[kq][nq] = val;
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

  const long long v2 = NN;
  double* out = cube + (long long)p * v2 * v;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= v) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long n = n0 + tx + 16 * c;
      if (n >= NN) continue;
      const int pp = (int)(n / v), qq = (int)(n - (long long)pp * v);
      long long off;
      if (g.axis == 0) {
        off = row * v2 + n;  // (a, b, c) = (row, p, q)
      } else if (g.axis == 1) {
        off = pp * v2 + (long long)row * v + qq;  // (p, row, q)
      } else {
        off = n * v + row;  // (p, q, row)
      }
      out[off] = accumulate ? out[off] + acc[r][c] : acc[r][c];
    }
  }
}

// The six sums of each triple of the chunk from its x (and m) cubes, with
// zn and y rebuilt from t1, W = v_oovv and t2 pair blocks.
__global__ void __launch_bounds__(kThreads)
fused_reduce_kernel(const double* __restrict__ x, const double* __restrict__ m,
                    const double* __restrict__ t1, const double* __restrict__ t2,
                    const double* __restrict__ W, const double* __restrict__ ev,
                    const double* __restrict__ eo, const int* __restrict__ ii,
                    const int* __restrict__ jj, const int* __restrict__ kk, int o, int v,
                    int has_z, int has_y, double* __restrict__ ujk_scratch,
                    double* __restrict__ partials) {
  const int p = blockIdx.y;
  const int i = ii[p], j = jj[p], k = kk[p];
  const long long v2 = (long long)v * v;
  const long long v3 = v2 * v;
  const double* xp = x + p * v3;
  const double* mp = m ? m + p * v3 : nullptr;
  const double *ti = t1 + (long long)i * v, *tj = t1 + (long long)j * v,
               *tk = t1 + (long long)k * v;
  const spatial::Rank3 zn{ti, tj, tk, W + (long long)(j * o + k) * v2,
                          W + (long long)(i * o + k) * v2, W + (long long)(i * o + j) * v2, v};
  // y's first matrix, outer(t1[j], t1[k]) + t2[j,k], prepared per triple
  const spatial::Rank3 y{ti, tj, tk, ujk_scratch + (long long)p * v2,
                         t2 + (long long)(i * o + k) * v2, t2 + (long long)(i * o + j) * v2, v};
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
    spatial::add_m_terms(acc, xp[e], has_y ? y.at(a, b, c) : 0.0, mp ? mp[e] : 0.0,
                         spatial::m_op(xp, pm), has_z ? zn.m_op(a, b, c) : 0.0, d,
                         has_z != 0, has_y != 0, mp != nullptr);
  }
  spatial::block_reduce6(acc, partials + ((long long)p * gridDim.x + blockIdx.x) * kSums);
}

__global__ void __launch_bounds__(kThreads)
ujk_kernel(const double* __restrict__ t1, const double* __restrict__ t2,
           const int* __restrict__ jj, const int* __restrict__ kk, int o, int v,
           double* __restrict__ ujk) {
  const int p = blockIdx.y;
  const int j = jj[p], k = kk[p];
  const long long v2 = (long long)v * v;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < v2;
       e += (long long)gridDim.x * kThreads) {
    const int b = (int)(e / v), c = (int)(e - (long long)b * v);
    ujk[p * v2 + e] = t1[j * v + b] * t1[k * v + c] + t2[(long long)(j * o + k) * v2 + e];
  }
}

}  // namespace

// The numerator cube of one chunk of C triples: three group GEMMs into
// cube (C, v, v, v), the first writing, the others adding.
// groups: three Group descriptors in host memory (ctypes mirrors the
// struct in ops/triples_spatial_cuda.py).
extern "C" int triples_fused_spatial_cube_launch(const void* groups, const void* ii,
                                                 const void* jj, const void* kk, int C,
                                                 int o, int v, void* cube, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Group* g = static_cast<const Group*>(groups);
  const long long NN = (long long)v * v;
  dim3 grid((unsigned)((NN + TN - 1) / TN), (unsigned)((v + TM - 1) / TM), (unsigned)C);
  for (int q = 0; q < 3; ++q) {
    group_gemm_kernel<<<grid, kThreads, 0, s>>>(
        g[q], static_cast<const int*>(ii), static_cast<const int*>(jj),
        static_cast<const int*>(kk), o, v, q > 0, static_cast<double*>(cube));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The six sums of each of the chunk's C triples into partials
// (C * nb * 6, row p * nb + block); ujk is (C, v, v) scratch.
extern "C" int triples_fused_spatial_reduce_launch(const void* x, const void* m,
                                                   const void* t1, const void* t2,
                                                   const void* W, const void* ev,
                                                   const void* eo, const void* ii,
                                                   const void* jj, const void* kk, int C,
                                                   int o, int v, int has_z, int has_y, int nb,
                                                   void* ujk, void* partials, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long v2 = (long long)v * v;
  dim3 ugrid((unsigned)((v2 + kThreads - 1) / kThreads), (unsigned)C);
  ujk_kernel<<<ugrid, kThreads, 0, s>>>(
      static_cast<const double*>(t1), static_cast<const double*>(t2),
      static_cast<const int*>(jj), static_cast<const int*>(kk), o, v,
      static_cast<double*>(ujk));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nb, (unsigned)C);
  fused_reduce_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(t1), static_cast<const double*>(t2),
      static_cast<const double*>(W), static_cast<const double*>(ev),
      static_cast<const double*>(eo), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<const int*>(kk), o, v, has_z, has_y,
      static_cast<double*>(ujk), static_cast<double*>(partials));
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
