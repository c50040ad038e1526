// K3: the fused restricted (spatial) triples tier, hand-written for
// Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_pallas.py:triples_fused_spatial (kernel
// body _fused_spatial_kernel): for each sorted triple the twelve t3_D
// numerator terms and, for CR, the twelve m3 terms (the term tables
// _SPATIAL_F_TERMS, _SPATIAL_M_TERMS, _SPATIAL_M3M_TERMS), then the six
// M-operator sums with zn and y from their (v,v)/(v,) factors, as the
// TPU kernel does; the orbit weights (1, 1/2, 1/6) are applied in f64 by
// the last, fixed-order pass.  The kernels and entry points are
// sorted_triples.cuh's, shared with K4 (triples_tiled_spatial.cu): the
// one thing the TPU's fused tier does that its tiled tier does not,
// keeping a chunk's cubes in VMEM from the numerator to the reduction,
// has no counterpart here, since chunks small enough for their cubes to
// stay in the H100's 50 MB L2 left the GEMM's grid too small and were
// slower (PERF.md §6).  The tier rule stays the JAX package's: K3 up to
// nvirt 128, K4 above.
//
// Bound on the H100: operations.  2 v^3 (2 v + 2 o) flops per cube per
// group, 3 groups, x2 for CR: 7.2e9 for the 35 sorted triples of
// H2O/cc-pVTZ (o = 5, v = 53), 0.11 ms at the 67 TFLOP/s f64 tensor-core
// peak; the inputs are ~13 MB.  What it leaves on the table (PERF.md §6):
// the group GEMM (spatial_gemm.cuh, its tile fitted to v: 128 x 112 at
// the dimer's v = 106, issuing 1.06 times the true shape's multiply-adds;
// 128 x 56 at v = 53, 1.10) runs near half the DMMA peak, and the
// reduction reads the three groups' cubes in rows of 64 bytes.

#include "sorted_triples.cuh"
