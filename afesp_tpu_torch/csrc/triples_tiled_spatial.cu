// K4: the tiled restricted (spatial) triples tier, hand-written for
// Hopper (sm_90a).
//
// Replaces afesp_tpu/ops/triples_tiled.py:triples_tiled_spatial: stage 1
// (_chunk_cubes, batched XLA einsums there) and stage 2 (kernel body
// _tiled_kernel, dispatched by _pallas_partials).  Stage 1 is
// sorted_triples.cuh's layout launch and group GEMMs on the f64 tensor
// cores, stage 2 its orbit-tile reduction, then the weighted sum; K3
// (triples_fused_spatial.cu) runs the same kernels, which it reaches
// through the same entry points.  The TPU tiers differ in where a
// chunk's cubes live between the stages (VMEM or HBM); on the H100 both
// write them to device memory.  f64 throughout, f64 accumulation, no
// nvirt cap.
//
// Bound on the H100: operations, for the whole tier.  2 v^3 (2 v + 2 o)
// flops per group, three groups a cube, x and m: 1.14e13 flops for the
// 680 sorted triples of the 174-bf trimer (o = 15, v = 159), 171 ms at
// the 67 TFLOP/s f64 tensor-core peak, and 3.79e14 for the 2925 of the
// 290-bf pentamer (o = 25, v = 265), 5.65 s; each group's cubes cross
// device memory twice (written by the GEMM, read by the reduction).
//
// What it leaves on the table (times in PERF.md §6): stage 1, the
// persistent group GEMM of spatial_gemm.cuh, issues 1.03 times the true
// shape's multiply-adds at the pentamer's shape and 1.02 at the
// trimer's, but under sustained load the card runs at its power limit
// and the GEMM near 34 TFLOP/s of issued work, about half the DMMA peak;
// the reduction reads the three groups' cubes in rows of 64 bytes,
// rebuilds zn once a staged tile and reads y's planes through the caches
// at every element.

#include "sorted_triples.cuh"
