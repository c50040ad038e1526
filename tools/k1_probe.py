#!/usr/bin/env python3
"""Two measurements behind the design of K1 (`csrc/triples_fused.cu`) on
one NVIDIA H100.  Needs a CUDA device and nvcc; imports no jax.

    python3 tools/k1_probe.py dmma
    python3 tools/k1_probe.py split --src-dir DIR [--shape 10,106 --shape 20,212]

`dmma`: for each f64 `mma.sync` shape of sm_90 (m8n8k4, m16n8k4,
m16n8k8, m16n8k16), whether nvcc builds it for sm_90a, whether the
fragment layout the kernels assume gives A·B on random operands, and
its rate over all SMs (TFLOP/s, eight independent accumulators a warp,
operands in registers).

`split`: the device time of each of the two launches of one chunk of
the first K1 design (`numerator_kernel`, then the shared
`triples::finale_partials_kernel`), by CUDA events around each launch.
DIR holds that design's `triples_fused.cu` and `triples_common.cuh`
(`git show 0fa1073:afesp_tpu_torch/csrc/triples_fused.cu`); a harness
includes the source, so its kernels are reached as they are.  The inputs
are `chip_smoke.random_problem`'s at each (o, v); the chunk is the
first of near-equal chunks whose t3c and t3d fit FUSED_SCRATCH_BYTES,
as that design cut them.

Each prints one line per result and `nvidia-smi`'s name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from afesp_tpu_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

SHAPES = {"m8n8k4": (8, 8, 4), "m16n8k4": (16, 8, 4), "m16n8k8": (16, 8, 8),
          "m16n8k16": (16, 8, 16)}
NACC = 8

DMMA_SRC = r"""
#include <cuda_runtime.h>
constexpr int M = %(M)d, N = %(N)d, K = %(K)d;
constexpr int NA = M * K / 32, NB = K * N / 32, NC = M * N / 32, NACC = %(NACC)d;

__device__ __forceinline__ void mma(double (&d)[NC], const double (&a)[NA],
                                    const double (&b)[NB]) {
  asm volatile("mma.sync.aligned.%(name)s.row.col.f64.f64.f64.f64 %(operands)s;"
               : %(outs)s : %(ins)s);
}

// fragment element i of each operand, at lane (g = lane / 4, t = lane %% 4)
__device__ __forceinline__ int a_row(int i, int g) { return g + 8 * (i & 1); }
__device__ __forceinline__ int a_col(int i, int t) { return t + 4 * (i >> 1); }
__device__ __forceinline__ int b_row(int i, int t) { return t + 4 * i; }
__device__ __forceinline__ int c_row(int i, int g) { return g + 8 * (i >> 1); }
__device__ __forceinline__ int c_col(int i, int t) { return 2 * t + (i & 1); }

__global__ void layout_kernel(const double* A, const double* B, double* D) {
  const int g = threadIdx.x / 4, t = threadIdx.x %% 4;
  double a[NA], b[NB], d[NC];
  for (int i = 0; i < NA; ++i) a[i] = A[a_row(i, g) * K + a_col(i, t)];
  for (int i = 0; i < NB; ++i) b[i] = B[b_row(i, t) * N + g];
  for (int i = 0; i < NC; ++i) d[i] = 0.0;
  mma(d, a, b);
  for (int i = 0; i < NC; ++i) D[c_row(i, g) * N + c_col(i, t)] = d[i];
}

__global__ void rate_kernel(double* out, int iters) {
  double a[NA], b[NB], acc[NACC][NC];
  for (int i = 0; i < NA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < NB; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int q = 0; q < NACC; ++q)
    for (int i = 0; i < NC; ++i) acc[q][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < NACC; ++q) mma(acc[q], a, b);
  }
  double s = 0.0;
  for (int q = 0; q < NACC; ++q)
    for (int i = 0; i < NC; ++i) s += acc[q][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int dmma_layout(const void* A, const void* B, void* D) {
  layout_kernel<<<1, 32>>>((const double*)A, (const double*)B, (double*)D);
  return (int)cudaGetLastError();
}

extern "C" int dmma_rate(void* out, int blocks, int threads, int iters, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  rate_kernel<<<blocks, threads>>>((double*)out, 16);
  cudaEventRecord(e0);
  rate_kernel<<<blocks, threads>>>((double*)out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}
"""

SPLIT_SRC = r"""
#include "triples_fused.cu"

extern "C" int k1_split(const void* L, const void* R, const void* W, const void* t1,
                        const void* ii, const void* jj, const void* kk, int C, int o,
                        int v, const void* eo, const void* ev, void* t3c, void* t3d,
                        void* partials, int nblocks, int reps, float* ms) {
  cudaEvent_t e[3];
  for (auto& x : e) cudaEventCreate(&x);
  const long long NN = (long long)v * v;
  dim3 grid((unsigned)((NN + TN - 1) / TN), (unsigned)((v + TM - 1) / TM), (unsigned)C);
  ms[0] = ms[1] = 0.f;
  for (int r = -1; r < reps; ++r) {
    cudaEventRecord(e[0]);
    numerator_kernel<<<grid, kThreads>>>(
        (const double*)L, (const double*)R, (const double*)W, (const double*)t1,
        (const int*)ii, (const int*)jj, (const int*)kk, o, v, (double*)t3c, (double*)t3d);
    cudaEventRecord(e[1]);
    triples::finale_partials_kernel<<<nblocks, triples::kReduceThreads>>>(
        (const double*)t3c, (const double*)t3d, (const double*)eo, (const double*)ev, C, v,
        (double*)partials);
    cudaEventRecord(e[2]);
    cudaEventSynchronize(e[2]);
    float a, b;
    cudaEventElapsedTime(&a, e[0], e[1]);
    cudaEventElapsedTime(&b, e[1], e[2]);
    if (r >= 0) {
      ms[0] += a / reps;
      ms[1] += b / reps;
    }
  }
  for (auto& x : e) cudaEventDestroy(x);
  return (int)cudaGetLastError();
}
"""


def _compile(src: str, out: Path, include: Path | None = None) -> tuple[bool, str]:
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(cu)]
    if include is not None:
        cmd[1:1] = ["-I", str(include)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    return p.returncode == 0, (p.stdout + p.stderr).strip()


def _dmma_src(name: str) -> str:
    M, N, K = SHAPES[name]
    na, nb, nc = M * K // 32, K * N // 32, M * N // 32
    d = ",".join(f"%{i}" for i in range(nc))
    a = ",".join(f"%{nc + i}" for i in range(na))
    b = ",".join(f"%{nc + na + i}" for i in range(nb))
    return DMMA_SRC % dict(
        M=M, N=N, K=K, NACC=NACC, name=name,
        operands=f"{{{d}}}, {{{a}}}, {{{b}}}, {{{d}}}",
        outs=", ".join(f'"+d"(d[{i}])' for i in range(nc)),
        ins=", ".join([f'"d"(a[{i}])' for i in range(na)] + [f'"d"(b[{i}])' for i in range(nb)]),
    )


def dmma(torch, work: Path) -> None:
    vp = ctypes.c_void_p
    dev = torch.device("cuda", 0)
    for name, (M, N, K) in SHAPES.items():
        ok, log = _compile(_dmma_src(name), work / f"lib_{name}.so")
        for line in log.splitlines():
            print(f"  nvcc[{name}] {line}")
        if not ok:
            print(f"dmma {name}: build failed")
            continue
        lib = ctypes.CDLL(str(work / f"lib_{name}.so"))
        lib.dmma_layout.argtypes = [vp, vp, vp]
        lib.dmma_rate.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_float)]
        g = torch.Generator().manual_seed(3)
        A = torch.randn(M, K, generator=g, dtype=torch.float64).to(dev)
        B = torch.randn(K, N, generator=g, dtype=torch.float64).to(dev)
        D = torch.zeros(M, N, dtype=torch.float64, device=dev)
        rc = lib.dmma_layout(vp(A.data_ptr()), vp(B.data_ptr()), vp(D.data_ptr()))
        torch.cuda.synchronize()
        err = float((D - A @ B).abs().max())
        blocks, threads, iters = 132 * 4, 256, 4096
        out = torch.empty(blocks * threads, dtype=torch.float64, device=dev)
        ms = ctypes.c_float()
        rc2 = lib.dmma_rate(vp(out.data_ptr()), blocks, threads, iters, ctypes.byref(ms))
        flops = 2.0 * M * N * K * NACC * iters * blocks * threads / 32
        print(f"dmma {name}: rc={rc},{rc2} layout_max_abs_err={err:.3e} "
              f"ms={ms.value:.4f} tflops={flops / ms.value / 1e9:.2f}", flush=True)


def split(torch, work: Path, src_dir: Path, shapes: list[tuple[int, int]]) -> None:
    from chip_smoke import random_problem

    from afesp_tpu_torch.methods import triples_spinorb as T
    from afesp_tpu_torch.ops import triples_cuda as Kc

    ok, log = _compile(SPLIT_SRC, work / "libk1split.so", include=src_dir)
    for line in log.splitlines():
        print(f"  nvcc[k1_split] {line}")
    if not ok:
        raise RuntimeError("the split harness did not build")
    lib = ctypes.CDLL(str(work / "libk1split.so"))
    vp = ctypes.c_void_p
    lib.k1_split.argtypes = ([vp] * 7 + [ctypes.c_int] * 3 + [vp] * 5
                             + [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)])
    dev = torch.device("cuda", 0)
    nblocks = 132 * 8
    for o, v in shapes:
        t1, t2, vovv, ovoo, oovv, e_o, e_v = random_problem(torch, dev, o, v)
        ii, jj, kk = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                      for x in T.strict_triple_list(o))
        n = ii.numel()
        L, R = Kc.fused_operands(t2, vovv, ovoo)
        # that design's chunk: t3c and t3d under FUSED_SCRATCH_BYTES
        cmax = max(1, int(Kc.FUSED_SCRATCH_BYTES // (2 * 8 * v**3)))
        clen = -(-n // -(-n // cmax))
        eo = (e_o[ii.long()] + e_o[jj.long()] + e_o[kk.long()]).contiguous()
        t3c = torch.empty((clen, v, v, v), dtype=torch.float64, device=dev)
        t3d = torch.empty_like(t3c)
        partials = torch.empty(nblocks, dtype=torch.float64, device=dev)
        ms = (ctypes.c_float * 2)()
        reps = 5 if v <= 128 else 2
        rc = lib.k1_split(*(vp(x.data_ptr()) for x in (L, R, oovv, t1, ii, jj, kk)),
                          clen, o, v, vp(eo.data_ptr()), vp(e_v.data_ptr()),
                          vp(t3c.data_ptr()), vp(t3d.data_ptr()), vp(partials.data_ptr()),
                          nblocks, reps, ms)
        torch.cuda.synchronize()
        nchunk = -(-n // clen)
        print(f"split o={o} v={v}: rc={rc} triples={n} chunk={clen} chunks={nchunk} "
              f"numerator_ms={ms[0]:.4f} finale_ms={ms[1]:.4f} "
              f"per_chunk_ms={ms[0] + ms[1]:.4f}", flush=True)
        del L, R, t3c, t3d


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dmma")
    sp = sub.add_parser("split")
    sp.add_argument("--src-dir", type=Path, required=True)
    sp.add_argument("--shape", action="append", default=None,
                    help="o,v (repeatable; default 10,106 and 20,212)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    with tempfile.TemporaryDirectory(prefix="k1_probe_") as tmp:
        if args.cmd == "dmma":
            dmma(torch, Path(tmp))
        else:
            shapes = [tuple(int(x) for x in s.split(",")) for s in
                      (args.shape or ["10,106", "20,212"])]
            split(torch, Path(tmp), args.src_dir.resolve(), shapes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
