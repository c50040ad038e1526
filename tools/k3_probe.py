#!/usr/bin/env python3
"""Where the time of K3 (`triples_fused_spatial`) and K5
(`triples_finale_spatial`) goes on one NVIDIA H100.  Needs a CUDA device
and nvcc; imports no jax.

    python3 tools/k3_probe.py split --src-dir DIR [--shape 5,53 --shape 10,106]
                              [--current]

DIR holds the first design of K3 and K5 (to commit 4b39d7d):
`triples_fused_spatial.cu`, `triples_finale_spatial.cu` and
`triples_spatial_common.cuh` (`git show 4b39d7d:afesp_tpu_torch/csrc/...`).
Each source is built here with the package's nvcc flags inside a small
shim that launches its kernels one at a time (the shim includes the
source, so the kernels are the source's own), and its `-Xptxas -v`
report is printed.  On `chip_smoke.random_spatial_problem`'s inputs at
each (o, v), all variants on (T, R, CR), the sorted triples of
`_sorted_plan`, it times by CUDA events, summed over the chunks of one
call and averaged over a few calls after a warm-up:

  K3  host_ms     that design's wrapper work before its launches:
                  `spatial_operands`, the ctypes group descriptors and
                  the e_i + e_j + e_k build (CUDA events around it, and
                  the host clock as host_wall_ms);
      group_ms    its three `group_gemm_kernel` launches (group 0 writes
                  the cube, groups 1 and 2 add into it), x and m cubes;
      ujk_ms      `ujk_kernel`;
      reduce_ms   `fused_reduce_kernel`;
  K5  kernel_ms   `finale_spatial_kernel` over one i-slab's panels, as
                  the "pallas" tier builds them, queued behind a
                  device-side wait so the host's pace does not count;
      sum_ms      the weighted sum of its partials.

With `--current`, the package's own K3 and K5 run on the same inputs:
K3 through its wrapper's `split=` (the three group launches, the
reduction, the operand and host work), and K5 by CUDA events around its
wrapper; both also at each variant subset of FLAG_SUBSETS.  Prints one
line per result and `nvidia-smi`'s name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from afesp_tpu_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

VP = ctypes.c_void_p
# the first design's chunk budget and reduction grid
PARENT_SCRATCH_BYTES = 2e9
# the variant subsets timed with --current; TRCR is every variant on
FLAG_SUBSETS = {"T": dict(doing_T=True, doing_R=False, doing_CR=False),
                "TR": dict(doing_T=True, doing_R=True, doing_CR=False),
                "TRCR": dict(doing_T=True, doing_R=True, doing_CR=True)}
REDUCE_SPAN, MAX_REDUCE_BLOCKS = 8 * 256, 64
# a device-side wait (~25 ms) before K5's timed launches, so that they are
# timed at the device's pace, not the host's
QUEUE_CYCLES = 50_000_000

K3_SHIM = r"""
#include "triples_fused_spatial.cu"
extern "C" int probe_k3_group(const void* groups, int q, const void* ii, const void* jj,
                              const void* kk, int C, int o, int v, void* cube, void* stream) {
  const Group* g = static_cast<const Group*>(groups);
  const long long NN = (long long)v * v;
  dim3 grid((unsigned)((NN + TN - 1) / TN), (unsigned)((v + TM - 1) / TM), (unsigned)C);
  group_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g[q], static_cast<const int*>(ii), static_cast<const int*>(jj),
      static_cast<const int*>(kk), o, v, q > 0, static_cast<double*>(cube));
  return (int)cudaGetLastError();
}
extern "C" int probe_k3_ujk(const void* t1, const void* t2, const void* jj, const void* kk,
                            int C, int o, int v, void* ujk, void* stream) {
  const long long v2 = (long long)v * v;
  dim3 grid((unsigned)((v2 + kThreads - 1) / kThreads), (unsigned)C);
  ujk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t1), static_cast<const double*>(t2),
      static_cast<const int*>(jj), static_cast<const int*>(kk), o, v,
      static_cast<double*>(ujk));
  return (int)cudaGetLastError();
}
extern "C" int probe_k3_reduce(const void* x, const void* m, const void* t1, const void* t2,
                               const void* W, const void* ev, const void* eo, const void* ii,
                               const void* jj, const void* kk, int C, int o, int v, int nb,
                               void* ujk, void* partials, void* stream) {
  dim3 grid((unsigned)nb, (unsigned)C);
  fused_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(t1), static_cast<const double*>(t2),
      static_cast<const double*>(W), static_cast<const double*>(ev),
      static_cast<const double*>(eo), static_cast<const int*>(ii),
      static_cast<const int*>(jj), static_cast<const int*>(kk), o, v, 1, 1,
      static_cast<double*>(ujk), static_cast<double*>(partials));
  return (int)cudaGetLastError();
}
"""

K5_SHIM = r"""
#include "triples_finale_spatial.cu"
extern "C" int probe_k5_kernel(const void* x, const void* m, const void* mats,
                               const void* vecs, const void* eo, const void* t1i,
                               const void* ev, int P, int v, int nb, void* partials,
                               void* stream) {
  dim3 grid((unsigned)nb, (unsigned)P);
  finale_spatial_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const double*>(m),
      static_cast<const double*>(mats), static_cast<const double*>(vecs),
      static_cast<const double*>(eo), static_cast<const double*>(t1i),
      static_cast<const double*>(ev), v, 1, 1, 1, static_cast<double*>(partials));
  return (int)cudaGetLastError();
}
extern "C" int probe_k5_sum(const void* partials, long long n, void* out, void* stream) {
  return spatial::launch_weighted_sum6(static_cast<const double*>(partials), n, nullptr, 1,
                                       1.0 / 3.0, static_cast<double*>(out),
                                       static_cast<cudaStream_t>(stream));
}
"""


class _Term(ctypes.Structure):  # the first design's term descriptor
    _fields_ = [
        ("A", VP), ("B", VP),
        ("a_pair", ctypes.c_longlong), ("a_x", ctypes.c_longlong), ("a_k", ctypes.c_longlong),
        ("b_r", ctypes.c_longlong), ("b_k", ctypes.c_longlong),
        ("b_p", ctypes.c_longlong), ("b_q", ctypes.c_longlong),
        ("sign", ctypes.c_double),
        ("K", ctypes.c_int), ("pa", ctypes.c_int), ("pb", ctypes.c_int), ("r", ctypes.c_int),
    ]


class _Group(ctypes.Structure):
    _fields_ = [("t", _Term * 4), ("nterms", ctypes.c_int), ("axis", ctypes.c_int)]


def _ctypes_groups(groups, ops):
    arr = (_Group * 3)()
    for g, terms in enumerate(groups):
        arr[g].nterms = len(terms)
        arr[g].axis = g
        for q, d in enumerate(terms):
            t = arr[g].t[q]
            t.A, t.B = ops[d["A"]].data_ptr(), ops[d["B"]].data_ptr()
            for key in ("a_pair", "a_x", "a_k", "b_r", "b_k", "b_p", "b_q", "sign",
                        "K", "pa", "pb", "r"):
                setattr(t, key, d[key])
    return arr


def _build_shim(work: Path, src_dir: Path, name: str, text: str) -> ctypes.CDLL:
    shim = work / f"{name}_shim.cu"
    shim.write_text(text)
    out = work / f"lib{name}_shim.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(src_dir), "-o", str(out), str(shim)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    for line in (p.stdout + p.stderr).strip().splitlines():
        print(f"  nvcc[{name}] {line}", flush=True)
    if p.returncode != 0:
        raise RuntimeError(f"{name} from {src_dir} did not build")
    return ctypes.CDLL(str(out))


def _events(torch, n):
    return [torch.cuda.Event(enable_timing=True) for _ in range(n)]


def k3_parent(torch, lib, args, plan, reps: int):
    """The first design of K3 over all chunks: mean ms of its parts over
    `reps` calls after a warm-up, and its six weighted sums."""
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    t1, t2, vvov, oovo, oovv, e_o, e_v, Iv, Jo = args
    (si, sj, sk), w = plan
    n, (o, v) = si.numel(), t1.shape
    dev = t1.device
    ii, jj, kk = (x.contiguous() for x in (si, sj, sk))
    nb = max(1, min(MAX_REDUCE_BLOCKS, -(-(v**3) // REDUCE_SPAN)))
    cmax = max(1, min(65535, int(PARENT_SCRATCH_BYTES // (2 * 8 * v**3))))
    clen = -(-n // -(-n // cmax))
    cubes = {c: torch.empty((clen, v, v, v), dtype=torch.float64, device=dev) for c in "xm"}
    ujk = torch.empty((clen, v, v), dtype=torch.float64, device=dev)
    partials = torch.empty(n * nb * 6, dtype=torch.float64, device=dev)
    out = torch.empty(6, dtype=torch.float64, device=dev)
    stream = VP(torch.cuda.current_stream().cuda_stream)
    p = lambda t: VP(t.data_ptr())
    parts = dict(host_ms=0.0, host_wall_ms=0.0, group0_ms=0.0, group1_ms=0.0, group2_ms=0.0,
                 ujk_ms=0.0, reduce_ms=0.0)
    for r in range(-1, reps):
        torch.cuda.synchronize()
        h = _events(torch, 2)
        h[0].record()
        t0 = time.perf_counter()
        ops = S.spatial_operands(t1, t2, vvov, oovo, oovv, Iv, Jo)
        groups = {c: _ctypes_groups(S.fused_term_groups(o, v, c), ops) for c in "xm"}
        eo = (e_o[ii.long()] + e_o[jj.long()] + e_o[kk.long()]).contiguous()
        wall = time.perf_counter() - t0
        h[1].record()
        spans = []
        for c0 in range(0, n, clen):
            C = min(clen, n - c0)
            tri = (p(ii[c0:]), p(jj[c0:]), p(kk[c0:]))
            ev = _events(torch, 9)
            ev[0].record()
            for qc, c in enumerate("xm"):
                for q in range(3):
                    rc = lib.probe_k3_group(VP(ctypes.addressof(groups[c])), q, *tri, C, o, v,
                                            p(cubes[c]), stream)
                    if rc:
                        raise RuntimeError(f"group_gemm_kernel: CUDA error {rc}")
                    ev[1 + 3 * qc + q].record()
            rc = lib.probe_k3_ujk(p(ops["t1"]), p(ops["t2"]), tri[1], tri[2], C, o, v, p(ujk),
                                  stream)
            ev[7].record()
            rc = rc or lib.probe_k3_reduce(
                p(cubes["x"]), p(cubes["m"]), p(ops["t1"]), p(ops["t2"]), p(ops["W"]), p(e_v),
                p(eo[c0:]), *tri, C, o, v, nb, p(ujk), p(partials[c0 * nb * 6:]), stream)
            ev[8].record()
            if rc:
                raise RuntimeError(f"reduction: CUDA error {rc}")
            spans.append(ev)
        rc = lib.triples_spatial_weighted_sum_launch(p(partials), ctypes.c_longlong(n * nb),
                                                     p(w), nb, p(out), stream)
        if rc:
            raise RuntimeError(f"weighted sum: CUDA error {rc}")
        torch.cuda.synchronize()
        if r < 0:
            continue
        parts["host_ms"] += h[0].elapsed_time(h[1]) / reps
        parts["host_wall_ms"] += wall * 1e3 / reps
        for ev in spans:
            for q in range(3):  # each group over both cubes
                parts[f"group{q}_ms"] += (ev[q].elapsed_time(ev[q + 1])
                                          + ev[q + 3].elapsed_time(ev[q + 4])) / reps
            parts["ujk_ms"] += ev[6].elapsed_time(ev[7]) / reps
            parts["reduce_ms"] += ev[7].elapsed_time(ev[8]) / reps
    parts["clen"] = clen
    return parts, out.tolist()


def k5_parent(torch, lib, panels, reps: int):
    x, m, mats, vecs, eo, t1i, e_v = panels
    P, v = x.shape[0], x.shape[1]
    nb = max(1, min(MAX_REDUCE_BLOCKS, -(-(v**3) // REDUCE_SPAN)))
    partials = torch.empty(P * nb * 6, dtype=torch.float64, device=x.device)
    out = torch.empty(6, dtype=torch.float64, device=x.device)
    stream = VP(torch.cuda.current_stream().cuda_stream)
    p = lambda t: VP(t.data_ptr())
    tot = [0.0, 0.0]
    for r in range(-1, reps):
        ev = _events(torch, 3)
        torch.cuda._sleep(QUEUE_CYCLES)
        ev[0].record()
        rc = lib.probe_k5_kernel(p(x), p(m), p(mats), p(vecs), p(eo), p(t1i), p(e_v), P, v, nb,
                                 p(partials), stream)
        ev[1].record()
        rc = rc or lib.probe_k5_sum(p(partials), ctypes.c_longlong(P * nb), p(out), stream)
        ev[2].record()
        if rc:
            raise RuntimeError(f"K5: CUDA error {rc}")
        torch.cuda.synchronize()
        if r >= 0:
            tot = [tot[0] + ev[0].elapsed_time(ev[1]) / reps,
                   tot[1] + ev[1].elapsed_time(ev[2]) / reps]
    return tot, out.tolist()


def split(torch, work: Path, src_dir: Path, shapes, current: bool) -> None:
    from chip_smoke import random_spatial_problem

    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    k3 = _build_shim(work, src_dir, "triples_fused_spatial", K3_SHIM)
    k5 = _build_shim(work, src_dir, "triples_finale_spatial", K5_SHIM)
    for lib in (k3, k5):
        for fn in ("probe_k3_group", "probe_k3_ujk", "probe_k3_reduce",
                   "triples_spatial_weighted_sum_launch", "probe_k5_kernel", "probe_k5_sum"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    flags = dict(doing_T=True, doing_R=True, doing_CR=True)
    fk = dict(doing_T=True, doing_Y=True, doing_CR=True)
    for o, v in shapes:
        args = random_spatial_problem(torch, dev, o, v)
        plan = TS._sorted_plan(o, dev)
        n = plan[0][0].numel()
        reps = 5 if v <= 53 else 2
        parts, sums = k3_parent(torch, k3, args, plan, reps)
        kern = sum(parts[k] for k in ("group0_ms", "group1_ms", "group2_ms", "ujk_ms",
                                      "reduce_ms"))
        print(f"k3 parent o={o} v={v}: triples={n} " +
              " ".join(f"{k}={val:.4f}" if isinstance(val, float) else f"{k}={val}"
                       for k, val in parts.items()) +
              f" kernels_ms={kern:.4f} total_ms={kern + parts['host_ms']:.4f} sums={sums}",
              flush=True)
        panels = TS.finale_panels(0, 0, *args, jlen=TS.pick_spatial_jlen(o, v, "pallas"),
                                  doing_CR=True)
        (k5_ms, sum_ms), k5_sums = k5_parent(torch, k5, panels, reps)
        print(f"k5 parent o={o} v={v}: panels={panels[0].shape[0]} kernel_ms={k5_ms:.4f} "
              f"sum_ms={sum_ms:.4f} sums={k5_sums}", flush=True)
        if current:
            got = S.triples_fused_spatial(*args, *plan[0], plan[1], **flags)
            tot = [0.0] * 5
            for _ in range(reps):
                sp = []
                S.triples_fused_spatial(*args, *plan[0], plan[1], **flags, split=sp)
                tot = [a + b / reps for a, b in zip(tot, sp)]
            print(f"k3 current o={o} v={v}: group_ms={tot[:3]} "
                  f"numerator_ms={sum(tot[:3]):.4f} reduce_ms={tot[3]:.4f} "
                  f"operand_ms={tot[4]:.4f} total_ms={sum(tot):.4f} sums={got.tolist()}",
                  flush=True)
            for name, f in FLAG_SUBSETS.items():
                sub = TS.finale_panels(0, 0, *args, jlen=TS.pick_spatial_jlen(o, v, "pallas"),
                                       doing_CR=f["doing_CR"]) if f != flags else panels
                fn = lambda: S.triples_finale_spatial(
                    *sub, doing_T=f["doing_T"], doing_Y=f["doing_R"] or f["doing_CR"],
                    doing_CR=f["doing_CR"])
                got = fn()
                torch.cuda.synchronize()
                e = _events(torch, 2)
                torch.cuda._sleep(QUEUE_CYCLES)
                e[0].record()
                for _ in range(reps):
                    fn()
                e[1].record()
                torch.cuda.synchronize()
                sp = [0.0] * 5
                for _ in range(reps):
                    part = []
                    S.triples_fused_spatial(*args, *plan[0], plan[1], **f, split=part)
                    sp = [a + b / reps for a, b in zip(sp, part)]
                k5_ms = e[0].elapsed_time(e[1]) / reps
                print(f"k5 current o={o} v={v} flags={name}: ms={k5_ms:.4f} "
                      f"sums={got.tolist()}; k3 flags={name}: numerator_ms={sum(sp[:3]):.4f} "
                      f"reduce_ms={sp[3]:.4f} operand_ms={sp[4]:.4f}", flush=True)
        del args, panels


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("split")
    sp.add_argument("--src-dir", type=Path, required=True)
    sp.add_argument("--shape", action="append", default=None,
                    help="o,v (repeatable; default 5,53 and 10,106)")
    sp.add_argument("--current", action="store_true",
                    help="also time the package's own K3 and K5")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    shapes = [tuple(int(x) for x in s.split(",")) for s in (args.shape or ["5,53", "10,106"])]
    with tempfile.TemporaryDirectory(prefix="k3_probe_") as tmp:
        split(torch, Path(tmp), args.src_dir.resolve(), shapes, args.current)
    return 0


if __name__ == "__main__":
    sys.exit(main())
