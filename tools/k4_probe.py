#!/usr/bin/env python3
"""Where the time of K4 (`triples_tiled_spatial`) goes on one NVIDIA H100.
Needs a CUDA device and nvcc; imports no jax.

    python3 tools/k4_probe.py split --src-dir DIR [--shape 5,53 --shape 10,106 ...]

Times the first design of K4 (to commit 81c0b2f), whose stage 1 is
batched torch matmuls (the port's `_chunk_cubes`) and whose stage 2 is DIR's
`triples_tiled_spatial.cu`, split into three parts by CUDA events summed
over the chunks of one call:

  gemm_ms      stage 1's 24 `torch.bmm` numerator products a chunk;
  assembly_ms  the rest of stage 1: the operand gathers, each term's
               permuted copy added into its cube, and the z3 / y rank-3
               cubes;
  stage2_ms    DIR's stage-2 launch over the chunk's four cubes.

DIR holds that design's `triples_tiled_spatial.cu` and
`triples_spatial_common.cuh` (`git show 81c0b2f:afesp_tpu_torch/csrc/...`);
it is built here with the package's nvcc flags and its `-Xptxas -v`
report is printed, with that of DIR's `triples_finale.cu` (K2) when DIR
has one.  With `--current`, the package's own K4 is timed on the same
inputs through its wrapper's `split=` (the three stage-1 group GEMMs,
stage 2, the operand layout and the wrapper's other work).  The inputs are `chip_smoke.random_spatial_problem`'s
at each (o, v), all variants on (T, R, CR), the sorted triples of
`_sorted_plan`.  Prints one line per result and `nvidia-smi`'s name and
power limit.
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


def _compile(src: Path, out: Path) -> tuple[bool, str]:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    return p.returncode == 0, (p.stdout + p.stderr).strip()


def _stage1_timed(torch, S, ops, ii, jj, kk, marks):
    """`_chunk_cubes` with all variants on, with a CUDA event pair around
    each bmm appended to `marks`; the same arithmetic, term for term."""
    idx = (ii, jj, kk)
    t2 = ops["t2"]
    B = ii.shape[0]
    o, v = t2.shape[0], t2.shape[2]

    def bmm(lhs, rhs):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = torch.bmm(lhs, rhs)
        e1.record()
        marks.append((e0, e1))
        return out

    def side(terms, lhs_of, rhs_of, K):
        acc = None
        for (pa, pb), r, perm in terms:
            raw = bmm(lhs_of(pa, pb), rhs_of(r).reshape(B, K, v * v)).reshape(B, v, v, v)
            raw = raw.permute(0, *(q + 1 for q in perm))
            acc = raw if acc is None else acc + raw
        return acc

    def f_side(tab):
        return side(S._SPATIAL_F_TERMS, lambda pa, pb: t2[idx[pa], idx[pb]],
                    lambda r: tab[idx[r]], v)

    def m_side(tab, terms):
        return side(terms, lambda pa, pb: tab[idx[pa], idx[pb]],
                    lambda r: ops["t2M2"][idx[r]], o)

    out = {"x": (f_side(ops["VvF"]) - m_side(ops["VoL"], S._SPATIAL_M_TERMS)).contiguous(),
           "m": (f_side(ops["IvF"]) - m_side(ops["JoT"], S._SPATIAL_M3M_TERMS)).contiguous()}
    t1i, t1j, t1k = (ops["t1"][x] for x in idx)

    def rank3(X1, X2, X3):
        return (t1i[:, :, None, None] * X1[:, None, :, :]
                + t1j[:, None, :, None] * X2[:, :, None, :]
                + t1k[:, None, None, :] * X3[:, :, :, None]).contiguous()

    pairs = lambda tab: [tab[idx[p], idx[q]] for p, q in S._WVV_PAIRS]
    out["z"] = rank3(*pairs(ops["W"]))
    ujk, uik, uij = pairs(t2)
    out["y"] = rank3(t1j[:, :, None] * t1k[:, None, :] + ujk, uik, uij)
    return out


def split_parent(torch, lib, args, plan, reps: int) -> tuple[list[float], list[float]]:
    """The first design over all chunks: mean [gemm, assembly, stage 2] ms
    of `reps` calls after a warm-up, and its six weighted sums."""
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    vp = ctypes.c_void_p
    t1, t2, vvov, oovo, oovv, e_o, e_v, Iv, Jo = args
    (si, sj, sk), w = plan
    n, (o, v) = si.numel(), t1.shape
    ops = S.spatial_operands(t1, t2, vvov, oovo, oovv, Iv, Jo)
    ii, jj, kk = (x.long() for x in (si, sj, sk))
    eo = (e_o[ii] + e_o[jj] + e_o[kk]).contiguous()
    # that design's stage-2 grid: 8 elements a thread, at most 64 blocks a triple
    clen, nb = S.tiled_chunk_len(n, v), max(1, min(64, -(-(v**3) // (8 * 256))))
    partials = torch.empty(n * nb * 6, dtype=torch.float64, device=t1.device)
    stream = vp(torch.cuda.current_stream().cuda_stream)
    tot = [0.0, 0.0, 0.0]
    for r in range(-1, reps):
        marks, s1, s2 = [], [], []
        for c0 in range(0, n, clen):
            sl = slice(c0, c0 + clen)
            B = min(clen, n - c0)
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            e[0].record()
            cubes = _stage1_timed(torch, S, ops, ii[sl], jj[sl], kk[sl], marks)
            e[1].record()
            rc = lib.triples_tiled_spatial_chunk_launch(
                *(vp(cubes[k].data_ptr()) for k in ("x", "m", "z", "y")),
                vp(eo[c0:].data_ptr()), vp(e_v.data_ptr()), B, v, nb,
                vp(partials[c0 * nb * 6:].data_ptr()), stream)
            if rc:
                raise RuntimeError(f"stage 2: CUDA error {rc}")
            e[2].record()
            s1.append((e[0], e[1]))
            s2.append((e[1], e[2]))
            del cubes
        torch.cuda.synchronize()
        if r >= 0:
            gemm = sum(a.elapsed_time(b) for a, b in marks)
            st1 = sum(a.elapsed_time(b) for a, b in s1)
            st2 = sum(a.elapsed_time(b) for a, b in s2)
            for q, t in enumerate((gemm, st1 - gemm, st2)):
                tot[q] += t / reps
    sums = (partials.view(n, nb, 6).sum(dim=1) * w[:, None]).sum(dim=0)
    return tot, sums.tolist()


def split(torch, work: Path, src_dir: Path, shapes, current: bool) -> None:
    from chip_smoke import random_spatial_problem

    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    for name in ("triples_finale", "triples_tiled_spatial"):
        if not (src_dir / f"{name}.cu").exists():
            continue
        ok, log = _compile(src_dir / f"{name}.cu", work / f"lib{name}.so")
        for line in log.splitlines():
            print(f"  nvcc[{name}] {line}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} from {src_dir} did not build")
    lib = ctypes.CDLL(str(work / "libtriples_tiled_spatial.so"))
    lib.triples_tiled_spatial_chunk_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    dev = torch.device("cuda", 0)
    flags = dict(doing_T=True, doing_R=True, doing_CR=True)
    for o, v in shapes:
        args = random_spatial_problem(torch, dev, o, v)
        plan = TS._sorted_plan(o, dev)
        n = plan[0][0].numel()
        reps = 5 if v <= 53 else 2 if v <= 106 else 1
        ms, sums = split_parent(torch, lib, args, plan, reps)
        print(f"split parent o={o} v={v}: triples={n} chunk={S.tiled_chunk_len(n, v)} "
              f"gemm_ms={ms[0]:.4f} assembly_ms={ms[1]:.4f} stage2_ms={ms[2]:.4f} "
              f"total_ms={sum(ms):.4f} sums={sums}", flush=True)
        if current:
            got = S.triples_tiled_spatial(*args, *plan[0], plan[1], **flags)
            tot = [0.0] * 5
            for _ in range(reps):
                parts = []
                S.triples_tiled_spatial(*args, *plan[0], plan[1], **flags, split=parts)
                tot = [t + p / reps for t, p in zip(tot, parts)]
            print(f"split current o={o} v={v}: group_ms={tot[:3]} "
                  f"stage1_ms={sum(tot[:3]):.4f} stage2_ms={tot[3]:.4f} "
                  f"operand_ms={tot[4]:.4f} total_ms={sum(tot):.4f} "
                  f"sums={got.tolist()}", flush=True)
        del args


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("split")
    sp.add_argument("--src-dir", type=Path, required=True)
    sp.add_argument("--shape", action="append", default=None,
                    help="o,v (repeatable; default 5,53, 10,106 and 15,159)")
    sp.add_argument("--current", action="store_true",
                    help="also time the package's own K4 through its wrapper")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    shapes = [tuple(int(x) for x in s.split(",")) for s in
              (args.shape or ["5,53", "10,106", "15,159"])]
    with tempfile.TemporaryDirectory(prefix="k4_probe_") as tmp:
        split(torch, Path(tmp), args.src_dir.resolve(), shapes, args.current)
    return 0


if __name__ == "__main__":
    sys.exit(main())
