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

    python3 tools/k4_probe.py gemm [--src-dir DIR] [--shape 25,265 ...]
        [--chunk C] [--variant NAME ...] [--reps N]
        [--sustain SECONDS --sustain-variant NAME ...]

Times the numerator group GEMM alone: one chunk of C sorted triples
(default `cube_chunk_len`'s) at each (o, v), its three group launches
over the x and m cubes, for each GEMM_VARIANTS entry of the package's
`csrc/spatial_gemm.cuh` and, from DIR's `spatial_gemm.cuh` and
`dmma_tile.cuh`, the earlier design (`git archive 500685d
afesp_tpu_torch/csrc`); each as ms and TFLOP/s on useful and on issued
multiply-adds, held against the earlier design's cubes and relaunched
bit for bit; then one f64 `torch.matmul` of a group's (NNp x K)(K x Np)
shape as a yardstick.  `--sustain` runs the earlier design and each
sustain variant that many seconds, sampling the SM clock and the power
draw with `nvidia-smi`.  The operands are seeded random tables laid out
by the package's layout kernel.
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

from afesp_tpu_torch.ops._build import CSRC as S_CSRC  # noqa: E402
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


# the group GEMMs `gemm` times: the package's tiles (TILE_CONFIGS, in
# order) and two other shapes of the same kernel that PERF.md §6
# compares, as Cfg<WARPS_M, MT, WARPS_N, N8, BK, STAGES> of
# csrc/spatial_gemm.cuh
GEMM_VARIANTS = {
    "128x136": "Cfg<4, 2, 2, 17, 16, 3>",
    "128x160": "Cfg<2, 4, 4, 20, 16, 4>",
    "128x112": "Cfg<4, 2, 2, 14, 16, 3>",
    "128x56": "Cfg<4, 2, 2, 7, 16, 3>",
    "128x136.mt4": "Cfg<2, 4, 4, 17, 16, 4>",
    "256x80.w16": "Cfg<8, 2, 2, 10, 16, 4>",
}

GEMM_NEW_SRC = r"""
#include "spatial_gemm.cuh"
using namespace sgemm;

extern "C" int probe_layout(const void* t2, const void* vvov, const void* oovo, const void* Iv,
                            const void* Jo, const void* dbase, const void* dcoef,
                            const void* ii, const void* jj, const void* kk, const void* bases,
                            int nleft, int nright, long long lsize, long long rsize, int ncube,
                            int n, int o, int v, int Np, int Kv, int Ko, long long NNp,
                            void* Lbuf, void* Rbuf, void* desc) {
  Layout lay;
  const long long* b = static_cast<const long long*>(bases);
  for (int q = 0; q < 3; ++q) lay.lbase[q] = b[q];
  for (int q = 0; q < 6; ++q) lay.rbase[q] = b[3 + q];
  return launch_layout((const double*)t2, (const double*)vvov, (const double*)oovo,
                       (const double*)Iv, (const double*)Jo, (const long long*)dbase,
                       (const long long*)dcoef, (const int*)ii, (const int*)jj, (const int*)kk,
                       lay, nleft, nright, lsize, rsize, ncube, n, o, v, Np, Kv, Ko, NNp,
                       (double*)Lbuf, (double*)Rbuf, (long long*)desc, 0);
}

extern "C" int probe_group(int variant, const void* L, const void* R, const void* desc,
                           long long desc_cube, int ncube, int C, int v, int Kv, int Ko, int Np,
                           long long NNp, long long cube_stride, int group, void* cube) {
  const double* l = (const double*)L;
  const double* r = (const double*)R;
  const long long* d = (const long long*)desc;
  switch (variant) {
%(cases)s
    default: return (int)cudaErrorInvalidValue;
  }
}
"""

GEMM_OLD_SRC = r"""
#include "spatial_gemm.cuh"

extern "C" int old_group(int tile, const void* L, const void* R, const void* desc,
                         long long desc_cube, int ncube, int C, int v, int Kv, int Ko, int Np,
                         long long NNp, long long cube_stride, int group, void* cube) {
  return sgemm::launch_group_tile(tile, (const double*)L, (const double*)R,
                                  (const long long*)desc, desc_cube, ncube, C, v,
                                  sgemm::KGeom{Kv, Ko}, Np, NNp, cube_stride, group,
                                  (double*)cube, 0);
}
"""

# the parent design's tiles (256 x 64, 256 x 80) and its rule: the fewest
# padded group-axis columns, the narrower on a tie
_OLD_TILES = (64, 80)


def _old_tile(v: int) -> int:
    Np = -(-v // 8) * 8
    return min(range(2), key=lambda t: (-(-Np // _OLD_TILES[t]) * _OLD_TILES[t], t))


def _gemm_lib(src: str, name: str, work: Path, include: Path):
    cu = work / f"{name}.cu"
    cu.write_text(src)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(work / f"lib{name}.so"), str(cu)]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    for line in (p.stdout + p.stderr).strip().splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Function" in line:
            print(f"  nvcc[{name}] {line}", flush=True)
    if p.returncode != 0:
        raise RuntimeError(f"{name} did not build:\n{(p.stdout + p.stderr)[-6000:]}")
    return ctypes.CDLL(str(work / f"lib{name}.so"))


def gemm(torch, work: Path, src_dir: Path | None, shapes, chunk: int | None,
         variants: list[str], reps: int, sustain: float = 0.0,
         sustain_variants: tuple = ()) -> None:
    """Time one chunk's three group GEMMs (x and m cubes) at each shape:
    the package's kernel in each variant, the parent design's from
    `src_dir`, and one f64 torch.matmul of a group's (NNp x K) (K x Np)
    shape as a yardstick; TFLOP/s on useful and on issued work."""
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    cases = "\n".join(
        f"    case {q}: return launch_group<{GEMM_VARIANTS[name]}>(l, r, d, desc_cube, ncube, C, "
        f"v, KGeom{{Kv, Ko}}, Np, NNp, cube_stride, group, (double*)cube, 0);"
        for q, name in enumerate(variants))
    new = _gemm_lib(GEMM_NEW_SRC % dict(cases=cases), "probe_new", work, S_CSRC)
    new.probe_group.argtypes = [ci, vp, vp, vp, ll, ci, ci, ci, ci, ci, ci, ll, ll, ci, vp]
    new.probe_layout.argtypes = [vp] * 11 + [ci, ci, ll, ll] + [ci] * 7 + [ll] + [vp] * 3
    old = None
    if src_dir is not None:
        old = _gemm_lib(GEMM_OLD_SRC, "probe_old", work, src_dir)
        old.old_group.argtypes = [ci, vp, vp, vp, ll, ci, ci, ci, ci, ci, ci, ll, ll, ci, vp]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(5)
    for o, v in shapes:
        r = lambda *sh: torch.randn(sh, generator=g, dtype=torch.float64, device=dev) * 0.02
        t2, vvov, oovo, Iv, Jo = r(o, o, v, v), r(v, v, o, v), r(o, o, v, o), r(v, o, v, v), \
            r(o, o, o, v)
        C = chunk or S.cube_chunk_len(o * (o + 1) * (o + 2) // 6, v, True)
        # C sorted triples spread over the occupied range: i = j, j = k and
        # distinct ones
        tri = [(0, 0, 1), (1, 2, 2), (0, 1, 2), (o // 3, o // 2, o - 1), (2, 2, o - 2),
               (o - 3, o - 1, o - 1)]
        tri = [tri[q % len(tri)] for q in range(C)]
        ii, jj, kk = (torch.tensor([t[q] for t in tri], dtype=torch.int32, device=dev)
                      for q in range(3))
        Np, Kv, Ko, NNp, tile = S.tiled_tile_dims(o, v)
        lefts, rights, _, _, lsize, rsize = S.tiled_layout(o, v, True)
        bases = (ctypes.c_longlong * 9)(*S.layout_bases(o, v, True))
        dbase, dcoef = S._term_tables(o, v, ("x", "m"), dev)
        Lbuf = torch.empty(lsize, dtype=torch.float64, device=dev)
        Rbuf = torch.empty(rsize, dtype=torch.float64, device=dev)
        desc = torch.empty((2, C, 3, 8), dtype=torch.int64, device=dev)
        rc = new.probe_layout(*(vp(x.data_ptr()) for x in (t2, vvov, oovo, Iv, Jo, dbase, dcoef,
                                                            ii, jj, kk)),
                              ctypes.cast(bases, vp), len(lefts), len(rights), lsize, rsize,
                              2, C, o, v, Np, Kv, Ko, NNp, vp(Lbuf.data_ptr()),
                              vp(Rbuf.data_ptr()), vp(desc.data_ptr()))
        assert rc == 0, rc
        del vvov, Iv
        cube_stride = C * v**3
        up = lambda x, b: -(-x // b) * b
        useful = 3 * 2 * C * 2 * S.useful_macs(o, v)
        K = 2 * Kv + 2 * Ko

        def run(fn, sel, out):
            for group in range(3):
                rc = fn(sel, vp(Lbuf.data_ptr()), vp(Rbuf.data_ptr()), vp(desc.data_ptr()),
                        C * 24, 2, C, v, Kv, Ko, Np, NNp, cube_stride, group,
                        vp(out[group].data_ptr()))
                assert rc == 0, rc

        def timed(fn, sel, out):
            run(fn, sel, out)
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            for _ in range(reps):
                run(fn, sel, out)
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / reps

        ref = torch.empty((3, 2, C, v, v, v), dtype=torch.float64, device=dev)
        out = torch.empty_like(ref)
        head = f"gemm o={o} v={v} C={C} K={K} Np={Np} NNp={NNp}"
        if old is not None:
            ot = _old_tile(v)
            ms = timed(old.old_group, ot, ref)
            BN = _OLD_TILES[ot]
            issued = 3 * 2 * C * 2 * up(NNp, 256) * up(Np, BN) * up(K, 32)
            print(f"{head} kernel=parent-256x{BN} ms={ms:.3f} "
                  f"useful_tflops={useful / ms / 1e9:.2f} "
                  f"issued_tflops={issued / ms / 1e9:.2f} issued/useful={issued / useful:.4f}",
                  flush=True)
        for q, name in enumerate(variants):
            ms = timed(new.probe_group, q, out)
            again = out.clone()
            run(new.probe_group, q, out)
            torch.cuda.synchronize()
            BM, BN = (int(x) for x in name.split(".")[0].split("x"))
            issued = 3 * 2 * C * 2 * up(NNp, BM) * up(Np, BN) * up(K, 16)
            err = (float((out - ref).abs().max() / ref.abs().max())
                   if old is not None else float("nan"))
            print(f"{head} kernel={name} ms={ms:.3f} useful_tflops={useful / ms / 1e9:.2f} "
                  f"issued_tflops={issued / ms / 1e9:.2f} issued/useful={issued / useful:.4f} "
                  f"rel_err_vs_parent={err:.3e} relaunch_equal={bool(torch.equal(out, again))} "
                  f"rule_tile={S.TILE_CONFIGS[tile]}", flush=True)
            del again
        if sustain > 0:
            runs = [("new:" + variants[q], new.probe_group, q) for q in range(len(variants))
                    if variants[q] in sustain_variants]
            if old is not None:
                runs.insert(0, ("parent", old.old_group, _old_tile(v)))
            for label, fn, sel in runs:
                smi = subprocess.Popen(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader,nounits", "-lms", "250"],
                    stdout=subprocess.PIPE, text=True)
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                e0.record()
                calls = 0
                while time.perf_counter() - t0 < sustain:
                    for _ in range(10):
                        run(fn, sel, out)
                    calls += 10
                    torch.cuda.synchronize()
                e1.record()
                torch.cuda.synchronize()
                smi.terminate()
                rows = [ln.split(",") for ln in smi.communicate()[0].strip().splitlines()]
                clk = sorted(float(r[0]) for r in rows if len(r) == 2)
                pw = sorted(float(r[1]) for r in rows if len(r) == 2)
                ms = e0.elapsed_time(e1) / calls
                print(f"{head} sustained={label} seconds={sustain} ms={ms:.3f} "
                      f"useful_tflops={useful / ms / 1e9:.2f} sm_clock_mhz_median="
                      f"{clk[len(clk) // 2] if clk else 'nan'} min={clk[0] if clk else 'nan'} "
                      f"power_w_median={pw[len(pw) // 2] if pw else 'nan'} samples={len(clk)}",
                      flush=True)
        del ref, out
        # the yardstick: one group's GEMM as one f64 torch.matmul
        A = Rbuf[: NNp * K].view(K, NNp).t()
        B = Lbuf[: Np * K].view(Np, K).t()
        A, B = A.contiguous(), B.contiguous()
        C_ = A @ B
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            torch.matmul(A, B, out=C_)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / reps
        flops = 2.0 * NNp * K * Np
        print(f"{head} yardstick=torch.matmul ({NNp}x{K})(x{Np}) ms={ms:.4f} "
              f"tflops={flops / ms / 1e9:.2f} chunk_equiv_ms={ms * 3 * 2 * C:.3f}", flush=True)
        del A, B, C_, Lbuf, Rbuf, t2, oovo, Jo
        torch.cuda.empty_cache()


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
    gp = sub.add_parser("gemm")
    gp.add_argument("--src-dir", type=Path, default=None,
                    help="the parent design's csrc (spatial_gemm.cuh, dmma_tile.cuh)")
    gp.add_argument("--shape", action="append", default=None,
                    help="o,v (repeatable; default 25,265 and 15,159)")
    gp.add_argument("--chunk", type=int, default=None,
                    help="triples a chunk (default: cube_chunk_len of the shape)")
    gp.add_argument("--variant", action="append", default=None,
                    help=f"GEMM_VARIANTS keys (default: all of {list(GEMM_VARIANTS)})")
    gp.add_argument("--reps", type=int, default=3)
    gp.add_argument("--sustain", type=float, default=0.0,
                    help="also run the parent's GEMM and each --sustain-variant's (default: the "
                         "first variant) this many seconds each, sampling the SM clock and "
                         "power with nvidia-smi")
    gp.add_argument("--sustain-variant", action="append", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    default = ["5,53", "10,106", "15,159"] if args.cmd == "split" else ["25,265", "15,159"]
    shapes = [tuple(int(x) for x in s.split(",")) for s in (args.shape or default)]
    with tempfile.TemporaryDirectory(prefix="k4_probe_") as tmp:
        if args.cmd == "split":
            split(torch, Path(tmp), args.src_dir.resolve(), shapes, args.current)
        else:
            gemm(torch, Path(tmp), args.src_dir.resolve() if args.src_dir else None, shapes,
                 args.chunk, args.variant or list(GEMM_VARIANTS), args.reps, args.sustain,
                 tuple(args.sustain_variant or [(args.variant or list(GEMM_VARIANTS))[0]]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
