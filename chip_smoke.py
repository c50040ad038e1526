#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives `afesp_tpu_torch` — never the JAX package — through its two
paths on H2O/cc-pVTZ (58 basis functions): CCSD(T)_spinorb (10 occupied
and 106 virtual spin orbitals) and restricted CRCCSD(T)_spatial (5
occupied and 53 virtual spatial orbitals), in eight phases, one line
each with its wall time:

  1. the device: torch's name and count, and nvidia-smi's name and
     power limit;
  2. the build of every CUDA kernel with nvcc, all five sources in
     parallel, timed (the `-Xptxas -v` report is printed);
  3. each kernel against its plain PyTorch version on the card, on
     seeded random inputs: K1 and K2 at the spin-orbital path's shapes;
     K3, K4 and K5 at the spatial path's (o=5, v=53), the 116-bf dimer's
     (o=10, v=106) and, for K4, the 174-bf trimer's (o=15, v=159), with
     all variants on (T, R, CR).  Relative error <= 1e-11 of each sum
     (both sides f64, only the order of summation differs; a sum nearer
     0 than 1e-6 of the largest is held to that floor instead), and two
     launches agree bit for bit; kernel, plain and library times by CUDA
     events at the paths' shapes;
  4. the spin-orbital path, `run_calculation` on a staged copy of
     data/h2o-cc-pvtz-2.00_104.45 with the committed eri.dat, default
     "fused" triples tier (K1): HF, MP2, CCSD and CCSD(T) totals within
     1e-8 Ha of the JAX package's CPU run (expected_jax_cpu.json) and
     equal SCF and CC iteration counts;
  5. its "pallas" triples tier (K2) on the same converged amplitudes:
     E(T) within 1e-9 of the fused tier and of JAX's f64 E(T);
  6. the restricted path, `run_calculation` on the same inputs with the
     CRCCSD(T)_spatial els.in of expected_jax_cpu_crccsd_t_spatial.json,
     default "fused" triples tier (K3): every breakdown value within
     1e-8 of that file (the JAX package's CPU run) and equal SCF and CC
     iteration counts;
  7. its "tiled" (K4) and "pallas" (K5) triples tiers on the same
     converged amplitudes: the six triples energies, D[T] and D(T) within
     1e-9 of the fused tier and of JAX's f64 values;
  8. one JSON line of the kernels: launches on the path that runs each,
     times, bound and errors.

Every check raises on failure (nonzero exit, no `ok` line).  The last
line is {"ok": true, "device": {...}}.  The script writes nothing into
the checkout except the kernels' gitignored build directory; its work
directories are temporary ones, removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"
SPATIAL_EXPECTED = FIXTURE / "expected_jax_cpu_crccsd_t_spatial.json"
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the f64 tensor-core
# peak (the f64 work of every kernel could at best run there)
HBM_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 67e12
KERNEL_RTOL = 1e-11
KERNEL_FLOOR = 1e-6  # of the largest of a kernel's six sums
ENERGY_TOL = 1e-8
TRIPLES_TOL = 1e-9


@contextmanager
def phase(name: str, info: dict):
    t0 = time.perf_counter()
    yield
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s {extra}".rstrip(), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of fn() over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_problem(torch, dev, o: int, v: int, seed: int = 7):
    """Antisymmetry-respecting random (T) inputs, as in
    tests/test_triples_pallas.py, made with numpy from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t1 = rng.standard_normal((o, v)) * 0.02
    t2 = rng.standard_normal((o, o, v, v)) * 0.02
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    oovv = rng.standard_normal((o, o, v, v)) * 0.02
    oovv = oovv - oovv.transpose(1, 0, 2, 3)
    oovv = (oovv - oovv.transpose(0, 1, 3, 2)) / 2
    ovoo = rng.standard_normal((o, v, o, o)) * 0.02
    ovoo = ovoo - ovoo.transpose(0, 1, 3, 2)
    vovv = rng.standard_normal((v, o, v, v)) * 0.02
    vovv = vovv - vovv.transpose(0, 1, 3, 2)
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    return tuple(
        torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)
        for x in (t1, t2, vovv, ovoo, oovv, e[:o], e[o:])
    )


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F64_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_checks(torch, dev, o: int, v: int) -> dict:
    from afesp_tpu_torch.methods import triples_spinorb as T
    from afesp_tpu_torch.ops import triples_cuda as K

    args = random_problem(torch, dev, o, v)
    ii, jj, kk = (torch.as_tensor(x, dtype=torch.long, device=dev)
                  for x in T.strict_triple_list(o))
    n = ii.numel()
    rows = {}

    # K1 at the main path's shapes: all strict triples of o = 10, v = 106
    got = K.triples_fused(*args, ii, jj, kk)
    again = K.triples_fused(*args, ii, jj, kk)
    want = K.triples_fused_plain(*args, ii, jj, kk)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), "triples_fused: two launches differ")
    pi, pj, pk, clen = (torch.as_tensor(x, dtype=torch.long, device=dev)
                        if not isinstance(x, int) else x for x in T.strict_plan(o, v))
    library = lambda: 6.0 * T._triples_total_strict(
        *args, pi, pj, pk, clen=clen, precision="f64")
    in_bytes = sum(x.numel() * 8 for x in args) + 3 * n * 8
    rows["triples_fused"] = dict(
        got=got, want=want,
        ms=cuda_ms(torch, lambda: K.triples_fused(*args, ii, jj, kk)),
        plain_ms=cuda_ms(torch, lambda: K.triples_fused_plain(*args, ii, jj, kk)),
        library_ms=cuda_ms(torch, library),
        bound=bound_ms(n * v**3 * (6 * (v + o) + 5 + 11), in_bytes + 8),
        source="afesp_tpu_torch/csrc/triples_fused.cu",
        replaces="afesp_tpu/ops/triples_pallas.py:926 (triples_fused, body _fused_kernel :308)",
    )

    # K2 at the "pallas" tier's chunk shape: (clen, v, v, v) panels
    t3c, t3d = T._chunk_panels(pi[:clen], pj[:clen], pk[:clen], *args[:5])
    e_o, e_v = args[5], args[6]
    eo_sum = (e_o[pi[:clen]] + e_o[pj[:clen]] + e_o[pk[:clen]]).contiguous()
    fin = (t3c.contiguous(), t3d.contiguous(), eo_sum, e_v)
    got = K.triples_finale(*fin)
    again = K.triples_finale(*fin)
    want = K.triples_finale_plain(*fin)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), "triples_finale: two launches differ")
    plain_ms = cuda_ms(torch, lambda: K.triples_finale_plain(*fin))
    rows["triples_finale"] = dict(
        got=got, want=want,
        ms=cuda_ms(torch, lambda: K.triples_finale(*fin)),
        plain_ms=plain_ms,
        # the plain version is already one torch expression of the same
        # function over all panels, so the library call is that same call
        library_ms=plain_ms,
        bound=bound_ms(clen * v**3 * 11, 2 * clen * v**3 * 8 + (clen + v + 1) * 8),
        source="afesp_tpu_torch/csrc/triples_finale.cu",
        replaces="afesp_tpu/ops/triples_pallas.py:1042 (triples_finale, body _finale_kernel :46)",
    )
    for name, r in rows.items():
        g, w = float(r["got"]), float(r["want"])
        r["max_abs_err"] = abs(g - w)
        r["max_rel_err"] = abs(g - w) / max(abs(w), 1e-300)
        check(r["max_rel_err"] <= KERNEL_RTOL,
              f"{name}: kernel {g!r} vs plain {w!r} (rel {r['max_rel_err']:.3e})")
    return rows


def random_spatial_problem(torch, dev, o: int, v: int, seed: int = 11):
    """Random restricted-triples inputs (t1, t2, v_vvov, v_oovo, v_oovv,
    e_o, e_v, I_vovv'', I_ooov''), made with numpy from a seed as in
    tests/test_triples_tiled.py: t2 and v_oovv carry the pair-exchange
    symmetry X[i,j,a,b] = X[j,i,b,a] that the sorted-triple identity of
    the z3/y sums needs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s) * 0.02
    sym = lambda x: (x + x.transpose(1, 0, 3, 2)) / 2
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    arrs = (r(o, v), sym(r(o, o, v, v)), r(v, v, o, v), r(o, o, v, o), sym(r(o, o, v, v)),
            e[:o], e[o:], r(v, o, v, v), r(o, o, o, v))
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)
                 for x in arrs)


def six_sum_error(got, want) -> tuple[float, float]:
    """(max abs error, max relative error) over six sums; a sum nearer 0
    than KERNEL_FLOOR of the largest is held relative to that floor."""
    g, w = got.tolist(), want.tolist()
    floor = KERNEL_FLOOR * max(abs(x) for x in w)
    abs_err = max(abs(a - b) for a, b in zip(g, w))
    rel_err = max(abs(a - b) / max(abs(b), floor, 1e-300) for a, b in zip(g, w))
    return abs_err, rel_err


def spatial_kernel_checks(torch, dev, o: int, v: int, timed: bool) -> dict:
    """K3, K4 and K5 against their plain versions at (o, v), all variants
    on, and the kernels' times; with `timed`, also the plain and library
    times and the bounds (the spatial path's shapes)."""
    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    args = random_spatial_problem(torch, dev, o, v)
    (si, sj, sk), w = TS._sorted_plan(o, dev)
    n = si.numel()
    flags = dict(doing_T=True, doing_R=True, doing_CR=True)
    rows = {}

    def held(name, fn, plain, reps=5):
        got, again = fn(), fn()
        want = plain()
        torch.cuda.synchronize()
        check(bool(torch.equal(got, again)), f"{name} (o={o}, v={v}): two launches differ")
        abs_err, rel_err = six_sum_error(got, want)
        check(rel_err <= KERNEL_RTOL,
              f"{name} (o={o}, v={v}): kernel {got.tolist()} vs plain {want.tolist()} "
              f"(rel {rel_err:.3e})")
        row = dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=cuda_ms(torch, fn, reps))
        if timed:
            row["plain_ms"] = cuda_ms(torch, plain, reps)
        return row

    # bytes of the sorted-triple function: every input read once, six sums out
    in_bytes = sum(x.numel() * 8 for x in args) + n * (3 * 4 + 8) + 6 * 8
    # its operations: 24 numerator GEMMs of 2 v^3 K flops (K = v for 12, o for
    # 12), and ~90 flops an element for D, M(x), M(zn), y and the six sums
    ops = n * (12 * 2 * v**3 * (v + o) + 90 * v**3)
    jlen = TS.pick_spatial_jlen(o, v, "f64")
    f64_total = lambda: torch.stack(TS._triples_total_spatial(
        *args, nocc=o, jlen=jlen, precision="f64", **flags))
    for name, fn, plain in (
        ("triples_fused_spatial", S.triples_fused_spatial, S.triples_fused_spatial_plain),
        ("triples_tiled_spatial", S.triples_tiled_spatial, S.triples_tiled_spatial_plain),
    ):
        if name == "triples_fused_spatial" and v > 128:
            continue  # K3 is the default up to nvirt 128: checked up to the dimer's
        rows[name] = held(name, lambda fn=fn: fn(*args, si, sj, sk, w, **flags),
                          lambda plain=plain: plain(*args, si, sj, sk, w, **flags),
                          reps=5 if v <= 106 else 2)
        if timed:
            rows[name].update(library_ms=cuda_ms(torch, f64_total), bound=bound_ms(ops, in_bytes))

    if v <= 128:  # K5 is checked up to the dimer's shape, as K3
        # the panels of one i-slab, as the "pallas" tier builds them
        fa = TS.finale_panels(0, 0, *args, jlen=TS.pick_spatial_jlen(o, v, "pallas"),
                              doing_CR=True)
        fk = dict(doing_T=True, doing_Y=True, doing_CR=True)
        r = rows["triples_finale_spatial"] = held(
            "triples_finale_spatial", lambda: S.triples_finale_spatial(*fa, **fk),
            lambda: S.triples_finale_spatial_plain(*fa, **fk))
        P = fa[0].shape[0]
        r["shape"] = f"{P} panels of (v, v, v), v={v}"
        if timed:
            # the plain version is one torch expression of the same function
            r["library_ms"] = r["plain_ms"]
            # ~45 flops an element: D, xbar of x and zn, zn at three points,
            # y, six products
            fin_bytes = sum(x.numel() * 8 for x in fa if x is not None) + 6 * 8
            r["bound"] = bound_ms(P * v**3 * 45, fin_bytes)
    sources = {
        "triples_fused_spatial": (
            "afesp_tpu_torch/csrc/triples_fused_spatial.cu",
            "afesp_tpu/ops/triples_pallas.py:784 (triples_fused_spatial, body "
            "_fused_spatial_kernel :470)"),
        "triples_tiled_spatial": (
            "afesp_tpu_torch/csrc/triples_tiled_spatial.cu",
            "afesp_tpu/ops/triples_tiled.py:347 (triples_tiled_spatial, stage 2 "
            "_tiled_kernel :151 via _pallas_partials :279)"),
        "triples_finale_spatial": (
            "afesp_tpu_torch/csrc/triples_finale_spatial.cu",
            "afesp_tpu/ops/triples_pallas.py:222 (triples_finale_spatial, body "
            "_make_spatial_kernel :97)"),
    }
    for name, r in rows.items():
        r["shape"] = r.get("shape", f"o={o}, v={v}, {n} sorted triples")
        r["source"], r["replaces"] = sources[name]
    return rows


def stage_workdir(els_in: str | None = None) -> Path:
    wd = Path(tempfile.mkdtemp(prefix="afesp_chip_smoke_"))
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
        shutil.copy(FIXTURE / f, wd / f)
    if els_in is not None:
        (wd / "els.in").write_text(els_in)
    (wd / "eri.dat").symlink_to(ERI)
    return wd


def spatial_phases(torch, kernels: dict, spatial: dict, device=None) -> tuple[int, dict]:
    """Phases 6 and 7: the restricted path through run_calculation (on
    `device`; None is the entry point's default, the card) against the
    JAX reference file, then its "tiled" and "pallas" triples tiers on
    the converged amplitudes.  Returns K3's launches on the path and
    K4's and K5's on their tiers."""
    import io

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial

    wd = stage_workdir(spatial["els_in"])
    try:
        info = {}
        with phase("spatial_path", info):
            for fn in kernels.values():
                fn.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            sres = run_calculation(wd, Reporter(stream=buf), device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            spatial_launches = {n: fn.launches for n, fn in kernels.items()}
            tr = sres.triples
            e0 = sres.e_hf + sres.e_nuc
            got = {"e_hf_total": e0, "e_mp2_corr": sres.e_mp2, "e_ccsd_corr": sres.e_ccsd,
                   "t1_diagnostic": sres.t1_diagnostic}
            got.update({k: getattr(tr, k) for k in spatial["triples"]})
            want = {k: spatial[k] for k in ("e_hf_total", "e_mp2_corr", "e_ccsd_corr",
                                            "t1_diagnostic")} | spatial["triples"]
            errs = {k: abs(got[k] - want[k]) for k in want}
            # and every printed value of the breakdown block, as printed
            lines = buf.getvalue().splitlines()
            start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
            block = lines[start - 1 : start - 1 + len(spatial["breakdown"])]
            for line in block:
                label, sep, val = line.strip().rpartition(" ")
                label = label.strip()
                if sep and label.endswith(":"):
                    errs[label] = abs(float(val) - spatial["breakdown_values"][label])
            check(len(errs) == len(want) + len(spatial["breakdown_values"]),
                  "the breakdown block lacks a line of the reference's")
            for key, err in errs.items():
                check(err <= ENERGY_TOL, f"{key}: off the JAX value by {err:.3e}")
            check(sres.hf.iterations == spatial["scf_iterations"],
                  f"SCF iterations {sres.hf.iterations} vs JAX {spatial['scf_iterations']}")
            check(sres.cc.iterations == spatial["cc_iterations"],
                  f"CC iterations {sres.cc.iterations} vs JAX {spatial['cc_iterations']}")
            check(tr.precision_used == "fused", f"spatial tier {tr.precision_used}")
            check(spatial_launches["triples_fused_spatial"] > 0,
                  "triples_fused_spatial not launched on the spatial path")
            stage_walls = [ln.strip() for ln in buf.getvalue().splitlines()
                           if ln.lstrip().startswith("Time taken for")]
            info.update(wall_s=f"{wall:.3f}", launches=json.dumps(spatial_launches),
                        max_abs_err=f"{max(errs.values()):.3e}",
                        scf_iterations=sres.hf.iterations, cc_iterations=sres.cc.iterations)
        for line in stage_walls:
            print(f"  {line}", flush=True)
        for line in block:
            print(f"  {line}", flush=True)

        tier_launches = {}
        for tier, kname in (("tiled", "triples_tiled_spatial"),
                            ("pallas", "triples_finale_spatial")):
            info = {}
            with phase(f"spatial_{tier}_tier", info):
                for fn in kernels.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                ttr = do_ccsd_t_spatial(sres.sys, sres.cc, sres.cfg, sres.hf.levels,
                                        Reporter(stream=io.StringIO()), precision=tier)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tier_launches[kname] = kernels[kname].launches
                check(tier_launches[kname] > 0, f"{kname} not launched on the {tier} tier")
                check(ttr.precision_used == tier, f"{tier} tier ran {ttr.precision_used}")
                err_f = max(abs(getattr(ttr, k) - getattr(tr, k)) for k in spatial["triples"])
                err_j = max(abs(getattr(ttr, k) - spatial["triples"][k])
                            for k in spatial["triples"])
                check(err_f <= TRIPLES_TOL, f"{tier} tier off the fused tier by {err_f:.3e}")
                check(err_j <= TRIPLES_TOL, f"{tier} tier off JAX's f64 by {err_j:.3e}")
                info.update(wall_s=f"{wall:.3f}", max_abs_vs_fused=f"{err_f:.3e}",
                            max_abs_vs_jax_f64=f"{err_j:.3e}",
                            launches=json.dumps({kname: tier_launches[kname]}))
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    return spatial_launches["triples_fused_spatial"], tier_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    # no __pycache__ in the checkout: the build directory is all it leaves
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(REPO))
    import io

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods.triples_spinorb import do_ccsd_t_spinorb
    from afesp_tpu_torch.ops import _build
    from afesp_tpu_torch.ops import triples_cuda as K
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    expected = json.loads((FIXTURE / "expected_jax_cpu.json").read_text())
    spatial = json.loads(SPATIAL_EXPECTED.read_text())
    kernels = {"triples_fused": K.triples_fused, "triples_finale": K.triples_finale,
               "triples_fused_spatial": S.triples_fused_spatial,
               "triples_tiled_spatial": S.triples_tiled_spatial,
               "triples_finale_spatial": S.triples_finale_spatial}

    info = {}
    with phase("device", info):
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        info.update(kind=json.dumps(kind), count=count, torch=torch.__version__,
                    cuda=torch.version.cuda)
    print(f"nvidia-smi: {smi}", flush=True)

    info = {}
    with phase("build", info):
        built = _build.build(list(kernels))
        info.update(built={n: round(b["seconds"], 3) for n, b in built.items()})
    for name, b in built.items():
        for line in b["log"].strip().splitlines():
            print(f"  nvcc[{name}] {line}", flush=True)

    info = {}
    with phase("kernels", info):
        rows = kernel_checks(torch, dev, o=expected["nocc"], v=expected["nvirt"])
        rows.update(spatial_kernel_checks(torch, dev, o=spatial["nocc"], v=spatial["nvirt"],
                                          timed=True))
        info.update({n: f"rel={r['max_rel_err']:.3e},ms={r['ms']:.4f}" for n, r in rows.items()})
    # the spatial kernels at the dimer's and the trimer's shapes (K3 and K5
    # up to the dimer's), seeded random inputs: held, and the kernels timed
    for o, v in ((10, 106), (15, 159)):
        info = {}
        with phase(f"kernels_o{o}_v{v}", info):
            big = spatial_kernel_checks(torch, dev, o=o, v=v, timed=False)
            info.update({n: f"rel={r['max_rel_err']:.3e},ms={r['ms']:.4f},shape={r['shape']!r}"
                         for n, r in big.items()})

    wd = stage_workdir()
    try:
        info = {}
        with phase("main_path", info):
            for fn in kernels.values():
                fn.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            res = run_calculation(wd, Reporter(stream=buf))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in kernels.items()}
            e0 = res.e_hf + res.e_nuc
            got = {
                "e_hf_total": e0,
                "e_mp2_total": e0 + res.e_mp2,
                "e_ccsd_total": e0 + res.e_ccsd,
                "e_ccsd_t_total": e0 + res.e_ccsd_t,
            }
            for key, val in got.items():
                check(abs(val - expected[key]) <= ENERGY_TOL,
                      f"{key}: {val!r} vs JAX {expected[key]!r}")
            check(res.hf.iterations == expected["scf_iterations"],
                  f"SCF iterations {res.hf.iterations} vs JAX {expected['scf_iterations']}")
            check(res.cc.iterations == expected["cc_iterations"],
                  f"CC iterations {res.cc.iterations} vs JAX {expected['cc_iterations']}")
            check(launches["triples_fused"] > 0, "triples_fused not launched on the main path")
            stage_walls = [ln.strip() for ln in buf.getvalue().splitlines()
                           if ln.lstrip().startswith("Time taken for")]
            info.update(wall_s=f"{wall:.3f}", launches=json.dumps(launches),
                        max_abs_energy_err=f"{max(abs(v - expected[k]) for k, v in got.items()):.3e}",
                        scf_iterations=res.hf.iterations, cc_iterations=res.cc.iterations)
        for line in stage_walls:
            print(f"  {line}", flush=True)
        lines = buf.getvalue().splitlines()
        start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
        for line in lines[start : start + len(expected["breakdown"]) - 1]:
            print(f"  {line}", flush=True)
        main_launches = launches

        info = {}
        with phase("pallas_tier", info):
            for fn in kernels.values():
                fn.launches = 0
            e_t_fused = res.e_ccsd_t - res.e_ccsd
            e_pallas = do_ccsd_t_spinorb(res.sys, res.cc, res.cfg, res.hf.levels,
                                         Reporter(stream=io.StringIO()), precision="pallas")
            e_t_pallas = e_pallas - res.e_ccsd
            pallas_launches = {n: fn.launches for n, fn in kernels.items()}
            check(pallas_launches["triples_finale"] > 0,
                  "triples_finale not launched on the pallas tier")
            check(abs(e_t_pallas - e_t_fused) <= TRIPLES_TOL,
                  f"E(T) pallas {e_t_pallas!r} vs fused {e_t_fused!r}")
            check(abs(e_t_pallas - expected["e_t_f64"]) <= TRIPLES_TOL,
                  f"E(T) pallas {e_t_pallas!r} vs JAX f64 {expected['e_t_f64']!r}")
            info.update(e_t_fused=repr(e_t_fused), e_t_pallas=repr(e_t_pallas),
                        e_t_jax_f64=repr(expected["e_t_f64"]),
                        launches=json.dumps(pallas_launches))
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    spatial_launches, tier_launches = spatial_phases(torch, kernels, spatial)

    # the path that runs each kernel: K1 the spin-orbital main path, K2 its
    # "pallas" tier, K3 the restricted path, K4 and K5 its "tiled" and
    # "pallas" tiers
    path_launches = {"triples_fused": main_launches["triples_fused"],
                     "triples_finale": pallas_launches["triples_finale"],
                     "triples_fused_spatial": spatial_launches,
                     **tier_launches}
    out = []
    for name, r in rows.items():
        b_ms, b_by = r["bound"]
        out.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": path_launches[name],
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": out}), flush=True)
    print(f"{smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
