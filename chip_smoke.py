#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives `afesp_tpu_torch` — never the JAX package — through its main
path, CCSD(T)_spinorb on H2O/cc-pVTZ (58 basis functions; 10 occupied
and 106 virtual spin orbitals), in six phases, one line each with its
wall time:

  1. the device: torch's name and count, and nvidia-smi's name and
     power limit;
  2. the build of every CUDA kernel of the path with nvcc, timed (the
     `-Xptxas -v` report is printed);
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, on seeded random antisymmetric inputs: relative
     error <= 1e-11 (both sides f64, only the order of summation
     differs), and two launches agree bit for bit; kernel, plain and
     library times by CUDA events;
  4. the main path, `run_calculation` on a staged copy of
     data/h2o-cc-pvtz-2.00_104.45 with the committed eri.dat, default
     "fused" triples tier: HF, MP2, CCSD and CCSD(T) totals within 1e-8 Ha
     of the JAX package's CPU run (expected_jax_cpu.json) and equal SCF
     and CC iteration counts;
  5. the "pallas" triples tier on the same converged amplitudes: E(T)
     within 1e-9 of the fused tier and of JAX's f64 E(T);
  6. one JSON line of the kernels: launches on the main path, times,
     bound and errors.

Every check raises on failure (nonzero exit, no `ok` line).  The last
line is {"ok": true, "device": {...}}.  The script writes nothing into
the checkout except the kernels' gitignored build directory; its work
directory is a temporary one, removed at the end.
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
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the f64 tensor-core
# peak (the f64 work of both kernels could at best run there)
HBM_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 67e12
KERNEL_RTOL = 1e-11
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


def stage_workdir() -> Path:
    wd = Path(tempfile.mkdtemp(prefix="afesp_chip_smoke_"))
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
        shutil.copy(FIXTURE / f, wd / f)
    (wd / "eri.dat").symlink_to(ERI)
    return wd


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

    expected = json.loads((FIXTURE / "expected_jax_cpu.json").read_text())
    kernels = {"triples_fused": K.triples_fused, "triples_finale": K.triples_finale}

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
        info.update({n: f"rel={r['max_rel_err']:.3e},ms={r['ms']:.4f}" for n, r in rows.items()})

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

    # the "pallas" tier is K2's path on this slice; K1's is the main path
    path_launches = {"triples_fused": main_launches["triples_fused"],
                     "triples_finale": pallas_launches["triples_finale"]}
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
