"""Write the H2O/cc-pVTZ one-electron inputs and the JAX reference values
that `chip_smoke.py` and the slow port test check against.

The committed `data/h2o-cc-pvtz/eri.dat` was generated by the native
integral engine for `water_geometry(2.00, 104.45)` with the
"fixture-cc-pvtz" basis.  This script writes the matching `s.dat`,
`t.dat`, `v.dat` and `geom.dat` (the generator's own text formats, no
ERI) plus an `els.in` into `data/h2o-cc-pvtz-2.00_104.45/`, so the
PyTorch port can run the headline workload on a machine without JAX.

With `--expected` it then runs the JAX package on the CPU over those
files plus the committed ERI (staged in a temporary directory) and
writes `expected_jax_cpu.json`: the four totals, the SCF and CC
iteration counts, E(T) at precision="f64", the breakdown lines of
`afesp_tpu.driver`, and how the run compares with the reference
program's own `els_cpu.out` values (recorded, not asserted).  That run
takes about 20 s on an 8-core CPU.

    JAX_PLATFORMS=cpu python tools/make_torch_pvtz_fixture.py [--expected]
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"

ELS_IN = """&elsinput
calc_type="CCSD(T)_spinorb",
scf_e_tol=1e-9,
scf_d_tol=1e-8,
scf_diis_n_errmat=6,
ccsd_e_tol=1e-9,
ccsd_t_tol=1e-8,
ccsd_diis_n_errmat=8,
scf_maxiter = 100,
ccsd_maxiter = 100,
ccsd_precision = "f64",
write_fcidump = .false.,
scf_read_guess = .false.,
scf_write_guess = .false.,
/
"""

# The reference program's own run of this geometry (els_cpu.out of the
# upstream sample data, as quoted by tests/test_pvtz_golden.py).
ELS_CPU_GOLDENS = {
    "e_hf_total": -75.5955554164,
    "e_ccsd_corr": -0.399789132814,
    "e_ccsd_t_corr": -0.434032756,
}


def write_inputs() -> None:
    from afesp_tpu.integrals.generate import write_dat_files
    from afesp_tpu.utils.wrapper import water_geometry

    charges, coords = water_geometry(2.00, 104.45)
    write_dat_files(OUT, charges, coords, "fixture-cc-pvtz", write_eri=False)
    (OUT / "els.in").write_text(ELS_IN)


def run_expected() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from afesp_tpu.config import read_els_in
    from afesp_tpu.driver import RunResult, _final_breakdown
    from afesp_tpu.io import dat
    from afesp_tpu.io.report import Reporter
    from afesp_tpu.methods.ccsd_spinorb import do_ccsd_spinorb
    from afesp_tpu.methods.hf import do_rhf
    from afesp_tpu.methods.mp2 import do_mp2_spatial
    from afesp_tpu.methods.triples_spinorb import do_ccsd_t_spinorb

    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
            shutil.copy(OUT / f, wd / f)
        shutil.copy(ERI, wd / "eri.dat")

        walls = {}
        t0 = time.perf_counter()
        cfg = read_els_in(wd)
        sys_, ints = dat.read_integrals(wd, cfg.restricted)
        rep = Reporter(stream=io.StringIO())
        hf = do_rhf(sys_, ints, cfg, rep, wd)
        mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
        walls["hf_mp2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cc = do_ccsd_spinorb(sys_, mp2.eri_mo, cfg, hf, rep, wd)
        walls["ccsd_s"] = time.perf_counter() - t0
        # as afesp_tpu.driver calls it: the backend picks the triples tier
        t0 = time.perf_counter()
        e_ccsd_t = do_ccsd_t_spinorb(sys_, cc, cfg, hf.levels, rep)
        walls["triples_default_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        e_ccsd_t_f64 = do_ccsd_t_spinorb(
            sys_, cc, cfg, hf.levels, rep, precision="f64"
        )
        walls["triples_f64_s"] = time.perf_counter() - t0

    res = RunResult(cfg=cfg, sys=sys_, e_nuc=ints.e_nuc)
    res.e_hf, res.e_mp2, res.e_ccsd = hf.e_hf, mp2.e_mp2, cc.e_ccsd
    res.e_ccsd_t = res.e_highest = e_ccsd_t
    buf = io.StringIO()
    _final_breakdown(Reporter(stream=buf), res, "CCSD")
    e0 = hf.e_hf + ints.e_nuc
    out = {
        "source": "tools/make_torch_pvtz_fixture.py --expected",
        "jax_version": jax.__version__,
        "jax_backend": jax.default_backend(),
        "inputs": {
            "dir": str(OUT.relative_to(REPO)),
            "eri": str(ERI.relative_to(REPO)),
            "geometry": "water_geometry(2.00, 104.45)",
            "basis": "fixture-cc-pvtz",
        },
        "nbasis": sys_.nbasis,
        "nocc": sys_.nocc,
        "nvirt": sys_.nvirt,
        "e_nuc": ints.e_nuc,
        "e_hf_total": e0,
        "e_mp2_total": e0 + mp2.e_mp2,
        "e_ccsd_total": e0 + cc.e_ccsd,
        "e_ccsd_t_total": e0 + e_ccsd_t,
        "e_mp2_corr": mp2.e_mp2,
        "e_ccsd_corr": cc.e_ccsd,
        "e_ccsd_t_corr": e_ccsd_t,
        "scf_iterations": hf.iterations,
        "cc_iterations": cc.iterations,
        "cc_converged": bool(cc.converged),
        "e_t_f64": e_ccsd_t_f64 - cc.e_ccsd,
        "e_t_default_tier": e_ccsd_t - cc.e_ccsd,
        "breakdown": buf.getvalue().rstrip("\n").split("\n"),
        "walls_s": walls,
    }
    deltas = {
        "e_hf_total": out["e_hf_total"] - ELS_CPU_GOLDENS["e_hf_total"],
        "e_ccsd_corr": out["e_ccsd_corr"] - ELS_CPU_GOLDENS["e_ccsd_corr"],
        "e_ccsd_t_corr": out["e_ccsd_t_corr"] - ELS_CPU_GOLDENS["e_ccsd_t_corr"],
    }
    out["els_cpu_goldens"] = dict(
        ELS_CPU_GOLDENS,
        deltas=deltas,
        within_1e8=all(abs(d) < 1e-8 for d in deltas.values()),
    )
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--expected", action="store_true",
                   help="also run the JAX package and write expected_jax_cpu.json")
    args = p.parse_args(argv)
    write_inputs()
    print(f"wrote {OUT.relative_to(REPO)}", flush=True)
    if args.expected:
        out = run_expected()
        (OUT / "expected_jax_cpu.json").write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps({k: out[k] for k in ("e_hf_total", "e_ccsd_t_total",
                                              "scf_iterations", "cc_iterations")}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("AFESP_JAX_CACHE", "")
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
