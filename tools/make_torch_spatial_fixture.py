"""Write the JAX reference values of the restricted CRCCSD(T)_spatial run
of H2O/cc-pVTZ that `chip_smoke.py`, the GPU tests and the slow port
test check against.

It runs the JAX package on the CPU over the committed inputs
(`data/h2o-cc-pvtz-2.00_104.45/{s,t,v,geom}.dat` and
`data/h2o-cc-pvtz/eri.dat`, staged in a temporary directory) with the
`els.in` below (`calc_type="CRCCSD(T)_spatial"`, `ccsd_precision="f64"`)
and writes `expected_jax_cpu_crccsd_t_spatial.json` beside those inputs:
the breakdown lines of `afesp_tpu.driver` and every value in them, the
SCF and CC iteration counts, the T1 diagnostic, D[T] and D(T), the six
f64 triples sums, and, for the record only, the same values from the
triples' "hybrid" tier (f32 panel GEMMs).  About 15 s on an 8-core CPU.
It writes nothing into the JAX compile cache.

    JAX_PLATFORMS=cpu python tools/make_torch_spatial_fixture.py
"""

from __future__ import annotations

import io
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"
OUT = FIXTURE / "expected_jax_cpu_crccsd_t_spatial.json"

ELS_IN = """&elsinput
calc_type="CRCCSD(T)_spatial",
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

TRIPLES_KEYS = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
                "e_crccsd_tt", "D_T", "D_TT")


def run_expected() -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")

    from afesp_tpu.config import read_els_in
    from afesp_tpu.driver import RunResult, _final_breakdown
    from afesp_tpu.io import dat
    from afesp_tpu.io.report import Reporter
    from afesp_tpu.methods import triples_spatial as T
    from afesp_tpu.methods.ccsd_spatial import do_ccsd_spatial
    from afesp_tpu.methods.hf import do_rhf
    from afesp_tpu.methods.mp2 import do_mp2_spatial

    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
            shutil.copy(FIXTURE / f, wd / f)
        (wd / "els.in").write_text(ELS_IN)
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
        cc = do_ccsd_spatial(sys_, mp2.eri_mo, cfg, hf, rep, wd,
                             slices=mp2.slices, vvvv_B=mp2.vvvv_B)
        walls["ccsd_s"] = time.perf_counter() - t0
        # as afesp_tpu.driver calls it: ccsd_precision="f64" picks the f64 tier
        t0 = time.perf_counter()
        tr = T.do_ccsd_t_spatial(sys_, cc, cfg, hf.levels, rep)
        walls["triples_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr_hybrid = T.do_ccsd_t_spatial(sys_, cc, cfg, hf.levels, rep, precision="hybrid")
        walls["triples_hybrid_s"] = time.perf_counter() - t0

        # the six raw f64 sums, as do_ccsd_t_spatial forms them
        nocc, nvirt = sys_.nocc, sys_.nvirt
        v = cc.slices
        Iv, Jo = T.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, v,
                                    nocc=nocc, precision="f64")
        sums = T._triples_total_spatial(
            cc.t1, cc.t2, v.v_vvov, v.v_oovo, v.v_oovv, hf.levels[:nocc],
            hf.levels[nocc : nocc + nvirt], Iv, Jo, nocc=nocc,
            jlen=T.pick_spatial_jlen(nocc, nvirt, "f64"),
            doing_T=True, doing_R=False, doing_CR=True, precision="f64",
        )

    res = RunResult(cfg=cfg, sys=sys_, e_nuc=ints.e_nuc)
    res.e_hf, res.e_mp2, res.e_ccsd = hf.e_hf, mp2.e_mp2, cc.e_ccsd
    res.t1_diagnostic = cc.t1_diagnostic
    res.triples = tr
    res.e_highest = tr.e_highest
    buf = io.StringIO()
    _final_breakdown(Reporter(stream=buf), res, tr.calcname)
    breakdown = buf.getvalue().rstrip("\n").split("\n")
    values = {}
    for line in breakdown:
        label, sep, val = line.strip().rpartition(" ")
        label = label.strip()
        if sep and label.endswith(":"):
            values[label] = float(val)
    e0 = hf.e_hf + ints.e_nuc
    return {
        "source": "tools/make_torch_spatial_fixture.py",
        "jax_version": jax.__version__,
        "jax_backend": jax.default_backend(),
        "inputs": {
            "dir": str(FIXTURE.relative_to(REPO)),
            "eri": str(ERI.relative_to(REPO)),
            "geometry": "water_geometry(2.00, 104.45)",
            "basis": "fixture-cc-pvtz",
        },
        "els_in": ELS_IN,
        "nbasis": sys_.nbasis,
        "nocc": nocc,
        "nvirt": nvirt,
        "e_nuc": ints.e_nuc,
        "e_hf_total": e0,
        "e_mp2_corr": mp2.e_mp2,
        "e_ccsd_corr": cc.e_ccsd,
        "scf_iterations": hf.iterations,
        "cc_iterations": cc.iterations,
        "cc_converged": bool(cc.converged),
        "t1_diagnostic": cc.t1_diagnostic,
        "triples_precision_used": tr.precision_used,
        "triples": {k: getattr(tr, k) for k in TRIPLES_KEYS},
        "sums_f64": {k: float(x) for k, x in zip(T._SUM_KEYS, sums)},
        "breakdown": breakdown,
        "breakdown_values": values,
        "triples_hybrid_tier": {k: getattr(tr_hybrid, k) for k in TRIPLES_KEYS},
        "walls_s": walls,
    }


def main() -> int:
    out = run_expected()
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(REPO)}", flush=True)
    print(json.dumps({k: out[k] for k in ("scf_iterations", "cc_iterations",
                                          "t1_diagnostic")} | out["triples"]))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["AFESP_JAX_CACHE"] = ""
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
