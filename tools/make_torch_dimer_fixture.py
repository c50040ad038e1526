"""Write the JAX reference values of the restricted CRCCSD(T)_spatial run
of the water dimer, cc-pVTZ (116 basis functions), that `chip_smoke.py`
checks the port's dimer path against.

It runs the JAX package on the CPU:
  1. builds the dimer's basis from the committed
     `data/h2o-dimer-cc-pvtz/geom.dat` with "cc-pvtz", as
     `tools/make_dimer.py` does, and its ERIs with the JAX engine's
     `eri_tensor` (about 6 minutes on an 8-core CPU);
  2. writes them, packed as `eri.npy` (`pack_eri`, as make_dimer.py
     does), into a temporary directory beside copies of the committed
     `s.dat`, `t.dat`, `v.dat` and `geom.dat`; nothing is written into
     `data/` but the JSON below;
  3. runs the JAX driver (`afesp_tpu.driver.run_calculation`) there with
     the committed `els.in` at `ccsd_precision = "f64"` (the port runs
     f64; JAX's CPU "hybrid" runs digit GEMMs), and, with `--hybrid`,
     once more at the committed "hybrid" as a cross-check;
  4. writes `data/h2o-dimer-cc-pvtz/expected_jax_cpu_crccsd_t_spatial.json`:
     the `els_in` string, the breakdown lines and every value in them,
     the SCF and CC iteration counts, and a sample of the ERIs (the
     packed store's sum and Frobenius norm, and 1000 (packed index,
     value) pairs drawn with a seeded numpy generator).

With `--pvtz` it writes instead, in about 40 s, the same ERI sample of
H2O/cc-pVTZ (`fixture-cc-pvtz` at the committed
`data/h2o-cc-pvtz-2.00_104.45/geom.dat`) from the JAX engine as it is
now, beside that directory's inputs as `expected_jax_cpu_eri_sample.json`,
with how far it lies from the committed `data/h2o-cc-pvtz/eri.dat`:
that file was written by an earlier form of the engine, and the two
differ by up to ~2e-9.

    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py [--hybrid]
    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py --pvtz
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

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DIMER = REPO / "data" / "h2o-dimer-cc-pvtz"
OUT = DIMER / "expected_jax_cpu_crccsd_t_spatial.json"
PVTZ = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
PVTZ_ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"
PVTZ_OUT = PVTZ / "expected_jax_cpu_eri_sample.json"
SAMPLE_SEED = 20261017
SAMPLE_SIZE = 1000
TRIPLES_KEYS = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
                "e_crccsd_tt", "D_T", "D_TT")


def els_in_at(precision: str) -> str:
    text = (DIMER / "els.in").read_text()
    old = 'ccsd_precision = "hybrid"'
    if old not in text:
        raise SystemExit(f"{DIMER / 'els.in'} has no line {old!r}")
    return text.replace(old, f'ccsd_precision = "{precision}"')


def breakdown_of(text: str) -> tuple[list[str], dict]:
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln) - 1
    stop = next(i for i in range(start, len(lines)) if "Total energy:" in lines[i]) + 1
    block = lines[start:stop]
    values = {}
    for line in block:
        label, sep, val = line.strip().rpartition(" ")
        label = label.strip()
        if sep and label.endswith(":"):
            values[label] = float(val)
    return block, values


def run_driver(wd: Path, els_in: str) -> dict:
    """The JAX driver on `wd`, with its HF and CC results caught on the
    way (its RunResult keeps neither)."""
    from afesp_tpu import driver
    from afesp_tpu.io.report import Reporter
    from afesp_tpu.methods import hf as hf_mod

    (wd / "els.in").write_text(els_in)
    caught = {}
    do_rhf, do_ccsd = hf_mod.do_rhf, driver.do_ccsd_spatial

    def rhf(*a, **k):
        caught["hf"] = do_rhf(*a, **k)
        return caught["hf"]

    def ccsd(*a, **k):
        caught["cc"] = do_ccsd(*a, **k)
        return caught["cc"]

    hf_mod.do_rhf, driver.do_ccsd_spatial = rhf, ccsd
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        res = driver.run_calculation(wd, Reporter(stream=buf))
        wall = time.perf_counter() - t0
    finally:
        hf_mod.do_rhf, driver.do_ccsd_spatial = do_rhf, do_ccsd
    block, values = breakdown_of(buf.getvalue())
    tr = res.triples
    stage_walls = [ln.strip() for ln in buf.getvalue().splitlines()
                   if ln.lstrip().startswith("Time taken for")]
    return {
        "nocc": res.sys.nocc,
        "nvirt": res.sys.nvirt,
        "e_nuc": res.e_nuc,
        "e_hf_total": res.e_hf + res.e_nuc,
        "e_mp2_corr": res.e_mp2,
        "e_ccsd_corr": res.e_ccsd,
        "t1_diagnostic": res.t1_diagnostic,
        "scf_iterations": caught["hf"].iterations,
        "cc_iterations": caught["cc"].iterations,
        "cc_converged": bool(caught["cc"].converged),
        "triples_precision_used": tr.precision_used,
        "triples": {k: float(getattr(tr, k)) for k in TRIPLES_KEYS},
        "breakdown": block,
        "breakdown_values": values,
        "wall_s": wall,
        "stage_walls": stage_walls,
    }


def eri_sample(packed: np.ndarray) -> dict:
    rng = np.random.default_rng(SAMPLE_SEED)
    idx = np.sort(rng.choice(packed.size, SAMPLE_SIZE, replace=False))
    return {
        "count": int(packed.size), "sum": float(packed.sum()),
        "frobenius": float(np.sqrt(np.dot(packed, packed))),
        "max_abs": float(np.abs(packed).max()), "seed": SAMPLE_SEED,
        "index": idx.tolist(), "value": packed[idx].tolist(),
    }


def pvtz_sample() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from afesp_tpu.integrals.engine import build_basis, eri_tensor
    from afesp_tpu.io.dat import pack_from_quadruple_table, read_eri_table, read_geometry
    from afesp_tpu.ops.packed_eri import pack_eri

    _, charges, coords = read_geometry(PVTZ / "geom.dat")
    basis = build_basis(charges, coords, "fixture-cc-pvtz")
    t0 = time.perf_counter()
    packed = pack_eri(eri_tensor(basis))
    eri_s = time.perf_counter() - t0
    committed = pack_from_quadruple_table(read_eri_table(PVTZ_ERI), basis.nbf)
    diff = np.abs(packed - committed)
    out = {
        "source": "tools/make_torch_dimer_fixture.py --pvtz",
        "jax_version": jax.__version__,
        "inputs": {"geometry": str((PVTZ / "geom.dat").relative_to(REPO)),
                   "basis": "fixture-cc-pvtz",
                   "eri": "eri_tensor of the JAX engine, packed (pack_eri)"},
        "nbasis": basis.nbf,
        "eri_sample": eri_sample(packed),
        "vs_committed_eri_dat": {
            "file": str(PVTZ_ERI.relative_to(REPO)), "max_abs_diff": float(diff.max()),
            "count_above_1e-12": int((diff > 1e-12).sum()),
        },
        "walls_s": {"eri_tensor": eri_s},
    }
    PVTZ_OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {PVTZ_OUT.relative_to(REPO)}: {out['vs_committed_eri_dat']}", flush=True)
    return 0


def main() -> int:
    if "--pvtz" in sys.argv[1:]:
        return pvtz_sample()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from afesp_tpu.integrals.engine import build_basis, eri_tensor
    from afesp_tpu.io.dat import read_geometry
    from afesp_tpu.ops.packed_eri import pack_eri

    _, charges, coords = read_geometry(DIMER / "geom.dat")
    basis = build_basis(charges, coords, "cc-pvtz")
    t0 = time.perf_counter()
    packed = pack_eri(eri_tensor(basis))
    eri_s = time.perf_counter() - t0
    print(f"eri_tensor: {basis.nbf} bf, {packed.size} packed values, {eri_s:.1f} s",
          flush=True)
    out = {
        "source": "tools/make_torch_dimer_fixture.py",
        "jax_version": jax.__version__,
        "jax_backend": jax.default_backend(),
        "inputs": {"dir": str(DIMER.relative_to(REPO)),
                   "geometry": "geom.dat of that directory", "basis": "cc-pvtz",
                   "eri": "eri_tensor of the JAX engine, packed (pack_eri) as eri.npy"},
        "nbasis": basis.nbf,
        "eri_sample": eri_sample(packed),
    }
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
            shutil.copy(DIMER / f, wd / f)
        np.save(wd / "eri.npy", packed)
        del packed
        els_in = els_in_at("f64")
        run = run_driver(wd, els_in)
        print(json.dumps({k: run[k] for k in ("scf_iterations", "cc_iterations",
                                              "wall_s")}), flush=True)
        out |= {"els_in": els_in} | run
        out["walls_s"] = {"eri_tensor": eri_s, "driver_f64": out.pop("wall_s")}
        write(out)
        if "--hybrid" in sys.argv[1:]:
            hyb = run_driver(wd, els_in_at("hybrid"))
            out["hybrid_cross_check"] = {
                k: hyb[k] for k in ("breakdown_values", "scf_iterations",
                                    "cc_iterations", "wall_s")}
            write(out)
    return 0


def write(out: dict) -> None:
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT.relative_to(REPO)} ({OUT.stat().st_size} bytes)", flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["AFESP_JAX_CACHE"] = ""
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
