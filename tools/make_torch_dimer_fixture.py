"""Write the JAX reference values that `chip_smoke.py` checks the port's
large paths against: the water dimer, cc-pVTZ (116 basis functions),
restricted CRCCSD(T)_spatial (default) or CCSD(T)_spinorb (`--spinorb`),
and the water trimer, cc-pVTZ (174 basis functions), CRCCSD(T)_spatial
(`--trimer`).

It runs the JAX package on the CPU:
  1. builds the molecule's basis from the committed `geom.dat` of its
     directory (`data/h2o-dimer-cc-pvtz/`, `data/h2o-trimer-cc-pvtz/`)
     with "cc-pvtz", as `tools/make_dimer.py` does, and its ERIs with the
     JAX engine's `eri_tensor`;
  2. writes them, packed as `eri.npy` (`pack_eri`, as make_dimer.py
     does), into a temporary directory beside copies of the committed
     `s.dat`, `t.dat`, `v.dat` and `geom.dat`; nothing is written into
     `data/` but the JSON below;
  3. runs the JAX driver (`afesp_tpu.driver.run_calculation`) there with
     the committed `els.in` at `ccsd_precision = "f64"`, or, with
     `--precision hybrid`, at "hybrid" (JAX's digit-GEMM CCSD: the
     committed els.in unchanged), with `--spinorb` also at
     `calc_type = "CCSD(T)_spinorb"` (JAX holds the dimer's vvvv as spin
     blocks by its 4e9-byte rule), and, with `--hybrid` at f64, once
     more at the committed "hybrid" as a cross-check (breakdown values
     and iteration counts only);
  4. writes `expected_jax_cpu_crccsd_t_spatial.json` (or, with
     `--spinorb`, `expected_jax_cpu_ccsd_t_spinorb.json`) into that
     directory: the `els_in` string, the breakdown lines and every value
     in them, the SCF and CC iteration counts, the stage walls and a
     sample of the ERIs (the packed store's sum and Frobenius norm, and
     1000 (packed index, value) pairs drawn with a seeded numpy
     generator).  The sample is written as soon as the engine ends.  With
     `--spinorb` the JSON also holds E(T) of JAX's f64 spin-orbital tier
     on the converged amplitudes (`spinorb_triples`): the driver's own
     CPU tier is the f32 "hybrid" one.  With `--precision hybrid` the
     file is named `..._hybrid.json`; for the spatial calc_type the
     driver's triples call then runs its own tier (kept under
     `triples_driver_default`) and then the f64 tier on the same hybrid
     amplitudes, whose values the breakdown and `triples` hold: the
     port's card runs CCSD at "hybrid" and its triples in f64.

Walls on an 8-core CPU with 62 GB: the dimer's engine 349 s (258 s in a
later run), its driver 128 s at f64 and 169 s at "hybrid"; `--spinorb`
driver 297 s and f64 (T) 598 s (about 17 GB of host memory); `--trimer`
engine 1537 s and driver 1106 s, 1028 s of it CR-CCSD(T) (about 34 GB).
`--eri-npy PATH` saves the engine's packed ERIs at PATH, or, where that
file exists, reads them from it instead of running the engine.
`--eager-ccsd` runs the CCSD solve op by op (see `run_driver`): the
hybrid runs of the trimer and the spin-orbital dimer need it on a host
with 62 GB.

With `--stream` it runs the same driver under `AFESP_FORCE_STREAM=1`,
the streaming-slices tier (packed-resident Fock build with its device
SCF prelude, the sliced transform with v_vvvv as digit limbs, the
external-slices CCSD and the CR term from the limbs), at the committed
"hybrid" (the tier refuses f64), and writes
`expected_jax_cpu_crccsd_t_spatial_stream.json` beside the inputs, with
the prelude's iteration count (`prelude_iterations`) and the f64
triples on the tier's own amplitudes and CR term; the driver's own
(f32 "hybrid") triples tier is not run then.  The dimer's solve runs
jitted; the trimer's needs `--eager-ccsd`.

With `--pvtz --precision hybrid` it writes, in a few minutes, the two
hybrid gates of the committed H2O/cc-pVTZ inputs instead
(`data/h2o-cc-pvtz-2.00_104.45/expected_jax_cpu_hybrid.json`,
CCSD(T)_spinorb, and `expected_jax_cpu_crccsd_t_spatial_hybrid.json`;
see `pvtz_hybrid`).

With `--pvtz` alone it writes instead, in about 40 s, the same ERI sample of
H2O/cc-pVTZ (`fixture-cc-pvtz` at the committed
`data/h2o-cc-pvtz-2.00_104.45/geom.dat`) from the JAX engine as it is
now, beside that directory's inputs as `expected_jax_cpu_eri_sample.json`,
with how far it lies from the committed `data/h2o-cc-pvtz/eri.dat`:
that file was written by an earlier form of the engine, and the two
differ by up to ~2e-9.

    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py [--hybrid]
    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py --spinorb [--eri-npy PATH]
    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py --trimer [--eri-npy PATH]
    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py --pvtz
    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py [--spinorb | --trimer | --pvtz] \
        --precision hybrid [--eri-npy PATH] [--eager-ccsd]
    JAX_PLATFORMS=cpu python tools/make_torch_dimer_fixture.py [--trimer] --stream \
        [--eri-npy PATH] [--eager-ccsd]
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
DIMER = REPO / "data" / "h2o-dimer-cc-pvtz"
TRIMER = REPO / "data" / "h2o-trimer-cc-pvtz"
OUT = DIMER / "expected_jax_cpu_crccsd_t_spatial.json"
PVTZ = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
PVTZ_ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"
PVTZ_OUT = PVTZ / "expected_jax_cpu_eri_sample.json"
SAMPLE_SEED = 20261017
SAMPLE_SIZE = 1000
TRIPLES_KEYS = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
                "e_crccsd_tt", "D_T", "D_TT")


def els_in_at(d: Path, precision: str, spinorb: bool = False) -> str:
    """The committed `d`/els.in with `ccsd_precision` (and, with
    `spinorb`, `calc_type = "CCSD(T)_spinorb"`) replaced."""
    text = (d / "els.in").read_text()
    for old, new in (('ccsd_precision = "hybrid"', f'ccsd_precision = "{precision}"'),
                     ('calc_type="CRCCSD(T)_spatial"',
                      'calc_type="CCSD(T)_spinorb"' if spinorb else None)):
        if old not in text:
            raise SystemExit(f"{d / 'els.in'} has no line {old!r}")
        if new is not None:
            text = text.replace(old, new)
    return text


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


def run_driver(wd: Path, els_in: str, spinorb: bool = False,
               f64_triples: bool = False, eager_ccsd: bool = False,
               default_triples: bool = True) -> dict:
    """The JAX driver on `wd`, with its HF and CC results caught on the
    way (its RunResult keeps neither).  With `f64_triples` (spatial
    only) the driver's triples call runs its own tier, whose values are
    kept under `triples_driver_default`, and then the f64 tier on the
    same amplitudes, whose values the driver reports: the breakdown is
    then the CCSD of the els.in's precision with the f64 triples family.
    With `eager_ccsd` the CCSD solve runs under jax.disable_jit(), op by
    op, so each intermediate is freed when it is dropped (with
    `default_triples` False the driver's own tier is skipped and only
    the f64 tier runs): the whole-solve
    program of the hybrid CCSD holds every digit-pair product of a
    contraction at once and outgrew 62 GB of host memory at the trimer
    and the spin-orbital dimer (the same arithmetic: on the 24-bf H2O
    the two forms agree to 2e-14 Ha spatial, 2e-12 spin-orbital).  For
    the restricted formulation it also drops what nothing reads after
    its use: the AO integrals once MP2 has run, and the dense MO tensor
    once the CC slices are cut from it (the trimer's eager run was
    OOM-killed at 65 GB with both held through the digitizing)."""
    from afesp_tpu import driver
    from afesp_tpu.io.report import Reporter
    from afesp_tpu.methods import ccsd_spatial as cs_mod
    from afesp_tpu.methods import hf as hf_mod
    from afesp_tpu.methods import mp2 as mp2_mod

    (wd / "els.in").write_text(els_in)
    caught = {}
    cc_name = "do_ccsd_spinorb" if spinorb else "do_ccsd_spatial"
    do_rhf, do_ccsd = hf_mod.do_rhf, getattr(driver, cc_name)
    do_t = driver.do_ccsd_t_spatial
    do_mp2, cc_init = mp2_mod.do_mp2_spatial, cs_mod.spatial_cc_init

    def mp2_then_free(sys_, ints, *a, **k):
        out = do_mp2(sys_, ints, *a, **k)
        ints.free_device_eri()
        ints.eri = ints.eri_packed = None
        return out

    def cc_init_then_free(eri_mo, *a, **k):
        out = cc_init(eri_mo, *a, **k)
        eri_mo.delete()
        return out

    def rhf(*a, **k):
        caught["hf"] = do_rhf(*a, **k)
        return caught["hf"]

    def ccsd(*a, **k):
        if eager_ccsd:
            import jax

            with jax.disable_jit():
                caught["cc"] = do_ccsd(*a, **k)
        else:
            caught["cc"] = do_ccsd(*a, **k)
        return caught["cc"]

    def triples(sys_, cc, cfg, levels, rep, **k):
        if default_triples:
            t0 = time.perf_counter()
            caught["t_default"] = do_t(sys_, cc, cfg, levels, rep, **k)
            caught["t_default_s"] = time.perf_counter() - t0
            rep = Reporter(stream=io.StringIO())
        t0 = time.perf_counter()
        caught["t_f64"] = do_t(sys_, cc, cfg, levels, rep, precision="f64")
        caught["t_f64_s"] = time.perf_counter() - t0
        return caught["t_f64"]

    hf_mod.do_rhf = rhf
    setattr(driver, cc_name, ccsd)
    if f64_triples:
        driver.do_ccsd_t_spatial = triples
    if eager_ccsd and not spinorb:
        mp2_mod.do_mp2_spatial = mp2_then_free
        cs_mod.spatial_cc_init = cc_init_then_free
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        res = driver.run_calculation(wd, Reporter(stream=buf))
        wall = time.perf_counter() - t0
    finally:
        hf_mod.do_rhf = do_rhf
        setattr(driver, cc_name, do_ccsd)
        driver.do_ccsd_t_spatial = do_t
        mp2_mod.do_mp2_spatial, cs_mod.spatial_cc_init = do_mp2, cc_init
    block, values = breakdown_of(buf.getvalue())
    stage_walls = [ln.strip() for ln in buf.getvalue().splitlines()
                   if ln.lstrip().startswith("Time taken for")]
    prelude = re.search(r"Device SCF prelude: (\d+) iterations", buf.getvalue())
    run = {
        "nocc": res.sys.nocc,
        "nvirt": res.sys.nvirt,
        "e_nuc": res.e_nuc,
        "e_hf_total": res.e_hf + res.e_nuc,
        "e_mp2_corr": res.e_mp2,
        "e_ccsd_corr": res.e_ccsd,
        "t1_diagnostic": res.t1_diagnostic,
        "scf_iterations": caught["hf"].iterations,
        "prelude_iterations": int(prelude.group(1)) if prelude else None,
        "cc_iterations": caught["cc"].iterations,
        "cc_converged": bool(caught["cc"].converged),
        "breakdown": block,
        "breakdown_values": values,
        "wall_s": wall,
        "stage_walls": stage_walls,
    }
    if spinorb:
        return run | {"_cc": caught["cc"], "_res": res, "_hf": caught["hf"]}
    tr = res.triples
    run |= {"triples_precision_used": tr.precision_used,
            "triples": {k: float(getattr(tr, k)) for k in TRIPLES_KEYS}}
    if f64_triples and default_triples:
        td = caught["t_default"]
        run["triples_driver_default"] = {
            "precision_used": td.precision_used,
            "triples": {k: float(getattr(td, k)) for k in TRIPLES_KEYS},
            "wall_s": caught["t_default_s"]}
    if f64_triples:
        run["triples_f64_s"] = caught["t_f64_s"]
    return run


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


def pvtz_hybrid(precision: str) -> int:
    """The JAX driver on the committed H2O/cc-pVTZ inputs (s/t/v/geom.dat
    of data/h2o-cc-pvtz-2.00_104.45 and data/h2o-cc-pvtz/eri.dat) at
    `precision`: CCSD(T)_spinorb from that directory's els.in into
    expected_jax_cpu_<precision>.json (with JAX's f64 E(T) on its own
    amplitudes, `spinorb_triples`), and CRCCSD(T)_spatial from the
    els_in of expected_jax_cpu_crccsd_t_spatial.json into
    expected_jax_cpu_crccsd_t_spatial_<precision>.json (its triples at
    f64, the driver's own tier under `triples_driver_default`)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    spatial = json.loads((PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())
    cases = ((f"expected_jax_cpu_{precision}.json", (PVTZ / "els.in").read_text(), True),
             (f"expected_jax_cpu_crccsd_t_spatial_{precision}.json", spatial["els_in"], False))
    for name, els_in, spinorb in cases:
        old = 'ccsd_precision = "f64"'
        if old not in els_in:
            raise SystemExit(f"{name}: the els.in has no line {old!r}")
        els_in = els_in.replace(old, f'ccsd_precision = "{precision}"')
        with tempfile.TemporaryDirectory() as tmp:
            wd = Path(tmp)
            for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
                shutil.copy(PVTZ / f, wd / f)
            (wd / "eri.dat").symlink_to(PVTZ_ERI)
            run = run_driver(wd, els_in, spinorb, f64_triples=not spinorb)
            if spinorb:
                run["spinorb_triples"] = spinorb_triples_f64(run)
        out = {
            "source": f"tools/make_torch_dimer_fixture.py --pvtz --precision {precision}",
            "jax_version": jax.__version__,
            "jax_backend": jax.default_backend(),
            "inputs": {"dir": str(PVTZ.relative_to(REPO)),
                       "eri": str(PVTZ_ERI.relative_to(REPO))},
            "els_in": els_in,
        } | run
        out["walls_s"] = {f"driver_{precision}": out.pop("wall_s")}
        write(PVTZ / name, out)
    return 0


def engine_eri(d: Path, eri_npy: Path | None) -> tuple[np.ndarray, int, float | None]:
    """The packed ERIs of `d`/geom.dat in cc-pVTZ from the JAX engine,
    or those of `eri_npy` when that file exists (written by an earlier
    run with the same option; no wall then)."""
    from afesp_tpu.integrals.engine import build_basis, eri_tensor
    from afesp_tpu.io.dat import read_geometry
    from afesp_tpu.ops.packed_eri import pack_eri

    _, charges, coords = read_geometry(d / "geom.dat")
    basis = build_basis(charges, coords, "cc-pvtz")
    if eri_npy is not None and eri_npy.exists():
        packed = np.load(eri_npy)
        print(f"read {eri_npy}: {packed.size} packed values", flush=True)
        return packed, basis.nbf, None
    t0 = time.perf_counter()
    packed = pack_eri(eri_tensor(basis))
    eri_s = time.perf_counter() - t0
    print(f"eri_tensor: {basis.nbf} bf, {packed.size} packed values, {eri_s:.1f} s",
          flush=True)
    if eri_npy is not None:
        np.save(eri_npy, packed)
    return packed, basis.nbf, eri_s


def spinorb_triples_f64(run: dict) -> dict:
    """E(T) of JAX's f64 spin-orbital tier on the amplitudes the driver
    converged (its CPU default is the f32 "hybrid" tier)."""
    from afesp_tpu.methods.triples_spinorb import do_ccsd_t_spinorb

    cc, res, hf = run.pop("_cc"), run.pop("_res"), run.pop("_hf")
    t0 = time.perf_counter()
    e = do_ccsd_t_spinorb(res.sys, cc, res.cfg, hf.levels, precision="f64")
    return {"block_vvvv": cc.slices.vvvv is None,
            "e_t_f64": float(e) - float(cc.e_ccsd),
            "e_t_driver": float(res.e_ccsd_t) - float(cc.e_ccsd),
            "triples_f64_s": time.perf_counter() - t0}


def main() -> int:
    args = sys.argv[1:]
    precision = args[args.index("--precision") + 1] if "--precision" in args else "f64"
    stream = "--stream" in args
    if stream:
        os.environ["AFESP_FORCE_STREAM"] = "1"
        precision = "hybrid"
    if precision not in ("f64", "hybrid"):
        raise SystemExit(f"--precision {precision!r}: f64 or hybrid")
    if "--pvtz" in args:
        return pvtz_hybrid(precision) if precision != "f64" else pvtz_sample()
    import jax

    jax.config.update("jax_platforms", "cpu")
    d, out_path = DIMER, OUT
    if "--trimer" in args:
        d, out_path = TRIMER, TRIMER / "expected_jax_cpu_crccsd_t_spatial.json"
    spinorb = "--spinorb" in args
    if spinorb:
        out_path = DIMER / "expected_jax_cpu_ccsd_t_spinorb.json"
    if precision != "f64":
        tag = "stream" if stream else precision
        out_path = out_path.with_name(f"{out_path.stem}_{tag}.json")
    eri_npy = Path(args[args.index("--eri-npy") + 1]) if "--eri-npy" in args else None
    packed, nbf, eri_s = engine_eri(d, eri_npy)
    out = {
        "source": "tools/make_torch_dimer_fixture.py " + " ".join(
            a for a in args
            if a in ("--trimer", "--spinorb", "--hybrid", "--eager-ccsd", "--stream"))
        + (f" --precision {precision}" if precision != "f64" and not stream else ""),
        "jax_version": jax.__version__,
        "jax_backend": jax.default_backend(),
        "inputs": {"dir": str(d.relative_to(REPO)),
                   "geometry": "geom.dat of that directory", "basis": "cc-pvtz",
                   "eri": "eri_tensor of the JAX engine, packed (pack_eri) as eri.npy"},
        "nbasis": nbf,
        "eri_sample": eri_sample(packed),
        "walls_s": {"eri_tensor": eri_s},
    }
    write(out_path, out)
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
            shutil.copy(d / f, wd / f)
        np.save(wd / "eri.npy", packed)
        del packed
        els_in = els_in_at(d, precision, spinorb)
        run = run_driver(wd, els_in, spinorb,
                         f64_triples=precision != "f64" and not spinorb,
                         eager_ccsd="--eager-ccsd" in args,
                         default_triples=not stream)
        print(json.dumps({k: run[k] for k in ("scf_iterations", "cc_iterations",
                                              "wall_s")}), flush=True)
        if spinorb:
            run["spinorb_triples"] = spinorb_triples_f64(run)
        out |= {"els_in": els_in} | run
        out["walls_s"][f"driver_{precision}"] = out.pop("wall_s")
        write(out_path, out)
        if "--hybrid" in args and precision == "f64":
            hyb = run_driver(wd, els_in_at(d, "hybrid", spinorb), spinorb)
            out["hybrid_cross_check"] = {
                k: hyb[k] for k in ("breakdown_values", "scf_iterations",
                                    "cc_iterations", "wall_s")}
            write(out_path, out)
    return 0


def write(path: Path, out: dict) -> None:
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path.relative_to(REPO)} ({path.stat().st_size} bytes)", flush=True)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["AFESP_JAX_CACHE"] = ""
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())
