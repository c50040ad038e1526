"""Time the port's spin-orbital CCSD iteration on the card.

    python3 tools/ccsd_iter_probe.py [--src-dir DIR] [--reps N] [--dimer]

Runs `CCSD(T)_spinorb` through `run_calculation` of the afesp_tpu_torch
package found in DIR (default: this checkout) on the committed
H2O/cc-pVTZ inputs (`data/h2o-cc-pvtz-2.00_104.45/` with
`data/h2o-cc-pvtz/eri.dat`), N times in one process (default 3), and
prints one JSON line a run: the path's wall, the CCSD stage's wall, its
iterations and milliseconds per iteration.

With --dimer it then builds the water dimer's ERIs (cc-pVTZ, 116 bf)
with that package's engine and runs the dimer as `CCSD(T)_spinorb` at
`ccsd_precision = "f64"` (20 occupied, 212 virtual spin orbitals): once
as the package decides, and, where the package has the block-compressed
vvvv store (`_BLOCK_VVVV_BYTES`), once more with the dense slice
(16.2 GB) forced by lifting that rule.  Each line says which store ran,
and the card's peak memory.

To compare two trees on one card, unpack the other with `git archive`
under `_fresh/` (gitignored) and run the probe from each in turn,
parent, change, change, parent.  Needs a CUDA device; the JAX package is
not imported.
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PVTZ = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
PVTZ_ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"
DIMER = REPO / "data" / "h2o-dimer-cc-pvtz"


def ccsd_line(label: str, res, text: str, wall: float, torch) -> dict:
    line = next(ln for ln in text.splitlines() if "Time taken for unrestricted CCSD:" in ln)
    ccsd_s = float(line.rsplit(None, 1)[1].rstrip("s"))
    out = {"run": label, "wall_s": round(wall, 4), "ccsd_s": ccsd_s,
           "cc_iterations": res.cc.iterations,
           "ccsd_ms_per_iteration": round(1e3 * ccsd_s / res.cc.iterations, 3),
           "e_ccsd_t": res.e_ccsd_t,
           "vvvv": "dense" if getattr(res.cc.slices, "vvvv", None) is not None else "blocks",
           "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    print(json.dumps(out), flush=True)
    return out


def run(torch, run_calculation, Reporter, wd: Path, label: str) -> None:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    res = run_calculation(wd, Reporter(stream=buf))
    torch.cuda.synchronize()
    ccsd_line(label, res, buf.getvalue(), time.perf_counter() - t0, torch)
    del res
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src-dir", type=Path, default=REPO)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dimer", action="store_true")
    a = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ccsd_iter_probe: needs a CUDA device", file=sys.stderr)
        return 1
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(a.src_dir.resolve()))
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io import dat
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import ccsd_spinorb as CS

    print(json.dumps({"src_dir": str(a.src_dir), "device": torch.cuda.get_device_name(0)}),
          flush=True)
    wd = Path(tempfile.mkdtemp(prefix="afesp_ccsd_probe_"))
    try:
        for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
            shutil.copy(PVTZ / f, wd / f)
        (wd / "eri.dat").symlink_to(PVTZ_ERI)
        for k in range(a.reps):
            run(torch, run_calculation, Reporter, wd, f"pvtz {k}")
        if a.dimer:
            from afesp_tpu_torch.integrals import engine as E

            shutil.rmtree(wd)
            wd.mkdir()
            for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
                shutil.copy(DIMER / f, wd / f)
            _, charges, coords = dat.read_geometry(DIMER / "geom.dat")
            packed = E.eri_packed(E.build_basis(charges, coords, "cc-pvtz"), "cuda")
            np.save(wd / "eri.npy", packed.cpu().numpy())
            del packed
            els = (DIMER / "els.in").read_text()
            els = els.replace('calc_type="CRCCSD(T)_spatial"', 'calc_type="CCSD(T)_spinorb"')
            els = els.replace('ccsd_precision = "hybrid"', 'ccsd_precision = "f64"')
            (wd / "els.in").write_text(els)
            run(torch, run_calculation, Reporter, wd, "dimer, the package's rule")
            if hasattr(CS, "_BLOCK_VVVV_BYTES"):
                CS._BLOCK_VVVV_BYTES = float("inf")
                run(torch, run_calculation, Reporter, wd, "dimer, dense forced")
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
