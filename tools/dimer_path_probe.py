"""Time the water dimer's restricted paths on the card, for one package tree.

    python3 tools/dimer_path_probe.py --make-inputs WD
    python3 tools/dimer_path_probe.py --workdir WD [--src-dir DIR] [--reps N] [--stream]

--make-inputs writes the 116-bf water dimer (cc-pVTZ) into WD with this
checkout's engine on the card: s/t/v.dat, geom.dat, a packed eri.npy and
the committed els.in (`CRCCSD(T)_spatial` at `ccsd_precision =
"hybrid"`).  --workdir runs that directory through `run_calculation` of
the afesp_tpu_torch package found in DIR (default: this checkout) N
times in one process (default 3; `--stream` sets AFESP_FORCE_STREAM=1
for the streaming-slices tier) and prints one JSON line a run: the
path's wall, each stage's wall from the report, the CC iterations, ms a
CC iteration, and the card's peak memory.  The package builds its
kernels before the first run, outside the timed walls.

To compare two trees on one card, unpack the other with `git archive`
under `_fresh/` (gitignored), make the inputs once, and run the probe
from each in turn, parent, change, change, parent.  Needs a CUDA
device; the JAX package is not imported.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DIMER = REPO / "data" / "h2o-dimer-cc-pvtz"
STAGES = {"rhf": "restricted Hartree-Fock", "mp2": "restricted MP2",
          "ccsd": "restricted CCSD:", "triples": "restricted completely renormalised"}


def make_inputs(wd: Path) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from afesp_tpu_torch.integrals import engine as E
    from afesp_tpu_torch.integrals.generate import write_dat_files
    from afesp_tpu_torch.io import dat

    dev = torch.device("cuda", 0)
    wd.mkdir(parents=True, exist_ok=True)
    _, charges, coords = dat.read_geometry(DIMER / "geom.dat")
    basis = write_dat_files(wd, charges, coords, "cc-pvtz", write_eri=False, device=dev)
    np.save(wd / "eri.npy", E.eri_packed(basis, dev).cpu().numpy())
    shutil.copy(DIMER / "els.in", wd / "els.in")
    print(json.dumps({"inputs": str(wd), "nbasis": basis.nbf}), flush=True)


def stage_wall(text: str, label: str) -> float:
    line = next(ln for ln in text.splitlines() if "Time taken for" in ln and label in ln)
    return float(line.rsplit(None, 1)[1].rstrip("s"))


def probe(wd: Path, src: Path, reps: int, stream: bool) -> None:
    if stream:
        os.environ["AFESP_FORCE_STREAM"] = "1"
    sys.path.insert(0, str(src))
    import torch

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.ops import _build

    names = [p.stem for p in _build.CSRC.glob("*.cu")]
    t0 = time.perf_counter()
    _build.build(names)
    build_s = time.perf_counter() - t0
    for rep in range(reps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        t0 = time.perf_counter()
        res = run_calculation(wd, Reporter(stream=buf))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        walls = {k: stage_wall(text, label) for k, label in STAGES.items()}
        prelude = re.search(r"Device SCF prelude: (\d+) iterations", text)
        print(json.dumps({
            "src": str(src), "run": rep, "stream": stream, "wall_s": round(wall, 4),
            "stage_walls_s": walls, "cc_iterations": res.cc.iterations,
            "cc_iter_ms": round(1e3 * walls["ccsd"] / res.cc.iterations, 3),
            "prelude_iterations": int(prelude.group(1)) if prelude else None,
            "peak_memory_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3),
            "total_energy": res.total_energy, "build_s": round(build_s, 3)}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--make-inputs", type=Path, help="write the dimer's inputs into this directory")
    p.add_argument("--workdir", type=Path, help="a directory the inputs were written into")
    p.add_argument("--src-dir", type=Path, default=REPO, help="the tree whose package runs")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--stream", action="store_true", help="run the streaming-slices tier")
    args = p.parse_args(argv)
    if args.make_inputs:
        make_inputs(args.make_inputs)
    if args.workdir:
        probe(args.workdir, args.src_dir.resolve(), args.reps, args.stream)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
