"""The readings the correctness limits are set from, on the card, at a
cell's own size.  Not part of a benchmark run.

    python3 gpubench/readings.py --workload <cell> --seeds 1,2,3 [--calcs 2]
        [--controls program:triples=hybrid,reference:fock=float32,...]
        [--expected <json>]

Each seed here is a displacement draw: a geometry of its own.  For each,
in one process: its inputs, `--calcs` calculations of the program back
to back (as in the window), the f64 reference, and each control put in
the program's place.  A control is one layer in a lower precision:

  program:triples=<tier>        the program, its (T) run at that tier
                                (`do_ccsd_t_spinorb` for a _spinorb calc
                                type, else `do_ccsd_t_spatial`; "hybrid":
                                f32 panels, and the f32 CR chain)
  program:<els key>=<value>     the program with that els.in key
                                (ccsd_precision=hybrid: digit-GEMM CCSD)
  reference:<stage>=<dtype>     the reference with one stage in that dtype
                                (fock, corr, triples, and cr in
                                `reference/rccsd_t`)

One JSON line a seed: each compared number's gap, and each value's, for
every program calculation and each control; at the end the lower
reading of each number (the largest program gap over the seeds), each
control's smallest gap, and the upper reading (the smallest control gap
that is three times the lower or more).  `--expected` also holds the f64
reference to a committed JSON of JAX's values (seed 0: the committed
geometry).
"""

from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import shutil
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from gpubench import run  # noqa: E402
from gpubench.harness import answers, spec  # noqa: E402
from gpubench.harness.patch import Patches  # noqa: E402

TRIPLES_TARGETS = {"spatial": "afesp_tpu_torch.driver:do_ccsd_t_spatial",
                   "spinorb": "afesp_tpu_torch.driver:do_ccsd_t_spinorb"}


def triples_target(calc_type: str) -> str:
    """The program's (T) function of the calc type's formulation."""
    return TRIPLES_TARGETS["spinorb" if calc_type.endswith("_spinorb") else "spatial"]


def expected_values(path: Path) -> dict:
    """The breakdown of a committed JSON of JAX's values; a spin-orbital
    one's CCSD(T) is its CCSD and its f64 (T) (`spinorb_triples.e_t_f64`)."""
    want = json.loads(Path(path).read_text())
    out = {"e_hf": want["e_hf_total"], "e_mp2": want["e_mp2_corr"],
           "e_ccsd": want["e_ccsd_corr"]}
    if "spinorb_triples" in want:
        return out | {"e_ccsd_tt": want["e_ccsd_corr"] + want["spinorb_triples"]["e_t_f64"]}
    return out | want["triples"]


def value_gaps(got: dict, ref: dict) -> dict:
    return {k: abs(got[k] - ref[k]) if k in got else math.inf
            for keys in answers.GROUPS.values() for k in keys if k in ref}


def run_control(s: run.Session, draw: int, control: str) -> dict:
    """The breakdown values of one control on geometry `draw`."""
    import torch

    side, _, setting = control.partition(":")
    key, _, value = setting.partition("=")
    if side == "reference":
        return s.reference(draw, lower={key: getattr(torch, value)})
    if side == "program" and key == "triples":
        with Patches() as patches:
            patches.wrap_everywhere(triples_target(s.cell.traffic["calc_type"]),
                                    lambda fn: functools.partial(fn, precision=value))
            return s.calc(draw)
    if side == "program":
        return s.calc(draw, els_in=s.cell.els_in(**{key: value}))
    raise ValueError(f"no control {control!r}")


def summary(lower: dict, controls: dict) -> dict:
    """Each number's upper reading: the smallest control gap that is
    three times its lower reading or more (None where there is none)."""
    upper = {}
    for name, low in lower.items():
        ok = [c[name] for c in controls.values() if name in c and c[name] >= 3 * low]
        upper[name] = min(ok) if ok else None
    return upper


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calcs", type=int, default=1)
    p.add_argument("--controls", default="")
    p.add_argument("--expected", default=None)
    args = p.parse_args(argv)
    import torch

    cell = spec.load_cell(HERE.parent, args.workload)
    dev = torch.device("cuda", 0)
    controls = [c for c in args.controls.split(",") if c]
    lower: dict = {}
    per_control: dict = {c: {} for c in controls}
    tmp = Path(tempfile.mkdtemp(prefix="gpubench-readings-"))
    try:
        s = run.Session(cell, dev, tmp)
        s.prebuild()
        for draw in [int(x) for x in args.seeds.split(",")]:
            s.make_inputs(draw)
            t = time.perf_counter()
            got = [s.calc(draw) for _ in range(args.calcs)]
            walls = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            ref = s.reference(draw)
            line = {"seed": draw, "calcs_s": walls, "reference_s": time.perf_counter() - t,
                    "iterations": [[v.get("scf_iterations"), v.get("cc_iterations")] for v in got],
                    "reference_iterations": [ref.get("scf_iterations"), ref.get("cc_iterations")],
                    "program": [answers.gaps(v, ref) for v in got],
                    "program_values": value_gaps(got[0], ref)}
            for g in line["program"]:
                for k, x in g.items():
                    lower[k] = max(lower.get(k, 0.0), x)
            for c in controls:
                gc.collect()
                torch.cuda.empty_cache()
                t = time.perf_counter()
                try:
                    ctl = run_control(s, draw, c)
                except Exception as e:  # a control that fails sets no upper end
                    line[c] = {"error": repr(e)[:300]}
                    continue
                g = answers.gaps(ctl, ref)
                line[c] = {"s": time.perf_counter() - t, "gaps": g,
                           "values": value_gaps(ctl, ref),
                           "iterations": [ctl.get("scf_iterations"), ctl.get("cc_iterations")]}
                for k, x in g.items():
                    per_control[c][k] = min(per_control[c].get(k, math.inf), x)
            if args.expected:
                want = expected_values(Path(args.expected))
                line["reference_vs_expected"] = {k: ref[k] - want[k] for k in want if k in ref}
            print(json.dumps(line), flush=True)
            shutil.rmtree(s.inputs(draw), ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "controls": per_control,
                      "upper": summary(lower, per_control), "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
