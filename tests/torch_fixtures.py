"""Inputs shared by the tests of the PyTorch port (tests/test_torch_*.py).

Fixtures are generated into a temporary directory by the JAX package's
integral engine (never into data/); random triples problems are made
with numpy from a seed, so both packages get the same arrays.
"""

from __future__ import annotations

import io
import re
from pathlib import Path

import numpy as np
import torch

# The suite runs several pytest workers on a few cores: one torch thread
# each keeps them from oversubscribing (the port's test shapes are tiny).
torch.set_num_threads(1)

ELS_IN = """&elsinput
calc_type="{calc}",
scf_e_tol=1e-9,
scf_d_tol=1e-8,
ccsd_e_tol=1e-9,
ccsd_t_tol=1e-8,
{extra}/
"""


def write_h2o(directory: Path, calc: str = "CCSD(T)_spinorb", extra: str = "") -> Path:
    """The 24-bf H2O/cc-pVDZ fixture at the geometry of the reference's
    h2o-cc-pvdz sample (1.80 A, 104.45 deg), plus an els.in."""
    from afesp_tpu.integrals.generate import write_dat_files
    from afesp_tpu.utils.wrapper import water_geometry

    directory.mkdir(parents=True, exist_ok=True)
    charges, coords = water_geometry(1.80, 104.45)
    write_dat_files(directory, charges, coords, "cc-pvdz")
    write_els_in(directory, calc, extra)
    return directory


def write_els_in(directory: Path, calc: str, extra: str = "") -> None:
    (directory / "els.in").write_text(ELS_IN.format(calc=calc, extra=extra))


def reporter_pair():
    """A JAX and a port Reporter, each writing into its own buffer."""
    from afesp_tpu.io.report import Reporter as JaxReporter

    from afesp_tpu_torch.io.report import Reporter

    return JaxReporter(stream=io.StringIO()), Reporter(stream=io.StringIO())


_ROW = re.compile(r"^\s+(\d+)\s+(-?\d+\.\d+)\s+(-?\d+\.\d+)\s+(-?\d+\.\d+)")


def table_energies(text: str, header: str) -> list[float]:
    """The Energy column of the iteration table that follows `header`
    (numbered rows only; the CC table's MP1 row is skipped)."""
    lines = text.split("\n")
    start = next(i for i, ln in enumerate(lines) if header in ln)
    out = []
    for ln in lines[start + 2 :]:
        if ln.startswith("---"):
            if out:
                break
            continue
        m = _ROW.match(ln)
        if m:
            out.append(float(m.group(2)))
    return out


def breakdown_block(text: str) -> list[str]:
    lines = text.split("\n")
    start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
    out = []
    for line in lines[start:]:
        out.append(line.rstrip())
        if line.lstrip().startswith("Total energy:"):
            break
    return out


def random_triples_problem(o: int, v: int, seed: int = 7):
    """Antisymmetry-respecting random (T) inputs, numpy f64, in the
    argument order (t1, t2, vovv, ovoo, oovv, e_o, e_v) — the generator
    of tests/test_triples_pallas.py."""
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
    return t1, t2, vovv, ovoo, oovv, e[:o], e[o:]


def random_spatial_problem(o: int, v: int, seed: int = 11):
    """Random restricted-triples inputs, numpy f64, in the argument order
    (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv'', I_ooov'') — the
    generator of tests/test_triples_tiled.py.  t2 and v_oovv carry the
    pair-exchange symmetry X[i,j,a,b] = X[j,i,b,a] that the sorted-triple
    orbit identity of the z3/y sums needs."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s) * 0.02
    sym = lambda x: (x + x.transpose(1, 0, 3, 2)) / 2
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    return (
        r(o, v), sym(r(o, o, v, v)),
        r(v, v, o, v), r(o, o, v, o), sym(r(o, o, v, v)),
        e[:o], e[o:],
        r(v, o, v, v), r(o, o, o, v),
    )
