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


_TIME = re.compile(r"(Time taken[^:]*:|Total execution time:)\s*[-\d.]+")
_DATE = re.compile(r"running on \S+ at \S+")
_TROW = re.compile(r"^(\s+(?:\d+|MP1)(?:\s+-?\d+\.\d+){3})\s+\d+\.\d+$")
_NUM = re.compile(r"-?\d+\.\d+(?:[eE][-+]?\d+)?")


def masked_report(text: str):
    """The report with timings and dates masked, and each line's numbers
    taken out as (value, one unit of its last printed decimal)."""
    lines, nums = [], []
    for ln in text.split("\n"):
        ln = _DATE.sub("running on <date>", _TIME.sub(r"\1 <t>", ln))
        ln = _TROW.sub(r"\1 <t>", ln)
        nums.append([(float(x), 10.0 ** -len(x.split(".")[1].split("e")[0].split("E")[0]))
                     for x in _NUM.findall(ln)])
        # the padding before a number shifts with its sign
        lines.append(re.sub(r"\s*" + _NUM.pattern, " <n>", ln))
    return lines, nums


def write_n2(directory: Path) -> Path:
    """The 28-bf N2/cc-pVDZ fixture, bond 2.00 bohr (nvirt 21)."""
    from afesp_tpu.integrals.generate import write_dat_files

    directory.mkdir(parents=True, exist_ok=True)
    write_dat_files(directory, np.array([7, 7]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 2.0]]),
                    "cc-pvdz")
    return directory


def mesh_driver_parity(wd: Path, src: Path, calc: str, width: int, precision: str,
                       monkeypatch, sub_size=None, stream: bool = False):
    """Both drivers at mesh_devices = width on `src`'s inputs (staged in
    `wd`), the port's visible devices eight CPU entries, JAX's its eight
    CPU devices, both drivers' triples called at precision="f64", and the
    checks of tests/test_torch_parallel_*.py: the reports equal line for
    line with the timings masked, the mesh line included, each number
    within 1e-10 (or one unit of its last printed decimal), equal SCF and
    CC iteration counts, the totals and the restricted triples within
    1e-10; the CCSD ran on a sub-mesh of `sub_size` entries in both (None:
    on one device), or, with `stream`, the stream tier's limbs split over
    the whole mesh, 1/width of the bytes an entry.  Returns the port's
    result and report."""
    import functools

    import afesp_tpu.driver as jdriver
    from afesp_tpu.io.report import Reporter as JaxReporter
    from afesp_tpu.methods.triples_spatial import do_ccsd_t_spatial
    from afesp_tpu.methods.triples_spinorb import do_ccsd_t_spinorb
    from afesp_tpu.parallel import ccsd_shard as jcs

    import afesp_tpu_torch.driver as tdriver
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import triples_spatial as tts
    from afesp_tpu_torch.methods import triples_spinorb as tto
    from afesp_tpu_torch.parallel import ccsd_shard as tcs
    from afesp_tpu_torch.parallel import mesh as tmesh

    if stream:
        monkeypatch.setenv("AFESP_FORCE_STREAM", "1")
    for f in src.iterdir():
        if f.name != "els.in":
            (wd / f.name).symlink_to(f)
    extra = f"mesh_devices = {width},\n"
    if precision != "f64":
        extra += f'ccsd_precision = "{precision}",\n'
    write_els_in(wd, calc, extra)
    monkeypatch.setattr(tmesh, "visible_devices", lambda dev: [dev] * 8)
    jsub, tsub, tlimbs = [], [], []
    jfit, tfit, tshard = jcs._fitting_mesh, tcs._fitting_mesh, tcs.shard_vvvv_limbs
    monkeypatch.setattr(jcs, "_fitting_mesh", lambda m, n: jsub.append(jfit(m, n)) or jsub[-1])
    monkeypatch.setattr(tcs, "_fitting_mesh", lambda m, n: tsub.append(tfit(m, n)) or tsub[-1])
    monkeypatch.setattr(tcs, "shard_vvvv_limbs",
                        lambda m, b: tlimbs.append(tshard(m, b)) or tlimbs[-1])

    rep = JaxReporter(stream=io.StringIO())
    with monkeypatch.context() as mp:
        mp.setattr(jdriver, "do_ccsd_t_spatial",
                   functools.partial(do_ccsd_t_spatial, precision="f64"))
        mp.setattr(jdriver, "do_ccsd_t_spinorb",
                   functools.partial(do_ccsd_t_spinorb, precision="f64"))
        jres = jdriver.run_calculation(wd, rep)
    jtext = rep.stream.getvalue()
    rep = Reporter(stream=io.StringIO())
    with monkeypatch.context() as mp:
        mp.setattr(tdriver, "do_ccsd_t_spatial",
                   functools.partial(tts.do_ccsd_t_spatial, precision="f64"))
        mp.setattr(tdriver, "do_ccsd_t_spinorb",
                   functools.partial(tto.do_ccsd_t_spinorb, precision="f64"))
        res = run_calculation(wd, rep, device="cpu")
    text = rep.stream.getvalue()

    mesh_line = f" Using a {width}-device mesh for CC stages."
    assert text.count(mesh_line) == 1 and jtext.count(mesh_line) == 1
    assert res.cc.precision_used == ("f64" if precision == "f64" else "hybrid")
    if stream:
        assert res.cc.slices.v_vvvv is None and res.cc.cr_vvvv_term is not None
        # split once: the solve and the CR term read the same shards
        limbs = tlimbs[0]
        assert all(x is limbs for x in tlimbs) and limbs.mesh.size == width
        assert all(b * width == sum(limbs.nbytes()) for b in limbs.nbytes())
    else:
        sizes = [None if m is None else m.size for m in tsub]
        assert sizes and sizes == [None if m is None else m.devices.size for m in jsub]
        assert sizes[0] == sub_size

    assert res.hf.iterations == len(table_energies(jtext, "delta RMS D"))
    assert res.cc.iterations == len(table_energies(jtext, "delta RMS T2"))
    for key in ("e_hf", "e_mp2", "e_ccsd", "e_ccsd_t", "total_energy"):
        assert abs(getattr(res, key) - getattr(jres, key)) < 1e-10, key
    if res.triples is not None:
        for key in ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
                    "e_crccsd_tt", "D_T", "D_TT"):
            assert abs(getattr(res.triples, key) - getattr(jres.triples, key)) < 1e-10, key
    lines, nums = masked_report(text)
    jlines, jnums = masked_report(jtext)
    assert lines == jlines
    for got, want, line in zip(nums, jnums, lines):
        assert len(got) == len(want)
        assert all(abs(a - b) <= max(1e-10, 1.001 * u) for (a, u), (b, _) in zip(got, want)), \
            (line, got, want)
    return res, text
