"""Port parity: the digit-GEMM ("hybrid") CCSD of both formulations
through afesp_tpu_torch.run_calculation against the JAX driver at
ccsd_precision = "hybrid" on the generated 24-bf H2O, on the CPU.

For CCSD_spatial, CRCCSD(T)_spatial and CCSD_spinorb with the "code" and
the "paper" equations: CCSD correlation within 1e-10 Ha, equal SCF and
CC iteration counts, the same arithmetic (the JAX driver's hybrid solver
and the port's precision_used "hybrid"), and the whole report equal line
for line with the timings and dates masked.  The report prints energies
to twelve decimals, and the two arithmetics agree to ~1e-11 (a digit of
an in-loop operand can round the other way when its f64 input differs
in the last bit), so a last printed digit can differ: the numbers of
each line are compared within 1e-10, the rest of the line as text.  Both
drivers' triples run at f64 (each driver's do_ccsd_t_spatial is called
with precision="f64"): their CPU tier at ccsd_precision = "hybrid" is
the f32 one, held in tests/test_torch_triples_hybrid.py."""

import functools
import io
import re

import pytest
import torch
from torch_fixtures import table_energies, write_els_in, write_h2o

import afesp_tpu.driver as jdriver
import afesp_tpu_torch.driver as tdriver
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import ccsd_spatial as jsp
from afesp_tpu.methods import ccsd_spinorb as jso
from afesp_tpu.methods.triples_spatial import do_ccsd_t_spatial as jax_ccsd_t_spatial
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import ccsd_spatial as tsp
from afesp_tpu_torch.methods import ccsd_spinorb as tso
from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial as port_ccsd_t_spatial

HYBRID = 'ccsd_precision = "hybrid",\n'
CASES = [("CCSD_spatial", ""), ("CRCCSD(T)_spatial", ""),
         ("CCSD_spinorb", 'ccsd_spinorb_equations = "code",\n'),
         ("CCSD_spinorb", 'ccsd_spinorb_equations = "paper",\n')]

_TIME = re.compile(r"(Time taken[^:]*:|Total execution time:)\s*[-\d.]+")
_DATE = re.compile(r"running on \S+ at \S+")
_ROW = re.compile(r"^(\s+(?:\d+|MP1)(?:\s+-?\d+\.\d+){3})\s+\d+\.\d+$")
_NUM = re.compile(r"-?\d+\.\d+(?:[eE][-+]?\d+)?")


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


def _masked(text: str) -> tuple[list[str], list[list[float]]]:
    """The report with timings (stage times, the iteration tables' time
    column) and dates masked, and each line's numbers taken out
    (returned separately)."""
    lines, nums = [], []
    for ln in text.split("\n"):
        ln = _DATE.sub("running on <date>", _TIME.sub(r"\1 <t>", ln))
        ln = _ROW.sub(r"\1 <t>", ln)
        nums.append([float(x) for x in _NUM.findall(ln)])
        lines.append(_NUM.sub("<n>", ln))
    return lines, nums


def _jax_run(wd):
    """The JAX driver, its spatial triples at f64, with the CC solver it
    picked caught on the way."""
    picked = []
    sp_get, so_get = jsp.get_spatial_solver, jso.get_spinorb_solver
    rep = JaxReporter(stream=io.StringIO())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdriver, "do_ccsd_t_spatial",
                   functools.partial(jax_ccsd_t_spatial, precision="f64"))
        mp.setattr(jsp, "get_spatial_solver", lambda **k: picked.append(sp_get(**k)) or picked[-1])
        mp.setattr(jso, "get_spinorb_solver", lambda **k: picked.append(so_get(**k)) or picked[-1])
        res = jdriver.run_calculation(wd, rep)
    return res, rep.stream.getvalue(), picked


@pytest.mark.parametrize("calc,extra", CASES,
                         ids=["CCSD_spatial", "CRCCSD(T)_spatial", "spinorb_code", "spinorb_paper"])
def test_hybrid_ccsd_matches_jax(tmp_path, h2o, calc, extra):
    for f in h2o.iterdir():
        if f.name != "els.in":
            (tmp_path / f.name).symlink_to(f)
    write_els_in(tmp_path, calc, HYBRID + extra)
    jres, jtext, picked = _jax_run(tmp_path)
    rep = Reporter(stream=io.StringIO())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdriver, "do_ccsd_t_spatial",
                   functools.partial(port_ccsd_t_spatial, precision="f64"))
        res = run_calculation(tmp_path, rep, device="cpu")
    text = rep.stream.getvalue()

    # the arithmetic: JAX's hybrid solver, the port's digit-GEMM iteration
    hybrid_solvers = (jsp.ccsd_spatial_solver_hybrid, jso.ccsd_spinorb_solver_hybrid,
                      jso.ccsd_spinorb_solver_paper_hybrid)
    assert picked and all(p in hybrid_solvers for p in picked)
    assert res.cc.precision_used == "hybrid"
    assert "CCSD arithmetic" not in text
    if calc == "CRCCSD(T)_spatial":
        assert res.triples.precision_used == jres.triples.precision_used == "f64"

    assert res.cc.converged
    assert abs(res.e_ccsd - jres.e_ccsd) < 1e-10
    assert res.cc.iterations == len(table_energies(jtext, "delta RMS T2"))
    assert res.hf.iterations == len(table_energies(jtext, "delta RMS D"))
    assert abs(res.total_energy - jres.total_energy) < 1e-10

    lines, nums = _masked(text)
    jlines, jnums = _masked(jtext)
    assert lines == jlines
    for got, want, line in zip(nums, jnums, lines):
        assert len(got) == len(want)
        assert all(abs(a - b) < 1e-10 for a, b in zip(got, want)), (line, got, want)


def test_solver_variants_match_jax():
    """The precision rule and the four spin-orbital solver variants: the
    hybrid ones digitize their constants once per solve (precompute),
    the f64 ones build none."""
    for vvvv_split in (False, True):
        assert (tsp.get_spatial_solver(vvvv_split=vvvv_split) is tsp.ccsd_spatial_solver_hybrid) \
            == vvvv_split
        for paper in (False, True):
            solver = tso.get_spinorb_solver(paper_foo=paper, vvvv_split=vvvv_split)
            want = {(False, False): tso.ccsd_spinorb_solver,
                    (True, False): tso.ccsd_spinorb_solver_paper,
                    (False, True): tso.ccsd_spinorb_solver_hybrid,
                    (True, True): tso.ccsd_spinorb_solver_paper_hybrid}[(paper, vvvv_split)]
            assert solver is want
    assert len({tso.get_spinorb_solver(paper_foo=p, vvvv_split=s)
                for p in (False, True) for s in (False, True)}) == 4


def test_precompute_runs_once_per_solve():
    """make_cc_solver's precompute hook is evaluated once per solve and
    its consts reach every iteration."""
    from afesp_tpu_torch.ops.cc_step import init_cc_state, make_cc_solver

    calls, seen = [], []

    def iteration(t1, t2, v, D_ia, D_ijab, consts):
        seen.append(consts)
        return 0.5 * t1, 0.5 * t2

    def energy(t1, t2, t2_old, oovv):
        return t2.sum(), ((t2 - t2_old) ** 2).sum()

    solve = make_cc_solver(iteration, energy, precompute=lambda v: calls.append(v) or "consts")
    t1, t2 = torch.ones(2, 3, dtype=torch.float64), torch.ones(2, 2, 3, 3, dtype=torch.float64)
    state, energies, converged = solve(init_cc_state(t1, t2, 4), "v", None, None, None, 36.0,
                                       1e-30, 1e-30, nerr=4, maxiter=5)
    assert calls == ["v"] and len(energies) >= 2 and seen == ["consts"] * len(energies)
