"""Port parity: both slices through afesp_tpu_torch.run_calculation
against the JAX driver on the generated 24-bf H2O, on the CPU — the
spin-orbital CCSD(T) and every restricted calc_type — plus the CLI's
error path and what the port refuses."""

import functools
import io

import pytest
import torch
from torch_fixtures import breakdown_block, table_energies, write_els_in, write_h2o

import afesp_tpu.driver as jdriver
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods.triples_spatial import do_ccsd_t_spatial as jax_ccsd_t_spatial
from afesp_tpu.methods.triples_spinorb import do_ccsd_t_spinorb as jax_ccsd_t
from afesp_tpu_torch.cli import main as cli_main
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


def _run_jax(wd, triples_f64: bool = False):
    rep = JaxReporter(stream=io.StringIO())
    if triples_f64:
        # on the CPU the JAX driver's default triples tier is "hybrid"
        # (f32 panel GEMMs, ~4e-11 Ha off f64 here); the port's is f64
        patched = functools.partial(jax_ccsd_t, precision="f64")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jdriver, "do_ccsd_t_spinorb", patched)
            res = jdriver.run_calculation(wd, rep)
    else:
        res = jdriver.run_calculation(wd, rep)
    return res, rep.stream.getvalue()


def _run_port(wd):
    rep = Reporter(stream=io.StringIO())
    res = run_calculation(wd, rep, device="cpu")
    return res, rep.stream.getvalue()


@pytest.fixture(scope="module")
def port_run(h2o):
    return _run_port(h2o)


def test_breakdown_matches_jax_driver(h2o, port_run):
    """The breakdown block equals the JAX driver's (its triples at f64)
    in every printed digit, with equal SCF and CC iteration counts."""
    jres, jtext = _run_jax(h2o, triples_f64=True)
    res, text = port_run
    assert breakdown_block(text) == breakdown_block(jtext)
    assert len(breakdown_block(text)) == 12
    for header in ("delta RMS D", "delta RMS T2"):
        assert len(table_energies(text, header)) == len(table_energies(jtext, header))
    assert abs(res.total_energy - jres.total_energy) < 1e-10


def test_totals_match_jax_default_driver(h2o, port_run):
    """Against the JAX driver exactly as it runs on the CPU (hybrid
    triples): every total within 1e-8 Ha, equal iteration counts."""
    jres, jtext = _run_jax(h2o)
    res, text = port_run
    for key in ("e_hf", "e_mp2", "e_ccsd", "e_ccsd_t"):
        assert abs(getattr(res, key) - getattr(jres, key)) < 1e-8, key
    assert abs(res.total_energy - jres.total_energy) < 1e-8
    assert res.hf.iterations == len(table_energies(jtext, "delta RMS D"))
    assert res.cc.iterations == len(table_energies(jtext, "delta RMS T2"))
    labels = [ln.split(":")[0] for ln in text.split("\n") if "Time taken for" in ln]
    jlabels = [ln.split(":")[0] for ln in jtext.split("\n") if "Time taken for" in ln]
    assert labels == jlabels


@pytest.mark.parametrize("calc", ["RHF", "UHF", "MP2_spatial", "MP2_spinorb", "CCSD_spinorb"])
def test_short_pipelines_match_jax(tmp_path, h2o, calc):
    for f in h2o.iterdir():
        (tmp_path / f.name).symlink_to(f)
    (tmp_path / "els.in").unlink()
    write_els_in(tmp_path, calc)
    _, jtext = _run_jax(tmp_path)
    _, text = _run_port(tmp_path)
    assert breakdown_block(text) == breakdown_block(jtext)


@pytest.mark.parametrize(
    "calc,extra,eri_npy_only", [("CRCCSD(T)_spatial", "mesh_devices = 2,\n", False),
                                ("CCSD_spatial", "", True),
                                ("CCSD(T)_spinorb", "mesh_devices = 2,\n", False)],
)
def test_unported_paths_raise(tmp_path, h2o, calc, extra, eri_npy_only):
    for f in h2o.iterdir():
        if eri_npy_only and f.name == "eri.dat":
            # the JAX package's binary ERI tier; the port reads text only
            (tmp_path / "eri.npy").write_bytes(b"")
        else:
            (tmp_path / f.name).symlink_to(f)
    (tmp_path / "els.in").unlink()
    write_els_in(tmp_path, calc, extra)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_calculation(tmp_path, Reporter(stream=io.StringIO()), device="cpu")
    assert cli_main([str(tmp_path), "--device", "cpu"]) == 999


RESTRICTED = ["RHF", "MP2_spatial", "CCSD_spatial", "CCSD[T]_spatial", "CCSD(T)_spatial",
              "RCCSD[T]_spatial", "RCCSD(T)_spatial", "CRCCSD[T]_spatial",
              "CRCCSD(T)_spatial"]


def _stage(tmp_path, h2o, calc, extra=""):
    for f in h2o.iterdir():
        if f.name != "els.in":
            (tmp_path / f.name).symlink_to(f)
    write_els_in(tmp_path, calc, extra)
    return tmp_path


@pytest.mark.parametrize("calc", RESTRICTED)
def test_restricted_calc_types_match_jax(tmp_path, h2o, calc, capsys):
    """Each of the nine restricted calc_types through the port's driver
    and CLI: the breakdown block equals the JAX driver's (its triples at
    f64, what ccsd_precision="f64" selects there) line for line, with
    equal SCF and CC iteration counts and the same stage-time labels."""
    wd = _stage(tmp_path, h2o, calc)
    jres, jtext = _run_jax(wd)
    res, text = _run_port(wd)
    assert breakdown_block(text) == breakdown_block(jtext)
    assert abs(res.total_energy - jres.total_energy) < 1e-10
    for header in ("delta RMS D", "delta RMS T2"):
        if header in jtext:
            assert len(table_energies(text, header)) == len(table_energies(jtext, header))
    labels = [ln.split(":")[0] for ln in text.split("\n") if "Time taken for" in ln]
    jlabels = [ln.split(":")[0] for ln in jtext.split("\n") if "Time taken for" in ln]
    assert labels == jlabels
    capsys.readouterr()
    assert cli_main([str(wd), "--device", "cpu"]) == 0
    assert breakdown_block(capsys.readouterr().out) == breakdown_block(text)


def test_restricted_totals_match_jax_hybrid_triples(tmp_path, h2o, port_run_cr):
    """Against the JAX driver with its spatial triples at "hybrid" (f32
    panel GEMMs, what its CPU runs use with ccsd_precision="hybrid"):
    every triples value and the total within 1e-8 Ha."""
    wd = _stage(tmp_path, h2o, "CRCCSD(T)_spatial")
    rep = JaxReporter(stream=io.StringIO())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdriver, "do_ccsd_t_spatial",
                   functools.partial(jax_ccsd_t_spatial, precision="hybrid"))
        jres = jdriver.run_calculation(wd, rep)
    res, _ = port_run_cr
    assert jres.triples.precision_used == "hybrid"
    for key in ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
                "e_crccsd_tt", "D_T", "D_TT"):
        assert abs(getattr(res.triples, key) - getattr(jres.triples, key)) < 1e-8, key
    assert abs(res.total_energy - jres.total_energy) < 1e-8


@pytest.fixture(scope="module")
def port_run_cr(h2o, tmp_path_factory):
    return _run_port(_stage(tmp_path_factory.mktemp("cr"), h2o, "CRCCSD(T)_spatial"))


@pytest.mark.parametrize("compat", [False, True])
def test_bug_compat_through_the_driver(tmp_path, h2o, compat):
    """ccsd_t_spatial_bug_compat on and off for plain CCSD(T)_spatial: the
    breakdown equals the JAX driver's, and with the flag the CCSD(T) line
    repeats the CCSD[T] value, as the reference prints it."""
    extra = f"ccsd_t_spatial_bug_compat = {'.true.' if compat else '.false.'},\n"
    wd = _stage(tmp_path, h2o, "CCSD(T)_spatial", extra)
    _, jtext = _run_jax(wd)
    res, text = _run_port(wd)
    assert breakdown_block(text) == breakdown_block(jtext)
    assert (res.triples.e_ccsd_tt == res.triples.e_ccsd_t) == compat


def test_cli_error_path_exits_999(tmp_path, capsys):
    assert cli_main([str(tmp_path), "--device", "cpu"]) == 999
    err = capsys.readouterr().err
    assert " ERROR." in err and "els.in does not exist" in err and " EXITING..." in err


def test_cli_runs_the_slice(h2o, port_run, capsys):
    assert cli_main([str(h2o), "--device", "cpu"]) == 0
    assert breakdown_block(capsys.readouterr().out) == breakdown_block(port_run[1])


def test_entry_points_need_a_card_unless_told(h2o):
    """With no device the port runs on cuda:0 or raises; it never drops to
    the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run_calculation() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_calculation(h2o, Reporter(stream=io.StringIO()))
    assert cli_main([str(h2o)]) == 999
