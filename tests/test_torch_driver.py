"""Port parity: both slices through afesp_tpu_torch.run_calculation
against the JAX driver on the generated 24-bf H2O, on the CPU — the
spin-orbital CCSD(T) and every restricted calc_type — plus the CLI's
error path, what the port once refused (eri.npy, mesh_devices = 2) and
the width that asks for more devices than are visible."""

import functools
import io

import numpy as np
import pytest
import torch
from torch_fixtures import breakdown_block, table_energies, write_els_in, write_h2o

import afesp_tpu.driver as jdriver
import afesp_tpu_torch.driver as tdriver
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import mp2 as jmp2
from afesp_tpu.methods.triples_spatial import do_ccsd_t_spatial as jax_ccsd_t_spatial
from afesp_tpu.methods.triples_spinorb import do_ccsd_t_spinorb as jax_ccsd_t
from afesp_tpu_torch.cli import main as cli_main
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import tiers as ttiers
from afesp_tpu_torch.methods.triples_spinorb import do_ccsd_t_spinorb as port_ccsd_t
from afesp_tpu_torch.parallel import mesh as pmesh


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


def _run_port(wd, triples_f64: bool = False):
    rep = Reporter(stream=io.StringIO())
    if triples_f64:
        # the port's CPU default spin-orbital tier is "hybrid" too
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tdriver, "do_ccsd_t_spinorb",
                       functools.partial(port_ccsd_t, precision="f64"))
            res = run_calculation(wd, rep, device="cpu")
    else:
        res = run_calculation(wd, rep, device="cpu")
    return res, rep.stream.getvalue()


@pytest.fixture(scope="module")
def port_run(h2o):
    return _run_port(h2o)


@pytest.fixture(scope="module")
def port_run_f64(h2o):
    return _run_port(h2o, triples_f64=True)


def test_breakdown_matches_jax_driver(h2o, port_run_f64):
    """The breakdown block equals the JAX driver's, both drivers' triples
    at f64, in every printed digit, with equal SCF and CC iteration
    counts."""
    jres, jtext = _run_jax(h2o, triples_f64=True)
    res, text = port_run_f64
    assert breakdown_block(text) == breakdown_block(jtext)
    assert len(breakdown_block(text)) == 12
    for header in ("delta RMS D", "delta RMS T2"):
        assert len(table_energies(text, header)) == len(table_energies(jtext, header))
    assert abs(res.total_energy - jres.total_energy) < 1e-10


def test_totals_match_jax_default_driver(h2o, port_run):
    """Both drivers exactly as they run on the CPU (both at the "hybrid"
    triples tier): every total within 1e-8 Ha, equal iteration counts."""
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
def test_unported_paths_raise(tmp_path, h2o, calc, extra, eri_npy_only, monkeypatch):
    """The paths the port once refused, each now against the JAX driver.
    The eri.npy-only case was the binary ERI tier (fault F4): run from a
    packed eri.npy written from the 24-bf H2O, its breakdown equals the
    JAX driver's line for line.  The two mesh_devices = 2 cases were the
    multi-device runs: with two CPU entries visible to the port (JAX's
    eight CPU devices) both drivers run the CC stages on a 2-device mesh,
    print the same mesh line and the same breakdown, with equal counts
    and totals within 1e-10."""
    for f in h2o.iterdir():
        if eri_npy_only and f.name == "eri.dat":
            _, ji = jdat.read_integrals(h2o, True)
            np.save(tmp_path / "eri.npy", ji.eri_packed)
        else:
            (tmp_path / f.name).symlink_to(f)
    (tmp_path / "els.in").unlink()
    write_els_in(tmp_path, calc, extra)
    monkeypatch.setattr(pmesh, "visible_devices", lambda dev: [dev, dev])
    jres, jtext = _run_jax(tmp_path, triples_f64=not eri_npy_only)
    res, text = _run_port(tmp_path, triples_f64=not eri_npy_only)
    assert breakdown_block(text) == breakdown_block(jtext)
    assert abs(res.total_energy - jres.total_energy) < 1e-10
    assert res.hf.iterations == len(table_energies(jtext, "delta RMS D"))
    assert res.cc.iterations == len(table_energies(jtext, "delta RMS T2"))
    mesh_line = " Using a 2-device mesh for CC stages."
    assert (mesh_line in text) == (mesh_line in jtext) == (not eri_npy_only)


@pytest.mark.parametrize("calc", ["CRCCSD(T)_spatial", "CCSD(T)_spinorb"])
def test_mesh_wider_than_visible_raises(tmp_path, h2o, calc, monkeypatch):
    """A mesh_devices width above the visible device count raises JAX's
    ValueError in both drivers (JAX: 8 CPU devices; the port: 8 CPU
    entries, and the CPU alone by default), and the CLI exits 999."""
    wd = _stage(tmp_path, h2o, calc, "mesh_devices = 9,\n")
    with pytest.raises(ValueError) as jerr:
        jdriver.run_calculation(wd, JaxReporter(stream=io.StringIO()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pmesh, "visible_devices", lambda dev: [dev] * 8)
        with pytest.raises(ValueError) as terr:
            run_calculation(wd, Reporter(stream=io.StringIO()), device="cpu")
    assert str(terr.value) == str(jerr.value) == "mesh_devices=9 but only 8 devices visible"
    write_els_in(wd, calc, "mesh_devices = 2,\n")
    with pytest.raises(ValueError, match="mesh_devices=2 but only 1 devices visible"):
        run_calculation(wd, Reporter(stream=io.StringIO()), device="cpu")
    assert cli_main([str(wd), "--device", "cpu"]) == 999


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


def test_dense_path_above_stream_nbasis(tmp_path, h2o, monkeypatch):
    """Off a TPU the JAX package runs the dense path at any nbasis; so
    does the port.  With STREAM_NBASIS at 20 in both packages the 24-bf
    H2O's CCSD_spatial runs in both, with equal breakdowns and CCSD corr
    within 1e-10."""
    monkeypatch.setattr(jmp2, "STREAM_NBASIS", 20)
    monkeypatch.setattr(ttiers, "STREAM_NBASIS", 20)
    wd = _stage(tmp_path, h2o, "CCSD_spatial")
    jres, jtext = _run_jax(wd)
    res, text = _run_port(wd)
    assert res.sys.nbasis >= 20
    assert abs(res.e_ccsd - jres.e_ccsd) < 1e-10
    assert breakdown_block(text) == breakdown_block(jtext)


@pytest.mark.parametrize("calc", ["MP2_spatial", "MP2_spinorb"])
def test_forced_streaming_matches_jax(tmp_path, h2o, monkeypatch, calc):
    """AFESP_FORCE_STREAM=1 routes the MP2 stage through the streaming
    tier in both packages (the sliced transform, no dense MO tensor, no
    FCIDUMP): the breakdowns are equal, MP2 within 1e-10, and the CLI
    runs it.  tests/test_torch_stream_tier.py holds the whole tier."""
    monkeypatch.setenv("AFESP_FORCE_STREAM", "1")
    wd = _stage(tmp_path, h2o, calc, "write_fcidump = .true.,\n")
    jres, jtext = _run_jax(wd)
    res, text = _run_port(wd)
    assert abs(res.e_mp2 - jres.e_mp2) < 1e-10
    assert breakdown_block(text) == breakdown_block(jtext)
    skipped = "FCIDUMP skipped: no dense MO tensor on the streaming tier."
    assert skipped in text and skipped in jtext and not (wd / "FCIDUMP").exists()
    assert cli_main([str(wd), "--device", "cpu"]) == 0


@pytest.fixture(scope="module")
def jax_width1_text(h2o, tmp_path_factory):
    wd = _stage(tmp_path_factory.mktemp("w1"), h2o, "CCSD_spatial", "mesh_devices = 1,\n")
    return _run_jax(wd)[1]


@pytest.mark.parametrize("width", [1, -1])
def test_single_device_mesh_widths_run(tmp_path, h2o, jax_width1_text, width):
    """mesh_devices = 1, and -1 with one device visible (the CPU), run on
    one device as in the JAX driver: the breakdown block equals the JAX
    driver's at mesh_devices = 1 line for line, and no mesh line is
    printed."""
    wd = _stage(tmp_path, h2o, "CCSD_spatial", f"mesh_devices = {width},\n")
    _, text = _run_port(wd)
    assert breakdown_block(text) == breakdown_block(jax_width1_text)
    assert "-device mesh" not in text and "-device mesh" not in jax_width1_text


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
