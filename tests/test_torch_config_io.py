"""Port parity: config parsing, .dat reading and the report lines of
afesp_tpu_torch against the JAX package, on the CPU."""

import dataclasses
import time

import numpy as np
import pytest
from torch_fixtures import reporter_pair, write_h2o

from afesp_tpu import config as jcfg
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.fcidump import write_fcidump as jax_write_fcidump
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.io import dat as tdat
from afesp_tpu_torch.io.fcidump import write_fcidump

OPTIONS = """scf_e_tol=1e-9,
scf_d_tol=2.5d-8,
scf_diis_n_errmat=5,
ccsd_e_tol=1e-7,
ccsd_t_tol=3e-7,
ccsd_diis_n_errmat=7,
scf_maxiter = 77,
ccsd_maxiter = 66,
write_fcidump = .true.,
scf_read_guess = .false.,
scf_write_guess = T,
ccsd_read_amplitudes = .true.,
ccsd_write_amplitudes = .true.,
ccsd_spinorb_equations = "paper",
ccsd_precision = "hybrid",
spinorb_selfcheck = .false.,
ccsd_t_spatial_bug_compat = .true.,
mesh_devices = 2,
unknown_key = 3,
"""


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["calc_type"] = cfg.calc_type.value
    return d


@pytest.mark.parametrize("calc", sorted(jcfg._CALC_TABLE))
def test_config_fields_identical(calc):
    text = f'&elsinput\ncalc_type="{calc}",\n{OPTIONS}/\n'
    assert _fields(tcfg.parse_els_in(text)) == _fields(jcfg.parse_els_in(text))


def test_config_defaults_and_tables_identical():
    assert _fields(tcfg.Config()) == _fields(jcfg.Config())
    assert {k: (v[0].value, *v[1:]) for k, v in tcfg._CALC_TABLE.items()} == {
        k: (v[0].value, *v[1:]) for k, v in jcfg._CALC_TABLE.items()
    }


@pytest.mark.parametrize(
    "body",
    ['calc_type="CCSD(Q)"', 'ccsd_precision="bf16"', 'ccsd_spinorb_equations="x"'],
)
def test_config_rejects_what_jax_rejects(body):
    text = f"&elsinput\n{body},\n/\n"
    with pytest.raises(ValueError) as je:
        jcfg.parse_els_in(text)
    with pytest.raises(ValueError) as te:
        tcfg.parse_els_in(text)
    assert str(te.value) == str(je.value)


def test_read_els_in_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcfg.read_els_in(tmp_path)


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


@pytest.mark.parametrize("restricted", [True, False])
def test_read_integrals_bit_equal(h2o, restricted):
    js, ji = jdat.read_integrals(h2o, restricted)
    ts, ti = tdat.read_integrals(h2o, restricted)
    for f in dataclasses.fields(tdat.System):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        assert np.array_equal(a, b), f.name
    for f in dataclasses.fields(tdat.IntStore):
        a, b = getattr(ji, f.name), getattr(ti, f.name)
        assert np.array_equal(a, b), f.name


def test_reading_writes_no_file(h2o):
    before = sorted(p.name for p in h2o.iterdir())
    tdat.read_integrals(h2o, False)
    assert sorted(p.name for p in h2o.iterdir()) == before


def test_packed_eri_round_trip(h2o):
    _, ti = tdat.read_integrals(h2o, True)
    n = ti.nbasis
    assert np.array_equal(tdat.unpack_eri_host(ti.eri_packed, n), ti.eri)
    assert np.array_equal(
        tdat.unpack_eri_host(ti.eri_packed, n), jdat.unpack_eri_host(ti.eri_packed, n)
    )
    i, j, k, l = np.array([[0, 1, 2, 3], [3, 2, 1, 0]]).T
    vals = np.array([0.5, -0.25])
    assert np.array_equal(
        tdat.pack_from_table(i, j, k, l, vals, 5), jdat.pack_from_table(i, j, k, l, vals, 5)
    )


def test_scf_guess_and_fcidump_text_identical(tmp_path):
    rng = np.random.default_rng(3)
    F = rng.standard_normal((6, 6))
    jdat.write_scf_guess(tmp_path / "j.dat", F)
    tdat.write_scf_guess(tmp_path / "t.dat", F)
    assert (tmp_path / "j.dat").read_text() == (tmp_path / "t.dat").read_text()
    assert np.array_equal(tdat.read_scf_guess(tmp_path / "t.dat", 6),
                          jdat.read_scf_guess(tmp_path / "j.dat", 6))
    eri = rng.standard_normal((5, 5, 5, 5)) * 1e-6
    jax_write_fcidump(tmp_path / "jf", eri)
    write_fcidump(tmp_path / "tf", eri)
    assert (tmp_path / "jf").read_text() == (tmp_path / "tf").read_text()


def test_reporter_lines_identical(h2o, monkeypatch):
    fixed = time.struct_time((2026, 1, 2, 3, 4, 5, 4, 2, 0))
    monkeypatch.setattr(time, "localtime", lambda *a: fixed)
    js, ji = jdat.read_integrals(h2o, False)
    cfg = jcfg.read_els_in(h2o)
    outs = []
    for rep in reporter_pair():
        rep.banner()
        rep.section("Integral read-in")
        rep.sys_info(js, ji, cfg)
        rep.stage_time("Time taken for restricted Hartree-Fock:", 1.25)
        rep.scf_table_header()
        rep.scf_row(3, -75.123456789012, 1e-5, 2e-6, 0.5)
        rep.cc_table_header()
        rep.cc_row("MP1", -0.2, -0.2, 0.01)
        rep.cc_row(7, -0.21234567890123, -1e-9, 3e-10, 0.25)
        rep.table_close()
        rep.breakdown_line("CCSD(T) energy:", -76.0295881392)
        rep.breakdown_bar()
        rep.finish(12.5)
        outs.append(rep.stream.getvalue())
    assert outs[1] == outs[0]
