"""The port's binding-curve harness (`afesp_tpu_torch/utils/wrapper.py`)
against the JAX package's, on the CPU: a two-point H2O/cc-pVDZ scan with
SCF-guess chaining, each package writing its own integrals and running
its own pipeline; the scraped tables agree within 1e-8 Ha."""

from __future__ import annotations

import numpy as np
import pytest

from afesp_tpu.utils import wrapper as jw

from afesp_tpu_torch.utils import wrapper as tw

TEMPLATE = """&elsinput
calc_type="CRCCSD(T)_spatial",
scf_e_tol=1e-9,
scf_d_tol=1e-8,
ccsd_e_tol=1e-9,
ccsd_t_tol=1e-8,
ccsd_precision = "f64",
scf_read_guess = .true.,
scf_write_guess = .true.,
/
"""


@pytest.fixture(scope="module")
def curves(tmp_path_factory):
    args = ("h2o", "cc-pvdz", 1.80, 1.90, 0.10, 104.45, TEMPLATE)
    jd, td = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    return (jw.binding_curve(*args, outdir=jd), jd / "h2o-cc-pvdz",
            tw.binding_curve(*args, outdir=td, device="cpu"), td / "h2o-cc-pvdz")


def test_binding_curve_matches_jax(curves):
    want, _, got, _ = curves
    assert got.shape == want.shape == (2, 14)
    assert np.array_equal(got[:, :2], want[:, :2])
    assert np.abs(got[:, 2:] - want[:, 2:]).max() <= 1e-8
    # every scraped label was found (no energy left at its 0 default)
    assert np.all(got[:, 2:] != 0.0)


def test_binding_curve_chains_the_scf_guess(curves):
    _, jd, _, td = curves
    for out in (jd, td):
        first, second = sorted(p for p in out.iterdir() if p.is_dir())
        assert not (first / "guess_in.dat").exists()
        assert (second / "guess_in.dat").read_text() == (first / "guess_out.dat").read_text()
        assert "scf_read_guess = .false." in (first / "els.in").read_text()
        assert "scf_read_guess = .true." in (second / "els.in").read_text()
        assert " Reading previous AO Fock matrix as guess..." in (second / "els.out").read_text()


def test_scrape_and_geometry_match_jax(curves):
    _, jd, _, td = curves
    for a, b in zip(sorted(jd.glob("*/els.out")), sorted(td.glob("*/els.out"))):
        assert np.abs(tw.scrape(b.read_text()) - jw.scrape(a.read_text())).max() <= 1e-8
        assert tw.scrape(a.read_text()).tolist() == jw.scrape(a.read_text()).tolist()
    for args in ((1.80, 104.45), (2.00, 104.45), (0.96, 100.0)):
        for x, y in zip(tw.water_geometry(*args), jw.water_geometry(*args)):
            assert np.array_equal(x, y)
