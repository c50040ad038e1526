"""The blocked plain reference (`reference/rccsd_t_blocked.py`) against
the dense one (`reference/rccsd_t.py`) on the committed H2O/cc-pVTZ
(58 bf), on the CPU: every breakdown number within 1e-12 Ha, with the
blocks cut small enough that every loop runs several blocks, and the
triples again at the default blocks; the symmetric x-bar that lets the
triples run over i <= j <= k alone; and the
tests' copy of it (`tests/plain_rccsd_blocked.py`) is the same file.

    python -m pytest gpubench/tests -q
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from gpubench.harness import spec
from gpubench.reference import rccsd_t, rccsd_t_blocked
from gpubench.reference.triples import xbar

ROOT = Path(__file__).resolve().parents[2]
PVTZ = ROOT / "data" / "h2o-cc-pvtz-2.00_104.45"
PVTZ_ERI = ROOT / "data" / "h2o-cc-pvtz" / "eri.dat"


@pytest.fixture(scope="module")
def pvtz_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pvtz_blocked")
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
        shutil.copy(PVTZ / f, d / f)
    (d / "eri.dat").symlink_to(PVTZ_ERI)
    return d


@pytest.fixture(scope="module")
def els():
    return spec.parse_namelist(
        json.loads((PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())["els_in"])


@pytest.fixture(scope="module")
def want(pvtz_dir, els):
    return rccsd_t.run(pvtz_dir, els, "cpu", torch.float64)


def test_the_blocked_reference_is_the_dense_one(pvtz_dir, els, want, monkeypatch):
    # 58 bf, o = 5, v = 53: AO blocks of 10 first indices, k-blocks of 1,
    # <ab|cd> terms of 2 virtuals
    monkeypatch.setattr(rccsd_t_blocked, "AO_BLOCK_ELEMS", 2e6)
    monkeypatch.setattr(rccsd_t_blocked, "CUBE_BYTES", 3e6)
    monkeypatch.setattr(rccsd_t_blocked, "VVVV_TERM_BYTES", 3e6)
    assert rccsd_t_blocked.k_block(5, 53, 8) == 1
    got = rccsd_t_blocked.run(pvtz_dir, els, "cpu", torch.float64)
    assert (got["scf_iterations"], got["cc_iterations"]) == \
        (want["scf_iterations"], want["cc_iterations"])
    for k in ("e_hf", "e_mp2", "e_ccsd") + rccsd_t.TRIPLES:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_the_triples_over_i_le_j_le_k_are_the_full_cube(pvtz_dir, els, want):
    # the default cube: k-blocks of 5 that start at j and stop at o, so
    # the weights 6, 3 and 1 meet within one block
    assert rccsd_t_blocked.k_block(5, 53, 8) == 5
    got = rccsd_t_blocked.run(pvtz_dir, els, "cpu", torch.float64)
    for k in rccsd_t.TRIPLES:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_xbar_sym_is_xbar_averaged_over_the_orderings_of_abc():
    x = torch.randn(2, 3, 4, 4, 4, dtype=torch.float64)
    y = torch.randn(2, 3, 4, 4, 4, dtype=torch.float64)
    orders = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
    p = lambda t, o: t.permute(0, 1, *(2 + a for a in o))
    mean = sum(torch.sum(xbar(p(x, o)) * p(y, o)) for o in orders) / 6
    assert torch.allclose(torch.sum(rccsd_t_blocked.xbar_sym(x) * y), mean, rtol=0, atol=1e-12)


def test_the_tests_copy_is_the_same_file():
    assert (ROOT / "tests" / "plain_rccsd_blocked.py").read_bytes() == \
        Path(rccsd_t_blocked.__file__).read_bytes()


def test_the_blocked_reference_names_its_stages():
    assert rccsd_t_blocked.STAGES == rccsd_t.STAGES
    with pytest.raises(ValueError, match="no reference stage"):
        rccsd_t_blocked.run(".", {"calc_type": "CCSD_spatial"}, "cpu", lower={"mp2": None})
