"""The sliced f64 tier on the CPU: RHF with no dense AO tensor (the
pair-row table's Fock build), the sliced f64 AO->MO transform and the
f64 CCSD, CR chain and (T) on its slices, forced on the committed 58-bf
H2O/cc-pVTZ through the tier rule's budget (`tiers.choose_tier`), with no
environment variable.  Held to the port's dense f64 path, to the plain
blocked reference (`tests/plain_rccsd_blocked.py`), and, piece by piece,
to the dense Fock build and the dense transform's slices; the tier rule
on every committed configuration; the spans and the counter."""

from __future__ import annotations

import functools
import io
import json
import shutil
from pathlib import Path

import numpy as np
import plain_rccsd_blocked
import pytest
import torch

from afesp_tpu_torch import driver as tdriver
from afesp_tpu_torch import trace
from afesp_tpu_torch.io import dat
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import hf as thf
from afesp_tpu_torch.methods import mo_slices
from afesp_tpu_torch.methods import mp2 as tmp2
from afesp_tpu_torch.methods import tiers
from afesp_tpu_torch.methods.ccsd_spatial import make_slices

ROOT = Path(__file__).resolve().parents[1]
PVTZ = ROOT / "data" / "h2o-cc-pvtz-2.00_104.45"
EXPECTED = json.loads((PVTZ / "expected_jax_cpu_crccsd_t_spatial.json").read_text())
KEYS = ("e_hf", "e_mp2", "e_ccsd", "e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt",
        "e_crccsd_t", "e_crccsd_tt")
# an H100's memory as torch.cuda.mem_get_info reports it (80 GB HBM3)
H100_BYTES = 85.0e9


def values(res) -> dict:
    out = {"e_hf": res.e_hf + res.e_nuc, "e_mp2": res.e_mp2, "e_ccsd": res.e_ccsd}
    return out | {k: getattr(res.triples, k) for k in KEYS[3:]}


def run_port(wd: Path):
    n = len(trace.records())
    trace.enable()
    try:
        res = tdriver.run_calculation(wd, Reporter(stream=io.StringIO()), device="cpu")
    finally:
        trace.disable()
    (record,) = trace.records()[n:]
    return res, record


@pytest.fixture(scope="module")
def pvtz(tmp_path_factory):
    d = tmp_path_factory.mktemp("pvtz_sliced")
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
        shutil.copy(PVTZ / f, d / f)
    (d / "eri.dat").symlink_to(ROOT / "data" / "h2o-cc-pvtz" / "eri.dat")
    (d / "els.in").write_text(EXPECTED["els_in"])  # CRCCSD(T)_spatial at "f64"
    return d


@pytest.fixture(scope="module")
def dense(pvtz):
    return run_port(pvtz)


@pytest.fixture(scope="module")
def sliced(pvtz):
    """The same calculation with the rule given a budget of one byte, and
    the transform's blocks small enough to make several vvvv chunks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiers, "choose_tier", functools.partial(tiers.choose_tier, budget_bytes=1))
        mp.setattr(mo_slices, "_F64_BLOCK_BYTES", 3e6)
        chunks = mo_slices.ao_to_mo_slices.vvvv_chunks
        res, record = run_port(pvtz)
        return res, record, mo_slices.ao_to_mo_slices.vvvv_chunks - chunks


@pytest.fixture(scope="module")
def integrals(pvtz, dense):
    sys_, ints = dat.read_integrals(pvtz, restricted=True)
    return sys_, ints, dense[0].hf


def test_the_sliced_breakdown_is_the_dense_one(dense, sliced):
    """Every breakdown number within 1e-10 Ha of the dense f64 path's,
    with the same SCF and CC iteration counts; no dense MO tensor, and
    v_vvvv dropped once its CR contraction was made."""
    (d, _), (s, _, _) = dense, sliced
    got, want = values(s), values(d)
    assert all(abs(got[k] - want[k]) <= 1e-10 for k in KEYS), (got, want)
    assert (s.hf.iterations, s.cc.iterations) == (d.hf.iterations, d.cc.iterations)
    assert s.cc.precision_used == "f64" and s.triples.cr_precision == "f64"
    assert s.cc.slices.v_vvvv is None and s.cc.cr_vvvv_term is not None
    assert d.cc.cr_vvvv_term is None


def test_the_sliced_breakdown_is_the_plain_blocked_reference(pvtz, sliced):
    """The plain blocked reference (no n^4 tensor, its own blocking) on the
    same files: every breakdown number within 1e-10 Ha, and JAX's
    committed values within 1e-10 Ha too."""
    ref = plain_rccsd_blocked.run(pvtz, plain_els(), "cpu")
    got = values(sliced[0])
    assert all(abs(got[k] - ref[k]) <= 1e-10 for k in KEYS), (got, ref)
    jax = {"e_hf": EXPECTED["e_hf_total"], "e_mp2": EXPECTED["e_mp2_corr"],
           "e_ccsd": EXPECTED["e_ccsd_corr"]} | EXPECTED["triples"]
    assert all(abs(got[k] - jax[k]) <= 1e-10 for k in KEYS)


def plain_els() -> dict:
    keys = ("calc_type", "scf_e_tol", "scf_d_tol", "scf_diis_n_errmat", "scf_maxiter",
            "ccsd_e_tol", "ccsd_t_tol", "ccsd_diis_n_errmat", "ccsd_maxiter")
    out = {}
    for line in EXPECTED["els_in"].split("\n"):
        key, _, raw = line.partition("=")
        key, raw = key.strip(), raw.strip().rstrip(",").strip()
        if key in keys:
            out[key] = raw.strip('"') if key == "calc_type" else float(raw)
    return out | {k: int(out[k]) for k in keys if "maxiter" in k or "errmat" in k}


def test_the_row_table_fock_build_is_the_dense_one(integrals):
    """fock_build_rows from the pair-row table equals the dense build
    within 1e-12 of its scale, at the converged density and at the core
    guess's; the table is (npair, n^2) with rows[pair(i,j), k*n+l] =
    (ij|kl)."""
    sys_, ints, hf = integrals
    n, nocc = sys_.nbasis, sys_.nel // 2
    rows = ints.rows_on_device("cpu")
    assert rows.shape == (n * (n + 1) // 2, n * n)
    assert ints.rows_on_device("cpu") is rows  # made once
    eri = torch.as_tensor(ints.eri)
    i, j = np.tril_indices(n)
    assert torch.equal(rows, eri[i, j].reshape(len(i), n * n))
    H = torch.as_tensor(ints.core_hamil)
    tk, tl = (torch.as_tensor(x) for x in np.tril_indices(n))
    C_core = np.linalg.eigh(thf.symmetric_orthogonaliser_np(ints.ovlp).T @ ints.core_hamil
                            @ thf.symmetric_orthogonaliser_np(ints.ovlp))[1]
    C_core = (thf.symmetric_orthogonaliser_np(ints.ovlp) @ C_core).T
    for C in (hf.coeff, C_core):
        D = torch.as_tensor(C[:nocc].T @ C[:nocc])
        want = thf.fock_build(H, eri, D)
        got = thf.fock_build_rows(H, rows, D, tk, tl)
        assert torch.max(torch.abs(got - want)) <= 1e-12 * torch.max(torch.abs(want))
    ints.free_device_rows()
    assert ints._rows_dev is None


@pytest.mark.parametrize("block_bytes", [3e6, 1e9], ids=["chunks", "one_chunk"])
def test_the_f64_slices_are_the_dense_transforms(integrals, monkeypatch, block_bytes):
    """ao_to_mo_slices_f64 from the row table gives make_slices of the
    dense ao_to_mo, every slice within 1e-12 of its scale, v_vvvv in
    one chunk or several; it frees the table through `free_rows`."""
    sys_, ints, hf = integrals
    nocc = sys_.nel // 2
    monkeypatch.setattr(mo_slices, "_F64_BLOCK_BYTES", block_bytes)
    C = torch.as_tensor(hf.coeff)
    want = make_slices(tmp2.ao_to_mo(torch.as_tensor(ints.eri), C), nocc)
    before = mo_slices.ao_to_mo_slices.vvvv_chunks
    got = mo_slices.ao_to_mo_slices_f64(ints, C, nocc=nocc, free_rows=ints.free_device_rows)
    chunks = mo_slices.ao_to_mo_slices.vvvv_chunks - before
    assert ints._rows_dev is None
    assert chunks > 1 if block_bytes < 1e8 else chunks == 1
    for name in ("v_oovv", "v_ovov", "v_vvov", "v_oovo", "v_oooo", "v_vvvv"):
        w, g = getattr(want, name), getattr(got, name)
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.max(torch.abs(g - w)) <= 1e-12 * torch.max(torch.abs(w)), name


@pytest.mark.parametrize("config,precision,tier", [
    ("h2o-ccpvtz", "f64", "dense"), ("h2o-ccpvtz", "hybrid", "dense"),
    ("h2o-dimer-ccpvtz", "f64", "dense"), ("h2o-dimer-ccpvtz", "hybrid", "dense"),
    ("h2o-trimer-ccpvtz", "f64", "dense"), ("h2o-trimer-ccpvtz", "hybrid", "dense"),
    ("h2o-pentamer-ccpvtz", "f64", "sliced"), ("h2o-pentamer-ccpvtz", "hybrid", "stream"),
])
def test_the_tier_rule_on_every_committed_configuration(config, precision, tier):
    """On an H100's memory every committed configuration keeps the tier it
    runs today, the pentamer alone above the dense cutoff; on the CPU
    the rule is dense unless a budget is given."""
    n = 58 if config == "h2o-ccpvtz" else json.loads(
        (ROOT / "gpubench" / "configs" / f"{config}.json").read_text())["nbasis"]
    assert tiers.choose_tier(n, precision, "cuda", budget_bytes=H100_BYTES) == tier
    assert tiers.choose_tier(n, precision, "cpu") == "dense"


def test_the_spans_and_the_counter(dense, sliced):
    """Both tiers record each Fock build as `rhf.fock` under RHF; the
    sliced transform is `mo.slices` under MP2 and counts its vvvv chunks,
    which the dense tier leaves at 0."""
    assert "mo_slices.vvvv_chunks" in trace._counters
    (d, drec), (s, srec, chunks) = dense, sliced
    for res, record in ((d, drec), (s, srec)):
        rhf = next(i for i, x in enumerate(record) if x.name == "Restricted Hartree-Fock")
        focks = [x for x in record if x.name == "rhf.fock"]
        assert len(focks) == res.hf.iterations - 1 and all(x.parent == rhf for x in focks)
    assert [x.name for x in drec if x.name == "mo.slices"] == []
    assert drec[0].counts["mo_slices.vvvv_chunks"] == 0
    (ms,) = [x for x in srec if x.name == "mo.slices"]
    assert srec[ms.parent].name == "MP2"
    assert srec[0].counts["mo_slices.vvvv_chunks"] == ms.counts["mo_slices.vvvv_chunks"] \
        == chunks > 1


def test_the_spinorb_refusal_on_a_sliced_tier_names_the_rule(pvtz, tmp_path, monkeypatch):
    wd = tmp_path / "spinorb"
    shutil.copytree(pvtz, wd, symlinks=True)
    (wd / "els.in").write_text(EXPECTED["els_in"].replace("CRCCSD(T)_spatial",
                                                          "CCSD(T)_spinorb"))
    monkeypatch.setattr(tiers, "choose_tier", functools.partial(tiers.choose_tier, budget_bytes=1))
    with pytest.raises(ValueError, match=r"exceed the card's memory \(methods/tiers.choose_tier\)"):
        tdriver.run_calculation(wd, Reporter(stream=io.StringIO()), device="cpu")
