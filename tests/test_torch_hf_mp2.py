"""Port parity: RHF and the AO->MO transform + MP2 of afesp_tpu_torch
against the JAX package on the generated 24-bf H2O, on the CPU.  Each
port stage starts from the JAX stage's own inputs (convert.from_jax)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import table_energies, write_h2o

from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import hf as jhf
from afesp_tpu.methods import mp2 as jmp2
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import hf as thf
from afesp_tpu_torch.methods import mp2 as tmp2

F64 = torch.float64


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    wd = write_h2o(tmp_path_factory.mktemp("h2o"), extra="write_fcidump = .true.,\n")
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = jhf.do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = jmp2.do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    return dict(wd=wd, sys_=sys_, ints=ints, hf=hf, mp2=mp2, text=rep.stream.getvalue())


def test_scf_trajectory_matches_jax(jax_run):
    st = from_jax(device="cpu", sys_=jax_run["sys_"], ints=jax_run["ints"])
    cfg = tcfg.read_els_in(jax_run["wd"])
    rep = Reporter(stream=io.StringIO())
    hf = thf.do_rhf(st["sys_"], st["ints"], cfg, rep, jax_run["wd"], device="cpu")
    jax_energies = table_energies(jax_run["text"], "delta RMS D")
    assert hf.converged and hf.iterations == jax_run["hf"].iterations
    assert len(hf.energies) == len(jax_energies) == hf.iterations
    # the JAX energies are read from its report, printed to 1e-10
    assert np.max(np.abs(np.array(hf.energies) - jax_energies)) < 1e-10
    assert abs(hf.e_hf - jax_run["hf"].e_hf) < 1e-10
    assert np.allclose(hf.levels, jax_run["hf"].levels, rtol=0, atol=1e-10)


def test_fock_build_matches_jax(jax_run):
    ints = jax_run["ints"]
    rng = np.random.default_rng(5)
    D = rng.standard_normal((ints.nbasis,) * 2)
    D = D + D.T
    want = np.asarray(jhf.fock_build_jax(jnp.asarray(ints.core_hamil), jnp.asarray(ints.eri),
                                         jnp.asarray(D)))
    t = lambda x: torch.as_tensor(x, dtype=F64)
    got = thf.fock_build(t(ints.core_hamil), t(ints.eri), t(D)).numpy()
    assert np.max(np.abs(got - want)) < 1e-12


def test_ao_to_mo_matches_jax(jax_run):
    eri, C = jax_run["ints"].eri, jax_run["hf"].coeff
    want = np.asarray(jmp2.ao_to_mo(jnp.asarray(eri), jnp.asarray(C)))
    got = tmp2.ao_to_mo(torch.as_tensor(eri), torch.as_tensor(C)).numpy()
    assert np.max(np.abs(got - want)) < 1e-12


def test_mp2_and_fcidump_match_jax(jax_run, tmp_path):
    st = from_jax(device="cpu", sys_=jax_run["sys_"], ints=jax_run["ints"], hf=jax_run["hf"])
    cfg = tcfg.read_els_in(jax_run["wd"])
    rep = Reporter(stream=io.StringIO())
    mp2 = tmp2.do_mp2_spatial(st["sys_"], st["ints"], cfg, st["hf"], rep, tmp_path,
                              device="cpu")
    assert abs(mp2.e_mp2 - jax_run["mp2"].e_mp2) < 1e-10
    assert np.max(np.abs(mp2.eri_mo.numpy() - np.asarray(jax_run["mp2"].eri_mo))) < 1e-12
    assert (tmp_path / "FCIDUMP").read_text() == (jax_run["wd"] / "FCIDUMP").read_text()


def test_mp2_streaming_tier_not_ported(jax_run, monkeypatch, tmp_path):
    """Only AFESP_FORCE_STREAM=1 asks for the streaming tier off a TPU.
    The port refused it until the tier was ported; now, from JAX's HF,
    its stream MP2 (the sliced transform: no dense MO tensor, v_vvvv as
    limbs, no FCIDUMP) equals JAX's stream MP2 within 1e-10, its slices
    JAX's within 1e-12 of scale and its limbs JAX's exactly."""
    monkeypatch.setenv("AFESP_FORCE_STREAM", "1")
    jrep = JaxReporter(stream=io.StringIO())
    jcfg = read_els_in(jax_run["wd"])
    want = jmp2.do_mp2_spatial(jax_run["sys_"], jax_run["ints"], jcfg, jax_run["hf"], jrep,
                               tmp_path)
    st = from_jax(device="cpu", sys_=jax_run["sys_"], ints=jax_run["ints"], hf=jax_run["hf"])
    rep = Reporter(stream=io.StringIO())
    got = tmp2.do_mp2_spatial(st["sys_"], st["ints"], tcfg.read_els_in(jax_run["wd"]),
                              st["hf"], rep, tmp_path, device="cpu")
    assert got.eri_mo is None and want.eri_mo is None and got.slices.v_vvvv is None
    assert abs(got.e_mp2 - want.e_mp2) < 1e-10
    for name in ("v_oovv", "v_ovov", "v_vvov", "v_oovo", "v_oooo"):
        w = np.asarray(getattr(want.slices, name))
        assert np.max(np.abs(getattr(got.slices, name).numpy() - w)) <= 1e-12 * np.abs(w).max()
    (limbs, scales), (jlimbs, jscales) = got.vvvv_B, want.vvvv_B
    assert all(np.array_equal(a.numpy(), np.asarray(b).astype(np.int8))
               for a, b in zip(limbs, jlimbs))
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    skipped = " FCIDUMP skipped: no dense MO tensor on the streaming tier."
    assert skipped in rep.stream.getvalue() and skipped in jrep.stream.getvalue()
    assert not (tmp_path / "FCIDUMP").exists()
