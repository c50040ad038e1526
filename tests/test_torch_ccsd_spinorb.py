"""Port parity: spin-orbital CCSD of afesp_tpu_torch (slices, the DIIS
step, both F_oo forms, the amplitude checkpoint) against the JAX
package on the generated 24-bf H2O, on the CPU."""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import table_energies, write_h2o

from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import ccsd_spinorb as jcc
from afesp_tpu.methods.hf import do_rhf
from afesp_tpu.methods.mp2 import do_mp2_spatial
from afesp_tpu.ops import cc_step as jstep
from afesp_tpu.ops import spin as jspin
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import ccsd_spinorb as tcc
from afesp_tpu_torch.ops import cc_step as tstep
from afesp_tpu_torch.ops import spin as tspin

F64 = torch.float64


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    wd = write_h2o(tmp_path_factory.mktemp("h2o"))
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    return dict(wd=wd, sys_=sys_, hf=hf, eri_mo=mp2.eri_mo)


@pytest.mark.parametrize("equations", ["code", "paper"])
def test_ccsd_trajectory_matches_jax(stages, equations, tmp_path):
    cfg = read_els_in(stages["wd"])
    cfg.ccsd_spinorb_equations = equations
    jrep = JaxReporter(stream=io.StringIO())
    jres = jcc.do_ccsd_spinorb(stages["sys_"], stages["eri_mo"], cfg, stages["hf"], jrep,
                               tmp_path)
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    tc = tcfg.read_els_in(stages["wd"])
    tc.ccsd_spinorb_equations = equations
    eri_mo = torch.as_tensor(np.array(stages["eri_mo"]), dtype=F64)
    res = tcc.do_ccsd_spinorb(st["sys_"], eri_mo, tc, st["hf"], Reporter(stream=io.StringIO()),
                              tmp_path, device="cpu")
    jax_energies = table_energies(jrep.stream.getvalue(), "delta RMS T2")
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations == len(jax_energies)
    # the JAX energies are read from its report, printed to 1e-12
    assert np.max(np.abs(np.array(res.energies) - jax_energies)) < 1e-10
    assert abs(res.e_ccsd - jres.e_ccsd) < 1e-10
    assert np.max(np.abs(res.t2.numpy() - np.asarray(jres.t2))) < 1e-9


def test_spin_slices_bit_equal(stages):
    nocc = stages["sys_"].nel // 2
    js = jcc.make_spin_slices(stages["eri_mo"], nocc_spatial=nocc)
    ts = tcc.make_spin_slices(torch.as_tensor(np.array(stages["eri_mo"])), nocc)
    for f in dataclasses.fields(tcc.SpinSlices):
        if f.name == "vvvv_blocks":  # dense mode at this size, in both packages
            assert ts.vvvv_blocks is None and js.vvvv_blocks is None
            continue
        assert np.array_equal(getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name))), f.name
    # the transformed MO tensor is symmetric to roundoff only
    assert float(tspin.spin_symmetry_error(ts.oooo, ts.oovv, ts.vvvv)) < 1e-10
    lv = np.asarray(stages["hf"].levels)
    assert np.array_equal(tspin.spinorb_levels(torch.as_tensor(lv), nocc).numpy(),
                          np.asarray(jspin.spinorb_levels(jnp.asarray(lv), nocc)))


def test_spin_expand_matches_jax():
    rng = np.random.default_rng(2)
    t1 = rng.standard_normal((3, 4))
    t2 = rng.standard_normal((3, 3, 4, 4))
    t2 = t2 + t2.transpose(1, 0, 3, 2)
    assert np.array_equal(tspin.spin_expand_t1(t1), jspin.spin_expand_t1(t1))
    assert np.array_equal(tspin.spin_expand_t2(t2), jspin.spin_expand_t2(t2))


def test_selfcheck_error_flags_broken_slices(stages, tmp_path):
    """An MO tensor that breaks (pq|rs) = (qp|rs) must trip the
    permutational self-check and raise before the solver starts."""
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    eri_mo = torch.as_tensor(np.array(stages["eri_mo"]), dtype=F64).clone()
    eri_mo[0, 1, 2, 3] += 1e-3
    with pytest.raises(RuntimeError, match="Permutational symmetry"):
        tcc.do_ccsd_spinorb(st["sys_"], eri_mo, tcfg.read_els_in(stages["wd"]), st["hf"],
                            Reporter(stream=io.StringIO()), tmp_path, device="cpu")


@pytest.mark.parametrize("singular", [False, True])
def test_gauss_solve_matches_jax(singular):
    rng = np.random.default_rng(4)
    M = rng.standard_normal((9, 9))
    M = M + M.T
    if singular:
        M[3] = M[5]
        M[:, 3] = M[:, 5]
    rhs = rng.standard_normal(9)
    jx, jok = jstep.gauss_solve(jnp.asarray(M), jnp.asarray(rhs))
    tx, tok = tstep.gauss_solve(torch.as_tensor(M), torch.as_tensor(rhs))
    assert bool(tok) == bool(jok) == (not singular)
    if not singular:
        assert np.max(np.abs(tx.numpy() - np.asarray(jx))) < 1e-12 * np.max(np.abs(np.asarray(jx)))


def test_amplitude_checkpoint_round_trip(stages, tmp_path):
    """Converged amplitudes written by the port restart the port (and are
    readable by the JAX package) at the same fixed point."""
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    eri_mo = torch.as_tensor(np.array(stages["eri_mo"]), dtype=F64)
    cfg = tcfg.read_els_in(stages["wd"])
    cfg.ccsd_write_amplitudes = True
    first = tcc.do_ccsd_spinorb(st["sys_"], eri_mo, cfg, st["hf"],
                                Reporter(stream=io.StringIO()), tmp_path, device="cpu")
    t1, t2 = jdat.read_amplitudes(tmp_path / "amplitudes_out.npz")
    assert np.array_equal(t1, first.t1.numpy()) and np.array_equal(t2, first.t2.numpy())
    (tmp_path / "amplitudes_out.npz").rename(tmp_path / "amplitudes_in.npz")
    cfg.ccsd_read_amplitudes, cfg.ccsd_write_amplitudes = True, False
    rep = Reporter(stream=io.StringIO())
    again = tcc.do_ccsd_spinorb(st["sys_"], eri_mo, cfg, st["hf"], rep, tmp_path, device="cpu")
    assert "Reading previous CC amplitudes as guess..." in rep.stream.getvalue()
    assert again.converged and again.iterations < first.iterations
    assert abs(again.e_ccsd - first.e_ccsd) < 1e-9
