"""Port parity: restricted (spatial) CCSD of afesp_tpu_torch (slices,
denominators, one iteration, the energy, the DIIS loop with its stale
amplitude pair, the T1 diagnostic) against the JAX package on the
generated 24-bf H2O, on the CPU."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import table_energies, write_h2o

from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import ccsd_spatial as jcc
from afesp_tpu.methods.hf import do_rhf
from afesp_tpu.methods.mp2 import do_mp2_spatial
from afesp_tpu.ops import cc_step as jstep
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import ccsd_spatial as tcc
from afesp_tpu_torch.ops import cc_step as tstep

F64 = torch.float64
WARNING = " Significant multireference character detected, CCSD result might be unreliable!"


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    wd = write_h2o(tmp_path_factory.mktemp("h2o"), calc="CRCCSD(T)_spatial")
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    return dict(wd=wd, sys_=sys_, hf=hf, eri_mo=mp2.eri_mo, nocc=sys_.nocc)


@pytest.fixture(scope="module")
def jax_cc(stages, tmp_path_factory):
    cfg = read_els_in(stages["wd"])
    rep = JaxReporter(stream=io.StringIO())
    res = jcc.do_ccsd_spatial(stages["sys_"], stages["eri_mo"], cfg, stages["hf"], rep,
                              tmp_path_factory.mktemp("jcc"))
    return res, rep.stream.getvalue()


def _t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def _close(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(1.0, np.max(np.abs(want)))


def _mp1_state(stages):
    """The JAX slices, denominators and MP1 guess, and the port's from the
    same eri_mo."""
    nocc = stages["nocc"]
    jv, jD1, jD2, jt1, jt2, je0, jr0 = jcc.spatial_cc_init(
        stages["eri_mo"], jnp.asarray(stages["hf"].levels), nocc=nocc)
    tv, tD1, tD2, tt1, tt2, te0, tr0 = tcc.spatial_cc_init(
        _t(stages["eri_mo"]), _t(stages["hf"].levels), nocc)
    return (jv, jD1, jD2, jt1, jt2, je0, jr0), (tv, tD1, tD2, tt1, tt2, te0, tr0)


def test_slices_and_denominators_match_jax(stages):
    """Every slice and both denominators: the same elements of the same
    eri_mo and levels, moved, so equal to 1e-12 (exactly, in fact)."""
    nocc = stages["nocc"]
    jv = jcc.make_slices(stages["eri_mo"], nocc)
    tv = tcc.make_slices(_t(stages["eri_mo"]), nocc)
    for name in jv._fields:
        _close(getattr(tv, name).numpy(), getattr(jv, name), 1e-12)
    for a, b in zip(tcc.denominators(_t(stages["hf"].levels), nocc),
                    jcc.denominators(jnp.asarray(stages["hf"].levels), nocc)):
        _close(a.numpy(), b, 1e-12)


def test_one_iteration_and_energy_match_jax(stages):
    """One T1/T2 update from the MP1 guess and then one from a nonzero
    t1, with the energy and squared T2 change, at 1e-12 relative: both
    are f64 einsums of the same terms, summed in another order."""
    (jv, jD1, jD2, jt1, jt2, je0, jr0), (tv, tD1, tD2, tt1, tt2, te0, tr0) = _mp1_state(stages)
    _close(float(te0), float(je0), 1e-12)
    _close(float(tr0), float(jr0), 1e-12)
    for _ in range(2):
        jn1, jn2 = jcc._iteration_core(jt1, jt2, jv, jD1, jD2)
        tn1, tn2 = tcc._iteration_core(tt1, tt2, tv, tD1, tD2)
        _close(tn1.numpy(), jn1, 1e-12)
        _close(tn2.numpy(), jn2, 1e-12)
        je, jr = jcc.cc_energy_restricted(jn1, jn2, jt2, jv.v_oovv)
        te, tr = tcc.cc_energy_restricted(tn1, tn2, tt2, tv.v_oovv)
        _close(float(te), float(je), 1e-12)
        _close(float(tr), float(jr), 1e-12)
        jt1, jt2, tt1, tt2 = jn1, jn2, tn1, tn2


def test_cc_step_keeps_the_amplitudes_that_fed_it(stages):
    """CCState.t1_in/t2_in are the amplitudes the last iteration started
    from, in the port as in the JAX step."""
    _, (tv, tD1, tD2, tt1, tt2, _, _) = _mp1_state(stages)
    it = lambda a, b: tcc._iteration_core(a, b, tv, tD1, tD2)
    en = lambda a, b, old: tcc.cc_energy_restricted(a, b, old, tv.v_oovv)
    st = tstep.init_cc_state(tt1, tt2, 8)
    assert st.t1_in is tt1 and st.t2_in is tt2
    st1, _ = tstep.cc_step(st, it, en, 8)
    st2, _ = tstep.cc_step(st1, it, en, 8)
    assert torch.equal(st2.t1_in, st1.t1) and torch.equal(st2.t2_in, st1.t2)
    js = jstep.init_cc_state(jnp.asarray(tt1.numpy()), jnp.asarray(tt2.numpy()), 8)
    assert set(tstep.CCState.__dataclass_fields__) == set(js._fields)


def test_ccsd_matches_jax(stages, jax_cc, tmp_path):
    """do_ccsd_spatial against JAX: the converged energy to 1e-10, every
    iteration's energy to 1e-10 (the JAX ones read from its report,
    printed to 1e-12), equal iteration counts, the converged and the
    stale amplitude pairs to 1e-10, and the T1 diagnostic lines."""
    jres, jtext = jax_cc
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    tc = tcfg.read_els_in(stages["wd"])
    rep = Reporter(stream=io.StringIO())
    res = tcc.do_ccsd_spatial(st["sys_"], _t(stages["eri_mo"]), tc, st["hf"], rep, tmp_path,
                              device="cpu")
    text = rep.stream.getvalue()
    jax_energies = table_energies(jtext, "delta RMS T2")
    assert res.converged and jres.converged
    assert res.iterations == jres.iterations == len(jax_energies)
    assert abs(res.e_ccsd - jres.e_ccsd) < 1e-10
    assert np.max(np.abs(np.array(res.energies) - jax_energies)) < 1e-10
    for a, b in ((res.t1, jres.t1), (res.t2, jres.t2), (res.t1_prev, jres.t1_prev),
                 (res.t2_prev, jres.t2_prev)):
        _close(a.numpy(), b, 1e-10)
    # the stale pair is not the converged one
    assert not torch.equal(res.t2_prev, res.t2)
    assert abs(res.t1_diagnostic - jres.t1_diagnostic) < 1e-12
    diag = [ln for ln in text.split("\n") if "T1 diagnostic" in ln or "multireference" in ln]
    jdiag = [ln for ln in jtext.split("\n") if "T1 diagnostic" in ln or "multireference" in ln]
    assert diag == jdiag and diag[0].startswith(" T1 diagnostic:")
    # this H2O's T1 diagnostic is above 0.02: the warning is printed
    assert res.t1_diagnostic > 0.02 and diag[1] == WARNING


def test_ccsd_precision_modes_run_f64(stages, jax_cc, tmp_path):
    """"hybrid", "pallas" and "fused" run the same f64 iteration (the
    digit GEMMs are not ported), and say so in the report."""
    jres, _ = jax_cc
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    tc = tcfg.read_els_in(stages["wd"])
    tc.ccsd_precision = "hybrid"
    rep = Reporter(stream=io.StringIO())
    res = tcc.do_ccsd_spatial(st["sys_"], _t(stages["eri_mo"]), tc, st["hf"], rep, tmp_path,
                              device="cpu")
    assert abs(res.e_ccsd - jres.e_ccsd) < 1e-10
    assert res.precision_used == "f64"
    assert 'CCSD arithmetic: f64 (ccsd_precision="hybrid"' in rep.stream.getvalue()


def test_amplitude_checkpoint_round_trip(stages, tmp_path):
    """Written amplitudes read back as the guess converge at once to the
    same energy."""
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    tc = tcfg.read_els_in(stages["wd"])
    tc.ccsd_write_amplitudes = True
    eri = _t(stages["eri_mo"])
    first = tcc.do_ccsd_spatial(st["sys_"], eri, tc, st["hf"], Reporter(stream=io.StringIO()),
                                tmp_path, device="cpu")
    (tmp_path / "amplitudes_out.npz").rename(tmp_path / "amplitudes_in.npz")
    tc.ccsd_write_amplitudes = False
    tc.ccsd_read_amplitudes = True
    rep = Reporter(stream=io.StringIO())
    again = tcc.do_ccsd_spatial(st["sys_"], eri, tc, st["hf"], rep, tmp_path, device="cpu")
    assert "Reading previous CC amplitudes as guess" in rep.stream.getvalue()
    assert again.iterations <= 2
    assert abs(again.e_ccsd - first.e_ccsd) < 1e-9


def test_from_jax_takes_the_restricted_state(stages, jax_cc):
    """convert.from_jax carries the spatial Slices and CCSDResult,
    t1_prev/t2_prev included, exactly."""
    jres, _ = jax_cc
    out = from_jax(device="cpu", cc=jres)
    assert isinstance(out["slices"], tcc.Slices) and isinstance(out["cc"], tcc.CCSDResult)
    for name in jres.slices._fields:
        assert np.array_equal(getattr(out["slices"], name).numpy(), np.asarray(getattr(jres.slices, name)))
    cc = out["cc"]
    for name in ("t1", "t2", "t1_prev", "t2_prev"):
        assert np.array_equal(getattr(cc, name).numpy(), np.asarray(getattr(jres, name)))
    assert cc.iterations == jres.iterations and cc.t1_diagnostic == jres.t1_diagnostic


def test_unported_ccsd_tier_raises(stages):
    """Without a dense MO tensor (the JAX package's streaming-slices
    tier) the port refuses."""
    st = from_jax(device="cpu", sys_=stages["sys_"], hf=stages["hf"])
    tc = tcfg.read_els_in(stages["wd"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcc.do_ccsd_spatial(st["sys_"], None, tc, st["hf"], Reporter(stream=io.StringIO()),
                            device="cpu")
