"""Port parity: the f32 "hybrid" (T) tiers of both formulations and the
f32 CR chain, against the JAX package on the CPU.

"hybrid" runs the panel GEMMs (and the restricted z3/y numerators) with
f32 operands, while the denominators, quotients and reductions stay f64;
the restricted CR intermediates run wholly in f32 unless the request is
"f64".  XLA's CPU dot and torch's CPU sgemm block differently, so the
port's f32 tier does not give JAX's bits: it is held to JAX's "hybrid"
within 1e-9 Ha (every energy, D[T] and D(T)) and to the port's own f64
tier within 5e-9 (JAX's bound between its two tiers,
tests/test_triples_precision.py), on JAX's converged amplitudes of the
generated 24-bf H2O.  The f32 CR intermediates are held to JAX's f32
chain relative to their largest element (CR_RTOL, a few f32 roundings
through the chain's two levels of contractions).  The drivers at the
CPU default (CCSD(T)_spinorb) and at ccsd_precision = "hybrid"
(CRCCSD(T)_spatial) run these tiers in both packages; the sharded tiers
at widths 2 and 3 are held to JAX's 8-device mesh.
"""

import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import (
    masked_report,
    random_spatial_problem,
    random_triples_problem,
    table_energies,
    write_h2o,
)

import afesp_tpu.driver as jdriver
from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import triples_spatial as JS
from afesp_tpu.methods import triples_spinorb as JO
from afesp_tpu.methods.ccsd_spatial import do_ccsd_spatial
from afesp_tpu.methods.ccsd_spinorb import do_ccsd_spinorb
from afesp_tpu.methods.hf import do_rhf
from afesp_tpu.methods.mp2 import do_mp2_spatial
from afesp_tpu.parallel import triples_shard as jts
from afesp_tpu.parallel.mesh import default_mesh as jax_mesh
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import triples_spatial as TS
from afesp_tpu_torch.methods import triples_spinorb as TO
from afesp_tpu_torch.parallel import triples_shard as tts
from afesp_tpu_torch.parallel.mesh import Mesh

F64 = torch.float64
CPU = torch.device("cpu")
VS_JAX_HYBRID = 1e-9
VS_F64 = 5e-9
CR_RTOL = 1e-6
KEYS = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t", "e_crccsd_tt",
        "D_T", "D_TT")
HYBRID = 'ccsd_precision = "hybrid",\n'


def _jax_stages(wd):
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    solve = do_ccsd_spatial if cfg.restricted else do_ccsd_spinorb
    cc = solve(sys_, mp2.eri_mo, cfg, hf, rep, wd)
    return dict(sys_=sys_, cfg=cfg, hf=hf, cc=cc)


@pytest.fixture(scope="module")
def spinorb(tmp_path_factory):
    """JAX's converged spin-orbital CCSD of the generated 24-bf H2O."""
    return _jax_stages(write_h2o(tmp_path_factory.mktemp("so")))


@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """JAX's converged restricted CCSD of the same H2O, CRCCSD(T)."""
    return _jax_stages(write_h2o(tmp_path_factory.mktemp("sp"), "CRCCSD(T)_spatial"))


def _port_spinorb(st, precision):
    port = from_jax(device="cpu", cc=st["cc"])
    return TO.do_ccsd_t_spinorb(st["sys_"], port["cc"], st["cfg"], st["hf"].levels,
                                Reporter(stream=io.StringIO()), precision=precision)


def _port_spatial(st, precision, ccsd_precision="f64"):
    port = from_jax(device="cpu", sys_=st["sys_"], cc=st["cc"])
    cfg = tcfg.parse_els_in(st["cfg"].raw_text)
    cfg.ccsd_precision = ccsd_precision
    return TS.do_ccsd_t_spatial(port["sys_"], port["cc"], cfg, st["hf"].levels,
                                Reporter(stream=io.StringIO()), precision=precision)


def _jax_spatial(st, precision):
    return JS.do_ccsd_t_spatial(st["sys_"], st["cc"], st["cfg"], st["hf"].levels,
                                JaxReporter(stream=io.StringIO()), precision=precision)


def test_spinorb_hybrid_matches_jax_hybrid(spinorb):
    """E(T) of the f32 tier within 1e-9 of JAX's "hybrid" and 5e-9 of the
    port's f64 tier; the CPU default is "hybrid" in both packages."""
    st = spinorb
    rep = JaxReporter(stream=io.StringIO())
    jax_hybrid = JO.do_ccsd_t_spinorb(st["sys_"], st["cc"], st["cfg"], st["hf"].levels, rep,
                                      precision="hybrid")
    jax_default = JO.do_ccsd_t_spinorb(st["sys_"], st["cc"], st["cfg"], st["hf"].levels, rep)
    got = _port_spinorb(st, "hybrid")
    f64 = _port_spinorb(st, "f64")
    assert abs(got - jax_hybrid) < VS_JAX_HYBRID
    assert abs(got - f64) < VS_F64
    assert got != f64  # the f32 tier ran
    assert _port_spinorb(st, None) == got
    assert jax_default == jax_hybrid


def test_spinorb_strict_sum_hybrid_matches_jax():
    """The strict-triangle sum of the f32 tier on seeded random inputs
    (o=6, v=10), two chunks: within 1e-9 of JAX's "hybrid" program and
    5e-9 of the port's f64 sum; the chunk length is sized at 4 B an
    element, as JAX's."""
    o, v = 6, 10
    arrs = random_triples_problem(o, v)
    args = tuple(torch.as_tensor(x, dtype=F64) for x in arrs)
    assert TO._pick_clen(212, 10**6, "hybrid") == 2 * TO._pick_clen(212, 10**6, "f64")
    ii, jj, kk, _ = TO.strict_plan(o, v, "hybrid")
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in (ii, jj, kk))
    got = float(TO._triples_total_strict(*args, *idx, clen=len(ii) // 2, precision="hybrid"))
    f64 = float(TO._triples_total_strict(*args, *idx, clen=len(ii), precision="f64"))
    jii, jjj, jkk, jclen = JO.strict_plan(o, v, "hybrid")
    want = float(JO._triples_total_strict(*map(jnp.asarray, arrs), jnp.asarray(jii),
                                          jnp.asarray(jjj), jnp.asarray(jkk), clen=jclen,
                                          precision="hybrid"))
    assert abs(got - want) < VS_JAX_HYBRID
    assert abs(got - f64) < VS_F64 and got != f64


def test_spatial_hybrid_matches_jax_hybrid(spatial):
    """The six energies, D[T] and D(T) of the f32 slab tier with the f32
    CR chain: within 1e-9 of JAX's "hybrid" and 5e-9 of the port's f64
    tier (f64 chain)."""
    jtr = _jax_spatial(spatial, "hybrid")
    tr = _port_spatial(spatial, "hybrid")
    f64 = _port_spatial(spatial, "f64")
    assert tr.precision_used == jtr.precision_used == "hybrid"
    assert (tr.cr_precision, f64.cr_precision) == ("f32", "f64")
    for k in KEYS:
        assert abs(getattr(tr, k) - getattr(jtr, k)) < VS_JAX_HYBRID, k
        assert abs(getattr(tr, k) - getattr(f64, k)) < VS_F64, k
    assert tr.e_crccsd_tt != f64.e_crccsd_tt
    assert tr.calcname == jtr.calcname


def test_cr_intermediates_f32_match_jax(spatial):
    """I_vovv'' and I_ooov'' of the f32 chain: f32 results within CR_RTOL
    of the largest element of JAX's f32 chain, and as far from the f64
    chain as JAX's are (at most twice)."""
    cc, nocc = spatial["cc"], spatial["sys_"].nocc
    tc = from_jax(device="cpu", cc=cc)["cc"]
    got = TS.cr_intermediates(tc.t1, tc.t2, tc.t1_prev, tc.t2_prev, tc.slices, nocc,
                              precision="hybrid")
    f64 = TS.cr_intermediates(tc.t1, tc.t2, tc.t1_prev, tc.t2_prev, tc.slices, nocc)
    want = JS.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, cc.slices, nocc=nocc,
                               precision="hybrid")
    for a, b, c in zip(got, want, f64):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and b.dtype == np.float32
        scale = np.max(np.abs(b))
        assert np.max(np.abs(a.numpy() - b)) <= CR_RTOL * scale
        port_gap = np.max(np.abs(a.double().numpy() - c.numpy()))
        jax_gap = np.max(np.abs(b.astype(np.float64) - c.numpy()))
        assert 0 < port_gap <= 2 * jax_gap


@pytest.mark.parametrize("ccsd_precision,tier", [("f64", "f64"), ("hybrid", "hybrid"),
                                                 ("pallas", "pallas"), ("fused", "fused")])
def test_spatial_cpu_default_tier_is_jaxs(spatial, ccsd_precision, tier):
    """precision=None takes the tier from ccsd_precision as JAX's off a
    TPU, and the CR chain is f32 unless ccsd_precision is "f64"."""
    tr = _port_spatial(spatial, None, ccsd_precision)
    assert tr.precision_used == tier
    assert tr.cr_precision == ("f64" if ccsd_precision == "f64" else "f32")
    assert TS.default_precision(CPU, 53, "hybrid") == "hybrid"
    assert TS.default_precision(torch.device("cuda", 0), 53, "hybrid") == "fused"
    # a named tier of the port is f64, so it asks for no f32 chain
    assert _port_spatial(spatial, "tiled").cr_precision == "f64"
    assert _port_spatial(spatial, "tiled", "hybrid").cr_precision == "f32"


def _driver_pair(wd):
    jrep, rep = JaxReporter(stream=io.StringIO()), Reporter(stream=io.StringIO())
    jres = jdriver.run_calculation(wd, jrep)
    res = run_calculation(wd, rep, device="cpu")
    return jres, jrep.stream.getvalue(), res, rep.stream.getvalue()


@pytest.mark.parametrize("calc,extra", [("CCSD(T)_spinorb", ""),
                                        ("CRCCSD(T)_spatial", HYBRID)],
                         ids=["spinorb_default", "spatial_hybrid"])
def test_drivers_at_the_hybrid_tiers_match(tmp_path, calc, extra):
    """Both drivers as they run on the CPU: the spin-orbital CCSD(T) at
    its default tier ("hybrid" in both) and CRCCSD(T)_spatial at
    ccsd_precision = "hybrid" (digit-GEMM CCSD, f32 CR chain and slab
    tier in both).  Every breakdown value within 1e-9, equal SCF and CC
    iteration counts, the reports equal line for line with the timings
    and the printed values masked."""
    wd = write_h2o(tmp_path, calc, extra)
    jres, jtext, res, text = _driver_pair(wd)
    if res.triples is not None:
        assert res.triples.precision_used == jres.triples.precision_used == "hybrid"
        assert res.triples.cr_precision == "f32"
        for k in KEYS:
            assert abs(getattr(res.triples, k) - getattr(jres.triples, k)) < VS_JAX_HYBRID, k
    for key in ("e_hf", "e_mp2", "e_ccsd", "e_ccsd_t", "total_energy"):
        assert abs(getattr(res, key) - getattr(jres, key)) < VS_JAX_HYBRID, key
    assert res.hf.iterations == len(table_energies(jtext, "delta RMS D"))
    assert res.cc.iterations == len(table_energies(jtext, "delta RMS T2"))
    lines, nums = masked_report(text)
    jlines, jnums = masked_report(jtext)
    assert lines == jlines
    start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
    breakdown = [(a, b) for got, want in zip(nums[start:], jnums[start:])
                 for (a, _), (b, _) in zip(got, want)]
    assert len(breakdown) >= 8
    assert max(abs(a - b) for a, b in breakdown) < VS_JAX_HYBRID


@pytest.mark.parametrize("width", [2, 3])
def test_sharded_hybrid_matches_jax_mesh(width):
    """The sharded f32 tiers on a mesh of `width` CPU entries (the
    operands cast before they are copied): spin-orbital E(T) and the six
    restricted sums within 1e-9 of JAX's sharded "hybrid" on its 8-device
    mesh, and within 1e-12 of the port's one-device f32 tier."""
    mesh = Mesh((CPU,) * width)
    o, v = 6, 10
    arrs = random_triples_problem(o, v)
    args = tuple(torch.as_tensor(x, dtype=F64) for x in arrs)
    got = tts.triples_total_sharded(mesh, *args, nocc=o, precision="hybrid")
    want = jts.triples_total_sharded(jax_mesh(8), *map(jnp.asarray, arrs), nocc=o,
                                     precision="hybrid")
    ii, jj, kk, clen = TO.strict_plan(o, v, "hybrid")
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in (ii, jj, kk))
    one = float(TO._triples_total_strict(*args, *idx, clen=clen, precision="hybrid"))
    assert abs(got - want) < VS_JAX_HYBRID
    assert abs(got - one) < 1e-12

    jlen, flags = 2, dict(doing_T=True, doing_R=True, doing_CR=True)
    arrs = random_spatial_problem(o, v)
    args = tuple(torch.as_tensor(x, dtype=F64) for x in arrs)
    got = torch.stack(tts.triples_spatial_sharded(mesh, *args, nocc=o, jlen=jlen,
                                                  precision="hybrid", **flags))
    want = np.array([float(x) for x in jts.triples_spatial_sharded(
        jax_mesh(8), *map(jnp.asarray, arrs), nocc=o, jlen=jlen, precision="hybrid", **flags)])
    one = torch.stack(TS._triples_total_spatial(*args, nocc=o, jlen=jlen, precision="hybrid",
                                                **flags))
    assert got.dtype == F64
    assert np.abs(got.numpy() - want).max() < VS_JAX_HYBRID
    assert float((got - one).abs().max()) < 1e-12


def test_hybrid_tier_casts_once(monkeypatch):
    """The f64->f32 casts of the slab tier run once, outside the slab
    loop: the slabs receive f32 operands and f64 orbital energies."""
    o, v, jlen = 4, 6, 1
    args = tuple(torch.as_tensor(x, dtype=F64) for x in random_spatial_problem(o, v))
    seen = []
    inner = TS._islice_terms

    def spy(i0, j0, *a, **k):
        seen.append(tuple(x.dtype for x in a))
        return inner(i0, j0, *a, **k)

    monkeypatch.setattr(TS, "_islice_terms", spy)
    TS._triples_total_spatial(*args, nocc=o, jlen=jlen, precision="hybrid",
                              doing_T=True, doing_R=True, doing_CR=True)
    f32 = torch.float32
    assert len(seen) == o * o // jlen
    assert set(seen) == {(f32, f32, f32, f32, f32, F64, F64, f32, f32)}


def test_unknown_precision_still_refused(spinorb):
    st = spinorb
    with pytest.raises(ValueError, match="precision"):
        _port_spinorb(st, "bf16")
    assert "hybrid" in TO.PRECISIONS and "hybrid" in TS.PRECISIONS
    fn = functools.partial(TO._pick_clen, 106, 10**6)
    assert fn("hybrid") >= fn("fused") == fn("f64")
