"""Port parity of the multi-device paths (afesp_tpu_torch/parallel/)
against the JAX package's, on the CPU.

The port's meshes list the CPU n times (one process addresses every
entry in turn); JAX's are its 8 virtual CPU devices (tests/conftest.py).
Each test of tests/test_parallel.py has its counterpart here on shared
seeded inputs: the sharded CCSD iteration and solve, both triples
formulations at widths 2, 3 and 8, the full-cube oracle, the stream
tier's limb-sharded solve (each entry holding 1/8 of the limb bytes)
and its CR term.  Where the port splits a product along an axis it does
not contract (dense and digit vvvv), the mesh result is the one-device
result bit for bit.  The drivers at mesh_devices >= 2 are held to each
other in tests/test_torch_parallel_{driver,hybrid,stream}.py.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import random_spatial_problem, random_triples_problem

from afesp_tpu.methods import ccsd_spatial as jsp
from afesp_tpu.methods import ccsd_spinorb as jso
from afesp_tpu.ops import cc_step as jcc
from afesp_tpu.ops.exact_gemm import prechunk_B_chunkscaled as jax_chunkscaled
from afesp_tpu.parallel import ccsd_shard as jcs
from afesp_tpu.parallel import triples_shard as jts
from afesp_tpu.parallel.mesh import default_mesh as jax_mesh
from afesp_tpu_torch import parallel as tpar
from afesp_tpu_torch.methods import ccsd_spatial as tsp
from afesp_tpu_torch.methods import ccsd_spinorb as tso
from afesp_tpu_torch.methods import triples_spatial as tts_mod
from afesp_tpu_torch.methods import triples_spinorb as tto
from afesp_tpu_torch.ops import cc_step as tcc
from afesp_tpu_torch.ops.exact_gemm import prechunk_B_chunkscaled
from afesp_tpu_torch.parallel import ccsd_shard as tcs
from afesp_tpu_torch.parallel import mesh as tmesh
from afesp_tpu_torch.parallel import triples_shard as tts
from afesp_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")
WIDTHS = [2, 3, 8]
# the f64 tiers; the f32 "hybrid" tier is held to JAX's in test_torch_triples_hybrid.py
F64_SPINORB_TIERS = [t for t in tto.PRECISIONS if t != "hybrid"]
F64_SPATIAL_TIERS = [t for t in tts_mod.PRECISIONS if t != "hybrid"]


def cpu_mesh(n: int) -> Mesh:
    return Mesh((CPU,) * n)


def _t(x):
    return torch.as_tensor(np.array(np.asarray(x)), dtype=torch.float64)


def _random_spin_problem(no=4, nv=16, seed=0):
    """tests/test_parallel.py's generator, numpy: (t1, t2, slices as a
    dict of arrays, D_ia, D_ijab)."""
    rng = np.random.default_rng(seed)
    o, v = no, nv
    r = lambda *shape: rng.standard_normal(shape) * 0.05
    names = ("oooo", "ooov", "ovoo", "oovo", "oovv", "ovvo", "ovvv", "vovv", "vvvv")
    shapes = ((o, o, o, o), (o, o, o, v), (o, v, o, o), (o, o, v, o), (o, o, v, v),
              (o, v, v, o), (o, v, v, v), (v, o, v, v), (v, v, v, v))
    slices = {n: r(*s) for n, s in zip(names, shapes)}
    t1 = r(o, v) * 0.4
    t2 = r(o, o, v, v) * 0.4
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    e_o, e_v = e[:o], e[o:]
    D_ia = e_o[:, None] - e_v[None, :]
    D_ijab = (e_o[:, None, None, None] + e_o[None, :, None, None]
              - e_v[None, None, :, None] - e_v[None, None, None, :])
    return t1, t2, slices, D_ia, D_ijab


def _spin_pair(problem):
    """The problem as JAX's and the port's argument tuples."""
    t1, t2, sl, D_ia, D_ijab = problem
    jargs = (jnp.asarray(t1), jnp.asarray(t2), jso.SpinSlices(**{k: jnp.asarray(x)
                                                                for k, x in sl.items()}),
             jnp.asarray(D_ia), jnp.asarray(D_ijab))
    targs = (_t(t1), _t(t2), tso.SpinSlices(**{k: _t(x) for k, x in sl.items()}),
             _t(D_ia), _t(D_ijab))
    return jargs, targs


def test_mesh_lists_the_visible_devices(monkeypatch):
    """JAX's default mesh takes its 8 CPU devices; the port's the visible
    devices of its kind (the CPU alone), the first n of them, and a mesh
    of the CPU listed eight times once visible_devices says so."""
    assert len(jax.devices()) == 8 and jax_mesh(8).devices.size == 8
    assert tmesh.visible_devices(CPU) == [CPU]
    assert tmesh.default_mesh(8, "cpu").size == 1
    monkeypatch.setattr(tmesh, "visible_devices", lambda dev: [dev] * 8)
    m = tmesh.default_mesh(None, "cpu")
    assert m.size == 8 and m.devices == (CPU,) * 8 and m.axis_name == "p"
    assert tmesh.default_mesh(3, "cpu").size == 3
    import afesp_tpu.parallel as jpar

    assert tpar.__all__ == jpar.__all__


@pytest.mark.parametrize("width", [8, 7, 3])
def test_fitting_mesh_matches_jax(width):
    """The sub-mesh that fits nvirt: its size equal to JAX's (none below
    two entries), its entries the leading ones."""
    for nvirt in (19, 21, 38, 48, 53, 106, 159):
        jm = jcs._fitting_mesh(jax_mesh(width), nvirt)
        tm = tcs._fitting_mesh(cpu_mesh(width), nvirt)
        assert (tm is None) == (jm is None)
        if tm is not None:
            assert tm.size == jm.devices.size


def test_sharded_ccsd_iteration_matches_unsharded():
    """One spin-orbital CCSD iteration with its vvvv term split over 8
    entries: the port's one-device iteration bit for bit, and JAX's
    GSPMD-sharded iteration within 1e-12 (JAX's own gate)."""
    jargs, targs = _spin_pair(_random_spin_problem())
    ref1, ref2 = tso._iteration_core(*targs, None, paper_foo=False)
    sh1, sh2 = tcs.ccsd_iteration_sharded(cpu_mesh(8), *targs)
    assert torch.equal(sh1, ref1) and torch.equal(sh2, ref2)
    j1, j2 = jcs.ccsd_iteration_sharded(jax_mesh(8), *jargs)
    np.testing.assert_allclose(sh1.numpy(), np.asarray(j1), rtol=0, atol=1e-12)
    np.testing.assert_allclose(sh2.numpy(), np.asarray(j2), rtol=0, atol=1e-12)


@pytest.mark.parametrize("width", WIDTHS)
def test_sharded_spinorb_triples_match(width):
    """Spin-orbital E(T) over the strict triples at every tier, each
    entry's share: within 1e-11 of the one-device tier and of JAX's
    sharded total (its f64 chunk kernel on its mesh of `width`)."""
    o, v = 6, 10
    arrs = random_triples_problem(o, v)
    args = tuple(_t(x) for x in arrs)
    ii, jj, kk, clen = tto.strict_plan(o, v)
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in (ii, jj, kk))
    one = float(tto._triples_total_strict(*args, *idx, clen=clen, precision="f64"))
    jax_sh = jts.triples_total_sharded(jax_mesh(width), *map(jnp.asarray, arrs), nocc=o,
                                       precision="f64")
    assert abs(jax_sh - one) < 1e-11
    for tier in F64_SPINORB_TIERS:
        got = tts.triples_total_sharded(cpu_mesh(width), *args, nocc=o, precision=tier)
        assert abs(got - one) < 1e-11, tier
        assert abs(got - jax_sh) < 1e-11, tier


@pytest.mark.parametrize("width", WIDTHS)
def test_sharded_spatial_triples_match(width):
    """The six restricted triples sums at every tier, each entry's share
    of the sorted triples or the (i, j-slab) grid: within 1e-11 of the
    one-device "f64" tier and of JAX's sharded (i, j-slab) totals."""
    o, v, jlen = 6, 10, 2
    arrs = random_spatial_problem(o, v)
    args = tuple(_t(x) for x in arrs)
    flags = dict(doing_T=True, doing_R=True, doing_CR=True)
    one = torch.stack(tts_mod._triples_total_spatial(*args, nocc=o, jlen=jlen, **flags))
    jax_sh = np.array([float(x) for x in jts.triples_spatial_sharded(
        jax_mesh(width), *map(jnp.asarray, arrs), nocc=o, jlen=jlen, precision="f64", **flags)])
    assert np.abs(jax_sh - one.numpy()).max() < 1e-11
    for tier in F64_SPATIAL_TIERS:
        got = torch.stack(tts.triples_spatial_sharded(cpu_mesh(width), *args, nocc=o,
                                                      jlen=jlen, precision=tier, **flags))
        assert float((got - one).abs().max()) < 1e-11, tier
        assert np.abs(got.numpy() - jax_sh).max() < 1e-11, tier


def test_triples_energy_sharded_oracle():
    """The full-cube oracle at width 8 (chunks of 25 triples) against
    JAX's and against the strict-triangle total, within 1e-12."""
    o, v = 6, 10
    arrs = random_triples_problem(o, v, seed=3)
    args = tuple(_t(x) for x in arrs)
    got = tpar.triples_energy_sharded(cpu_mesh(8), o, *args, inner_chunk=25)
    want = jts.triples_energy_sharded(jax_mesh(8), o, *map(jnp.asarray, arrs), inner_chunk=25)
    ii, jj, kk, clen = tto.strict_plan(o, v)
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in (ii, jj, kk))
    strict = float(tto._triples_total_strict(*args, *idx, clen=clen, precision="f64"))
    assert abs(got - want) < 1e-12 and abs(got - strict) < 1e-12


def test_sharded_fused_solve_matches_unsharded():
    """The whole spin-orbital f64 solve (DIIS included) with its vvvv
    term split over 8 entries: the port's one-device solve bit for bit
    (counts, energies, t2), and JAX's sharded solve within 1e-11 (its
    own gate), with equal counts."""
    jargs, targs = _spin_pair(_random_spin_problem())
    nerr, maxiter = 6, 25
    t1, t2, v, D_ia, D_ijab = targs
    solver = tso.get_spinorb_solver()
    loop = dict(nerr=nerr, maxiter=maxiter)
    ref = solver(tcc.init_cc_state(torch.zeros_like(t1), t2, nerr), v, D_ia, D_ijab, v.oovv,
                 0.0, 1e-10, 1e-10, **loop)
    got = tcs.ccsd_solve_sharded(cpu_mesh(8), solver,
                                 tcc.init_cc_state(torch.zeros_like(t1), t2, nerr), v, D_ia,
                                 D_ijab, v.oovv, 0.0, 1e-10, 1e-10, **loop)
    assert got[1] == ref[1] and got[2] == ref[2] and torch.equal(got[0].t2_raw, ref[0].t2_raw)

    jt1, jt2, jv, jD1, jD2 = jargs
    jstate = jcc.init_cc_state(jnp.zeros_like(jt1), jt2, nerr)
    tols = (jnp.float64(1e-10), jnp.float64(1e-10))
    jst, jn, jdone, jhe, _ = jcs.ccsd_solve_sharded(
        jax_mesh(8), jso.get_spinorb_solver(), jstate, jv, jD1, jD2, jv.oovv,
        jnp.float64(0.0), *tols, **loop)
    assert len(got[1]) == int(jn) and got[2] == bool(jdone)
    np.testing.assert_allclose(got[1], np.asarray(jhe)[: int(jn)], rtol=0, atol=1e-11)
    np.testing.assert_allclose(got[0].t2_raw.numpy(), np.asarray(jst.t2_raw), rtol=0, atol=1e-11)


def _random_spatial_slices(o=4, v=12, seed=5):
    rng = np.random.default_rng(seed)
    r = lambda *s: _t(rng.standard_normal(s) * 0.05)
    v_oovv = r(o, o, v, v)
    v_oovv = (v_oovv + v_oovv.permute(1, 0, 3, 2)) / 2
    sl = tsp.Slices(v_oovv=v_oovv, v_ovov=r(o, v, o, v), v_vvov=r(v, v, o, v),
                    v_oovo=r(o, o, v, o), v_oooo=r(o, o, o, o), v_vvvv=r(v, v, v, v))
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    D_ia, D_ijab = tsp.denominators(_t(e), o)
    return sl, D_ia, D_ijab


@pytest.mark.parametrize("formulation", ["spatial", "spinorb"])
@pytest.mark.parametrize("hybrid", [False, True], ids=["f64", "hybrid"])
def test_sharded_solve_is_the_one_device_solve(formulation, hybrid):
    """Both formulations' solves at f64 (dense vvvv slices) and "hybrid"
    (digit GEMMs against per-slice digitized vvvv) with the vvvv term
    split over three entries: the one-device solve bit for bit."""
    if formulation == "spatial":
        v, D_ia, D_ijab = _random_spatial_slices()
        solver = tsp.get_spatial_solver(vvvv_split=hybrid)
        t2 = v.v_oovv / D_ijab
        oovv = v.v_oovv
    else:
        _, (t1, t2, v, D_ia, D_ijab) = _spin_pair(_random_spin_problem(no=4, nv=12, seed=2))
        solver = tso.get_spinorb_solver(vvvv_split=hybrid)
        oovv = v.oovv
    state = lambda: tcc.init_cc_state(torch.zeros_like(D_ia), t2, 6)
    loop = dict(nerr=6, maxiter=12)
    ref = solver(state(), v, D_ia, D_ijab, oovv, 0.0, 1e-10, 1e-10, **loop)
    got = tcs.ccsd_solve_sharded(cpu_mesh(3), solver, state(), v, D_ia, D_ijab, oovv, 0.0,
                                 1e-10, 1e-10, **loop)
    assert len(ref[1]) > 3 and got[1] == ref[1] and got[2] == ref[2]
    assert torch.equal(got[0].t1_raw, ref[0].t1_raw) and torch.equal(got[0].t2_raw, ref[0].t2_raw)


def _ext_problem(n: int = 32, nocc: int = 8):
    """tests/test_parallel.py's streaming-tier problem at n=32, nocc=8
    (nvirt=24: 2 limb chunks; JAX's n=60 takes ~2.4 s an iteration on
    the port's CPU digit GEMMs), through JAX's transform; returns JAX's
    and the port's slices (v_vvvv taken out), denominators and limbs."""
    from afesp_tpu.methods.mp2 import _ao_to_mo_oneshot

    rng = np.random.default_rng(21)
    e = rng.standard_normal((n, n, n, n)) * 0.02
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = e + e.transpose(2, 3, 0, 1)
    eri = e / 8.0 + 4.0 * np.einsum("ij,kl->ijkl", np.eye(n), np.eye(n))
    C = np.linalg.qr(rng.standard_normal((n, n)))[0].T
    jv = jsp.make_slices(_ao_to_mo_oneshot(jnp.asarray(eri), jnp.asarray(C)), nocc)
    levels = np.concatenate([-np.arange(1, nocc + 1)[::-1] - 1.0, 2.0 + np.arange(n - nocc)])
    nv = n - nocc
    jB = jax_chunkscaled(jv.v_vvvv.reshape(nv * nv, nv * nv), L=6)
    tv = tsp.Slices(**{f: None if f == "v_vvvv" else _t(getattr(jv, f))
                       for f in tsp.Slices.__dataclass_fields__})
    tB = prechunk_B_chunkscaled(_t(jv.v_vvvv).reshape(nv * nv, nv * nv), L=6)
    jD = jsp.denominators(jnp.asarray(levels), nocc)
    tD = tsp.denominators(_t(levels), nocc)
    return jv._replace(v_vvvv=None), tv, jD, tD, jB, tB


def test_sharded_ext_solve_scales_memory_and_matches():
    """The stream tier's solve with its limbs (2 chunks, padded to 8)
    split over 8 entries: each holds 1/8 of the padded limb bytes, in
    storage of its own; over 8 iterations the solve matches the port's
    one-device solve and JAX's limb-sharded solve at JAX's gates
    (energies 1e-10, t2 1e-8), with equal counts."""
    jv, tv, (jD1, jD2), (tD1, tD2), jB, tB = _ext_problem()
    assert tB[0][0].shape[0] == 2
    mesh = cpu_mesh(8)
    limbs = tcs.shard_vvvv_limbs(mesh, tB)
    padded = tcs._pad_chunk_axis(tB, 8)
    assert limbs.nc == 8 and padded[0][0].shape[0] == 8
    total = sum(c.numel() for c in padded[0]) + padded[1].numel() * 8
    assert all(b * 8 == total for b in limbs.nbytes())
    ptrs = {c.untyped_storage().data_ptr() for chunks, _ in limbs.parts for c in chunks}
    assert len(ptrs) == 8 * len(tB[0])
    assert tcs.shard_vvvv_limbs(mesh, limbs) is limbs

    nerr, maxiter = 6, 8
    t2 = tv.v_oovv / tD2
    state = lambda: tcc.init_cc_state(torch.zeros_like(tD1), t2, nerr)
    args = (tv, tD1, tD2, tv.v_oovv, 0.0, 1e-10, 1e-10)
    loop = dict(nerr=nerr, maxiter=maxiter)
    ref = tsp.ccsd_spatial_solver_ext(state(), *args, tB, **loop)
    got = tcs.ccsd_solve_sharded_ext(mesh, tsp.ccsd_spatial_solver_ext, state(), *args, limbs,
                                     **loop)
    assert len(got[1]) == len(ref[1]) and got[2] == ref[2]
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[0].t2_raw.numpy(), ref[0].t2_raw.numpy(), rtol=0, atol=1e-8)

    jt2 = jv.v_oovv / jD2
    jst, jn, jdone, jhe, _ = jcs.ccsd_solve_sharded_ext(
        jax_mesh(8), jsp.ccsd_spatial_solver_ext,
        jcc.init_cc_state(jnp.zeros_like(jD1), jt2, nerr), jv, jD1, jD2, jv.v_oovv,
        jnp.float64(0.0), jnp.float64(1e-10), jnp.float64(1e-10), jB, **loop)
    assert len(got[1]) == int(jn) and got[2] == bool(jdone)
    np.testing.assert_allclose(got[1], np.asarray(jhe)[: int(jn)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[0].t2_raw.numpy(), np.asarray(jst.t2_raw), rtol=0, atol=1e-8)


def test_cr_vvvv_term_from_limbs_sharded_matches_dense():
    """The CR chain's v_vvvv contraction from limbs split over 8 entries
    (each 1/8 of the padded bytes) and over 2 (nvirt 36: 3 chunks padded
    to 4, two an entry): within 1e-7 of the dense einsum (JAX's gate),
    and within 1e-12 of scale of the one-device streamed term and of
    JAX's term from its chunk-sharded limbs."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    nv, o = 24, 6
    rng = np.random.default_rng(7)
    vvvv = rng.standard_normal((nv, nv, nv, nv)) * 0.1
    t1 = rng.standard_normal((o, nv)) * 0.3
    dense = np.einsum("ecba,ie->ciab", vvvv, t1)

    tB = prechunk_B_chunkscaled(_t(vvvv).reshape(nv * nv, nv * nv), L=6)
    limbs = tcs.shard_vvvv_limbs(cpu_mesh(8), tB)
    assert all(b * 8 == sum(limbs.nbytes()) for b in limbs.nbytes())
    got = tsp._cr_vvvv_term_from_B(_t(t1), limbs, nv=nv).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-7)
    one = tsp._cr_vvvv_term_from_B(_t(t1), tB, nv=nv).numpy()
    scale = max(np.abs(one).max(), 1.0)
    assert np.abs(got - one).max() <= 1e-12 * scale
    nv3 = 36  # 3 chunks of 432 rows
    vvvv3 = rng.standard_normal((nv3,) * 4) * 0.1
    tB3 = prechunk_B_chunkscaled(_t(vvvv3).reshape(nv3 * nv3, -1), L=6)
    limbs3 = tcs.shard_vvvv_limbs(cpu_mesh(2), tB3)
    assert tB3[0][0].shape[0] == 3 and limbs3.nc == 4
    t13 = _t(t1[:, :1].repeat(nv3, 1))
    got3 = tsp._cr_vvvv_term_from_B(t13, limbs3, nv=nv3).numpy()
    one3 = tsp._cr_vvvv_term_from_B(t13, tB3, nv=nv3).numpy()
    assert np.abs(got3 - one3).max() <= 1e-12 * max(np.abs(one3).max(), 1.0)
    np.testing.assert_allclose(got3, np.einsum("ecba,ie->ciab", vvvv3, t13.numpy()), rtol=0,
                               atol=1e-7)

    mesh = jax_mesh(8)
    chunks, s = jcs._pad_chunk_axis(jax_chunkscaled(jnp.asarray(vvvv).reshape(nv * nv, -1),
                                                    L=6), 8)
    sh = NamedSharding(mesh, P(mesh.axis_names[0], None, None))
    jB = ([jax.device_put(c, sh) for c in chunks], jax.device_put(s, sh))
    want = np.asarray(jsp._cr_vvvv_term_from_B(jnp.asarray(t1), jB, nv=nv, streamed=False))
    assert np.abs(got - want).max() <= 1e-12 * scale
