"""Port parity: the spin-orbital triples of afesp_tpu_torch against the
JAX package, on the CPU.  The CUDA kernels K1 (triples_fused) and K2
(triples_finale) cannot run here; their plain PyTorch versions, which
their wrappers use for CPU tensors, are held against the JAX Pallas
kernels in interpret mode and against the JAX f64 path.  The kernels
themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import random_triples_problem, write_h2o

from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import triples_spinorb as JT
from afesp_tpu.methods.ccsd_spinorb import do_ccsd_spinorb
from afesp_tpu.methods.hf import do_rhf
from afesp_tpu.methods.mp2 import do_mp2_spatial
from afesp_tpu.ops.triples_pallas import triples_finale as jax_finale
from afesp_tpu.ops.triples_pallas import triples_fused as jax_fused
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import triples_spinorb as TT
from afesp_tpu_torch.ops import triples_cuda as K

F64 = torch.float64
O, V = 6, 10


@pytest.fixture(scope="module")
def problem():
    args = random_triples_problem(O, V)
    ii, jj, kk = JT.strict_triple_list(O)
    return args, (ii, jj, kk)


def _torch(args):
    return tuple(torch.as_tensor(x, dtype=F64) for x in args)


def _strict_f64(args, idx):
    si, sj, sk, clen = JT.strict_plan(O, V, "f64")
    return float(JT._triples_total_strict(
        *(jnp.asarray(x) for x in args), *(jnp.asarray(x) for x in (si, sj, sk)),
        clen=clen, precision="f64"))


def test_k1_plain_matches_jax_fused_kernel(problem):
    """K1's plain version vs the JAX Pallas kernel (f32 inside, so 5e-8
    relative) and vs the JAX f64 strict path (1e-12 relative)."""
    args, idx = problem
    tidx = tuple(torch.as_tensor(x, dtype=torch.long) for x in idx)
    got = float(K.triples_fused(*_torch(args), *tidx))
    assert K.triples_fused.launches == 0
    jidx = tuple(jnp.asarray(x) for x in idx)
    want_pallas = float(jax_fused(*(jnp.asarray(x) for x in args), *jidx, interpret=True))
    assert abs(got - want_pallas) < 5e-8 * abs(want_pallas)
    want_f64 = 6.0 * _strict_f64(args, idx)
    assert abs(got - want_f64) < 1e-12 * abs(want_f64)


def test_k2_plain_matches_jax_finale_kernel(problem):
    """K2's plain version vs the JAX Pallas finale (f32 panels and
    denominator, interpret mode) on the same panels, at the 5e-9 of
    tests/test_triples_pallas.py."""
    args, idx = problem
    jargs = tuple(jnp.asarray(x) for x in args)
    jidx = tuple(jnp.asarray(x) for x in idx)
    t3c, t3d = JT._chunk_panels(*jidx, *jargs[:5])
    e_o, e_v = args[5], args[6]
    eo_sum = e_o[idx[0]] + e_o[idx[1]] + e_o[idx[2]]
    want = float(jax_finale(t3c.astype(jnp.float32), t3d.astype(jnp.float32),
                            jnp.asarray(eo_sum, jnp.float32), jnp.asarray(e_v, jnp.float32),
                            interpret=True))
    t = lambda x: torch.as_tensor(np.array(x), dtype=F64)
    got = float(K.triples_finale(t(t3c), t(t3d), t(eo_sum), t(e_v)))
    assert K.triples_finale.launches == 0
    assert abs(got - want) < 5e-9


def test_chunk_panels_match_jax(problem):
    args, idx = problem
    jt3c, jt3d = JT._chunk_panels(*(jnp.asarray(x) for x in idx),
                                  *(jnp.asarray(x) for x in args[:5]))
    tidx = tuple(torch.as_tensor(x, dtype=torch.long) for x in idx)
    t3c, t3d = TT._chunk_panels(*tidx, *_torch(args)[:5])
    assert np.max(np.abs(t3c.numpy() - np.asarray(jt3c))) < 1e-15
    assert np.max(np.abs(t3d.numpy() - np.asarray(jt3d))) < 1e-15


@pytest.mark.parametrize("nocc", [3, 6, 10])
def test_strict_triples_match_jax(nocc):
    for a, b in zip(TT.strict_triple_list(nocc), JT.strict_triple_list(nocc)):
        assert np.array_equal(a, b)
    ii, jj, kk, clen = TT.strict_plan(nocc, 106)
    assert len(ii) % clen == 0 and len(ii) >= len(JT.strict_triple_list(nocc)[0])
    assert not (ii[len(JT.strict_triple_list(nocc)[0]):]).any()


@pytest.mark.parametrize("precision", ["f64", "pallas", "fused"])
def test_tiers_match_jax_f64(problem, precision):
    """Every tier of the port's strict (T) sum equals the JAX f64 path."""
    args, idx = problem
    if precision == "fused":
        ii, jj, kk = idx
        clen = len(ii)
    else:
        ii, jj, kk, clen = TT.strict_plan(O, V)
    tidx = tuple(torch.as_tensor(x, dtype=torch.long) for x in (ii, jj, kk))
    got = float(TT._triples_total_strict(*_torch(args), *tidx, clen=clen, precision=precision))
    want = _strict_f64(args, idx)
    assert abs(got - want) < 1e-12 * abs(want)


@pytest.fixture(scope="module")
def h2o_cc(tmp_path_factory):
    wd = write_h2o(tmp_path_factory.mktemp("h2o"))
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    cc = do_ccsd_spinorb(sys_, mp2.eri_mo, cfg, hf, rep, wd)
    e_t = JT.do_ccsd_t_spinorb(sys_, cc, cfg, hf.levels, rep, precision="f64")
    return sys_, cfg, hf, cc, e_t


@pytest.mark.parametrize("precision", [None, "f64", "pallas", "fused", "hybrid"])
def test_ccsd_t_on_jax_amplitudes(h2o_cc, precision):
    """do_ccsd_t_spinorb on the JAX CCSD amplitudes and slices, every tier
    (None picks "f64" on the CPU; "hybrid" runs f64): E(T) within 1e-9 of
    the JAX f64 tier, and the report line in its format."""
    sys_, cfg, hf, cc, e_t = h2o_cc
    st = from_jax(device="cpu", cc=cc)
    rep = Reporter(stream=io.StringIO())
    got = TT.do_ccsd_t_spinorb(sys_, st["cc"], cfg, hf.levels, rep, precision=precision)
    assert abs(got - e_t) < 1e-9
    assert f"Unrestricted CCSD(T) correlation energy (Hartree): {got:15.9f}" in rep.stream.getvalue()


def test_unknown_precision_rejected(h2o_cc):
    sys_, cfg, hf, cc, _ = h2o_cc
    st = from_jax(device="cpu", cc=cc)
    with pytest.raises(ValueError, match="precision"):
        TT.do_ccsd_t_spinorb(sys_, st["cc"], cfg, hf.levels, Reporter(stream=io.StringIO()),
                             precision="bf16")


def test_wrappers_refuse_other_devices(problem):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never computed by the plain version."""
    args, idx = problem
    meta = tuple(torch.empty(x.shape, dtype=F64, device="meta") for x in args)
    midx = tuple(torch.empty(len(idx[0]), dtype=torch.long, device="meta") for _ in idx)
    with pytest.raises(ValueError, match="unsupported device"):
        K.triples_fused(*meta, *midx)
    p = torch.empty((2, V, V, V), dtype=F64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.triples_finale(p, p, torch.empty(2, device="meta"), torch.empty(V, device="meta"))


def test_fused_chunking_bounds_scratch():
    for total, v in ((120, 106), (1, 10), (560, 150), (10_000, 8)):
        clen = K.fused_chunk_len(total, v)
        assert 1 <= clen <= min(total, 65535)
        assert 2 * 8 * clen * v**3 <= max(K.FUSED_SCRATCH_BYTES, 2 * 8 * v**3)
        nchunk = -(-total // clen)
        assert (nchunk - 1) * clen < total <= nchunk * clen
