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
    (None picks "hybrid", the f32 panel tier, on the CPU, as JAX does):
    E(T) within 1e-9 of the JAX f64 tier, and the report line in its
    format."""
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
    """K1's chunk holds one t3c panel of (v, v, v) f64 a triple (t3d is
    never stored) within FUSED_SCRATCH_BYTES."""
    for total, v in ((120, 106), (1, 10), (560, 150), (10_000, 8)):
        clen = K.fused_chunk_len(total, v)
        assert 1 <= clen <= min(total, 65535)
        assert 8 * clen * v**3 <= max(K.FUSED_SCRATCH_BYTES, 8 * v**3)
        assert clen * -(-v // 16) <= 65535
        nchunk = -(-total // clen)
        assert (nchunk - 1) * clen < total <= nchunk * clen


# (o, v): the test shape, a ragged one (v not a multiple of 8, v*v odd)
# and one with v + o odd as well (K padded to an even count)
TILE_SHAPES = [(O, V), (5, 37), (4, 37)]


def _tile_problem(o, v):
    args = _torch(random_triples_problem(o, v, seed=5))
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in JT.strict_triple_list(o))
    return args, idx


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k1_tile_operands_match_fused_operands(o, v):
    """The padded operands K1's GEMM tiles read hold L, -L and R of
    fused_operands and zeros elsewhere; the padding stays under 6% of a
    and of bc at the paths' shapes."""
    args, _ = _tile_problem(o, v)
    L, R = K.fused_operands(*args[1:4])
    Lbuf, Rbuf = K.fused_tile_operands(*args[1:4])
    Np, Kp, NNp = K.fused_tile_dims(o, v)
    assert Lbuf.shape == (2, o, o, Np, Kp) and Rbuf.shape == (o, Kp, NNp)
    assert Np % 8 == 0 and Kp % 2 == 0 and NNp % K.GEMM_BM == 0
    assert torch.equal(Lbuf[0, :, :, :v, : v + o], L)
    assert torch.equal(Lbuf[1], -Lbuf[0])
    assert torch.equal(Rbuf[:, : v + o, : v * v], R)
    pad_l, pad_r = Lbuf[0].clone(), Rbuf.clone()
    pad_l[:, :, :v, : v + o] = 0
    pad_r[:, : v + o, : v * v] = 0
    assert not pad_l.any() and not pad_r.any()
    for oo, vv in ((10, 106), (20, 212)):
        Np, _, NNp = K.fused_tile_dims(oo, vv)
        assert Np / vv - 1 < 0.06 and NNp / vv**2 - 1 < 0.06


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k1_tile_gemm_gives_t3c(o, v):
    """The kernel's GEMM as its tiles address it, in torch: for each
    triple, row kg of the concatenated K axis (3 Kp rows) lies in term
    kg // Kp at row kg % Kp of the blocks that fused_term_offsets points
    at; A[bc, kg] comes from Rbuf, B[kg, a] from Lbuf, and the product
    lands at t3c[p, a, bc] of the (C, v, v, v) scratch.  It equals the
    t3c of the plain version, L[j,k]R[i] - L[i,k]R[j] - L[j,i]R[k]."""
    args, (ii, jj, kk) = _tile_problem(o, v)
    Np, Kp, NNp = K.fused_tile_dims(o, v)
    Lbuf, Rbuf = K.fused_tile_operands(*args[1:4])
    desc = K.fused_term_offsets(ii, jj, kk, o, v)
    assert desc.shape == (len(ii), 6) and desc.dtype == torch.int64
    kg = torch.arange(3 * Kp)
    term = (kg >= Kp).long() + (kg >= 2 * Kp).long()
    kl = kg - term * Kp
    m, a = torch.arange(NNp), torch.arange(Np)
    lflat, rflat = Lbuf.reshape(-1), Rbuf.reshape(-1)
    L, R = K.fused_operands(*args[1:4])
    want = L[jj, kk] @ R[ii] - L[ii, kk] @ R[jj] - L[jj, ii] @ R[kk]
    scratch = torch.empty((len(ii), v, v, v), dtype=F64)
    for p in range(len(ii)):
        loff, roff = desc[p, 0::2], desc[p, 1::2]
        A = rflat[roff[term][None, :] + kl[None, :] * NNp + m[:, None]]      # (NNp, 3Kp)
        B = lflat[loff[term][:, None] + a[None, :] * Kp + kl[:, None]]       # (3Kp, Np)
        scratch.view(len(ii), v, v * v)[p] = (A @ B)[: v * v, :v].T
    assert torch.allclose(scratch.reshape(len(ii), v, v * v), want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k1_energy_pass_indexing(o, v):
    """K1's energy pass as it indexes, in torch: x[abc], x[bac] and x[cba]
    read from the t3c scratch, the three permutations of t3d rebuilt from
    t1 and the triple's W planes (never stored), then the sum over one
    partial for each 32 x 32 (a, c) tile and range of 16 b of each
    triple, in the kernel's order.  It equals triples_fused_plain."""
    args, (ii, jj, kk) = _tile_problem(o, v)
    t1, t2, vovv, ovoo, oovv, e_o, e_v = args
    L, R = K.fused_operands(t2, vovv, ovoo)
    x = (L[jj, kk] @ R[ii] - L[ii, kk] @ R[jj] - L[jj, ii] @ R[kk]).reshape(-1, v, v, v)
    W = oovv.reshape(o, o, v, v)
    av = torch.arange(v)
    a, b, c = av[:, None, None], av[None, :, None], av[None, None, :]
    tiles, nb = -(-v // 32), -(-v // 16)
    assert K.energy_blocks(v) == nb * tiles**2
    partials = torch.zeros(len(ii), nb, tiles, tiles, dtype=F64)
    for p, (i, j, k) in enumerate(zip(ii.tolist(), jj.tolist(), kk.tolist())):
        xf = x[p].reshape(-1)
        px = xf[(a * v + b) * v + c] - xf[(b * v + a) * v + c] - xf[(c * v + b) * v + a]
        def y(r, s, q):  # t3d at (r, s, q): t1[i,r]W[j,k,s,q] - t1[j,r]W[i,k,s,q] + ...
            return (t1[i, r] * W[j, k, s, q] - t1[j, r] * W[i, k, s, q]
                    + t1[k, r] * W[i, j, s, q])
        py = y(a, b, c) - y(b, a, c) - y(c, b, a)
        d = e_o[i] + e_o[j] + e_o[k] - e_v[a] - e_v[b] - e_v[c]
        term = px * (px + py) / d
        for br in range(nb):
            for at in range(tiles):
                for ct in range(tiles):
                    partials[p, br, at, ct] = term[at * 32 : at * 32 + 32, br * 16 : br * 16 + 16,
                                                   ct * 32 : ct * 32 + 32].sum()
    got = float(partials.reshape(-1).sum())
    want = float(K.triples_fused_plain(*args, ii, jj, kk))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k2_walk_indexing(o, v):
    """K2's walk as it indexes, in torch: for each panel, x and y read at
    abc and bac along c and at cba through the transposed tile, P(x) and
    P(y) formed beside each other, then one partial for each 32 x 32
    (a, c) tile and range of 16 b of each panel, in the kernel's
    panel-major order, summed.  It equals triples_finale_plain."""
    args, (ii, jj, kk) = _tile_problem(o, v)
    t3c, t3d = TT._chunk_panels(ii, jj, kk, *args[:5])
    e_o, e_v = args[5], args[6]
    eo_sum = e_o[ii] + e_o[jj] + e_o[kk]
    av = torch.arange(v)
    a, b, c = av[:, None, None], av[None, :, None], av[None, None, :]
    tiles, nb = -(-v // 32), -(-v // 16)
    partials = torch.zeros(len(ii), nb, tiles, tiles, dtype=F64)
    for p in range(len(ii)):
        xf, yf = t3c[p].reshape(-1), t3d[p].reshape(-1)
        px = xf[(a * v + b) * v + c] - xf[(b * v + a) * v + c] - xf[(c * v + b) * v + a]
        py = yf[(a * v + b) * v + c] - yf[(b * v + a) * v + c] - yf[(c * v + b) * v + a]
        d = eo_sum[p] - e_v[a] - e_v[b] - e_v[c]
        term = px * (px + py) / d
        for br in range(nb):
            for at in range(tiles):
                for ct in range(tiles):
                    partials[p, br, at, ct] = term[at * 32 : at * 32 + 32, br * 16 : br * 16 + 16,
                                                   ct * 32 : ct * 32 + 32].sum()
    assert partials.numel() == len(ii) * K.energy_blocks(v)
    got = float(partials.reshape(-1).sum())
    want = float(K.triples_finale_plain(t3c, t3d, eo_sum, e_v))
    assert abs(got - want) <= 1e-12 * abs(want)
