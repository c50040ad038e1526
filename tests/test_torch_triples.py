"""Port parity: the spin-orbital triples of afesp_tpu_torch against the
JAX package, on the CPU.  The CUDA kernels K1 (triples_fused) and K2
(triples_finale) cannot run here; their plain PyTorch versions, which
their wrappers use for CPU tensors, are held against the JAX Pallas
kernels in interpret mode and against the JAX f64 path.  The kernels
themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import io
import itertools

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


# (o, v) of K1's layout tests: even, in block spin order, with ragged
# halves: v/2 = 5 and 37 (not a multiple of 8, (v/2)^2 odd), and
# v/2 + o/2 odd too (each term's K padded to an even count)
K1_TILE_SHAPES = [(O, V), (6, 74), (4, 74)]


def _k1_problem(o, v):
    """Seeded operands projected onto the Sz-allowed blocks, the strict
    triples, K1's plan and its (gemm, energy) tables as tensors."""
    args = _torch(K.sz_project(*random_triples_problem(o, v, seed=5)))
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in JT.strict_triple_list(o))
    plan = K.fused_block_plan(*(x.numpy() for x in idx), o, v)
    return args, idx, plan


def _dense_t3c(args, ii, jj, kk):
    t2, vovv, ovoo = args[1:4]
    v = t2.shape[2]
    L, R = K.fused_operands(t2, vovv, ovoo)
    return (L[jj, kk] @ R[ii] - L[ii, kk] @ R[jj] - L[jj, ii] @ R[kk]).reshape(-1, v, v, v)


def _k1_tile_gemm(args, plan, o, v):
    """K1's numerator as its tiles address it, in torch: for each plan
    row, row kg of its concatenated K axis (terms x Kp rows) lies in term
    kg // Kp at row kg % Kp of the blocks the row's offsets point at;
    A[bc, kg] comes from Rbuf, B[kg, a] from Lbuf, and the product lands
    at t3c[row, a, bc] of the compact (rows, h, h, h) scratch."""
    _, h = K.spin_halves(o, v)
    Np, Kp, MMp = K.fused_tile_dims(o, v)
    Lbuf, Rbuf = K.fused_tile_operands(*args[1:4])
    lflat, rflat = Lbuf.reshape(-1), Rbuf.reshape(-1)
    gemm = torch.as_tensor(plan["gemm"])
    m, a = torch.arange(MMp), torch.arange(Np)
    scratch = torch.empty((len(gemm), h, h * h), dtype=F64)
    for r, row in enumerate(gemm):
        kg = torch.arange(int(row[6]) * Kp)
        term = kg // Kp
        kl = kg - term * Kp
        A = rflat[row[1:6:2][term][None, :] + kl[None, :] * MMp + m[:, None]]   # (MMp, K)
        B = lflat[row[0:6:2][term][:, None] + a[None, :] * Kp + kl[:, None]]    # (K, Np)
        scratch[r] = (A @ B)[: h * h, :h].T
    return scratch.reshape(-1, h, h, h)


@pytest.mark.parametrize("o,v", [(4, 6), (6, 10), (8, 4)])
def test_k1_block_plan_matches_brute_force(o, v):
    """K1's plan against an enumeration of spin assignments: exactly the
    (triple, block) pairs with sa + sb + sc = si + sj + sk, in order; each
    term present where some spin s of f and m makes both of its operand
    blocks allowed, its offsets decoding to (sign, y, z, sa) and to x's
    slot of (sb, sc); the partner rows; and the multiply-add counters
    against a count of the tiles."""
    o2, h = o // 2, v // 2
    Np, Kp, MMp = K.fused_tile_dims(o, v)
    ii, jj, kk = JT.strict_triple_list(o)
    plan = K.fused_block_plan(ii, jj, kk, o, v)
    gemm, energy = plan["gemm"], plan["energy"]
    spin = lambda p: int(p >= o2)
    want = [(t, s) for t, (i, j, k) in enumerate(zip(ii, jj, kk))
            for s in itertools.product((0, 1), repeat=3)
            if sum(s) == spin(i) + spin(j) + spin(k)]
    assert [(int(e[0]), tuple(int(x) for x in e[1:4])) for e in energy] == want
    row_of = {w: r for r, w in enumerate(want)}
    assert list(plan["starts"]) == [sum(1 for t, _ in want if t < n) for n in range(len(ii) + 1)]
    issued = 0
    for r, ((t, (sa, sb, sc)), g, e) in enumerate(zip(want, gemm, energy)):
        i, j, k = ii[t], jj[t], kk[t]
        assert e[4] == row_of[(t, (sb, sa, sc))] and e[5] == row_of[(t, (sc, sb, sa))]
        terms = []
        for y, z, x, sign in ((j, k, i, 0), (i, k, j, 1), (j, i, k, 1)):
            if any(spin(y) + spin(z) == sa + s and s + spin(x) == sb + sc for s in (0, 1)):
                slots = [q for q in itertools.product((0, 1), repeat=2)
                         if 0 <= sum(q) - spin(x) <= 1]
                terms.append(((((sign * o + y) * o + z) * 2 + sa) * Np * Kp,
                              (x * 3 + slots.index((sb, sc))) * Kp * MMp))
        assert g[6] == len(terms) >= 1
        assert [(g[2 * q], g[2 * q + 1]) for q in range(len(terms))] == terms
        assert not g[2 * len(terms) : 6].any() and g[7] == 0
        issued += sum(K.GEMM_BM * K.GEMM_BN * K.GEMM_BK
                      for _ in range(0, h * h, K.GEMM_BM) for _ in range(0, h, K.GEMM_BN)
                      for _ in range(0, len(terms) * Kp, K.GEMM_BK))
    assert K.fused_issued_macs(o, v, gemm[:, 6]) == issued
    Kd = -(-(v + o) // 2) * 2
    cube = len(ii) * sum(K.GEMM_BM * K.GEMM_BN * K.GEMM_BK
                         for _ in range(0, v * v, K.GEMM_BM) for _ in range(0, v, K.GEMM_BN)
                         for _ in range(0, 3 * Kd, K.GEMM_BK))
    assert K.fused_cube_macs(o, v, len(ii)) == cube


def test_k1_counts_at_the_dimer():
    """At the spin-orbital dimer (o = 20, v = 212, 1140 strict triples):
    2940 rows (120 aaa and 120 bbb triples with one block, 900 mixed with
    three), 900 of them with one zero term, and the block tiles issue
    14.8% of the dense design's multiply-adds."""
    ii, jj, kk = JT.strict_triple_list(20)
    plan = K.fused_block_plan(ii, jj, kk, 20, 212)
    terms = plan["gemm"][:, 6]
    assert len(terms) == 2940 and (terms == 2).sum() == 900 and (terms == 3).sum() == 2040
    ratio = K.fused_issued_macs(20, 212, terms) / K.fused_cube_macs(20, 212, len(ii))
    assert 0.148 < ratio < 0.149


def test_fused_chunking_bounds_scratch():
    """K1's chunks hold whole triples, cover the plan's rows in order, and
    keep the compact t3c scratch (one (h, h, h) f64 panel a row) within
    FUSED_SCRATCH_BYTES and the energy pass's grid under 65535 along z;
    the plain version's dense chunk holds one (v, v, v) panel a triple
    within it."""
    for o, v in ((10, 106), (20, 212), (4, 10), (30, 300), (4, 4)):
        h = v // 2
        plan = K.fused_block_plan(*JT.strict_triple_list(o), o, v)
        starts = plan["starts"]
        chunks = K.fused_chunks(starts, h)
        assert chunks[0][0] == 0 and chunks[-1][1] == starts[-1] > 0
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        for r0, r1 in chunks:
            assert r0 in starts and r1 in starts and r1 > r0
            assert 8 * (r1 - r0) * h**3 <= K.FUSED_SCRATCH_BYTES
            assert (r1 - r0) * -(-h // 16) <= 65535
    for total, v in ((120, 106), (1, 10), (560, 150), (10_000, 8)):
        clen = K.fused_chunk_len(total, v)
        assert 1 <= clen <= min(total, 65535)
        assert 8 * clen * v**3 <= max(K.FUSED_SCRATCH_BYTES, 8 * v**3)
        assert clen * -(-v // 16) <= 65535
        nchunk = -(-total // clen)
        assert (nchunk - 1) * clen < total <= nchunk * clen


@pytest.mark.parametrize("o,v", K1_TILE_SHAPES)
def test_k1_tile_operands_match_fused_operands(o, v):
    """The operands K1's GEMM tiles read by spin block: Lbuf[0, y, z, sa]
    holds the rows of a of spin sa of fused_operands' L[y, z] at the
    columns of f and m of spin sy + sz - sa, Lbuf[1] = -Lbuf[0], and
    Rbuf[x, slot] the columns bc of spins (sb, sc) of R[x] at the rows of
    spin sb + sc - sx; zeros elsewhere.  The padding stays under 6% of a
    and of bc at the paths' shapes."""
    args, _, _ = _k1_problem(o, v)
    o2, h = K.spin_halves(o, v)
    L, R = K.fused_operands(*args[1:4])
    Lbuf, Rbuf = K.fused_tile_operands(*args[1:4])
    Np, Kp, MMp = K.fused_tile_dims(o, v)
    assert Lbuf.shape == (2, o, o, 2, Np, Kp) and Rbuf.shape == (o, 3, Kp, MMp)
    assert Np % 8 == 0 and Kp % 2 == 0 and MMp % K.GEMM_BM == 0
    assert torch.equal(Lbuf[1], -Lbuf[0])
    spin = lambda p: int(p >= o2)
    hs = lambda s: slice(s * h, (s + 1) * h)
    os_ = lambda s: slice(v + s * o2, v + (s + 1) * o2)
    wantL, wantR = torch.zeros_like(Lbuf[0]), torch.zeros_like(Rbuf)
    for y, z, sa in itertools.product(range(o), range(o), (0, 1)):
        s = spin(y) + spin(z) - sa
        if s in (0, 1):
            wantL[y, z, sa, :h, :h] = L[y, z, hs(sa), hs(s)]
            wantL[y, z, sa, :h, h : h + o2] = L[y, z, hs(sa), os_(s)]
    Rx = R.reshape(o, v + o, v, v)
    for x in range(o):
        pairs = [q for q in itertools.product((0, 1), repeat=2) if 0 <= sum(q) - spin(x) <= 1]
        for slot, (sb, sc) in enumerate(pairs):
            s = sb + sc - spin(x)
            wantR[x, slot, :h, : h * h] = Rx[x, hs(s), hs(sb), hs(sc)].reshape(h, h * h)
            wantR[x, slot, h : h + o2, : h * h] = Rx[x, os_(s), hs(sb), hs(sc)].reshape(o2, h * h)
    assert torch.equal(Lbuf[0], wantL) and torch.equal(Rbuf, wantR)
    for oo, vv in ((10, 106), (20, 212)):
        Np, _, MMp = K.fused_tile_dims(oo, vv)
        assert Np / (vv // 2) - 1 < 0.06 and MMp / (vv // 2) ** 2 - 1 < 0.06


@pytest.mark.parametrize("o,v", K1_TILE_SHAPES)
def test_k1_tile_gemm_gives_t3c(o, v):
    """The block GEMM as K1's tiles address it (_k1_tile_gemm) gives, in
    each plan row, the block (sa, sb, sc) of the plain version's dense
    t3c = L[j,k]R[i] - L[i,k]R[j] - L[j,i]R[k]; and the dense t3c is
    exactly zero outside the plan's blocks."""
    args, (ii, jj, kk), plan = _k1_problem(o, v)
    _, h = K.spin_halves(o, v)
    scratch = _k1_tile_gemm(args, plan, o, v)
    dense = _dense_t3c(args, ii, jj, kk)
    covered = torch.zeros_like(dense, dtype=torch.bool)
    for r, (p, sa, sb, sc) in enumerate(plan["energy"][:, :4].tolist()):
        blk = (p, slice(sa * h, sa * h + h), slice(sb * h, sb * h + h), slice(sc * h, sc * h + h))
        assert torch.allclose(scratch[r], dense[blk], rtol=0, atol=1e-15)
        covered[blk] = True
    assert not dense[~covered].any()


@pytest.mark.parametrize("o,v", K1_TILE_SHAPES)
def test_k1_energy_pass_indexing(o, v):
    """K1's energy pass as it indexes, in torch: for each plan row, x[abc]
    read from the row's compact block, x[bac] and x[cba] from its partner
    rows, the three permutations of t3d rebuilt from t1 and the triple's
    W planes at the block's spin offsets (never stored), the denominator
    from the levels at those offsets, then one partial for each 32 x 32
    (a, c) tile and range of 16 b of each row, in the plan's row order.
    It equals triples_fused_plain over the dense cube."""
    args, (ii, jj, kk), plan = _k1_problem(o, v)
    t1, _, _, _, W, e_o, e_v = args
    _, h = K.spin_halves(o, v)
    x = _k1_tile_gemm(args, plan, o, v)
    av = torch.arange(h)
    a, b, c = av[:, None, None], av[None, :, None], av[None, None, :]
    tiles, nb = -(-h // 32), -(-h // 16)
    assert K.energy_blocks(h) == nb * tiles**2
    partials = torch.zeros(len(x), nb, tiles, tiles, dtype=F64)
    for r, (p, sa, sb, sc, rbac, rcba) in enumerate(plan["energy"][:, :6].tolist()):
        i, j, k = int(ii[p]), int(jj[p]), int(kk[p])
        ao, bo, co = sa * h, sb * h, sc * h
        px = x[r][a, b, c] - x[rbac][b, a, c] - x[rcba][c, b, a]
        def y(ra, rb, rc):  # t3d at (ra, rb, rc): t1[i,ra]W[j,k,rb,rc] - t1[j,ra]W[i,k,rb,rc] + ...
            return (t1[i, ra] * W[j, k, rb, rc] - t1[j, ra] * W[i, k, rb, rc]
                    + t1[k, ra] * W[i, j, rb, rc])
        py = y(ao + a, bo + b, co + c) - y(bo + b, ao + a, co + c) - y(co + c, bo + b, ao + a)
        d = e_o[i] + e_o[j] + e_o[k] - e_v[ao + a] - e_v[bo + b] - e_v[co + c]
        term = px * (px + py) / d
        for br in range(nb):
            for at in range(tiles):
                for ct in range(tiles):
                    partials[r, br, at, ct] = term[at * 32 : at * 32 + 32, br * 16 : br * 16 + 16,
                                                   ct * 32 : ct * 32 + 32].sum()
    got = float(partials.reshape(-1).sum())
    want = float(K.triples_fused_plain(*args, ii, jj, kk))
    assert abs(got - want) <= 1e-12 * abs(want)


def test_sz_violations_flag_each_tensor():
    """The contract's check: no flag on projected operands; one non-zero
    element in a forbidden block (or a NaN there) flags that tensor only."""
    args, _, _ = _k1_problem(6, 10)
    named = dict(zip(("t1", "t2", "vovv", "ovoo", "oovv"), args[:5]))
    assert K.sz_violations(**named) == []
    for n, (key, where) in enumerate((("t1", (0, 9)), ("t2", (0, 1, 2, 8)),
                                      ("vovv", (0, 4, 1, 2)), ("ovoo", (4, 1, 0, 1)),
                                      ("oovv", (3, 4, 0, 1)))):
        bad = dict(named)
        bad[key] = named[key].clone()
        bad[key][where] = 1e-300 if n % 2 else float("nan")
        assert K.sz_violations(**bad) == [key]


# (o, v) of K2's walk test: the test shape, a ragged one (v not a
# multiple of 8, v*v odd) and one with v + o odd as well
TILE_SHAPES = [(O, V), (5, 37), (4, 37)]


def _tile_problem(o, v):
    args = _torch(random_triples_problem(o, v, seed=5))
    idx = tuple(torch.as_tensor(x, dtype=torch.long) for x in JT.strict_triple_list(o))
    return args, idx


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
