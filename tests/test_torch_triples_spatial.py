"""Port parity: the restricted (spatial) triples family of
afesp_tpu_torch against the JAX package, on the CPU.  The CUDA kernels
K3 (triples_fused_spatial), K4 (triples_tiled_spatial) and K5
(triples_finale_spatial) cannot run here; their plain PyTorch versions,
which their wrappers use for CPU tensors, are held against the JAX
Pallas kernels in interpret mode (f32 inside, so ~5e-6 relative, as in
tests/test_triples_tiled.py) and against the JAX f64 slab path
`_triples_total_spatial` (1e-12 relative: both f64, only the order of
summation differs).  The kernels themselves are held against these
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_fixtures import random_spatial_problem, write_h2o

from afesp_tpu.config import read_els_in
from afesp_tpu.io import dat as jdat
from afesp_tpu.io.report import Reporter as JaxReporter
from afesp_tpu.methods import triples_spatial as JT
from afesp_tpu.methods.ccsd_spatial import do_ccsd_spatial
from afesp_tpu.methods.hf import do_rhf
from afesp_tpu.methods.mp2 import do_mp2_spatial
from afesp_tpu.ops.triples_pallas import triples_fused_spatial as jax_fused
from afesp_tpu.ops.triples_tiled import triples_tiled_spatial as jax_tiled
from afesp_tpu_torch import config as tcfg
from afesp_tpu_torch.convert import from_jax
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods import triples_spatial as TT
from afesp_tpu_torch.ops import triples_spatial_cuda as K

F64 = torch.float64
ALL = dict(doing_T=True, doing_R=True, doing_CR=True)
TRIPLES_KEYS = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
                "e_crccsd_tt", "D_T", "D_TT")


def _torch(args):
    return tuple(torch.as_tensor(x, dtype=F64) for x in args)


def _jax(args):
    return tuple(jnp.asarray(x) for x in args)


def _plan(o):
    """The port's sorted plan (no zero-weight padding) as CPU tensors."""
    (si, sj, sk), w = TT._sorted_plan(o, torch.device("cpu"))
    return si, sj, sk, w


def _combine(s):
    """(s0..s5) -> the six _SUM_KEYS totals."""
    s = [float(x) for x in s]
    return (s[0], s[0] + s[1], s[2], s[2] + s[3], s[4], s[4] + s[5])


def _jax_f64(args, o, flags):
    return tuple(float(x) for x in JT._triples_total_spatial(
        *_jax(args), nocc=o, jlen=1, precision="f64", **flags))


def _near_interpret(got, want):
    """Against a JAX kernel in interpret mode (f32 inside): the bound of
    tests/test_triples_tiled.py, 5e-6 * max(1, |want|)."""
    for k, a, b in zip(JT._SUM_KEYS, got, want):
        assert abs(a - b) <= 5e-6 * max(1.0, abs(b)), (k, a, b)


def _near_f64(got, want):
    """Against an f64 path: 1e-12 of the largest of the six sums."""
    scale = max(abs(x) for x in want)
    for k, a, b in zip(JT._SUM_KEYS, got, want):
        assert abs(a - b) <= 1e-12 * scale, (k, a, b)


@pytest.mark.parametrize("o,v", [(3, 8), (4, 19)])
def test_k4_plain_matches_jax_tiled_and_f64(o, v):
    """K4's plain version vs the JAX tiled tier (interpret mode, f32
    cubes and slabs) and vs the JAX f64 full grid."""
    args = random_spatial_problem(o, v)
    got = _combine(K.triples_tiled_spatial(*_torch(args), *_plan(o), **ALL))
    assert K.triples_tiled_spatial.launches == 0
    si, sj, sk, w = JT.strict_spatial_plan(o)
    r = jax_tiled(*_jax(args), *_jax((si, sj, sk, w)), nocc=o, B=8, PA=16, **ALL)
    _near_interpret(got, _combine(r))
    _near_f64(got, _jax_f64(args, o, ALL))


def test_k3_plain_matches_jax_fused_kernel():
    """K3's plain version vs the JAX fused kernel (interpret mode; its
    (C, 8, 768) f32 partial grids summed in f64 and weighted as
    do_ccsd_t_spatial does) and vs the JAX f64 full grid."""
    o, v = 3, 8
    args = random_spatial_problem(o, v)
    got = _combine(K.triples_fused_spatial(*_torch(args), *_plan(o), **ALL))
    assert K.triples_fused_spatial.launches == 0
    si, sj, sk, w = JT.strict_spatial_plan(o)
    part = jax_fused(*_jax(args), *_jax((si, sj, sk)), has_m=True, interpret=True)
    g = np.asarray(part, dtype=np.float64).reshape(len(si), 8, 6, 128)
    s = (g.sum(axis=(1, 3)) * w[:, None]).sum(axis=0)
    _near_interpret(got, _combine(s))
    _near_f64(got, _jax_f64(args, o, ALL))


@pytest.mark.parametrize("o,v", [(3, 8), (4, 19)])
def test_k5_plain_matches_jax_finale(o, v):
    """The "pallas" slab of the port (panels as torch einsums, then K5's
    plain version) vs the JAX "pallas" slab (its K5 in interpret mode),
    and vs both packages' f64 slab, for one i-slab."""
    args = random_spatial_problem(o, v)
    i0 = o - 1
    got = TT._islice_terms(i0, 0, *_torch(args), jlen=o, precision="pallas", **ALL)
    assert K.triples_finale_spatial.launches == 0
    want = JT._islice_terms(i0, 0, *_jax(args), jlen=o, precision="pallas", **ALL)
    f64 = TT._islice_terms(i0, 0, *_torch(args), jlen=o, precision="f64", **ALL)
    jf64 = JT._islice_terms(i0, 0, *_jax(args), jlen=o, precision="f64", **ALL)
    assert set(got) == set(want) == set(f64) == set(JT._SUM_KEYS)
    for k in JT._SUM_KEYS:
        a, b, c, d = float(got[k]), float(want[k]), float(f64[k]), float(jf64[k])
        assert abs(a - b) <= 5e-6 * max(1.0, abs(b)), (k, a, b)
        scale = max(abs(float(x)) for x in jf64.values())
        assert abs(a - c) <= 1e-12 * scale, (k, a, c)
        assert abs(c - d) <= 1e-12 * scale, (k, c, d)


FLAG_SETS = [
    dict(doing_T=True, doing_R=False, doing_CR=False),
    dict(doing_T=False, doing_R=True, doing_CR=False),
    dict(doing_T=True, doing_R=True, doing_CR=False),
    dict(doing_T=False, doing_R=False, doing_CR=True),
    dict(doing_T=False, doing_R=False, doing_CR=False),
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: "".join(
    n for n, k in (("T", "doing_T"), ("R", "doing_R"), ("CR", "doing_CR")) if f[k]) or "none")
def test_flag_combinations(flags):
    """Every variant subset (tests/test_triples_tiled.py:64-86): the
    enabled sums of K3's, K4's and K5's plain versions match the full
    run's and JAX's f64, and a sum whose variant is off is exactly 0."""
    o, v = 3, 10
    args = random_spatial_problem(o, v, seed=5)
    full = K.triples_tiled_spatial(*_torch(args), *_plan(o), **ALL)
    on = [True, flags["doing_T"], flags["doing_R"] or flags["doing_CR"],
          (flags["doing_R"] or flags["doing_CR"]) and flags["doing_T"],
          flags["doing_CR"], flags["doing_CR"] and flags["doing_T"]]
    jf64 = JT._triples_total_spatial(*_jax(args), nocc=o, jlen=1, precision="f64", **flags)
    for fn in (K.triples_tiled_spatial, K.triples_fused_spatial):
        s = fn(*_torch(args), *_plan(o), **flags)
        for q in range(6):
            if on[q]:
                assert abs(float(s[q]) - float(full[q])) <= 1e-13 * float(full.abs().max())
            else:
                assert float(s[q]) == 0.0
        tot = _combine(s)
        for q, k in enumerate(JT._SUM_KEYS):
            if k != "e_T" and not on[q]:
                continue
            assert abs(tot[q] - float(jf64[q])) <= 1e-12 * max(abs(x) for x in tot)
    # K5: the panels of one i-slab through the port's "pallas" slab
    acc = TT._islice_terms(1, 0, *_torch(args), jlen=o, precision="pallas", **flags)
    jacc = JT._islice_terms(1, 0, *_jax(args), jlen=o, precision="f64", **flags)
    assert set(acc) == set(jacc)
    for k in acc:
        assert abs(float(acc[k]) - float(jacc[k])) <= 1e-12 * abs(float(jacc["e_T"]))


def test_term_tables_are_the_jax_ones():
    """The port keeps its own copy of the term tables; it must equal the
    JAX package's."""
    from afesp_tpu.ops import triples_pallas as JP

    for name in ("_SPATIAL_F_TERMS", "_SPATIAL_M_TERMS", "_SPATIAL_M3M_TERMS", "_WVV_PAIRS"):
        assert getattr(K, name) == getattr(JP, name), name


def test_fused_descriptors_build_the_numerator_cubes():
    """The GEMM descriptors that K3's kernel runs (fused_term_groups),
    evaluated here with the same offsets and strides in torch, give
    stage 1's t3_D and m3 cubes: the kernel's index arithmetic is held
    on the CPU, where it cannot run."""
    o, v = 4, 7
    args = _torch(random_spatial_problem(o, v, seed=3))
    t1, t2, vvov, oovo, oovv, e_o, e_v, Iv, Jo = args
    ops = K.spatial_operands(t1, t2, vvov, oovo, oovv, Iv, Jo)
    si, sj, sk, w = _plan(o)
    ii, jj, kk = (x.long() for x in (si, sj, sk))
    want = K._chunk_cubes(ops, ii, jj, kk, has_z=False, has_y=False, has_m=True)
    ar = torch.arange(v)
    for cube in ("x", "m"):
        groups = K.fused_term_groups(o, v, cube)
        assert [len(g) for g in groups] == [4, 4, 4]
        got = torch.zeros_like(want[cube])
        for p in range(len(ii)):
            idx = (int(ii[p]), int(jj[p]), int(kk[p]))
            for axis, terms in enumerate(groups):
                for d in terms:
                    A = ops[d["A"]].reshape(-1)
                    B = ops[d["B"]].reshape(-1)
                    a0 = (idx[d["pa"]] * o + idx[d["pb"]]) * d["a_pair"]
                    Kr = torch.arange(d["K"])
                    Am = A[a0 + ar[:, None] * d["a_x"] + Kr[None, :] * d["a_k"]]  # (x, K)
                    Bm = B[idx[d["r"]] * d["b_r"] + Kr[:, None, None] * d["b_k"]
                           + ar[None, :, None] * d["b_p"] + ar[None, None, :] * d["b_q"]]
                    prod = d["sign"] * torch.einsum("xk,kpq->xpq", Am, Bm)
                    # rows are the group's axis, (p, q) the others ascending
                    dst = {0: (0, 1, 2), 1: (1, 0, 2), 2: (1, 2, 0)}[axis]
                    got[p] += prod.permute(*dst)
        assert torch.allclose(got, want[cube], rtol=0, atol=1e-14)


@pytest.fixture(scope="module")
def h2o_cc(tmp_path_factory):
    """JAX's converged restricted CCSD of the generated 24-bf H2O."""
    wd = write_h2o(tmp_path_factory.mktemp("h2o"), calc="CRCCSD(T)_spatial")
    cfg = read_els_in(wd)
    sys_, ints = jdat.read_integrals(wd, cfg.restricted)
    rep = JaxReporter(stream=io.StringIO())
    hf = do_rhf(sys_, ints, cfg, rep, wd)
    mp2 = do_mp2_spatial(sys_, ints, cfg, hf, rep, wd)
    cc = do_ccsd_spatial(sys_, mp2.eri_mo, cfg, hf, rep, wd)
    return dict(wd=wd, sys_=sys_, hf=hf, cc=cc, cfg=cfg)


def test_cr_intermediates_match_jax(h2o_cc):
    """I_vovv'' and I_ooov'' at f64 from the same converged and stale
    amplitudes, at 1e-12."""
    cc, nocc = h2o_cc["cc"], h2o_cc["sys_"].nocc
    st = from_jax(device="cpu", cc=cc)
    tc = st["cc"]
    got = TT.cr_intermediates(tc.t1, tc.t2, tc.t1_prev, tc.t2_prev, st["slices"], nocc)
    want = JT.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, cc.slices, nocc=nocc,
                               precision="f64")
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * max(1.0, np.max(np.abs(b)))


def _port_triples(h2o_cc, precision, calc="CRCCSD(T)_spatial", bug_compat=False):
    st = from_jax(device="cpu", sys_=h2o_cc["sys_"], cc=h2o_cc["cc"])
    tc = tcfg.parse_els_in(h2o_cc["cfg"].raw_text.replace("CRCCSD(T)_spatial", calc))
    tc.ccsd_t_spatial_bug_compat = bug_compat
    return TT.do_ccsd_t_spatial(st["sys_"], st["cc"], tc, h2o_cc["hf"].levels,
                                Reporter(stream=io.StringIO()), precision=precision)


@pytest.mark.parametrize("precision", ["f64", "pallas", "fused", "tiled", None, "hybrid"])
def test_tiers_agree_on_jax_amplitudes(h2o_cc, precision):
    """Every tier of the port (the kernels' plain versions on the CPU) on
    JAX's converged amplitudes: all six energies, D[T] and D(T) within
    1e-12 of JAX's f64 tier.  None runs "f64" on the CPU at
    ccsd_precision "f64"; "hybrid" is the f32 tier (f32 panel GEMMs and
    CR chain), held to JAX's "hybrid" within test_torch_triples_hybrid.py's
    1e-9."""
    jax_tier = "hybrid" if precision == "hybrid" else "f64"
    jtr = JT.do_ccsd_t_spatial(h2o_cc["sys_"], h2o_cc["cc"], h2o_cc["cfg"],
                               h2o_cc["hf"].levels, JaxReporter(stream=io.StringIO()),
                               precision=jax_tier)
    tr = _port_triples(h2o_cc, precision)
    assert tr.precision_used == (precision or "f64")
    tol = 1e-9 if precision == "hybrid" else 1e-12
    for k in TRIPLES_KEYS:
        assert abs(getattr(tr, k) - getattr(jtr, k)) < tol, k
    assert tr.calcname == jtr.calcname == "completely renormalised CCSD(T)"


def test_bug_compat_flag(h2o_cc):
    """Plain CCSD(T)_spatial: the correct (T) by default, the reference's
    CCSD[T]-valued (T) with ccsd_t_spatial_bug_compat, as in JAX."""
    jcfg = read_els_in(h2o_cc["wd"])
    jcfg.ccsd_t_paren, jcfg.ccsd_t_renorm, jcfg.ccsd_t_comp_renorm = True, False, False
    for compat in (False, True):
        jcfg.ccsd_t_spatial_bug_compat = compat
        jtr = JT.do_ccsd_t_spatial(h2o_cc["sys_"], h2o_cc["cc"], jcfg, h2o_cc["hf"].levels,
                                   JaxReporter(stream=io.StringIO()))
        tr = _port_triples(h2o_cc, "fused", calc="CCSD(T)_spatial", bug_compat=compat)
        assert abs(tr.e_ccsd_t - jtr.e_ccsd_t) < 1e-12
        assert abs(tr.e_ccsd_tt - jtr.e_ccsd_tt) < 1e-12
        assert (tr.e_ccsd_tt == tr.e_ccsd_t) == compat


def test_default_tier_rule():
    """None at ccsd_precision "f64": "fused" on a CUDA device up to nvirt
    128, "tiled" above, "f64" on the CPU."""
    cuda = torch.device("cuda", 0)
    assert TT.default_precision(cuda, 53) == "fused"
    assert TT.default_precision(cuda, 128) == "fused"
    assert TT.default_precision(cuda, 159) == "tiled"
    assert TT.default_precision(torch.device("cpu"), 159) == "f64"


def test_unknown_tier_is_refused(h2o_cc):
    with pytest.raises(ValueError, match="precision must be one of"):
        _port_triples(h2o_cc, "f32")


def test_strict_spatial_plan_matches_jax():
    for o in (1, 3, 5, 10):
        for a, b in zip(TT.strict_spatial_plan(o), JT.strict_spatial_plan(o)):
            assert np.array_equal(a, b)
        assert TT.pick_spatial_jlen(o, 53, "f64") == JT.pick_spatial_jlen(o, 53, "f64")
        assert TT.pick_spatial_jlen(o, 106, "pallas") == JT.pick_spatial_jlen(o, 106, "pallas")


def test_wrappers_refuse_other_devices_and_dtypes():
    """A tensor on neither the CPU nor a CUDA device is refused; the
    checks the wrappers run on the card refuse another dtype, a
    non-contiguous tensor, a wrong shape and indices out of range."""
    o, v = 3, 6
    args = _torch(random_spatial_problem(o, v))
    plan = _plan(o)
    meta = tuple(x.to("meta") for x in args)
    mplan = tuple(x.to("meta") for x in plan)
    for fn in (K.triples_fused_spatial, K.triples_tiled_spatial):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*meta, *mplan, **ALL)
    with pytest.raises(ValueError, match="unsupported device"):
        K.triples_finale_spatial(*(torch.zeros(2, v, v, v, device="meta"),) * 2,
                                 torch.zeros(2, 6, v, v, device="meta"),
                                 torch.zeros(2, 2, v, device="meta"),
                                 torch.zeros(2, device="meta"), torch.zeros(v, device="meta"),
                                 torch.zeros(v, device="meta"), doing_T=True, doing_Y=True,
                                 doing_CR=True)
    cpu = torch.device("cpu")
    check = lambda *a: K._check_sorted_triples("k", cpu, *a, *plan, True)
    with pytest.raises(ValueError, match="float64"):
        check(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        check(args[0], args[1].transpose(2, 3), *args[2:])
    with pytest.raises(ValueError, match="expected"):
        check(args[0], args[1][:, :, :-1].contiguous(), *args[2:])
    with pytest.raises(ValueError, match="outside"):
        K._check_sorted_triples("k", cpu, *args, plan[0] + o, *plan[1:], True)
    assert check(*args).shape == (3, len(plan[0]))


# (o, v) of the CPU tests of K4's kernels' indexing: a small shape and
# two where v is a multiple of no tile (8, 16, 32) and v*v is odd
TILE_SHAPES = [(6, 10), (5, 37), (4, 37)]
# the six orders of a tile triple and of an element's permuted reads in
# K4's stage 2 (csrc/triples_tiled_spatial.cu perm_at): abc, bac, acb, cba, bca, cab
ORDERS = [(0, 1, 2), (1, 0, 2), (0, 2, 1), (2, 1, 0), (1, 2, 0), (2, 0, 1)]


def _tile_problem(o, v):
    args = _torch(random_spatial_problem(o, v, seed=5))
    t1, t2, vvov, oovo, oovv, e_o, e_v, Iv, Jo = args
    ops = K.spatial_operands(t1, t2, vvov, oovo, oovv, Iv, Jo)
    si, sj, sk, w = _plan(o)
    return args, ops, tuple(x.long() for x in (si, sj, sk)), w


def _rel_close(got, want, rtol=1e-12):
    assert float((got - want).abs().max()) <= rtol * float(want.abs().max())


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_chunk_cubes_match_jax(o, v):
    """Stage 1's plain version, the port's `_chunk_cubes`, against the
    JAX package's (f32 operands and einsums, as its tiled tier runs
    them on the CPU): every cube to 1e-5 of its largest element."""
    from afesp_tpu.ops.triples_tiled import _chunk_cubes as jax_chunk_cubes

    args = random_spatial_problem(o, v, seed=5)
    t1, t2, vvov, oovo, oovv, e_o, e_v, Iv, Jo = (np.asarray(x, np.float32) for x in args)
    si, sj, sk, _ = _plan(o)
    jcubes = jax_chunk_cubes(
        *(jnp.asarray(x) for x in (t2, vvov.transpose(2, 3, 1, 0), oovo, t2.transpose(1, 0, 3, 2),
                                   Iv.transpose(1, 0, 2, 3), Jo.transpose(0, 1, 3, 2), oovv, t1)),
        *(jnp.asarray(x.numpy()) for x in (si, sj, sk)),
        has_z=True, has_y=True, has_m=True, npa=v)
    _, ops, idx, _ = _tile_problem(o, v)
    cubes = K._chunk_cubes(ops, *idx, has_z=True, has_y=True, has_m=True)
    for name, cube in cubes.items():
        want = torch.as_tensor(np.asarray(jcubes[name + "g"], np.float64))
        _rel_close(cube, want, 1e-5)


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k4_stage1_gemm_gives_the_cubes(o, v):
    """The numerator GEMM of K3 and K4 as its tiles address it, in
    torch: the tile that tiled_tile_dims picks, with its row tiles over
    the NNp rows (rows past NNp read as zeros), its column tiles over the
    Np columns (zeros past Np) and its BK-deep stages over the
    concatenated K axis (zeros past K); row kg lies in term (kg >= Kv) +
    (kg >= 2Kv) + (kg >= 2Kv + Ko) at row kg - start of the blocks that
    tiled_term_offsets points at; A[pq, kg] comes from Rbuf, B[kg, x] from
    Lbuf, and the epilogue puts C[pq, x] (pq < v^2, x < v) at the group's
    place in the group's own cube.  The three groups' cubes, summed in
    group order as the reduction reads them, equal `_chunk_cubes`'s x and
    m to 1e-12 relative."""
    _, ops, (ii, jj, kk), _ = _tile_problem(o, v)
    Np, Kv, Ko, NNp, tile = K.tiled_tile_dims(o, v)
    assert Np % 8 == 0 and Kv % 2 == 0 and Ko % 2 == 0 and NNp % 8 == 0 and NNp >= v * v
    BM, BN, BK = K.TILE_CONFIGS[tile]
    Ktot = 2 * Kv + 2 * Ko
    up = lambda x, b: -(-x // b) * b
    Mp, Npad, Kp = up(NNp, BM), up(Np, BN), up(Ktot, BK)
    Lbuf, Rbuf = K.tiled_operands(ops, True)
    desc = K.tiled_term_offsets(ii, jj, kk, o, v, ("x", "m"))
    assert desc.shape == (2, len(ii), 3, 8) and desc.dtype == torch.int64
    assert not (desc % 2).any()  # every 16-byte copy is aligned
    want = K._chunk_cubes(ops, ii, jj, kk, has_z=False, has_y=False, has_m=True)
    kg = torch.arange(Kp)
    in_k = kg < Ktot
    kg = kg.clamp(max=Ktot - 1)
    term = (kg >= Kv).long() + (kg >= 2 * Kv).long() + (kg >= 2 * Kv + Ko).long()
    start = torch.where(term < 2, term * Kv, 2 * Kv + (term - 2) * Ko)
    ld = torch.where(term < 2, Kv, Ko)
    m, n = torch.arange(Mp), torch.arange(Npad)
    a_ok = in_k[None, :] & (m < NNp)[:, None]
    b_ok = in_k[:, None] & (n < Np)[None, :]
    m, n = m.clamp(max=NNp - 1), n.clamp(max=Np - 1)
    for q, cube in enumerate(("x", "m")):
        parts = torch.empty((3, *want[cube].shape), dtype=F64)
        for p in range(len(ii)):
            for g in range(3):
                loff, roff = desc[q, p, g, 0::2], desc[q, p, g, 1::2]
                A = torch.where(a_ok, Rbuf[roff[term][None, :] + (kg - start)[None, :] * NNp
                                           + m[:, None]], 0.0)
                B = torch.where(b_ok, Lbuf[loff[term][:, None] + n[None, :] * ld[:, None]
                                           + (kg - start)[:, None]], 0.0)
                C = (A @ B)[: v * v, :v]  # rows (p, q) of the two other axes, cols the group's
                if g == 0:
                    parts[g, p] = C.T.reshape(v, v, v)
                elif g == 1:
                    parts[g, p] = C.reshape(v, v, v).permute(0, 2, 1)
                else:
                    parts[g, p] = C.reshape(v, v, v)
        _rel_close((parts[0] + parts[1]) + parts[2], want[cube])


@pytest.mark.parametrize("o,v", [(25, 265), (15, 159), (10, 106), (6, 100), (5, 53), (5, 37),
                                 (4, 37), (4, 130), (6, 10), (3, 8)])
def test_group_gemm_tile_fits_the_shape(o, v):
    """The tile rule of the group GEMM (tiled_tile_dims): the tile that
    issues the fewest multiply-adds (gemm_macs: the tiles over the padded
    rows and columns, the 8-deep steps over K) of TILE_CONFIGS; issued
    over useful (useful_macs: v^2 rows, v columns, K = 2v + 2o) is at most
    1.10 at the trimer's v = 159 and the pentamer's v = 265, below 1.34
    at the dimer's v = 106, and at every shape the tiles cover the padded
    rows NNp, columns Np and depth K."""
    Np, Kv, Ko, NNp, tile = K.tiled_tile_dims(o, v)
    macs = [K.gemm_macs(o, v, t) for t in range(len(K.TILE_CONFIGS))]
    assert macs[tile] == min(macs) and tile == macs.index(min(macs))
    BM, BN, BK = K.TILE_CONFIGS[tile]
    WARPS_M, MT, WARPS_N = K.TILE_WARPS[tile]
    assert BM == 16 * MT * WARPS_M and BN % 8 == 0 and BN // 8 >= WARPS_N and BK % 8 == 0
    up = lambda x, b: -(-x // b) * b
    assert up(NNp, BM) >= NNp >= v * v and up(Np, BN) >= Np >= v
    assert BK % K.GEMM_KSTEP == 0 and up(2 * Kv + 2 * Ko, BK) >= 2 * Kv + 2 * Ko >= 2 * v + 2 * o
    assert macs[tile] == up(NNp, BM) * up(Np, BN) * up(2 * Kv + 2 * Ko, K.GEMM_KSTEP)
    ratio = macs[tile] / K.useful_macs(o, v)
    if v in (159, 265):
        assert ratio <= 1.10
    if v == 106:
        assert ratio < 1.34


def _walk(ntiles: int, blocks: int, nk: int):
    """group_gemm_kernel's persistent walk: block b of `blocks` takes
    tiles b, b + blocks, ...; its stages run tile after tile, nk a tile.
    Yields (block, tile, k block) in the order each block loads them."""
    for b in range(blocks):
        mine = (ntiles - 1 - b) // blocks + 1 if b < ntiles else 0
        for it in range(mine * nk):
            j, kb = divmod(it, nk)
            yield b, b + j * blocks, kb


@pytest.mark.parametrize("tile", range(len(K.TILE_CONFIGS)))
def test_group_gemm_walk_takes_every_tile_once(tile):
    """A group GEMM launch's tiles as the persistent kernel walks them
    (csrc/spatial_gemm.cuh Grid::at and group_gemm_kernel), at the
    pentamer's shape with a chunk of 6 triples and both cubes, for the
    grid launch_group picks (one block an SM, 132 SMs) and others: each
    (cube, triple, row tile, column tile) once, every stage of it once
    and in K order, the column tile fastest, so the blocks in flight at
    once (consecutive tiles) read the same right-hand rows."""
    o, v, C, ncube = 25, 265, 6, 2
    Np, Kv, Ko, NNp, _ = K.tiled_tile_dims(o, v)
    BM, BN, BK = K.TILE_CONFIGS[tile]
    ntn, ntm = -(-Np // BN), -(-NNp // BM)
    ntiles = ntn * ntm * ncube * C
    nk = -(-(2 * Kv + 2 * Ko) // BK)

    def at(t):  # Grid::at
        rest, nt = divmod(t, ntn)
        z, mt = divmod(rest, ntm)
        q, p = divmod(z, C)
        return q, p, mt * BM, nt * BN

    assert [at(t) for t in range(ntn)] == [(0, 0, 0, n * BN) for n in range(ntn)]
    for blocks in (132, 7, ntiles + 5):
        seen = {}
        for b, t, kb in _walk(ntiles, blocks, nk):
            assert t % blocks == b and 0 <= t < ntiles
            seen.setdefault(t, []).append(kb)
        assert sorted(seen) == list(range(ntiles))
        assert all(kbs == list(range(nk)) for kbs in seen.values())
    q, p, m0, n0 = zip(*(at(t) for t in range(ntiles)))
    assert max(q) == ncube - 1 and max(p) == C - 1
    assert max(m0) < NNp <= max(m0) + BM and max(n0) < Np <= max(n0) + BN
    assert len(set(zip(q, p, m0, n0))) == ntiles


def _mma(d, a, b, kdepth):
    """mma.sync m16n8k{kdepth} .f64 on one warp's registers, by PTX's
    fragment layouts: a (32, kdepth / 2), lane (g, t)'s element i is
    A[g + 8 (i & 1)][t + 4 (i >> 1)]; b (32, kdepth / 4), B[t + 4 i][g];
    d (32, 4) += D[g + 8 (q >> 1)][2 t + (q & 1)]."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    A = torch.zeros(16, kdepth, dtype=F64)
    B = torch.zeros(kdepth, 8, dtype=F64)
    for i in range(kdepth // 2):
        A[g + 8 * (i & 1), t + 4 * (i >> 1)] = a[:, i]
    for i in range(kdepth // 4):
        B[t + 4 * i, g] = b[:, i]
    D = A @ B
    for q in range(4):
        d[:, q] += D[g + 8 * (q >> 1), 2 * t + (q & 1)]


@pytest.mark.parametrize("tile", range(len(K.TILE_CONFIGS)))
def test_group_gemm_fragments_give_the_tile_product(tile):
    """One stage of a block tile as the group GEMM's warps read their
    fragments and multiply (csrc/spatial_gemm.cuh mma_stage, store_tile),
    in torch: warp row r covers rows wm = 16 MT r .., the WARPS_N warp
    columns share the tile's n8 tiles in order, NT0 = ceil(N8 / WARPS_N)
    each to the first ones and NT0 - 1 to the rest (TILE_WARPS); lane
    (g, t) reads As[kc + 2t + h][wm + 16 mt + 2g], [.. + 1] (h = 0, 1)
    and Bs[wn + 8 nt + g][kc + 2t], [.. + 1] as 16-byte pairs, runs two
    m16n8k4 MMAs (step h) over each 8-deep step kc, and its accumulator
    element (mt, nt, 2h + e) is C[wm + 16 mt + 2g + h][wn + 8 nt + 2t +
    e].  Over the block's warps every element of the BM x BN tile is
    produced once and equals As^T Bs^T over the stage to 1e-14
    relative."""
    BM, BN, BK = K.TILE_CONFIGS[tile]
    WARPS_M, MT, WARPS_N = K.TILE_WARPS[tile]
    N8 = BN // 8
    NT0 = -(-N8 // WARPS_N)
    wide = N8 - (NT0 - 1) * WARPS_N  # warp columns of NT0 n8 tiles
    cols = [NT0 if c < wide else NT0 - 1 for c in range(WARPS_N)]
    assert BM == 16 * MT * WARPS_M and BN % 8 == 0 and sum(cols) == N8 and min(cols) >= 1
    rng = np.random.default_rng(tile)
    As = torch.as_tensor(rng.standard_normal((BK, BM)))
    Bs = torch.as_tensor(rng.standard_normal((BN, BK)))
    C = torch.zeros(BM, BN, dtype=F64)
    hits = torch.zeros(BM, BN, dtype=torch.long)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    for warp in range(WARPS_M * WARPS_N):
        wm, wc = (warp % WARPS_M) * 16 * MT, warp // WARPS_M
        wn, NT = 8 * sum(cols[:wc]), cols[wc]
        acc = torch.zeros(MT, NT, 32, 4, dtype=F64)
        for kc in range(0, BK, 8):
            a = [[torch.stack([As[kc + 2 * t + h, wm + 16 * mt + 2 * g + x] for x in (0, 1)], 1)
                  for h in (0, 1)] for mt in range(MT)]
            b = [torch.stack([Bs[wn + 8 * nt + g, kc + 2 * t + x] for x in (0, 1)], 1)
                 for nt in range(NT)]
            for nt in range(NT):
                for h in (0, 1):
                    for mt in range(MT):
                        _mma(acc[mt, nt], a[mt][h], b[nt][:, h:h + 1], 4)
        for mt in range(MT):
            for nt in range(NT):
                for h in (0, 1):
                    for e in (0, 1):
                        m, n = wm + 16 * mt + 2 * g + h, wn + 8 * nt + 2 * t + e
                        C[m, n] += acc[mt, nt, :, 2 * h + e]
                        hits[m, n] += 1
    assert int(hits.min()) == int(hits.max()) == 1
    _rel_close(C, As.T @ Bs.T, 1e-14)


@pytest.mark.parametrize("total,v,has_m", [(35, 53, True), (220, 106, True), (220, 106, False),
                                           (680, 159, True), (3, 400, True)])
def test_cube_chunk_len(total, v, has_m):
    """The chunks of K3's and K4's kernels cover every triple in chunks
    of near-equal length, the three groups' x (and m) cubes of a chunk
    stay under CUBE_BYTES (or hold one triple), and the GEMM's z grid of
    (cube, triple) pairs stays within 65535."""
    clen = K.cube_chunk_len(total, v, has_m)
    ncube = 2 if has_m else 1
    nchunk = -(-total // clen)
    assert 1 <= clen <= total and (nchunk - 1) * clen < total
    assert total - (nchunk - 1) * clen > clen - nchunk  # the last chunk is not a runt
    per_triple = 3 * ncube * 8 * v**3
    assert clen == 1 or clen * per_triple <= K.CUBE_BYTES
    assert ncube * clen <= 65535


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k4_zn_and_y_on_the_fly(o, v):
    """K4's stage 2 builds zn and y at an element from t1 and the flat
    (v, v) planes of v_oovv and t2 as it indexes them; they equal
    `_chunk_cubes`'s z3 numerator and y cubes to 1e-12 relative."""
    _, ops, (ii, jj, kk), _ = _tile_problem(o, v)
    want = K._chunk_cubes(ops, ii, jj, kk, has_z=True, has_y=True, has_m=False)
    t1, W, t2 = ops["t1"], ops["W"].reshape(-1), ops["t2"].reshape(-1)
    ar = torch.arange(v)
    a, b, c = ar[:, None, None], ar[None, :, None], ar[None, None, :]
    v2 = v * v
    for p, (i, j, k) in enumerate(zip(ii.tolist(), jj.tolist(), kk.tolist())):
        ti, tj, tk = t1[i][a], t1[j][b], t1[k][c]
        zn = (ti * W[(j * o + k) * v2 + b * v + c] + tj * W[(i * o + k) * v2 + a * v + c]
              + tk * W[(i * o + j) * v2 + a * v + b])
        y = (ti * (tj * tk + t2[(j * o + k) * v2 + b * v + c])
             + tj * t2[(i * o + k) * v2 + a * v + c] + tk * t2[(i * o + j) * v2 + a * v + b])
        _rel_close(zn, want["z"][p])
        _rel_close(y, want["y"][p])


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k4_orbit_tile_addressing(o, v):
    """The stage-2 reduction of K4, which K3 shares
    (csrc/orbit_tile.cuh sorted_orbit_kernel), as `_orbit_walk`
    addresses its shared tiles: a block takes a sorted tile triple
    (A, B, C) of orbit_tiles, stages each distinct tile of the six orders
    once (zeros past v), and for every element of each distinct tile
    reads its five permuted elements from the staged tile the order
    composition names; one partial row of six sums a block.  Every cube
    element is staged once, and the weighted sums equal the plain
    M-operator sums to 1e-12 relative."""
    args, ops, (ii, jj, kk), w = _tile_problem(o, v)
    e_o, e_v = args[5], args[6]
    cubes = K._chunk_cubes(ops, ii, jj, kk, has_z=True, has_y=True, has_m=True)
    eo = e_o[ii] + e_o[jj] + e_o[kk]
    want = (w[:, None] * K._m_sums_plain(cubes, eo, e_v)).sum(dim=0)
    tiles = K.orbit_tiles(v)
    nt = -(-v // 8)
    assert tiles.dtype == torch.int32 and len(tiles) == nt * (nt + 1) * (nt + 2) // 6
    sums, staged = _orbit_walk(cubes["x"], cubes["m"], cubes["y"], cubes["z"],
                               K._denominator(eo, e_v), v, "M")
    total = (w[:, None] * sums).sum(dim=0)
    assert int(staged.min()) == int(staged.max()) == 1
    scale = float(want.abs().max())
    assert float((total - want).abs().max()) <= 1e-12 * scale


def _orbit_walk(x, m, y, zn, D, v, op):
    """orbit_tile.cuh tile_triple_sums over every sorted tile triple, all
    cubes (B, v, v, v) at once, as the kernels address their staged
    tiles: each distinct tile of x and zn of a tile triple's six orders
    staged once (zeros past v), each element's five partners read from
    the staged tile that the order composition names, O (M or 3 xbar)
    applied to both; y and m taken at the element.  Returns the (B, 6)
    sums and how often each cube element was staged."""
    nt = -(-v // 8)
    pad = nt * 8 - v
    P = lambda u: torch.nn.functional.pad(u, (0, pad, 0, pad, 0, pad))
    xs, ms, ys, zs = P(x), P(m), P(y), P(zn)
    Dp = torch.nn.functional.pad(D, (0, pad, 0, pad, 0, pad), value=1.0)
    loc = torch.meshgrid(*(torch.arange(8),) * 3, indexing="ij")
    compose = [[ORDERS.index(tuple(ORDERS[s][ORDERS[r][n]] for n in range(3)))
                for r in range(6)] for s in range(6)]
    if op == "M":
        O = lambda u: 8.0 * u[0] - 4.0 * (u[1] + u[2] + u[3]) + 2.0 * (u[4] + u[5])
    else:
        O = lambda u: 4.0 * u[0] - 6.0 * u[2] + 2.0 * u[4]
    acc = torch.zeros(x.shape[0], 6, dtype=F64)
    staged = torch.zeros(nt * 8, nt * 8, nt * 8, dtype=torch.long)
    for T in K.orbit_tiles(v).tolist():
        tup = [tuple(T[Pm[n]] for n in range(3)) for Pm in ORDERS]
        smap = [tup.index(t) for t in tup]
        sl = lambda s: (slice(None),) + tuple(slice(8 * t, 8 * t + 8) for t in tup[s])
        for s in range(6):
            if smap[s] != s:
                continue
            staged[sl(s)[1:]] += 1
            g = [(a * 8 + l) for a, l in zip(tup[s], loc)]
            mask = (g[0] < v) & (g[1] < v) & (g[2] < v)

            def reads(cube):
                out = []
                for r in range(6):
                    t = cube[sl(smap[compose[s][r]])]
                    out.append(t[:, loc[ORDERS[r][0]], loc[ORDERS[r][1]], loc[ORDERS[r][2]]])
                return out

            u = reads(xs)
            d = Dp[sl(s)]
            t, zt = O(u) / d, O(reads(zs)) / d
            yv, mv = ys[sl(s)], ms[sl(s)]
            terms = [u[0] * t, u[0] * zt, yv * t, yv * zt, mv * t, mv * zt]
            acc += torch.stack([(x_ * mask).sum(dim=(1, 2, 3)) for x_ in terms], dim=1)
    return acc, staged[:v, :v, :v]


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k5_orbit_tile_sums(o, v):
    """K5's reduction (the same tiles with 3 xbar for M, over one
    i-slab's panels of `finale_panels`, zn and y built from the panels'
    factors as the kernel builds them) as `_orbit_walk` addresses it:
    every element staged once, and the sums, divided by 3, equal K5's
    plain version to 1e-12 relative."""
    args = _tile_problem(o, v)[0]
    x, m, mats, vecs, eo, t1i, ev = TT.finale_panels(o - 1, 0, *args, jlen=o, doing_CR=True)
    tj, tk = vecs[:, 0], vecs[:, 1]
    rank3 = lambda X1, X2, X3: (t1i[None, :, None, None] * X1[:, None, :, :]
                                + tj[:, None, :, None] * X2[:, :, None, :]
                                + tk[:, None, None, :] * X3[:, :, :, None])
    zn = rank3(mats[:, 0], mats[:, 1], mats[:, 2])
    y = (rank3(mats[:, 3], mats[:, 4], mats[:, 5])
         + t1i[None, :, None, None] * tj[:, None, :, None] * tk[:, None, None, :])
    sums, staged = _orbit_walk(x, m, y, zn, K._denominator(eo, ev), v, "Xbar")
    got = sums.sum(dim=0) / 3.0
    want = K.triples_finale_spatial_plain(x, m, mats, vecs, eo, t1i, ev, doing_T=True,
                                          doing_Y=True, doing_CR=True)
    assert int(staged.min()) == int(staged.max()) == 1
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("o,v", TILE_SHAPES)
def test_k3_layout_kernel_decode(o, v):
    """The layout kernel of K3 and K4 (csrc/spatial_gemm.cuh
    layout_kernel) as it decodes each element of Lbuf, Rbuf and the term
    offsets from its flat index, the nine bases of `layout_bases` and
    the inputs, in torch: equal to `tiled_operands` and
    `tiled_term_offsets` element for element."""
    args, ops, (ii, jj, kk), _ = _tile_problem(o, v)
    t1, t2, vvov, oovo, oovv, e_o, e_v, Iv, Jo = args
    Np, Kv, Ko, NNp, _ = K.tiled_tile_dims(o, v)
    lefts, rights, _, _, lsize, rsize = K.tiled_layout(o, v, True)
    bases = K.layout_bases(o, v, True)
    lb, rb = bases[:3], bases[3:]
    want_L, want_R = K.tiled_operands(ops, True)
    zero = torch.zeros((), dtype=F64)
    flat = lambda u: u.reshape(-1)

    e = torch.arange(lsize)
    t = (e >= lb[1]).long() + (e >= lb[2]).long()
    Kt = torch.where(t == 0, Kv, Ko)
    rel = e - torch.tensor(lb)[t]
    k, rest = rel % Kt, rel // Kt
    x, pq = rest % Np, rest // Np
    ok = x < v
    L = torch.where(ok & (t == 0) & (k < v),
                    flat(t2)[((pq * v + x) * v + k).clamp(max=t2.numel() - 1)], zero)
    L = torch.where(ok & (t == 1) & (k < o),
                    -flat(oovo)[((pq * v + x) * o + k).clamp(max=oovo.numel() - 1)], L)
    L = torch.where(ok & (t == 2) & (k < o),
                    -flat(Jo)[((pq * o + k) * v + x).clamp(max=Jo.numel() - 1)], L)
    assert torch.equal(L, want_L)

    er = torch.arange(rsize)
    u = sum((er >= rb[q]).long() for q in range(1, 6))
    name = u // 2
    Kr = torch.where(name == 1, Ko, Kv)
    rel = er - torch.tensor(rb)[u]
    nn, rk = rel % NNp, rel // NNp
    k, r = rk % Kr, rk // Kr
    ok = (nn < v * v) & (k < torch.where(name == 1, o, v))
    yy, zz = nn // v, nn % v
    Y, Z = torch.where(u % 2 == 0, yy, zz), torch.where(u % 2 == 0, zz, yy)
    srcs = {0: (vvov, ((Z * v + Y) * o + r) * v + k), 1: (t2, ((k * o + r) * v + Z) * v + Y),
            2: (Iv, ((k * o + r) * v + Y) * v + Z)}
    R = torch.zeros(rsize, dtype=F64)
    for q, (tab, ix) in srcs.items():
        R = torch.where(ok & (name == q), flat(tab)[ix.clamp(0, tab.numel() - 1)], R)
    assert torch.equal(R, want_R)

    dbase, dcoef = K._term_tables(o, v, ("x", "m"), torch.device("cpu"))
    n = len(ii)
    ed = torch.arange(2 * n * 24)
    slot, qp = ed % 24, ed // 24
    p, q = qp % n, qp // n
    row = q * 24 + slot
    dc = dcoef.reshape(-1)
    desc = (dbase.reshape(-1)[row] + ii[p] * dc[3 * row] + jj[p] * dc[3 * row + 1]
            + kk[p] * dc[3 * row + 2])
    assert torch.equal(desc.view(2, n, 3, 8), K.tiled_term_offsets(ii, jj, kk, o, v, ("x", "m")))

