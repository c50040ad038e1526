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
    1e-12 of JAX's f64 tier.  None and "hybrid" run "f64" on the CPU."""
    jtr = JT.do_ccsd_t_spatial(h2o_cc["sys_"], h2o_cc["cc"], h2o_cc["cfg"],
                               h2o_cc["hf"].levels, JaxReporter(stream=io.StringIO()),
                               precision="f64")
    tr = _port_triples(h2o_cc, precision)
    assert tr.precision_used == (precision if precision in ("pallas", "fused", "tiled") else "f64")
    for k in TRIPLES_KEYS:
        assert abs(getattr(tr, k) - getattr(jtr, k)) < 1e-12, k
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
    """None: "fused" on a CUDA device up to nvirt 128, "tiled" above,
    "f64" on the CPU."""
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
