"""The CUDA kernels and the slice on the card (marker `gpu`).

Each test decides inside its body whether a CUDA device is present and
skips without one, so every pytest worker collects the same tests.  On
a machine with a card and without jax (tests/conftest.py imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Nothing here imports jax or the JAX package: the JAX reference values
come from data/h2o-cc-pvtz-2.00_104.45/expected_jax_cpu.json and
expected_jax_cpu_crccsd_t_spatial.json.
"""

import io
import json
import shutil
from pathlib import Path

import pytest
import torch
from torch_fixtures import random_spatial_problem, random_triples_problem

from afesp_tpu_torch.methods import triples_spatial as TS
from afesp_tpu_torch.methods import triples_spinorb as T
from afesp_tpu_torch.ops import triples_cuda as K
from afesp_tpu_torch.ops import triples_spatial_cuda as S

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _problem(dev, o, v, seed=7, sz=False):
    """Seeded (T) inputs on dev and the strict triples; with sz, projected
    onto the Sz-allowed spin blocks (what K1 takes, as an RHF reference
    leaves them)."""
    args = random_triples_problem(o, v, seed)
    args = K.sz_project(*args) if sz else args
    args = tuple(torch.as_tensor(x, dtype=F64, device=dev) for x in args)
    idx = tuple(torch.as_tensor(x, dtype=torch.long, device=dev) for x in T.strict_triple_list(o))
    return args, idx


# (o, v): the small test shape, the H2O/cc-pVTZ shape, and nvirt > 128
# (the TPU kernel's cap, which K1 does not have)
SHAPES = [(6, 10), (10, 106), (4, 130)]
# K1's shapes, even as its spin blocks need: the small test shape, the
# H2O/cc-pVTZ shape, nvirt > 128, the spin-orbital dimer's (1140 triples,
# 2940 block rows, 16 chunks), and v/2 = 37 (not a multiple of 8,
# (v/2)^2 odd), with v/2 + o/2 odd in the last (K padded a term)
K1_SHAPES = [(6, 10), (10, 106), (4, 130), (20, 212), (10, 74), (4, 74)]


@pytest.mark.parametrize("o,v", K1_SHAPES)
def test_k1_kernel_matches_plain(o, v):
    dev = _card()
    args, idx = _problem(dev, o, v, sz=True)
    before = K.triples_fused.launches
    got = K.triples_fused(*args, *idx)
    again = K.triples_fused(*args, *idx)
    want = K.triples_fused_plain(*args, *idx)
    torch.cuda.synchronize()
    assert K.triples_fused.launches == before + 2
    assert torch.equal(got, again)  # fixed-order sums, no atomics
    # both f64: only the order of summation differs
    assert abs(float(got) - float(want)) <= 1e-11 * abs(float(want))


@pytest.mark.parametrize("tensor,where", [("t2", (0, 1, 2, 8)), ("vovv", (0, 4, 1, 2))])
def test_k1_refuses_a_forbidden_spin_block(tensor, where):
    """One non-zero element in an Sz-forbidden block of t2 or vovv makes
    K1 raise: it computes the allowed blocks only, with no dense
    fallback."""
    dev = _card()
    args, idx = _problem(dev, 6, 10, sz=True)
    args = list(args)
    pos = {"t2": 1, "vovv": 2}[tensor]
    args[pos] = args[pos].clone()
    args[pos][where] = 1e-3
    before = K.triples_fused.launches
    with pytest.raises(ValueError, match=f"forbidden spin block of {tensor}"):
        K.triples_fused(*args, *idx)
    assert K.triples_fused.launches == before


# K2 also at the spin-orbital dimer's shape and at ragged ones: v not a
# multiple of 8 and v*v odd, and v + o odd too
K2_SHAPES = SHAPES + [(20, 212), (5, 37), (4, 37)]


@pytest.mark.parametrize("o,v", K2_SHAPES)
def test_k2_kernel_matches_plain(o, v):
    dev = _card()
    args, idx = _problem(dev, o, v)
    # the panels of as many triples as 4 GB of t3c and t3d hold (all of
    # them up to the H2O/cc-pVTZ shape; 26 at the dimer's)
    cap = max(1, int(4e9 // (16 * v**3)))
    ii, jj, kk = (x[:cap] for x in idx)
    t3c, t3d = T._chunk_panels(ii, jj, kk, *args[:5])
    e_o, e_v = args[5], args[6]
    panels = (t3c.contiguous(), t3d.contiguous(), (e_o[ii] + e_o[jj] + e_o[kk]).contiguous(), e_v)
    before = K.triples_finale.launches
    got = K.triples_finale(*panels)
    again = K.triples_finale(*panels)
    want = K.triples_finale_plain(*panels)
    torch.cuda.synchronize()
    assert K.triples_finale.launches == before + 2
    assert torch.equal(got, again)
    assert abs(float(got) - float(want)) <= 1e-11 * abs(float(want))


def test_wrappers_check_their_arguments():
    dev = _card()
    args, idx = _problem(dev, 6, 10, sz=True)
    with pytest.raises(ValueError, match="float64"):
        K.triples_fused(args[0].float(), *args[1:], *idx)
    with pytest.raises(ValueError, match="contiguous"):
        K.triples_fused(args[0], args[1].transpose(2, 3), *args[2:], *idx)
    with pytest.raises(ValueError, match="outside"):
        K.triples_fused(*args, idx[0] + 6, *idx[1:])
    with pytest.raises(ValueError, match="is on cpu"):
        K.triples_fused(*args[:5], args[5].cpu(), args[6], *idx)
    p = torch.zeros((2, 10, 10, 10), dtype=F64, device=dev)
    with pytest.raises(ValueError, match="panels"):
        K.triples_finale(p, p[:1], torch.zeros(2, dtype=F64, device=dev),
                         torch.zeros(10, dtype=F64, device=dev))


def test_pvtz_slice_on_the_card(tmp_path):
    """run_calculation with no device runs on the card: the four totals
    within 1e-8 Ha of the JAX package's CPU run, equal iteration counts,
    K1 launched on the way."""
    _card()
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter

    fixture = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
    expected = json.loads((fixture / "expected_jax_cpu.json").read_text())
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
        shutil.copy(fixture / f, tmp_path / f)
    (tmp_path / "eri.dat").symlink_to(REPO / "data" / "h2o-cc-pvtz" / "eri.dat")
    before = K.triples_fused.launches
    res = run_calculation(tmp_path, Reporter(stream=io.StringIO()))
    assert K.triples_fused.launches > before
    e0 = res.e_hf + res.e_nuc
    got = {"e_hf_total": e0, "e_mp2_total": e0 + res.e_mp2,
           "e_ccsd_total": e0 + res.e_ccsd, "e_ccsd_t_total": e0 + res.e_ccsd_t}
    for key, val in got.items():
        assert abs(val - expected[key]) < 1e-8, key
    assert res.hf.iterations == expected["scf_iterations"]
    assert res.cc.iterations == expected["cc_iterations"]
    assert res.cc.t1.device.type == "cuda"


def _random_eri_mo(n: int, seed: int = 5):
    """A seeded chemist-order (pq|rs) tensor with the 8-fold symmetry of
    real orbitals, and levels below zero for the three occupied orbitals
    and above it for the rest."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n, n, n)) * 0.05
    x = x + x.transpose(1, 0, 2, 3)
    x = x + x.transpose(0, 1, 3, 2)
    x = x + x.transpose(2, 3, 0, 1)
    return x, np.sort(rng.uniform(0.5, 2.0, n)) * np.where(np.arange(n) < 3, -1.0, 1.0)


def test_blocked_vvvv_iteration_matches_dense_on_the_card():
    """Three spin-orbital CCSD iterations (through the Sz-blocked einsum)
    from the MP1 guess, with the vvvv slice held dense and as its spin
    blocks, agree on the card and with the CPU's dense run."""
    import numpy as np

    from afesp_tpu_torch.methods import ccsd_spinorb as CS

    dev = _card()
    eri, levels = _random_eri_mo(14)
    out = {}
    for name, d, block in (("cpu", "cpu", False), ("dense", dev, False), ("block", dev, True)):
        v, D_ia, D_ijab, t1, t2, _, _, err = CS.spinorb_cc_init(
            torch.as_tensor(eri, device=d), torch.as_tensor(levels, device=d), 3,
            block_vvvv=block)
        assert float(err) < 1e-10
        assert (v.vvvv is None) == block
        for _ in range(3):
            t1, t2 = CS._iteration_core(t1, t2, v, D_ia, D_ijab, paper_foo=False)
        out[name] = (t1.cpu().numpy(), t2.cpu().numpy())
    scale = np.abs(out["cpu"][1]).max()
    for name in ("dense", "block"):
        for got, want in zip(out[name], out["cpu"]):
            assert np.max(np.abs(got - want)) < 1e-12 * scale, name


# (o, v) of the spatial kernels: a small shape, H2O/cc-pVTZ's, and
# nvirt > 128 (the TPU kernels' cap, which K3 and K4 do not have)
SPATIAL_SHAPES = [(3, 8), (5, 53), (4, 130)]
ALL = dict(doing_T=True, doing_R=True, doing_CR=True)


def _spatial(dev, o, v):
    args = tuple(torch.as_tensor(x, dtype=F64, device=dev)
                 for x in random_spatial_problem(o, v))
    (si, sj, sk), w = TS._sorted_plan(o, dev)
    return args, (si, sj, sk, w)


def _six_close(got, want):
    """Both f64, only the order of summation differs: 1e-11 of each sum,
    or of 1e-6 of the largest where a sum is nearer 0 than that."""
    floor = 1e-6 * float(want.abs().max())
    for g, w in zip(got.tolist(), want.tolist()):
        assert abs(g - w) <= 1e-11 * max(abs(w), floor), (g, w)


# K4 also at the dimer's and the trimer's shapes (the trimer's default
# tier), K3 at the dimer's (its default tier there); both at a ragged v
# that is a multiple of neither 8 nor 16; K3 at a v whose group axis the
# parent's 64-wide tiles ran as 128 columns for 104
K3_K4_CASES = [(k, o, v) for o, v in SPATIAL_SHAPES + [(4, 37)]
               for k in ("triples_fused_spatial", "triples_tiled_spatial")] + [
    ("triples_tiled_spatial", 10, 106), ("triples_tiled_spatial", 15, 159),
    ("triples_fused_spatial", 10, 106), ("triples_fused_spatial", 6, 100)]


@pytest.mark.parametrize("kernel,o,v", K3_K4_CASES)
def test_k3_k4_kernels_match_plain(kernel, o, v):
    dev = _card()
    args, plan = _spatial(dev, o, v)
    fn, plain = getattr(S, kernel), getattr(S, kernel + "_plain")
    before = fn.launches
    got = fn(*args, *plan, **ALL)
    again = fn(*args, *plan, **ALL)
    want = plain(*args, *plan, **ALL)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)  # fixed-order sums, no atomics
    _six_close(got, want)


# sorted triples of the pentamer's shape (o = 25, v = 265): two equal
# (i = j, j = k), all equal, and distinct
PENTAMER_TRIPLES = [(0, 0, 1), (3, 3, 24), (2, 7, 7), (11, 24, 24), (5, 5, 5), (0, 1, 2),
                    (4, 13, 22), (9, 10, 17)]


def test_k4_at_the_pentamer_shape_matches_plain():
    """K4 at the pentamer's shape on hand-picked sorted triples, all
    variants on: within 1e-11 of its plain version, a relaunch bit for
    bit the same; every group GEMM launch holds more than one tile for
    each block the card keeps resident, and issues at most 1.10 times the
    multiply-adds of the true shapes (the parent's tiles: 1.27)."""
    dev = _card()
    o, v = 25, 265
    args = tuple(torch.as_tensor(x, dtype=F64, device=dev)
                 for x in random_spatial_problem(o, v))
    ii, jj, kk = (torch.tensor([t[q] for t in PENTAMER_TRIPLES], dtype=torch.int32,
                               device=dev) for q in range(3))
    w = torch.tensor([1.0 if i < j < k else 1.0 / 6.0 if i == j == k else 0.5
                      for i, j, k in PENTAMER_TRIPLES], dtype=F64, device=dev)
    fn = S.triples_tiled_spatial
    before, gemm = fn.launches, S.spatial_gemm
    counts = (gemm.launches, gemm.issued_macs, gemm.useful_macs)
    got = fn(*args, ii, jj, kk, w, **ALL)
    again = fn(*args, ii, jj, kk, w, **ALL)
    want = S.triples_tiled_spatial_plain(*args, ii, jj, kk, w, **ALL)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    _six_close(got, want)
    n = len(PENTAMER_TRIPLES)
    clen = S.cube_chunk_len(n, v, True)
    launches, issued, useful = (a - b for a, b in zip(
        (gemm.launches, gemm.issued_macs, gemm.useful_macs), counts))
    assert launches == 2 * 3 * -(-n // clen)
    assert useful == 2 * 3 * 2 * n * S.useful_macs(o, v) and issued <= 1.10 * useful
    Np, _, _, NNp, tile = S.tiled_tile_dims(o, v)
    BM, BN, _ = S.TILE_CONFIGS[tile]
    tiles = -(-Np // BN) * -(-NNp // BM) * 2 * min(clen, n - (-(-n // clen) - 1) * clen)
    assert tiles > 2 * torch.cuda.get_device_properties(dev).multi_processor_count


# K5 also at the dimer's shape (100 panels of one i-slab) and a ragged one
K5_SHAPES = SPATIAL_SHAPES[:2] + [(10, 106), (4, 37)]


@pytest.mark.parametrize("o,v", K5_SHAPES)
def test_k5_kernel_matches_plain(o, v):
    dev = _card()
    args, _ = _spatial(dev, o, v)
    panels = TS.finale_panels(o - 1, 0, *args, jlen=o, doing_CR=True)
    flags = dict(doing_T=True, doing_Y=True, doing_CR=True)
    before = S.triples_finale_spatial.launches
    got = S.triples_finale_spatial(*panels, **flags)
    again = S.triples_finale_spatial(*panels, **flags)
    want = S.triples_finale_spatial_plain(*panels, **flags)
    torch.cuda.synchronize()
    assert S.triples_finale_spatial.launches == before + 2
    assert torch.equal(got, again)
    _six_close(got, want)


FLAG_SUBSETS = {
    "T": dict(doing_T=True, doing_R=False, doing_CR=False),
    "TR": dict(doing_T=True, doing_R=True, doing_CR=False),
    "TRCR": dict(doing_T=True, doing_R=True, doing_CR=True),
    "R": dict(doing_T=False, doing_R=True, doing_CR=False),
    "CR": dict(doing_T=False, doing_R=False, doing_CR=True),
}


@pytest.mark.parametrize("flags", list(FLAG_SUBSETS))
@pytest.mark.parametrize("kernel", ["triples_fused_spatial", "triples_finale_spatial"])
def test_k3_k5_flag_subsets(kernel, flags):
    """Each variant subset takes its own branches of the staging and the
    sums: K3 and K5 at a ragged shape against their plain versions, and
    a sum whose variant is off exactly 0."""
    dev = _card()
    o, v = 4, 37
    f = FLAG_SUBSETS[flags]
    args, plan = _spatial(dev, o, v)
    if kernel == "triples_fused_spatial":
        fn = lambda: S.triples_fused_spatial(*args, *plan, **f)
        plain = lambda: S.triples_fused_spatial_plain(*args, *plan, **f)
    else:
        panels = TS.finale_panels(o - 1, 0, *args, jlen=o, doing_CR=f["doing_CR"])
        fk = dict(doing_T=f["doing_T"], doing_Y=f["doing_R"] or f["doing_CR"],
                  doing_CR=f["doing_CR"])
        fn = lambda: S.triples_finale_spatial(*panels, **fk)
        plain = lambda: S.triples_finale_spatial_plain(*panels, **fk)
    counter = getattr(S, kernel)
    before = counter.launches
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(got, again)
    _six_close(got, want)
    y = f["doing_R"] or f["doing_CR"]
    on = [True, f["doing_T"], y, y and f["doing_T"], f["doing_CR"],
          f["doing_CR"] and f["doing_T"]]
    for q in range(6):
        if not on[q]:
            assert float(got[q]) == 0.0


def test_spatial_wrappers_check_their_arguments():
    dev = _card()
    args, (si, sj, sk, w) = _spatial(dev, 3, 8)
    for fn in (S.triples_fused_spatial, S.triples_tiled_spatial):
        with pytest.raises(ValueError, match="float64"):
            fn(args[0].float(), *args[1:], si, sj, sk, w, **ALL)
        with pytest.raises(ValueError, match="contiguous"):
            fn(args[0], args[1].transpose(2, 3), *args[2:], si, sj, sk, w, **ALL)
        with pytest.raises(ValueError, match="outside"):
            fn(*args, si + 3, sj, sk, w, **ALL)
        with pytest.raises(ValueError, match="is on cpu"):
            fn(*args[:5], args[5].cpu(), *args[6:], si, sj, sk, w, **ALL)
    panels = TS.finale_panels(0, 0, *args, jlen=3, doing_CR=True)
    with pytest.raises(ValueError, match="expected"):
        S.triples_finale_spatial(panels[0][:1], *panels[1:], doing_T=True, doing_Y=True,
                                 doing_CR=True)


def test_pvtz_spatial_slice_on_the_card(tmp_path):
    """run_calculation with no device runs CRCCSD(T)_spatial on the card:
    every value of the breakdown within 1e-8 of the JAX package's CPU
    run, equal iteration counts, K3 launched on the way."""
    _card()
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter

    fixture = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
    expected = json.loads((fixture / "expected_jax_cpu_crccsd_t_spatial.json").read_text())
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
        shutil.copy(fixture / f, tmp_path / f)
    (tmp_path / "els.in").write_text(expected["els_in"])
    (tmp_path / "eri.dat").symlink_to(REPO / "data" / "h2o-cc-pvtz" / "eri.dat")
    before = S.triples_fused_spatial.launches
    res = run_calculation(tmp_path, Reporter(stream=io.StringIO()))
    assert S.triples_fused_spatial.launches > before
    assert res.triples.precision_used == "fused"
    assert abs(res.e_hf + res.e_nuc - expected["e_hf_total"]) < 1e-8
    assert abs(res.e_ccsd - expected["e_ccsd_corr"]) < 1e-8
    assert abs(res.t1_diagnostic - expected["t1_diagnostic"]) < 1e-8
    for key, val in expected["triples"].items():
        assert abs(getattr(res.triples, key) - val) < 1e-8, key
    assert res.hf.iterations == expected["scf_iterations"]
    assert res.cc.iterations == expected["cc_iterations"]
    assert res.cc.t1.device.type == "cuda"


# --- the integral engine and the read-in on the card -----------------------


@pytest.mark.parametrize("basis_name", ["cc-pvdz", "cc-pvtz"])
def test_engine_on_the_card_matches_its_cpu_run(basis_name):
    """S, T, V and the packed ERIs built on the card against the port's
    own CPU engine, to 1e-12 absolute (H2O at 1.80 A, 104.45 deg)."""
    from afesp_tpu_torch.integrals import engine as E
    from afesp_tpu_torch.utils.wrapper import water_geometry

    dev = _card()
    charges, coords = water_geometry(1.80, 104.45)
    basis = E.build_basis(charges, coords, basis_name)
    for fn in (E.overlap, E.kinetic):
        assert float((fn(basis, dev).cpu() - fn(basis, "cpu")).abs().max()) <= 1e-12
    v = E.nuclear(basis, charges, coords, dev).cpu() - E.nuclear(basis, charges, coords, "cpu")
    assert float(v.abs().max()) <= 1e-12
    got = E.eri_packed(basis, dev)
    assert got.device.type == "cuda"
    assert float((got.cpu() - E.eri_packed(basis, "cpu")).abs().max()) <= 1e-12


def test_boys_on_the_card_matches_the_cpu():
    """The Boys function through the card's gammainc over T from 0 (the
    T < 1e-13 branch) to 1e7, past what the dimer's primitives reach,
    every order to 12."""
    from afesp_tpu_torch.integrals import engine as E

    dev = _card()
    T_ = torch.cat([torch.tensor([0.0, 1e-14, 1e-12], dtype=F64),
                    torch.logspace(-9, 7, 4000, dtype=F64)])
    got = E.boys(12, T_.to(dev)).cpu()
    assert float((got - E.boys(12, T_)).abs().max()) <= 1e-14


def test_device_unpack_matches_unpack_eri_host():
    """The one gather on the card against the host unpack, bit for bit,
    and IntStore.eri_on_device sends only the packed store."""
    import numpy as np

    from afesp_tpu_torch.io import dat
    from afesp_tpu_torch.ops.packed_eri import pack_eri, unpack_eri

    dev = _card()
    n = 13
    rng = np.random.default_rng(2)
    npair = n * (n + 1) // 2
    packed = rng.standard_normal(npair * (npair + 1) // 2)
    got = unpack_eri(torch.as_tensor(packed, device=dev), n)
    assert torch.equal(got.cpu(), torch.as_tensor(dat.unpack_eri_host(packed, n)))
    assert torch.equal(pack_eri(got).cpu(), torch.as_tensor(packed))
    ints = dat.IntStore(nbasis=n, eri_packed=packed)
    assert torch.equal(ints.eri_on_device(dev), got)


# the digit GEMM's (M, K, N) on the card: ragged shapes that need the
# _int_mm padding (M <= 16, K and N not multiples of 8), three K chunks
# of the f32 route, and an o^2 x v^2 slice of the dimer's vvvv shape
DIGIT_SHAPES = [(5, 13, 7), (37, 1300, 29), (100, 2809, 2809)]


@pytest.mark.parametrize("M,K,N", DIGIT_SHAPES)
def test_digit_gemm_on_the_card_matches_the_cpu(M, K, N):
    """exact_gemm on the card equals its CPU run bit for bit on every
    flat-scale route (direct, prechunked on either side and both, the
    int8 recombination) and on both pair routes (_int_mm, f32); the
    per-chunk-scaled operand holds 1e-14 of scale (its chunk sum
    rounds); f32 matmul runs without TF32."""
    import numpy as np

    from afesp_tpu_torch.ops import exact_gemm as EG

    dev = _card()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    rng = np.random.default_rng(M + K + N)
    A = torch.as_tensor(rng.standard_normal((M, K)) * np.exp(rng.uniform(-8, 8, (M, 1))))
    B = torch.as_tensor(rng.standard_normal((K, N)) * np.exp(rng.uniform(-8, 8, (1, N))))
    Ad, Bd = A.to(dev), B.to(dev)
    for L, maxdeg in ((5, 6), (6, 7), (7, 8)):
        want = EG.exact_gemm(A, B, L=L, maxdeg=maxdeg)
        for route in EG.ROUTES:
            got = {
                "direct": EG.exact_gemm(Ad, Bd, L=L, maxdeg=maxdeg, route=route),
                "A_pre": EG.exact_gemm(B=Bd, A_pre=EG.prechunk_A(Ad, L), maxdeg=maxdeg,
                                       route=route),
                "B_pre": EG.exact_gemm(A=Ad, B_pre=EG.prechunk_B(Bd, L), maxdeg=maxdeg,
                                       route=route),
                "both": EG.exact_gemm(A_pre=EG.prechunk_A(Ad, L), B_pre=EG.prechunk_B(Bd, L),
                                      maxdeg=maxdeg, route=route),
            }
            for name, g in got.items():
                assert g.device.type == "cuda"
                assert torch.equal(g.cpu(), want), (L, maxdeg, route, name)
            i8 = EG.exact_gemm(Ad, Bd, L=L, maxdeg=maxdeg, digit_dtype=torch.int8, route=route)
            assert torch.equal(i8.cpu(), EG.exact_gemm(A, B, L=L, maxdeg=maxdeg,
                                                       digit_dtype=torch.int8))
    if K % 8 == 0 or K > 512:
        Bp, Bpd = EG.prechunk_B_chunkscaled(B, 6), EG.prechunk_B_chunkscaled(Bd, 6)
        want = EG.exact_gemm(A=A, B_pre=Bp, maxdeg=7)
        scale = float(want.abs().max())
        for got in (EG.exact_gemm(A=Ad, B_pre=Bpd, maxdeg=7),
                    EG.gemm_B_pre_streamed(Ad, Bpd, maxdeg=7)):
            assert float((got.cpu() - want).abs().max()) <= 1e-14 * scale


def test_hybrid_iterations_on_the_card_match_the_cpu():
    """Three hybrid CCSD iterations of each formulation (digitized
    constants, digit GEMMs) on the card against the same on the CPU:
    within 1e-10 of scale (the digit GEMMs are exact on both; the f64
    einsums around them round in another order, which can move a last
    digit)."""
    import numpy as np

    from afesp_tpu_torch.methods import ccsd_spatial as CSP
    from afesp_tpu_torch.methods import ccsd_spinorb as CS

    dev = _card()
    eri, levels = _random_eri_mo(14)
    out = {}
    for d in ("cpu", dev):
        e, lv = torch.as_tensor(eri, device=d), torch.as_tensor(levels, device=d)
        v, D_ia, D_ijab, t1, t2, _, _, _ = CS.spinorb_cc_init(e, lv, 3)
        consts = CS.presplit_consts(v)
        sv, sD1, sD2, s1, s2, _, _ = CSP.spatial_cc_init(e, lv, 3)
        sconsts = CSP.spatial_presplit(sv)
        for _ in range(3):
            t1, t2 = CS._iteration_core(t1, t2, v, D_ia, D_ijab, consts, paper_foo=False,
                                        vvvv_split=True)
            s1, s2 = CSP._iteration_core(s1, s2, sv, sD1, sD2, sconsts, vvvv_split=True)
        out[str(d)] = [x.cpu().numpy() for x in (t1, t2, s1, s2)]
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert np.max(np.abs(got - want)) <= 1e-10 * np.abs(want).max()


def _packed_symmetric_eri(n: int, seed: int):
    import numpy as np

    from afesp_tpu_torch.ops.packed_eri import pack_eri

    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = (e + e.transpose(2, 3, 0, 1)) / 8.0
    return pack_eri(torch.as_tensor(e))


@pytest.mark.parametrize("n,nocc,nr", [(14, 4, 5), (20, 5, 3)])
def test_stream_pieces_on_the_card_match_the_cpu(n, nocc, nr, monkeypatch):
    """The streaming tier's pieces on the card equal the CPU's bit for bit:
    the stream Fock consts and build (whole and packed f32), the sliced
    transform's slices and its vvvv limbs and scales (virtual rows forced
    into chunks of nr, stage 1 into passes of two chunks), and the CR
    term from the limbs."""
    import numpy as np

    from afesp_tpu_torch.methods import ccsd_spatial as CSP
    from afesp_tpu_torch.methods import hf as HF
    from afesp_tpu_torch.methods import mo_slices as MS

    dev = _card()
    nv = n - nocc
    monkeypatch.setattr(MS, "_pick_chunk", lambda nvirt, n_: nr)
    monkeypatch.setattr(MS, "_GROUP_BYTES", 2 * 8.0 * n**3 * nr)
    packed = _packed_symmetric_eri(n, seed=n)
    rng = np.random.default_rng(n + 1)
    H = rng.standard_normal((n, n))
    H = torch.as_tensor(H + H.T)
    Cc = rng.standard_normal((nocc, n))
    D = torch.as_tensor(Cc.T @ Cc)
    C = torch.as_tensor(rng.standard_normal((n, n)) / np.sqrt(n))
    t1 = torch.as_tensor(0.05 * rng.standard_normal((nocc, nv)))
    tk, tl = (torch.as_tensor(x) for x in np.tril_indices(n))
    iu = tuple(torch.as_tensor(x) for x in np.triu_indices(n))
    out = {}
    for d in ("cpu", dev):
        to = lambda x: x.to(d)
        consts = HF._fock_stream_consts(to(packed), to(tk), to(tl), n=n)
        F = HF._fock_build_stream(to(H), to(D), consts, to(tk), to(tl))
        Fp = HF._fock_build_stream(to(H), to(D), consts, to(tk), to(tl), tuple(map(to, iu)),
                                   packed_f32=True)
        sl, (limbs, scales) = MS.ao_to_mo_slices(to(packed), to(C), n=n, nocc=nocc, digit_L=5)
        cr = CSP._cr_vvvv_term_from_B(to(t1), (limbs, scales), nv=nv)
        flat = [*consts[0][0], consts[0][1], *consts[1][0], consts[1][1], F, Fp,
                sl.v_oovv, sl.v_ovov, sl.v_vvov, sl.v_oovo, sl.v_oooo, *limbs, scales, cr]
        out[str(d)] = [x.cpu() for x in flat]
    assert scales.shape[0] == nv // nr
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert torch.equal(got, want)


def test_stream_iterations_on_the_card_match_the_cpu():
    """Three external-slices CCSD iterations (v_vvvv as per-chunk limbs,
    `spatial_presplit_ext`) on the card against the same on the CPU:
    within 1e-10 of scale, as the dense hybrid iterations."""
    import numpy as np

    from afesp_tpu_torch.methods import ccsd_spatial as CSP
    from afesp_tpu_torch.ops.exact_gemm import prechunk_B_chunkscaled

    dev = _card()
    eri, levels = _random_eri_mo(16)
    out = {}
    for d in ("cpu", dev):
        e, lv = torch.as_tensor(eri, device=d), torch.as_tensor(levels, device=d)
        sv, sD1, sD2, s1, s2, _, _ = CSP.spatial_cc_init(e, lv, 3)
        nv = sv.v_vvvv.shape[0]
        vvvv_B = prechunk_B_chunkscaled(sv.v_vvvv.reshape(nv * nv, nv * nv), L=5)
        sv.v_vvvv = None
        consts = CSP.spatial_presplit_ext(sv, vvvv_B)
        for _ in range(3):
            s1, s2 = CSP._iteration_core(s1, s2, sv, sD1, sD2, consts, vvvv_split=True)
        out[str(d)] = [x.cpu().numpy() for x in (s1, s2)]
    for got, want in zip(out[str(dev)], out["cpu"]):
        assert np.max(np.abs(got - want)) <= 1e-10 * np.abs(want).max()


# --- the mesh (parallel/) on the card ----------------------------------------


def _two_entry_mesh(second: int = 0):
    from afesp_tpu_torch.parallel.mesh import Mesh

    return Mesh((torch.device("cuda", 0), torch.device("cuda", second)))


def _mesh_kernel_case(kernel: str, mesh):
    """(sharded, one-device) totals of `kernel`'s tier on a mesh and on
    cuda:0, and the launches the sharded call made: K1/K2 through the
    spin-orbital shares (o=6, v=40), K3-K5 through the restricted ones
    (o=5, v=53, every variant on)."""
    from afesp_tpu_torch.parallel import triples_shard as P

    dev = torch.device("cuda", 0)
    counter = {"K1": K.triples_fused, "K2": K.triples_finale, "K3": S.triples_fused_spatial,
               "K4": S.triples_tiled_spatial, "K5": S.triples_finale_spatial}[kernel]
    if kernel in ("K1", "K2"):
        o, v = 6, 40
        args, _ = _problem(dev, o, v, sz=True)
        tier = "fused" if kernel == "K1" else "pallas"
        ii, jj, kk, clen = T.strict_plan(o, v)
        if tier == "fused":
            ii, jj, kk = T.strict_triple_list(o)
            clen = len(ii)
        idx = tuple(torch.as_tensor(x, dtype=torch.long, device=dev) for x in (ii, jj, kk))
        one = torch.stack([T._triples_total_strict(*args, *idx, clen=clen, precision=tier)])
        before = counter.launches
        got = torch.tensor([P.triples_total_sharded(mesh, *args, nocc=o, precision=tier)],
                           dtype=F64)
        return got, one.cpu(), counter.launches - before
    o, v = 5, 53
    args = tuple(torch.as_tensor(x, dtype=F64, device=dev)
                 for x in random_spatial_problem(o, v))
    tier = {"K3": "fused", "K4": "tiled", "K5": "pallas"}[kernel]
    jlen = TS.pick_spatial_jlen(o, v, tier)
    if tier == "pallas":
        one = torch.stack(TS._triples_total_spatial(*args, nocc=o, jlen=jlen, precision=tier,
                                                    **ALL))
    else:
        (si, sj, sk), w = TS._sorted_plan(o, dev)
        s = counter(*args, si, sj, sk, w, **ALL)
        one = torch.stack([s[0], s[0] + s[1], s[2], s[2] + s[3], s[4], s[4] + s[5]])
    before = counter.launches
    got = torch.stack(P.triples_spatial_sharded(mesh, *args, nocc=o, jlen=jlen, precision=tier,
                                                **ALL))
    return got.cpu(), one.cpu(), counter.launches - before


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5"])
def test_kernels_on_a_two_entry_mesh_match_one_device(kernel):
    """Each kernel's tier on a mesh that lists cuda:0 twice: each entry
    launches on its share (K1, K3 and K4 once an entry; K2 and K5 once a
    chunk or slab), and the sum of the shares is within 1e-12 of the
    one-device launch (only the order of the f64 sums differs)."""
    _card()
    got, one, launches = _mesh_kernel_case(kernel, _two_entry_mesh())
    assert launches == 2 if kernel in ("K1", "K3", "K4") else launches >= 2
    assert float((got - one).abs().max()) <= 1e-12 * float(one.abs().max())


def _vvvv_cases(dev, spin: bool, digits: bool):
    """(X, vvvv shards' slices, the one-device product) for the vvvv term
    of one route: spatial c_oovv (o=5, v=40) against v_vvvv, or
    spin-orbital tau (o=6, 2*vs=36) against the (aa, ab) block store."""
    import numpy as np

    from afesp_tpu_torch.methods import ccsd_spatial as CSP
    from afesp_tpu_torch.methods import ccsd_spinorb as CS
    from afesp_tpu_torch.ops.exact_gemm import exact_einsum, prechunk_op

    rng = np.random.default_rng(9)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s) * 0.05, device=dev)
    if not spin:
        o, v = 5, 40
        sl = CSP.Slices(v_oovv=r(o, o, v, v), v_ovov=r(o, v, o, v), v_vvov=r(v, v, o, v),
                        v_oovo=r(o, o, v, o), v_oooo=r(o, o, o, o), v_vvvv=r(v, v, v, v))
        X = r(o, o, v, v)
        spec = "efab,ijef->ijab"
        if digits:
            want = exact_einsum(spec, sl.v_vvvv, X, A_pre=prechunk_op(spec, "A", sl.v_vvvv, L=6),
                                maxdeg=7)
        else:
            want = torch.einsum(spec, sl.v_vvvv, X)
        return X, sl, want
    o, vs = 6, 18
    blocks = (r(vs, vs, vs, vs), r(vs, vs, vs, vs))
    z = lambda *s: torch.zeros(s, dtype=F64, device=dev)
    sl = CS.SpinSlices(oooo=z(o, o, o, o), ooov=z(o, o, o, 2 * vs), ovoo=z(o, 2 * vs, o, o),
                       oovo=z(o, o, 2 * vs, o), oovv=z(o, o, 2 * vs, 2 * vs),
                       ovvo=z(o, 2 * vs, 2 * vs, o), ovvv=z(o, 2 * vs, 2 * vs, 2 * vs),
                       vovv=z(2 * vs, o, 2 * vs, 2 * vs), vvvv=None, vvvv_blocks=blocks)
    tau = r(o, o, 2 * vs, 2 * vs)
    if digits:
        want = CS.tau_vvvv_split(tau, None, CS.presplit_consts(sl), blocks=blocks)
    else:
        want = CS.tau_vvvv_blocked(tau, None, blocks=blocks)
    return tau, sl, want


def _vvvv_agrees(got, want, digits: bool) -> None:
    """The digit route bit for bit (exact integer pair products, an
    elementwise recombination); the dense f64 route within 1e-12 of
    scale: cuBLAS may take another DGEMM for a slice's narrower
    operand, so the order of the f64 sums can differ (on the CPU the
    split is bit for bit, tests/test_torch_parallel.py)."""
    if digits:
        assert torch.equal(got, want)
    else:
        err = float((got - want).abs().max())
        assert err <= 1e-12 * float(want.abs().max()), err


@pytest.mark.parametrize("spin", [False, True], ids=["spatial", "spinorb"])
@pytest.mark.parametrize("digits", [False, True], ids=["dense", "digits"])
def test_sharded_vvvv_is_the_one_device_product_on_the_card(spin, digits):
    """The vvvv term split along the output's a over a mesh that lists
    cuda:0 twice against the one-device product, on the dense f64 route
    and on the digit route (per-slice digitized operand): _vvvv_agrees."""
    from afesp_tpu_torch.parallel import ccsd_shard as CSH

    dev = _card()
    X, sl, want = _vvvv_cases(dev, spin, digits)
    got = CSH.vvvv_shards(_two_entry_mesh(), sl, digits)(X)
    assert got.device == dev
    _vvvv_agrees(got, want, digits)


def test_mesh_on_two_cards():
    """The same on a mesh of cuda:0 and cuda:1: every kernel launches on
    its entry's card (the wrappers make that card current) and the sums
    hold 1e-12 of one device; the vvvv shards' products agree with the
    one-device ones on both routes (_vvvv_agrees).  Needs two cards."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a mesh of cuda:0 and cuda:1")
    mesh = _two_entry_mesh(1)
    for kernel in ("K1", "K2", "K3", "K4", "K5"):
        got, one, launches = _mesh_kernel_case(kernel, mesh)
        assert launches >= 2
        assert float((got - one).abs().max()) <= 1e-12 * float(one.abs().max()), kernel
    from afesp_tpu_torch.parallel import ccsd_shard as CSH

    for spin in (False, True):
        for digits in (False, True):
            X, sl, want = _vvvv_cases(torch.device("cuda", 0), spin, digits)
            _vvvv_agrees(CSH.vvvv_shards(mesh, sl, digits)(X), want, digits)


# the f32 tiers against the f64 kernels on seeded inputs, relative to each
# value: ~30 f32 units (measured on the card: at most 3.9e-7 of a sum)
F32_REL = 2e-6


def _random_cr_inputs(o: int, v: int, seed: int = 5):
    """Random amplitudes, stale amplitudes and restricted slices for
    cr_intermediates, as CPU tensors."""
    import numpy as np

    from afesp_tpu_torch.methods.ccsd_spatial import Slices

    rng = np.random.default_rng(seed)
    r = lambda *s: torch.as_tensor(rng.standard_normal(s) * 0.05)
    amps = (r(o, v), r(o, o, v, v), r(o, v), r(o, o, v, v))
    slices = Slices(r(o, o, v, v), r(o, v, o, v), r(v, v, o, v), r(o, o, v, o), r(o, o, o, o),
                    r(v, v, v, v))
    return amps, slices


@pytest.mark.parametrize("o,v", [(6, 10), (10, 106)])
def test_spinorb_hybrid_tier_on_the_card_matches_the_cpu(o, v):
    """The f32 strict-chunk tier on the card (cuBLAS sgemm, f64 quotient
    and sum) against the same on the CPU within 1e-9 Ha, and against the
    card's f64 K1 tier within F32_REL of E(T) (these seeded inputs give
    E(T) from -0.025 to -1706 Ha, so JAX's 5e-9 between its tiers, which
    chip_smoke.py holds on the paths' amplitudes, is no bound here); f32
    means f32 there, not TF32."""
    dev = _card()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    out = {}
    for d in ("cpu", dev):
        args, _ = _problem(d, o, v, sz=True)
        ii, jj, kk, clen = T.strict_plan(o, v, "hybrid")
        idx = tuple(torch.as_tensor(x, dtype=torch.long, device=d) for x in (ii, jj, kk))
        out[str(d)] = float(T._triples_total_strict(*args, *idx, clen=clen, precision="hybrid"))
    args, idx = _problem(dev, o, v, sz=True)
    fused = float(T._triples_total_strict(*args, *idx, clen=len(idx[0]), precision="fused"))
    assert abs(out[str(dev)] - out["cpu"]) < 1e-9
    assert abs(out[str(dev)] - fused) <= F32_REL * abs(fused) and out[str(dev)] != fused


@pytest.mark.parametrize("o,v", [(5, 53), (6, 80)])
def test_spatial_hybrid_tier_on_the_card_matches_the_cpu(o, v):
    """The six restricted sums of the f32 slab tier on the card against
    the CPU within 1e-9, and against K3 on the card within F32_REL of
    each sum; the f32 CR chain on the card against the CPU's within 1e-6
    of its largest element (f32 roundings in another order)."""
    import numpy as np

    dev = _card()
    flags = dict(doing_T=True, doing_R=True, doing_CR=True)
    jlen = TS.pick_spatial_jlen(o, v, "hybrid")
    out = {}
    for d in ("cpu", dev):
        args = tuple(torch.as_tensor(x, dtype=F64, device=d)
                     for x in random_spatial_problem(o, v))
        out[str(d)] = torch.stack(TS._triples_total_spatial(
            *args, nocc=o, jlen=jlen, precision="hybrid", **flags)).cpu().numpy()
    (si, sj, sk), w = TS._sorted_plan(o, dev)
    s = S.triples_fused_spatial(*args, si, sj, sk, w, **flags)
    k3 = torch.stack([s[0], s[0] + s[1], s[2], s[2] + s[3], s[4], s[4] + s[5]]).cpu().numpy()
    assert np.abs(out[str(dev)] - out["cpu"]).max() < 1e-9
    assert np.all(np.abs(out[str(dev)] - k3) <= F32_REL * np.abs(k3))

    amps, slices = _random_cr_inputs(o, v)
    want = TS.cr_intermediates(*amps, slices, o, precision="hybrid")
    moved = type(slices)(*(x.to(dev) for x in (slices.v_oovv, slices.v_ovov, slices.v_vvov,
                                                slices.v_oovo, slices.v_oooo, slices.v_vvvv)))
    got = TS.cr_intermediates(*(x.to(dev) for x in amps), moved, o, precision="hybrid")
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        assert float((g.cpu() - w_).abs().max()) <= 1e-6 * float(w_.abs().max())


def test_a_readback_in_a_span_counts_one_sync_on_the_card():
    """With recording on, torch's sync debug mode counts each host-device
    synchronisation once in the open span (the explicit `synced()` mark
    beside a readback adds nothing there); `disable()` puts the previous
    mode back."""
    from afesp_tpu_torch import trace

    dev = _card()
    x = torch.arange(8.0, device=dev)
    torch.cuda.synchronize(dev)
    before = torch.cuda.get_sync_debug_mode()
    trace.enable()
    try:
        assert torch.cuda.get_sync_debug_mode() == 1
        with trace.span("calc"):
            with trace.span("readback"):
                assert x.sum().item() == 28.0
                trace.synced()
            with trace.span("launches"):
                y = x * 2.0
    finally:
        trace.disable()
    assert torch.cuda.get_sync_debug_mode() == before
    calc, readback, launches = trace.records()[-1]
    assert readback.counts["syncs"] == 1 and launches.counts["syncs"] == 0
    assert calc.counts["syncs"] == 1 and float(y.sum()) == 56.0


def _digit_graph_counts() -> list:
    """The digit-graph and launch counters, as the recorder reads them."""
    from afesp_tpu_torch import trace

    now = trace._snapshot()
    return [now[k] for k in ("digit_graph.calls", "digit_graph.captures",
                             "digit_graph.replays", "_int_mm.launches",
                             "digit_pair_gemm.launches")]


def _digit_graph_cases(dev):
    """Digit-GEMM calls at the water dimer's sizes (o=10, v=106), one a
    route of the hybrid iteration: `ce` (A-side prechunked vvvv), `cb`
    (B-side prechunked vvov: a 112360-wide output, four _INT_MM_TILE
    blocks), `xe` (both operands digitized in the call), the stream
    tier's chunk-scaled limbs through exact_einsum and
    gemm_B_pre_streamed, and a pre-digitized exact_gemm."""
    from afesp_tpu_torch.ops import exact_gemm as EG

    o, v = 10, 106
    g = torch.Generator(device=dev).manual_seed(19)
    r = lambda *s: torch.randn(s, dtype=F64, device=dev, generator=g)
    vvvv, vvov, t1, t2, ovov = r(v, v, v, v), r(v, v, o, v), r(o, v), r(o, o, v, v), r(o, v, o, v)
    ce = EG.prechunk_op("efab,ijef->ijab", "A", vvvv, L=4)
    cb = EG.prechunk_op("ie,baje->ijab", "B", vvov, L=4)
    limbs = EG.prechunk_B_chunkscaled(vvvv.reshape(v * v, v * v), L=5)
    B_dig = EG.digitize_B(ovov.reshape(o * v, o * v), 6)
    return {
        "ce": lambda: EG.exact_einsum("efab,ijef->ijab", vvvv, t2, A_pre=ce, maxdeg=7),
        "cb": lambda: EG.exact_einsum("ie,baje->ijab", t1, vvov, B_pre=cb, maxdeg=7),
        "xe": lambda: EG.exact_einsum("mjae,iemb->ijab", t2, ovov, L=6, maxdeg=7),
        "chunkscaled": lambda: EG.exact_einsum("ijef,efab->ijab", t2, None, L=6, maxdeg=7,
                                               B_pre=limbs, B_shape=(v, v, v, v)),
        "streamed": lambda: EG.gemm_B_pre_streamed(t2.reshape(o * o, v * v), limbs, maxdeg=6),
        "dig": lambda: EG.exact_gemm(ovov.reshape(o * v, o * v), B_dig=B_dig, L=6, maxdeg=7),
    }


@pytest.mark.parametrize("case", ["ce", "cb", "xe", "chunkscaled", "streamed", "dig"])
def test_digit_graph_replays_equal_the_eager_call_bit_for_bit(case):
    """Inside a graph scope a call runs eagerly at its first meeting,
    is captured and replayed at its second, and replayed at its third:
    each result equals the eager call's bit for bit, with its strides;
    the launch counters rise as three eager calls' would; once the
    scope has closed, the memory its graphs held is no longer allocated
    (an eager call after it makes the workspace that closing cleared)."""
    from afesp_tpu_torch.ops import exact_gemm as EG

    dev = _card()
    call = _digit_graph_cases(dev)[case]
    with EG.graph_scope():  # cuBLAS and the allocator warmed, outside the count
        for _ in range(3):
            call()
    want = call()
    before = _digit_graph_counts()
    call()
    eager = [a - b for a, b in zip(_digit_graph_counts(), before)]
    held = torch.cuda.memory_allocated(dev)
    before = _digit_graph_counts()
    with EG.graph_scope():
        got = [call() for _ in range(3)]
        torch.cuda.synchronize(dev)
    counts = [a - b for a, b in zip(_digit_graph_counts(), before)]
    for g in got:
        assert torch.equal(g, want) and g.stride() == want.stride(), case
    assert counts[:3] == [3, 1, 1]
    assert counts[3:] == [3 * n for n in eager[3:]] and eager[3] > 0
    del got, g
    assert torch.cuda.memory_allocated(dev) < held
    call()
    assert torch.cuda.memory_allocated(dev) == held


def _pvtz_hybrid_run(tmp_path, name: str, graphs: bool, monkeypatch):
    """run_calculation on the pVTZ water fixture with the els.in of
    `expected_jax_cpu<name>.json` ("hybrid"), recording on; with graphs
    off the solve's scope is a plain null context.  Returns the result,
    the report, the record, the keys the scope met and the counters'
    change."""
    import contextlib

    from afesp_tpu_torch import trace
    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.ops import exact_gemm as EG

    fixture = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
    want = json.loads((fixture / f"expected_jax_cpu{name}.json").read_text())
    wd = tmp_path / ("graphs" if graphs else "eager")
    wd.mkdir()
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
        shutil.copy(fixture / f, wd / f)
    (wd / "eri.dat").symlink_to(REPO / "data" / "h2o-cc-pvtz" / "eri.dat")
    (wd / "els.in").write_text(want["els_in"])
    keys = []
    with monkeypatch.context() as m:
        if graphs:
            key = EG._call_key

            def spy(*a):
                out = key(*a)
                keys.append(out[0])
                return out
            m.setattr(EG, "_call_key", spy)
        else:
            m.setattr(EG, "graph_scope", contextlib.nullcontext)
        stream = io.StringIO()
        before = _digit_graph_counts()
        trace.enable()
        try:
            res = run_calculation(wd, Reporter(stream=stream))
        finally:
            trace.disable()
        torch.cuda.synchronize()
        counts = [a - b for a, b in zip(_digit_graph_counts(), before)]
    return res, stream.getvalue(), trace.records()[-1], keys, counts, want


@pytest.mark.parametrize("name", ["_crccsd_t_spatial_hybrid", "_hybrid"],
                         ids=["restricted", "spinorb"])
def test_hybrid_solve_with_digit_graphs_is_the_eager_solve_bit_for_bit(name, tmp_path,
                                                                       monkeypatch):
    """A hybrid CCSD solve of the pVTZ water on the card with its digit
    GEMMs replayed from graphs prints the eager solve's energies bit for
    bit, in the same iterations (JAX's count), with the same int8 GEMM
    launches and the same syncs each iteration.  Captures are the keys
    met at least twice; replays are the calls less the captures and the
    first meetings."""
    from torch_fixtures import breakdown_block

    _card()
    res, text, record, keys, counts, want = _pvtz_hybrid_run(tmp_path, name, True, monkeypatch)
    eres, etext, erecord, _, ecounts, _ = _pvtz_hybrid_run(tmp_path, name, False, monkeypatch)
    assert breakdown_block(text) == breakdown_block(etext)
    assert res.cc.energies == eres.cc.energies and res.cc.iterations == want["cc_iterations"]
    assert torch.equal(res.cc.t2, eres.cc.t2)
    assert counts[3:] == ecounts[3:] and ecounts[:3] == [0, 0, 0]
    met = {k: keys.count(k) for k in keys}
    calls, captures, replays = counts[:3]
    assert calls == len(keys) > 0
    assert captures == sum(n >= 2 for n in met.values()) > 0
    assert replays == calls - captures - len(met)
    syncs = [[s.counts["syncs"] for s in r if s.name == "ccsd.iter"] for r in (record, erecord)]
    assert syncs[0] == syncs[1] and len(syncs[0]) == res.cc.iterations
