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


def _problem(dev, o, v, seed=7):
    args = tuple(torch.as_tensor(x, dtype=F64, device=dev)
                 for x in random_triples_problem(o, v, seed))
    idx = tuple(torch.as_tensor(x, dtype=torch.long, device=dev) for x in T.strict_triple_list(o))
    return args, idx


# (o, v): the small test shape, the H2O/cc-pVTZ shape, and nvirt > 128
# (the TPU kernel's cap, which K1 does not have)
SHAPES = [(6, 10), (10, 106), (4, 130)]


@pytest.mark.parametrize("o,v", SHAPES)
def test_k1_kernel_matches_plain(o, v):
    dev = _card()
    args, idx = _problem(dev, o, v)
    before = K.triples_fused.launches
    got = K.triples_fused(*args, *idx)
    again = K.triples_fused(*args, *idx)
    want = K.triples_fused_plain(*args, *idx)
    torch.cuda.synchronize()
    assert K.triples_fused.launches == before + 2
    assert torch.equal(got, again)  # fixed-order sums, no atomics
    # both f64: only the order of summation differs
    assert abs(float(got) - float(want)) <= 1e-11 * abs(float(want))


@pytest.mark.parametrize("o,v", SHAPES)
def test_k2_kernel_matches_plain(o, v):
    dev = _card()
    args, (ii, jj, kk) = _problem(dev, o, v)
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
    args, idx = _problem(dev, 6, 10)
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


@pytest.mark.parametrize("kernel", ["triples_fused_spatial", "triples_tiled_spatial"])
@pytest.mark.parametrize("o,v", SPATIAL_SHAPES)
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


@pytest.mark.parametrize("o,v", SPATIAL_SHAPES[:2])
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
