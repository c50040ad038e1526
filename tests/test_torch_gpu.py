"""The CUDA kernels and the slice on the card (marker `gpu`).

Each test decides inside its body whether a CUDA device is present and
skips without one, so every pytest worker collects the same tests.  On
a machine with a card and without jax (tests/conftest.py imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Nothing here imports jax or the JAX package: the JAX reference values
come from data/h2o-cc-pvtz-2.00_104.45/expected_jax_cpu.json.
"""

import io
import json
import shutil
from pathlib import Path

import pytest
import torch
from torch_fixtures import random_triples_problem

from afesp_tpu_torch.methods import triples_spinorb as T
from afesp_tpu_torch.ops import triples_cuda as K

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
