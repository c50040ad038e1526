"""Port parity: the streaming-slices tier (AFESP_FORCE_STREAM=1) under a
mesh, on the CPU: the drivers on the 28-bf N2 at mesh_devices = 7, the
vvvv limbs (one chunk) padded to 7 and split over the whole mesh, one
seventh of the bytes an entry, the CR term from them
(torch_fixtures.mesh_driver_parity).  JAX's stream mesh path needs the
CCSD's sub-mesh to be the whole mesh (its solve and its limbs must share
one device set), so the width is one that divides N2's nvirt 21; at
H2O's nvirt 19, or at N2's width 8, JAX's run stops on "incompatible
devices".  The port runs there: at width 8 (limbs padded to 8) its
breakdown equals its width-7 one within 1e-10, both with the triples at
precision="f64" (mesh_driver_parity's; the CPU tier at "hybrid" is the
f32 one, tests/test_torch_triples_hybrid.py)."""

import functools
import io

import pytest
from torch_fixtures import breakdown_block, mesh_driver_parity, write_els_in, write_n2

import afesp_tpu_torch.driver as tdriver
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial


@pytest.fixture(scope="module")
def n2(tmp_path_factory):
    return write_n2(tmp_path_factory.mktemp("n2"))


def test_driver_mesh_stream_matches_jax(tmp_path, n2, monkeypatch):
    res, text = mesh_driver_parity(tmp_path, n2, "CRCCSD(T)_spatial", 7, "hybrid", monkeypatch,
                                   stream=True)
    assert res.cc.converged
    write_els_in(tmp_path, "CRCCSD(T)_spatial", 'mesh_devices = 8,\nccsd_precision = "hybrid",\n')
    rep = Reporter(stream=io.StringIO())
    monkeypatch.setattr(tdriver, "do_ccsd_t_spatial",
                        functools.partial(do_ccsd_t_spatial, precision="f64"))
    res8 = run_calculation(tmp_path, rep, device="cpu")
    assert " Using a 8-device mesh for CC stages." in rep.stream.getvalue()
    assert res8.cc.iterations == res.cc.iterations
    assert abs(res8.total_energy - res.total_energy) < 1e-10
    got, want = _values(rep.stream.getvalue()), _values(text)
    assert len(got) == 23 and got.keys() == want.keys()
    assert all(abs(got[k] - want[k]) < 1e-10 for k in got), (got, want)


def _values(text: str) -> dict:
    """label -> value of each numbered line of the breakdown block."""
    out = {}
    for line in breakdown_block(text):
        label, _, val = line.rpartition(" ")
        if label.strip().endswith(":"):
            out[label.strip()] = float(val)
    return out
