"""Port parity: the drivers at mesh_devices = 8 at ccsd_precision
"hybrid" (the digit-GEMM CCSD; the port's vvvv digitized per slice on
the entries of the sub-mesh), on the CPU, on the generated 24-bf H2O in
both formulations (torch_fixtures.mesh_driver_parity; JAX's triples at
f64, the port's every tier)."""

import pytest
from torch_fixtures import mesh_driver_parity, write_h2o


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


@pytest.mark.parametrize("calc,sub_size", [("CRCCSD(T)_spatial", None),
                                           ("CCSD(T)_spinorb", 2)],
                         ids=["spatial", "spinorb"])
def test_driver_mesh_hybrid_matches_jax(tmp_path, h2o, monkeypatch, calc, sub_size):
    res, _ = mesh_driver_parity(tmp_path, h2o, calc, 8, "hybrid", monkeypatch,
                                sub_size=sub_size)
    assert res.cc.converged
