"""Port parity: the drivers at mesh_devices >= 2 at ccsd_precision
"f64", on the CPU: the port's mesh of the CPU listed eight times against
JAX's eight CPU devices (torch_fixtures.mesh_driver_parity), on the
generated 24-bf H2O in both formulations (JAX's CCSD on one device at
nvirt 19, on 2 entries at the spin-orbital 38) and on the 28-bf N2,
whose nvirt 21 takes JAX's 7-of-8 sub-mesh."""

import pytest
from torch_fixtures import mesh_driver_parity, write_h2o, write_n2


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return {"h2o": write_h2o(tmp_path_factory.mktemp("h2o")),
            "n2": write_n2(tmp_path_factory.mktemp("n2"))}


@pytest.mark.parametrize("name,calc,sub_size", [
    ("h2o", "CRCCSD(T)_spatial", None),
    ("h2o", "CCSD(T)_spinorb", 2),
    ("n2", "CRCCSD(T)_spatial", 7),
], ids=["h2o_spatial", "h2o_spinorb", "n2_spatial"])
def test_driver_mesh_f64_matches_jax(tmp_path, inputs, monkeypatch, name, calc, sub_size):
    res, _ = mesh_driver_parity(tmp_path, inputs[name], calc, 8, "f64", monkeypatch,
                                sub_size=sub_size)
    assert res.cc.converged
