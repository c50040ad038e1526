"""The frozen input maker (`gpubench/inputs/`) on the CPU: at seed 0 the
committed geometry and one-electron files, the ERIs against the JAX
engine's committed sample, and the seeded displacement."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import inputs
from gpubench.harness import spec
from gpubench.inputs import engine
from gpubench.reference import files

ROOT = Path(__file__).resolve().parents[2]
DIMER = ROOT / "data" / "h2o-dimer-cc-pvtz"
PVTZ = ROOT / "data" / "h2o-cc-pvtz-2.00_104.45"
# chip_smoke.py's limits: a .dat value relative to max(1, |value|), and
# an ERI against the JAX engine's sample
DAT_RTOL = 1e-14
ERI_TOL = 1e-12


def dat_agree(a: Path, b: Path) -> float:
    """The same index columns, and the largest value difference relative
    to max(1, |value|) (chip_smoke.py's `dat_agree`)."""
    ta, tb = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
    assert ta.shape == tb.shape and (ta[:, :2] == tb[:, :2]).all()
    return float((abs(ta[:, 2] - tb[:, 2]) / abs(ta[:, 2]).clip(min=1.0)).max())


def test_seed_0_writes_the_committed_dimer_geometry_and_one_electron_files(tmp_path):
    cfg = spec.load_cell(ROOT, "dimer-crccsdt-hybrid").config
    charges, coords = cfg["charges"], inputs.displaced(cfg["coords_bohr"], 0, 0.01)
    inputs.write_geometry(tmp_path / "geom.dat", charges, coords)
    assert (tmp_path / "geom.dat").read_bytes() == (DIMER / "geom.dat").read_bytes()
    ch, xyz = files.read_geometry(tmp_path / "geom.dat")
    basis = engine.build_basis(ch, xyz, cfg["basis"])
    assert basis.nbf == cfg["nbasis"]
    for name, M in (("s.dat", engine.overlap(basis, "cpu")),
                    ("t.dat", engine.kinetic(basis, "cpu")),
                    ("v.dat", engine.nuclear(basis, ch, xyz, "cpu"))):
        inputs.write_tri_2d(tmp_path / name, M.numpy())
        assert dat_agree(DIMER / name, tmp_path / name) <= DAT_RTOL, name


def test_trimer_seed_0_geometry_is_the_committed_one(tmp_path):
    cfg = spec.load_cell(ROOT, "trimer-crccsdt-f64").config
    inputs.write_geometry(tmp_path / "geom.dat", cfg["charges"],
                          inputs.displaced(cfg["coords_bohr"], 0, 0.01))
    assert (tmp_path / "geom.dat").read_bytes() == \
        (ROOT / "data" / "h2o-trimer-cc-pvtz" / "geom.dat").read_bytes()


def test_pvtz_eris_match_the_jax_sample(tmp_path):
    sample = json.loads((PVTZ / "expected_jax_cpu_eri_sample.json").read_text())["eri_sample"]
    ch, xyz = files.read_geometry(PVTZ / "geom.dat")
    packed = engine.eri_packed(engine.build_basis(ch, xyz, "fixture-cc-pvtz"), "cpu")
    assert packed.numel() == sample["count"]
    got = packed[torch.as_tensor(sample["index"])]
    want = torch.as_tensor(sample["value"], dtype=torch.float64)
    assert float((got - want).abs().max()) <= ERI_TOL
    # the writer's eri.npy reads back as the same store
    np.save(tmp_path / "eri.npy", packed.numpy())
    assert np.array_equal(files.packed_eri(tmp_path, 58), packed.numpy())


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 12345678901])
def test_a_seed_gives_one_geometry_and_two_seeds_two(seed):
    coords = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    a, b = inputs.displaced(coords, seed, 0.01), inputs.displaced(coords, seed, 0.01)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, inputs.displaced(coords, seed + 1, 0.01))
    assert 0 < np.abs(a - coords).max() <= 0.01
    assert np.array_equal(inputs.displaced(coords, 0, 0.01), coords)


def test_make_inputs_writes_what_a_calculation_reads(tmp_path):
    info = inputs.make_inputs(tmp_path, [8, 1, 1], [[0, 0, -0.26], [0, -2.99, 2.06],
                                                    [0, 2.99, 2.06]],
                              "cc-pvdz", seed=5, amplitude=0.01, device="cpu")
    assert info["nbasis"] == 24
    for f in ("geom.dat", "s.dat", "t.dat", "v.dat", "eri.npy"):
        assert (tmp_path / f).stat().st_size > 0
    S = files.read_matrix(tmp_path / "s.dat")
    assert S.shape == (24, 24) and np.allclose(np.diag(S), 1.0)
