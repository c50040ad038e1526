"""The port's integral engine (`afesp_tpu_torch/integrals/`) against the
JAX package's, on the CPU: S, T, V and the ERIs to 1e-12 absolute on
H2O/cc-pVDZ (24 bf) and on a two-centre O-H/cc-pVTZ (44 bf, 16 shells,
every class up to (ff|ff)); each Cartesian class against the independent
Obara-Saika oracle (`tests/oracle_integrals.py`); the `.dat` writers
byte for byte.  Each JAX reference is built once per module."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import scipy.special
import torch

from afesp_tpu.integrals import basis_data as jbd
from afesp_tpu.integrals import engine as J
from afesp_tpu.integrals import fixture_basis as jfb
from afesp_tpu.integrals import generate as jgen
from afesp_tpu.ops.packed_eri import pack_eri as jax_pack_eri
from afesp_tpu.utils.wrapper import water_geometry

from afesp_tpu_torch import integrals as tint
from afesp_tpu_torch.integrals import basis_data as tbd
from afesp_tpu_torch.integrals import engine as T
from afesp_tpu_torch.integrals import fixture_basis as tfb
from afesp_tpu_torch.integrals import generate as tgen
from afesp_tpu_torch.io import dat as tdat

try:  # repo root on sys.path (python -m pytest)
    from tests import oracle_integrals as oi
except ImportError:  # bare pytest rootdir import modes: tests/ itself is on sys.path
    import oracle_integrals as oi

TOL = 1e-12
MOLECULES = {
    "h2o_pvdz": (*water_geometry(1.80, 104.45), "cc-pvdz"),
    "oh_pvtz": (np.array([8, 1]), np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.83]]), "cc-pvtz"),
}


@functools.lru_cache(maxsize=None)
def jax_reference(name: str) -> dict:
    """JAX's S, T, V and dense ERIs of one molecule, and the inputs:
    built once per test process."""
    charges, coords, basis_name = MOLECULES[name]
    jb = J.build_basis(charges, coords, basis_name)
    return dict(name=name, charges=charges, coords=coords, basis=basis_name,
                S=J.overlap(jb), T=J.kinetic(jb), V=J.nuclear(jb, charges, coords),
                eri=J.eri_tensor(jb), jb=jb)


@pytest.fixture(scope="module", params=list(MOLECULES))
def mol(request):
    return jax_reference(request.param)


@pytest.fixture(scope="module")
def port_basis(mol):
    return T.build_basis(mol["charges"], mol["coords"], mol["basis"])


@pytest.fixture(scope="module")
def h2o():
    return jax_reference("h2o_pvdz")


def test_basis_data_copies_equal():
    assert tbd.CC_PVDZ == jbd.CC_PVDZ and tbd.CC_PVTZ == jbd.CC_PVTZ
    assert tbd.ELEMENTS == jbd.ELEMENTS and tbd.BASIS_SETS == jbd.BASIS_SETS
    assert tfb.FIXTURE_DEF2_SVP == jfb.FIXTURE_DEF2_SVP
    assert tfb.FIXTURE_CC_PVTZ == jfb.FIXTURE_CC_PVTZ


def test_public_names_match_jax():
    from afesp_tpu import integrals as jint

    assert tint.__all__ == jint.__all__
    assert all(hasattr(tint, n) for n in jint.__all__)


def test_basis_and_c2s_identical(mol, port_basis):
    jb, tb = mol["jb"], port_basis
    assert tb.nbf == jb.nbf and tb.offsets == jb.offsets
    for a, b in zip(jb.shells, tb.shells):
        assert a.l == b.l
        for f in ("center", "exps", "coefs"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    for l in range(4):
        assert np.array_equal(T.c2s_matrix(l), J.c2s_matrix(l))


@pytest.mark.parametrize("kind", ["S", "T", "V"])
def test_one_electron_matches_jax(mol, port_basis, kind):
    if kind == "S":
        got = T.overlap(port_basis, "cpu")
    elif kind == "T":
        got = T.kinetic(port_basis, "cpu")
    else:
        got = T.nuclear(port_basis, mol["charges"], mol["coords"], "cpu")
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - mol[kind]).max() <= TOL


def test_eri_matches_jax(mol, port_basis):
    got = T.eri_tensor(port_basis, "cpu").numpy()
    assert np.abs(got - mol["eri"]).max() <= TOL
    # exactly 8-fold symmetric: the dense tensor is the packed store unpacked
    assert np.array_equal(got, got.transpose(1, 0, 2, 3))
    assert np.array_equal(got, got.transpose(2, 3, 0, 1))


def test_packed_store_matches_jax_pack(mol, port_basis):
    """The engine's packed store against JAX's pack_eri of its dense
    tensor, the layout the `eri.npy` files carry."""
    got = T.eri_packed(port_basis, "cpu").numpy()
    want = jax_pack_eri(mol["eri"])
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_small_chunks_give_the_same_store(h2o):
    """A chunk budget of one quartet at a time changes nothing but the
    matmuls' rounding: the same elements written, the same values to
    1e-14."""
    basis = T.build_basis(h2o["charges"], h2o["coords"], h2o["basis"])
    a = T.eri_packed(basis, "cpu")
    b = T.eri_packed(basis, "cpu", chunk_bytes=1)
    assert float((a - b).abs().max()) <= 1e-14


def _skipped_quartets(eri: np.ndarray, full: np.ndarray, basis) -> np.ndarray:
    """Which shell quartets the screen skipped: blocks exactly zero
    throughout in `eri` whose unscreened values (`full`) exceed 1e-12
    (blocks that vanish by symmetry come out 0 or ~1e-17 by roundoff)."""
    edges = list(basis.offsets) + [basis.nbf]
    sl = [slice(edges[i], edges[i + 1]) for i in range(len(basis.offsets))]
    ns = len(sl)
    out = np.zeros((ns,) * 4, dtype=bool)
    for idx in np.ndindex(*out.shape):
        blk = tuple(sl[i] for i in idx)
        out[idx] = not eri[blk].any() and np.abs(full[blk]).max() > 1e-12
    return out


def test_schwarz_screen_leaves_skipped_quartets_zero(h2o):
    """At a screen that skips some quartets, the port skips the same ones
    as the JAX engine: the same elements are exactly zero."""
    screen = 1e-3
    want = J.eri_tensor(h2o["jb"], screen=screen)
    basis = T.build_basis(h2o["charges"], h2o["coords"], h2o["basis"])
    got = T.eri_tensor(basis, "cpu", screen=screen).numpy()
    skipped = _skipped_quartets(want, h2o["eri"], basis)
    assert 0 < skipped.sum() < skipped.size
    assert np.array_equal(_skipped_quartets(got, h2o["eri"], basis), skipped)
    assert np.abs(got - want).max() <= TOL


def test_boys_matches_scipy():
    # up to beyond the largest alpha |PQ|^2 of the dimer's tightest
    # primitives on its two oxygens (~7.7e3 * 5.6^2 bohr^-2)
    T_ = np.concatenate([[0.0, 1e-14, 5e-14, 1e-12], np.geomspace(1e-9, 1e7, 800)])
    got = T.boys(12, torch.as_tensor(T_)).numpy()
    want = J.boys(12, T_)
    assert np.abs(got - want).max() <= 1e-14
    assert abs(float(torch.special.gammainc(torch.tensor(2.5, dtype=torch.float64),
                                            torch.tensor(3.0, dtype=torch.float64)))
               - scipy.special.gammainc(2.5, 3.0)) <= 1e-16


def test_hermite_R_matches_jax():
    rng = np.random.default_rng(4)
    p = rng.uniform(0.1, 20.0, 7)
    PC = rng.standard_normal((7, 3))
    PC[0] = 0.0  # the T < 1e-13 branch
    L = 8
    want = J.hermite_R_batched(L, p, PC)  # (B, L+1, L+1, L+1)
    got = T.hermite_R(L, torch.as_tensor(p), torch.as_tensor(PC)).numpy()
    for k, (t, u, v) in enumerate(T.simplex(L)):
        assert np.abs(got[:, k] - want[:, t, u, v]).max() <= 1e-12 * max(
            1.0, np.abs(want[:, t, u, v]).max())


def _toy_shells():
    mk = lambda l, ctr, e, c: J.Shell(
        l, np.asarray(ctr, float), np.asarray(e, float), np.asarray(c, float)
    )
    return {
        0: mk(0, (0.0, 0.0, 0.0), [13.0, 2.0, 0.4], [0.3, 0.5, 0.8]),
        1: mk(1, (0.0, 1.4, 1.1), [1.2, 0.35], [0.6, 0.5]),
        2: mk(2, (0.2, -1.4, 1.1), [0.9], [1.0]),
        3: mk(3, (0.5, 0.3, -0.9), [0.6, 1.8], [0.7, 0.3]),
    }


@pytest.mark.parametrize("la", range(4))
def test_one_electron_classes_vs_oracle(la):
    """Every (l_a, l_b) up to f, against the Obara-Saika oracle, with a
    point charge on a shell centre (the small-T Boys branch)."""
    sh = _toy_shells()
    charges = [8.0, 1.2]
    coords = [np.array([0.0, 0.0, 0.0]), np.array([1.9, -0.4, 0.3])]
    for lb in range(4):
        a, b = sh[la], sh[lb]
        for kind, oracle in (
            ("S", oi.os_overlap_block(a, b)),
            ("T", oi.os_kinetic_block(a, b)),
            ("V", oi.os_nuclear_block(a, b, charges, coords)),
        ):
            got = T.shell_pair_1e(a, b, kind, charges, coords, device="cpu").numpy()
            scale = max(np.abs(oracle).max(), 1e-3)
            assert np.abs(got - oracle).max() < 1e-11 * scale, (kind, la, lb)


ERI_CLASSES = [
    (0, 0, 0, 0),
    (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1),
    (1, 1, 1, 1),
    (2, 1, 0, 0), (0, 0, 2, 1), (1, 2, 0, 1),
    (2, 2, 2, 2),
    (3, 0, 0, 0), (0, 3, 0, 0), (0, 0, 0, 3),
    (3, 1, 2, 0), (2, 0, 3, 1), (1, 3, 1, 0),
    (3, 3, 0, 0), (0, 0, 3, 3), (3, 2, 3, 0), (3, 3, 3, 1),
]


@pytest.mark.parametrize("q", [ERI_CLASSES[:10], ERI_CLASSES[10:]],
                         ids=["through_d", "with_f"])
def test_eri_classes_vs_oracle(q):
    sh = _toy_shells()
    for cls in q:
        a, b, c, d = (sh[l] for l in cls)
        got = T.eri_shell_quartet(a, b, c, d, device="cpu").numpy()
        want = oi.os_eri_shell_quartet(a, b, c, d)
        scale = max(np.abs(want).max(), 1e-3)
        assert np.abs(got - want).max() < 1e-11 * scale, cls
        # and against the JAX engine's quartet
        assert np.abs(got - J.eri_shell_quartet(a, b, c, d)).max() <= 1e-13 * scale, cls


def test_writers_byte_identical_on_the_same_matrices(h2o, tmp_path):
    """The port's `.dat` writers turn JAX's matrices into JAX's bytes."""
    for name, M, jw, tw in (
        ("s.dat", h2o["S"], jgen._write_tri_2d, tgen._write_tri_2d),
        ("eri.dat", h2o["eri"], jgen._write_tri_4d, tgen._write_tri_4d),
    ):
        jw(tmp_path / f"j_{name}", M)
        tw(tmp_path / f"t_{name}", M)
        assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()


def test_write_dat_files_matches_jax(h2o, tmp_path):
    """write_dat_files of both packages on the 24-bf case: geom.dat byte
    for byte; s, t, v and eri.dat the same index columns, values within
    1e-12 (the engines differ in the last bits, which can move the 15th
    printed decimal), and the same set of lines where no value sits within
    1e-12 of the writer's cut."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    jgen.write_dat_files(jd, h2o["charges"], h2o["coords"], h2o["basis"])
    tgen.write_dat_files(td, h2o["charges"], h2o["coords"], h2o["basis"], device="cpu")
    assert sorted(p.name for p in td.iterdir()) == sorted(p.name for p in jd.iterdir())
    assert (td / "geom.dat").read_bytes() == (jd / "geom.dat").read_bytes()
    for name, ncols in (("s.dat", 3), ("t.dat", 3), ("v.dat", 3), ("eri.dat", 5)):
        a = tdat._parse_numeric_table(jd / name, ncols)
        b = tdat._parse_numeric_table(td / name, ncols)
        assert np.array_equal(a[:, :-1], b[:, :-1]), name
        assert np.abs(a[:, -1] - b[:, -1]).max() <= TOL, name
