"""The port's read-in (`afesp_tpu_torch/io/fastparse.py`, `io/dat.py`,
`ops/packed_eri.py`) against the JAX package's, on the CPU: the C
scanner, the numpy route and JAX's scanner give bit-identical tables of
the committed pVTZ inputs; a malformed token raises JAX's message; a
run directory with `eri.npy` is read from it (fault F4), giving JAX's
packed and dense ERIs bit for bit; pack and unpack equal JAX's."""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from afesp_tpu.io import dat as jdat
from afesp_tpu.io import fastparse as jfp
from afesp_tpu.ops import packed_eri as jpe

from afesp_tpu_torch.io import dat as tdat
from afesp_tpu_torch.io import fastparse as tfp
from afesp_tpu_torch.ops import _build
from afesp_tpu_torch.ops import packed_eri as tpe
from torch_fixtures import write_h2o

REPO = Path(__file__).resolve().parent.parent
PVTZ = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
INPUTS = [(PVTZ / "s.dat", 3), (PVTZ / "t.dat", 3), (PVTZ / "v.dat", 3),
          (REPO / "data" / "h2o-cc-pvtz" / "eri.dat", 5)]


@pytest.mark.parametrize("path,ncols", INPUTS, ids=lambda x: getattr(x, "name", str(x)))
def test_scanner_numpy_and_jax_tables_identical(path, ncols, monkeypatch):
    assert tfp.available() and jfp.available()
    before = dict(tfp.ROUTES)
    scanned = tdat._parse_numeric_table(path, ncols)
    assert tfp.ROUTES["scanner"] == before.get("scanner", 0) + 1
    jax_scanned = jfp.parse_doubles_file(path, ncols)
    monkeypatch.setenv("AFESP_NO_FASTPARSE", "1")
    monkeypatch.setattr(tfp, "_LIB", None)
    numpy_table = tdat._parse_numeric_table(path, ncols)
    assert tfp.ROUTES["numpy"] == before.get("numpy", 0) + 1
    monkeypatch.setattr(tfp, "_LIB", None)
    for other in (jax_scanned, numpy_table):
        assert other.shape == scanned.shape
        assert np.array_equal(other.view(np.uint64), scanned.view(np.uint64))


def test_scanner_builds_into_the_build_directory():
    so = tfp.build()
    assert so.parent == _build.BUILD_DIR
    assert so.exists() and so.name.startswith("lib_fastparse-")
    # never next to its source, and never in csrc/ (the kernels' hash)
    assert not list(Path(tfp.__file__).parent.glob("*.so"))
    assert not list(_build.CSRC.glob("_fastparse*"))


def test_scanner_source_is_jax_s_line_for_line():
    body = lambda p: p.read_text().split("#include <stdint.h>", 1)[1]
    assert body(Path(tfp._SRC)) == body(Path(jfp._SRC))


@pytest.mark.parametrize("token,ncols", [("1 2 x3\n", 3), ("1 2 3.5e\n", 3),
                                         ("1 2 3 4\n", 3)])
def test_malformed_input_raises_jax_s_message(tmp_path, token, ncols):
    p = tmp_path / "bad.dat"
    p.write_text(token)
    with pytest.raises(ValueError) as je:
        jfp.parse_doubles_file(p, ncols)
    with pytest.raises(ValueError) as te:
        tfp.parse_doubles_file(p, ncols)
    assert str(te.value) == str(je.value)


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


def _npy_dir(base: Path, h2o: Path, keep_dat: bool) -> Path:
    """A copy of the 24-bf H2O with its ERIs as a packed eri.npy (written
    from the JAX package's read of eri.dat), with or without eri.dat."""
    base.mkdir()
    for f in h2o.iterdir():
        if f.name != "eri.dat" or keep_dat:
            shutil.copy(f, base / f.name)
    _, ji = jdat.read_integrals(h2o, True)
    np.save(base / "eri.npy", ji.eri_packed)
    return base


@pytest.mark.parametrize("keep_dat", [False, True], ids=["npy_only", "npy_and_dat"])
@pytest.mark.parametrize("restricted", [True, False])
def test_read_integrals_eri_npy_matches_jax(tmp_path, h2o, keep_dat, restricted):
    """Fault F4: with eri.npy present the port reads it, as JAX does
    (`afesp_tpu/io/dat.py:441-456`); every field equals JAX's bit for bit."""
    d = _npy_dir(tmp_path / "run", h2o, keep_dat)
    if keep_dat:
        # a different eri.npy than eri.dat holds shows which file was read
        packed = np.load(d / "eri.npy")
        packed[0] += 1.0
        np.save(d / "eri.npy", packed)
    js, ji = jdat.read_integrals(d, restricted)
    ts, ti = tdat.read_integrals(d, restricted)
    for f in dataclasses.fields(tdat.System):
        assert np.array_equal(getattr(js, f.name), getattr(ts, f.name)), f.name
    for f in dataclasses.fields(tdat.IntStore):
        assert np.array_equal(getattr(ji, f.name), getattr(ti, f.name)), f.name
    assert np.array_equal(ti.eri_packed, np.load(d / "eri.npy"))


def test_eri_npy_shape_check_raises_jax_s_message(tmp_path, h2o):
    d = _npy_dir(tmp_path / "run", h2o, keep_dat=False)
    np.save(d / "eri.npy", np.zeros(7))
    with pytest.raises(ValueError) as je:
        jdat.read_integrals(d, True)
    with pytest.raises(ValueError) as te:
        tdat.read_integrals(d, True)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("source", ["eri.npy", "eri.dat"])
def test_packed_only_read_unpacks_on_the_device(tmp_path, h2o, source):
    """host_dense=False (a run on a card) keeps only the packed store;
    the device copy, unpacked there by one gather, equals the host dense
    tensor, and is made once and shared."""
    d = _npy_dir(tmp_path / "run", h2o, keep_dat=True) if source == "eri.npy" else h2o
    _, full = tdat.read_integrals(d, True)
    _, ints = tdat.read_integrals(d, True, host_dense=False)
    assert ints.eri is None
    assert np.array_equal(ints.eri_packed, full.eri_packed)
    dev = ints.eri_on_device("cpu")
    assert torch.equal(dev, torch.as_tensor(full.eri))
    assert ints.eri_on_device("cpu") is dev
    ints.free_device_eri()
    assert ints._eri_dev is None


def test_pack_and_unpack_match_jax(h2o):
    _, ji = jdat.read_integrals(h2o, True)
    n = ji.nbasis
    packed = tpe.pack_eri(torch.as_tensor(ji.eri))
    assert np.array_equal(packed.numpy(), jpe.pack_eri(ji.eri))
    dense = tpe.unpack_eri(torch.as_tensor(ji.eri_packed), n)
    want = np.asarray(jpe.unpack_eri(jnp.asarray(ji.eri_packed), n=n))
    assert dense.dtype == torch.float64
    assert np.array_equal(dense.numpy(), want)
    assert np.array_equal(dense.numpy(), tdat.unpack_eri_host(ji.eri_packed, n))
    with pytest.raises(AssertionError, match="n=300"):
        tpe.unpack_eri(torch.zeros(1, dtype=torch.float64), 301)
