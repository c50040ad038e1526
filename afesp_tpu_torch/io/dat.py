"""Integral / geometry file readers.

Port of `afesp_tpu/io/dat.py:160-483`.  Reads the five text files the
reference consumes (integrals.f90:48-165, geometry.f90:8-50): `s.dat`,
`t.dat`, `v.dat` (one-electron, `i j value` sparse lower-triangular
lines), `eri.dat` (`i j k l value` canonical 8-fold-symmetric
quadruples) and `geom.dat` (natoms; then charge x y z per atom, bohr).

The text tables are parsed by the C scanner of `io/fastparse.py`, or
by numpy where the scanner is switched off or cannot be built.  When a
run directory holds the binary packed `eri.npy`, it is read in place of
`eri.dat`, as the JAX package does (`afesp_tpu/io/dat.py:441-456`).

The arrays read are host numpy, the interchange format.  The ERIs cross
to a device once, packed, and are unpacked there by one gather
(`IntStore.eri_on_device`); the dense host tensor is built only for a
run on the CPU (`read_integrals(..., host_dense=True)`).  Unlike the JAX
reader this one writes no cache file next to its inputs (nor anywhere
else): `eri.dat` is parsed anew on every run.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import trace
from ..ops.packed_eri import unpack_eri
from . import fastparse


@dataclasses.dataclass
class System:
    """Basic system information (system.f90:10-18, geometry.f90:38-46)."""

    natoms: int = 0
    nel: int = 0
    nbasis: int = 0
    nocc: int = 0
    nvirt: int = 0
    charges: np.ndarray | None = None
    coords: np.ndarray | None = None  # (natoms, 3), bohr


@dataclasses.dataclass
class IntStore:
    """AO integral store (integrals.f90:24-34): host arrays, one cached
    device copy of the dense ERI (`eri_on_device`) and, on the
    streaming tier, one of the packed store (`packed_on_device`)."""

    e_nuc: float = 0.0
    nbasis: int = 0
    ovlp: np.ndarray | None = None
    ke: np.ndarray | None = None
    ele_nuc: np.ndarray | None = None
    core_hamil: np.ndarray | None = None
    eri: np.ndarray | None = None  # dense (n,n,n,n) chemist (ij|kl)
    eri_packed: np.ndarray | None = None  # 8-fold store, reference eri_ind order
    _eri_dev: torch.Tensor | None = None  # the one device copy (eri_on_device)
    _packed_dev: torch.Tensor | None = None  # the streaming tier's (packed_on_device)

    def _upload_packed(self, dev: torch.device) -> torch.Tensor:
        """The packed store on `dev`: the one upload both device forms
        are made from (only the packed elements cross PCIe), the span
        `eri.upload` (`trace.py`)."""
        if self._packed_dev is not None and self._packed_dev.device == dev:
            return self._packed_dev
        with trace.span("eri.upload"):
            if self.eri_packed is not None:
                return torch.as_tensor(self.eri_packed, dtype=torch.float64, device=dev)
            from ..ops.packed_eri import pack_eri

            return pack_eri(torch.as_tensor(self.eri, dtype=torch.float64, device=dev))

    def eri_on_device(self, device: str | torch.device) -> torch.Tensor:
        """The dense ERI on `device`, made once and cached, as the JAX
        package's `IntStore.eri_on_device` (`afesp_tpu/io/dat.py:58`):
        HF's Fock build and the MP2 transform share it.  On a card only
        the packed store crosses PCIe and `unpack_eri` builds the dense
        tensor there; on the CPU the host dense tensor, where there is
        one, is used in place."""
        dev = torch.device(device)
        if self._eri_dev is None or self._eri_dev.device != dev:
            if self.eri_packed is not None and (dev.type != "cpu" or self.eri is None):
                self._eri_dev = unpack_eri(self._upload_packed(dev), self.nbasis)
            else:
                self._eri_dev = torch.as_tensor(self.eri, dtype=torch.float64, device=dev)
        return self._eri_dev

    def free_device_eri(self) -> None:
        """Drop the cached device ERI (after the MP2 transform nothing
        reads it; at 116 bf this frees 1.45 GB for the CC stages)."""
        self._eri_dev = None

    def packed_on_device(self, device: str | torch.device) -> torch.Tensor:
        """The 8-fold packed store on `device`, with no unpack, made once
        and cached (`afesp_tpu/io/dat.py:94`): the only resident AO-ERI
        form of the streaming tier, where the dense tensor (7.3 GB at
        174 bf) is never built.  The stream Fock build and the sliced
        MO transform (`methods/mo_slices.py`) both read it."""
        dev = torch.device(device)
        if self._packed_dev is None or self._packed_dev.device != dev:
            self._packed_dev = self._upload_packed(dev)
        return self._packed_dev

    def free_device_packed(self) -> None:
        """Drop the cached device packed store (the sliced transform
        frees it once its row table supersedes it)."""
        self._packed_dev = None


def _parse_numeric_table(path: Path, ncols: int) -> np.ndarray:
    """Whitespace-table parser: the C scanner (`io/fastparse.py`), else
    the numpy route, which gives the same table bit for bit."""
    arr = fastparse.parse_doubles_file(path, ncols)
    if arr is not None:
        return arr
    fastparse.ROUTES["numpy"] += 1
    arr = np.array(path.read_text().split(), dtype=np.float64)
    if arr.size % ncols != 0:
        raise ValueError(f"{path}: expected {ncols} columns")
    return arr.reshape(-1, ncols)


def read_dat_matrix(path: str | Path, nbasis: int | None = None) -> np.ndarray:
    """Read a symmetric matrix from `i j value` lines (integrals.f90:100-140)."""
    path = Path(path)
    tab = _parse_numeric_table(path, 3)
    i = tab[:, 0].astype(np.int64) - 1
    j = tab[:, 1].astype(np.int64) - 1
    if nbasis is None:
        nbasis = int(max(i.max(), j.max())) + 1
    mat = np.zeros((nbasis, nbasis))
    mat[i, j] = tab[:, 2]
    mat[j, i] = tab[:, 2]
    return mat


def _pair_index(i: np.ndarray, j: np.ndarray) -> np.ndarray:
    hi, lo = np.maximum(i, j), np.minimum(i, j)
    return hi * (hi + 1) // 2 + lo


def pack_from_table(
    i: np.ndarray, j: np.ndarray, k: np.ndarray, l: np.ndarray,
    v: np.ndarray, nbasis: int,
) -> np.ndarray:
    """Canonical-quadruple table -> packed 8-fold store in the
    reference's eri_ind order (integrals.f90:196-210): ij = tri(max)+min
    over orbital pairs, index = tri(max)+min over pair pairs."""
    npair = nbasis * (nbasis + 1) // 2
    packed = np.zeros(npair * (npair + 1) // 2)
    packed[_pair_index(_pair_index(i, j), _pair_index(k, l))] = v
    return packed


def pack_from_quadruple_table(tab: np.ndarray, nbasis: int) -> np.ndarray:
    """pack_from_table over a whole (nquad, 5) table, in chunks of 1M
    rows so that the index temporaries stay small."""
    npair = nbasis * (nbasis + 1) // 2
    packed = np.zeros(npair * (npair + 1) // 2)
    ch = 1 << 20
    for c0 in range(0, tab.shape[0], ch):
        t = np.asarray(tab[c0 : c0 + ch])
        i, j, k, l = (t[:, c].astype(np.int64) - 1 for c in range(4))
        packed[_pair_index(_pair_index(i, j), _pair_index(k, l))] = t[:, 4]
    return packed


def unpack_eri_host(packed: np.ndarray, n: int) -> np.ndarray:
    """Packed eri_ind store -> dense (n,n,n,n) chemist tensor."""
    idx = np.arange(n, dtype=np.int64)
    pair = _pair_index(idx[:, None], idx[None, :]).reshape(-1)  # (n^2,)
    return packed[_pair_index(pair[:, None], pair[None, :])].reshape(n, n, n, n)


def read_eri_table(path: str | Path) -> np.ndarray:
    """Parse `eri.dat` into its (nquad, 5) canonical-quadruple table."""
    return _parse_numeric_table(Path(path), 5)


def read_eri_dense(
    path: str | Path, nbasis: int, tab: np.ndarray | None = None
) -> np.ndarray:
    """Read `eri.dat` and scatter into the dense (n,n,n,n) chemist tensor,
    applying the full 8-fold permutational symmetry
    (ij|kl)=(ji|kl)=(ij|lk)=(ji|lk)=(kl|ij)=(lk|ij)=(kl|ji)=(lk|ji)."""
    if tab is None:
        tab = read_eri_table(path)
    i, j, k, l = (tab[:, c].astype(np.int64) - 1 for c in range(4))
    v = tab[:, 4]
    eri = np.zeros((nbasis,) * 4)
    for a, b, c, d in (
        (i, j, k, l),
        (j, i, k, l),
        (i, j, l, k),
        (j, i, l, k),
        (k, l, i, j),
        (l, k, i, j),
        (k, l, j, i),
        (l, k, j, i),
    ):
        eri[a, b, c, d] = v
    return eri


def read_geometry(path: str | Path) -> tuple[int, np.ndarray, np.ndarray]:
    """Read `geom.dat`: natoms, charges, coords (bohr). geometry.f90:8-36."""
    lines = Path(path).read_text().split("\n")
    natoms = int(lines[0].split()[0])
    charges = np.zeros(natoms, dtype=np.int64)
    coords = np.zeros((natoms, 3))
    for a in range(natoms):
        parts = lines[1 + a].split()
        charges[a] = int(float(parts[0]))
        coords[a] = [float(x) for x in parts[1:4]]
    return natoms, charges, coords


def nuclear_repulsion(charges: np.ndarray, coords: np.ndarray) -> float:
    """E_nuc = sum_{i<j} Z_i Z_j / r_ij (geometry.f90:74-95)."""
    e = 0.0
    n = len(charges)
    for j in range(1, n):
        for i in range(j):
            r = np.linalg.norm(coords[i] - coords[j])
            e += charges[i] * charges[j] / r
    return float(e)


def read_integrals(
    directory: str | Path, restricted: bool, require_eri: bool = True,
    host_dense: bool = True,
) -> tuple[System, IntStore]:
    """Read all input files from a run directory, mirroring the pipeline
    read_integrals_in (integrals.f90:48-165) + read_geometry_in
    (geometry.f90:8-50) including the occupied/virtual bookkeeping:
    restricted: nocc=nel/2, nvirt=nbasis-nocc; spin-orbital: nocc=nel,
    nvirt=(nbasis-nocc/2)*2 (geometry.f90:40-46).

    The ERIs come from `eri.npy` (the packed store) when the directory
    holds one, else from `eri.dat`.  `host_dense=False`, a run on a card,
    keeps only the packed store (`ints.eri` stays None): the dense tensor
    is then built on the device (`IntStore.eri_on_device`).
    """
    d = Path(directory)
    sys_ = System()
    ints = IntStore()

    ints.ovlp = read_dat_matrix(d / "s.dat")
    sys_.nbasis = ints.ovlp.shape[0]
    ints.ke = read_dat_matrix(d / "t.dat", sys_.nbasis)
    ints.ele_nuc = read_dat_matrix(d / "v.dat", sys_.nbasis)
    ints.core_hamil = ints.ke + ints.ele_nuc
    ints.nbasis = sys_.nbasis
    if require_eri or (d / "eri.dat").exists() or (d / "eri.npy").exists():
        n = sys_.nbasis
        if (d / "eri.npy").exists():
            # the binary packed store in eri_ind order; read first, as JAX does
            src = np.load(d / "eri.npy", mmap_mode="r")
            npair = n * (n + 1) // 2
            if src.shape != (npair * (npair + 1) // 2,):
                raise ValueError(
                    f"eri.npy shape {src.shape} inconsistent with nbasis={n}"
                )
            packed = np.zeros(src.shape)
            np.copyto(packed, src)
            if host_dense:
                ints.eri = unpack_eri_host(packed, n)
        else:
            tab = read_eri_table(d / "eri.dat")
            packed = pack_from_quadruple_table(tab, n)
            if host_dense:
                ints.eri = read_eri_dense(d / "eri.dat", n, tab=tab)
        ints.eri_packed = packed

    sys_.natoms, sys_.charges, sys_.coords = read_geometry(d / "geom.dat")
    sys_.nel = int(sys_.charges.sum())
    if restricted:
        sys_.nocc = sys_.nel // 2
        sys_.nvirt = sys_.nbasis - sys_.nocc
    else:
        sys_.nocc = sys_.nel
        sys_.nvirt = (sys_.nbasis - sys_.nocc // 2) * 2
    ints.e_nuc = nuclear_repulsion(sys_.charges, sys_.coords)
    return sys_, ints


def read_scf_guess(path: str | Path, nbasis: int) -> np.ndarray:
    """Read a previous AO Fock matrix, `guess_in.dat` (hf.f90:153-170)."""
    tab = _parse_numeric_table(Path(path), 3)
    i = tab[:, 0].astype(np.int64) - 1
    j = tab[:, 1].astype(np.int64) - 1
    mat = np.zeros((nbasis, nbasis))
    mat[i, j] = tab[:, 2]
    return mat


def write_scf_guess(path: str | Path, ao_fock: np.ndarray) -> None:
    """Write the converged AO Fock matrix, `guess_out.dat` (hf.f90:172-191),
    in the reference's '(I0, 1X, I0, 1X, ES16.9)' format."""
    n = ao_fock.shape[0]
    with open(path, "w") as f:
        for i in range(n):
            for j in range(n):
                f.write(f"{i+1} {j+1} {ao_fock[i, j]:16.9E}\n")


def read_amplitudes(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """CC amplitude restart file (npz with t1, t2) — a capability beyond
    the reference's SCF-guess-only checkpointing."""
    data = np.load(path)
    return data["t1"], data["t2"]


def write_amplitudes(path: str | Path, t1, t2) -> None:
    np.savez_compressed(path, t1=np.asarray(t1), t2=np.asarray(t2))
