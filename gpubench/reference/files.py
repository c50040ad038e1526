"""Plain readers of a calculation's input files, for the reference.

The same files the program reads: `s.dat`, `t.dat`, `v.dat` (`i j value`
lower-triangular lines), `geom.dat` (natoms; charge x y z in bohr) and
the ERIs as `eri.npy` (the 8-fold packed store in `eri_ind` order) or
`eri.dat` (`i j k l value` canonical quadruples).  numpy only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def read_matrix(path: Path) -> np.ndarray:
    """A symmetric matrix from its `i j value` lower triangle (1-based)."""
    tab = np.loadtxt(path, ndmin=2)
    i = tab[:, 0].astype(np.int64) - 1
    j = tab[:, 1].astype(np.int64) - 1
    n = int(max(i.max(), j.max())) + 1
    M = np.zeros((n, n))
    M[i, j] = tab[:, 2]
    M[j, i] = tab[:, 2]
    return M


def read_geometry(path: Path) -> tuple[np.ndarray, np.ndarray]:
    lines = Path(path).read_text().split("\n")
    natoms = int(lines[0].split()[0])
    rows = np.array([[float(x) for x in lines[1 + a].split()[:4]] for a in range(natoms)])
    return rows[:, 0], rows[:, 1:4]


def nuclear_repulsion(charges: np.ndarray, coords: np.ndarray) -> float:
    e = 0.0
    for a in range(len(charges)):
        for b in range(a):
            e += charges[a] * charges[b] / float(np.linalg.norm(coords[a] - coords[b]))
    return e


def _pair(x, y):
    lo, hi = np.minimum(x, y), np.maximum(x, y)
    return hi * (hi + 1) // 2 + lo


def packed_eri(directory: Path, n: int) -> np.ndarray:
    """The packed store, from eri.npy or built from eri.dat."""
    d = Path(directory)
    if (d / "eri.npy").exists():
        return np.load(d / "eri.npy").astype(np.float64)
    tab = np.loadtxt(d / "eri.dat", ndmin=2)
    idx = tab[:, :4].astype(np.int64) - 1
    npair = n * (n + 1) // 2
    packed = np.zeros(npair * (npair + 1) // 2)
    packed[_pair(_pair(idx[:, 0], idx[:, 1]), _pair(idx[:, 2], idx[:, 3]))] = tab[:, 4]
    return packed


def dense_eri(packed: np.ndarray, n: int, device, dtype) -> torch.Tensor:
    """(ij|kl) as a dense (n, n, n, n) tensor on `device`: one gather from
    the packed store, made there."""
    p = torch.as_tensor(packed, device=device).to(dtype)
    i = torch.arange(n, device=device, dtype=torch.int64)
    lo, hi = torch.minimum(i[:, None], i[None, :]), torch.maximum(i[:, None], i[None, :])
    pair = (hi * (hi + 1) // 2 + lo).reshape(-1)
    out = torch.empty((n * n, n * n), dtype=dtype, device=device)
    for r0 in range(0, n * n, n):  # row blocks: no (n^2, n^2) int64 index map
        a = pair[r0:r0 + n, None]
        lo, hi = torch.minimum(a, pair[None, :]), torch.maximum(a, pair[None, :])
        out[r0:r0 + n] = p[hi * (hi + 1) // 2 + lo]
    del p
    return out.reshape(n, n, n, n)
