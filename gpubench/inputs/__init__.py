"""The benchmark's input maker: a seeded geometry and its integral files.

`make_inputs` writes, into one directory, what a calculation reads:
`geom.dat` (the configuration's geometry, each Cartesian coordinate
moved by a seeded uniform amount), `s.dat`, `t.dat`, `v.dat` (the
reference's sparse lower-triangular text tables) and `eri.npy` (the
8-fold packed ERI store in `eri_ind` order, as float64).  The integrals
come from `engine.py`, the benchmark's frozen copy of the program's
engine, on the device given; nothing of the program is imported.  The
same seed gives the same files; seed 0 is the configuration's geometry.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..reference.files import read_geometry
from . import engine


def displaced(coords, seed: int, amplitude: float) -> np.ndarray:
    """`coords` (natoms, 3) bohr, each coordinate moved by a uniform draw
    in [-amplitude, amplitude] from `seed`; seed 0 moves nothing."""
    coords = np.asarray(coords, dtype=np.float64)
    if seed == 0:
        return coords.copy()
    rng = np.random.default_rng(np.random.SeedSequence(seed % 2**64))
    return coords + rng.uniform(-amplitude, amplitude, size=coords.shape)


def write_geometry(path: Path, charges, coords) -> None:
    with open(path, "w") as f:
        f.write(f"{len(charges)}\n")
        for z, r in zip(charges, coords):
            f.write(f"{int(z)}\t{r[0]:17.15f}\t{r[1]:17.15f}\t{r[2]:17.15f}\n")


def write_tri_2d(path: Path, M: np.ndarray) -> None:
    """The `i j value` lower triangle, 1-based, '%17.15f' (the program's
    and the reference's one-electron file layout)."""
    n = M.shape[0]
    ii, jj = np.tril_indices(n)
    with open(path, "w") as f:
        f.write("".join(f"{i + 1}\t{j + 1}\t{v:17.15f}\n"
                        for i, j, v in zip(ii, jj, M[ii, jj])))


def make_inputs(out: str | Path, charges, coords, basis: str, *, seed: int,
                amplitude: float, device: str | torch.device) -> dict:
    """Write geom.dat, s/t/v.dat and eri.npy of the displaced geometry into
    `out`; returns {"nbasis", "coords" (as written), "walls" (s a step)}."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    write_geometry(out / "geom.dat", charges, displaced(coords, seed, amplitude))
    # the integrals of the geometry as the calculation will read it back
    charges, coords = read_geometry(out / "geom.dat")
    dev = torch.device(device)
    walls, t = {}, time.perf_counter()
    bas = engine.build_basis(charges, coords, basis)
    host = lambda M: M.cpu().numpy()
    mats = {name: host(M) for name, M in (("s.dat", engine.overlap(bas, dev)),
                                          ("t.dat", engine.kinetic(bas, dev)),
                                          ("v.dat", engine.nuclear(bas, charges, coords, dev)))}
    walls["one_electron"], t = time.perf_counter() - t, time.perf_counter()
    packed = host(engine.eri_packed(bas, dev))
    walls["eri"], t = time.perf_counter() - t, time.perf_counter()
    for name, M in mats.items():
        write_tri_2d(out / name, M)
    np.save(out / "eri.npy", packed)
    walls["files"] = time.perf_counter() - t
    return {"nbasis": bas.nbf, "coords": coords, "walls": walls}
