"""Write the `.dat` integral files from the port's engine.

Port of `afesp_tpu/integrals/generate.py:18-70`: the same sparse
lower-triangular text layouts with a 1e-12 cutoff, so the files
interoperate with both packages and the reference els.x.  The writers
produce the JAX package's bytes from the same matrices; the integrals
are computed on `device` and written from the host.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import default_device
from .engine import build_basis, eri_tensor, kinetic, nuclear, overlap


def _write_tri_2d(path: Path, M: np.ndarray):
    n = M.shape[0]
    with open(path, "w") as f:
        for i in range(1, n + 1):
            for j in range(1, i + 1):
                f.write(f"{i}\t{j}\t{M[i-1, j-1]:17.15f}\n")


def _write_tri_4d(path: Path, eri: np.ndarray, cut: float = 1e-12):
    """Unique-quadruple enumeration (j<=i, k<=i, l<=(k if k<i else j))
    vectorised per i-slab."""
    n = eri.shape[0]
    with open(path, "w") as f:
        for i in range(n):
            J, K = np.meshgrid(np.arange(i + 1), np.arange(i + 1), indexing="ij")
            counts = (np.where(K < i, K, J) + 1).ravel()
            jj = np.repeat(J.ravel(), counts)
            kk = np.repeat(K.ravel(), counts)
            ll = np.arange(counts.sum()) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            vals = eri[i, jj, kk, ll]
            keep = np.abs(vals) > cut
            f.write(
                "".join(
                    f"{i+1}\t{j+1}\t{k+1}\t{l+1}\t{v:17.15f}\n"
                    for j, k, l, v in zip(jj[keep], kk[keep], ll[keep], vals[keep])
                )
            )


def write_dat_files(
    directory: str | Path, charges, coords, basis_name: str, verbose=False,
    write_eri: bool = True, device: str | torch.device | None = None,
):
    """s.dat, t.dat, v.dat, geom.dat and, with `write_eri`, eri.dat for a
    molecule, the integrals computed on `device`.  Returns the basis."""
    dev = default_device(device)
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    basis = build_basis(charges, coords, basis_name)
    host = lambda M: M.cpu().numpy()
    _write_tri_2d(d / "s.dat", host(overlap(basis, dev)))
    _write_tri_2d(d / "t.dat", host(kinetic(basis, dev)))
    _write_tri_2d(d / "v.dat", host(nuclear(basis, charges, coords, dev)))
    # write_eri=False: a large fixture stores its ERIs as the binary packed
    # eri.npy instead (tools/make_dimer.py); the text file is quartic in size
    if write_eri:
        _write_tri_4d(d / "eri.dat", host(eri_tensor(basis, dev, verbose=verbose)))
    with open(d / "geom.dat", "w") as f:
        f.write(f"{len(charges)}\n")
        for z, r in zip(charges, coords):
            f.write(f"{int(z)}\t{r[0]:17.15f}\t{r[1]:17.15f}\t{r[2]:17.15f}\n")
    return basis
