"""Restricted Hartree-Fock with DIIS (hf.f90:21-151).

Port of `afesp_tpu/methods/hf.py`: the host loop of `do_rhf`
(`hf.py:456-633`), `_DiisHost` (`:416-448`) and
`symmetric_orthogonaliser_np` (`:450`), with the f64 Fock build
(`fock_build_jax`, `:88-98`) as torch on the device.

The per-iteration sequence replicates do_rhf exactly so that SCF
trajectories match the reference to roundoff:

  F' = X^T F X -> eigh -> C = (X C')^T -> D = C_occ^T C_occ
  -> E = sum(D*(Hcore+F)), convergence on (dE, ||dD||_F)
  -> fresh Fock from D -> DIIS extrapolation of F.

The eigensolve and DIIS stay in host LAPACK/numpy as in the JAX host
loop (at the reference's scale SCF is latency-bound); only the O(n^4)
Fock build runs on the device, against the one device copy of the ERI
that MP2 shares (`IntStore.eri_on_device`).  The TPU
tiers of the JAX package (the >=100-bf device prelude, the split and
stream Fock builds) are not ported.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.report import Reporter


@dataclasses.dataclass
class HFResult:
    e_hf: float  # electronic energy (E_nuc added only in the report)
    coeff: np.ndarray  # canonical MO coefficients, rows = MO (sys%canon_coeff)
    levels: np.ndarray  # orbital energies ascending (sys%canon_levels)
    ao_fock: np.ndarray  # the AO Fock diagonalised at convergence
    converged: bool
    iterations: int
    energies: list[float] = dataclasses.field(default_factory=list)  # per iteration


def fock_build(H: torch.Tensor, eri: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """F = Hcore + 2J - K (replaces the packed-ERI OpenMP loop,
    hf.f90:349-385)."""
    n = H.shape[0]
    J = (eri.reshape(n * n, n * n) @ D.reshape(-1)).reshape(n, n)
    K = torch.einsum("ikjl,kl->ij", eri, D)
    return H + 2.0 * J - K


class _DiisHost:
    """Host-side Pulay DIIS over Fock matrices (hf.f90:197-266)."""

    def __init__(self, n_errmat: int, shape):
        self.use_diis = n_errmat >= 2
        self.n_errmat = n_errmat
        self.n_active = 0
        self.slot = -1
        if self.use_diis:
            self.F = np.zeros((n_errmat,) + shape)
            self.E = np.zeros((n_errmat,) + shape)

    def update(self, F: np.ndarray, err: np.ndarray) -> np.ndarray | None:
        if not self.use_diis:
            return None
        self.slot = (self.slot + 1) % self.n_errmat
        self.n_active = min(self.n_active + 1, self.n_errmat)
        self.F[self.slot] = F
        self.E[self.slot] = err
        n = self.n_active
        if n < 2:  # `if (n > 1)` guard, hf.f90:216
            return None
        B = np.zeros((n + 1, n + 1))
        for i in range(n):
            for j in range(i + 1):
                B[i, j] = B[j, i] = np.sum(self.E[i] * self.E[j])
        B[n, :n] = -1.0
        B[:n, n] = -1.0
        rhs = np.zeros(n + 1)
        rhs[n] = -1.0
        c = np.linalg.solve(B, rhs)
        return np.tensordot(c[:n], self.F[:n], axes=1)


def symmetric_orthogonaliser_np(S: np.ndarray) -> np.ndarray:
    """X = S^{-1/2} = U s^{-1/2} U^T (hf.f90:48-66, Szabo-Ostlund 3.167)."""
    s, U = np.linalg.eigh(S)
    return (U / np.sqrt(s)) @ U.T


def do_rhf(
    sys_: dat.System,
    ints: dat.IntStore,
    cfg: Config,
    rep: Reporter | None = None,
    workdir: str | Path = ".",
    device: str | torch.device | None = None,
) -> HFResult:
    dev = default_device(device)
    rep = rep or Reporter()
    rep.section("Restricted Hartree-Fock")
    t_start = time.perf_counter()

    n = sys_.nbasis
    nocc = sys_.nel // 2  # hf.f90:105 uses nel/2 regardless of path

    S = ints.ovlp
    H = ints.core_hamil
    H_dev = torch.as_tensor(H, dtype=F64, device=dev)
    eri_dev = ints.eri_on_device(dev)
    X = symmetric_orthogonaliser_np(S)

    if cfg.scf_read_guess:
        rep.write(" Reading previous AO Fock matrix as guess...")
        F = dat.read_scf_guess(Path(workdir) / "guess_in.dat", n)
    else:
        # Core-Hamiltonian guess (hf.f90:78-81)
        F = H.copy()

    diis = _DiisHost(cfg.scf_diis_n_errmat, (n, n))

    rep.scf_table_header()
    D_old = np.zeros((n, n))
    energy_old = 0.0
    energies = []
    result = None
    t0 = time.perf_counter()

    for it in range(1, cfg.scf_maxiter + 1):
        Fp = X.T @ F @ X
        w, Cp = np.linalg.eigh(Fp)
        C = (X @ Cp).T  # rows = MO index (hf.f90:102)
        D = C[:nocc].T @ C[:nocc]
        energy = float(np.sum(D * (H + F)))
        energies.append(energy)
        rms = float(np.sqrt(np.sum((D - D_old) ** 2)))
        t1 = time.perf_counter()
        rep.scf_row(it, energy, energy - energy_old, rms, t1 - t0)
        t0 = t1

        if rms < cfg.scf_d_tol and abs(energy - energy_old) < cfg.scf_e_tol:
            rep.table_close()
            rep.write(" Convergence reached within tolerance.")
            rep.write(f" Final SCF Energy (Hartree): {energy:15.8f}")
            rep.write(" Orbital energies (Hartree):")
            for i in range(n, 0, -1):
                rep.write(f" {i:3d} {w[i-1]:15.8f}")
            result = HFResult(
                e_hf=energy, coeff=C, levels=w, ao_fock=F, converged=True,
                iterations=it, energies=energies,
            )
            if cfg.scf_write_guess:
                rep.write(" Writing AO Fock matrix for future use...")
                dat.write_scf_guess(Path(workdir) / "guess_out.dat", F)
            break

        energy_old = energy
        D_old = D
        D_dev = torch.as_tensor(D, dtype=F64, device=dev)
        F = fock_build(H_dev, eri_dev, D_dev).cpu().numpy()
        err = F @ D @ S - S @ D @ F  # DIIS error (hf.f90:212-213)
        extrap = diis.update(F, err)
        if extrap is not None:
            F = extrap

    if result is None:
        # Warn-and-continue, matching hf.f90:144-146 (does NOT abort)
        rep.write(" Convergence not reached, please increase maxiter.")
        result = HFResult(
            e_hf=energy, coeff=C, levels=w, ao_fock=F, converged=False,
            iterations=cfg.scf_maxiter, energies=energies,
        )

    rep.stage_time(
        "Time taken for restricted Hartree-Fock:", time.perf_counter() - t_start
    )
    return result
