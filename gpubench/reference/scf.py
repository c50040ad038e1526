"""Plain restricted Hartree-Fock with Pulay DIIS (Szabo & Ostlund, ch. 3).

The iteration the program's input format defines (the reference code's
hf.f90): symmetric orthogonalisation X = S^-1/2, the core-Hamiltonian
guess, and in each iteration F' = X^T F X, its eigenvectors C = X C',
the density D = C_occ C_occ^T, the energy sum(D (H + F)); converged when
||D - D_old||_F < scf_d_tol and |E - E_old| < scf_e_tol; otherwise a
new F = H + 2J - K and a DIIS extrapolation over the last
scf_diis_n_errmat Fock matrices with errors F D S - S D F.  Every step
is torch on the given device, in the given dtype; `fock_dtype` puts the
J/K build alone in another (its ERIs cast once), the control of a Fock
build in a lower precision.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class SCF:
    energy: float  # electronic
    coeff: torch.Tensor  # (n, n) columns are MOs, orbital energies ascending
    levels: torch.Tensor  # (n,)
    iterations: int
    converged: bool


def fock(H: torch.Tensor, eri: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """H + 2J - K, J and K contracted in the ERIs' dtype."""
    n = H.shape[0]
    D = D.to(eri.dtype)
    J = (eri.reshape(n * n, n * n) @ D.reshape(-1)).reshape(n, n)
    K = torch.einsum("ikjl,kl->ij", eri, D)
    return H + 2.0 * J.to(H.dtype) - K.to(H.dtype)


def diis_extrapolate(Fs: list, Es: list) -> torch.Tensor:
    n = len(Fs)
    B = Fs[0].new_zeros((n + 1, n + 1))
    for i in range(n):
        for j in range(i + 1):
            B[i, j] = B[j, i] = torch.sum(Es[i] * Es[j])
    B[n, :n] = -1.0
    B[:n, n] = -1.0
    rhs = Fs[0].new_zeros(n + 1)
    rhs[n] = -1.0
    c = torch.linalg.solve(B, rhs)
    return sum(c[k] * Fs[k] for k in range(n))


def rhf(S, H, eri, nocc: int, *, e_tol: float, d_tol: float, n_errmat: int,
        maxiter: int, fock_dtype: torch.dtype | None = None) -> SCF:
    if fock_dtype is not None:
        eri = eri.to(fock_dtype)
    s, U = torch.linalg.eigh(S)
    X = (U / torch.sqrt(s)) @ U.T
    F = H.clone()
    D_old = torch.zeros_like(H)
    e_old = 0.0
    Fs, Es = [], []
    for it in range(1, maxiter + 1):
        w, Cp = torch.linalg.eigh(X.T @ F @ X)
        C = X @ Cp
        D = C[:, :nocc] @ C[:, :nocc].T
        energy = float(torch.sum(D * (H + F)))
        rms = float(torch.linalg.norm(D - D_old))
        if rms < d_tol and abs(energy - e_old) < e_tol:
            return SCF(energy, C, w, it, True)
        e_old, D_old = energy, D
        F = fock(H, eri, D)
        if n_errmat >= 2:
            Fs.append(F)
            Es.append(F @ D @ S - S @ D @ F)
            Fs, Es = Fs[-n_errmat:], Es[-n_errmat:]
            if len(Fs) >= 2:
                F = diis_extrapolate(Fs, Es)
    return SCF(energy, C, w, maxiter, False)
