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
that MP2 shares (`IntStore.eri_on_device`).  Each iteration's host work
(the DIIS step of the last Fock build, then F', eigh, density and
energy) is the span `rhf.host` (`trace.py`).

The streaming tier (`afesp_tpu/methods/hf.py:143-413,477-549`), taken
under `AFESP_FORCE_STREAM=1` at nbasis >= `_TPU_FOCK_NBASIS`, as in the
JAX package off a TPU: the J and K matricisations are gathered from the
packed store on the device and digitized once (`_fock_stream_consts`),
every Fock build is two exact digit GEMVs (`_fock_build_stream`), and a
device prelude (`_scf_prelude_device`: canonical purification, no
eigensolve, and Pulay DIIS on the device) gives the host loop its
starting Fock matrix.  The JAX prelude is one `while_loop` dispatch
(for the TPU's remote link); the port's is a Python loop over device
tensors with one readback per iteration, and one per block of
purification steps.  The split Fock build (`_fock_split_consts`,
`_fock_build_split`) is reachable in the JAX package on a TPU backend
only, and is not ported.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from .. import trace
from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.report import Reporter
from ..ops.cc_step import gauss_solve
from ..ops.exact_gemm import digitize_A, exact_gemm
from ..ops.packed_eri import pair_index

# Basis size from which the JAX package builds the Fock matrix on the
# device (`afesp_tpu/methods/hf.py:56`); off a TPU it does so only on the
# streaming tier, under AFESP_FORCE_STREAM=1, and so does the port.
_TPU_FOCK_NBASIS = 100
# purification steps run between two readbacks of their stop test
_PM_BLOCK = 8


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


def _tri_rows(npair: int, ncols: int, budget_elems: float = 1.6e8) -> int:
    """Largest divisor of npair whose (rows, ncols) f64 gather block fits
    the budget: the stream consts are gathered and digitized in row
    blocks of this size."""
    cap = max(1, int(budget_elems / ncols))
    return max(d for d in range(1, npair + 1) if npair % d == 0 and d <= cap)


def _fock_stream_consts(packed: torch.Tensor, tk: torch.Tensor, tl: torch.Tensor, *,
                        n: int, L: int = 6):
    """The stream tier's Fock constants, gathered from the packed store:

      J: the symmetric pair matrix P2[p, q] = (ij|kl) over tri pairs
         p = (i>=j), q = (k>=l), n^4/4 elements;
      K: the tri rows p = (i>=j) of the exchange matricisation (ik|jl)
         over all columns (k, l), n^4/2 elements (F is symmetric, so
         the tri rows suffice; the build scatters them back).

    Each is digitized to L int8 limbs with per-row scales (L=6: ~2^-42
    of scale), row block by row block (`_tri_rows`), which moves no
    digit: the scales are per row.  Returns ((J digits, J scales),
    (K digits, K scales)), the digits equal to the JAX package's."""
    npair = n * (n + 1) // 2
    dev = packed.device
    q = torch.arange(npair, device=dev)
    kk = torch.arange(n, device=dev)

    def digitized(ncols: int, block_values):
        digits = [torch.empty((npair, ncols), dtype=torch.int8, device=dev) for _ in range(L)]
        scales = torch.empty((npair, 1), dtype=packed.dtype, device=dev)
        b = _tri_rows(npair, ncols)
        for p0 in range(0, npair, b):
            rows = torch.arange(p0, p0 + b, device=dev)
            d, sc = digitize_A(block_values(rows), L)
            for dst, src in zip(digits, d):
                dst[p0:p0 + b] = src
            scales[p0:p0 + b] = sc
        return digits, scales

    J_dig = digitized(npair, lambda rows: packed[pair_index(rows[:, None], q[None, :])])

    def k_block(rows):
        ik = pair_index(tk[rows][:, None], kk[None, :])  # (b, n) pair(i,k)
        jl = pair_index(tl[rows][:, None], kk[None, :])  # (b, n) pair(j,l)
        return packed[pair_index(ik[:, :, None], jl[:, None, :])].reshape(rows.numel(), n * n)

    return J_dig, digitized(n * n, k_block)


def _fock_build_stream(H, D, consts, tk, tl, iu=None, packed_f32: bool = False):
    """F = Hcore + 2J - K from the stream consts: J as a tri-pair GEMV
    against the symmetry-weighted density (off-diagonal pairs count
    twice), K as a tri-row GEMV over the whole density, both exact digit
    GEMMs; the symmetric matrices are scattered back from their
    triangles.  With `iu` (upper-triangle index pair) only the packed
    upper triangle is returned, in f32 with `packed_f32` (the JAX
    package's early far-from-convergence iterations)."""
    n = H.shape[0]
    J_dig, K_dig = consts
    w = torch.where(tk == tl, 1.0, 2.0).to(D.dtype) * D[tk, tl]
    Jt = exact_gemm(B=w[:, None], A_dig=J_dig)[:, 0]
    Kt = exact_gemm(B=D.reshape(-1, 1), A_dig=K_dig)[:, 0]
    J = H.new_zeros((n, n))
    J[tk, tl] = Jt
    J[tl, tk] = Jt
    K = H.new_zeros((n, n))
    K[tk, tl] = Kt
    K[tl, tk] = Kt
    F = H + 2.0 * J - K
    if iu is None:
        return F
    Fp = F[iu[0], iu[1]]
    return Fp.to(torch.float32) if packed_f32 else Fp


def _pm_step(D: torch.Tensor):
    """One trace-preserving Palser-Manolopoulos step; returns the new
    density and |tr(D - D^2)|, the loop's convergence measure."""
    D2 = D @ D
    D3 = D2 @ D
    t_hi = torch.trace(D2 - D3)
    t_lo = torch.trace(D - D2)
    cn = t_hi / torch.where(t_lo.abs() > 1e-300, t_lo, torch.full_like(t_lo, 1e-300))
    up_lo = ((1.0 - 2.0 * cn) * D + (1.0 + cn) * D2 - D3) / (1.0 - cn)
    up_hi = ((1.0 + cn) * D2 - D3) / cn
    return torch.where(cn <= 0.5, up_lo, up_hi), t_lo.abs()


def purify_density(Fp: torch.Tensor, *, nocc: int, tol: float = 1e-14, maxiter: int = 100):
    """Occupied-subspace projector of a symmetric (orthogonal-basis) Fock
    matrix by Palser-Manolopoulos canonical purification (PM98), with no
    eigensolve (`afesp_tpu/methods/hf.py:232`).  D0 = (lam/m)(mu I - Fp)
    + (nocc/m) I with Gershgorin bounds has its spectrum in [0, 1] and
    trace nocc; the cubic steps polarise it to {0, 1}, and two trailing
    McWeeny steps finish to f64 where PM's ratio stalls near sqrt(eps).

    The JAX loop tests |tr(D - D^2)| > tol*m after every step; here the
    steps run in blocks of `_PM_BLOCK` with one readback of their measures,
    and the density kept is the one of the step at which the JAX loop
    stops.  Returns (D, steps)."""
    m = Fp.shape[0]
    diag = torch.diagonal(Fp)
    r = Fp.abs().sum(1) - diag.abs()
    fmin = (diag - r).min()
    fmax = (diag + r).max()
    mu = torch.trace(Fp) / m
    # a (near-)uniform spectrum would make D0 NaN; any positive lam works
    lam = torch.minimum(nocc / torch.clamp(fmax - mu, min=1e-300),
                        (m - nocc) / torch.clamp(mu - fmin, min=1e-300))
    eye = torch.eye(m, dtype=Fp.dtype, device=Fp.device)
    D = (lam / m) * (mu * eye - Fp) + (nocc / m) * eye
    steps = 0
    while steps < maxiter:
        run = []
        Dc = D
        for _ in range(min(_PM_BLOCK, maxiter - steps)):
            Dc, t_lo = _pm_step(Dc)
            run.append((Dc, t_lo))
        going = (torch.stack([t for _, t in run]) > tol * m).tolist()
        trace.synced()
        for (Dk, _), more in zip(run, going):
            D = Dk
            steps += 1
            if not more:
                break
        if not more:
            break
    for _ in range(2):
        D2 = D @ D
        D = 3.0 * D2 - 2.0 * D2 @ D
    return D, steps


def _scf_prelude_device(H, S, X, consts, iu, tk, tl, *, nocc: int, nerr: int, maxiter: int):
    """The device SCF prelude of the streaming tier (the `stream=True`
    branch of `afesp_tpu/methods/hf.py:296`): F' = X^T F X -> purified
    density -> exact-GEMM Fock -> Pulay DIIS on the device, until the
    density change is below 1e-8 and the energy change below 1e-7, or
    `maxiter` iterations.  The Fock matrix with the smallest density
    change is kept: once the DIIS system turns singular the bare
    Roothaan map can drift away.  One readback per iteration (its stop
    test).  Returns (packed upper triangle of that Fock matrix,
    iterations run); the host loop of `do_rhf` starts from it."""
    n = H.shape[0]
    F = H
    D_old = torch.zeros_like(H)
    E_old = H.new_zeros(())
    Fh = H.new_zeros((nerr, n * n))
    Eh = H.new_zeros((nerr, n * n))
    gram = H.new_zeros((nerr, nerr))
    eye = torch.eye(nerr, dtype=H.dtype, device=H.device)
    slot, nact = -1, 0
    F_best, best = H, H.new_tensor(float("inf"))
    it = 0
    while it < maxiter:
        Fp = X.T @ F @ X
        D_orth, _ = purify_density(Fp, nocc=nocc)
        D = X @ D_orth @ X.T
        E = torch.sum(D * (H + F))
        rms = torch.sqrt(torch.sum((D - D_old) ** 2))
        # rms scores the Fock this iteration entered with; keep the best
        better = rms < best
        F_best = torch.where(better, F, F_best)
        best = torch.where(better, rms, best)
        done = (rms < 1e-8) & ((E - E_old).abs() < 1e-7)
        Fn = _fock_build_stream(H, D, consts, tk, tl)
        err = (Fn @ D @ S - S @ D @ Fn).reshape(-1)
        slot = (slot + 1) % nerr
        nact = min(nact + 1, nerr)
        Fh[slot] = Fn.reshape(-1)
        Eh[slot] = err
        row = torch.sum(Eh * err[None, :], dim=1)
        gram[slot, :] = row
        gram[:, slot] = row
        active = torch.arange(nerr, device=H.device) < nact
        M = H.new_zeros((nerr + 1, nerr + 1))
        M[:nerr, :nerr] = torch.where(active[:, None] & active[None, :], gram, eye)
        border = torch.where(active, -1.0, 0.0).to(H.dtype)
        M[nerr, :nerr] = border
        M[:nerr, nerr] = border
        rhs = H.new_zeros(nerr + 1)
        rhs[nerr] = -1.0
        c, ok = gauss_solve(M, rhs)
        if nact >= 2:
            Fn = torch.where(ok, torch.sum(c[:nerr, None] * Fh, dim=0).reshape(n, n), Fn)
        F, D_old, E_old = Fn, D, E
        it += 1
        trace.synced()
        if bool(done):
            break
    return F_best[iu[0], iu[1]], it


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


def _diis_step(diis: _DiisHost, F: np.ndarray, D: np.ndarray, S: np.ndarray) -> np.ndarray:
    """The Fock matrix F built from density D after its DIIS step."""
    err = F @ D @ S - S @ D @ F  # DIIS error (hf.f90:212-213)
    extrap = diis.update(F, err)
    return F if extrap is None else extrap


def symmetric_orthogonaliser_np(S: np.ndarray) -> np.ndarray:
    """X = S^{-1/2} = U s^{-1/2} U^T (hf.f90:48-66, Szabo-Ostlund 3.167)."""
    s, U = np.linalg.eigh(S)
    return (U / np.sqrt(s)) @ U.T


def _from_upper(fp: torch.Tensor, iu_h, n: int) -> np.ndarray:
    """The symmetric host matrix of a packed upper triangle."""
    fp = fp.to(F64).cpu().numpy()
    trace.synced()
    F = np.empty((n, n))
    F[iu_h] = fp
    F.T[iu_h] = fp
    return F


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
    stream = False
    if n >= _TPU_FOCK_NBASIS and (ints.eri is not None or ints.eri_packed is not None):
        from .mp2 import _force_stream

        stream = _force_stream()
    if stream:
        # packed-resident tier: the J/K consts are gathered and digitized
        # from the packed store; no dense tensor is built
        tk_h, tl_h = np.tril_indices(n)
        tk = torch.as_tensor(tk_h, device=dev)
        tl = torch.as_tensor(tl_h, device=dev)
        fock_consts = _fock_stream_consts(ints.packed_on_device(dev), tk, tl, n=n)
        iu_h = np.triu_indices(n)
        iu = (torch.as_tensor(iu_h[0], device=dev), torch.as_tensor(iu_h[1], device=dev))
    else:
        eri_dev = ints.eri_on_device(dev)
    X = symmetric_orthogonaliser_np(S)

    prelude_guess = False
    if cfg.scf_read_guess:
        rep.write(" Reading previous AO Fock matrix as guess...")
        F = dat.read_scf_guess(Path(workdir) / "guess_in.dat", n)
    elif stream:
        # the device prelude converges the far-from-convergence phase;
        # the host loop below polishes to the els.in tolerances.  A DIIS-
        # off config still gets a 2-slot ring (JAX `:517-549`)
        as_dev = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
        fp, pre_iters = _scf_prelude_device(
            H_dev, as_dev(S), as_dev(X), fock_consts, iu, tk, tl, nocc=nocc,
            nerr=max(cfg.scf_diis_n_errmat, 2), maxiter=min(cfg.scf_maxiter, 40),
        )
        F = _from_upper(fp, iu_h, n)
        if not np.isfinite(F).all():  # diverged prelude: core guess
            F = H.copy()
        else:
            prelude_guess = True
            rep.write(f" Device SCF prelude: {pre_iters} iterations.")
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

    F_built = None  # the last Fock build, before its DIIS step
    for it in range(1, cfg.scf_maxiter + 1):
        # the iteration's host work: the DIIS step of the Fock matrix built
        # at the end of the previous one, then its eigenproblem and density
        with trace.span("rhf.host"):
            if F_built is not None:
                F = _diis_step(diis, F_built, D, S)
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
        if stream:
            # packed upper triangle, in f32 while far from convergence
            # unless the prelude already converged the guess (JAX `:590-609`)
            early = rms > 1e-3 and not prelude_guess
            fp = _fock_build_stream(H_dev, D_dev, fock_consts, tk, tl, iu, packed_f32=early)
            F_built = _from_upper(fp, iu_h, n)
        else:
            F_built = fock_build(H_dev, eri_dev, D_dev).cpu().numpy()
            trace.synced()

    if result is None:
        F = _diis_step(diis, F_built, D, S)
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
