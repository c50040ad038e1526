"""The CC fixed-point loop with amplitude DIIS, on the device.

Port of `afesp_tpu/ops/cc_step.py:24-302`: the DIIS ring buffers, the
incrementally maintained Gram matrix, the fixed-size bordered solve
(`gauss_solve`, with its singular-pivot guard) and the extrapolation.
The JAX package compiles the whole solve into one `lax.while_loop`; the
port runs it as a Python loop on the device with ONE readback per
iteration (the energy and the squared T2 change, read together), which
is what the host needs for the convergence test and the report.

The DIIS system is solved at fixed size (n_errmat+1) with inactive slots
masked to identity rows, algebraically identical to the reference's
growing-size dsysv solve (hf.f90:216-233 semantics).  On convergence
the state carries the last un-extrapolated amplitudes (`t1_raw`,
`t2_raw`), which is what the reference returns (ccsd.f90:252-268).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class CCState:
    t1: torch.Tensor  # current (extrapolated) amplitudes
    t2: torch.Tensor
    t1_raw: torch.Tensor  # last un-extrapolated update (returned on convergence)
    t2_raw: torch.Tensor
    t1_in: torch.Tensor  # amplitudes that fed the last iteration (the
    t2_in: torch.Tensor  # "stale" pair the CR-CC intermediates consume)
    t2_old: torch.Tensor  # for the RMS (ccsd.f90:1776)
    diis_T: torch.Tensor  # (nerr, size) amplitude history
    diis_E: torch.Tensor  # (nerr, size) error history
    gram: torch.Tensor  # (nerr, nerr) E E^T, maintained incrementally
    slot: int  # ring position
    n_active: int


def init_cc_state(t1: torch.Tensor, t2: torch.Tensor, n_errmat: int) -> CCState:
    size = t1.numel() + t2.numel()
    z = lambda *s: t1.new_zeros(s)
    return CCState(
        t1=t1, t2=t2, t1_raw=t1, t2_raw=t2, t1_in=t1, t2_in=t2, t2_old=t2,
        diis_T=z(n_errmat, size), diis_E=z(n_errmat, size),
        gram=z(n_errmat, n_errmat), slot=-1, n_active=0,
    )


def gauss_solve(M: torch.Tensor, rhs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f64 Gauss-Jordan solve with partial pivoting for the tiny DIIS
    system, in the JAX package's exact order of operations.

    Returns (x, ok): ok is a 0-d bool tensor, False when a pivot is
    (near-)zero, i.e. the Gram matrix is singular to working precision;
    callers then keep the unextrapolated amplitudes, since a ~0 pivot
    would inject inf/NaN into the extrapolation.  Everything stays on
    the device: the pivot row is picked by index, never read back."""
    n = M.shape[0]
    A = torch.cat([M, rhs[:, None]], dim=1)
    rows = torch.arange(n, device=M.device)
    for k in range(n):
        col = torch.where(rows < k, -torch.inf, A[:, k].abs())
        p = torch.argmax(col).reshape(1)
        rk, rp = A[k].clone(), A.index_select(0, p)[0]
        A[k] = rp
        A.index_copy_(0, p, rk[None])
        piv = A[k, k]
        # guard the division; a tiny pivot flips `ok` below instead
        safe = torch.where(piv.abs() > 0.0, piv, torch.ones_like(piv))
        factors = A[:, k] / safe
        factors[k] = 0.0
        A = A - factors[:, None] * A[k][None, :]
    diag = torch.diagonal(A[:, :n])
    scale = M.abs().max()
    eps = torch.finfo(M.dtype).eps
    ok = diag.abs().min() > n * eps * torch.clamp(scale, min=1e-300)
    safe_diag = torch.where(diag.abs() > 0.0, diag, torch.ones_like(diag))
    return A[:, n] / safe_diag, ok


def cc_step(
    state: CCState,
    iteration_fn: Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    energy_fn: Callable[..., tuple[torch.Tensor, torch.Tensor]],
    nerr: int,
) -> tuple[CCState, torch.Tensor]:
    """One CC iteration: amplitude update, energy and squared T2 change,
    DIIS (ccsd.f90:617-676).  Returns the new state and a (2,) device
    tensor [energy, rms2] for the caller's one readback."""
    t1n, t2n = iteration_fn(state.t1, state.t2)
    e, rms2 = energy_fn(t1n, t2n, state.t2_old)

    flat = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
    snap = torch.cat([state.t1.reshape(-1), state.t2.reshape(-1)])
    err = flat - snap
    slot = (state.slot + 1) % nerr
    n = min(state.n_active + 1, nerr)
    T, E = state.diis_T, state.diis_E  # updated in place: the ring is ours
    T[slot] = flat
    E[slot] = err

    # the Gram matrix changes only in the slot's row and column
    row = E @ err
    gram = state.gram
    gram[slot, :] = row
    gram[:, slot] = row
    dev = flat.device
    active = torch.arange(nerr, device=dev) < n
    both = active[:, None] & active[None, :]
    M = flat.new_zeros((nerr + 1, nerr + 1))
    M[:nerr, :nerr] = torch.where(both, gram, torch.eye(nerr, dtype=flat.dtype, device=dev))
    border = torch.where(active, -1.0, 0.0).to(flat.dtype)
    M[nerr, :nerr] = border
    M[:nerr, nerr] = border
    rhs = flat.new_zeros(nerr + 1)
    rhs[nerr] = -1.0
    c, solve_ok = gauss_solve(M, rhs)
    extrap = c[:nerr] @ T

    new_flat = torch.where(solve_ok, extrap, flat) if n >= 2 else flat
    t1e = new_flat[: t1n.numel()].reshape(t1n.shape)
    t2e = new_flat[t1n.numel() :].reshape(t2n.shape)

    new_state = CCState(
        t1=t1e, t2=t2e, t1_raw=t1n, t2_raw=t2n, t1_in=state.t1, t2_in=state.t2,
        t2_old=t2n,
        diis_T=T, diis_E=E, gram=gram, slot=slot, n_active=n,
    )
    return new_state, torch.stack([e, rms2])
