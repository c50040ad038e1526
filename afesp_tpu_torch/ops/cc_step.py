"""The CC fixed-point loop with amplitude DIIS, on the device.

Port of `afesp_tpu/ops/cc_step.py:24-302`: the DIIS ring buffers, the
incrementally maintained Gram matrix, the fixed-size bordered solve
(`gauss_solve`, with its singular-pivot guard), the extrapolation, and
`make_cc_solver` with its `precompute` hook (`:199-237`) and
`make_cc_solver_pre` (`:239`), whose hook also takes an operand built
outside the solve (each solve keeps its pieces as `solve.parts`, from
which `parallel/ccsd_shard` builds the multi-device solve): loop-constant
operands (the hybrid iterations' digitized ERI slices) are built once
per solve and handed to every iteration.  The JAX package compiles the
whole solve into one `lax.while_loop` (and pins the consts with an
optimization barrier, `_pin`, which eager torch needs no counterpart
of); the port runs it as a Python loop on the device with one readback
per iteration (the energy and the squared T2 change, read together),
which is what the host needs for the convergence test and the report.
That readback is not the iteration's only host-device synchronisation:
on an H100 an iteration makes nerr + 3 of them (11 at nerr = 8, 9 at 6,
counted by the recorder's `syncs`).  Each Python scalar written into a
device tensor is a host scalar copied over with a sync: `gauss_solve`'s
`factors[k] = 0.0`, once a pivot step (nerr + 1), and `cc_step`'s
`rhs[nerr] = -1.0`, once.  The first of them blocks the host until the
device has run the iteration's launches.  Each pass of the loop is the
span `ccsd.iter` (`trace.py`), split into `ccsd.issue` (up to `cc_step`
returning: the launches, and with them those syncs' waits) and
`ccsd.readback` (the readback).  The loop runs inside a digit-graph
scope (`exact_gemm.graph_scope`, closed on every exit): a digit-GEMM
call on the card that the solve has made before is captured once as a
CUDA graph and from then on replayed, the same kernels on the same
bytes, so the host no longer issues its few hundred launches one by one.

The DIIS system is solved at fixed size (n_errmat+1) with inactive slots
masked to identity rows, algebraically identical to the reference's
growing-size dsysv solve (hf.f90:216-233 semantics).  On convergence
the state carries the last un-extrapolated amplitudes (`t1_raw`,
`t2_raw`), which is what the reference returns (ccsd.f90:252-268).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import torch

from .. import trace
from . import exact_gemm


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


class SolverParts(NamedTuple):
    """What a solve was made of (`solve.parts`): the multi-device solve
    (parallel/ccsd_shard) rebuilds it with its vvvv term split."""

    iteration_fn: Callable
    energy_fn: Callable
    precompute: Callable | None


def make_cc_solver(iteration_fn: Callable, energy_fn: Callable,
                   precompute: Callable | None = None) -> Callable:
    """The DIIS-accelerated CC fixed-point loop (`make_cc_solver`,
    JAX `:199-237`).

    iteration_fn(t1, t2, v, D_ia, D_ijab, consts) -> (t1_new, t2_new)
    energy_fn(t1, t2, t2_old, oovv)              -> (energy, rms2)
    precompute(v) -> consts: evaluated once per solve, before the loop;
    consts is None without it.

    solve(state0, v, D_ia, D_ijab, oovv, e0, e_tol, t_tol, *, nerr,
          maxiter, on_iteration=None) -> (state, energies, converged)
    converges when sqrt(rms2) < t_tol and |e - e_old| < e_tol after an
    iteration (e_old starts at the MP1 energy e0, a float).
    on_iteration(k, e, e - e_old, rms2, seconds) is called after each
    iteration (the report's table row); the first one's seconds include
    the precompute."""

    def solve(state, v, D_ia, D_ijab, oovv, e0: float, e_tol: float, t_tol: float, *,
              nerr: int, maxiter: int, on_iteration: Callable | None = None):
        t_it = time.perf_counter()
        consts = precompute(v) if precompute is not None else None
        iteration = lambda t1, t2: iteration_fn(t1, t2, v, D_ia, D_ijab, consts)
        energy = lambda t1, t2, t2_old: energy_fn(t1, t2, t2_old, oovv)
        energies: list[float] = []
        e_old = e0
        with exact_gemm.graph_scope():
            for k in range(1, maxiter + 1):
                with trace.span("ccsd.iter"):
                    with trace.span("ccsd.issue"):
                        state, er = cc_step(state, iteration, energy, nerr)
                    with trace.span("ccsd.readback"):
                        e, rms2 = er.tolist()
                        trace.synced()
                    now = time.perf_counter()
                    if on_iteration is not None:
                        on_iteration(k, e, e - e_old, rms2, now - t_it)
                t_it = now
                energies.append(e)
                done = rms2**0.5 < t_tol and abs(e - e_old) < e_tol
                e_old = e
                if done:
                    return state, energies, True
            return state, energies, False

    solve.parts = SolverParts(iteration_fn, energy_fn, precompute)
    return solve


def make_cc_solver_pre(iteration_fn: Callable, energy_fn: Callable,
                       precompute: Callable) -> Callable:
    """make_cc_solver whose solve takes one more operand, `pre`:
    loop-constant data built outside the solve (the streaming
    transform's digit-limb v_vvvv), handed to precompute(v, pre) once
    per solve (JAX `:239`).

    solve(state0, v, D_ia, D_ijab, oovv, e0, e_tol, t_tol, pre, *, nerr,
          maxiter, on_iteration=None) -> (state, energies, converged)"""

    def solve(state, v, D_ia, D_ijab, oovv, e0: float, e_tol: float, t_tol: float, pre,
              **loop):
        inner = make_cc_solver(iteration_fn, energy_fn, lambda v: precompute(v, pre))
        return inner(state, v, D_ia, D_ijab, oovv, e0, e_tol, t_tol, **loop)

    solve.parts = SolverParts(iteration_fn, energy_fn, precompute)  # precompute(v, pre)
    return solve
