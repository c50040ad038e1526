"""The memory tier of a restricted calculation: which forms of the
two-electron integrals live on the device, and when each is freed.

`calc_tier` picks it once a calculation, and the driver hands it to RHF,
MP2 and CCSD (a stage called without one picks its own): "stream" under
AFESP_FORCE_STREAM=1, the JAX package's hook; else "dense" while the
dense path's n^4 tensors and `TIER_HEADROOM_BYTES` fit the card (always
on the CPU unless `choose_tier` is given a budget), above that "stream"
on the digit-GEMM route or "sliced" at "f64" (off a TPU the JAX package
runs the dense path at every size: the rule by memory is the port's).

  dense   RHF reads the dense AO ERI; MP2 makes the dense MO tensor and
          frees the AO ERI at nbasis >= 100 (as JAX); CCSD keeps v_vvvv.
  stream  RHF at nbasis >= `_TPU_FOCK_NBASIS` reads the packed store as
          digitized J/K consts, its guess from a device SCF prelude; MP2
          frees the packed store once its row table supersedes it and
          keeps v_vvvv as per-chunk int8 limbs; CCSD ("f64" refused, as
          in JAX) makes the CR term from them, and drops them as it ends.
  sliced  RHF reads the f64 pair-row table, which the f64 transform
          frees after its first half, before it allocates v_vvvv; CCSD
          makes the CR term as one GEMM over v_vvvv, then drops v_vvvv.

Neither sliced tier has a dense MO tensor: MP2 takes its energy from
the <ij|ab> slice and writes no FCIDUMP, and the spin-orbital CCSD is
refused.  The card's peak memory depends on each release made here.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import trace
from ..config import Config
from ..device import F64
from . import ccsd_spatial as cs
from . import hf as hf_mod
from . import mo_slices
from . import mp2 as mp2_mod

# Above this basis size the JAX package switches to its streaming tier on
# a TPU (`afesp_tpu/methods/mp2.py:48`).  The port, never on a TPU,
# takes a sliced tier by the memory rule or under AFESP_FORCE_STREAM=1;
# the value names the tier in the refusal of the spin-orbital CCSD under
# the variable, as the JAX driver words it.
STREAM_NBASIS = 140
# Basis size from which the JAX package builds the Fock matrix on the
# device (`afesp_tpu/methods/hf.py:56`); off a TPU it does so only on the
# streaming tier, and so does the port.
_TPU_FOCK_NBASIS = 100

# Card memory the tier rule keeps free beside the dense path's n^4
# tensors: the CUDA context, the allocator's slack and the CC stages'
# working set.
TIER_HEADROOM_BYTES = 8e9
# The dense path's peak in units of one dense n^4 f64 tensor: at "f64"
# the AO tensor and `ao_to_mo`'s two live quarter transforms (the
# trimer's measured 22.04 GB = 3 x 7.33); on the digit-GEMM route the
# trimer's measured 40.99 GB = 5.6 x 7.33.
_DENSE_N4_TENSORS = {"f64": 3.0, "hybrid": 5.6}
_DIGIT_PRECISIONS = ("hybrid", "pallas", "fused")


def _force_stream() -> bool:
    """AFESP_FORCE_STREAM=1: the JAX package's hook that routes any size
    through the streaming tier (`afesp_tpu/methods/mp2.py:335`)."""
    return os.environ.get("AFESP_FORCE_STREAM", "") == "1"


def dense_need_bytes(n: int, precision: str) -> float:
    """The dense path's card memory at nbasis n: its n^4 f64 tensors
    (`_DENSE_N4_TENSORS`) plus the packed store resident beside them."""
    npair = n * (n + 1) // 2
    route = "hybrid" if precision in _DIGIT_PRECISIONS else "f64"
    return _DENSE_N4_TENSORS[route] * 8.0 * n**4 + 8.0 * npair * (npair + 1) // 2


def choose_tier(n: int, precision: str, device, budget_bytes: float | None = None) -> str:
    """The tier at nbasis n: "dense", or where the dense path's need and
    `TIER_HEADROOM_BYTES` pass `budget_bytes` the sliced tier of the
    precision ("stream" for the digit-GEMM route, "sliced" at "f64").
    The budget is by default the card's total memory
    (`torch.cuda.mem_get_info`); on the CPU, with no budget given, the
    tier is always "dense"."""
    if budget_bytes is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return "dense"
        budget_bytes = torch.cuda.mem_get_info(dev)[1]
    if dense_need_bytes(n, precision) + TIER_HEADROOM_BYTES <= budget_bytes:
        return "dense"
    return "stream" if precision in _DIGIT_PRECISIONS else "sliced"


def calc_tier(n: int, cfg: Config, device) -> Tier:
    """The tier of a calculation: "stream" under AFESP_FORCE_STREAM=1
    (any precision; the f64 CCSD then refuses it, as in the JAX
    package), else `choose_tier`'s."""
    return Tier("stream" if _force_stream() else choose_tier(n, cfg.ccsd_precision, device))


def _tri(n: int, dev: torch.device):
    tk, tl = np.tril_indices(n)
    return torch.as_tensor(tk, device=dev), torch.as_tensor(tl, device=dev)


def _host(F: torch.Tensor) -> np.ndarray:
    F = F.cpu().numpy()
    trace.synced()
    return F


def _from_upper(fp: torch.Tensor, iu_h, n: int) -> np.ndarray:
    """The symmetric host matrix of a packed upper triangle."""
    fp = _host(fp.to(F64))
    F = np.empty((n, n))
    F[iu_h] = fp
    F.T[iu_h] = fp
    return F


def _stream_fock(ints, H: torch.Tensor):
    """The stream tier's (guess, build) from consts gathered and digitized
    from the packed store: the device prelude's guess, and each build the
    packed upper triangle, in f32 while far from convergence unless the
    prelude converged the guess (JAX `:590-609`)."""
    n, dev = H.shape[0], H.device
    tk, tl = _tri(n, dev)
    consts = hf_mod._fock_stream_consts(ints.packed_on_device(dev), tk, tl, n=n)
    iu_h = np.triu_indices(n)
    iu = tuple(torch.as_tensor(i, device=dev) for i in iu_h)
    prelude = []

    def guess(H_host, S, X, cfg: Config, nocc: int, rep) -> np.ndarray:
        # the device prelude converges the far-from-convergence phase; the
        # host loop polishes to the els.in tolerances.  A DIIS-off config
        # still gets a 2-slot ring (JAX `:517-549`)
        as_dev = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
        fp, iterations = hf_mod._scf_prelude_device(
            H, as_dev(S), as_dev(X), consts, iu, tk, tl, nocc=nocc,
            nerr=max(cfg.scf_diis_n_errmat, 2), maxiter=min(cfg.scf_maxiter, 40),
        )
        F = _from_upper(fp, iu_h, n)
        if not np.isfinite(F).all():  # diverged prelude: core guess
            return H_host.copy()
        prelude.append(iterations)
        rep.write(f" Device SCF prelude: {iterations} iterations.")
        return F

    def build(D: torch.Tensor, rms: float) -> np.ndarray:
        early = rms > 1e-3 and not prelude
        return _from_upper(hf_mod._fock_build_stream(H, D, consts, tk, tl, iu, packed_f32=early),
                           iu_h, n)

    return guess, build


class Tier:
    """A calculation's tier, "dense", "stream" or "sliced" (module docstring)."""

    def __init__(self, name: str):
        self.name = name
        self.dense_mo = name == "dense"  # whether MP2 leaves a dense MO tensor
        self.label = {"stream": "streaming", "sliced": "sliced f64"}.get(name, name)

    def rhf_fock(self, ints, H: torch.Tensor):
        """RHF's (guess, build) from the device core Hamiltonian H: the
        starting host Fock matrix guess(H, S, X, cfg, nocc, rep), None for
        the core Hamiltonian's; build(D, rms) that of device density D."""
        n, dev = H.shape[0], H.device
        has_eri = ints.eri is not None or ints.eri_packed is not None
        if self.name == "stream" and n >= _TPU_FOCK_NBASIS and has_eri:
            return _stream_fock(ints, H)
        if self.name == "sliced" and has_eri:
            tk, tl = _tri(n, dev)
            rows = ints.rows_on_device(dev)
            return None, lambda D, rms: _host(hf_mod.fock_build_rows(H, rows, D, tk, tl))
        eri = ints.eri_on_device(dev)
        return None, lambda D, rms: _host(hf_mod.fock_build(H, eri, D))

    def mo_integrals(self, ints, C: torch.Tensor, nocc: int):
        """MP2Result's (eri_mo, slices, vvvv_B) from the MO coefficients C,
        and the MP2 energy as a function of the orbital energies."""
        n, dev = C.shape[0], C.device
        if self.name == "stream":
            # each vvvv chunk digitized to L=5 limbs as computed (JAX `:266-293`)
            slices, vvvv_B = mo_slices.ao_to_mo_slices(
                ints.packed_on_device(dev), C, n=n, nocc=nocc, digit_L=5,
                free_packed=ints.free_device_packed)
        elif self.name == "sliced":
            slices, vvvv_B = mo_slices.ao_to_mo_slices_f64(
                ints, C, nocc=nocc, free_rows=ints.free_device_rows), None
        if not self.dense_mo:
            return None, slices, vvvv_B, lambda levels: mp2_mod.mp2_energy_from_oovv(
                slices.v_oovv, levels[:nocc], levels[nocc:])
        eri_mo = mp2_mod.ao_to_mo(ints.eri_on_device(dev), C)
        # nothing downstream reads the AO ERI (1.45 GB at 116 bf)
        if n >= 100:
            ints.free_device_eri()
        return eri_mo, None, None, lambda levels: mp2_mod.mp2_energy(eri_mo, levels, nocc)

    def cc_init(self, eri_mo, slices, vvvv_B, cfg: Config, levels: torch.Tensor, nocc: int):
        """CCSD's slices, denominators, MP1 guess and its energy."""
        if self.dense_mo:
            if eri_mo is None:
                raise AssertionError("no dense MO tensor: the streaming tier needs the slices"
                                     " and the vvvv limbs")
            return cs.spatial_cc_init(eri_mo.to(device=levels.device, dtype=F64), levels, nocc)
        if self.name == "stream" and (slices is None or vvvv_B is None):
            raise AssertionError("the streaming tier needs the slices and the vvvv limbs")
        if self.name == "stream" and cfg.ccsd_precision not in _DIGIT_PRECISIONS:
            raise AssertionError(
                "the streaming-slices tier stores v_vvvv as digit limbs; "
                "all-f64 ccsd_precision is not available above the dense cutoff")
        return (slices, *cs.spatial_cc_init_slices(slices, levels, nocc))

    def cc_solve(self, args: tuple, loop: dict, vvvv_B, mesh, vvvv_split: bool):
        """The solve, on `mesh` if given: (state, energies, converged, limbs)."""
        if self.name != "stream":
            solver = cs.get_spatial_solver(vvvv_split=vvvv_split)
            if mesh is None:
                return (*solver(*args, **loop), None)
            from ..parallel import ccsd_shard
            return (*ccsd_shard.ccsd_solve_sharded(mesh, solver, *args, **loop), None)
        solver = cs.ccsd_spatial_solver_ext
        if mesh is None:
            return (*solver(*args, vvvv_B, **loop), vvvv_B)
        from ..parallel import ccsd_shard
        # the CR term reads the same split limbs as the solve
        vvvv_B = ccsd_shard.shard_vvvv_limbs(mesh, vvvv_B)
        return (*ccsd_shard.ccsd_solve_sharded_ext(mesh, solver, *args, vvvv_B, **loop), vvvv_B)

    def cr_term(self, t1: torch.Tensor, v, vvvv_B, cfg: Config):
        """`CCSDResult.cr_vvvv_term`: es("ecba,ie->ciab", v_vvvv, t1), or
        None where (T) makes it from v_vvvv; the sliced tier drops v_vvvv."""
        term = None
        if self.name == "stream" and cfg.ccsd_t_comp_renorm:
            # from the limbs while they are at hand (JAX `:738-760`)
            term = cs._cr_vvvv_term_from_B(t1, vvvv_B, nv=t1.shape[1])
        elif self.name == "sliced":
            # one GEMM over v_vvvv's (e, cba) matricisation, before v_vvvv
            # goes: the einsum would copy v_vvvv first
            if cfg.ccsd_t_comp_renorm:
                o, nv = t1.shape
                term = (t1 @ v.v_vvvv.view(nv, -1)).view(o, nv, nv, nv).permute(1, 0, 3, 2)
            v.v_vvvv = None
        return term

    def drop_limbs(self, mp2) -> None:
        """Once the CC stage returns: its vvvv limbs had no other reader."""
        mp2.vvvv_B = None

    def check_spinorb(self, n: int, cfg: Config) -> None:
        """Refuse the spin-orbital CCSD where no dense MO tensor exists."""
        if self.dense_mo:
            return
        # under the variable the JAX driver's words; else the rule's
        why = (f"the streaming tier (nbasis >= {STREAM_NBASIS}) currently serves"
               if _force_stream() else
               f"the dense path's {dense_need_bytes(n, cfg.ccsd_precision):.3e} bytes at nbasis"
               f" {n} and ccsd_precision {cfg.ccsd_precision!r}, with {TIER_HEADROOM_BYTES:.0e}"
               " bytes of headroom, exceed the card's memory (methods/tiers.choose_tier), so"
               f" the {self.name} tier ran, which serves")
        raise ValueError(f"spin-orbital CCSD needs the dense MO tensor; {why} the spatial"
                         " formulation only — use a *_spatial calc_type at this scale")
