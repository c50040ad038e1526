"""Spin-free (spatial-orbital) CCSD — Piecuch et al., CPC 149 (2002) 71-96.

Port of `afesp_tpu/methods/ccsd_spatial.py` (`Slices`, `CCSDResult`,
`make_slices`, `denominators`, the f64 branches of `_intermediates` and
`_iteration_core`, `cc_energy_restricted`, `spatial_cc_init` and
`do_ccsd_spatial` on the dense `eri_mo` path).  The equations are the
reference's debug twin routines (update_restricted_intermediates_debug
ccsd.f90:1314-1458, update_amplitudes_restricted_debug 1460-1536,
update_cc_energy 1734-1810), with the Fortran index orders kept
(I_vovv_p[c,i,a,b], I_voov[b,j,i,a], ...) so each line can be checked
term by term against the reference.

Every contraction is an f64 `torch.einsum` on the device.  The JAX
package's digit and split GEMMs exist because the TPU has no f64; the
H100 has, so `ccsd_precision` "hybrid"/"pallas"/"fused" run this same
f64 iteration and the result says so (`precision_used`).  Not ported
yet, and refused with "not ported yet": the streaming-slices tier (no
dense MO tensor, v_vvvv as digit limbs), its `_cr_vvvv_term_from_B`, and
the device mesh.

DIIS follows ccsd.f90:38-67 through the port's `ops/cc_step`; the state
keeps the amplitudes that fed the final iteration (`t1_prev`/`t2_prev`),
which the CR-CC intermediates consume (ccsd.f90:2364-2377).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.report import Reporter
from ..ops.cc_step import cc_step, init_cc_state
from .hf import HFResult

es = torch.einsum


@dataclasses.dataclass
class Slices:
    """Physicist-notation MO ERI slices (ccsd.f90:493-514).

    v_pqrs = <pq|rs> = (pr|qs); o = occupied, v = virtual blocks."""

    v_oovv: torch.Tensor  # (o,o,v,v)
    v_ovov: torch.Tensor  # (o,v,o,v)
    v_vvov: torch.Tensor  # (v,v,o,v)
    v_oovo: torch.Tensor  # (o,o,v,o)
    v_oooo: torch.Tensor  # (o,o,o,o)
    v_vvvv: torch.Tensor  # (v,v,v,v)


@dataclasses.dataclass
class CCSDResult:
    e_ccsd: float
    t1: torch.Tensor  # (o,v)
    t2: torch.Tensor  # (o,o,v,v)
    t1_diagnostic: float
    converged: bool
    iterations: int
    slices: Slices
    # The amplitudes that fed the final iteration: build_cr_ccsd_t_
    # intermediates (ccsd.f90:2338-2551) consumes I_vo and asym_t2
    # computed from these ("stale" relative to the converged t1/t2 —
    # reproduced deliberately).
    t1_prev: torch.Tensor | None = None
    t2_prev: torch.Tensor | None = None
    energies: list[float] = dataclasses.field(default_factory=list)  # per iteration
    precision_used: str = "f64"


def make_slices(eri_mo: torch.Tensor, nocc: int) -> Slices:
    """Chemist (pq|rs) -> physicist <pq|rs> slices (ccsd.f90:493-514),
    each a contiguous copy."""
    phys = eri_mo.permute(0, 2, 1, 3)  # <pq|rs> = (pr|qs)
    o = slice(None, nocc)
    v = slice(nocc, None)
    c = lambda x: x.contiguous()
    return Slices(
        v_oovv=c(phys[o, o, v, v]),
        v_ovov=c(phys[o, v, o, v]),
        v_vvov=c(phys[v, v, o, v]),
        v_oovo=c(phys[o, o, v, o]),
        v_oooo=c(phys[o, o, o, o]),
        v_vvvv=c(phys[v, v, v, v]),
    )


def denominators(levels: torch.Tensor, nocc: int):
    """D_ia = e_i - e_a;  D_ijab = e_i + e_j - e_a - e_b (ccsd.f90:435-445)."""
    e_o = levels[:nocc]
    e_v = levels[nocc:]
    D_ia = e_o[:, None] - e_v[None, :]
    D_ijab = (
        e_o[:, None, None, None]
        + e_o[None, :, None, None]
        - e_v[None, None, :, None]
        - e_v[None, None, None, :]
    )
    return D_ia, D_ijab


def _intermediates(t1, t2, v: Slices) -> dict:
    """Piecuch Table-1 intermediates (debug twin, ccsd.f90:1334-1454)."""
    asym_t2 = 2.0 * t2 - t2.permute(1, 0, 2, 3)
    c_oovv = t2 + es("ia,jb->ijab", t1, t1)

    # I_ai = (2 v_oovv[m,i,e,a] - v_oovv[m,i,a,e]) t1[m,e]        (ccsd.f90:1336)
    I_vo = 2.0 * es("miea,me->ai", v.v_oovv, t1) - es("miae,me->ai", v.v_oovv, t1)

    # the two t1-dressings of v_vvov, shared by I_vv / I_ovov / I_voov / I_ooov'
    #   x_voov[b,j,i,a]    = v_vvov[b,e,i,a] t1[j,e]   (ccsd.f90:1413/1426)
    #   x_ovov_t1[j,b,i,a] = v_vvov[e,b,i,a] t1[j,e]   (ccsd.f90:1401)
    x_voov = es("je,beia->bjia", t1, v.v_vvov)
    x_ovov_t1 = es("je,ebia->jbia", t1, v.v_vvov)

    # I_ba (ccsd.f90:1352-1353); the two v_vvov GEMVs are diagonal traces
    # of the dressings above
    I_vv = (
        2.0 * es("mbma->ba", x_ovov_t1)
        - es("bmma->ba", x_voov)
        - 2.0 * es("mneb,mnea->ba", v.v_oovv, c_oovv)
        + es("mnbe,mnea->ba", v.v_oovv, c_oovv)
    )

    # I_ji' (ccsd.f90:1359)
    I_oo_p = (
        2.0 * es("miej,me->ji", v.v_oovo, t1)
        - es("imej,me->ji", v.v_oovo, t1)
        + es("mief,mjef->ji", v.v_oovv, asym_t2)
    )

    # I_ji = I_ji' + I_ei t1[j,e] (ccsd.f90:1365)
    I_oo = I_oo_p + es("ei,je->ji", I_vo, t1)

    # I_klij (ccsd.f90:1375-1376)
    I_oooo = (
        v.v_oooo
        + es("ijef,klef->klij", v.v_oovv, c_oovv)
        + es("ijel,ke->klij", v.v_oovo, t1)
        + es("jiek,le->klij", v.v_oovo, t1)
    )

    # I_jbia (ccsd.f90:1400-1401)
    I_ovov = (
        v.v_ovov
        - 0.5 * es("imeb,jmea->jbia", v.v_oovv, c_oovv)
        - es("mibj,ma->jbia", v.v_oovo, t1)
        + x_ovov_t1
    )

    # I_bjia (ccsd.f90:1413-1414; x_voov also ccsd.f90:1426)
    I_voov = (
        v.v_oovv.permute(2, 1, 0, 3)  # v_oovv[i,j,b,a] -> [b,j,i,a]
        + es("imbe,mjea->bjia", v.v_oovv, t2)
        - 0.5 * es("imeb,mjea->bjia", v.v_oovv, t2)
        - 0.5 * es("mieb,mjae->bjia", v.v_oovv, c_oovv)
        + x_voov
        - es("imbj,ma->bjia", v.v_oovo, t1)
    )

    # I_jkia' (ccsd.f90:1438)
    I_ooov_p = (
        v.v_oovo.permute(1, 0, 3, 2)  # v_oovo[k,j,a,i] -> [j,k,i,a]
        + es("efia,jkef->jkia", v.v_vvov, t2)
        + es("je,ekia->jkia", t1, x_voov)
    )

    return dict(
        asym_t2=asym_t2, c_oovv=c_oovv, I_vo=I_vo, I_vv=I_vv, I_oo_p=I_oo_p,
        I_oo=I_oo, I_oooo=I_oooo, I_ovov=I_ovov, I_voov=I_voov,
        x_voov=x_voov, I_ooov_p=I_ooov_p,
    )


def _iteration_core(t1, t2, v: Slices, D_ia, D_ijab):
    """One T1/T2 update, Piecuch Eqs. 43-44 (debug twin ccsd.f90:1487-1530)."""
    im = _intermediates(t1, t2, v)
    asym_t2 = im["asym_t2"]
    c_oovv = im["c_oovv"]

    # ---------------- T1 (Eq. 43; ccsd.f90:1487-1495) ----------------
    tmp_t1 = (
        es("ea,ie->ia", im["I_vv"], t1)
        - es("im,ma->ia", im["I_oo_p"], t1)
        + es("em,miea->ia", im["I_vo"], asym_t2)
        + 2.0 * es("miea,me->ia", v.v_oovv, t1)
        - es("maie,me->ia", v.v_ovov, t1)
        - 2.0 * es("mnei,mnea->ia", v.v_oovo, t2)
        + es("mnei,mnae->ia", v.v_oovo, t2)
        + es("efma,mief->ia", v.v_vvov, asym_t2)
    )

    # ---------------- T2 (Eq. 44; ccsd.f90:1497-1526) ----------------
    vvvv_term = 0.5 * es("efab,ijef->ijab", v.v_vvvv, c_oovv)
    # t1 * I_vovv' (Eq. 44 term 5), reassociated through the t1
    # contraction so the (v,o,v,v) intermediate never exists:
    #   sum_e t1[i,e] I_vovv'[e,j,a,b]
    #     = sum_e t1[i,e] v_vvov[b,a,j,e]
    #     - sum_m U[i,m,a,j] t1[m,b],  U = v_ovov[m,a,j,e] t1[i,e]
    #     - sum_m W[i,m,j,b] t1[m,a],  W = v_oovv[m,j,e,b] t1[i,e]
    U = es("ie,maje->imaj", t1, v.v_ovov)
    W = es("ie,mjeb->imjb", t1, v.v_oovv)
    t1_Ivovv = (
        es("ie,baje->ijab", t1, v.v_vvov)
        - es("imaj,mb->ijab", U, t1)
        - es("imjb,ma->ijab", W, t1)
    )
    X = (
        es("ijae,eb->ijab", t2, im["I_vv"])
        - es("imab,jm->ijab", t2, im["I_oo"])
        + vvvv_term
        + 0.5 * es("mnab,ijmn->ijab", c_oovv, im["I_oooo"])
        + t1_Ivovv
        - es("ma,ijmb->ijab", t1, im["I_ooov_p"])
        - es("mjae,iemb->ijab", t2, im["I_ovov"])
        - es("iema,mjeb->ijab", im["I_ovov"], t2)
        + es("miea,ejmb->ijab", asym_t2, im["I_voov"])
    )
    t2_new = (v.v_oovv + X + X.permute(1, 0, 3, 2)) / D_ijab
    t1_new = tmp_t1 / D_ia
    return t1_new, t2_new


def cc_energy_restricted(t1, t2, t2_old, v_oovv):
    """E_CC and the (squared) t2 RMS (ccsd.f90:1764-1781)."""
    asym_v = 2.0 * v_oovv - v_oovv.permute(0, 1, 3, 2)
    ecc = torch.sum(asym_v * (t2 + es("ia,jb->ijab", t1, t1)))
    rms2 = torch.sum((t2 - t2_old) ** 2)
    return ecc, rms2


def spatial_cc_init(eri_mo: torch.Tensor, levels: torch.Tensor, nocc: int):
    """Slices, denominators, the MP1 guess and its energy."""
    v = make_slices(eri_mo, nocc)
    D_ia, D_ijab = denominators(levels, nocc)
    t1 = torch.zeros_like(D_ia)
    t2 = v.v_oovv / D_ijab  # MP1 (ccsd.f90:521)
    e0, r0 = cc_energy_restricted(t1, t2, torch.zeros_like(t2), v.v_oovv)
    return v, D_ia, D_ijab, t1, t2, e0, r0


def do_ccsd_spatial(
    sys_: dat.System,
    eri_mo: torch.Tensor | None,
    cfg: Config,
    hf: HFResult,
    rep: Reporter | None = None,
    workdir: str | Path = ".",
    device: str | torch.device | None = None,
) -> CCSDResult:
    """Restricted CCSD on the dense MO tensor `eri_mo` (do_ccsd_spatial,
    ccsd.f90:279-402)."""
    if eri_mo is None:
        raise NotImplementedError(
            "restricted CCSD without a dense MO tensor (the streaming-slices"
            " tier) is not ported yet"
        )
    dev = default_device(device)
    rep = rep or Reporter()
    rep.section("CCSD")
    t_stage = time.perf_counter()
    rep.write(" Initialise CC intermediate tensors and DIIS auxilliary arrays...")
    rep.write(" Forming energy denominator matrices...")
    rep.write(" Allocating amplitude tensors...")
    rep.write(" Forming ERI slices...")

    nocc = sys_.nocc
    eri_mo = eri_mo.to(device=dev, dtype=F64)
    levels = torch.as_tensor(hf.levels, dtype=F64, device=dev)
    v, D_ia, D_ijab, t1, t2, e0, r0 = spatial_cc_init(eri_mo, levels, nocc)

    rep.write(" Forming initial amplitude guesses...")
    amp_in = Path(workdir) / "amplitudes_in.npz"
    if cfg.ccsd_read_amplitudes and amp_in.exists():
        rep.write(" Reading previous CC amplitudes as guess...")
        t1_np, t2_np = dat.read_amplitudes(amp_in)
        t1 = torch.as_tensor(t1_np, dtype=F64, device=dev)
        t2 = torch.as_tensor(t2_np, dtype=F64, device=dev)
        e0, r0 = cc_energy_restricted(t1, t2, torch.zeros_like(t2), v.v_oovv)
    rep.write(" Allocating stored intermediate tensors...")
    if cfg.ccsd_precision != "f64":
        rep.write(
            f' CCSD arithmetic: f64 (ccsd_precision="{cfg.ccsd_precision}"'
            " runs in f64 on this device)"
        )

    rep.write(f" Time taken: {time.perf_counter() - t_stage:8.6f} s")
    rep.write("")
    rep.write(" Initialisation done, now entering iterative CC solver...")
    rep.cc_table_header()

    iteration = lambda a, b: _iteration_core(a, b, v, D_ia, D_ijab)
    energy_fn = lambda a, b, old: cc_energy_restricted(a, b, old, v.v_oovv)

    energy, r0_h = torch.stack([e0, r0]).tolist()
    rep.cc_row("MP1", energy, energy, r0_h)
    state = init_cc_state(t1, t2, cfg.ccsd_diis_n_errmat)
    energies = []
    converged = False
    e_old = energy
    t_it = time.perf_counter()
    for k in range(1, cfg.ccsd_maxiter + 1):
        state, er = cc_step(state, iteration, energy_fn, cfg.ccsd_diis_n_errmat)
        e, rms2 = er.tolist()
        now = time.perf_counter()
        rep.cc_row(k, e, e - e_old, rms2, now - t_it)
        t_it = now
        energies.append(e)
        done = rms2**0.5 < cfg.ccsd_t_tol and abs(e - e_old) < cfg.ccsd_e_tol
        e_old = e
        if done:
            converged = True
            break
    if energies:
        energy = energies[-1]
    if converged:
        rep.table_close()
        rep.write(" Convergence reached within tolerance.")
        rep.write(f" Final CCSD Energy (Hartree): {energy:15.12f}")

    # On convergence the reference keeps the unextrapolated final
    # amplitudes (ccsd.f90:365-393); t1_in/t2_in are the pair that fed
    # the final iteration (stale I_vo/asym_t2 of the CR intermediates).
    t1_out = state.t1_raw if converged else state.t1
    t2_out = state.t2_raw if converged else state.t2
    if cfg.ccsd_write_amplitudes and converged:
        rep.write(" Writing CC amplitudes for future use...")
        dat.write_amplitudes(
            Path(workdir) / "amplitudes_out.npz", t1_out.cpu().numpy(), t2_out.cpu().numpy()
        )

    t1_diag = 0.0
    if converged:
        # T1 diagnostic (ccsd.f90:369-376)
        t1_diag = (float(torch.sum(t1_out * t1_out)) / sys_.nel) ** 0.5
        rep.write(f" T1 diagnostic: {t1_diag:8.5f}")
        if t1_diag > 0.02:
            rep.write(
                " Significant multireference character detected,"
                " CCSD result might be unreliable!"
            )

    return CCSDResult(
        e_ccsd=energy,
        t1=t1_out,
        t2=t2_out,
        t1_diagnostic=t1_diag,
        converged=converged,
        iterations=len(energies),
        slices=v,
        t1_prev=state.t1_in,
        t2_prev=state.t2_in,
        energies=energies,
    )
