"""Spin-orbital CCSD — Stanton, Gauss, Watts, Bartlett, JCP 94, 4334 (1991).

Port of `afesp_tpu/methods/ccsd_spinorb.py` (`make_spin_slices`,
`_iteration_core` `:350-592` with both F_oo forms, `cc_energy_spinorb`,
`spinorb_denominators`, `spinorb_cc_init`, `do_ccsd_spinorb`
`:700-862`).  The tau/F/W intermediates (build_tau ccsd.f90:678-715,
build_F 717-797, build_W 799-905) and amplitude equations
(update_amplitudes 907-1038) are transcribed code-faithfully, including
the reference's F_oo tau~ term, which contracts as
0.5 tau~[m,n,e,f] <in||ef> (ccsd.f90:792-795; Stanton Eq. 5 writes the
[m<->i]-transposed contraction, selected here by
`ccsd_spinorb_equations = "paper"`).

Every contraction is f64 on the device.  Where the JAX package's f64
iteration routes a contraction through `spin_blocked_einsum` (its `bs`
and `hs`, `:367-392`), so does this one: the forbidden Sz blocks are
skipped and the half-size blocks contracted with `torch.einsum`.  The
JAX package's digit and split GEMMs exist because the TPU has no f64;
the H100 has, so `ccsd_precision` "hybrid"/"pallas"/"fused" run this
same f64 iteration and the result says so (`precision_used`).

The spin-orbital vvvv is held dense while (2 nvirt)^4 f64 stays within
`_BLOCK_VVVV_BYTES` (4e9 bytes), and above it, on every device as in the
JAX package, as its two unique spin blocks (`SpinSlices.vvvv_blocks`,
`ops/spin.spinorb_vvvv_blocks`): 2 x 1.0 GB at the 116-bf dimer, where
the dense slice would take 16.2 GB.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from pathlib import Path

import torch

from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.report import Reporter
from ..ops.cc_step import cc_step, init_cc_state
from ..ops.spin import (
    spin_symmetry_error,
    spin_symmetry_error_blocks,
    spinorb_levels,
    spinorb_slice,
    spinorb_vvvv_blocks,
)
from ..ops.spin_einsum import spin_blocked_einsum
from .hf import HFResult

es = torch.einsum


@dataclasses.dataclass
class SpinSlices:
    """Antisymmetrised spin-orbital ERI slices (ccsd.f90:181-194)."""

    oooo: torch.Tensor
    ooov: torch.Tensor
    ovoo: torch.Tensor
    oovo: torch.Tensor
    oovv: torch.Tensor
    ovvo: torch.Tensor
    ovvv: torch.Tensor
    vovv: torch.Tensor
    # None when the slice is held block-compressed (vvvv_blocks)
    vvvv: torch.Tensor | None
    # the unique (aa, ab) spin blocks of vvvv (ops/spin.spinorb_vvvv_blocks)
    # when (2 nvirt)^4 f64 exceeds _BLOCK_VVVV_BYTES; every vvvv consumer
    # then reads them
    vvvv_blocks: tuple[torch.Tensor, torch.Tensor] | None = None


@dataclasses.dataclass
class CCSDSpinorbResult:
    e_ccsd: float
    t1: torch.Tensor  # (o,v) spin-orbital
    t2: torch.Tensor  # (o,o,v,v) spin-orbital
    converged: bool
    iterations: int
    slices: SpinSlices
    energies: list[float] = dataclasses.field(default_factory=list)  # per iteration
    precision_used: str = "f64"


def make_spin_slices(eri_mo: torch.Tensor, nocc_spatial: int,
                     block_vvvv: bool = False) -> SpinSlices:
    """The nine antisymmetrised slices; with block_vvvv, vvvv is held as
    its two unique spin blocks instead of the dense (2 nvirt)^4 tensor."""
    names = [f.name for f in dataclasses.fields(SpinSlices) if f.name != "vvvv_blocks"]
    return SpinSlices(
        **{
            name: None if block_vvvv and name == "vvvv"
            else spinorb_slice(eri_mo, name, nocc_spatial)
            for name in names
        },
        vvvv_blocks=spinorb_vvvv_blocks(eri_mo, nocc_spatial) if block_vvvv else None,
    )


def tau_vvvv_blocked(tau: torch.Tensor, vvvv: torch.Tensor | None,
                     blocks: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """0.5 * einsum('ijef,efab->ijab', tau, vvvv), exploiting the spin
    block-sparsity of the antisymmetrised slices in block spin order:
    <ef||ab> vanishes unless multiset{spin e, spin f} == multiset{spin a,
    spin b}, and antisymmetry in (e<->f) and (a<->b) collapses the four
    mixed-spin blocks onto one GEMM.  Three GEMMs instead of one 16x
    larger one; the skipped blocks are exact zeros.  Falls back to the
    dense einsum for odd nv.

    blocks: the (aa, ab) unique spin blocks when vvvv is held
    block-compressed (SpinSlices.vvvv_blocks): the same three GEMMs, with
    the bb block read from aa (identical for closed shells in block spin
    order)."""
    if blocks is not None:
        aa_blk, ab_blk = blocks
        vs = aa_blk.shape[0]
        A, B = slice(0, vs), slice(vs, None)
        bb_blk = aa_blk
    else:
        nv = vvvv.shape[0]
        if nv % 2:
            return 0.5 * es("ijef,efab->ijab", tau, vvvv)
        vs = nv // 2
        A, B = slice(0, vs), slice(vs, None)
        aa_blk, bb_blk, ab_blk = vvvv[A, A, A, A], vvvv[B, B, B, B], vvvv[A, B, A, B]
    out_aa = es("ijef,efab->ijab", tau[:, :, A, A], aa_blk)
    out_bb = es("ijef,efab->ijab", tau[:, :, B, B], bb_blk)
    # the (e alpha, f beta) and (e beta, f alpha) contributions are equal
    # by simultaneous antisymmetry of tau and vvvv in (e,f)
    out_ab = 2.0 * es("ijef,efab->ijab", tau[:, :, A, B], ab_blk)
    # <ef||ab> = -<ef||ba>: the (beta a, alpha b) block is the negated
    # transpose of the (alpha a, beta b) block
    out_ba = -out_ab.permute(0, 1, 3, 2)
    top = torch.cat([out_aa, out_ab], dim=3)
    bot = torch.cat([out_ba, out_bb], dim=3)
    return 0.5 * torch.cat([top, bot], dim=2)


def _iteration_core(t1, t2, v: SpinSlices, D_ia, D_ijab, *, paper_foo: bool):
    # Sz-block-sparse evaluation (`bs`, ops/spin_einsum.py) wherever the
    # JAX package's f64 iteration uses it: forbidden spin blocks are
    # exact zeros, so skipping them is exact up to f64 reassociation.
    # Only even spin-orbital extents qualify (always true for the
    # closed-shell spin-orbital path).
    bs = spin_blocked_einsum if t1.shape[0] % 2 == 0 and t1.shape[1] % 2 == 0 else es

    # -------- tau / tau~ (ccsd.f90:678-715) --------
    x = es("ia,jb->ijab", t1, t1)
    x = x - x.permute(0, 1, 3, 2)
    tau_tilde = t2 + 0.5 * x
    tau = t2 + x

    # -------- F intermediates (ccsd.f90:717-797) --------
    F_vv = bs("mf,mafe->ae", t1, v.ovvv) + 0.5 * bs("mnaf,mnfe->ae", tau_tilde, v.oovv)
    if paper_foo:
        # Stanton Eq. 5: 0.5 tau~[i,n,e,f] <mn||ef>
        foo_tau = bs("inef,mnef->mi", tau_tilde, v.oovv)
    else:
        # code-faithful tau~ contraction (ccsd.f90:792-795)
        foo_tau = bs("mnef,inef->mi", tau_tilde, v.oovv)
    F_oo = -bs("ne,nmie->mi", t1, v.ooov) + 0.5 * foo_tau
    F_ov = es("nf,mnef->me", t1, v.oovv)

    # -------- W intermediates (ccsd.f90:799-905) --------
    # W_mnij kept in natural [m,n,i,j] order (stored as [i,j,m,n] upstream)
    w1 = es("mnie,je->mnij", v.ooov, t1)
    W_oooo = v.oooo + w1 - w1.permute(0, 1, 3, 2) + 0.5 * bs("mnef,ijef->mnij", v.oovv, tau)
    # W_abef (Eq. 7) is not materialised: its contributions to the T2
    # equation are fused below, so no O(v^4) temporary beyond vvvv exists.
    # W_mbej (Eq. 8)
    Z = 0.5 * t2 + es("jf,nb->jnfb", t1, t1)  # [j,n,f,b]
    W_ovvo = (
        v.ovvo
        + bs("mbef,jf->mbej", v.ovvv, t1)
        + es("nb,nmej->mbej", t1, v.oovo)
        - bs("mnef,jnfb->mbej", v.oovv, Z)
    )

    # -------- T1 (Eq. 1; ccsd.f90:933-965) --------
    tmp_t1 = (
        es("ie,ae->ia", t1, F_vv)
        - es("mi,ma->ia", F_oo, t1)
        + es("me,maei->ia", t1, v.ovvo)
        + es("miea,me->ia", t2, F_ov)
        + 0.5 * bs("mife,mafe->ia", t2, v.ovvv)
        - 0.5 * es("mnea,mnei->ia", t2, v.oovo)
    )
    t1_new = tmp_t1 / D_ia

    # -------- T2 (Eq. 2; ccsd.f90:967-1031) --------
    # three-operand terms are contracted pairwise in a fixed order, so
    # no o^3 v^3 intermediate can appear whatever einsum's path finder
    s = -es("imbj,ma->ijab", es("ie,mbej->imbj", t1, v.ovvo), t1) + bs(
        "miea,mbej->ijab", t2, W_ovvo
    )
    tmp_t2 = (
        v.oovv
        + s
        - s.permute(1, 0, 2, 3)
        - s.permute(0, 1, 3, 2)
        + s.permute(1, 0, 3, 2)
    )
    s = bs("ijae,be->ijab", t2, F_vv)
    tmp_t2 += s - s.permute(0, 1, 3, 2)
    s = es("ijae,be->ijab", t2, es("mb,me->be", t1, F_ov))
    tmp_t2 -= 0.5 * (s - s.permute(0, 1, 3, 2))
    s = es("im,mjab->ijab", es("ie,me->im", t1, F_ov), t2)
    tmp_t2 -= 0.5 * (s - s.permute(1, 0, 2, 3))
    s = bs("ie,ejab->ijab", t1, v.vovv)
    tmp_t2 += s - s.permute(1, 0, 2, 3)
    s = es("ijbm,ma->ijab", v.oovo, t1)
    tmp_t2 += s - s.permute(0, 1, 3, 2)
    s = es("mi,mjab->ijab", F_oo, t2)
    tmp_t2 -= s - s.permute(1, 0, 2, 3)
    tmp_t2 += 0.5 * bs("mnij,mnab->ijab", W_oooo, tau)
    # 0.5 tau_ijef W_abef with W_abef = <ab||ef> + P_(ab) t1[m,b] <ma||ef>,
    # fused: the t1 part factors through G[i,j,m,a] = tau_ijef <ma||ef>
    tmp_t2 += tau_vvvv_blocked(tau, v.vvvv, blocks=v.vvvv_blocks)
    G = bs("ijef,maef->ijma", tau, v.ovvv)
    tmp_t2 += 0.5 * (es("ijma,mb->ijab", G, t1) - es("ijmb,ma->ijab", G, t1))
    t2_new = tmp_t2 / D_ijab

    return t1_new, t2_new


def cc_energy_spinorb(t1, t2, t2_old, oovv):
    """E = 1/4 sum <ij||ab> (t2 + 2 t1 t1) (ccsd.f90:1789-1799), and the
    squared change of t2."""
    ecc = 0.25 * torch.sum(oovv * (t2 + 2.0 * es("ia,jb->ijab", t1, t1)))
    rms2 = torch.sum((t2 - t2_old) ** 2)
    return ecc, rms2


def spinorb_denominators(levels_so: torch.Tensor, nocc: int):
    e_o = levels_so[:nocc]
    e_v = levels_so[nocc:]
    D_ia = e_o[:, None] - e_v[None, :]
    D_ijab = (
        e_o[:, None, None, None]
        + e_o[None, :, None, None]
        - e_v[None, None, :, None]
        - e_v[None, None, None, :]
    )
    return D_ia, D_ijab


def spinorb_cc_init(eri_mo: torch.Tensor, levels: torch.Tensor, nocc_spatial: int,
                    selfcheck: bool = True, block_vvvv: bool = False):
    """Slices, denominators, the MP1 guess, its energy, and the
    permutational-symmetry self-check error (ccsd.f90:150-173); with
    block_vvvv the slice is held, and checked, as its spin blocks."""
    v = make_spin_slices(eri_mo, nocc_spatial, block_vvvv=block_vvvv)
    lv = spinorb_levels(levels, nocc_spatial)
    D_ia, D_ijab = spinorb_denominators(lv, 2 * nocc_spatial)
    t1 = torch.zeros_like(D_ia)
    t2 = v.oovv / D_ijab  # MP1 guess (ccsd.f90:523)
    e0, r0 = cc_energy_spinorb(t1, t2, torch.zeros_like(t2), v.oovv)
    if selfcheck and block_vvvv:
        err = spin_symmetry_error_blocks(v.oooo, v.oovv, *v.vvvv_blocks)
    elif selfcheck:
        err = spin_symmetry_error(v.oooo, v.oovv, v.vvvv)
    else:
        err = e0.new_zeros(())
    return v, D_ia, D_ijab, t1, t2, e0, r0, err


# dense-vvvv byte budget above which do_ccsd_spinorb holds the slice
# block-compressed (tests lower this to force the path on small fixtures)
_BLOCK_VVVV_BYTES = 4e9


def do_ccsd_spinorb(
    sys_: dat.System,
    eri_mo: torch.Tensor,
    cfg: Config,
    hf: HFResult,
    rep: Reporter | None = None,
    workdir: str | Path = ".",
    device: str | torch.device | None = None,
) -> CCSDSpinorbResult:
    dev = default_device(device)
    rep = rep or Reporter()
    rep.section("CCSD")
    t0_stage = time.perf_counter()
    rep.write(" Forming antisymmetrised spinorbital ERIs...")

    eri_mo = eri_mo.to(device=dev, dtype=F64)
    levels = torch.as_tensor(hf.levels, dtype=F64, device=dev)
    # dense vvvv is nvirt^4 f64 (spin-orbital nvirt); above 4 GB it is
    # held as its two unique spin blocks, on every device (16x smaller)
    block_vvvv = sys_.nvirt**4 * 8 > _BLOCK_VVVV_BYTES
    v, D_ia, D_ijab, t1, t2, e0, r0, selfcheck_err = spinorb_cc_init(
        eri_mo, levels, sys_.nel // 2, selfcheck=cfg.spinorb_selfcheck,
        block_vvvv=block_vvvv,
    )
    if cfg.spinorb_selfcheck:
        # the reference's typo is part of the output format
        rep.write(
            " Checking that the permuational symmetry of the antisymmetrised"
            " integrals hold..."
        )
    rep.write(f" Time taken: {time.perf_counter() - t0_stage:8.6f} s")
    rep.write("")
    rep.write(" Forming slices of antisymmetrised spinorbital ERIs")
    rep.write("")

    rep.write(" Initialise CC intermediate tensors and DIIS auxilliary arrays...")
    rep.write(" Forming energy denominator matrices...")
    rep.write(" Allocating amplitude tensors...")
    amp_in = Path(workdir) / "amplitudes_in.npz"
    if cfg.ccsd_read_amplitudes and amp_in.exists():
        rep.write(" Reading previous CC amplitudes as guess...")
        t1_np, t2_np = dat.read_amplitudes(amp_in)
        t1 = torch.as_tensor(t1_np, dtype=F64, device=dev)
        t2 = torch.as_tensor(t2_np, dtype=F64, device=dev)
        e0, r0 = cc_energy_spinorb(t1, t2, torch.zeros_like(t2), v.oovv)
    rep.write(" Forming initial amplitude guesses...")
    if cfg.ccsd_precision != "f64":
        rep.write(
            f' CCSD arithmetic: f64 (ccsd_precision="{cfg.ccsd_precision}"'
            " runs in f64 on this device)"
        )

    iteration = partial(
        _iteration_core, v=v, D_ia=D_ia, D_ijab=D_ijab,
        paper_foo=cfg.ccsd_spinorb_equations == "paper",
    )
    energy_fn = partial(cc_energy_spinorb, oovv=v.oovv)

    rep.write(" Initialisation done, now entering iterative CC solver...")
    rep.cc_table_header()

    energy, r0_h, err = torch.stack([e0, r0, selfcheck_err]).tolist()
    rep.cc_row("MP1", energy, energy, r0_h)
    if cfg.spinorb_selfcheck:
        # the reference compares against depsilon=1e-12 on exact Fortran
        # copies; the tolerance scales with the number of summed elements
        # as in the JAX package (still ~9 orders below a real violation)
        vvvv_size = v.vvvv.numel() if v.vvvv is not None else 16 * v.vvvv_blocks[0].numel()
        tol = max(1e-10, 1e-13 * 2 * (v.oooo.numel() + vvvv_size))
        if err > tol:
            rep.write(f" Permutational symmetry error: {err:15.6E}")
            raise RuntimeError(
                "Permutational symmetry of antisymmetrised integrals does not hold"
            )

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

    # On convergence the reference returns the *unextrapolated* amplitudes
    # of the final iteration (ccsd.f90:252-268)
    t1_out = state.t1_raw if converged else state.t1
    t2_out = state.t2_raw if converged else state.t2
    if cfg.ccsd_write_amplitudes and converged:
        rep.write(" Writing CC amplitudes for future use...")
        dat.write_amplitudes(
            Path(workdir) / "amplitudes_out.npz", t1_out.cpu().numpy(), t2_out.cpu().numpy()
        )
    return CCSDSpinorbResult(
        e_ccsd=energy,
        t1=t1_out,
        t2=t2_out,
        converged=converged,
        iterations=len(energies),
        slices=v,
        energies=energies,
    )
