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

With `ccsd_precision` "f64" (the default) every contraction is f64 on
the device: where the JAX package's f64 iteration routes a contraction
through `spin_blocked_einsum` (its `bs` and `hs`, `:367-392`), so does
this one (the forbidden Sz blocks skipped, the half-size blocks
contracted with `torch.einsum`).  "hybrid", "pallas" and "fused" run the
JAX package's hybrid iteration (its rule, JAX `:759`): the 4-index
contractions and every contraction with a constant ERI operand are exact
digit GEMMs (`ops/exact_gemm`), the constant sides digitized once per
solve (`presplit_consts`, `HybridConsts`, through the solver's
precompute hook) unless the ovvv-family limbs exceed
`_OVVV_LIMB_BYTES`, in which case those digitize in the loop, as in the
JAX package; `precision_used` says which ran.

The spin-orbital vvvv is held dense while (2 nvirt)^4 f64 stays within
`_BLOCK_VVVV_BYTES` (4e9 bytes), and above it, on every device as in the
JAX package, as its two unique spin blocks (`SpinSlices.vvvv_blocks`,
`ops/spin.spinorb_vvvv_blocks`): 2 x 1.0 GB at the 116-bf dimer, where
the dense slice would take 16.2 GB.

Under a device mesh (`mesh`, JAX `:767-776`) the tau.vvvv term is split
over the sub-mesh that fits nvirt (`parallel/ccsd_shard`): each entry
holds a slice of the three spin blocks (of the dense slice or of the
`(aa, ab)` store), along the output's a, and computes its part, on the
iteration's route; the rest of the solve runs on the first device.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from pathlib import Path

import torch

from .. import trace
from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.report import Reporter
from ..ops.cc_step import init_cc_state, make_cc_solver
from ..ops.exact_gemm import exact_einsum, exact_gemm, prechunk_A, prechunk_B
from ..ops.spin import (
    spin_symmetry_error,
    spin_symmetry_error_blocks,
    spinorb_levels,
    spinorb_slice,
    spinorb_vvvv_blocks,
)
from ..ops.spin_einsum import spin_blocked_einsum
from ..ops.split_gemm import split_matmul
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
    # the CCSD arithmetic that ran: "f64", or "hybrid" (the digit GEMMs)
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
    return _spin_blocks_out(es("ijef,efab->ijab", tau[:, :, A, A], aa_blk),
                            es("ijef,efab->ijab", tau[:, :, B, B], bb_blk),
                            es("ijef,efab->ijab", tau[:, :, A, B], ab_blk))


def _spin_blocks_out(aa: torch.Tensor, bb: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
    """0.5 tau.vvvv (o, o, nv, nv) from the three block products
    tau[A,A].aa, tau[B,B].bb and tau[A,B].ab, each (o, o, vs, vs)."""
    # the (e alpha, f beta) and (e beta, f alpha) contributions are equal
    # by simultaneous antisymmetry of tau and vvvv in (e,f)
    ab = 2.0 * ab
    # <ef||ab> = -<ef||ba>: the (beta a, alpha b) block is the negated
    # transpose of the (alpha a, beta b) block
    ba = -ab.permute(0, 1, 3, 2)
    top = torch.cat([aa, ab], dim=3)
    bot = torch.cat([ba, bb], dim=3)
    return 0.5 * torch.cat([top, bot], dim=2)


def _split_gemm_chunked(tau_b, v_b, kc: int = 64, B_pre=None):
    """sum_ef tau[i,j,e,f] v[e,f,a,b]: digit GEMM when the vvvv block is
    pre-digitized (B_pre), split_matmul otherwise."""
    o, _, e1, f1 = tau_b.shape
    K = e1 * f1
    if B_pre is not None:
        out = exact_gemm(A=tau_b.reshape(o * o, K), B_pre=B_pre, maxdeg=6)
    else:
        out = split_matmul(tau_b.reshape(o * o, K), v_b.reshape(K, -1), kc)
    return out.reshape(o, o, v_b.shape[2], v_b.shape[3])


@dataclasses.dataclass
class HybridConsts:
    """Loop-constant ERI operands of the hybrid iteration, digitized once
    per solve by presplit_consts (prechunk_A/prechunk_B outputs, L=5),
    in the matricisation exact_einsum builds for the annotated spec.
    The ovvv-family entries are None above _OVVV_LIMB_BYTES: those sites
    then digitize in the loop."""

    vvvv_aa: tuple  # the three vvvv spin blocks, keyed (ef, ab)
    vvvv_bb: tuple
    vvvv_ab: tuple
    ovvv_ef: tuple | None  # <ma||ef> keyed (ef, ma) for the G intermediate
    oovv_me: tuple  # <mn||ef> keyed (me, nf) for the W_mbej tau term
    oovv_mn_dig: tuple  # <mn||ef> keyed (mn, ef) for W_oooo
    ovvv_mbe_dig: tuple | None  # <mb||ef> keyed (mbe, f) for W_ovvo
    vovv_e_dig: tuple | None  # <ej||ab> keyed (e, jab) for the T2 t1*vovv term
    oovv_nef_m_dig: tuple  # B of both F_oo tau~ contractions
    oovv_mnf_e_dig: tuple  # B of "mnaf,mnfe->ae"
    ovvv_mf_ae_dig: tuple | None  # B of "mf,mafe->ae"
    ovvv_mfe_a_dig: tuple | None  # B of "mife,mafe->ia"
    ooov_ne_mi_dig: tuple  # B of "ne,nmie->mi"
    ooov_mni_e_dig: tuple  # A of "mnie,je->mnij"
    oovo_mne_i_dig: tuple  # B of "mnea,mnei->ia"
    oovo_n_mej_dig: tuple  # B of "nb,nmej->mbej"
    oovo_ijb_m_dig: tuple  # A of "ijbm,ma->ijab"


# resident-limb budget for the five ovvv-sized prechunks combined, in the
# JAX package's bf16 bytes (each is 5 limbs of an o*v^3 operand); above
# it they digitize in the loop
_OVVV_LIMB_BYTES = 1.5e9


def presplit_consts(v: SpinSlices, kc: int = 64) -> HybridConsts:
    nv = v.oovv.shape[2]
    vs = nv // 2
    A, B = slice(0, vs), slice(vs, None)
    no = v.oovv.shape[0]
    # the JAX package's byte rule, kept as it is (JAX `:205-220`): at the
    # 116-bf dimer (o=20, v=212) the five ovvv-family sites stay in the loop
    big = no * nv**3 * 2 * 5 > _OVVV_LIMB_BYTES

    def unless_big(pre_fn, build_operand):
        return None if big else pre_fn(build_operand(), L=5)

    if v.vvvv_blocks is not None:
        # block-compressed vvvv: bb == aa for closed shells in block spin
        # order, so one prechunk serves both
        aa_blk, ab_blk = v.vvvv_blocks
        aa_pre = prechunk_B(aa_blk.reshape(vs * vs, vs * vs), L=5)
        vvvv_pre = (aa_pre, aa_pre, prechunk_B(ab_blk.reshape(vs * vs, vs * vs), L=5))
    elif v.vvvv is None:
        # a mesh solve holds vvvv split (parallel/ccsd_shard)
        vvvv_pre = (None, None, None)
    else:
        vvvv_pre = (
            prechunk_B(v.vvvv[A, A, A, A].reshape(vs * vs, vs * vs), L=5),
            prechunk_B(v.vvvv[B, B, B, B].reshape(vs * vs, vs * vs), L=5),
            prechunk_B(v.vvvv[A, B, A, B].reshape(vs * vs, vs * vs), L=5),
        )
    return HybridConsts(
        vvvv_aa=vvvv_pre[0],
        vvvv_bb=vvvv_pre[1],
        vvvv_ab=vvvv_pre[2],
        ovvv_ef=unless_big(prechunk_B,
                           lambda: v.ovvv.permute(2, 3, 0, 1).reshape(nv * nv, no * nv)),
        oovv_me=prechunk_A(v.oovv.permute(0, 2, 1, 3).reshape(no * nv, no * nv), L=5),
        oovv_mn_dig=prechunk_A(v.oovv.reshape(no * no, nv * nv), L=5),
        ovvv_mbe_dig=unless_big(prechunk_A, lambda: v.ovvv.reshape(no * nv * nv, nv)),
        vovv_e_dig=unless_big(prechunk_B, lambda: v.vovv.reshape(nv, no * nv * nv)),
        oovv_nef_m_dig=prechunk_B(v.oovv.permute(1, 2, 3, 0).reshape(no * nv * nv, no), L=5),
        oovv_mnf_e_dig=prechunk_B(v.oovv.reshape(no * no * nv, nv), L=5),
        ovvv_mf_ae_dig=unless_big(prechunk_B,
                                  lambda: v.ovvv.permute(0, 2, 1, 3).reshape(no * nv, nv * nv)),
        ovvv_mfe_a_dig=unless_big(prechunk_B,
                                  lambda: v.ovvv.permute(0, 2, 3, 1).reshape(no * nv * nv, nv)),
        ooov_ne_mi_dig=prechunk_B(v.ooov.permute(0, 3, 1, 2).reshape(no * nv, no * no), L=5),
        ooov_mni_e_dig=prechunk_A(v.ooov.reshape(no * no * no, nv), L=5),
        oovo_mne_i_dig=prechunk_B(v.oovo.reshape(no * no * nv, no), L=5),
        oovo_n_mej_dig=prechunk_B(v.oovo.reshape(no, no * nv * no), L=5),
        oovo_ijb_m_dig=prechunk_A(v.oovo.reshape(no * no * nv, no), L=5),
    )


def tau_vvvv_split(tau, vvvv, consts: HybridConsts | None = None, blocks=None):
    """tau_vvvv_blocked with the three spin-block GEMMs as digit GEMMs
    against the digitized blocks (split-f32 without consts).  blocks: the
    (aa, ab) unique spin blocks when vvvv is block-compressed (bb reads
    aa, identical for closed shells)."""
    nv = tau.shape[2]
    vs = nv // 2
    A, B = slice(0, vs), slice(vs, None)
    pre = (None, None, None) if consts is None else (
        consts.vvvv_aa, consts.vvvv_bb, consts.vvvv_ab)
    if blocks is not None:
        aa_blk, ab_blk = blocks
        bb_blk = aa_blk
    else:
        aa_blk, bb_blk, ab_blk = vvvv[A, A, A, A], vvvv[B, B, B, B], vvvv[A, B, A, B]
    aa = _split_gemm_chunked(tau[:, :, A, A], aa_blk, B_pre=pre[0])
    bb = _split_gemm_chunked(tau[:, :, B, B], bb_blk, B_pre=pre[1])
    ab = _split_gemm_chunked(tau[:, :, A, B], ab_blk, B_pre=pre[2])
    return _spin_blocks_out(aa, bb, ab)


def _w4_split(oovv, Z, consts: HybridConsts | None):
    """w4[m,b,e,j] = sum_nf <mn||ef> Z[j,n,f,b] as one GEMM, the <mn||ef>
    side digitized once when consts are available."""
    no, nv = oovv.shape[0], oovv.shape[2]
    Zm = Z.permute(1, 2, 0, 3).reshape(no * nv, no * nv)  # (nf, jb)
    if consts is None:
        Am = oovv.permute(0, 2, 1, 3).reshape(no * nv, no * nv)
        C = split_matmul(Am, Zm)
    else:
        C = exact_gemm(B=Zm, A_pre=consts.oovv_me, maxdeg=6)
    return C.reshape(no, nv, no, nv).permute(0, 3, 1, 2)  # (m,e,j,b) -> (m,b,e,j)


def _g_split(tau, ovvv, consts: HybridConsts | None):
    """G[i,j,m,a] = sum_ef tau[i,j,e,f] <ma||ef>, the <ma||ef> side
    digitized once when consts hold it, in the loop above the byte rule."""
    no, _, nv, _ = tau.shape
    if consts is None:
        Bm = ovvv.permute(2, 3, 0, 1).reshape(nv * nv, -1)
        C = split_matmul(tau.reshape(no * no, nv * nv), Bm)
    elif consts.ovvv_ef is None:
        Bm = ovvv.permute(2, 3, 0, 1).reshape(nv * nv, -1)
        C = exact_gemm(tau.reshape(no * no, nv * nv), Bm, L=5, maxdeg=6)
    else:
        C = exact_gemm(tau.reshape(no * no, nv * nv), B_pre=consts.ovvv_ef, maxdeg=6)
    return C.reshape(no, no, ovvv.shape[0], ovvv.shape[1])


def _iteration_core(t1, t2, v: SpinSlices, D_ia, D_ijab, consts: HybridConsts | None = None,
                    *, paper_foo: bool, vvvv_split: bool = False, vvvv_shards=None):
    # vvvv_shards (a mesh solve, parallel/ccsd_shard): the tau.vvvv term,
    # on this iteration's route, from the operand split over the mesh
    # Sz-block-sparse evaluation (`bs`, ops/spin_einsum.py) wherever the
    # JAX package's f64 iteration uses it: forbidden spin blocks are
    # exact zeros, so skipping them is exact up to f64 reassociation.
    # Only even spin-orbital extents qualify (always true for the
    # closed-shell spin-orbital path).
    bs = spin_blocked_einsum if t1.shape[0] % 2 == 0 and t1.shape[1] % 2 == 0 else es
    # hybrid: the 4-index-output contractions run as one dense digit GEMM
    # each (`hs`, L=5/maxdeg=6, 15 pair products); with consts every
    # contraction whose ERI operand is a loop constant reads its
    # digitized form (`dig`), as in the JAX package (`:367-404`)
    hs = partial(exact_einsum, L=5, maxdeg=6) if vvvv_split else bs
    dig = vvvv_split and consts is not None
    dg = lambda spec, A, B, **pre: exact_einsum(spec, A, B, maxdeg=6, **pre)

    # -------- tau / tau~ (ccsd.f90:678-715) --------
    x = es("ia,jb->ijab", t1, t1)
    x = x - x.permute(0, 1, 3, 2)
    tau_tilde = t2 + 0.5 * x
    tau = t2 + x

    # -------- F intermediates (ccsd.f90:717-797) --------
    if dig:
        F_vv = dg("mf,mafe->ae", t1, v.ovvv, B_pre=consts.ovvv_mf_ae_dig, L=5) + 0.5 * dg(
            "mnaf,mnfe->ae", tau_tilde, v.oovv, B_pre=consts.oovv_mnf_e_dig)
        f_ne = dg("ne,nmie->mi", t1, v.ooov, B_pre=consts.ooov_ne_mi_dig)
    else:
        F_vv = bs("mf,mafe->ae", t1, v.ovvv) + 0.5 * bs("mnaf,mnfe->ae", tau_tilde, v.oovv)
        f_ne = bs("ne,nmie->mi", t1, v.ooov)
    # the (n,e,f,m) matricisation of the constant oovv side coincides for
    # the two forms, so one digitized operand serves both
    if paper_foo:
        # Stanton Eq. 5: 0.5 tau~[i,n,e,f] <mn||ef>
        spec = "inef,mnef->mi"
    else:
        # code-faithful tau~ contraction (ccsd.f90:792-795)
        spec = "mnef,inef->mi"
    if dig:
        foo_tau = dg(spec, tau_tilde, v.oovv, B_pre=consts.oovv_nef_m_dig)
    else:
        foo_tau = bs(spec, tau_tilde, v.oovv)
    F_oo = -f_ne + 0.5 * foo_tau
    F_ov = es("nf,mnef->me", t1, v.oovv)

    # -------- W intermediates (ccsd.f90:799-905) --------
    # W_mnij kept in natural [m,n,i,j] order (stored as [i,j,m,n] upstream)
    if dig:
        w1 = dg("mnie,je->mnij", v.ooov, t1, A_pre=consts.ooov_mni_e_dig)
        w_tau = dg("mnef,ijef->mnij", v.oovv, tau, A_pre=consts.oovv_mn_dig)
    else:
        w1 = es("mnie,je->mnij", v.ooov, t1)
        w_tau = hs("mnef,ijef->mnij", v.oovv, tau)
    W_oooo = v.oooo + w1 - w1.permute(0, 1, 3, 2) + 0.5 * w_tau
    # W_abef (Eq. 7) is not materialised: its contributions to the T2
    # equation are fused below, so no O(v^4) temporary beyond vvvv exists.
    # W_mbej (Eq. 8)
    Z = 0.5 * t2 + es("jf,nb->jnfb", t1, t1)  # [j,n,f,b]
    w4 = _w4_split(v.oovv, Z, consts) if vvvv_split else bs("mnef,jnfb->mbej", v.oovv, Z)
    if dig:
        w2 = dg("mbef,jf->mbej", v.ovvv, t1, A_pre=consts.ovvv_mbe_dig, L=5)
        w3 = dg("nb,nmej->mbej", t1, v.oovo, B_pre=consts.oovo_n_mej_dig)
    else:
        w2 = hs("mbef,jf->mbej", v.ovvv, t1)
        w3 = es("nb,nmej->mbej", t1, v.oovo)
    W_ovvo = v.ovvo + w2 + w3 - w4

    # -------- T1 (Eq. 1; ccsd.f90:933-965) --------
    if dig:
        t1_v = dg("mife,mafe->ia", t2, v.ovvv, B_pre=consts.ovvv_mfe_a_dig, L=5)
        t1_o = dg("mnea,mnei->ia", t2, v.oovo, B_pre=consts.oovo_mne_i_dig)
    else:
        t1_v = bs("mife,mafe->ia", t2, v.ovvv)
        t1_o = es("mnea,mnei->ia", t2, v.oovo)
    tmp_t1 = (
        es("ie,ae->ia", t1, F_vv)
        - es("mi,ma->ia", F_oo, t1)
        + es("me,maei->ia", t1, v.ovvo)
        + es("miea,me->ia", t2, F_ov)
        + 0.5 * t1_v
        - 0.5 * t1_o
    )
    t1_new = tmp_t1 / D_ia

    # -------- T2 (Eq. 2; ccsd.f90:967-1031) --------
    # three-operand terms are contracted pairwise in a fixed order, so
    # no o^3 v^3 intermediate can appear whatever einsum's path finder
    s = -es("imbj,ma->ijab", es("ie,mbej->imbj", t1, v.ovvo), t1) + hs(
        "miea,mbej->ijab", t2, W_ovvo
    )
    tmp_t2 = (
        v.oovv
        + s
        - s.permute(1, 0, 2, 3)
        - s.permute(0, 1, 3, 2)
        + s.permute(1, 0, 3, 2)
    )
    s = hs("ijae,be->ijab", t2, F_vv)
    tmp_t2 += s - s.permute(0, 1, 3, 2)
    s = es("ijae,be->ijab", t2, es("mb,me->be", t1, F_ov))
    tmp_t2 -= 0.5 * (s - s.permute(0, 1, 3, 2))
    s = es("im,mjab->ijab", es("ie,me->im", t1, F_ov), t2)
    tmp_t2 -= 0.5 * (s - s.permute(1, 0, 2, 3))
    if dig:
        s = dg("ie,ejab->ijab", t1, v.vovv, B_pre=consts.vovv_e_dig, L=5)
    else:
        s = hs("ie,ejab->ijab", t1, v.vovv)
    tmp_t2 += s - s.permute(1, 0, 2, 3)
    if dig:
        s = dg("ijbm,ma->ijab", v.oovo, t1, A_pre=consts.oovo_ijb_m_dig)
    else:
        s = es("ijbm,ma->ijab", v.oovo, t1)
    tmp_t2 += s - s.permute(0, 1, 3, 2)
    s = es("mi,mjab->ijab", F_oo, t2)
    tmp_t2 -= s - s.permute(1, 0, 2, 3)
    tmp_t2 += 0.5 * hs("mnij,mnab->ijab", W_oooo, tau)
    # 0.5 tau_ijef W_abef with W_abef = <ab||ef> + P_(ab) t1[m,b] <ma||ef>,
    # fused: the t1 part factors through G[i,j,m,a] = tau_ijef <ma||ef>
    if vvvv_shards is not None:
        tmp_t2 += vvvv_shards(tau)
    elif vvvv_split:
        tmp_t2 += tau_vvvv_split(tau, v.vvvv, consts, blocks=v.vvvv_blocks)
    else:
        tmp_t2 += tau_vvvv_blocked(tau, v.vvvv, blocks=v.vvvv_blocks)
    G = _g_split(tau, v.ovvv, consts) if vvvv_split else bs("ijef,maef->ijma", tau, v.ovvv)
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


ccsd_spinorb_solver = make_cc_solver(partial(_iteration_core, paper_foo=False),
                                     cc_energy_spinorb)
ccsd_spinorb_solver_paper = make_cc_solver(partial(_iteration_core, paper_foo=True),
                                           cc_energy_spinorb)
ccsd_spinorb_solver_hybrid = make_cc_solver(
    partial(_iteration_core, paper_foo=False, vvvv_split=True), cc_energy_spinorb,
    precompute=presplit_consts)
ccsd_spinorb_solver_paper_hybrid = make_cc_solver(
    partial(_iteration_core, paper_foo=True, vvvv_split=True), cc_energy_spinorb,
    precompute=presplit_consts)


def get_spinorb_solver(paper_foo: bool = False, vvvv_split: bool = False):
    """The whole-solve loop for an equations/precision combination (JAX
    `:646`)."""
    return {
        (False, False): ccsd_spinorb_solver,
        (True, False): ccsd_spinorb_solver_paper,
        (False, True): ccsd_spinorb_solver_hybrid,
        (True, True): ccsd_spinorb_solver_paper_hybrid,
    }[(paper_foo, vvvv_split)]


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
    mesh=None,
) -> CCSDSpinorbResult:
    """Spin-orbital CCSD on the dense MO tensor `eri_mo`; with `mesh`
    (`parallel.mesh.Mesh`, its first entry `device`) the tau.vvvv term is
    split over it (module docstring)."""
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

    # "pallas" and "fused" change only the triples tier; the CC solve
    # runs the hybrid digit-GEMM iteration for all three (JAX `:759`)
    vvvv_split = cfg.ccsd_precision in ("hybrid", "pallas", "fused")
    solver = get_spinorb_solver(paper_foo=cfg.ccsd_spinorb_equations == "paper",
                                vvvv_split=vvvv_split)

    rep.write(" Initialisation done, now entering iterative CC solver...")
    rep.cc_table_header()

    energy, r0_h, err = torch.stack([e0, r0, selfcheck_err]).tolist()
    trace.synced()
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
    args = (state, v, D_ia, D_ijab, v.oovv, energy, cfg.ccsd_e_tol, cfg.ccsd_t_tol)
    loop = dict(nerr=cfg.ccsd_diis_n_errmat, maxiter=cfg.ccsd_maxiter, on_iteration=rep.cc_row)
    if mesh is not None:
        from ..parallel.ccsd_shard import ccsd_solve_sharded

        state, energies, converged = ccsd_solve_sharded(mesh, solver, *args, **loop)
    else:
        state, energies, converged = solver(*args, **loop)
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
        trace.synced(2)
    return CCSDSpinorbResult(
        e_ccsd=energy,
        t1=t1_out,
        t2=t2_out,
        converged=converged,
        iterations=len(energies),
        slices=v,
        energies=energies,
        precision_used="hybrid" if vvvv_split else "f64",
    )
