"""Spin-free (spatial-orbital) CCSD — Piecuch et al., CPC 149 (2002) 71-96.

Port of `afesp_tpu/methods/ccsd_spatial.py` (`Slices`, `CCSDResult`,
`make_slices`, `denominators`, `_intermediates` and `_iteration_core`
with their f64 and digit-GEMM ("hybrid") routes, `SpatialHybridConsts`,
`_DIG_CONST_SPECS`/`_DIG_CONST_SPECS_B`/`_DIG_L`, `_build_digs`,
`spatial_presplit`, `get_spatial_solver`, `cc_energy_restricted`,
`spatial_cc_init` and `do_ccsd_spatial`), and its streaming-slices tier
(`spatial_presplit_ext`, `ccsd_spatial_solver_ext`,
`spatial_cc_init_slices`, `_cr_vvvv_term_from_B`).
The equations are the reference's debug twin routines
(update_restricted_intermediates_debug ccsd.f90:1314-1458,
update_amplitudes_restricted_debug 1460-1536, update_cc_energy
1734-1810), with the Fortran index orders kept (I_vovv_p[c,i,a,b],
I_voov[b,j,i,a], ...) so each line can be checked term by term against
the reference.

`ccsd_precision` "f64" (the default) runs every contraction as an f64
`torch.einsum`.  "hybrid", "pallas" and "fused" run the JAX package's
hybrid iteration (its rule, JAX `:618-623`): every contraction with a
slice-sized operand is an exact digit GEMM (`ops/exact_gemm`), the
loop-constant slice sides digitized once per solve (`spatial_presplit`,
through the solver's precompute hook); `precision_used` says which ran.

Which MO integral forms the solve reads, and which it drops after, are
the memory tier's (`methods/tiers.py`).

Under a device mesh (`mesh`, JAX `:634-662,745-767`) the vvvv term of
every route is split over the mesh (`parallel/ccsd_shard`): the dense
and digit products along the output's a on the sub-mesh that fits
nvirt, the stream tier's limbs along their K chunks over the whole
mesh, which its CR term then reads too; the rest of the solve runs on
the first device, with the same one readback an iteration.

DIIS follows ccsd.f90:38-67 through the port's `ops/cc_step`; the state
keeps the amplitudes that fed the final iteration (`t1_prev`/`t2_prev`),
which the CR-CC intermediates consume (ccsd.f90:2364-2377).
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
from ..ops.cc_step import init_cc_state, make_cc_solver, make_cc_solver_pre
from ..ops.exact_gemm import exact_einsum, gemm_B_pre_streamed, prechunk_op
from ..ops.split_gemm import split_einsum
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
    v_vvvv: torch.Tensor | None  # (v,v,v,v); None on the sliced tiers after CCSD


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
    # the CCSD arithmetic that ran: "f64", or "hybrid" (the digit GEMMs)
    precision_used: str = "f64"
    # sliced tiers only: the CR chain's one v_vvvv contraction
    # es("ecba,ie->ciab", v_vvvv, t1) (ccsd.f90:2513), made by the memory
    # tier when the solve ends (`methods/tiers.py`)
    cr_vvvv_term: torch.Tensor | None = None


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


def _routes(digs: dict | None):
    """The contraction routes (ce, cb, xe) of the hybrid iteration: a
    digit GEMM against the A-side / B-side digitized constant of the
    spec, and one with both operands digitized in the loop (L=6).
    Without `digs`, all three are the f64 einsum."""
    if digs is None:
        return es, es, es
    return (
        lambda spec, A, B: exact_einsum(spec, A, B, A_pre=digs[spec], maxdeg=7),
        lambda spec, A, B: exact_einsum(spec, A, B, B_pre=digs[spec], maxdeg=7),
        lambda spec, A, B: exact_einsum(spec, A, B, L=6, maxdeg=7),
    )


def _intermediates(t1, t2, v: Slices, digs: dict | None = None) -> dict:
    """Piecuch Table-1 intermediates (debug twin, ccsd.f90:1334-1454).

    With `digs` (the prechunk_op dict of the hybrid solve) every
    contraction with a slice-sized operand runs as a digit GEMM, as in
    the JAX package: prechunked on the A side (`ce`) or the B side
    (`cb`) for the constant slices, digitized in the loop (`xe`) where
    both operands change every iteration."""
    ce, cb, xe = _routes(digs)
    asym_t2 = 2.0 * t2 - t2.permute(1, 0, 2, 3)
    c_oovv = t2 + es("ia,jb->ijab", t1, t1)

    # I_ai = (2 v_oovv[m,i,e,a] - v_oovv[m,i,a,e]) t1[m,e]        (ccsd.f90:1336)
    I_vo = 2.0 * ce("miea,me->ai", v.v_oovv, t1) - ce("miae,me->ai", v.v_oovv, t1)

    # the two t1-dressings of v_vvov, shared by I_vv / I_ovov / I_voov / I_ooov'
    #   x_voov[b,j,i,a]    = v_vvov[b,e,i,a] t1[j,e]   (ccsd.f90:1413/1426)
    #   x_ovov_t1[j,b,i,a] = v_vvov[e,b,i,a] t1[j,e]   (ccsd.f90:1401)
    x_voov = cb("je,beia->bjia", t1, v.v_vvov)
    x_ovov_t1 = cb("je,ebia->jbia", t1, v.v_vvov)

    # I_ba (ccsd.f90:1352-1353); the two v_vvov GEMVs are diagonal traces
    # of the dressings above
    I_vv = (
        2.0 * es("mbma->ba", x_ovov_t1)
        - es("bmma->ba", x_voov)
        - 2.0 * ce("mneb,mnea->ba", v.v_oovv, c_oovv)
        + ce("mnbe,mnea->ba", v.v_oovv, c_oovv)
    )

    # I_ji' (ccsd.f90:1359)
    I_oo_p = (
        2.0 * ce("miej,me->ji", v.v_oovo, t1)
        - ce("imej,me->ji", v.v_oovo, t1)
        + ce("mief,mjef->ji", v.v_oovv, asym_t2)
    )

    # I_ji = I_ji' + I_ei t1[j,e] (ccsd.f90:1365)
    I_oo = I_oo_p + es("ei,je->ji", I_vo, t1)

    # I_klij (ccsd.f90:1375-1376)
    I_oooo = (
        v.v_oooo
        + ce("ijef,klef->klij", v.v_oovv, c_oovv)
        + ce("ijel,ke->klij", v.v_oovo, t1)
        + ce("jiek,le->klij", v.v_oovo, t1)
    )

    # I_jbia (ccsd.f90:1400-1401)
    I_ovov = (
        v.v_ovov
        - 0.5 * ce("imeb,jmea->jbia", v.v_oovv, c_oovv)
        - ce("mibj,ma->jbia", v.v_oovo, t1)
        + x_ovov_t1
    )

    # I_bjia (ccsd.f90:1413-1414; x_voov also ccsd.f90:1426)
    I_voov = (
        v.v_oovv.permute(2, 1, 0, 3)  # v_oovv[i,j,b,a] -> [b,j,i,a]
        + ce("imbe,mjea->bjia", v.v_oovv, t2)
        - 0.5 * ce("imeb,mjea->bjia", v.v_oovv, t2)
        - 0.5 * ce("mieb,mjae->bjia", v.v_oovv, c_oovv)
        + x_voov
        - ce("imbj,ma->bjia", v.v_oovo, t1)
    )

    # I_jkia' (ccsd.f90:1438)
    I_ooov_p = (
        v.v_oovo.permute(1, 0, 3, 2)  # v_oovo[k,j,a,i] -> [j,k,i,a]
        + ce("efia,jkef->jkia", v.v_vvov, t2)
        + xe("je,ekia->jkia", t1, x_voov)
    )

    return dict(
        asym_t2=asym_t2, c_oovv=c_oovv, I_vo=I_vo, I_vv=I_vv, I_oo_p=I_oo_p,
        I_oo=I_oo, I_oooo=I_oooo, I_ovov=I_ovov, I_voov=I_voov,
        x_voov=x_voov, I_ooov_p=I_ooov_p,
    )


@dataclasses.dataclass
class SpatialHybridConsts:
    """Loop-constant operand preparations of the hybrid iteration, built
    once per solve (the solver's precompute hook): the digitized forms
    (ops/exact_gemm.prechunk_op) of every constant-slice side of the
    digit-GEMM contractions, keyed by spec, and on the streaming tier
    v_vvvv as the transform's per-chunk-scaled limbs (`vvvv_B`, from
    prechunk_B_chunkscaled of the (ef, ab) matricisation)."""

    digs: dict  # spec -> prechunk_op output
    vvvv_B: tuple | None = None


# Contractions of the hybrid iteration whose FIRST operand is a
# loop-constant ERI slice, evaluated as digit GEMMs against its
# digitized form (JAX `:263-306`).
_DIG_CONST_SPECS = (
    ("mneb,mnea->ba", "v_oovv"),
    ("mnbe,mnea->ba", "v_oovv"),
    ("mief,mjef->ji", "v_oovv"),
    ("ijef,klef->klij", "v_oovv"),
    ("imeb,jmea->jbia", "v_oovv"),
    ("imbe,mjea->bjia", "v_oovv"),
    ("imeb,mjea->bjia", "v_oovv"),
    ("mieb,mjae->bjia", "v_oovv"),
    ("efia,jkef->jkia", "v_vvov"),
    ("efma,mief->ia", "v_vvov"),
    ("mnei,mnea->ia", "v_oovo"),
    ("mnei,mnae->ia", "v_oovo"),
    # the t1-weighted slice GEMVs
    ("miea,me->ai", "v_oovv"),
    ("miae,me->ai", "v_oovv"),
    ("miej,me->ji", "v_oovo"),
    ("imej,me->ji", "v_oovo"),
    ("ijel,ke->klij", "v_oovo"),
    ("jiek,le->klij", "v_oovo"),
    ("mibj,ma->jbia", "v_oovo"),
    ("imbj,ma->bjia", "v_oovo"),
    ("miea,me->ia", "v_oovv"),
    ("maie,me->ia", "v_ovov"),
    # the dominant O(o^2 v^4) contraction
    ("efab,ijef->ijab", "v_vvvv"),
)

# Contractions whose constant slice is the SECOND operand, digitized on
# the B side (JAX `:308-314`): the v_vvov t1-dressings and the
# reassociated t1*I_vovv' pieces.
_DIG_CONST_SPECS_B = (
    ("je,beia->bjia", "v_vvov"),
    ("je,ebia->jbia", "v_vvov"),
    ("ie,baje->ijab", "v_vvov"),
    ("ie,maje->imaj", "v_ovov"),
    ("ie,mjeb->imjb", "v_oovv"),
)

# Digit depth per prechunked constant (JAX `:317-339`): L=6/maxdeg=7
# (21 digit-pair GEMMs) by default; the three O(v^3 o) v_vvov
# matricisations of the B side and "efia,jkef" hold L=5, "efma,mief"
# L=4 (each feeds t1- or t2-weighted correction terms of scale ~1e-2).
_DIG_L = {
    "je,beia->bjia": 5,
    "je,ebia->jbia": 5,
    "ie,baje->ijab": 5,
    "efia,jkef->jkia": 5,
    "efma,mief->ia": 4,
}


def _build_digs(v: Slices, skip_vvvv: bool = False) -> dict:
    digs = {
        spec: prechunk_op(spec, "A", getattr(v, name), L=_DIG_L.get(spec, 6))
        for spec, name in _DIG_CONST_SPECS
        if not (skip_vvvv and name == "v_vvvv")
    }
    digs.update({
        spec: prechunk_op(spec, "B", getattr(v, name), L=_DIG_L.get(spec, 6))
        for spec, name in _DIG_CONST_SPECS_B
    })
    return digs


def spatial_presplit(v: Slices, kc: int = 64) -> SpatialHybridConsts:
    # no v_vvvv: a mesh solve holds it split (parallel/ccsd_shard)
    return SpatialHybridConsts(digs=_build_digs(v, skip_vvvv=v.v_vvvv is None))


def spatial_presplit_ext(v: Slices, vvvv_B) -> SpatialHybridConsts:
    """The streaming tier's consts: v.v_vvvv is None and its digit form
    arrives prebuilt from the transform; every other slice is digitized
    here as usual."""
    return SpatialHybridConsts(digs=_build_digs(v, skip_vvvv=True), vvvv_B=vvvv_B)


def _iteration_core(t1, t2, v: Slices, D_ia, D_ijab, consts: SpatialHybridConsts | None = None,
                    *, vvvv_split: bool = False, vvvv_shards=None):
    """One T1/T2 update, Piecuch Eqs. 43-44 (debug twin ccsd.f90:1487-1530).

    vvvv_split (ccsd_precision "hybrid"/"pallas"/"fused") with consts
    runs every slice contraction as a digit GEMM; without consts the
    dominant c_oovv * v_vvvv contraction alone takes the split-f32
    route (split_einsum), as in the JAX package.  vvvv_shards (a mesh
    solve, `parallel/ccsd_shard`) computes that contraction, on its
    route, from the operand split over the mesh."""
    digs = consts.digs if vvvv_split and consts is not None else None
    ce, cb, xe = _routes(digs)
    im = _intermediates(t1, t2, v, digs)
    asym_t2 = im["asym_t2"]
    c_oovv = im["c_oovv"]

    # ---------------- T1 (Eq. 43; ccsd.f90:1487-1495) ----------------
    tmp_t1 = (
        es("ea,ie->ia", im["I_vv"], t1)
        - es("im,ma->ia", im["I_oo_p"], t1)
        + xe("em,miea->ia", im["I_vo"], asym_t2)
        + 2.0 * ce("miea,me->ia", v.v_oovv, t1)
        - ce("maie,me->ia", v.v_ovov, t1)
        - 2.0 * ce("mnei,mnea->ia", v.v_oovo, t2)
        + ce("mnei,mnae->ia", v.v_oovo, t2)
        + ce("efma,mief->ia", v.v_vvov, asym_t2)
    )

    # ---------------- T2 (Eq. 44; ccsd.f90:1497-1526) ----------------
    if vvvv_shards is not None:
        vvvv_term = 0.5 * vvvv_shards(c_oovv)
    elif vvvv_split and consts is None:
        vvvv_term = 0.5 * split_einsum("efab,ijef->ijab", v.v_vvvv, c_oovv)
    elif consts is not None and consts.vvvv_B is not None:
        # streaming tier: v_vvvv exists only as the transform's limbs
        nv = t2.shape[-1]
        vvvv_term = 0.5 * exact_einsum(
            "ijef,efab->ijab", c_oovv, None, L=6, maxdeg=7,
            B_pre=consts.vvvv_B, B_shape=(nv, nv, nv, nv),
        )
    else:
        vvvv_term = 0.5 * ce("efab,ijef->ijab", v.v_vvvv, c_oovv)
    # t1 * I_vovv' (Eq. 44 term 5), reassociated through the t1
    # contraction so the (v,o,v,v) intermediate never exists:
    #   sum_e t1[i,e] I_vovv'[e,j,a,b]
    #     = sum_e t1[i,e] v_vvov[b,a,j,e]
    #     - sum_m U[i,m,a,j] t1[m,b],  U = v_ovov[m,a,j,e] t1[i,e]
    #     - sum_m W[i,m,j,b] t1[m,a],  W = v_oovv[m,j,e,b] t1[i,e]
    U = cb("ie,maje->imaj", t1, v.v_ovov)
    W = cb("ie,mjeb->imjb", t1, v.v_oovv)
    t1_Ivovv = (
        cb("ie,baje->ijab", t1, v.v_vvov)
        - es("imaj,mb->ijab", U, t1)
        - es("imjb,ma->ijab", W, t1)
    )
    X = (
        xe("ijae,eb->ijab", t2, im["I_vv"])
        - xe("imab,jm->ijab", t2, im["I_oo"])
        + vvvv_term
        + 0.5 * xe("mnab,ijmn->ijab", c_oovv, im["I_oooo"])
        + t1_Ivovv
        - xe("ma,ijmb->ijab", t1, im["I_ooov_p"])
        - xe("mjae,iemb->ijab", t2, im["I_ovov"])
        - xe("iema,mjeb->ijab", im["I_ovov"], t2)
        + xe("miea,ejmb->ijab", asym_t2, im["I_voov"])
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


ccsd_spatial_solver = make_cc_solver(partial(_iteration_core, vvvv_split=False),
                                     cc_energy_restricted)
ccsd_spatial_solver_hybrid = make_cc_solver(partial(_iteration_core, vvvv_split=True),
                                            cc_energy_restricted, precompute=spatial_presplit)


# streaming tier: v_vvvv arrives as prebuilt digit limbs (the solve's `pre`)
ccsd_spatial_solver_ext = make_cc_solver_pre(partial(_iteration_core, vvvv_split=True),
                                             cc_energy_restricted,
                                             precompute=spatial_presplit_ext)


def get_spatial_solver(vvvv_split: bool = False):
    """The whole-solve loop for a precision mode (JAX `:496`)."""
    return ccsd_spatial_solver_hybrid if vvvv_split else ccsd_spatial_solver


def spatial_cc_init_slices(v: Slices, levels: torch.Tensor, nocc: int):
    """Denominators, the MP1 guess and its energy from built slices (the
    streaming transform's, where no dense MO tensor exists)."""
    D_ia, D_ijab = denominators(levels, nocc)
    t1 = torch.zeros_like(D_ia)
    t2 = v.v_oovv / D_ijab  # MP1 (ccsd.f90:521)
    e0, r0 = cc_energy_restricted(t1, t2, torch.zeros_like(t2), v.v_oovv)
    return D_ia, D_ijab, t1, t2, e0, r0


def spatial_cc_init(eri_mo: torch.Tensor, levels: torch.Tensor, nocc: int):
    """Slices, denominators, the MP1 guess and its energy."""
    v = make_slices(eri_mo, nocc)
    return (v, *spatial_cc_init_slices(v, levels, nocc))


def _cr_vvvv_term_from_B(t1: torch.Tensor, vvvv_B, *, nv: int) -> torch.Tensor:
    """es("ecba,ie->ciab", v_vvvv, t1) from the digit limbs of v_vvvv,
    whose matricisation has rows (e, c) and columns (b, a) in this
    term's index roles.  The contraction over e alone is recast as one
    (o*v, v^2) x (v^2, v^2) digit GEMM with the Kronecker left operand
    A[(i,c), (e,c')] = t1[i,e] delta_cc' (exact per digit plane: t1 is
    digitized from f64), streamed over the limbs' K chunks
    (`gemm_B_pre_streamed`, maxdeg=6); limbs split over a mesh
    (`parallel/ccsd_shard.LimbShards`) take each entry's digit GEMM over
    its chunks (JAX's `streamed=False` there), the partials added on t1's
    device.  Returns (c, i, a, b) f64."""
    from ..parallel.ccsd_shard import LimbShards

    o = t1.shape[0]
    eye = torch.eye(nv, dtype=t1.dtype, device=t1.device)
    A = (t1[:, None, :, None] * eye[None, :, None, :]).reshape(o * nv, nv * nv)
    if isinstance(vvvv_B, LimbShards):
        out = vvvv_B.gemm(A, maxdeg=6)
    else:
        out = gemm_B_pre_streamed(A, vvvv_B, maxdeg=6)
    return out.reshape(o, nv, nv, nv).permute(1, 0, 3, 2)


def do_ccsd_spatial(
    sys_: dat.System,
    eri_mo: torch.Tensor | None,
    cfg: Config,
    hf: HFResult,
    rep: Reporter | None = None,
    workdir: str | Path = ".",
    device: str | torch.device | None = None,
    slices: Slices | None = None,
    vvvv_B=None,
    mesh=None,
    tier=None,
) -> CCSDResult:
    """Restricted CCSD (do_ccsd_spatial, ccsd.f90:279-402) on MP2's MO
    integrals as the memory `tier` reads them (`methods/tiers.py`); with
    `mesh` (`parallel.mesh.Mesh`, its first entry `device`) the vvvv
    term is split over it."""
    dev = default_device(device)
    rep = rep or Reporter()
    rep.section("CCSD")
    t_stage = time.perf_counter()
    rep.write(" Initialise CC intermediate tensors and DIIS auxilliary arrays...")
    rep.write(" Forming energy denominator matrices...")
    rep.write(" Allocating amplitude tensors...")
    rep.write(" Forming ERI slices...")

    nocc = sys_.nocc
    levels = torch.as_tensor(hf.levels, dtype=F64, device=dev)
    from .tiers import calc_tier

    tier = tier or calc_tier(sys_.nbasis, cfg, dev)
    v, D_ia, D_ijab, t1, t2, e0, r0 = tier.cc_init(eri_mo, slices, vvvv_B, cfg, levels, nocc)

    rep.write(" Forming initial amplitude guesses...")
    amp_in = Path(workdir) / "amplitudes_in.npz"
    if cfg.ccsd_read_amplitudes and amp_in.exists():
        rep.write(" Reading previous CC amplitudes as guess...")
        t1_np, t2_np = dat.read_amplitudes(amp_in)
        t1 = torch.as_tensor(t1_np, dtype=F64, device=dev)
        t2 = torch.as_tensor(t2_np, dtype=F64, device=dev)
        e0, r0 = cc_energy_restricted(t1, t2, torch.zeros_like(t2), v.v_oovv)
    rep.write(" Allocating stored intermediate tensors...")

    # "pallas" and "fused" change only the triples tier; the CC solve
    # runs the hybrid digit-GEMM iteration for all three (JAX `:618-623`)
    vvvv_split = cfg.ccsd_precision in ("hybrid", "pallas", "fused")

    rep.write(f" Time taken: {time.perf_counter() - t_stage:8.6f} s")
    rep.write("")
    rep.write(" Initialisation done, now entering iterative CC solver...")
    rep.cc_table_header()

    energy, r0_h = torch.stack([e0, r0]).tolist()
    trace.synced()
    rep.cc_row("MP1", energy, energy, r0_h)
    state = init_cc_state(t1, t2, cfg.ccsd_diis_n_errmat)
    args = (state, v, D_ia, D_ijab, v.v_oovv, energy, cfg.ccsd_e_tol, cfg.ccsd_t_tol)
    loop = dict(nerr=cfg.ccsd_diis_n_errmat, maxiter=cfg.ccsd_maxiter, on_iteration=rep.cc_row)
    state, energies, converged, vvvv_B = tier.cc_solve(args, loop, vvvv_B, mesh, vvvv_split)
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
        trace.synced(2)

    t1_diag = 0.0
    if converged:
        # T1 diagnostic (ccsd.f90:369-376)
        t1_diag = (float(torch.sum(t1_out * t1_out)) / sys_.nel) ** 0.5
        trace.synced()
        rep.write(f" T1 diagnostic: {t1_diag:8.5f}")
        if t1_diag > 0.02:
            rep.write(
                " Significant multireference character detected,"
                " CCSD result might be unreliable!"
            )

    cr_term = tier.cr_term(t1_out, v, vvvv_B, cfg)

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
        precision_used="hybrid" if vvvv_split else "f64",
        cr_vvvv_term=cr_term,
    )
