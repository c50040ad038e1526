"""Spatial perturbative-triples family: CCSD[T], CCSD(T), R-CCSD[T]/(T),
CR-CCSD[T]/(T) — Piecuch et al., CPC 149 (2002) 71-96.

Port of `afesp_tpu/methods/triples_spatial.py` (`TriplesResult`, `_xbar`,
`cr_intermediates` at f64 and f32, `_islice_terms`, `strict_spatial_plan`,
`_triples_total_spatial`, `pick_spatial_jlen`, `do_ccsd_t_spatial` with
its mesh branch `:546-551,673-683`).
Re-implements do_ccsd_t_spatial (ccsd.f90:2018-2293) and
build_cr_ccsd_t_intermediates (ccsd.f90:2338-2551), with the reference's
quirks reproduced deliberately: the I_ooov'' virtual sum cut at nocc
(ccsd.f90:2535), the stale I_vo/asym_t2 from the amplitudes that fed the
final CCSD iteration, and `ccsd_t_spatial_bug_compat` (plain
CCSD(T)_spatial printing CCSD[T], ccsd.f90:2211-2215).

Five tiers:

  "fused"  — K3, `ops/triples_spatial_cuda.triples_fused_spatial`: the
             24 numerator GEMMs and the M-operator sums over sorted
             i<=j<=k triples in hand-written CUDA, f64;
  "tiled"  — K4, `triples_tiled_spatial`: the numerator cubes as batched
             torch matmuls per chunk, the M-operator sums in CUDA, f64;
  "pallas" — the (i, j-slab) panels as f64 torch einsums, then K5,
             `triples_finale_spatial` (JAX's panels here are f32; the
             port's K5 is an f64 kernel, so its panels stay f64);
  "hybrid" — JAX's f32 slab tier: the 24 panel GEMMs and z3/y with f32
             operands (cast once, outside the slab loop), the
             denominators and every reduction in f64 (`_islice_terms`);
  "f64"    — plain torch throughout (`_islice_terms`).

With `precision=None` the tier follows `cfg.ccsd_precision`, as in the
JAX driver (`:530-549`): "pallas" and "fused" name their tiers; for
"f64" and "hybrid" (`default_precision`) a CUDA device runs "fused" when
nvirt <= 128 and "tiled" above (the JAX package's TPU choice by size,
which upgrades "hybrid" to its kernels; the port's kernels have no 128
cap), and the CPU runs the request itself, "f64" or "hybrid", as JAX off
a TPU.  A kernel that fails raises: the JAX package's VMEM-degrade memo
is not carried over.

The CR intermediates follow JAX's normalisation (`:565-578`): the whole
chain runs in f32 unless the request is "f64".  The request is
`precision` when it names an arithmetic ("f64", "hybrid") and
`cfg.ccsd_precision` otherwise: the port's kernel tiers are f64, so
naming one asks for no f32.  So the committed inputs, at
`ccsd_precision = "hybrid"`, run the f32 chain into K3 or K4 on a card.
The f32 I'' enter the f64 tiers cast back to f64 (exactly).

Under a device mesh (`mesh`) each entry runs the tier one device would
run on its contiguous share of that tier's work list
(`parallel/triples_shard.triples_spatial_sharded`): the sorted triples
with their orbit weights (K3, K4) or the (i, j-slab) grid ("pallas",
K5; "hybrid"; "f64"), the six sums added on the first entry.  JAX swaps
"fused" and "tiled" for its slab tiers under a mesh (JAX
`:549-551,681-682`), a limit of Pallas under shard_map, not of the
physics; the port keeps its one-device tier choice, and
`precision_used` names the tier that ran.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import trace
from ..config import Config
from ..io import dat
from ..io.report import Reporter
from ..ops.triples_spatial_cuda import (
    triples_finale_spatial,
    triples_fused_spatial,
    triples_tiled_spatial,
)
from .ccsd_spatial import CCSDResult, Slices

es = torch.einsum
PRECISIONS = ("f64", "hybrid", "pallas", "fused", "tiled")
_SUM_KEYS = ("e_T", "e_TT", "D_T", "D_TT", "e_CR", "e_CRT")


@dataclasses.dataclass
class TriplesResult:
    e_ccsd_t: float = 0.0  # CCSD[T] correlation (e_ccsd + e_T)
    e_ccsd_tt: float = 0.0  # CCSD(T)
    e_rccsd_t: float = 0.0
    e_rccsd_tt: float = 0.0
    e_crccsd_t: float = 0.0
    e_crccsd_tt: float = 0.0
    D_T: float = 0.0
    D_TT: float = 0.0
    e_highest: float = 0.0
    calcname: str = "CCSD"
    precision_used: str = ""  # the tier that ran
    cr_precision: str = ""  # the CR intermediates' arithmetic, "f64" or "f32"


def _xbar(x: torch.Tensor) -> torch.Tensor:
    """x_bar[...,a,b,c] = 4/3 x[abc] - 2 x[acb] + 2/3 x[bca]
    (make_x_bar, ccsd.f90:2313-2318; acts on the last three axes)."""
    n = x.ndim
    lead = tuple(range(n - 3))
    acb = x.permute(*lead, n - 3, n - 1, n - 2)
    bca = x.permute(*lead, n - 1, n - 3, n - 2)
    return 4.0 / 3.0 * x - 2.0 * acb + 2.0 / 3.0 * bca


def cr_intermediates(t1, t2, t1_prev, t2_prev, v: Slices, nocc: int, precision: str = "f64",
                     vvvv_term=None):
    """I_vovv'' and I_ooov'' (build_cr_ccsd_t_intermediates,
    ccsd.f90:2338-2551), with stale I_vo/asym_t2 from (t1_prev, t2_prev).

    precision "f64" runs the chain in f64; any other value runs the whole
    chain in f32 (JAX `:100-108`), the two results f32.

    vvvv_term: the chain's one v_vvvv contraction es("ecba,ie->ciab",
    v_vvvv, t1) (ccsd.f90:2513), computed on the streaming tier from the
    digit limbs (`ccsd_spatial._cr_vvvv_term_from_B`); with it v.v_vvvv
    may be None."""
    if precision != "f64":
        t1, t2, t1_prev, t2_prev = (x.float() for x in (t1, t2, t1_prev, t2_prev))
        f32 = lambda x: None if x is None else x.float()
        # v_vvvv is read only without vvvv_term: no f32 copy of it then
        v = Slices(f32(v.v_oovv), f32(v.v_ovov), f32(v.v_vvov), f32(v.v_oovo),
                   f32(v.v_oooo), f32(v.v_vvvv) if vvvv_term is None else None)
        vvvv_term = f32(vvvv_term)
    # stale quantities (module docstring)
    asym_t2 = 2.0 * t2_prev - t2_prev.permute(1, 0, 2, 3)
    I_vo = 2.0 * es("miea,me->ai", v.v_oovv, t1_prev) - es("miae,me->ai", v.v_oovv, t1_prev)

    # x helpers (ccsd.f90:2390-2403 definitions, 2424-2506 loops)
    x_vvvo_p = v.v_vvov.permute(1, 0, 3, 2) - 0.5 * es("ma,mibc->bcai", t1, v.v_oovv)
    x_ovov_p = (
        v.v_ovov
        - 0.5 * es("mibj,ma->jbia", v.v_oovo, t1)
        + es("je,beai->jbia", t1, x_vvvo_p)
    )
    x_voov_p = (
        v.v_oovv.permute(2, 1, 0, 3)
        - 0.5 * es("imbj,ma->bjia", v.v_oovo, t1)
        + es("ebai,je->bjia", x_vvvo_p, t1)
    )
    x_vvvo = x_vvvo_p - 0.5 * es("ma,mibc->bcai", t1, v.v_oovv)
    x_ovoo = v.v_oovo.permute(3, 2, 1, 0) + es("ke,ijea->kaij", t1, v.v_oovv)
    x_ovov_pp = (
        v.v_ovov
        - es("mibj,ma->jbia", v.v_oovo, t1)
        + 0.5 * es("je,beai->jbia", t1, x_vvvo)
    )
    x_voov_pp = (
        v.v_oovv.permute(2, 1, 0, 3)
        - es("imbj,ma->bjia", v.v_oovo, t1)
        + 0.5 * es("ebai,je->bjia", x_vvvo, t1)
    )

    # I_vovv'' (ccsd.f90:2513-2520)
    if vvvv_term is None:
        vvvv_term = es("ecba,ie->ciab", v.v_vvvv, t1)
    I_vovv_pp = (
        v.v_vvov.permute(3, 2, 1, 0)
        + vvvv_term
        - es("icma,mb->ciab", x_ovov_p, t1)
        - es("ma,cimb->ciab", t1, x_voov_p)
        - es("cm,miab->ciab", I_vo, t2)
        + es("mnba,icmn->ciab", t2, x_ovoo)
        + es("ceam,imbe->ciab", x_vvvo, asym_t2)
        - es("ecam,mieb->ciab", x_vvvo, t2)
        - es("miae,ecbm->ciab", t2, x_vvvo)
    )

    # I_ooov'' (ccsd.f90:2532-2537).  The reference's bug reproduced: the
    # virtual index e of the last three terms runs only over the first
    # nocc virtuals (ccsd.f90:2535 `do e = 1, nocc`).
    ec = slice(None, nocc)
    I_ooov_pp = (
        v.v_oovo.permute(1, 0, 3, 2)
        - es("mikj,ma->jkia", v.v_oooo, t1)
        + es("jeia,ke->jkia", x_ovov_pp, t1)
        + es("je,ekia->jkia", t1, x_voov_pp)
        + es("kjef,efai->jkia", t2, x_vvvo)
        + es("jeim,mkea->jkia", x_ovoo[:, ec], asym_t2[:, :, ec])
        - es("jemi,mkea->jkia", x_ovoo[:, ec], t2[:, :, ec])
        - es("mjae,kemi->jkia", t2[:, :, :, ec], x_ovoo[:, ec])
    )
    return I_vovv_pp.contiguous(), I_ooov_pp.contiguous()


def _slab_numerators(i0: int, j0: int, t1, t2, v_vvov, v_oovo, I_vovv_pp, I_ooov_pp, *,
                     jlen: int, with_m3: bool):
    """t3_D and (with_m3) m3 of the (i = i0, j in [j0, j0+jlen), all k)
    slab, (jlen, o, v, v, v) each: the twelve joint-permutation terms of
    ccsd.f90:2168-2173 and of the M3 moment (Piecuch Eq. 62;
    ccsd.f90:2188-2193)."""
    dj = lambda x, ax: x.narrow(ax, j0, jlen)
    t2_i = t2[i0]  # t2[i0,.,:,:]  (o,v,v)
    t2_ci = t2[:, i0]  # t2[.,i0,:,:]  (o,v,v)
    Vv, Vo = v_vvov, v_oovo
    Vv_i3 = Vv[:, :, i0]  # Vv[a,b,i0,f]  (v,v,v)
    Vo_i0 = Vo[i0]  # Vo[i0,j,a,m]  (o,v,o)
    Vo_i1 = Vo[:, i0]  # Vo[k,i0,c,m]  (o,v,o)
    t3_D = (
        es("jaf,cbkf->jkabc", dj(t2_i, 0), Vv)
        - es("mba,kjcm->jkabc", t2_ci, dj(Vo, 1))
        + es("jbf,cakf->jkabc", dj(t2_ci, 0), Vv)
        - es("mjab,kcm->jkabc", dj(t2, 1), Vo_i1)
        + es("kjcf,abf->jkabc", dj(t2, 1), Vv_i3)
        - es("mkbc,jam->jkabc", t2, dj(Vo_i0, 0))
        + es("kaf,bcjf->jkabc", t2_i, dj(Vv, 2))
        - es("mca,jkbm->jkabc", t2_ci, dj(Vo, 0))
        + es("jkbf,acf->jkabc", dj(t2, 0), Vv_i3)
        - es("mjcb,kam->jkabc", dj(t2, 1), Vo_i0)
        + es("kcf,bajf->jkabc", t2_ci, dj(Vv, 2))
        - es("mkac,jbm->jkabc", t2, dj(Vo_i1, 0))
    )
    if not with_m3:
        return t3_D, None
    Iv, Jo = I_vovv_pp, I_ooov_pp
    Iv_i1 = Iv[:, i0]  # Iv[e,i0,b,a]  (v,v,v)
    Jo_i0 = Jo[i0]  # Jo[i0,k,m,c]  (o,o,v)
    Jo_i1 = Jo[:, i0]  # Jo[j,i0,m,a]  (o,o,v)
    m3 = (
        es("jae,ekbc->jkabc", dj(t2_i, 0), Iv)
        - es("mba,jkmc->jkabc", t2_ci, dj(Jo, 0))
        + es("jbe,ekac->jkabc", dj(t2_ci, 0), Iv)
        - es("mjab,kmc->jkabc", dj(t2, 1), Jo_i0)
        + es("kjce,eba->jkabc", dj(t2, 1), Iv_i1)
        - es("mkbc,jma->jkabc", t2, dj(Jo_i1, 0))
        + es("kae,ejcb->jkabc", t2_i, dj(Iv, 1))
        - es("mca,kjmb->jkabc", t2_ci, dj(Jo, 1))
        + es("jkbe,eca->jkabc", dj(t2, 0), Iv_i1)
        - es("mjcb,kma->jkabc", dj(t2, 1), Jo_i1)
        + es("kce,ejab->jkabc", t2_ci, dj(Iv, 1))
        - es("mkac,jmb->jkabc", t2, dj(Jo_i0, 0))
    )
    return t3_D, m3


def finale_panels(i0: int, j0: int, t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv_pp,
                  I_ooov_pp, *, jlen: int, doing_CR: bool) -> tuple:
    """The arguments of K5 (`triples_finale_spatial`) for one slab: the
    (jlen*o, v, v, v) t3_D and m3 (None without CR) panels, the (v,v)
    factor panels of z3 and y, [t1[j], t1[k]], e_i+e_j+e_k, t1[i], e_v."""
    t3_D, m3 = _slab_numerators(i0, j0, t1, t2, v_vvov, v_oovo, I_vovv_pp, I_ooov_pp,
                                jlen=jlen, with_m3=doing_CR)
    dj = lambda x, ax: x.narrow(ax, j0, jlen)
    o, nv = t2.shape[0], t2.shape[-1]
    t2_i, voovv_i = t2[i0], v_oovv[i0]
    bcast = lambda x: x.expand(jlen, o, nv, nv)
    mats = torch.stack(
        [
            dj(v_oovv, 0),  # v_oovv[j,k]  [b,c]
            bcast(voovv_i[None]),  # v_oovv[i,k]  [a,c]
            bcast(dj(voovv_i, 0)[:, None]),  # v_oovv[i,j]  [a,b]
            dj(t2, 0),  # t2[j,k]  [b,c]
            bcast(t2_i[None]),  # t2[i,k]  [a,c]
            bcast(dj(t2_i, 0)[:, None]),  # t2[i,j]  [a,b]
        ],
        dim=2,
    ).reshape(jlen * o, 6, nv, nv)
    vecs = torch.stack(
        [dj(t1, 0)[:, None, :].expand(jlen, o, nv), t1[None].expand(jlen, o, nv)], dim=2
    ).reshape(jlen * o, 2, nv)
    eo_sum = e_o[i0] + dj(e_o, 0)[:, None] + e_o[None, :]
    c = lambda x: None if x is None else x.reshape(-1, nv, nv, nv).contiguous()
    return (c(t3_D), c(m3), mats.contiguous(), vecs.contiguous(),
            eo_sum.reshape(-1).contiguous(), t1[i0].contiguous(), e_v.contiguous())


def _islice_terms(i0: int, j0: int, t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v,
                  I_vovv_pp, I_ooov_pp, *, jlen: int, doing_T: bool, doing_R: bool,
                  doing_CR: bool, precision: str = "f64") -> dict:
    """The six reductions over the (i = i0, j in [j0, j0+jlen), all k)
    slab (panel form of the per-(i,j,k) loop, ccsd.f90:2151-2237).
    precision "pallas" hands the panels to K5; "f64" reduces in torch;
    "hybrid" runs the panel GEMMs and z3/y with f32 operands (cast here
    unless the caller has), while e_o/e_v, hence the denominators, the
    quotients and every reduction, stay f64 (JAX `:213-221`)."""
    if precision == "hybrid":
        t1, t2, v_vvov, v_oovo, v_oovv, I_vovv_pp, I_ooov_pp = (
            x.float() for x in (t1, t2, v_vvov, v_oovo, v_oovv, I_vovv_pp, I_ooov_pp))
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv_pp, I_ooov_pp)
    if precision == "pallas":
        # K5: only the two GEMM outputs (t3_D, m3) are materialised; t3,
        # xbar, z3 and y and the six reductions happen in the kernel
        s = triples_finale_spatial(
            *finale_panels(i0, j0, *args, jlen=jlen, doing_CR=doing_CR),
            doing_T=doing_T, doing_Y=doing_R or doing_CR, doing_CR=doing_CR,
        )
        acc = {"e_T": s[0]}
        if doing_T:
            acc["e_TT"] = s[0] + s[1]
        if doing_R or doing_CR:
            acc["D_T"] = s[2]
            if doing_T:
                acc["D_TT"] = s[2] + s[3]
        if doing_CR:
            acc["e_CR"] = s[4]
            if doing_T:
                acc["e_CRT"] = s[4] + s[5]
        return acc

    dj = lambda x, ax: x.narrow(ax, j0, jlen)
    t3_D, m3 = _slab_numerators(i0, j0, t1, t2, v_vvov, v_oovo, I_vovv_pp, I_ooov_pp,
                                jlen=jlen, with_m3=doing_CR)
    t2_i, t1_i = t2[i0], t1[i0]
    eo_sum = e_o[i0] + dj(e_o, 0)[:, None] + e_o[None, :]  # (jlen, o)
    D3 = (
        eo_sum[:, :, None, None, None]
        - e_v[None, None, :, None, None]
        - e_v[None, None, None, :, None]
        - e_v[None, None, None, None, :]
    )
    t3 = t3_D / D3
    t_bar = _xbar(t3)

    acc = {"e_T": torch.sum(t_bar * t3_D)}
    voovv_i = v_oovv[i0]  # (o,v,v)
    if doing_T:
        # z3 (Piecuch Eq. 60; ccsd.f90:2178-2179)
        z3 = (
            es("a,jkbc->jkabc", t1_i, dj(v_oovv, 0))
            + es("jb,kac->jkabc", dj(t1, 0), voovv_i)
            + es("kc,jab->jkabc", t1, dj(voovv_i, 0))
        ) / D3
        z3_bar = _xbar(z3)
        acc["e_TT"] = acc["e_T"] + torch.sum(z3_bar * t3_D)

    if doing_R or doing_CR:
        # y (Piecuch Eq. 66; ccsd.f90:2183-2184)
        y = (
            es("a,jb,kc->jkabc", t1_i, dj(t1, 0), t1)
            + es("a,jkbc->jkabc", t1_i, dj(t2, 0))
            + es("jb,kac->jkabc", dj(t1, 0), t2_i)
            + es("kc,jab->jkabc", t1, dj(t2_i, 0))
        )
        acc["D_T"] = torch.sum(t_bar * y)
        if doing_T:
            acc["D_TT"] = acc["D_T"] + torch.sum(z3_bar * y)

    if doing_CR:
        acc["e_CR"] = torch.sum(t_bar * m3)
        if doing_T:
            acc["e_CRT"] = acc["e_CR"] + torch.sum(z3_bar * m3)
    return acc


def strict_spatial_plan(nocc: int):
    """Sorted occupied triples i<=j<=k with their S3-orbit weights 1
    (distinct), 1/2 (two equal), 1/6 (all equal): with the class
    operator M, summing them reproduces the full-cube totals of every
    xbar reduction.  Padded to a multiple of 8 with zero-weight (0,0,0)
    entries, as in the JAX package.  Returns (ii, jj, kk, w) numpy."""
    tri = [(i, j, k) for i in range(nocc) for j in range(i, nocc) for k in range(j, nocc)]
    w = [1.0 if i < j < k else (1.0 / 6.0 if i == j == k else 0.5) for (i, j, k) in tri]
    pad = (-len(tri)) % 8
    tri += [(0, 0, 0)] * pad
    w += [0.0] * pad
    a = np.asarray(tri, dtype=np.int32).reshape(-1, 3)
    return a[:, 0], a[:, 1], a[:, 2], np.asarray(w)


def _triples_total_spatial(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv_pp, I_ooov_pp,
                           *, nocc: int, jlen: int, doing_T: bool, doing_R: bool,
                           doing_CR: bool, precision: str = "f64", cells=None) -> tuple:
    """The six reductions over the (i, j-slab) grid, in _SUM_KEYS order,
    as 0-d tensors: the full grid, or the (i0, j0) slabs of `cells` (a
    mesh entry's share).  jlen must divide nocc."""
    assert nocc % jlen == 0
    if precision == "hybrid":
        # the f64->f32 operand casts once, outside the slab loop
        t1, t2, v_vvov, v_oovo, v_oovv, I_vovv_pp, I_ooov_pp = (
            x.float() for x in (t1, t2, v_vvov, v_oovo, v_oovv, I_vovv_pp, I_ooov_pp))
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv_pp, I_ooov_pp)
    if cells is None:
        cells = [(i0, j0) for i0 in range(nocc) for j0 in range(0, nocc, jlen)]
    sums = [e_o.new_zeros(()) for _ in _SUM_KEYS]
    for i0, j0 in cells:
        acc = _islice_terms(i0, j0, *args, jlen=jlen, doing_T=doing_T, doing_R=doing_R,
                            doing_CR=doing_CR, precision=precision)
        sums = [s + acc[k] if k in acc else s for s, k in zip(sums, _SUM_KEYS)]
    return tuple(sums)


def pick_spatial_jlen(nocc: int, nvirt: int, precision: str) -> int:
    """j-slab length for the (i, j-slab) grid: bounds the ~(6..20) live
    (jlen*o*v^3) panel transients to ~8 GB at the JAX package's bytes per
    element ("pallas" 8, "hybrid" 12, otherwise 40).  jlen divides nocc."""
    el = {"hybrid": 12, "pallas": 8}.get(precision, 40)
    budget = max(1, min(nocc, int(8e9 / (20 * el * nocc * nvirt**3) + 1)))
    return max(d for d in range(1, budget + 1) if nocc % d == 0)


def _sorted_plan(nocc: int, dev):
    """strict_spatial_plan without its zero-weight padding, on `dev`."""
    si, sj, sk, w = strict_spatial_plan(nocc)
    keep = w > 0
    idx = tuple(torch.as_tensor(x[keep], dtype=torch.int32, device=dev) for x in (si, sj, sk))
    return idx, torch.as_tensor(w[keep], dtype=torch.float64, device=dev)


def default_precision(dev: torch.device, nvirt: int, requested: str = "f64") -> str:
    """The tier of a "f64" or "hybrid" request: on a CUDA device K3 up to
    nvirt 128 and K4 above, on the CPU the request itself."""
    if dev.type != "cuda":
        return "hybrid" if requested == "hybrid" else "f64"
    return "fused" if nvirt <= 128 else "tiled"


def triples_tier(cfg: Config) -> str | None:
    """The tier `ccsd_precision` names (JAX `do_ccsd_t_spatial`
    `:530-549`): "pallas" and "fused" as named, None (default_precision)
    for "f64" and "hybrid"."""
    return cfg.ccsd_precision if cfg.ccsd_precision in ("pallas", "fused") else None


def cr_precision(cfg: Config, precision: str | None) -> str:
    """The CR chain's arithmetic, "f64" or "f32" (module docstring)."""
    requested = precision if precision in ("f64", "hybrid") else cfg.ccsd_precision
    return "f64" if requested == "f64" else "f32"


def do_ccsd_t_spatial(
    sys_: dat.System,
    cc: CCSDResult,
    cfg: Config,
    levels: np.ndarray,
    rep: Reporter | None = None,
    precision: str | None = None,
    mesh=None,
) -> TriplesResult:
    """The restricted triples family on the device of the amplitudes.
    precision: "fused" | "tiled" | "pallas" | "hybrid" | "f64"; None
    takes the tier from cfg.ccsd_precision, the device and nvirt (module
    docstring).  With `mesh` the tier runs on each entry's share of its
    work list."""
    t1, t2 = cc.t1, cc.t2
    dev = t1.device
    nocc, nvirt = sys_.nocc, sys_.nvirt
    chain = cr_precision(cfg, precision)
    if precision is None:
        precision = triples_tier(cfg) or default_precision(dev, nvirt, cfg.ccsd_precision)
    if precision not in PRECISIONS:
        raise ValueError(f"triples precision must be one of {PRECISIONS}, got {precision!r}")
    rep = rep or Reporter()
    rep.section("CCSD(T)")
    t_start = time.perf_counter()

    doing_T = cfg.ccsd_t_paren
    doing_R = cfg.ccsd_t_renorm
    doing_CR = cfg.ccsd_t_comp_renorm
    flags = dict(doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR)

    v = cc.slices
    lv = torch.as_tensor(levels, dtype=t1.dtype, device=dev)
    e_o, e_v = lv[:nocc], lv[nocc : nocc + nvirt]
    if doing_CR:
        if v.v_vvvv is None and cc.cr_vvvv_term is None:
            raise AssertionError(
                "CR intermediates need v_vvvv or its precomputed contraction "
                "(streaming tier: do_ccsd_spatial computes cr_vvvv_term when "
                "the config requests a CR variant)"
            )
        I_vovv_pp, I_ooov_pp = cr_intermediates(
            t1, t2, cc.t1_prev, cc.t2_prev, v, nocc,
            precision="f64" if chain == "f64" else "hybrid", vvvv_term=cc.cr_vvvv_term)
        if precision != "hybrid":
            # the f64 tiers take the f32 chain's results as f64 (exact)
            I_vovv_pp, I_ooov_pp = I_vovv_pp.double(), I_ooov_pp.double()
    else:
        I_vovv_pp = I_ooov_pp = None

    if precision in ("pallas", "hybrid", "f64") and not doing_CR:
        # _islice_terms reads them only for CR
        I_vovv_pp = t1.new_zeros((nvirt, nocc, nvirt, nvirt))
        I_ooov_pp = t1.new_zeros((nocc, nocc, nocc, nvirt))
    targs = (t1, t2, v.v_vvov, v.v_oovo, v.v_oovv, e_o, e_v, I_vovv_pp, I_ooov_pp)
    jlen = pick_spatial_jlen(nocc, nvirt, precision)
    if mesh is not None:
        from ..parallel.triples_shard import triples_spatial_sharded

        totals = triples_spatial_sharded(mesh, *targs, nocc=nocc, jlen=jlen,
                                         precision=precision, **flags)
    elif precision in ("fused", "tiled"):
        (si, sj, sk), w = _sorted_plan(nocc, dev)
        kernel = triples_fused_spatial if precision == "fused" else triples_tiled_spatial
        s = kernel(*targs, si, sj, sk, w, **flags)
        totals = (s[0], s[0] + s[1], s[2], s[2] + s[3], s[4], s[4] + s[5])
    else:
        totals = _triples_total_spatial(*targs, nocc=nocc, jlen=jlen, precision=precision,
                                        **flags)
    # a sum whose variant is off is 0 on every tier
    on = dict(e_T=True, e_TT=doing_T, D_T=doing_R or doing_CR,
              D_TT=(doing_R or doing_CR) and doing_T, e_CR=doing_CR, e_CRT=doing_CR and doing_T)
    vals = torch.stack([x for x in totals]).tolist()
    trace.synced()
    sums = {k: (x if on[k] else 0.0) for k, x in zip(_SUM_KEYS, vals)}
    if cfg.ccsd_t_spatial_bug_compat and doing_T and not (doing_R or doing_CR):
        # reference quirk (ccsd.f90:2211-2215): z3_bar is only formed for
        # renormalised variants, so upstream's plain CCSD(T)_spatial
        # equals its CCSD[T]
        sums["e_TT"] = sums["e_T"]

    e_T, e_TT = sums["e_T"], sums["e_TT"]
    D_T, D_TT = sums["D_T"], sums["D_TT"]
    e_CR, e_CRT = sums["e_CR"], sums["e_CRT"]

    if doing_R or doing_CR:
        # constant denominator terms (ccsd.f90:2241-2248), from the
        # converged amplitudes
        asym_t2 = 2.0 * t2 - t2.permute(1, 0, 2, 3)
        c_oovv = t2 + es("ia,jb->ijab", t1, t1)
        const = float(1.0 + 2.0 * torch.sum(t1**2) + torch.sum(asym_t2 * c_oovv))
        trace.synced()
        D_T += const
        if doing_T:
            D_TT += const

    res = TriplesResult(precision_used=precision, cr_precision=chain if doing_CR else "")
    e_ccsd = cc.e_ccsd
    res.e_ccsd_t = e_ccsd + e_T
    res.e_highest = res.e_ccsd_t
    res.D_T, res.D_TT = D_T, D_TT
    if doing_T:
        res.e_ccsd_tt = e_ccsd + e_TT
        res.e_highest = res.e_ccsd_tt
    if doing_R or doing_CR:
        res.e_rccsd_t = e_ccsd + e_T / D_T
        res.e_highest = res.e_rccsd_t
        if doing_T:
            res.e_rccsd_tt = e_ccsd + e_TT / D_TT
            res.e_highest = res.e_rccsd_tt
        if doing_CR:
            res.e_crccsd_t = e_ccsd + e_CR / D_T
            res.e_highest = res.e_crccsd_t
            if doing_T:
                res.e_crccsd_tt = e_ccsd + e_CRT / D_TT
                res.e_highest = res.e_crccsd_tt

    # calcname assembly (ccsd.f90:2279-2287)
    calcname = "CCSD" + ("(T)" if doing_T else "[T]")
    if doing_R:
        calcname = "renormalised " + calcname
    if doing_CR:
        calcname = "completely renormalised " + calcname
    res.calcname = calcname

    rep.write(
        f" Restricted {calcname} correlation energy (Hartree): {res.e_highest:15.9f}"
    )
    rep.stage_time(
        f"Time taken for restricted {calcname}:", time.perf_counter() - t_start
    )
    return res
