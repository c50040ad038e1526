"""Plain restricted triples family: CCSD[T], CCSD(T), R-CCSD[T]/(T) and
CR-CCSD[T]/(T) (Piecuch et al., Comput. Phys. Commun. 149, 71 (2002)).

The reference code's do_ccsd_t_spatial and build_cr_ccsd_t_intermediates
(ccsd.f90:2018-2293, 2338-2551), with their quirks kept, since the
program reproduces them: the CR intermediates read I_vo and the
antisymmetrised T2 of the amplitudes fed into the last CCSD iteration,
and the last three terms of I_ooov'' sum their virtual index over the
first nocc virtuals only.  The connected triples, the z3, y and M3
terms are formed for every (i, j, k) of the full cube, a slab of j at a
time, by `torch.einsum` in the given dtype; the six sums are the
reductions of the x-bar combinations against them.  `cr_dtype` puts the
CR chain alone in another dtype, its intermediates cast back.
"""

from __future__ import annotations

import torch

from .cc import CCSD, Slices, cast_ccsd, cast_slices

es = torch.einsum


def xbar(x: torch.Tensor) -> torch.Tensor:
    """4/3 x[abc] - 2 x[acb] + 2/3 x[bca] over the last three axes."""
    n = x.ndim
    lead = tuple(range(n - 3))
    return (4.0 / 3.0 * x - 2.0 * x.permute(*lead, n - 3, n - 1, n - 2)
            + 2.0 / 3.0 * x.permute(*lead, n - 1, n - 3, n - 2))


def cr_intermediates(cc: CCSD, v: Slices, nocc: int):
    """I_vovv'' (c, i, a, b) and I_ooov'' (j, k, i, a)."""
    t1, t2 = cc.t1, cc.t2
    asym_t2 = 2.0 * cc.t2_prev - cc.t2_prev.permute(1, 0, 2, 3)
    I_vo = 2.0 * es("miea,me->ai", v.oovv, cc.t1_prev) - es("miae,me->ai", v.oovv, cc.t1_prev)
    x_vvvo_p = v.vvov.permute(1, 0, 3, 2) - 0.5 * es("ma,mibc->bcai", t1, v.oovv)
    x_ovov_p = (v.ovov - 0.5 * es("mibj,ma->jbia", v.oovo, t1)
                + es("je,beai->jbia", t1, x_vvvo_p))
    x_voov_p = (v.oovv.permute(2, 1, 0, 3) - 0.5 * es("imbj,ma->bjia", v.oovo, t1)
                + es("ebai,je->bjia", x_vvvo_p, t1))
    x_vvvo = x_vvvo_p - 0.5 * es("ma,mibc->bcai", t1, v.oovv)
    x_ovoo = v.oovo.permute(3, 2, 1, 0) + es("ke,ijea->kaij", t1, v.oovv)
    x_ovov_pp = (v.ovov - es("mibj,ma->jbia", v.oovo, t1)
                 + 0.5 * es("je,beai->jbia", t1, x_vvvo))
    x_voov_pp = (v.oovv.permute(2, 1, 0, 3) - es("imbj,ma->bjia", v.oovo, t1)
                 + 0.5 * es("ebai,je->bjia", x_vvvo, t1))
    I_vovv = (v.vvov.permute(3, 2, 1, 0) + es("ecba,ie->ciab", v.vvvv, t1)
              - es("icma,mb->ciab", x_ovov_p, t1) - es("ma,cimb->ciab", t1, x_voov_p)
              - es("cm,miab->ciab", I_vo, t2) + es("mnba,icmn->ciab", t2, x_ovoo)
              + es("ceam,imbe->ciab", x_vvvo, asym_t2) - es("ecam,mieb->ciab", x_vvvo, t2)
              - es("miae,ecbm->ciab", t2, x_vvvo))
    ec = slice(None, nocc)  # the reference's `do e = 1, nocc`
    I_ooov = (v.oovo.permute(1, 0, 3, 2) - es("mikj,ma->jkia", v.oooo, t1)
              + es("jeia,ke->jkia", x_ovov_pp, t1) + es("je,ekia->jkia", t1, x_voov_pp)
              + es("kjef,efai->jkia", t2, x_vvvo)
              + es("jeim,mkea->jkia", x_ovoo[:, ec], asym_t2[:, :, ec])
              - es("jemi,mkea->jkia", x_ovoo[:, ec], t2[:, :, ec])
              - es("mjae,kemi->jkia", t2[:, :, :, ec], x_ovoo[:, ec]))
    return I_vovv.contiguous(), I_ooov.contiguous()


def _slab(i0, js, t1, t2, v: Slices, e_o, e_v, Iv, Jo) -> dict:
    """The six sums over (i = i0, j in js, every k)."""
    Vv, Vo = v.vvov, v.oovo
    dj = lambda x, ax: x.narrow(ax, js.start, js.stop - js.start)
    t2_i, t2_ci = t2[i0], t2[:, i0]
    Vv_i, Vo_i0, Vo_i1 = Vv[:, :, i0], Vo[i0], Vo[:, i0]
    t3_D = (es("jaf,cbkf->jkabc", dj(t2_i, 0), Vv) - es("mba,kjcm->jkabc", t2_ci, dj(Vo, 1))
            + es("jbf,cakf->jkabc", dj(t2_ci, 0), Vv) - es("mjab,kcm->jkabc", dj(t2, 1), Vo_i1)
            + es("kjcf,abf->jkabc", dj(t2, 1), Vv_i) - es("mkbc,jam->jkabc", t2, dj(Vo_i0, 0))
            + es("kaf,bcjf->jkabc", t2_i, dj(Vv, 2)) - es("mca,jkbm->jkabc", t2_ci, dj(Vo, 0))
            + es("jkbf,acf->jkabc", dj(t2, 0), Vv_i) - es("mjcb,kam->jkabc", dj(t2, 1), Vo_i0)
            + es("kcf,bajf->jkabc", t2_ci, dj(Vv, 2)) - es("mkac,jbm->jkabc", t2, dj(Vo_i1, 0)))
    Iv_i, Jo_i0, Jo_i1 = Iv[:, i0], Jo[i0], Jo[:, i0]
    m3 = (es("jae,ekbc->jkabc", dj(t2_i, 0), Iv) - es("mba,jkmc->jkabc", t2_ci, dj(Jo, 0))
          + es("jbe,ekac->jkabc", dj(t2_ci, 0), Iv) - es("mjab,kmc->jkabc", dj(t2, 1), Jo_i0)
          + es("kjce,eba->jkabc", dj(t2, 1), Iv_i) - es("mkbc,jma->jkabc", t2, dj(Jo_i1, 0))
          + es("kae,ejcb->jkabc", t2_i, dj(Iv, 1)) - es("mca,kjmb->jkabc", t2_ci, dj(Jo, 1))
          + es("jkbe,eca->jkabc", dj(t2, 0), Iv_i) - es("mjcb,kma->jkabc", dj(t2, 1), Jo_i1)
          + es("kce,ejab->jkabc", t2_ci, dj(Iv, 1)) - es("mkac,jmb->jkabc", t2, dj(Jo_i0, 0)))
    eo = e_o[i0] + dj(e_o, 0)[:, None] + e_o[None, :]
    D3 = (eo[:, :, None, None, None] - e_v[None, None, :, None, None]
          - e_v[None, None, None, :, None] - e_v[None, None, None, None, :])
    t3 = t3_D / D3
    tb = xbar(t3)
    t1_i, g_i = t1[i0], v.oovv[i0]
    z3 = (es("a,jkbc->jkabc", t1_i, dj(v.oovv, 0)) + es("jb,kac->jkabc", dj(t1, 0), g_i)
          + es("kc,jab->jkabc", t1, dj(g_i, 0))) / D3
    zb = xbar(z3)
    y = (es("a,jb,kc->jkabc", t1_i, dj(t1, 0), t1) + es("a,jkbc->jkabc", t1_i, dj(t2, 0))
         + es("jb,kac->jkabc", dj(t1, 0), t2_i) + es("kc,jab->jkabc", t1, dj(t2_i, 0)))
    return {"e_T": torch.sum(tb * t3_D), "e_Tz": torch.sum(zb * t3_D),
            "D_T": torch.sum(tb * y), "D_Tz": torch.sum(zb * y),
            "e_CR": torch.sum(tb * m3), "e_CRz": torch.sum(zb * m3)}


def slab_length(o: int, v: int, itemsize: int, budget: float = 12e9) -> int:
    """The largest j-slab (a divisor of o) whose ~24 live (jlen, o, v, v, v)
    transients fit `budget` bytes."""
    cap = max(1, int(budget / (24 * itemsize * o * v**3)))
    return max(d for d in range(1, min(o, cap) + 1) if o % d == 0)


def triples(cc: CCSD, v: Slices, e_o, e_v, e_ccsd: float,
            cr_dtype: torch.dtype | None = None) -> dict:
    """The six correlation energies of the family, and D[T], D(T)."""
    o, nv = cc.t1.shape
    t1, t2 = cc.t1, cc.t2
    if cr_dtype is None or cr_dtype == t1.dtype:
        Iv, Jo = cr_intermediates(cc, v, o)
    else:
        low = cr_intermediates(cast_ccsd(cc, cr_dtype), cast_slices(v, cr_dtype), o)
        Iv, Jo = (x.to(t1.dtype) for x in low)
    jlen = slab_length(o, nv, t1.element_size())
    sums = dict.fromkeys(("e_T", "e_Tz", "D_T", "D_Tz", "e_CR", "e_CRz"), 0.0)
    for i0 in range(o):
        for j0 in range(0, o, jlen):
            part = _slab(i0, slice(j0, j0 + jlen), t1, t2, v, e_o, e_v, Iv, Jo)
            for k in sums:
                sums[k] = sums[k] + part[k]
    s = {k: float(x) for k, x in sums.items()}
    asym_t2 = 2.0 * t2 - t2.permute(1, 0, 2, 3)
    const = float(1.0 + 2.0 * torch.sum(t1**2)
                  + torch.sum(asym_t2 * (t2 + es("ia,jb->ijab", t1, t1))))
    D_T = s["D_T"] + const
    D_TT = s["D_T"] + s["D_Tz"] + const
    e_T, e_TT = s["e_T"], s["e_T"] + s["e_Tz"]
    e_CR, e_CRT = s["e_CR"], s["e_CR"] + s["e_CRz"]
    return {
        "e_ccsd_t": e_ccsd + e_T, "e_ccsd_tt": e_ccsd + e_TT,
        "e_rccsd_t": e_ccsd + e_T / D_T, "e_rccsd_tt": e_ccsd + e_TT / D_TT,
        "e_crccsd_t": e_ccsd + e_CR / D_T, "e_crccsd_tt": e_ccsd + e_CRT / D_TT,
        "D_T": D_T, "D_TT": D_TT,
    }
