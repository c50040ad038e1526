"""Plain AO->MO transform, MP2 and spin-free CCSD.

CCSD follows Piecuch et al., Comput. Phys. Commun. 149, 71 (2002):
the Table-1 intermediates and the T1/T2 equations (Eqs. 43-44) in the
reference code's index orders (ccsd.f90's restricted debug routines),
every contraction a `torch.einsum` in the given dtype.  The iteration
starts from the MP1 amplitudes and is accelerated by DIIS over the last
ccsd_diis_n_errmat amplitude vectors, the error being the change from
the amplitudes fed in; converged when the RMS change of T2 is below
ccsd_t_tol and the energy change below ccsd_e_tol.  The converged
amplitudes are the last unextrapolated update; the pair fed into the
last iteration is kept too, since the CR-CC intermediates read it.
"""

from __future__ import annotations

import dataclasses

import torch

es = torch.einsum


@dataclasses.dataclass
class Slices:
    """<pq|rs> = (pr|qs) blocks; o occupied, v virtual."""

    oovv: torch.Tensor
    ovov: torch.Tensor
    vvov: torch.Tensor
    oovo: torch.Tensor
    oooo: torch.Tensor
    vvvv: torch.Tensor


@dataclasses.dataclass
class CCSD:
    energy: float
    t1: torch.Tensor
    t2: torch.Tensor
    t1_prev: torch.Tensor  # the pair fed into the last iteration
    t2_prev: torch.Tensor
    iterations: int
    converged: bool


def ao_to_mo(eri: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(mu nu|la si) -> (pq|rs) with C[mu, p], one index at a time."""
    n = eri.shape[0]
    Ct = C.T.contiguous()
    t = (Ct @ eri.reshape(n, n**3)).reshape(n, n, n, n)
    t = torch.matmul(Ct, t.reshape(n, n, n * n))
    t = torch.matmul(Ct, t.reshape(n * n, n, n))
    return (t.reshape(n**3, n) @ C).reshape(n, n, n, n)


def slices(mo: torch.Tensor, o: int) -> Slices:
    phys = mo.permute(0, 2, 1, 3)
    O, V = slice(None, o), slice(o, None)
    c = lambda x: x.contiguous()
    return Slices(c(phys[O, O, V, V]), c(phys[O, V, O, V]), c(phys[V, V, O, V]),
                  c(phys[O, O, V, O]), c(phys[O, O, O, O]), c(phys[V, V, V, V]))


def cast_slices(v: Slices, dtype: torch.dtype) -> Slices:
    return Slices(*(getattr(v, f.name).to(dtype) for f in dataclasses.fields(v)))


def cast_ccsd(res: CCSD, dtype: torch.dtype) -> CCSD:
    return dataclasses.replace(res, **{k: getattr(res, k).to(dtype)
                                       for k in ("t1", "t2", "t1_prev", "t2_prev")})


def mp2_energy(v: Slices, e_o: torch.Tensor, e_v: torch.Tensor) -> float:
    D = e_o[:, None, None, None] + e_o[None, :, None, None] - e_v[None, None, :, None] \
        - e_v[None, None, None, :]
    g = v.oovv  # <ij|ab> = (ia|jb)
    return float(torch.sum(g * (2.0 * g - g.permute(0, 1, 3, 2)) / D))


def energy(t1, t2, oovv) -> torch.Tensor:
    asym = 2.0 * oovv - oovv.permute(0, 1, 3, 2)
    return torch.sum(asym * (t2 + es("ia,jb->ijab", t1, t1)))


def update(t1, t2, v: Slices, D1, D2):
    """One T1/T2 update (Piecuch Eqs. 43-44 with the Table-1 intermediates)."""
    asym_t2 = 2.0 * t2 - t2.permute(1, 0, 2, 3)
    c2 = t2 + es("ia,jb->ijab", t1, t1)
    I_vo = 2.0 * es("miea,me->ai", v.oovv, t1) - es("miae,me->ai", v.oovv, t1)
    x_voov = es("je,beia->bjia", t1, v.vvov)
    x_ovov = es("je,ebia->jbia", t1, v.vvov)
    I_vv = (2.0 * es("mbma->ba", x_ovov) - es("bmma->ba", x_voov)
            - 2.0 * es("mneb,mnea->ba", v.oovv, c2) + es("mnbe,mnea->ba", v.oovv, c2))
    I_oo_p = (2.0 * es("miej,me->ji", v.oovo, t1) - es("imej,me->ji", v.oovo, t1)
              + es("mief,mjef->ji", v.oovv, asym_t2))
    I_oo = I_oo_p + es("ei,je->ji", I_vo, t1)
    I_oooo = (v.oooo + es("ijef,klef->klij", v.oovv, c2)
              + es("ijel,ke->klij", v.oovo, t1) + es("jiek,le->klij", v.oovo, t1))
    I_ovov = (v.ovov - 0.5 * es("imeb,jmea->jbia", v.oovv, c2)
              - es("mibj,ma->jbia", v.oovo, t1) + x_ovov)
    I_voov = (v.oovv.permute(2, 1, 0, 3) + es("imbe,mjea->bjia", v.oovv, t2)
              - 0.5 * es("imeb,mjea->bjia", v.oovv, t2)
              - 0.5 * es("mieb,mjae->bjia", v.oovv, c2)
              + x_voov - es("imbj,ma->bjia", v.oovo, t1))
    I_ooov_p = (v.oovo.permute(1, 0, 3, 2) + es("efia,jkef->jkia", v.vvov, t2)
                + es("je,ekia->jkia", t1, x_voov))

    r1 = (es("ea,ie->ia", I_vv, t1) - es("im,ma->ia", I_oo_p, t1)
          + es("em,miea->ia", I_vo, asym_t2)
          + 2.0 * es("miea,me->ia", v.oovv, t1) - es("maie,me->ia", v.ovov, t1)
          - 2.0 * es("mnei,mnea->ia", v.oovo, t2) + es("mnei,mnae->ia", v.oovo, t2)
          + es("efma,mief->ia", v.vvov, asym_t2))

    # sum_e t1[i,e] I_vovv'[e,j,a,b], with I_vovv' = v_vvov[b,a,j,e]
    # - v_ovov[m,a,j,e] t1[m,b] - v_oovv[m,j,e,b] t1[m,a]
    t1_Ivovv = (es("ie,baje->ijab", t1, v.vvov)
                - es("ie,maje,mb->ijab", t1, v.ovov, t1)
                - es("ie,mjeb,ma->ijab", t1, v.oovv, t1))
    X = (es("ijae,eb->ijab", t2, I_vv) - es("imab,jm->ijab", t2, I_oo)
         + 0.5 * es("efab,ijef->ijab", v.vvvv, c2)
         + 0.5 * es("mnab,ijmn->ijab", c2, I_oooo)
         + t1_Ivovv - es("ma,ijmb->ijab", t1, I_ooov_p)
         - es("mjae,iemb->ijab", t2, I_ovov) - es("iema,mjeb->ijab", I_ovov, t2)
         + es("miea,ejmb->ijab", asym_t2, I_voov))
    return r1 / D1, (v.oovv + X + X.permute(1, 0, 3, 2)) / D2


def ccsd(v: Slices, e_o, e_v, *, e_tol: float, t_tol: float, n_errmat: int,
         maxiter: int) -> CCSD:
    D1 = e_o[:, None] - e_v[None, :]
    D2 = e_o[:, None, None, None] + e_o[None, :, None, None] - e_v[None, None, :, None] \
        - e_v[None, None, None, :]
    t1 = torch.zeros_like(D1)
    t2 = v.oovv / D2
    e_old = float(energy(t1, t2, v.oovv))
    t2_old = t2
    hist_T, hist_E = [], []
    for it in range(1, maxiter + 1):
        t1n, t2n = update(t1, t2, v, D1, D2)
        e = float(energy(t1n, t2n, v.oovv))
        rms = float(torch.sqrt(torch.sum((t2n - t2_old) ** 2)))
        new = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        hist_T.append(new)
        hist_E.append(new - torch.cat([t1.reshape(-1), t2.reshape(-1)]))
        hist_T, hist_E = hist_T[-n_errmat:], hist_E[-n_errmat:]
        t1_fed, t2_fed = t1, t2
        if rms < t_tol and abs(e - e_old) < e_tol:
            return CCSD(e, t1n, t2n, t1_fed, t2_fed, it, True)
        e_old, t2_old = e, t2n
        t1, t2 = t1n, t2n
        if len(hist_T) >= 2:
            n = len(hist_T)
            E = torch.stack(hist_E)
            B = new.new_zeros((n + 1, n + 1))
            B[:n, :n] = E @ E.T
            B[n, :n] = B[:n, n] = -1.0
            rhs = new.new_zeros(n + 1)
            rhs[n] = -1.0
            c, info = torch.linalg.solve_ex(B, rhs)
            if int(info) == 0 and bool(torch.isfinite(c).all()):
                flat = c[:n] @ torch.stack(hist_T)
                t1 = flat[:t1.numel()].reshape(t1.shape)
                t2 = flat[t1.numel():].reshape(t2.shape)
    return CCSD(e, t1n, t2n, t1_fed, t2_fed, maxiter, False)
