"""Plain restricted RHF, MP2, CCSD and the [T]/(T)/R-/CR- triples family
that never holds an n^4 AO or MO tensor: the f64 reference of systems
whose dense tensors do not fit on one card (the water pentamer in
cc-pVTZ: one n^4 f64 tensor is 56.6 GB).

The calculation of `gpubench/reference/rccsd_t.py`, whose readers
(`files`), DIIS (`scf`), MP2 and CCSD (`cc`, which fits: v_vvvv is the
one v^4 tensor) and x-bar (`triples`) it calls, with three changes of
blocking and none of arithmetic:

- the Fock build reads the packed store (`eri.npy` or `eri.dat`) a
  block of the first AO index at a time, (i0:i1, :, :, :) gathered from
  it, J and K contracted from each block;
- the AO->MO transform makes each such block's three trailing quarter
  transforms and adds the block's share of the first into the MO slices
  (<ab|cd> written straight into its physicist layout, a block of
  virtuals at a time), so that no n^4 tensor exists;
- the triples form their cubes a (i, j, block of k) at a time, over
  i <= j <= k alone, each (i, j, k) weighted by the number of its
  distinct orderings (6, 3 or 1); the CR chain's v_vvvv contraction is
  made as soon as CCSD ends, as one GEMM (the einsum would copy
  v_vvvv), and v_vvvv is then dropped.

The triples' one change of arithmetic: each cube is reduced against
`xbar_sym`, the average of `triples.xbar` over the six orderings of
(a, b, c), in place of `xbar`.  The cubes (t3, z3, y, M3) are covariant
under a permutation of (i, j, k) taken with the same one of (a, b, c),
so over the full cube of (i, j, k) the two give the same six sums; with
`xbar_sym` each (i, j, k)'s share is the same for every ordering of
(i, j, k), which lets the sums run over i <= j <= k: under a fifth of the
work at o = 25 (the water pentamer's triples on an H100: ~220 s over the
full cube, ~55 s so).

`run(workdir, els, device, dtype, lower)` returns what `rccsd_t.run`
returns: the RHF total energy, the MP2 and CCSD correlation energies,
the six triples correlation energies and D[T], D(T) for a (T)
calc_type, and the SCF and CC iteration counts.  `lower` puts one stage
in another dtype (the controls of the correctness limits): "fock" the
J/K build, "corr" MP2 and CCSD, "triples" the (T) family with its CR
chain, "cr" the CR chain alone.  TF32 is off while it runs.  It imports
torch, numpy and the benchmark's plain reference alone: nothing of the
program, nothing of JAX.  The benchmark's copy
(`gpubench/reference/rccsd_t_blocked.py`) and the tests' one
(`tests/plain_rccsd_blocked.py`) are the same file.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from gpubench.reference import cc, files, scf
from gpubench.reference.rccsd_t import CALC_TYPES, STAGES, no_tf32

es = torch.einsum
# elements of one gathered AO block (ib, n, n, n)
AO_BLOCK_ELEMS = 1.5e8
# bytes of one triples cube (kb, v, v, v), of which ~30 are live
CUBE_BYTES = 8e8
# bytes of the (pb, v, v, v) term added into <ab|cd> at a time
VVVV_TERM_BYTES = 1.2e9


# ------------------------------------------------------------- the AO blocks

def _pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.minimum(x, y), torch.maximum(x, y)
    return hi * (hi + 1) // 2 + lo


class AOStore:
    """The packed store on the device, handed out a block of the first AO
    index at a time as dense (i1 - i0, n, n, n) chemist (ij|kl)."""

    def __init__(self, packed, n: int, device):
        self.n = n
        self.packed = torch.as_tensor(packed, device=device)
        # int32 index arithmetic is exact while npair (npair + 1) < 2^31
        self.itype = torch.int32 if n <= 300 else torch.int64
        i = torch.arange(n, device=device, dtype=self.itype)
        self.pairs = _pair(i[:, None], i[None, :])  # (n, n)
        self.ib = max(1, min(n, int(AO_BLOCK_ELEMS // n**3)))

    def blocks(self):
        for i0 in range(0, self.n, self.ib):
            i1 = min(i0 + self.ib, self.n)
            ij = self.pairs[i0:i1].reshape(-1, 1)
            idx = _pair(ij, self.pairs.reshape(1, -1))
            yield i0, i1, self.packed[idx].view(i1 - i0, self.n, self.n, self.n)


# ---------------------------------------------------------------------- RHF

def fock(H: torch.Tensor, ao: AOStore, D: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """H + 2J - K, J and K contracted in `dtype` from the AO blocks."""
    n = H.shape[0]
    Dl = D.to(dtype)
    J = torch.empty((n, n), dtype=dtype, device=H.device)
    K = torch.empty((n, n), dtype=dtype, device=H.device)
    for i0, i1, E in ao.blocks():
        E = E.to(dtype)
        J[i0:i1] = (E.reshape((i1 - i0) * n, n * n) @ Dl.reshape(-1)).view(i1 - i0, n)
        K[i0:i1] = es("ikjl,kl->ij", E, Dl)
    return H + 2.0 * J.to(H.dtype) - K.to(H.dtype)


def rhf(S, H, ao: AOStore, nocc: int, *, e_tol: float, d_tol: float, n_errmat: int,
        maxiter: int, fock_dtype: torch.dtype) -> scf.SCF:
    """`scf.rhf` with the blocked Fock build."""
    s, U = torch.linalg.eigh(S)
    X = (U / torch.sqrt(s)) @ U.T
    F = H.clone()
    D_old = torch.zeros_like(H)
    e_old = 0.0
    Fs, Es = [], []
    for it in range(1, maxiter + 1):
        w, Cp = torch.linalg.eigh(X.T @ F @ X)
        C = X @ Cp
        D = C[:, :nocc] @ C[:, :nocc].T
        energy = float(torch.sum(D * (H + F)))
        rms = float(torch.linalg.norm(D - D_old))
        if rms < d_tol and abs(energy - e_old) < e_tol:
            return scf.SCF(energy, C, w, it, True)
        e_old, D_old = energy, D
        F = fock(H, ao, D, fock_dtype)
        if n_errmat >= 2:
            Fs.append(F)
            Es.append(F @ D @ S - S @ D @ F)
            Fs, Es = Fs[-n_errmat:], Es[-n_errmat:]
            if len(Fs) >= 2:
                F = scf.diis_extrapolate(Fs, Es)
    return scf.SCF(energy, C, w, maxiter, False)


# ------------------------------------------------------------ AO -> MO slices

def ao_to_mo_slices(ao: AOStore, C: torch.Tensor, o: int) -> cc.Slices:
    """The physicist slices from the AO blocks with C[mu, p]: each block
    (mu0:mu1| ..) transformed on its three trailing indices, then its
    share C[mu, p] Y[mu, q, r, s] of each chemist block added."""
    n = ao.n
    nv = n - o
    O, V = slice(None, o), slice(o, None)
    dt, dev = C.dtype, C.device
    chem = {  # chemist (pq|rs) blocks: (P, Q, R, S)
        "ovov": (O, V, O, V), "oovv": (O, O, V, V), "vovv": (V, O, V, V),
        "ovoo": (O, V, O, O), "oooo": (O, O, O, O)}
    size = lambda s: o if s is O else nv
    acc = {k: torch.zeros(tuple(size(s) for s in blk), dtype=dt, device=dev)
           for k, blk in chem.items()}
    vvvv = torch.zeros((nv, nv, nv, nv), dtype=dt, device=dev)  # <ab|cd>
    pb = max(1, min(nv, int(VVVV_TERM_BYTES // (8 * nv**3))))
    for m0, m1, E in ao.blocks():
        b = m1 - m0
        Y = (E.reshape(b * n * n, n) @ C).view(b * n, n, n)  # (m nu, la, s)
        Y = torch.matmul(C.T, Y).view(b, n, n * n)  # (m, nu, r s)
        Y = torch.matmul(C.T, Y).view(b, n, n, n)  # (m, q, r, s)
        del E
        Cm = C[m0:m1]
        for k, (P, Q, R, S) in chem.items():
            acc[k] += es("mp,mqrs->pqrs", Cm[:, P], Y[:, Q, R, S])
        Yv = Y[:, V, V, V].reshape(b, nv**3)
        del Y
        for p0 in range(0, nv, pb):
            p1 = min(p0 + pb, nv)
            term = (Cm[:, o + p0:o + p1].T @ Yv).view(p1 - p0, nv, nv, nv)  # (pq|rs)
            vvvv[p0:p1].permute(0, 2, 1, 3).add_(term)  # <pr|qs> = (pq|rs)
            del term
        del Yv
    c = lambda t, *perm: t.permute(*perm).contiguous()
    return cc.Slices(oovv=c(acc["ovov"], 0, 2, 1, 3), ovov=c(acc["oovv"], 0, 2, 1, 3),
                  vvov=c(acc["vovv"], 0, 2, 1, 3), oovo=c(acc["ovoo"], 0, 2, 1, 3),
                  oooo=c(acc["oooo"], 0, 2, 1, 3), vvvv=vvvv)


def cast_slices(v: cc.Slices, dtype: torch.dtype) -> cc.Slices:
    """`cc.cast_slices`, with v_vvvv None once it has been dropped."""
    return cc.Slices(*(None if getattr(v, f.name) is None else getattr(v, f.name).to(dtype)
                       for f in dataclasses.fields(v)))


# ------------------------------------------------------------------- triples

def cr_intermediates(res: cc.CCSD, v: cc.Slices, nocc: int, vvvv_term: torch.Tensor):
    """`triples.cr_intermediates` with the chain's one v_vvvv contraction
    es("ecba,ie->ciab", v_vvvv, t1) given: I_vovv'' (c, i, a, b) and
    I_ooov'' (j, k, i, a)."""
    t1, t2 = res.t1, res.t2
    asym_t2 = 2.0 * res.t2_prev - res.t2_prev.permute(1, 0, 2, 3)
    I_vo = 2.0 * es("miea,me->ai", v.oovv, res.t1_prev) - es("miae,me->ai", v.oovv, res.t1_prev)
    x_vvvo_p = v.vvov.permute(1, 0, 3, 2) - 0.5 * es("ma,mibc->bcai", t1, v.oovv)
    x_ovov_p = (v.ovov - 0.5 * es("mibj,ma->jbia", v.oovo, t1)
                + es("je,beai->jbia", t1, x_vvvo_p))
    x_voov_p = (v.oovv.permute(2, 1, 0, 3) - 0.5 * es("imbj,ma->bjia", v.oovo, t1)
                + es("ebai,je->bjia", x_vvvo_p, t1))
    x_vvvo = x_vvvo_p - 0.5 * es("ma,mibc->bcai", t1, v.oovv)
    del x_vvvo_p
    x_ovoo = v.oovo.permute(3, 2, 1, 0) + es("ke,ijea->kaij", t1, v.oovv)
    x_ovov_pp = (v.ovov - es("mibj,ma->jbia", v.oovo, t1)
                 + 0.5 * es("je,beai->jbia", t1, x_vvvo))
    x_voov_pp = (v.oovv.permute(2, 1, 0, 3) - es("imbj,ma->bjia", v.oovo, t1)
                 + 0.5 * es("ebai,je->bjia", x_vvvo, t1))
    I_vovv = v.vvov.permute(3, 2, 1, 0) + vvvv_term
    I_vovv -= es("icma,mb->ciab", x_ovov_p, t1)
    I_vovv -= es("ma,cimb->ciab", t1, x_voov_p)
    I_vovv -= es("cm,miab->ciab", I_vo, t2)
    I_vovv += es("mnba,icmn->ciab", t2, x_ovoo)
    I_vovv += es("ceam,imbe->ciab", x_vvvo, asym_t2)
    I_vovv -= es("ecam,mieb->ciab", x_vvvo, t2)
    I_vovv -= es("miae,ecbm->ciab", t2, x_vvvo)
    ec = slice(None, nocc)  # the reference's `do e = 1, nocc`
    I_ooov = (v.oovo.permute(1, 0, 3, 2) - es("mikj,ma->jkia", v.oooo, t1)
              + es("jeia,ke->jkia", x_ovov_pp, t1) + es("je,ekia->jkia", t1, x_voov_pp)
              + es("kjef,efai->jkia", t2, x_vvvo)
              + es("jeim,mkea->jkia", x_ovoo[:, ec], asym_t2[:, :, ec])
              - es("jemi,mkea->jkia", x_ovoo[:, ec], t2[:, :, ec])
              - es("mjae,kemi->jkia", t2[:, :, :, ec], x_ovoo[:, ec]))
    return I_vovv.contiguous(), I_ooov.contiguous()


def xbar_sym(x: torch.Tensor) -> torch.Tensor:
    """4/3 x[abc] - 2/3 (x[acb] + x[bac] + x[cba]) + 1/3 (x[bca] + x[cab])
    over the last three axes: `triples.xbar` averaged over the orderings
    of (a, b, c)."""
    n = x.ndim
    lead = tuple(range(n - 3))
    a, b, c = n - 3, n - 2, n - 1
    p = lambda *axes: x.permute(*lead, *axes)
    return (4.0 / 3.0 * x - 2.0 / 3.0 * (p(a, c, b) + p(b, a, c) + p(c, b, a))
            + 1.0 / 3.0 * (p(c, a, b) + p(b, c, a)))


def _block(i0, js, ks, t1, t2, v: cc.Slices, e_o, e_v, Iv, Jo, w) -> dict:
    """The six sums over (i = i0, j in js, k in ks), each (j, k)'s share
    weighted by w[j, k]."""
    Vv, Vo = v.vvov, v.oovo
    dj = lambda x, ax: x.narrow(ax, js.start, js.stop - js.start)
    dk = lambda x, ax: x.narrow(ax, ks.start, ks.stop - ks.start)
    t2_i, t2_ci = t2[i0], t2[:, i0]
    Vv_i, Vo_i0, Vo_i1 = Vv[:, :, i0], Vo[i0], Vo[:, i0]
    Vv_k = dk(Vv, 2)
    t3_D = (es("jaf,cbkf->jkabc", dj(t2_i, 0), Vv_k)
            - es("mba,kjcm->jkabc", t2_ci, dk(dj(Vo, 1), 0))
            + es("jbf,cakf->jkabc", dj(t2_ci, 0), Vv_k)
            - es("mjab,kcm->jkabc", dj(t2, 1), dk(Vo_i1, 0))
            + es("kjcf,abf->jkabc", dk(dj(t2, 1), 0), Vv_i)
            - es("mkbc,jam->jkabc", dk(t2, 1), dj(Vo_i0, 0))
            + es("kaf,bcjf->jkabc", dk(t2_i, 0), dj(Vv, 2))
            - es("mca,jkbm->jkabc", t2_ci, dk(dj(Vo, 0), 1))
            + es("jkbf,acf->jkabc", dk(dj(t2, 0), 1), Vv_i)
            - es("mjcb,kam->jkabc", dj(t2, 1), dk(Vo_i0, 0))
            + es("kcf,bajf->jkabc", dk(t2_ci, 0), dj(Vv, 2))
            - es("mkac,jbm->jkabc", dk(t2, 1), dj(Vo_i1, 0)))
    Iv_i, Jo_i0, Jo_i1 = Iv[:, i0], Jo[i0], Jo[:, i0]
    Iv_k = dk(Iv, 1)
    m3 = (es("jae,ekbc->jkabc", dj(t2_i, 0), Iv_k)
          - es("mba,jkmc->jkabc", t2_ci, dk(dj(Jo, 0), 1))
          + es("jbe,ekac->jkabc", dj(t2_ci, 0), Iv_k)
          - es("mjab,kmc->jkabc", dj(t2, 1), dk(Jo_i0, 0))
          + es("kjce,eba->jkabc", dk(dj(t2, 1), 0), Iv_i)
          - es("mkbc,jma->jkabc", dk(t2, 1), dj(Jo_i1, 0))
          + es("kae,ejcb->jkabc", dk(t2_i, 0), dj(Iv, 1))
          - es("mca,kjmb->jkabc", t2_ci, dk(dj(Jo, 1), 0))
          + es("jkbe,eca->jkabc", dk(dj(t2, 0), 1), Iv_i)
          - es("mjcb,kma->jkabc", dj(t2, 1), dk(Jo_i1, 0))
          + es("kce,ejab->jkabc", dk(t2_ci, 0), dj(Iv, 1))
          - es("mkac,jmb->jkabc", dk(t2, 1), dj(Jo_i0, 0)))
    eo = e_o[i0] + dj(e_o, 0)[:, None] + dk(e_o, 0)[None, :]
    D3 = (eo[:, :, None, None, None] - e_v[None, None, :, None, None]
          - e_v[None, None, None, :, None] - e_v[None, None, None, None, :])
    t3 = t3_D / D3
    tb = xbar_sym(t3)
    del t3
    t1_i, g_i = t1[i0], v.oovv[i0]
    t1_k = dk(t1, 0)
    z3 = (es("a,jkbc->jkabc", t1_i, dk(dj(v.oovv, 0), 1))
          + es("jb,kac->jkabc", dj(t1, 0), dk(g_i, 0))
          + es("kc,jab->jkabc", t1_k, dj(g_i, 0))) / D3
    zb = xbar_sym(z3)
    del z3, D3
    y = (es("a,jb,kc->jkabc", t1_i, dj(t1, 0), t1_k)
         + es("a,jkbc->jkabc", t1_i, dk(dj(t2, 0), 1))
         + es("jb,kac->jkabc", dj(t1, 0), dk(t2_i, 0))
         + es("kc,jab->jkabc", t1_k, dj(t2_i, 0)))
    ws = lambda p, q: torch.sum(torch.sum(p * q, dim=(2, 3, 4)) * w)
    return {"e_T": ws(tb, t3_D), "e_Tz": ws(zb, t3_D), "D_T": ws(tb, y), "D_Tz": ws(zb, y),
            "e_CR": ws(tb, m3), "e_CRz": ws(zb, m3)}


def k_block(o: int, v: int, itemsize: int, cube_bytes: float | None = None) -> int:
    """The largest k-block (a divisor of o) whose (kb, v, v, v) cube
    holds at most `cube_bytes` (default CUBE_BYTES)."""
    cap = max(1, int((cube_bytes or CUBE_BYTES) / (itemsize * v**3)))
    return max(d for d in range(1, min(o, cap) + 1) if o % d == 0)


def triples(res: cc.CCSD, v: cc.Slices, e_o, e_v, e_ccsd: float, Iv, Jo) -> dict:
    """`triples.triples` over i <= j <= k, a (i, j, k-block) at a time,
    each (i, j, k) weighted by its number of distinct orderings, with the
    CR intermediates given: the six correlation energies of the family,
    and D[T], D(T)."""
    o, nv = res.t1.shape
    t1, t2 = res.t1, res.t2
    kb = k_block(o, nv, t1.element_size())
    sums = dict.fromkeys(("e_T", "e_Tz", "D_T", "D_Tz", "e_CR", "e_CRz"), 0.0)
    for i0 in range(o):
        for j0 in range(i0, o):
            for k0 in range(j0, o, kb):
                ks = range(k0, min(k0 + kb, o))
                w = torch.tensor([[(1, 3, 6)[len({i0, j0, k}) - 1] for k in ks]],
                                 dtype=t1.dtype, device=t1.device)
                part = _block(i0, slice(j0, j0 + 1), slice(ks.start, ks.stop), t1, t2, v,
                              e_o, e_v, Iv, Jo, w)
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


# ----------------------------------------------------------------------- run

def run(workdir: str | Path, els: dict, device, dtype=torch.float64,
        lower: dict | None = None) -> dict:
    calc = els["calc_type"]
    if calc not in CALC_TYPES:
        raise ValueError(f"the restricted reference does not run calc_type {calc!r}")
    lower = lower or {}
    if set(lower) - set(STAGES):
        raise ValueError(f"no reference stage {sorted(set(lower) - set(STAGES))}; have {STAGES}")
    corr_dt, triples_dt = lower.get("corr", dtype), lower.get("triples", dtype)
    cr_dt = lower.get("cr", triples_dt)
    d = Path(workdir)
    dev = torch.device(device)
    with no_tf32():
        S_np = files.read_matrix(d / "s.dat")
        n = S_np.shape[0]
        as_t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        S = as_t(S_np)
        H = as_t(files.read_matrix(d / "t.dat") + files.read_matrix(d / "v.dat"))
        charges, coords = files.read_geometry(d / "geom.dat")
        e_nuc = files.nuclear_repulsion(charges, coords)
        nocc = int(round(charges.sum())) // 2
        ao = AOStore(files.packed_eri(d, n), n, dev)

        hf = rhf(S, H, ao, nocc, e_tol=els["scf_e_tol"], d_tol=els["scf_d_tol"],
                 n_errmat=els["scf_diis_n_errmat"], maxiter=els["scf_maxiter"],
                 fock_dtype=lower.get("fock", dtype))
        out = {"e_hf": hf.energy + e_nuc, "scf_iterations": hf.iterations}
        v = ao_to_mo_slices(ao, hf.coeff, nocc)
        del ao
        e_o, e_v = hf.levels[:nocc], hf.levels[nocc:]
        vc = cast_slices(v, corr_dt)
        out["e_mp2"] = cc.mp2_energy(vc, e_o.to(corr_dt), e_v.to(corr_dt))
        if calc == "MP2_spatial":
            return out
        res = cc.ccsd(vc, e_o.to(corr_dt), e_v.to(corr_dt), e_tol=els["ccsd_e_tol"],
                      t_tol=els["ccsd_t_tol"], n_errmat=els["ccsd_diis_n_errmat"],
                      maxiter=els["ccsd_maxiter"])
        del vc
        out.update(e_ccsd=res.energy, cc_iterations=res.iterations)
        if calc == "CCSD_spatial":
            return out
        # the CR chain in cr_dt, its one v_vvvv contraction first,
        # es("ecba,ie->ciab", v_vvvv, t1) as one GEMM over v_vvvv's (e, cba)
        # matricisation (the einsum would copy v_vvvv), then v_vvvv goes
        cc_cr = cc.cast_ccsd(res, cr_dt)
        nv = n - nocc
        vvvv_term = (cc_cr.t1 @ v.vvvv.to(cr_dt).view(nv, -1)).view(nocc, nv, nv, nv)
        vvvv_term = vvvv_term.permute(1, 0, 3, 2)
        v.vvvv = None
        Iv, Jo = cr_intermediates(cc_cr, cast_slices(v, cr_dt), nocc, vvvv_term)
        del vvvv_term, cc_cr
        vt = cast_slices(v, triples_dt)
        del v
        out.update(triples(cc.cast_ccsd(res, triples_dt), vt, e_o.to(triples_dt),
                           e_v.to(triples_dt), res.energy, Iv.to(triples_dt),
                           Jo.to(triples_dt)))
        return out
