"""The plain reference of the spin-orbital calculation types: RHF, MP2,
spin-orbital CCSD and its (T), from a run directory's input files
(`files.py`), in one dtype on one device.

`run(workdir, els, device, dtype, lower)` returns what `rccsd_t.run`
returns for the same stages: "e_hf" (the RHF total energy), "e_mp2" and
"e_ccsd" (correlation energies), for CCSD(T)_spinorb "e_ccsd_tt" (the
CCSD(T) correlation energy), and the SCF and CC iteration counts.  TF32
is switched off while it runs.  It imports nothing of the program and
reads nothing the program wrote.

The spin orbitals are interleaved, 2P + spin, within the occupied and
the virtual space (the reference code's order); each antisymmetrised
slice <pq||rs> = <pq|rs> - <pq|sr> is built from the spatial MO tensor
by setting its spin blocks, vvvv dense.  CCSD follows Stanton, Gauss,
Watts and Bartlett, J. Chem. Phys. 94, 4334 (1991), with canonical
orbitals (no off-diagonal Fock terms), its W_abef contracted
term by term so that no second v^4 tensor is made.  One departure, set
by `ccsd_spinorb_equations`: with "code" (the default) the tau~ term of
F_mi contracts 0.5 tau~[m,n,e,f] <in||ef>, as the reference code does
(ccsd.f90:792-795); with "paper" it is the paper's 0.5 tau~[i,n,e,f]
<mn||ef>.  The iteration starts from the MP1 amplitudes and runs the
reference code's DIIS, `cc.ccsd`'s scheme (the last ccsd_diis_n_errmat
amplitude vectors, the error the change from the amplitudes fed in;
converged when the T2 change's norm is below ccsd_t_tol and the energy
change below ccsd_e_tol, returning the last unextrapolated update) with
two details the iteration count depends on near convergence: the vectors
are a ring in slot order, and a bordered system singular to working
precision keeps the update unextrapolated.

(T) is E(T) = sum t3c (t3c + t3d) / D / 36 over (i, j, k) and (a, b, c)
(ccsd.f90:1868-1914), with D t3c = P(i/jk) P(a/bc) [sum_e t_jkae <ei||bc>
- sum_m t_imbc <ma||jk>] and D t3d = P(i/jk) P(a/bc) t_ia <jk||bc>.  The
summand is symmetric under permutations of (i, j, k) and vanishes where
two coincide, so `strict` sums i<j<k with weight 6; a chunk of triples
at a time, by `torch.einsum` in the given dtype.

`lower` puts single stages in another dtype, each stage's results
entering the next in `dtype`: "fock" the SCF's J/K build, "corr" MP2 and
CCSD, "triples" the (T).
"""

from __future__ import annotations

import dataclasses
import itertools
from pathlib import Path

import torch

from . import cc, files, scf
from .rccsd_t import no_tf32

CALC_TYPES = ("MP2_spinorb", "CCSD_spinorb", "CCSD(T)_spinorb")
STAGES = ("fock", "corr", "triples")
SLICES = ("oooo", "ooov", "oovo", "ovoo", "oovv", "ovov", "ovvo", "ovvv", "vovv", "vvvo",
          "vvvv")

es = torch.einsum


@dataclasses.dataclass
class SpinSlices:
    """<pq||rs> over spin orbitals; o occupied, v virtual."""

    oooo: torch.Tensor
    ooov: torch.Tensor
    oovo: torch.Tensor
    ovoo: torch.Tensor
    oovv: torch.Tensor
    ovov: torch.Tensor
    ovvo: torch.Tensor
    ovvv: torch.Tensor
    vovv: torch.Tensor
    vvvo: torch.Tensor
    vvvv: torch.Tensor


def antisymmetrised(mo: torch.Tensor, o: int, blocks: str) -> torch.Tensor:
    """<pq||rs> for the spaces `blocks` (e.g. "oovv") from the spatial
    chemist tensor (PQ|RS) with o occupied orbitals:
    <pq|rs> = (PR|QS) d(s_p, s_r) d(s_q, s_s), less <pq|sr>."""
    space = {"o": slice(None, o), "v": slice(o, None)}
    s0, s1, s2, s3 = (space[b] for b in blocks)
    direct = mo.permute(0, 2, 1, 3)[s0, s1, s2, s3]    # <PQ|RS> = (PR|QS)
    exchange = mo.permute(0, 2, 3, 1)[s0, s1, s2, s3]  # <PQ|SR> = (PS|QR)
    n = direct.shape
    out = mo.new_zeros((n[0], 2, n[1], 2, n[2], 2, n[3], 2))
    for s, t in itertools.product((0, 1), repeat=2):
        out[:, s, :, t, :, s, :, t] += direct
        out[:, s, :, t, :, t, :, s] -= exchange
    return out.reshape(2 * n[0], 2 * n[1], 2 * n[2], 2 * n[3])


def spin_slices(mo: torch.Tensor, o: int) -> SpinSlices:
    return SpinSlices(**{name: antisymmetrised(mo, o, name) for name in SLICES})


def cast(v: SpinSlices, dtype: torch.dtype) -> SpinSlices:
    return SpinSlices(*(getattr(v, f.name).to(dtype) for f in dataclasses.fields(v)))


def denominators(e_o, e_v):
    D1 = e_o[:, None] - e_v[None, :]
    D2 = D1[:, None, :, None] + D1[None, :, None, :]
    return D1, D2


def antisym_pair(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """x - x with axes a and b exchanged: the permutation operator P(ab)."""
    return x - x.transpose(a, b)


def energy(t1, t2, g: SpinSlices) -> torch.Tensor:
    """E = 1/4 sum <ij||ab> t_ijab + 1/2 sum <ij||ab> t_ia t_jb."""
    return 0.25 * torch.sum(g.oovv * t2) + 0.5 * torch.sum(g.oovv * es("ia,jb->ijab", t1, t1))


def update(t1, t2, g: SpinSlices, D1, D2, paper: bool):
    """One T1/T2 update (Stanton et al.'s T1 and T2 equations with their
    F and W intermediates)."""
    t1t1 = es("ia,jb->ijab", t1, t1)
    tau_t = t2 + 0.5 * antisym_pair(t1t1, 2, 3)
    tau = t2 + antisym_pair(t1t1, 2, 3)

    F_ae = es("mf,mafe->ae", t1, g.ovvv) - 0.5 * es("mnaf,mnef->ae", tau_t, g.oovv)
    if paper:
        foo_tau = es("inef,mnef->mi", tau_t, g.oovv)
    else:  # ccsd.f90:792-795
        foo_tau = es("mnef,inef->mi", tau_t, g.oovv)
    F_mi = es("ne,mnie->mi", t1, g.ooov) + 0.5 * foo_tau
    F_me = es("nf,mnef->me", t1, g.oovv)
    # Y_ijmn = sum_ef tau_ijef <mn||ef>: W_mnij's tau term, and through
    # tau_mnab that of W_abef
    Y = es("ijef,mnef->ijmn", tau, g.oovv)
    W_mnij = g.oooo + antisym_pair(es("je,mnie->mnij", t1, g.ooov), 2, 3) \
        + 0.25 * Y.permute(2, 3, 0, 1)
    W_mbej = (g.ovvo + es("jf,mbef->mbej", t1, g.ovvv) - es("nb,mnej->mbej", t1, g.oovo)
              - es("jnfb,mnef->mbej", 0.5 * t2 + es("jf,nb->jnfb", t1, t1), g.oovv))

    r1 = (es("ie,ae->ia", t1, F_ae) - es("ma,mi->ia", t1, F_mi)
          + es("imae,me->ia", t2, F_me) - es("nf,naif->ia", t1, g.ovov)
          - 0.5 * es("imef,maef->ia", t2, g.ovvv)
          - 0.5 * es("mnae,nmei->ia", t2, g.oovo))

    r2 = g.oovv.clone()
    r2 += antisym_pair(es("ijae,be->ijab", t2, F_ae - 0.5 * es("mb,me->be", t1, F_me)), 2, 3)
    r2 -= antisym_pair(es("imab,mj->ijab", t2, F_mi + 0.5 * es("je,me->mj", t1, F_me)), 0, 1)
    r2 += 0.5 * es("mnab,mnij->ijab", tau, W_mnij)
    # 0.5 sum_ef tau_ijef W_abef, W_abef = <ab||ef> - P(ab) t_mb <am||ef>
    # + 1/4 tau_mnab <mn||ef>, a term at a time
    o, v = t1.shape
    r2 += 0.5 * (tau.reshape(o * o, v * v) @ g.vvvv.reshape(v * v, v * v).T).reshape(o, o, v, v)
    r2 -= 0.5 * antisym_pair(es("mb,ijam->ijab", t1, es("ijef,amef->ijam", tau, g.vovv)), 2, 3)
    r2 += 0.125 * es("mnab,ijmn->ijab", tau, Y)
    ring = es("imae,mbej->ijab", t2, W_mbej) \
        - es("imbj,ma->ijab", es("ie,mbej->imbj", t1, g.ovvo), t1)
    r2 += antisym_pair(antisym_pair(ring, 0, 1), 2, 3)
    r2 += antisym_pair(es("ie,abej->ijab", t1, g.vvvo), 0, 1)
    r2 -= antisym_pair(es("ma,mbij->ijab", t1, g.ovoo), 2, 3)
    return r1 / D1, r2 / D2


def ccsd(g: SpinSlices, e_o, e_v, *, paper: bool, e_tol: float, t_tol: float,
         n_errmat: int, maxiter: int) -> cc.CCSD:
    """The DIIS-accelerated iteration, `cc.ccsd`'s scheme on the
    spin-orbital equations."""
    D1, D2 = denominators(e_o, e_v)
    t1 = torch.zeros_like(D1)
    t2 = g.oovv / D2
    e_old = float(energy(t1, t2, g))
    t2_old = t2
    hist_T, hist_E = [], []
    for it in range(1, maxiter + 1):
        t1n, t2n = update(t1, t2, g, D1, D2, paper)
        e = float(energy(t1n, t2n, g))
        rms = float(torch.sqrt(torch.sum((t2n - t2_old) ** 2)))
        new = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        # a ring of the last n_errmat vectors, in slot order
        slot = (it - 1) % n_errmat
        err = new - torch.cat([t1.reshape(-1), t2.reshape(-1)])
        if slot < len(hist_T):
            hist_T[slot], hist_E[slot] = new, err
        else:
            hist_T.append(new)
            hist_E.append(err)
        t1_fed, t2_fed = t1, t2
        if rms < t_tol and abs(e - e_old) < e_tol:
            return cc.CCSD(e, t1n, t2n, t1_fed, t2_fed, it, True)
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
            # a system singular to working precision (its smallest
            # partial-pivoting pivot at most (n_errmat + 1) eps max|B|, as
            # the reference code's guard has it) keeps the update as it is
            lu, pivots, info = torch.linalg.lu_factor_ex(B)
            tiny = (n_errmat + 1) * torch.finfo(B.dtype).eps * float(B.abs().max())
            if int(info) == 0 and float(lu.diagonal().abs().min()) > tiny:
                c = torch.linalg.lu_solve(lu, pivots, rhs[:, None])[:, 0]
                flat = c[:n] @ torch.stack(hist_T)
                t1 = flat[:t1.numel()].reshape(t1.shape)
                t2 = flat[t1.numel():].reshape(t2.shape)
    return cc.CCSD(e, t1n, t2n, t1_fed, t2_fed, maxiter, False)


def p_abc(x: torch.Tensor) -> torch.Tensor:
    """P(a/bc) over the last three axes: x - x(bac) - x(cba)."""
    return x - x.transpose(-3, -2) - x.transpose(-3, -1)


def _triples_chunk(I, J, K, t1, t2, vovv, ovoo, oovv, e_o, e_v) -> torch.Tensor:
    """sum over the chunk's triples (I, J, K index tensors) and every
    (a, b, c) of t3c (t3c + t3d) / D."""
    def connected(i, j, k):
        return (es("Cae,eCbc->Cabc", t2[j, k], vovv[:, i])
                - es("Cmbc,mCa->Cabc", t2[i], ovoo[:, :, j, k].permute(0, 2, 1)))

    def disconnected(i, j, k):
        return es("Ca,Cbc->Cabc", t1[i], oovv[j, k])

    def p_ijk(f):  # P(i/jk) f(i, j, k) = f(ijk) - f(jik) - f(kji)
        return f(I, J, K) - f(J, I, K) - f(K, J, I)

    t3c, t3d = p_abc(p_ijk(connected)), p_abc(p_ijk(disconnected))
    D = ((e_o[I] + e_o[J] + e_o[K])[:, None, None, None] - e_v[:, None, None]
         - e_v[None, :, None] - e_v[None, None, :])
    return torch.sum(t3c * (t3c + t3d) / D)


def triples(t1, t2, vovv, ovoo, oovv, e_o, e_v, strict: bool = True,
            budget: float = 8e9) -> float:
    """E(T) from <ei||bc>, <ma||jk> and <jk||bc>; `strict` sums i<j<k
    with weight 6, else the whole cube."""
    o, v = t1.shape
    r = torch.arange(o, device=t1.device)
    I, J, K = (x.reshape(-1) for x in torch.meshgrid(r, r, r, indexing="ij"))
    if strict:
        keep = (I < J) & (J < K)
        I, J, K = I[keep], J[keep], K[keep]
    # ~12 live (chunk, v, v, v) transients
    chunk = max(1, int(budget / (12 * t1.element_size() * v**3)))
    total = t1.new_zeros(())
    for c0 in range(0, len(I), chunk):
        sl = slice(c0, c0 + chunk)
        total = total + _triples_chunk(I[sl], J[sl], K[sl], t1, t2, vovv, ovoo, oovv,
                                       e_o, e_v)
    return float(total) * (6.0 if strict else 1.0) / 36.0


def run(workdir: str | Path, els: dict, device, dtype=torch.float64,
        lower: dict | None = None) -> dict:
    calc = els["calc_type"]
    if calc not in CALC_TYPES:
        raise ValueError(f"the spin-orbital reference does not run calc_type {calc!r}")
    lower = lower or {}
    if set(lower) - set(STAGES):
        raise ValueError(f"no reference stage {sorted(set(lower) - set(STAGES))}; have {STAGES}")
    equations = els.get("ccsd_spinorb_equations", "code")
    if equations not in ("code", "paper"):
        raise ValueError(f"ccsd_spinorb_equations must be 'code' or 'paper', not {equations!r}")
    corr_dt, triples_dt = lower.get("corr", dtype), lower.get("triples", dtype)
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
        eri = files.dense_eri(files.packed_eri(d, n), n, dev, dtype)

        hf = scf.rhf(S, H, eri, nocc, e_tol=els["scf_e_tol"], d_tol=els["scf_d_tol"],
                     n_errmat=els["scf_diis_n_errmat"], maxiter=els["scf_maxiter"],
                     fock_dtype=lower.get("fock"))
        out = {"e_hf": hf.energy + e_nuc, "scf_iterations": hf.iterations}
        mo = cc.ao_to_mo(eri, hf.coeff)
        del eri
        g = spin_slices(mo, nocc)
        del mo
        levels = hf.levels.repeat_interleave(2)
        e_o, e_v = levels[:2 * nocc], levels[2 * nocc:]
        gc_ = cast(g, corr_dt)
        eo_c, ev_c = e_o.to(corr_dt), e_v.to(corr_dt)
        D1, D2 = denominators(eo_c, ev_c)
        out["e_mp2"] = float(0.25 * torch.sum(gc_.oovv**2 / D2))
        del D1, D2
        if calc == "MP2_spinorb":
            return out
        res = ccsd(gc_, eo_c, ev_c, paper=equations == "paper", e_tol=els["ccsd_e_tol"],
                   t_tol=els["ccsd_t_tol"], n_errmat=els["ccsd_diis_n_errmat"],
                   maxiter=els["ccsd_maxiter"])
        del gc_
        out.update(e_ccsd=res.energy, cc_iterations=res.iterations)
        if calc == "CCSD_spinorb":
            return out
        vovv, ovoo, oovv = (getattr(g, k).to(triples_dt) for k in ("vovv", "ovoo", "oovv"))
        del g
        e_t = triples(res.t1.to(triples_dt), res.t2.to(triples_dt), vovv, ovoo, oovv,
                      e_o.to(triples_dt), e_v.to(triples_dt))
        out["e_ccsd_tt"] = res.energy + e_t
        return out
