"""Gaussian-integral engine (McMurchie-Davidson) in torch: the benchmark's
frozen copy of `afesp_tpu_torch/integrals/engine.py`.

It makes the one-electron matrices and the packed ERI store of every
benchmark input, so that a later change to the program's engine cannot
move the inputs the benchmark measures.  It imports nothing of the
program: the helper it took from there (`default_device`) is defined
below.  Conventions as in the program: Hermite
expansion after McMurchie & Davidson, JCP 26, 218 (1978);
Cartesian->spherical transform after Schlegel & Frisch, IJQC 54, 83
(1995); spherical order m = 0, +1, -1, +2, -2, ...; alphabetic Cartesian
order; contracted functions of unit self-overlap; a class of shell
quartets a vectorised pass; Schwarz screening at 1e-13; the ERIs land in
the 8-fold packed store (reference `eri_ind` order).  Everything is f64.
Only what the input maker calls is kept: the bases, `overlap`,
`kinetic`, `nuclear` and `eri_packed`.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from .basis_data import BASIS_SETS, ELEMENTS

F64 = torch.float64


def default_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> `cuda:0`, raising when no card is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu'")
        return torch.device("cuda", 0)
    return torch.device(device)


# bytes of the largest temporaries of one ERI chunk (the R tables and
# the window), by device type
CHUNK_BYTES = {"cuda": 1 << 30}
CHUNK_BYTES_DEFAULT = 1 << 27
SCHWARZ_SCREEN = 1e-13


# --------------------------------------------------------------------------
# shells and basis construction (host numpy, as in the JAX engine)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Shell:
    l: int
    center: np.ndarray  # (3,)
    exps: np.ndarray  # (K,)
    coefs: np.ndarray  # (K,) contraction coefficients incl. all normalisation


@dataclasses.dataclass
class BasisSet:
    shells: list
    nbf: int  # spherical basis functions
    offsets: list  # starting spherical index per shell


def _double_fact(n: int) -> int:
    if n <= 0:
        return 1
    out = 1
    while n > 0:
        out *= n
        n -= 2
    return out


def _prim_norm(alpha: float, l: int) -> float:
    """Normalisation of the (l,0,0) Cartesian primitive."""
    return (
        (2.0 * alpha / np.pi) ** 0.75
        * (4.0 * alpha) ** (l / 2.0)
        / math.sqrt(_double_fact(2 * l - 1))
    )


def _basis_table(basis_name: str):
    name = basis_name.lower()
    if name.startswith("fixture-"):
        from . import fixture_basis

        return {
            "fixture-def2-svp": fixture_basis.FIXTURE_DEF2_SVP,
            "fixture-cc-pvtz": fixture_basis.FIXTURE_CC_PVTZ,
        }[name]
    return BASIS_SETS[name]


def build_basis(charges, coords, basis_name: str) -> BasisSet:
    data = _basis_table(basis_name)
    shells = []
    offsets = []
    nbf = 0
    for Z, R in zip(charges, coords):
        elem = ELEMENTS[int(Z)]
        for l, prims in data[elem]:
            exps = np.array([e for e, _ in prims])
            coefs = np.array([c for _, c in prims]) * np.array(
                [_prim_norm(e, l) for e, _ in prims]
            )
            # normalise the contracted (l,0,0) function to unit self-overlap
            ee = exps[:, None] + exps[None, :]
            s = (
                np.pi**1.5
                * _double_fact(2 * l - 1)
                / 2.0**l
                * np.sum(coefs[:, None] * coefs[None, :] / ee ** (l + 1.5))
            )
            coefs = coefs / math.sqrt(s)
            shells.append(Shell(l, np.asarray(R, float), exps, coefs))
            offsets.append(nbf)
            nbf += 2 * l + 1
    return BasisSet(shells, nbf, offsets)


# --------------------------------------------------------------------------
# Cartesian monomials and the spherical transformation (host numpy)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def cart_components(l: int):
    """Alphabetic Cartesian ordering (CCA): e.g. l=2 -> xx,xy,xz,yy,yz,zz."""
    return [
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    ]


def _binom(n, k):
    if k < 0 or k > n:
        return 0
    return math.comb(n, k)


@lru_cache(maxsize=None)
def c2s_matrix(l: int) -> np.ndarray:
    """Spherical(2l+1) x Cartesian(ncart) transformation (Schlegel-Frisch
    eq. 15), rows ordered m = 0, +1, -1, +2, -2, ..., with the per-
    component Cartesian normalisation ratio folded in (the engine's
    Cartesian integrals are over primitives normalised as (l,0,0))."""
    ncart = (l + 1) * (l + 2) // 2
    mat = np.zeros((2 * l + 1, ncart))
    rows = [0]
    for m in range(1, l + 1):
        rows += [m, -m]
    for row, m in enumerate(rows):
        am = abs(m)
        for ci, (lx, ly, lz) in enumerate(cart_components(l)):
            jj = lx + ly - am
            if jj < 0 or jj % 2:
                continue
            j = jj // 2
            pref = math.sqrt(
                (
                    math.factorial(2 * lx)
                    * math.factorial(2 * ly)
                    * math.factorial(2 * lz)
                    * math.factorial(l)
                    * math.factorial(l - am)
                )
                / (
                    math.factorial(lx)
                    * math.factorial(ly)
                    * math.factorial(lz)
                    * math.factorial(2 * l)
                    * math.factorial(l + am)
                )
            ) / (2.0**l * math.factorial(l))
            s1 = 0.0
            for i in range((l - am) // 2 + 1):
                if j > i:
                    continue
                t1 = (
                    _binom(l, i)
                    * _binom(i, j)
                    * (-1) ** i
                    * math.factorial(2 * l - 2 * i)
                    / math.factorial(l - am - 2 * i)
                )
                s2 = 0.0
                for k in range(j + 1):
                    ex = am - lx + 2 * k
                    if m >= 0:
                        # cosine part: ex even
                        if ex % 2 == 0:
                            sgn = (-1.0) ** (ex // 2)
                            s2 += _binom(j, k) * _binom(am, lx - 2 * k) * sgn
                    else:
                        # sine part: ex odd
                        if ex % 2 == 1:
                            sgn = (-1.0) ** ((ex - 1) // 2)
                            s2 += _binom(j, k) * _binom(am, lx - 2 * k) * sgn
                s1 += t1 * s2
            c = pref * s1
            if m != 0:
                c *= math.sqrt(2.0)
            mat[row, ci] = c
    for ci, (lx, ly, lz) in enumerate(cart_components(l)):
        ratio = math.sqrt(
            _double_fact(2 * l - 1)
            / (
                _double_fact(2 * lx - 1)
                * _double_fact(2 * ly - 1)
                * _double_fact(2 * lz - 1)
            )
        )
        mat[:, ci] *= ratio
    return mat


# --------------------------------------------------------------------------
# Hermite expansion coefficients, Boys function, Hermite integrals
# --------------------------------------------------------------------------


def hermite_E(la: int, lb: int, a: torch.Tensor, b: torch.Tensor, AB: torch.Tensor):
    """E[i, j, t] Hermite expansion tables for one dimension, batched:
    a, b, AB broadcast to one shape S.  Returns (la+1, lb+1, la+lb+1) + S,
    zero where t > i + j.  The recursion of the JAX engine's `hermite_E`,
    with the t axis of each (i, j) step in one operation."""
    p = a + b
    q = a * b / p
    shape = torch.broadcast_shapes(a.shape, b.shape, AB.shape)
    E = torch.zeros((la + 1, lb + 1, la + lb + 1) + shape, dtype=F64, device=AB.device)
    E[0, 0, 0] = torch.exp(-q * AB * AB)
    XPA = -b / p * AB  # P - A
    XPB = a / p * AB  # P - B
    inv2p = 1.0 / (2.0 * p)
    tail = (1,) * len(shape)
    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            # built from (i-1, 0) when j == 0, else from (i, j-1)
            prev, X, m = (E[i - 1, 0], XPA, i) if j == 0 else (E[i, j - 1], XPB, i + j)
            v = X * prev[: m + 1]
            v[1:] += inv2p * prev[:m]
            if m >= 2:
                t1 = torch.arange(1, m, dtype=F64, device=AB.device).reshape((m - 1,) + tail)
                v[: m - 1] += t1 * prev[1:m]
            E[i, j, : m + 1] = v
    return E


def boys(nmax: int, T: torch.Tensor) -> torch.Tensor:
    """F_n(T) for n = 0..nmax, vectorised over T: F_nmax from the
    regularised lower incomplete gamma function, then the downward
    recursion; T < 1e-13 takes the limit 1/(2n+1).  (nmax+1,) + T.shape."""
    out = torch.empty((nmax + 1,) + T.shape, dtype=F64, device=T.device)
    small = T < 1e-13
    Ts = torch.where(small, torch.ones_like(T), T)
    nn = nmax + 0.5
    Fn = torch.special.gammainc(torch.full_like(Ts, nn), Ts) * math.gamma(nn) / (2.0 * Ts**nn)
    out[nmax] = torch.where(small, torch.full_like(T, 1.0 / (2 * nmax + 1)), Fn)
    expT = torch.exp(-Ts)
    for n in range(nmax - 1, -1, -1):
        Fn = (2.0 * Ts * out[n + 1] + expT) / (2 * n + 1)
        out[n] = torch.where(small, torch.full_like(T, 1.0 / (2 * n + 1)), Fn)
    return out


@lru_cache(maxsize=None)
def simplex(L: int) -> tuple:
    """Every (t, u, v) with t + u + v <= L, ordered by t + u + v."""
    return tuple(
        (t, u, s - t - u)
        for s in range(L + 1)
        for t in range(s, -1, -1)
        for u in range(s - t, -1, -1)
    )


@lru_cache(maxsize=None)
def _simplex_pos(L: int) -> dict:
    return {x: k for k, x in enumerate(simplex(L))}


@lru_cache(maxsize=None)
def _r_levels(L: int) -> tuple:
    """The recursion of `hermite_R` by total degree s = t+u+v: for each
    s, the rows of that degree (contiguous in `simplex(L)`), the axis each
    is stepped along (x if t > 0, else y if u > 0, else z, as the JAX
    engine chooses), the rows one and two steps back along it, and the
    coefficient of the second (0 where there is none)."""
    tuv = simplex(L)
    pos = _simplex_pos(L)
    levels = []
    for s in range(1, L + 1):
        rows = [k for k, x in enumerate(tuv) if sum(x) == s]
        axis, back1, back2, coef = [], [], [], []
        for k in rows:
            x = list(tuv[k])
            d = 0 if x[0] > 0 else (1 if x[1] > 0 else 2)
            c = x[d] - 1
            x1 = list(x)
            x1[d] -= 1
            x2 = list(x)
            x2[d] -= 2
            axis.append(d)
            back1.append(pos[tuple(x1)])
            back2.append(pos[tuple(x2)] if c > 0 else pos[tuple(x1)])
            coef.append(float(max(c, 0)))
        levels.append((s, rows[0], rows[-1] + 1, axis, back1, back2, coef))
    return tuple(levels)


@lru_cache(maxsize=None)
def _r_plan(L: int, dev: torch.device) -> tuple:
    """`_r_levels(L)` as index tensors on `dev`, made once."""
    out = []
    for s, r0, r1, axis, back1, back2, coef in _r_levels(L):
        t = lambda x: torch.as_tensor(x, device=dev)
        cf = torch.as_tensor(coef, dtype=F64, device=dev) if any(coef) else None
        out.append((s, r0, r1, t(axis), t(back1), t(back2), cf))
    return tuple(out)


def hermite_R(L: int, alpha: torch.Tensor, PC: torch.Tensor) -> torch.Tensor:
    """Hermite Coulomb integrals R_{tuv} (n = 0) for a batch: alpha (N,),
    PC (N, 3).  Returns (N, M) over `simplex(L)`.  The auxiliary
    recursion of the JAX engine's `hermite_R_batched`, one total degree
    a step, every entry of that degree and every order n in one
    operation."""
    N = alpha.shape[0]
    M = len(simplex(L))
    T = alpha * (PC * PC).sum(-1)
    F = boys(L, T)  # (L+1, N)
    R = torch.zeros((N, M, L + 1), dtype=F64, device=alpha.device)
    m2p = (-2.0 * alpha).expand(L + 1, N)
    pw = torch.cumprod(m2p, 0) / (-2.0 * alpha)  # (-2 alpha)^n
    R[:, 0, :] = (pw * F).T
    for s, r0, r1, axis, back1, back2, cf in _r_plan(L, alpha.device):
        top = L - s + 1  # orders n = 0 .. L-s
        val = PC[:, axis][:, :, None] * R[:, back1, 1 : top + 1]
        if cf is not None:
            val = val + cf[None, :, None] * R[:, back2, 1 : top + 1]
        R[:, r0:r1, :top] = val
    return R[:, :, 0]


@lru_cache(maxsize=None)
def _window(Lab: int, Lcd: int, dev: torch.device) -> torch.Tensor:
    """(ntuv, nxyz) positions of (t+x, u+y, v+z) in simplex(Lab+Lcd)."""
    pos = _simplex_pos(Lab + Lcd)
    return torch.as_tensor([[pos[(t + x, u + y, v + z)] for (x, y, z) in simplex(Lcd)]
                            for (t, u, v) in simplex(Lab)], device=dev)


@lru_cache(maxsize=None)
def _component_index(la: int, lb: int, lc: int, dev: torch.device) -> tuple:
    """Index tensors (into a (la+1, lb+1, lc+1) E table, a triple per
    axis) of the products E_x[ax,bx,t] E_y[ay,by,u] E_z[az,bz,v] over the
    Cartesian pairs (a, b) and (t, u, v) in simplex(lc)."""
    idx = [[], [], []]
    for a in cart_components(la):
        for b in cart_components(lb):
            for tuv in simplex(lc):
                for d in range(3):
                    idx[d].append((a[d], b[d], tuv[d]))
    return tuple(torch.as_tensor(np.array(x).T, device=dev) for x in idx)


def _hermite_products(E: torch.Tensor, la: int, lb: int) -> torch.Tensor:
    """E_x E_y E_z of every Cartesian pair and (t, u, v) in
    simplex(la+lb), from the tables E (la+1, lb+1, L+1, ..., 3):
    (nab * ntuv, ...)."""
    ix, iy, iz = _component_index(la, lb, la + lb, E.device)
    return (E[ix[0], ix[1], ix[2], ..., 0] * E[iy[0], iy[1], iy[2], ..., 1]
            * E[iz[0], iz[1], iz[2], ..., 2])


# --------------------------------------------------------------------------
# shell pairs, stacked by class
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PairClass:
    """Every shell pair (i >= j) with one (l_a, l_b, K_a, K_b), stacked:
    `p` (P, B) and `P` (P, B, 3) over the B = K_a K_b primitive pairs,
    and the Hermite tables with contraction coefficients folded in, for
    the bra (P, nab, B, ntuv) and, signed by (-1)^(t+u+v), the ket
    (P, B, ntuv, nab): spherical in `bra`/`ket`, Cartesian in
    `bra_cart`/`ket_cart` (the Schwarz bound's diagonal quartets)."""

    la: int
    lb: int
    pairs: np.ndarray  # (P,) positions in the engine's pair list
    ish: np.ndarray  # (P,) shell index of a
    jsh: np.ndarray  # (P,) shell index of b
    p: torch.Tensor
    P: torch.Tensor
    bra: torch.Tensor
    ket: torch.Tensor
    bra_cart: torch.Tensor | None
    ket_cart: torch.Tensor | None


def _stack_pairs(shells, pairs, dev):
    """(exps a, exps b, coefs a, coefs b, A, B) of a pair class, stacked:
    exponents and coefficients (P, K_a, K_b), centres (P, 3)."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=F64, device=dev)
    ea = t([shells[i].exps for i, _ in pairs])[:, :, None]
    eb = t([shells[j].exps for _, j in pairs])[:, None, :]
    da = t([shells[i].coefs for i, _ in pairs])[:, :, None]
    db = t([shells[j].coefs for _, j in pairs])[:, None, :]
    A = t([shells[i].center for i, _ in pairs])
    Bc = t([shells[j].center for _, j in pairs])
    return ea, eb, da, db, A, Bc


def _pair_class(shells, pair_pos, pairs, dev, cart: bool) -> PairClass:
    la, lb = shells[pairs[0][0]].l, shells[pairs[0][1]].l
    L = la + lb
    ea, eb, da, db, A, Bc = _stack_pairs(shells, pairs, dev)
    Pn = len(pairs)
    ea, eb = ea.expand(-1, -1, eb.shape[2]), eb.expand(-1, ea.shape[1], -1)
    p = (ea + eb).reshape(Pn, -1)
    AB = (A - Bc)[:, None, None, :]
    Pc = (ea[..., None] * A[:, None, None, :] + eb[..., None] * Bc[:, None, None, :]) / (
        ea + eb)[..., None]
    E = hermite_E(la, lb, ea[..., None], eb[..., None], AB)  # (la+1, lb+1, L+1, P, Ka, Kb, 3)
    prod = _hermite_products(E.reshape(E.shape[:3] + (Pn, -1, 3)), la, lb)
    nab = len(cart_components(la)) * len(cart_components(lb))
    ntuv = len(simplex(L))
    coef = (da * db).reshape(Pn, -1)  # (P, B)
    cartE = prod.reshape(nab, ntuv, Pn, -1).permute(2, 0, 3, 1) * coef[:, None, :, None]
    K = torch.as_tensor(np.kron(c2s_matrix(la), c2s_matrix(lb)), dtype=F64, device=dev)
    sphE = torch.einsum("sc,pcbt->psbt", K, cartE)
    sgn = torch.as_tensor([(-1.0) ** sum(x) for x in simplex(L)], dtype=F64, device=dev)
    ket = lambda X: (X * sgn).permute(0, 2, 3, 1).contiguous()
    return PairClass(
        la=la, lb=lb, pairs=np.asarray(pair_pos), ish=np.array([i for i, _ in pairs]),
        jsh=np.array([j for _, j in pairs]), p=p, P=Pc.reshape(Pn, -1, 3),
        bra=sphE.contiguous(), ket=ket(sphE),
        bra_cart=cartE.contiguous() if cart else None, ket_cart=ket(cartE) if cart else None,
    )


def _pair_groups(shells) -> tuple[list, list]:
    """The shell-pair list [(i, j), i >= j] (the JAX engine's order) and
    the positions in it of each pair class (l_a, l_b, K_a, K_b)."""
    pair_list = [(i, j) for i in range(len(shells)) for j in range(i + 1)]
    groups: dict = {}
    for pos, (i, j) in enumerate(pair_list):
        key = (shells[i].l, shells[j].l, len(shells[i].exps), len(shells[j].exps))
        groups.setdefault(key, []).append(pos)
    return pair_list, list(groups.values())


def pair_classes(basis: BasisSet, dev, cart: bool = True) -> tuple[list, list]:
    """The engine's shell-pair list and its pair classes."""
    pair_list, groups = _pair_groups(basis.shells)
    classes = [_pair_class(basis.shells, pos, [pair_list[k] for k in pos], dev, cart)
               for pos in groups]
    return pair_list, classes


# --------------------------------------------------------------------------
# two-electron integrals
# --------------------------------------------------------------------------


def _quartet_bytes(bra: PairClass, ket: PairClass) -> int:
    """Bytes of the largest temporaries a quartet of this class needs:
    its R tables during the recursion and its window."""
    L = bra.la + bra.lb + ket.la + ket.lb
    nprim = bra.p.shape[1] * ket.p.shape[1]
    ntuv, nxyz = len(simplex(bra.la + bra.lb)), len(simplex(ket.la + ket.lb))
    return 8 * nprim * (len(simplex(L)) * (L + 2) + 2 * ntuv * nxyz + 8)


def eri_quartets(bra: PairClass, ket: PairClass, bi: torch.Tensor, ki: torch.Tensor,
                 cart: bool = False) -> torch.Tensor:
    """ERI blocks (Q, nab, ncd) of the quartets (bra pair bi[q] | ket pair
    ki[q]), spherical (or Cartesian with `cart`): one vectorised pass."""
    Lab, Lcd = bra.la + bra.lb, ket.la + ket.lb
    L = Lab + Lcd
    Q = bi.shape[0]
    p, P = bra.p[bi], bra.P[bi]  # (Q, Bab), (Q, Bab, 3)
    q, Qc = ket.p[ki], ket.P[ki]  # (Q, Bcd), (Q, Bcd, 3)
    Bab, Bcd = p.shape[1], q.shape[1]
    pq = p[:, :, None] * q[:, None, :]
    psum = p[:, :, None] + q[:, None, :]
    alpha = (pq / psum).reshape(-1)
    PQ = (P[:, :, None, :] - Qc[:, None, :, :]).reshape(-1, 3)
    fac = (2.0 * math.pi**2.5 / (pq * torch.sqrt(psum))).reshape(-1, 1)
    R = (hermite_R(L, alpha, PQ) * fac).reshape(Q, Bab, Bcd, -1)
    # the window R[t+x, u+y, v+z], gathered as (Q, Bab, ntuv, Bcd, nxyz)
    dev = R.device
    w = _window(Lab, Lcd, dev)
    ntuv, nxyz = w.shape
    Rw = R[torch.arange(Q, device=dev)[:, None, None, None, None],
           torch.arange(Bab, device=dev)[None, :, None, None, None],
           torch.arange(Bcd, device=dev)[None, None, None, :, None],
           w[None, None, :, None, :]].reshape(Q, Bab * ntuv, Bcd * nxyz)
    Eab = (bra.bra_cart if cart else bra.bra)[bi]  # (Q, nab, Bab, ntuv)
    Ecd = (ket.ket_cart if cart else ket.ket)[ki]  # (Q, Bcd, nxyz, ncd) signed
    nab, ncd = Eab.shape[1], Ecd.shape[3]
    Eab = Eab.reshape(Q, nab, Bab * ntuv)
    Ecd = Ecd.reshape(Q, Bcd * nxyz, ncd)
    # out[q, ab, cd] = sum Eab[q, ab, (i tuv)] Rw[q, (i tuv), (j xyz)] Ecd[q, (j xyz), cd]
    if ncd <= nab:
        return torch.bmm(Eab, torch.bmm(Rw, Ecd))
    return torch.bmm(torch.bmm(Eab, Rw), Ecd)


def _chunks(n: int, per_item: int, budget: int):
    step = max(1, budget // max(per_item, 1))
    for c0 in range(0, n, step):
        yield c0, min(n, c0 + step)


def schwarz_bounds(pair_list, classes, budget: int) -> torch.Tensor:
    """sqrt(max |(ab|ab)|) over the Cartesian components of each shell
    pair's diagonal quartet, as the JAX engine's `eri_tensor` takes it."""
    dev = classes[0].p.device
    Qb = torch.empty(len(pair_list), dtype=F64, device=dev)
    for c in classes:
        idx = torch.arange(len(c.pairs), device=dev)
        pos = torch.as_tensor(c.pairs, device=dev)
        for c0, c1 in _chunks(len(c.pairs), _quartet_bytes(c, c), budget):
            blk = eri_quartets(c, c, idx[c0:c1], idx[c0:c1], cart=True)
            Qb[pos[c0:c1]] = torch.sqrt(
                blk.abs().reshape(c1 - c0, -1).amax(1))
    return Qb


def _canonical_index(A, B, C, D):
    """eri_ind position of (AB|CD) with A >= B and C >= D."""
    ab = A * (A + 1) // 2 + B
    cd = C * (C + 1) // 2 + D
    hi, lo = torch.maximum(ab, cd), torch.minimum(ab, cd)
    return ab, cd, hi * (hi + 1) // 2 + lo


def eri_packed(basis: BasisSet, device: str | torch.device | None = None,
               screen: float = SCHWARZ_SCREEN, verbose: bool = False,
               chunk_bytes: int | None = None) -> torch.Tensor:
    """The 8-fold packed ERI store (reference eri_ind order) on `device`,
    every unique element computed once; Schwarz-screened quartets are 0.

    The quartets each ERI class keeps after screening are listed on the
    host and sent to the device in one copy, so the loop over classes and
    chunks queues work without waiting for the device."""
    dev = default_device(device)
    budget = chunk_bytes or CHUNK_BYTES.get(dev.type, CHUNK_BYTES_DEFAULT)
    n = basis.nbf
    npair = n * (n + 1) // 2
    npack = npair * (npair + 1) // 2
    pair_list, classes = pair_classes(basis, dev)
    Qb = schwarz_bounds(pair_list, classes, budget).cpu().numpy()
    for c in classes:
        c.bra_cart = c.ket_cart = None
    # the quartets of every class (bra pair class ia, ket pair class ib <= ia)
    plan, bq, kq, total = [], [], [], 0
    for ia, ca in enumerate(classes):
        for cb in classes[: ia + 1]:
            bi, ki = np.meshgrid(np.arange(len(ca.pairs)), np.arange(len(cb.pairs)),
                                 indexing="ij")
            keep = Qb[ca.pairs][:, None] * Qb[cb.pairs][None, :] >= screen
            if cb is ca:
                keep &= ki <= bi
            if keep.any():
                plan.append((ia, ca, cb, total, total + int(keep.sum())))
                bq.append(bi[keep])
                kq.append(ki[keep])
                total = plan[-1][-1]
    Bq = torch.as_tensor(np.concatenate(bq), device=dev)
    Kq = torch.as_tensor(np.concatenate(kq), device=dev)
    off = torch.as_tensor(basis.offsets, device=dev)
    # per pair class: the offsets of a and b and the pair's list position
    meta = {id(c): tuple(torch.as_tensor(x, device=dev) for x in (c.ish, c.jsh, c.pairs))
            for c in classes}
    comp = lambda d, k: torch.arange(d, device=dev).reshape(
        (1,) * (k + 1) + (d,) + (1,) * (3 - k))
    # one spare slot at the end takes the components that are not written
    packed = torch.zeros(npack + 1, dtype=F64, device=dev)
    for ia, ca, cb, s0, s1 in plan:
        if verbose and cb is classes[0]:
            print(f"  pair class {ia + 1}/{len(classes)}", flush=True)
        ia_sh, ja_sh, pa = meta[id(ca)]
        ib_sh, jb_sh, pb = meta[id(cb)]
        da, db = 2 * ca.la + 1, 2 * ca.lb + 1
        dc, dd = 2 * cb.la + 1, 2 * cb.lb + 1
        for c0, c1 in _chunks(s1 - s0, _quartet_bytes(ca, cb), budget):
            b_, k_ = Bq[s0 + c0 : s0 + c1], Kq[s0 + c0 : s0 + c1]
            blk = eri_quartets(ca, cb, b_, k_)
            o = lambda sh, x: off[sh[x]].reshape(-1, 1, 1, 1, 1)
            A = o(ia_sh, b_) + comp(da, 0)
            B = o(ja_sh, b_) + comp(db, 1)
            C = o(ib_sh, k_) + comp(dc, 2)
            D = o(jb_sh, k_) + comp(dd, 3)
            ab, cd, idx = _canonical_index(A, B, C, D)
            same = (pa[b_] == pb[k_]).reshape(-1, 1, 1, 1, 1)
            ok = (A >= B) & (C >= D) & ((ab >= cd) | ~same)
            idx = torch.where(ok, idx, npack)
            packed[idx.reshape(-1)] = blk.reshape(-1)
    return packed[:npack]


# --------------------------------------------------------------------------
# one-electron integrals
# --------------------------------------------------------------------------


def _one_electron(basis: BasisSet, kind: str, dev, charges=None, coords=None) -> torch.Tensor:
    """S, T or V over the spherical basis, one pair class at a time."""
    n = basis.nbf
    shells, off = basis.shells, np.asarray(basis.offsets)
    pair_list, groups = _pair_groups(shells)
    M = torch.zeros((n, n), dtype=F64, device=dev)
    for pos in groups:
        pairs = [pair_list[k] for k in pos]
        la, lb = shells[pairs[0][0]].l, shells[pairs[0][1]].l
        blk = _pair_1e(shells, pairs, kind, dev, charges, coords)  # (P, na, nb) Cartesian
        Ta = torch.as_tensor(c2s_matrix(la), dtype=F64, device=dev)
        Tb = torch.as_tensor(c2s_matrix(lb), dtype=F64, device=dev)
        blk = Ta @ blk @ Tb.T
        ii = torch.as_tensor(off[[i for i, _ in pairs]], device=dev)[:, None, None]
        jj = torch.as_tensor(off[[j for _, j in pairs]], device=dev)[:, None, None]
        ra = torch.arange(2 * la + 1, device=dev)[None, :, None]
        rb = torch.arange(2 * lb + 1, device=dev)[None, None, :]
        M[jj + rb, ii + ra] = blk
        M[ii + ra, jj + rb] = blk
    return M


def _pair_1e(shells, pairs, kind, dev, charges, coords) -> torch.Tensor:
    """Cartesian blocks (P, ncart_a, ncart_b) of S, T or V for a pair class."""
    la, lb = shells[pairs[0][0]].l, shells[pairs[0][1]].l
    ea, eb, da, db, A, Bc = _stack_pairs(shells, pairs, dev)
    p = ea + eb  # (P, Ka, Kb)
    pref = da * db
    AB = (A - Bc)[:, None, None, :]
    ca, cb = cart_components(la), cart_components(lb)
    if kind in ("S", "T"):
        lbx = lb + 2 if kind == "T" else lb
        E = hermite_E(la, lbx, ea[..., None], eb[..., None], AB)[:, :, 0]  # (la+1, lbx+1, P, Ka, Kb, 3)
        fac = (math.pi / p) ** 1.5 * pref
        ax = torch.as_tensor([[a[d] for a in ca] for d in range(3)], device=dev)
        bx = torch.as_tensor([[b[d] for b in cb] for d in range(3)], device=dev)
        # E0[d][a, b] = E_d[a_d, b_d, 0] over Cartesian components: (na, nb, P, Ka, Kb)
        e0 = [E[ax[d][:, None], bx[d][None, :], ..., d] for d in range(3)]
        if kind == "S":
            val = e0[0] * e0[1] * e0[2]
        else:
            ebd = eb[None, None]

            def t1d(d):
                jb = bx[d][None, :].to(F64).reshape(1, -1, 1, 1, 1)
                t = ebd * (2 * jb + 1) * e0[d]
                t = t - 2.0 * ebd**2 * E[ax[d][:, None], bx[d][None, :] + 2, ..., d]
                jm = (bx[d] - 2).clamp(min=0)
                lo = E[ax[d][:, None], jm[None, :], ..., d]
                return t - torch.where(jb >= 2, 0.5 * jb * (jb - 1) * lo, torch.zeros_like(lo))

            val = (t1d(0) * e0[1] * e0[2] + e0[0] * t1d(1) * e0[2]
                   + e0[0] * e0[1] * t1d(2))
        return (val * fac).sum((-1, -2)).permute(2, 0, 1)
    # nuclear attraction
    L = la + lb
    prod = _hermite_products(hermite_E(la, lb, ea[..., None], eb[..., None], AB), la, lb)
    ntuv = len(simplex(L))
    Et = prod.reshape(len(ca) * len(cb), ntuv, *p.shape)  # (nab, ntuv, P, Ka, Kb)
    Pc = (ea[..., None] * A[:, None, None, :] + eb[..., None] * Bc[:, None, None, :]) / p[..., None]
    Z = torch.as_tensor(np.asarray(charges, float), dtype=F64, device=dev)
    Cn = torch.as_tensor(np.asarray(coords, float), dtype=F64, device=dev)
    PC = Pc[..., None, :] - Cn  # (P, Ka, Kb, natoms, 3)
    R = hermite_R(L, p[..., None].expand(PC.shape[:-1]).reshape(-1), PC.reshape(-1, 3))
    R = R.reshape(PC.shape[:-1] + (ntuv,))  # (P, Ka, Kb, natoms, ntuv)
    Rz = -(R * Z[:, None]).sum(-2)  # (P, Ka, Kb, ntuv)
    acc = torch.einsum("ctpkl,pklt->cpkl", Et, Rz)
    val = (acc * (pref * (2.0 * math.pi / p))).sum((-1, -2))  # (nab, P)
    return val.T.reshape(-1, len(ca), len(cb))


def overlap(basis: BasisSet, device: str | torch.device | None = None) -> torch.Tensor:
    return _one_electron(basis, "S", default_device(device))


def kinetic(basis: BasisSet, device: str | torch.device | None = None) -> torch.Tensor:
    return _one_electron(basis, "T", default_device(device))


def nuclear(basis: BasisSet, charges, coords,
            device: str | torch.device | None = None) -> torch.Tensor:
    return _one_electron(basis, "V", default_device(device), charges, coords)
