"""Spin-orbital antisymmetrised ERI slices.

Port of `afesp_tpu/ops/spin.py:20-236`.  The reference materialises the
full (2n)^4 tensor
<pq||rs> = (PR|QS) d(sp,sr) d(sq,ss) - (PS|QR) d(sp,ss) d(sq,sr)
via a spin decision tree (ccsd.f90:106-148) and then slices it
(ccsd.f90:181-194).  Here each o/v slice is built directly from two
spatial tensors, one spin block at a time — no (2n)^4 intermediate ever
exists.

Spin-orbital order is BLOCK order, as in the JAX package: within each
occupied/virtual space all alpha orbitals precede all beta (the
reference interleaves; CC energies are invariant to orbital order within
the o/v spaces).
"""

from __future__ import annotations

import numpy as np
import torch


def spinorb_slice(eri_mo: torch.Tensor, blocks: str, nocc_spatial: int) -> torch.Tensor:
    """Build the <b1 b2 || b3 b4> slice, blocks like "oovv".

    eri_mo: dense chemist (pq|rs) MO tensor.
    Returns a tensor over spin orbitals with dims (2*n_i) per position.
    """
    n = eri_mo.shape[0]
    sl = {"o": slice(0, nocc_spatial), "v": slice(nocc_spatial, n)}
    s1, s2, s3, s4 = (sl[b] for b in blocks)

    A = eri_mo.permute(0, 2, 1, 3)[s1, s2, s3, s4]  # <PQ|RS> = (PR|QS)
    B = eri_mo.permute(0, 2, 3, 1)[s1, s2, s3, s4]  # <PQ|SR> = (PS|QR)
    d = A.shape
    out = eri_mo.new_zeros((2 * d[0], 2 * d[1], 2 * d[2], 2 * d[3]))

    def blk(sp, sq, sr, ss):
        return out[
            sp * d[0] : (sp + 1) * d[0],
            sq * d[1] : (sq + 1) * d[1],
            sr * d[2] : (sr + 1) * d[2],
            ss * d[3] : (ss + 1) * d[3],
        ]

    # the ccsd.f90:133-138 decision tree: <pq||rs> is A where the spins
    # pair (p,r),(q,s), -B where they pair (p,s),(q,r), A - B where both
    for sp in (0, 1):
        for sq in (0, 1):
            blk(sp, sq, sp, sq).copy_(A)
            blk(sp, sq, sq, sp).sub_(B)
    return out


def spinorb_vvvv_blocks(
    eri_mo: torch.Tensor, nocc_spatial: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The two unique spin blocks of the antisymmetrised <ab||cd> slice,
    built straight from the spatial MO tensor: the (2 nvirt)^4 tensor
    never exists (16.2 GB f64 at the 116-bf dimer; the blocks are 1.0 GB
    each).

    Returns (aa, ab) with aa = <AB||CD>_aaaa = A - B and
    ab = <AB||CD>_abab = A, where A = (AC|BD), B = (AD|BC) over spatial
    virtuals (the ccsd.f90:133-138 decision tree at its only two
    distinct non-zero patterns; bbbb == aaaa and the mixed blocks are
    +-transposes of ab).  The views are sliced to the virtuals before
    anything is copied, so no transposed copy of the full MO tensor is
    made."""
    n = eri_mo.shape[0]
    v = slice(nocc_spatial, n)
    vir = eri_mo[v, v, v, v]
    ab = vir.permute(0, 2, 1, 3).contiguous()
    # aa in ab's row-major layout (A - B of two views would keep theirs)
    aa = ab.clone().sub_(vir.permute(0, 2, 3, 1))
    return aa, ab


def spinorb_levels(levels: torch.Tensor, nocc_spatial: int) -> torch.Tensor:
    """Spin-orbital levels in block order: [occ-alpha, occ-beta,
    virt-alpha, virt-beta] (the reference interleaves, ccsd.f90:460-463)."""
    e_o = levels[:nocc_spatial]
    e_v = levels[nocc_spatial:]
    return torch.cat([e_o, e_o, e_v, e_v])


def spin_expand_t1(t1: np.ndarray) -> np.ndarray:
    """Closed-shell spatial t1 -> block-spin spin-orbital t1."""
    no, nv = t1.shape
    out = np.zeros((2 * no, 2 * nv))
    out[:no, :nv] = t1
    out[no:, nv:] = t1
    return out


def spin_expand_t2(t2: np.ndarray) -> np.ndarray:
    """Closed-shell spatial t2 -> antisymmetrised block-spin t2:
    t2_so[(si I)(sj J)(sa A)(sb B)] = d(si,sa)d(sj,sb) t2[I,J,A,B]
                                     - d(si,sb)d(sj,sa) t2[I,J,B,A]."""
    no, _, nv, _ = t2.shape
    out = np.zeros((2 * no, 2 * no, 2 * nv, 2 * nv))
    t2swap = t2.transpose(0, 1, 3, 2)
    for si in (0, 1):
        for sj in (0, 1):
            blk = out[si * no : (si + 1) * no, sj * no : (sj + 1) * no]
            blk[:, :, si * nv : (si + 1) * nv, sj * nv : (sj + 1) * nv] += t2
            blk[:, :, sj * nv : (sj + 1) * nv, si * nv : (si + 1) * nv] -= t2swap
    return out


def _exchange_error(X):
    """Sum of |X - X^c| for the pair-exchange generator
    c: <pq||rs> = <rs||pq>."""
    return (X - X.permute(2, 3, 0, 1)).abs().sum()


def _generators_error(X):
    """The swap-last-pair generator b: <pq||rs> = -<pq||sr>, plus c."""
    return (X + X.permute(0, 1, 3, 2)).abs().sum() + _exchange_error(X)


def _oovv_error(oovv):
    """Both antisymmetries of <ij||ab>."""
    return (oovv + oovv.permute(0, 1, 3, 2)).abs().sum() + (
        oovv + oovv.permute(1, 0, 2, 3)
    ).abs().sum()


def spin_symmetry_error(oooo, oovv, vvvv) -> torch.Tensor:
    """Runtime self-check (ccsd.f90:150-173): deviation from
    <pq||rs> = -<pq||sr> = <rs||pq>, the two generators of the
    reference's identity set, on the oooo/vvvv slices (where the
    identities close within one slice) plus both antisymmetries of oovv.
    Evaluated in the slices' own f64 (the JAX package casts to f32 to
    save TPU traffic; an exactly symmetric tensor stays so either way)."""
    return _generators_error(oooo) + _generators_error(vvvv) + _oovv_error(oovv)


def spin_symmetry_error_blocks(oooo, oovv, aa, ab) -> torch.Tensor:
    """spin_symmetry_error for the block-compressed vvvv (held as its
    (aa, ab) spin blocks).  Both generators close within the aa block
    (a complete antisymmetrised tensor over the alpha virtuals); for ab
    only the pair-exchange generator stays inside the stored block, so
    the swap-last-pair generator is checked through aa and oovv.
    Accumulated in f32 as in the JAX package (`afesp_tpu/ops/spin.py:85`),
    whose block-aware tolerance was set against that sum."""
    oooo, oovv, aa, ab = (x.float() for x in (oooo, oovv, aa, ab))
    return (_generators_error(oooo) + _generators_error(aa) + _exchange_error(ab)
            + _oovv_error(oovv)).double()
