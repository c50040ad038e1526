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


def spin_symmetry_error(oooo, oovv, vvvv) -> torch.Tensor:
    """Runtime self-check (ccsd.f90:150-173): deviation from
    <pq||rs> = -<pq||sr> = <rs||pq>, the two generators of the
    reference's identity set, on the oooo/vvvv slices (where the
    identities close within one slice) plus both antisymmetries of oovv.
    Evaluated in the slices' own f64 (the JAX package casts to f32 to
    save TPU traffic; an exactly symmetric tensor stays so either way)."""

    def gen2(X):
        return (X + X.permute(0, 1, 3, 2)).abs().sum() + (
            X - X.permute(2, 3, 0, 1)
        ).abs().sum()

    anti = (oovv + oovv.permute(0, 1, 3, 2)).abs().sum() + (
        oovv + oovv.permute(1, 0, 2, 3)
    ).abs().sum()
    return gen2(oooo) + gen2(vvvv) + anti

