"""Sliced AO->MO transforms (which tier runs which: `methods/tiers.py`):
the AO ERI -> the physicist CCSD slices, with no dense n^4 f64 tensor.

Port of `afesp_tpu/methods/mo_slices.py`.  The packed store (0.93 GB at
174 bf) is the only resident AO-ERI form: it is half-expanded once into
an (npair, n^2) row table (`_expand_packed_rows`, held as an f32 hi/lo
pair as in the JAX package, whose values it reproduces bit for bit),
and the MO rows are produced in chunks, each through four quarter
transforms that contract the leading index and emit its MO partner
trailing (mp2.f90:320-386), so a chunk's chemist rows land in
(p, q, r, s) order.  Each chunk's physicist blocks go straight into the
slice buffers; with `digit_L` each vvvv chunk is digitized to int8 limbs
with its own per-chunk scales the moment it is computed
(`prechunk_B_chunkscaled`), so the f64 v_vvvv never exists.

Every contraction is an exact digit GEMM (`ops/exact_gemm`, L=7,
maxdeg=8), the JAX package's arithmetic.  A digit GEMM digitizes its
rows (columns of the C side) each with its own scale, so how the rows
are blocked moves no bit; the chunk of virtual MO rows (`_pick_chunk`,
4e8 bytes) does move the vvvv limbs, whose scales are per chunk, and is
JAX's.  The port computes stage 1 for several chunks in one pass over
the row table (`_GROUP_BYTES` of stage-1 output at a time), which the
JAX package repeats per chunk: the same numbers, fewer passes.

The sliced f64 tier (`ao_to_mo_slices_f64`, the port's own: the JAX
package has no f64 tier above its dense cutoff) reads RHF's f64 pair-row
table (`IntStore.rows_on_device`) and makes every contraction an f64
GEMM.  The digit route's loop, one stage-1 pass over the whole table per
group of chunks, would hold the table (28.4 GB at 290 bf) beside the f64
v_vvvv (39.4 GB); so the f64 route makes one pass.  Its first half
transforms the (k, l) side of each table row, (ij|kl) -> (ij|rs), for
s occupied (all r) and for the virtual pairs c >= d, which the table
then no longer holds: it is freed.  The second half unpacks the ij pairs
of a block of those columns at a time and transforms them: the
occupied-s columns give the chemist (pq|rs) from which the five small
slices are cut, as `make_slices` cuts them from the dense tensor; each
block of virtual-pair columns, a vvvv chunk, is written into the f64
v_vvvv and freed.

Both routes are the span `mo.slices`; `ao_to_mo_slices.vvvv_chunks`
(the counter `mo_slices.vvvv_chunks`) counts the v_vvvv chunks a sliced
transform computed.
"""

from __future__ import annotations

import torch

from .. import trace
from ..device import F64
from ..ops.exact_gemm import digitize_B, exact_gemm, prechunk_B_chunkscaled
from ..ops.packed_eri import pair_index
from .ccsd_spatial import Slices

F32 = torch.float32
# the stage-1 output held for one pass over the row table (several chunks)
_GROUP_BYTES = 2e9
# the f64 route's blocks: table rows, and unpacked (n^2, columns) operands
_F64_BLOCK_BYTES = 1e9


def _expand_packed_rows(packed: torch.Tensor, *, n: int):
    """(npair, n^2) row half-expansion of the packed store,
    P3[p, (k,l)] = packed[pair(p, pair(k,l))], as the JAX package's f32
    (hi, lo) split pair: hi + lo gives each value to ~2^-48 relative,
    and the transform reads exactly those values.  Built in row blocks
    whose (rows, n^2) index fits 5e7 elements (the JAX package's 2.1e8
    bounds its own temporaries; the blocking moves no value)."""
    npair = n * (n + 1) // 2
    dev = packed.device
    i = torch.arange(n, device=dev)
    kl = pair_index(i[:, None], i[None, :]).reshape(-1)
    bp = max(d for d in range(1, npair + 1) if npair % d == 0 and d * n * n <= 5e7)
    hi = torch.empty((npair, n * n), dtype=F32, device=dev)
    lo = torch.empty((npair, n * n), dtype=F32, device=dev)
    for p0 in range(0, npair, bp):
        rows = torch.arange(p0, p0 + bp, device=dev)
        vals = packed[pair_index(rows[:, None], kl[None, :])]
        h = vals.to(F32)
        hi[p0:p0 + bp] = h
        lo[p0:p0 + bp] = (vals - h.to(vals.dtype)).to(F32)
    return hi, lo


def _gather_ao_jkl_block(P3, j0: int, *, n: int, jb: int) -> torch.Tensor:
    """AO[(j,k,l), i] for j in [j0, j0+jb): jb*n contiguous rows of the
    row table (pair(i,j), all kl), rebuilt in f64 and transposed to the
    [(j,k,l), i] GEMM layout."""
    hi, lo = P3
    dev = hi.device
    i = torch.arange(n, device=dev)
    j = torch.arange(j0, j0 + jb, device=dev)
    pij = pair_index(i[None, :], j[:, None]).reshape(-1)  # (jb*n,) pair(i,j)
    G = hi[pij].to(F64) + lo[pij]
    return G.reshape(jb, n, n, n).permute(0, 2, 3, 1).reshape(jb * n * n, n)


def _stage1_from_packed(P3, CBr, *, n: int, jb: int) -> torch.Tensor:
    """out[j, k, l, p] = sum_i AO[i,j,k,l] C[p,i] for the MO rows p whose
    digitized columns CBr holds, reading jb leading-j planes of the row
    table at a time (jb | n)."""
    out = torch.empty((n * n * n, CBr[1].shape[1]), dtype=F64, device=P3[0].device)
    for j0 in range(0, n, jb):
        out[j0 * n * n:(j0 + jb) * n * n] = exact_gemm(
            _gather_ao_jkl_block(P3, j0, n=n, jb=jb), B_dig=CBr)
    return out.reshape(n, n, n, -1)


def _stage_dense(T: torch.Tensor, CB) -> torch.Tensor:
    """Contract the leading axis of T against C (the columns of CB):
    T (k, rest...) -> (rest..., p), as one digit GEMM over the transposed
    matricisation."""
    k = T.shape[0]
    out = exact_gemm(T.reshape(k, -1).t(), B_dig=CB)
    return out.reshape(*T.shape[1:], out.shape[-1])


def _chem_rows(t: torch.Tensor, CB) -> torch.Tensor:
    """Stages 2-4 of a chunk: (j, k, l, p) from stage 1 -> the chemist
    rows (p q|r s), each stage emitting its MO index trailing."""
    t = _stage_dense(t, CB)  # (k,l,p,q)
    t = _stage_dense(t, CB)  # (l,p,q,r)
    return _stage_dense(t, CB)  # (p,q,r,s)


def _pslice(chem: torch.Tensor, x, y, z) -> torch.Tensor:
    """Physicist block phys[:, x, y, z] of a chemist row chunk:
    phys[p,x,y,z] = chem(p y|x z), sliced before the transpose."""
    return chem[:, y, x, z].permute(0, 2, 1, 3)


def _pick_chunk(nvirt: int, n: int, budget_bytes: float = 4e8) -> int:
    """Largest divisor of nvirt whose (nr, n^3) f64 stage buffer fits the
    budget: the JAX package's chunk of virtual MO rows, which sets the
    per-chunk scales of the vvvv limbs."""
    cap = max(1, int(budget_bytes / (8.0 * n**3)))
    return max(d for d in range(1, nvirt + 1) if nvirt % d == 0 and d <= cap)


def ao_to_mo_slices(packed: torch.Tensor, C: torch.Tensor, *, n: int, nocc: int,
                    digit_L: int | None = None, free_packed=None):
    """Packed AO ERI (on the device) and MO coefficients C (rows = MO,
    sys%canon_coeff layout) -> (Slices with v_vvvv None, vvvv form).

    digit_L None: the vvvv form is the (ef, ab) f64 matricisation.
    digit_L=L (the stream tier, L=5): it is the prechunk_B_chunkscaled
    operand (limbs (nc, kc, v^2) int8, scales (nc, 1, v^2)) assembled
    chunk by chunk, equal to the JAX package's limbs.  free_packed is
    called once the row table supersedes the packed store."""
    # the span's body holds the only reference to the packed store, so
    # that it can be freed once the row table supersedes it
    with trace.span("mo.slices"):
        dev = packed.device
        C = C.to(device=dev, dtype=F64)
        nvirt = n - nocc
        # jb: leading-j planes per stage-1 gather block (JAX `:242`)
        jb = max(d for d in range(1, n + 1) if n % d == 0 and d * n**3 * 12 <= 3e8)
        CB = digitize_B(C.T)
        P3 = _expand_packed_rows(packed, n=n)
        if free_packed is not None:
            del packed
            free_packed()
        o, v = slice(None, nocc), slice(nocc, None)

        chem = _chem_rows(_stage1_from_packed(P3, digitize_B(C[:nocc].T), n=n, jb=jb), CB)
        oovv, ovov, oovo, oooo = (_pslice(chem, *xyz).contiguous()
                                  for xyz in ((o, v, v), (v, o, v), (o, v, o), (o, o, o)))
        del chem

        nr = _pick_chunk(nvirt, n)
        nchunks = nvirt // nr
        per_pass = max(1, int(_GROUP_BYTES // (8.0 * n**3 * nr)))
        vvov = torch.empty((nvirt, nvirt, nocc, nvirt), dtype=F64, device=dev)
        vvvv = (torch.empty((nvirt * nvirt, nvirt * nvirt), dtype=F64, device=dev)
                if digit_L is None else None)
        limbs = scales = None
        for g0 in range(0, nchunks, per_pass):
            g1 = min(g0 + per_pass, nchunks)
            rows = C[nocc + g0 * nr:nocc + g1 * nr]
            t1 = _stage1_from_packed(P3, digitize_B(rows.T), n=n, jb=jb)
            for c in range(g0, g1):
                cols = slice((c - g0) * nr, (c - g0 + 1) * nr)
                chem = _chem_rows(t1[..., cols].contiguous(), CB)
                e = slice(c * nr, (c + 1) * nr)
                ao_to_mo_slices.vvvv_chunks += 1
                vvov[e] = _pslice(chem, v, o, v)
                block = _pslice(chem, v, v, v).reshape(nr * nvirt, nvirt * nvirt)
                del chem
                if digit_L is None:
                    vvvv[c * nr * nvirt:(c + 1) * nr * nvirt] = block
                    continue
                bl, bs = prechunk_B_chunkscaled(block, L=digit_L)
                del block  # the f64 chunk dies before the next one is built
                if limbs is None:
                    nc = nchunks * bs.shape[0]
                    limbs = [torch.empty((nc,) + tuple(x.shape[1:]), dtype=torch.int8, device=dev)
                             for x in bl]
                    scales = torch.empty((nc,) + tuple(bs.shape[1:]), dtype=F64, device=dev)
                ch = slice(c * bs.shape[0], (c + 1) * bs.shape[0])
                for dst, src in zip(limbs, bl):
                    dst[ch] = src
                scales[ch] = bs
            del t1
        del P3
        slices = Slices(v_oovv=oovv, v_ovov=ovov, v_vvov=vvov, v_oovo=oovo, v_oooo=oooo,
                        v_vvvv=None)
        return slices, (vvvv if digit_L is None else (limbs, scales))


ao_to_mo_slices.vvvv_chunks = 0
trace.register("mo_slices.vvvv_chunks", ao_to_mo_slices, "vvvv_chunks")


def _second_half(H: torch.Tensor, pairs: torch.Tensor, Cp: torch.Tensor,
                 Cq: torch.Tensor) -> torch.Tensor:
    """(pq|cols) from half-transformed columns H[pair(i,j), col] =
    (ij|col): the ij pairs unpacked to (i, j) (`pairs`, (n^2,)), then
    contracted with Cp on i and Cq on j, two f64 GEMMs.  Returns
    (p, col, q)."""
    n, m = Cp.shape[1], H.shape[1]
    U = H[pairs]  # (i*n + j, col)
    A = torch.mm(Cp, U.view(n, n * m)).view(-1, n, m)  # (p, j, col)
    return torch.matmul(A.transpose(1, 2).contiguous(), Cq.T)  # (p, col, q)


def ao_to_mo_slices_f64(ints, C: torch.Tensor, *, nocc: int, free_rows) -> Slices:
    """The sliced f64 transform (module docstring): the f64 pair-row
    table of `ints` (`IntStore.rows_on_device`, rows[pair(i,j), k*n + l]
    = (ij|kl), on C's device) and the MO coefficients C (rows = MO) ->
    the physicist Slices, v_vvvv included, every contraction an f64 GEMM
    and no n^4 tensor held.  The table is freed (`free_rows`) once the
    first half has read it; it is not an argument, so that no caller
    holds it past that point."""
    with trace.span("mo.slices"):
        rows = ints.rows_on_device(C.device)
        dev = rows.device
        npair = rows.shape[0]
        n = C.shape[0]
        nv = n - nocc
        C = C.to(dtype=F64)
        Co, Cv = C[:nocc], C[nocc:]
        cv, dv = torch.tril_indices(nv, nv, device=dev)  # the virtual pairs c >= d
        ncol = max(1, int(_F64_BLOCK_BYTES // (8 * n * n)))
        bounds = [(c0, min(c0 + ncol, cv.numel())) for c0 in range(0, cv.numel(), ncol)]

        # first half: Ho[pair(i,j), r, s] = (ij|rs), s occupied; Hv[k] the
        # block k of (ij|cd), c >= d; M[k,l] is symmetric, so
        # (C M)[r, l] = (M C^T)[l, r]
        Ho = torch.empty((npair, n, nocc), dtype=F64, device=dev)
        Hv = [torch.empty((npair, c1 - c0), dtype=F64, device=dev) for c0, c1 in bounds]
        for p0 in range(0, npair, ncol):
            p1 = min(p0 + ncol, npair)
            T = torch.mm(rows[p0:p1].view(-1, n), C.T).view(p1 - p0, n, n).transpose(1, 2)
            T = T.contiguous()  # (pair, r, l)
            Ho[p0:p1] = torch.matmul(T, Co.T)
            Tv = torch.matmul(T[:, nocc:], Cv.T).reshape(p1 - p0, nv * nv)[:, cv * nv + dv]
            for (c0, c1), blk in zip(bounds, Hv):
                blk[p0:p1] = Tv[:, c0:c1]
            del T, Tv
        del rows
        free_rows()
        if dev.type == "cuda":
            # v_vvvv, the largest allocation, is made with the table's
            # block given back, so that no freed block splits the card
            torch.cuda.empty_cache()
        vvvv = torch.empty((nv, nv, nv, nv), dtype=F64, device=dev)

        i = torch.arange(n, device=dev)
        pairs = pair_index(i[:, None], i[None, :]).reshape(-1)
        # second half, the virtual pairs: <ab|cd> = (ac|bd), written at
        # [a, c, b, d] and [a, d, b, c] from each chunk's (ab|cd), c >= d
        for k, (c0, c1) in enumerate(bounds):
            chunk = _second_half(Hv[k], pairs, Cv, Cv).permute(1, 0, 2)  # (cd, a, b)
            Hv[k] = None
            vvvv[:, cv[c0:c1], :, dv[c0:c1]] = chunk
            vvvv[:, dv[c0:c1], :, cv[c0:c1]] = chunk
            ao_to_mo_slices.vvvv_chunks += 1
            del chunk

        # second half, s occupied: X[p, r, s, q] = (pq|rs)
        X = torch.empty((n, n * nocc, n), dtype=F64, device=dev)
        Hflat = Ho.view(npair, n * nocc)
        for c0 in range(0, n * nocc, ncol):
            c1 = min(c0 + ncol, n * nocc)
            X[:, c0:c1] = _second_half(Hflat[:, c0:c1], pairs, C, C)
        del Ho, Hflat
        X = X.view(n, n, nocc, n)
        o, v = slice(None, nocc), slice(nocc, None)
        c = lambda t, *perm: t.permute(*perm).contiguous()
        oovv = c(X[v, v, :, o], 3, 2, 0, 1)  # <ij|ab> = (ai|bj)
        ovov = c(X[v, o, :, v], 1, 0, 2, 3)  # <ia|jb> = (ab|ij)
        vvov = c(X[v, v, :, v], 1, 0, 2, 3)  # <ab|ic> = (bc|ai)
        oovo = c(X[o, o, :, v], 0, 1, 3, 2)  # <ij|ak> = (ia|jk)
        oooo = c(X[o, o, :, o], 0, 1, 3, 2)  # <ij|kl> = (ik|jl)
        del X
        return Slices(v_oovv=oovv, v_ovov=ovov, v_vvov=vvov, v_oovo=oovo, v_oooo=oooo,
                      v_vvvv=vvvv)
