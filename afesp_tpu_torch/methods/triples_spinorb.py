"""Spin-orbital CCSD(T) — the headline compute kernel.

Port of `afesp_tpu/methods/triples_spinorb.py:36-489`
(`strict_triple_list`, `strict_plan`, `_pick_clen`, `_chunk_panels`,
`triples_chunk_energies`, `_strict_chunk_energy`, `_triples_total_strict`,
`do_ccsd_t_spinorb` with its mesh branch `:431-438`).
Re-implements do_ccsd_t_spinorb (ccsd.f90:1812-1922):

  t3d(abc)*D = P(i/jk)P(a/bc) t1[i,a] <jk||bc>
  t3c(abc)*D = P(i/jk)P(a/bc) [ f-sum - m-sum ]   (ccsd.f90:1878-1907)
  E(T) = sum_{ijk,abc} t3c * (t3c/D + t3d/D) / 36

over the STRICT triangle i<j<k only (the summand is S3-symmetric and
vanishes on diagonals, so 6x weight on C(o,3) triples replaces the
reference's o^3 cube).  Four tiers:

  "fused"  — K1, `ops/triples_cuda.triples_fused`: the numerator
             products and the reduction in hand-written CUDA, f64;
  "pallas" — the numerator panels as f64 torch einsums per chunk
             (`_chunk_panels`), then K2, `ops/triples_cuda.triples_finale`
             (JAX's panels here are f32; the port's K2 is an f64 kernel,
             so its panels stay f64);
  "hybrid" — JAX's f32 strict-chunk tier: the operands cast to f32 once,
             the panel GEMMs and P(a/bc) in f32, the denominator and the
             reduction in f64 (`_strict_chunk_energy`);
  "f64"    — plain torch throughout.

The default is "fused" on a CUDA device (no nvirt cap, so the card needs
no switch to "hybrid" above 128 virtuals as the TPU does) and "hybrid"
on the CPU, as the JAX package's off a TPU.  A kernel that fails raises:
the JAX package's degrade-to-hybrid memo is not carried over.

Under a device mesh each entry runs the tier one device would run (the
choice above, kept) on its contiguous share of the strict list
(`parallel/triples_shard.triples_total_sharded`: K1 per share, or the
share's chunks through the panels and K2), the partial sums added on the
first entry.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..io import dat
from ..io.report import Reporter
from ..ops.spin import spinorb_levels
from ..ops.triples_cuda import triples_finale, triples_finale_plain, triples_fused
from .ccsd_spinorb import CCSDSpinorbResult

es = torch.einsum
PRECISIONS = ("f64", "hybrid", "pallas", "fused")
# memory budget of one chunk's ~12 live (C, v^3) transients
_CHUNK_BYTES = 4e9


def _chunk_panels(ii, jj, kk, t1, t2, vovv, ovoo, oovv):
    """t3c/t3d numerator panels, (C, v, v, v), for a chunk of (i,j,k)
    triples given as (C,) index tensors.  Panels carry the P(i/jk) row
    permutation only; P(a/bc), the denominator and the reduction are the
    finale's job."""
    # Disconnected: t1[i,a] <jk||bc> - t1[j,a] <ik||bc> - t1[k,a] <ji||bc>
    t3d = (
        es("Ca,Cbc->Cabc", t1[ii], oovv[jj, kk])
        - es("Ca,Cbc->Cabc", t1[jj], oovv[ii, kk])
        - es("Ca,Cbc->Cabc", t1[kk], oovv[jj, ii])
    )
    # Connected (ccsd.f90:1883-1890):
    #   sum_f [ vovv[f,i,b,c] t2[j,k,a,f] - vovv[f,j,b,c] t2[i,k,a,f]
    #           - vovv[f,k,b,c] t2[j,i,a,f] ]
    # - sum_m [ t2[m,i,c,b] ovoo[m,a,j,k] - t2[m,j,c,b] ovoo[m,a,i,k]
    #           - t2[m,k,c,b] ovoo[m,a,j,i] ]
    t3c = (
        es("Caf,fCbc->Cabc", t2[jj, kk], vovv[:, ii])
        - es("Caf,fCbc->Cabc", t2[ii, kk], vovv[:, jj])
        - es("Caf,fCbc->Cabc", t2[jj, ii], vovv[:, kk])
        - es("mCcb,maC->Cabc", t2[:, ii], ovoo[:, :, jj, kk])
        + es("mCcb,maC->Cabc", t2[:, jj], ovoo[:, :, ii, kk])
        + es("mCcb,maC->Cabc", t2[:, kk], ovoo[:, :, jj, ii])
    )
    return t3c, t3d


def triples_chunk_energies(ii, jj, kk, t1, t2, vovv, ovoo, oovv, e_o, e_v) -> torch.Tensor:
    """Per-triple E(T) contributions, the 1/36 included (ccsd.f90:1910),
    for a chunk of (i,j,k) triples of the full cube: the (C,) vector the
    caller reduces (`parallel/triples_shard.triples_energy_sharded`, the
    full-cube oracle)."""
    t3c, t3d = _chunk_panels(ii, jj, kk, t1, t2, vovv, ovoo, oovv)

    # P(a/bc): x - x(bac) - x(cba) (ccsd.f90:1897-1907)
    def p_abc(x):
        return x - x.permute(0, 2, 1, 3) - x.permute(0, 3, 2, 1)

    t3d, t3c = p_abc(t3d), p_abc(t3c)
    D = (
        (e_o[ii] + e_o[jj] + e_o[kk])[:, None, None, None]
        - e_v[None, :, None, None]
        - e_v[None, None, :, None]
        - e_v[None, None, None, :]
    )
    return torch.sum(t3c * (t3c / D + t3d / D), dim=(1, 2, 3)) / 36.0


def strict_triple_list(nocc: int):
    """All strictly-ordered occupied triples i<j<k, lexicographic, as
    int32 numpy arrays (C(nocc,3) entries)."""
    idx = np.arange(nocc, dtype=np.int32)
    ii, jj, kk = np.meshgrid(idx, idx, idx, indexing="ij")
    m = (ii < jj) & (jj < kk)
    return ii[m], jj[m], kk[m]


def _pick_clen(nvirt: int, total: int, precision: str = "f64") -> int:
    """Largest per-chunk triple count whose ~12 live (C, v^3) transients
    fit _CHUNK_BYTES: 4 B an element for "hybrid"'s f32 panels, else 8."""
    el = 4 if precision == "hybrid" else 8
    return max(1, min(total, int(_CHUNK_BYTES / (12 * el * nvirt**3))))


def strict_plan(nocc: int, nvirt: int, precision: str = "f64"):
    """(ii, jj, kk, clen) for the strict-triangle grid: the triple list
    padded with (0,0,0) entries — which contribute exactly zero, since
    every numerator term then carries a vanishing t2[p,p] / <pp||bc> /
    <ma||pp> factor — to a multiple of clen."""
    ii, jj, kk = strict_triple_list(nocc)
    total = len(ii)
    if total == 0:
        return ii, jj, kk, 1
    clen = _pick_clen(nvirt, total, precision)
    npad = -(-total // clen) * clen - total
    pad = np.zeros(npad, dtype=np.int32)
    return (
        np.concatenate([ii, pad]),
        np.concatenate([jj, pad]),
        np.concatenate([kk, pad]),
        clen,
    )


def _strict_chunk_energy(iii, jjj, kkk, t1, t2, vovv, ovoo, oovv, e_o, e_v, precision: str):
    """Sum of E(T)*6 contributions of one chunk of strict triples (the
    global 1/6 is applied by the caller).  The operands arrive cast (f32
    for "hybrid"); e_o/e_v stay f64, so the denominator, the quotient
    and the reduction are f64 on every tier."""
    t3c, t3d = _chunk_panels(iii, jjj, kkk, t1, t2, vovv, ovoo, oovv)
    eo_sum = e_o[iii] + e_o[jjj] + e_o[kkk]
    finale = triples_finale if precision == "pallas" else triples_finale_plain
    return finale(t3c, t3d, eo_sum, e_v)


def _triples_total_strict(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk, *,
                          clen: int, precision: str) -> torch.Tensor:
    """E(T) over the strict i<j<k triple list.  For "fused" the list is
    taken whole (K1 chunks it itself); otherwise ii/jj/kk are padded to a
    multiple of clen (strict_plan) and summed chunk by chunk."""
    if precision == "fused":
        return triples_fused(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk) / 6.0
    if precision == "hybrid":
        # the f64->f32 operand casts once, outside the chunk loop
        t1, t2, vovv, ovoo, oovv = (x.float() for x in (t1, t2, vovv, ovoo, oovv))
    total = e_o.new_zeros(())
    for c0 in range(0, ii.shape[0], clen):
        sl = slice(c0, c0 + clen)
        total = total + _strict_chunk_energy(
            ii[sl], jj[sl], kk[sl], t1, t2, vovv, ovoo, oovv, e_o, e_v, precision
        )
    return total / 6.0


def do_ccsd_t_spinorb(
    sys_: dat.System,
    cc: CCSDSpinorbResult,
    cfg: Config,
    levels: np.ndarray,
    rep: Reporter | None = None,
    precision: str | None = None,
    mesh=None,
) -> float:
    """Returns e_ccsd_t = e_ccsd + E(T) (ccsd.f90:1917), on the device of
    the amplitudes.  precision: "fused" | "pallas" | "hybrid" | "f64";
    None picks "fused" on CUDA and "hybrid" on the CPU.  With `mesh` the
    tier runs on each entry's share of the triples (module docstring)."""
    t1 = cc.t1
    dev = t1.device
    if precision is None:
        precision = "fused" if dev.type == "cuda" else "hybrid"
    if precision not in PRECISIONS:
        raise ValueError(f"triples precision must be one of {PRECISIONS}, got {precision!r}")
    rep = rep or Reporter()
    rep.section("CCSD(T)")
    t_start = time.perf_counter()

    nocc = sys_.nocc
    lv = spinorb_levels(torch.as_tensor(levels, dtype=t1.dtype, device=dev), nocc // 2)
    v = cc.slices
    # <fi||bc> slice: vovv; <ma||jk>: ovoo; <jk||bc>: oovv (ccsd.f90:1834-1835)
    args = (t1, cc.t2, v.vovv, v.ovoo, v.oovv, lv[:nocc], lv[nocc:])
    e_t = 0.0
    if mesh is not None:
        from ..parallel.triples_shard import triples_total_sharded

        e_t = triples_total_sharded(mesh, *args, nocc=nocc, precision=precision)
    else:
        if precision == "fused":
            ii, jj, kk = strict_triple_list(nocc)
            clen = len(ii)
        else:
            ii, jj, kk, clen = strict_plan(nocc, t1.shape[1], precision)
        if len(ii):
            idx = (torch.as_tensor(x, dtype=torch.long, device=dev) for x in (ii, jj, kk))
            e_t = float(_triples_total_strict(*args, *idx, clen=clen, precision=precision))
    e_ccsd_t = e_t + cc.e_ccsd
    rep.write(
        f" Unrestricted CCSD(T) correlation energy (Hartree): {e_ccsd_t:15.9f}"
    )
    rep.stage_time(
        "Time taken for unrestricted CCSD(T):", time.perf_counter() - t_start
    )
    return e_ccsd_t
