"""Multi-device (T): each mesh entry runs its share of the triples.

Port of `afesp_tpu/parallel/triples_shard.py` (`_padded_grid` :59-66,
`triples_total_sharded` :68-154, `triples_spatial_sharded` :157-234,
`triples_energy_sharded` :242-317).  JAX maps the tier's per-chunk
kernel over the mesh with shard_map and psum-reduces; here each entry
runs the tier one device would run, on operands copied to its device,
over an equal contiguous share of the work list that tier walks, and
the partial sums are added on the first entry in mesh order:

  spin-orbital — the strict i<j<k list: K1 ("fused") takes its share
      whole; "pallas" (panels + K2), "hybrid" and "f64" take their share
      padded with (0,0,0) triples, which contribute exactly zero, to
      whole chunks, as in JAX;
  restricted — the sorted i<=j<=k triples with their orbit weights (K3
      "fused", K4 "tiled"), or the (i, j-slab) grid ("pallas" panels +
      K5, "hybrid", "f64"), padded to a multiple of the mesh size with
      weight-0 cells, as in JAX.

The amplitudes and ERI slices are copied whole to every entry (JAX
replicates them, for the reasons in its docstring); only the v_vvvv
operand of CCSD is split (`ccsd_shard.py`).  Under "hybrid" the operands
of the f32 GEMMs are cast to f32 before they are copied, as JAX
downcasts before placement, so each entry holds half the bytes; the
orbital energies stay f64.  `triples_energy_sharded`
is the full-cube oracle of the parity tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .mesh import Mesh


def _padded_grid(total: int, ndev: int):
    """Pad a linear work grid to a multiple of ndev; returns (idx, w), w
    masking the padding entries to zero weight."""
    per = -(-total // ndev)
    idx = np.arange(per * ndev, dtype=np.int32)
    w = (idx < total).astype(np.float64)
    return np.where(idx < total, idx, 0).astype(np.int32), w


def _to(dev: torch.device, *xs):
    return tuple(None if x is None else x.to(dev) for x in xs)


def _add(acc, part):
    """Add an entry's partial (a tensor or a tuple of them) into `acc`,
    on acc's device."""
    if acc is None:
        return part
    if isinstance(part, tuple):
        return tuple(a + p.to(a.device) for a, p in zip(acc, part))
    return acc + part.to(acc.device)


def triples_total_sharded(mesh: Mesh, t1, t2, vovv, ovoo, oovv, e_o, e_v, *, nocc: int,
                          precision: str = "f64") -> float:
    """Spin-orbital E(T) over the strict i<j<k triples, the tier
    `precision` ("fused", "pallas", "hybrid" or "f64") on each entry's
    share."""
    from ..methods.triples_spinorb import _pick_clen, _triples_total_strict, strict_triple_list

    ii, jj, kk = strict_triple_list(nocc)
    total, ndev = len(ii), mesh.size
    if total == 0:
        return 0.0
    first = mesh.devices[0]
    per_raw = -(-total // ndev)
    if precision == "fused":
        clen = per = per_raw  # K1 chunks its share itself
    else:
        # equal whole-chunk shares, padded with zero-contribution (0,0,0)s
        clen = _pick_clen(e_v.shape[0], per_raw, precision)
        per = -(-per_raw // clen) * clen
        pad = np.zeros(per * ndev - total, dtype=np.int32)
        ii, jj, kk = (np.concatenate([x, pad]) for x in (ii, jj, kk))
    if precision == "hybrid":
        t1, t2, vovv, ovoo, oovv = (x.float() for x in (t1, t2, vovv, ovoo, oovv))
    args = (t1, t2, vovv, ovoo, oovv, e_o, e_v)
    acc = None
    for s, dev in enumerate(mesh.devices):
        share = slice(s * per, (s + 1) * per)
        if len(ii[share]) == 0:
            continue
        idx = (torch.as_tensor(x[share], dtype=torch.long, device=dev) for x in (ii, jj, kk))
        part = _triples_total_strict(*_to(dev, *args), *idx, clen=clen, precision=precision)
        acc = _add(acc, part.to(first))
    trace.synced()
    return float(acc)


def triples_spatial_sharded(mesh: Mesh, t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv_pp,
                            I_ooov_pp, *, nocc: int, jlen: int, doing_T: bool, doing_R: bool,
                            doing_CR: bool, precision: str = "f64") -> tuple:
    """The six restricted triples sums (in `triples_spatial._SUM_KEYS`
    order, as 0-d tensors on the first entry's device), the tier
    `precision` on each entry's share: the sorted triples for "fused"
    and "tiled", the (i, j-slab) grid for "pallas", "hybrid" and "f64"."""
    from ..methods import triples_spatial as TS
    from ..ops.triples_spatial_cuda import triples_fused_spatial, triples_tiled_spatial

    flags = dict(doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR)
    if precision == "hybrid":
        t1, t2, v_vvov, v_oovo, v_oovv, I_vovv_pp, I_ooov_pp = (
            x.float() for x in (t1, t2, v_vvov, v_oovo, v_oovv, I_vovv_pp, I_ooov_pp))
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, I_vovv_pp, I_ooov_pp)
    first, ndev = mesh.devices[0], mesh.size
    acc = None
    if precision in ("fused", "tiled"):
        kernel = triples_fused_spatial if precision == "fused" else triples_tiled_spatial
        si, sj, sk, w = TS.strict_spatial_plan(nocc)
        keep = w > 0
        si, sj, sk, w = si[keep], sj[keep], sk[keep], w[keep]
        per = -(-len(si) // ndev)
        for s, dev in enumerate(mesh.devices):
            share = slice(s * per, (s + 1) * per)
            if len(si[share]) == 0:
                continue
            idx = (torch.as_tensor(x[share], dtype=torch.int32, device=dev) for x in (si, sj, sk))
            ws = torch.as_tensor(w[share], dtype=torch.float64, device=dev)
            acc = _add(acc, kernel(*_to(dev, *args), *idx, ws, **flags).to(first))
        return (acc[0], acc[0] + acc[1], acc[2], acc[2] + acc[3], acc[4], acc[4] + acc[5])
    nslab = nocc // jlen
    idx, w = _padded_grid(nocc * nslab, ndev)
    per = len(idx) // ndev
    for s, dev in enumerate(mesh.devices):
        cells = [(int(k) // nslab, (int(k) % nslab) * jlen)
                 for k, wk in zip(idx[s * per:(s + 1) * per], w[s * per:(s + 1) * per]) if wk]
        if not cells:
            continue
        part = TS._triples_total_spatial(*_to(dev, *args), nocc=nocc, jlen=jlen,
                                         precision=precision, cells=cells, **flags)
        acc = _add(acc, tuple(x.to(first) for x in part))
    return acc


def triples_energy_sharded(mesh: Mesh, nocc: int, t1, t2, vovv, ovoo, oovv, e_o, e_v,
                           inner_chunk: int = 0) -> float:
    """Spin-orbital E(T) over the full (i, j, k) cube, each entry's
    share in chunks of `inner_chunk` triples (`triples_chunk_energies`)."""
    from ..methods.triples_spinorb import triples_chunk_energies

    ndev = mesh.size
    idx = np.arange(nocc)
    ii, jj, kk = (x.ravel() for x in np.meshgrid(idx, idx, idx, indexing="ij"))
    n = len(ii)
    per = -(-n // ndev)
    if inner_chunk <= 0:
        nvirt = e_v.shape[0]
        inner_chunk = max(1, min(per, int(1e9 / (3 * 8 * nvirt**3) + 1)))
    # the cube padded with zero-weight (0,0,0)s to ndev shares of whole chunks
    per_pad = -(-per // inner_chunk) * inner_chunk
    extra = per_pad * ndev - n
    w = np.concatenate([np.ones(n), np.zeros(extra)])
    ii, jj, kk = (np.concatenate([x, np.zeros(extra, dtype=x.dtype)]) for x in (ii, jj, kk))
    args = (t1, t2, vovv, ovoo, oovv, e_o, e_v)
    acc = None
    for s, dev in enumerate(mesh.devices):
        on_dev = _to(dev, *args)
        partials = []
        for c0 in range(s * per_pad, (s + 1) * per_pad, inner_chunk):
            c = slice(c0, c0 + inner_chunk)
            i, j, k = (torch.as_tensor(x[c], dtype=torch.long, device=dev) for x in (ii, jj, kk))
            e = triples_chunk_energies(i, j, k, *on_dev)
            partials.append(torch.dot(torch.as_tensor(w[c], dtype=e.dtype, device=dev), e))
        acc = _add(acc, torch.stack(partials).sum().to(mesh.devices[0]))
    trace.synced()
    return float(acc)
