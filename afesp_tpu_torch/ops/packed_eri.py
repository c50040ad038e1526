"""8-fold-symmetric packed ERI <-> dense, with the unpack on the device.

Port of `afesp_tpu/ops/packed_eri.py:22-51`.  The reference stores the
ERI packed triangular-of-triangular (integrals.f90:10-45, `eri_ind`:
pair index ij = i(i+1)/2 + j for i>=j, quad index = ij(ij+1)/2 + kl for
ij>=kl).  The port uses the packed array as the transfer format: only
the packed unique elements cross PCIe (184 MB at 116 bf, against 1.45 GB
dense), and the dense (n,n,n,n) tensor every later stage reads is built
on the device by one gather over an index map made there from `arange`.
In the JAX package that gather is XLA's; here it is torch indexing.
"""

from __future__ import annotations

import torch


def pack_eri(eri: torch.Tensor) -> torch.Tensor:
    """Dense (n,n,n,n) chemist ERI -> packed unique elements, ordered by
    the reference's eri_ind (integrals.f90:196-210): the canonical
    quadruple (i>=j, k>=l, ij>=kl) sits at tri(ij) + kl with
    tri(x) = x(x+1)/2, the order `torch.tril_indices` enumerates."""
    n = eri.shape[0]
    I, J = torch.tril_indices(n, n, device=eri.device)  # pair p=(i,j), i>=j
    IJ, KL = torch.tril_indices(I.numel(), I.numel(), device=eri.device)  # ij>=kl
    return eri[I[IJ], J[IJ], I[KL], J[KL]].contiguous()


def pair_index(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """eri_ind's pair index tri(max) + min (integrals.f90:196-210), in
    the dtype of x and y."""
    lo, hi = torch.minimum(x, y), torch.maximum(x, y)
    return hi * (hi + 1) // 2 + lo


def unpack_eri(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Packed -> dense (n,n,n,n) as ONE gather on `packed`'s device.

    The (n^2, n^2) index map is made on that device from `arange`
    (uploading it would cost more than the dense tensor).  int32 index
    arithmetic, as in the JAX package, is exact for n <= 300
    (npair*(npair+1) < 2^31)."""
    assert n <= 300, "int32 packed-index arithmetic overflows beyond n=300"
    i = torch.arange(n, dtype=torch.int32, device=packed.device)
    pair = pair_index(i[:, None], i[None, :]).reshape(-1)  # (n^2,)
    ind = pair_index(pair[:, None], pair[None, :])  # (n^2, n^2)
    return packed[ind].reshape(n, n, n, n)


def expand_packed_rows(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Packed -> the f64 pair-row table (npair, n^2), rows[pair(i,j),
    k*n + l] = (ij|kl): half the dense tensor's elements (the rows
    i >= j), gathered on `packed`'s device in row blocks whose index
    holds at most 5e7 elements (int32 arithmetic, as `unpack_eri`)."""
    assert n <= 300, "int32 packed-index arithmetic overflows beyond n=300"
    npair = n * (n + 1) // 2
    dev = packed.device
    i = torch.arange(n, dtype=torch.int32, device=dev)
    kl = pair_index(i[:, None], i[None, :]).reshape(-1)  # (n^2,)
    rows = torch.empty((npair, n * n), dtype=packed.dtype, device=dev)
    bp = max(1, int(5e7 // (n * n)))
    for p0 in range(0, npair, bp):
        p = torch.arange(p0, min(p0 + bp, npair), dtype=torch.int32, device=dev)
        rows[p0:p0 + p.numel()] = packed[pair_index(p[:, None], kl[None, :])]
    return rows
