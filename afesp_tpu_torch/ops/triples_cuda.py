"""The spin-orbital triples kernels: wrappers, plain versions, counters.

K1 `triples_fused` (csrc/triples_fused.cu) replaces
`afesp_tpu/ops/triples_pallas.py:triples_fused` (body `_fused_kernel`);
K2 `triples_finale` (csrc/triples_finale.cu) replaces
`afesp_tpu/ops/triples_pallas.py:triples_finale` (body `_finale_kernel`).
Both compute in f64 with f64 accumulation (the TPU kernels are f32 only
because Mosaic has no f64).  Each CUDA source's head note gives the
kernel's bound on the H100 and what its simple design leaves on the
table.

Each wrapper takes the JAX function's arguments and returns the same
sum, as a 0-d f64 tensor on the inputs' device.  Tensors on the CPU go
to the plain PyTorch version beside it; tensors on a CUDA device launch
the kernel, or raise — there is no fallback.  `launches` on each wrapper
counts the calls that launched its kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import trace
from ..device import current
from ._build import load

F64 = torch.float64
_VP = ctypes.c_void_p
# scratch budget of one K1 chunk: its compact t3c panels (rows, v/2, v/2,
# v/2) f64, one a (triple, allowed spin block); also the plain version's
# dense (C, v, v, v) chunk
FUSED_SCRATCH_BYTES = 2e9


def _ptr(t: torch.Tensor) -> _VP:
    return _VP(t.data_ptr())


def _stream(dev: torch.device) -> _VP:
    return _VP(torch.cuda.current_stream(dev).cuda_stream)


def _check(name: str, dev: torch.device, **tensors) -> None:
    for key, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
        if t.dtype != F64:
            raise ValueError(f"{name}: {key} has dtype {t.dtype}, expected float64")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def on_its_device(wrapper):
    """Run a kernel wrapper with the device of its first argument
    current: its launches go into that device's stream, which fails from
    another device's context (a mesh entry on a second card)."""

    @functools.wraps(wrapper)
    def run(*args, **kwargs):
        with current(args[0].device):
            return wrapper(*args, **kwargs)

    return run


# --------------------------------------------------------------- K2 -----


def triples_finale_plain(t3c, t3d, eo_sum, e_v) -> torch.Tensor:
    """sum P(t3c)(P(t3c)+P(t3d))/D over (P,v,v,v) panels, in f64, with
    P(x) = x - x[bac] - x[cba] and D = eo_sum[p] - ev[a] - ev[b] - ev[c]."""

    def p_abc(x):
        return x - x.permute(0, 2, 1, 3) - x.permute(0, 3, 2, 1)

    x, y = p_abc(t3c), p_abc(t3d)
    D = (
        eo_sum[:, None, None, None]
        - e_v[None, :, None, None]
        - e_v[None, None, :, None]
        - e_v[None, None, None, :]
    )
    return torch.sum(x * (x + y) / D)


@on_its_device
def triples_finale(t3c, t3d, eo_sum, e_v) -> torch.Tensor:
    """K2.  t3c/t3d: (P, v, v, v) panels; eo_sum: (P,) e_i+e_j+e_k per
    panel; e_v: (v,).  Returns sum P(t3c)*(P(t3c)+P(t3d))/D."""
    dev = t3c.device
    if dev.type == "cpu":
        return triples_finale_plain(t3c, t3d, eo_sum, e_v)
    if dev.type != "cuda":
        raise ValueError(f"triples_finale: unsupported device {dev}")
    _check("triples_finale", dev, t3c=t3c, t3d=t3d, eo_sum=eo_sum, e_v=e_v)
    P, v = t3c.shape[0], t3c.shape[1]
    if t3c.shape != (P, v, v, v) or t3d.shape != t3c.shape:
        raise ValueError(f"triples_finale: panels {tuple(t3c.shape)}, {tuple(t3d.shape)}")
    if eo_sum.shape != (P,) or e_v.shape != (v,):
        raise ValueError("triples_finale: eo_sum must be (P,) and e_v (v,)")
    if P == 0:
        return t3c.new_zeros(())
    lib = load("triples_finale")
    fn = lib.triples_finale_launch
    fn.argtypes = [_VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, _VP, _VP, _VP]
    fn.restype = ctypes.c_int
    partials = torch.empty(P * energy_blocks(v), dtype=F64, device=dev)
    out = torch.empty((), dtype=F64, device=dev)
    rc = fn(_ptr(t3c), _ptr(t3d), _ptr(eo_sum), _ptr(e_v), P, v, _ptr(partials), _ptr(out),
            _stream(dev))
    _raise_on("triples_finale", rc)
    triples_finale.launches += 1
    return out


triples_finale.launches = 0


# --------------------------------------------------------------- K1 -----

# K1's GEMM block tile (csrc/triples_fused.cu BM, BN, BK): rows of bc
# (the MMA's M), columns of a (its N), K rows of a shared-memory stage
GEMM_BM, GEMM_BN, GEMM_BK = 192, 112, 32
# the 3-bit spin assignments (sa, sb, sc) of an output block, in the
# plan's order: combination q has spins (q >> 2 & 1, q >> 1 & 1, q & 1)
_SPINS = [((q >> 2) & 1, (q >> 1) & 1, q & 1) for q in range(8)]


def fused_operands(t2, vovv, ovoo):
    """The dense K-concatenated GEMM operands of K1's plain version
    (layout of the TPU kernel's lhs/rhs blocks):
      L[p,q,a,:] = [t2[p,q,a,f] (f<v) | ovoo[m,a,p,q] (m<o)]   (o,o,v,v+o)
      R[x,:,bc]  = [vovv[f,x,b,c]     ; t2[m,x,b,c]]           (o,v+o,v*v)
    The m-sums enter with flipped sign through t2's (b,c) antisymmetry:
    sum_m t2[m,i,c,b] <ma||jk> = -sum_m t2[m,i,b,c] <ma||jk>."""
    o, v = t2.shape[0], t2.shape[2]
    L = torch.cat([t2, ovoo.permute(2, 3, 1, 0)], dim=3).contiguous()
    R = torch.cat([vovv.permute(1, 0, 2, 3), t2.permute(1, 0, 2, 3)], dim=1)
    return L, R.reshape(o, v + o, v * v).contiguous()


def spin_halves(o: int, v: int) -> tuple[int, int]:
    """(o/2, v/2): the alpha half of each space in block spin order
    (ops/spin.py), which K1 requires; raises on an odd o or v."""
    if o % 2 or v % 2:
        raise ValueError(f"triples_fused: o={o} and v={v} must be even (block spin order)")
    return o // 2, v // 2


def fused_tile_dims(o: int, v: int) -> tuple[int, int, int]:
    """(Np, Kp, MMp) of K1's spin-block GEMM: a over one spin half (v/2)
    padded to a multiple of 8 (the MMA's N), one term's K = v/2 + o/2 to
    an even count (16-byte copies never straddle two terms), bc over one
    (sb, sc) block ((v/2)^2) to a multiple of GEMM_BM (the MMA's M)."""
    o2, h = spin_halves(o, v)
    return -(-h // 8) * 8, -(-(h + o2) // 2) * 2, -(-(h * h) // GEMM_BM) * GEMM_BM


def _r_slot(sx, sb, sc):
    """R's block of (sb, sc) for an index of spin sx: the three (sb, sc)
    with sb + sc - sx in {0, 1}, in order."""
    return 2 * sb + sc - sx


def fused_tile_operands(t2, vovv, ovoo):
    """The operands of K1's GEMM by spin block, zero-padded to
    fused_tile_dims (h = v/2, o2 = o/2; s = the one spin of f and of m
    that a block allows):
      Lbuf (2, o, o, 2, Np, Kp): Lbuf[0, y, z, sa] = [t2[y,z,a,f] | ovoo[m,a,y,z]]
          for a of spin sa, f and m of spin s = sy + sz - sa (zero where
          s is not 0 or 1); Lbuf[1] = -Lbuf[0]
      Rbuf (o, 3, Kp, MMp):    Rbuf[x, _r_slot(sx, sb, sc)] = [vovv[f,x,b,c] ; t2[m,x,b,c]]
          for b of spin sb, c of spin sc, f and m of spin s = sb + sc - sx
    The negated copy carries the two minus terms, so the kernel's single
    accumulator takes all three products."""
    o, v = t2.shape[0], t2.shape[2]
    o2, h = spin_halves(o, v)
    Np, Kp, MMp = fused_tile_dims(o, v)
    spin = (torch.arange(o, device=t2.device) >= o2).long()
    pair = spin[:, None] + spin[None, :]
    t2b = t2.view(o, o, 2, h, 2, h)                               # [y, z, sa, a, sf, f]
    ovb = ovoo.view(2, o2, 2, h, o, o).permute(4, 5, 0, 2, 3, 1)  # [y, z, sm, sa, a, m]
    Lbuf = t2.new_zeros((2, o, o, 2, Np, Kp))
    for sa in (0, 1):
        for s in (0, 1):
            mask = (pair - sa == s)[:, :, None, None]
            Lbuf[0, :, :, sa, :h, :h] += torch.where(mask, t2b[:, :, sa, :, s, :], 0.0)
            Lbuf[0, :, :, sa, :h, h : h + o2] += torch.where(mask, ovb[:, :, s, sa], 0.0)
    Lbuf[1] = -Lbuf[0]
    Rbuf = t2.new_zeros((o, 3, Kp, MMp))
    vb = vovv.view(2, h, o, 2, h, 2, h)    # [sf, f, x, sb, b, sc, c]
    tb = t2.view(2, o2, o, 2, h, 2, h)     # [sm, m, x, sb, b, sc, c]
    for sx in (0, 1):
        xs = slice(sx * o2, (sx + 1) * o2)
        for sb in (0, 1):
            for sc in (0, 1):
                s = sb + sc - sx
                if s not in (0, 1):
                    continue
                blk = Rbuf[xs, _r_slot(sx, sb, sc)]
                blk[:, :h, : h * h] = vb[s, :, xs, sb, :, sc, :].transpose(0, 1).reshape(
                    o2, h, h * h)
                blk[:, h : h + o2, : h * h] = tb[s, :, xs, sb, :, sc, :].transpose(0, 1).reshape(
                    o2, o2, h * h)
    return Lbuf, Rbuf


def fused_block_plan(ii, jj, kk, o: int, v: int) -> dict:
    """K1's work list, built on the host from the strict triples (numpy
    integer arrays): one row a (triple, Sz-allowed output block).  A spin
    is p >= o/2 for an occupied index and a >= v/2 for a virtual one;
    block (sa, sb, sc) of triple (i, j, k) is allowed where sa + sb + sc
    = si + sj + sk (1 of 8 for an aaa or bbb triple, 3 of 8 otherwise),
    listed triple by triple in the order of _SPINS.  Returns numpy arrays:
      gemm   (R, 8) int64: the element offsets (L, R) into Lbuf and Rbuf
             of the row's terms, then how many there are, then 0.  The
             terms +L[j,k]R[i], -L[i,k]R[j], -L[j,i]R[k] keep those whose
             f and m spin s (= sy + sz - sa = sb + sc - sx) is 0 or 1,
             in that order; the others are zero and are not issued.
      energy (R, 8) int32: the triple's index, sa, sb, sc, the rows of
             the partner blocks (sb, sa, sc) and (sc, sb, sa) of the same
             triple (x[bac] and x[cba] are read there), 0, 0.
      starts (n + 1,): the first row of each triple, and R."""
    o2, h = spin_halves(o, v)
    Np, Kp, MMp = fused_tile_dims(o, v)
    ii, jj, kk = (np.asarray(x, dtype=np.int64) for x in (ii, jj, kk))
    total = (ii >= o2).astype(np.int64) + (jj >= o2) + (kk >= o2)
    combos = np.array(_SPINS, dtype=np.int64)
    allowed = combos.sum(1)[None, :] == total[:, None]          # (n, 8)
    tri, comb = np.nonzero(allowed)
    rank = np.cumsum(allowed, 1) - 1
    starts = np.concatenate([[0], np.cumsum(allowed.sum(1))])
    sa, sb, sc = combos[comb].T
    bac = starts[tri] + rank[tri, 4 * sb + 2 * sa + sc]
    cba = starts[tri] + rank[tri, 4 * sc + 2 * sb + sa]
    loffs, roffs, present = [], [], []
    for y, z, x, sign in ((jj, kk, ii, 0), (ii, kk, jj, 1), (jj, ii, kk, 1)):
        y, z, x = y[tri], z[tri], x[tri]
        s = (y >= o2).astype(np.int64) + (z >= o2) - sa
        present.append((s >= 0) & (s <= 1))
        loffs.append((((sign * o + y) * o + z) * 2 + sa) * (Np * Kp))
        roffs.append((x * 3 + _r_slot((x >= o2).astype(np.int64), sb, sc)) * Kp * MMp)
    present = np.stack(present, 1)
    order = np.argsort(~present, axis=1, kind="stable")        # present terms first
    take = lambda a: np.take_along_axis(np.stack(a, 1) * present, order, 1)
    gemm = np.zeros((len(tri), 8), dtype=np.int64)
    gemm[:, 0:6:2], gemm[:, 1:6:2] = take(loffs), take(roffs)
    gemm[:, 6] = present.sum(1)
    energy = np.zeros((len(tri), 8), dtype=np.int32)
    energy[:, :6] = np.stack([tri, sa, sb, sc, bac, cba], 1)
    return dict(gemm=gemm, energy=energy, starts=starts)


def fused_issued_macs(o: int, v: int, nterms) -> int:
    """The multiply-adds K1's block tiles issue over rows with `nterms`
    terms each, padding included: whole (GEMM_BM x GEMM_BN) tiles, each
    term's K rows padded to Kp and a row's K to a multiple of GEMM_BK."""
    Np, Kp, MMp = fused_tile_dims(o, v)
    nk = -(-np.asarray(nterms, dtype=np.int64) * Kp // GEMM_BK) * GEMM_BK
    return int(MMp * -(-Np // GEMM_BN) * GEMM_BN * nk.sum())


def fused_cube_macs(o: int, v: int, ntriples: int) -> int:
    """The multiply-adds the dense design issued for `ntriples` triples:
    one (v^2 x v x 3(v + o)) GEMM a triple on the same tile, padded as it
    padded (a to a multiple of 8, v + o to an even count, v^2 to a
    multiple of GEMM_BM, K to a multiple of GEMM_BK)."""
    Nd, Kd = -(-v // 8) * 8, -(-(v + o) // 2) * 2
    MMd = -(-(v * v) // GEMM_BM) * GEMM_BM
    return ntriples * MMd * -(-Nd // GEMM_BN) * GEMM_BN * -(-3 * Kd // GEMM_BK) * GEMM_BK


def energy_blocks(v: int) -> int:
    """Blocks of the energy walk (K1's energy pass, K2) a panel of side
    v, one partial each: (a, c) tiles of 32 a side times ranges of 16 b."""
    return (-(-v // 32)) ** 2 * -(-v // 16)


def fused_chunk_len(total: int, v: int) -> int:
    """Panels of side v per chunk: the scratch, one (v, v, v) f64 panel
    each, stays under FUSED_SCRATCH_BYTES, the energy pass's grid keeps
    under 65535 blocks along z (ceil(v / 16) a panel), and the chunks are
    of near-equal length."""
    zmax = 65535 // -(-v // 16)
    cmax = max(1, min(zmax, int(FUSED_SCRATCH_BYTES // (8 * v**3))))
    nchunk = -(-total // cmax)
    return -(-total // nchunk)


def fused_chunks(starts, h: int) -> list[tuple[int, int]]:
    """K1's chunks: (first row, end row) ranges of the plan's rows, each
    of whole triples (`starts` of fused_block_plan) and at most
    fused_chunk_len(rows, h) rows long, so the compact t3c scratch (one
    (h, h, h) panel a row) stays within FUSED_SCRATCH_BYTES.  A triple has
    at most 3 rows, within every budget."""
    starts = np.asarray(starts)
    clen = max(3, fused_chunk_len(int(starts[-1]), h))
    chunks, r0 = [], 0
    for t in range(1, len(starts)):
        if starts[t] - r0 > clen:
            chunks.append((r0, int(starts[t - 1])))
            r0 = int(starts[t - 1])
    if starts[-1] > r0:
        chunks.append((r0, int(starts[-1])))
    return chunks


def sz_block_norms(x: torch.Tensor) -> torch.Tensor:
    """The largest |element| of each spin block of a 2- or 4-index tensor
    in block spin order, shape (2,) * x.dim(), NaN where a block holds
    one; one reduction on x's device, no readback.  Every dimension must
    be even."""
    halves = x.view(*(d for n in x.shape for d in (2, n // 2)))
    return torch.linalg.vector_norm(halves, ord=float("inf"), dim=tuple(range(1, 2 * x.dim(), 2)))


def sz_forbidden_nonzero(norms: np.ndarray) -> bool:
    """Whether block norms (sz_block_norms', on the host) show a value
    that is not exactly zero in an Sz-forbidden block: a 2-index block
    (s0, s1) with s0 != s1, a 4-index one with s0 + s1 != s2 + s3
    (ops/spin_einsum.py's rule)."""
    s = np.indices(norms.shape)
    allowed = s[0] == s[1] if norms.ndim == 2 else s[0] + s[1] == s[2] + s[3]
    return bool((norms[~allowed] != 0).any())


def sz_project(t1, t2, vovv, ovoo, oovv, *rest) -> tuple:
    """K1's five operands (numpy, block spin order) with every Sz-forbidden
    spin block set to zero, as an RHF reference leaves them; `rest` (the
    orbital energies) passes through.  A spin is p >= o/2, a >= v/2, and
    the rule is sz_forbidden_nonzero's, which is symmetric under the
    antisymmetries, so they survive."""
    o, v = t1.shape
    so, sv = (np.arange(o) >= o // 2).astype(int), (np.arange(v) >= v // 2).astype(int)

    def keep(x, *spins):
        axes = [s.reshape([-1 if q == n else 1 for q in range(len(spins))])
                for n, s in enumerate(spins)]
        ok = axes[0] == axes[1] if len(axes) == 2 else axes[0] + axes[1] == axes[2] + axes[3]
        return np.where(ok, x, 0.0)

    return (keep(t1, so, sv), keep(t2, so, so, sv, sv), keep(vovv, sv, so, sv, sv),
            keep(ovoo, so, sv, so, so), keep(oovv, so, so, sv, sv), *rest)


def sz_violations(**tensors) -> list[str]:
    """The names of the tensors with a forbidden spin block that is not
    exactly zero (NaN included); reads each tensor's block norms back."""
    return [k for k, x in tensors.items() if sz_forbidden_nonzero(sz_block_norms(x).cpu().numpy())]


def _triple_sums(e_o, ii, jj, kk):
    return e_o[ii] + e_o[jj] + e_o[kk]


def triples_fused_plain(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk) -> torch.Tensor:
    """K1's function in plain torch over the dense spin-orbital cube, any
    input: the K-concatenated numerator products as batched matmuls,
    t3d, then the finale, chunk by chunk."""
    o, v = t1.shape
    L, R = fused_operands(t2, vovv, ovoo)
    W = oovv.reshape(o, o, v * v)
    ii, jj, kk = (x.long() for x in (ii, jj, kk))
    eo_sum = _triple_sums(e_o, ii, jj, kk)
    clen = fused_chunk_len(len(ii), v)
    total = t1.new_zeros(())
    for c0 in range(0, len(ii), clen):
        i, j, k = ii[c0 : c0 + clen], jj[c0 : c0 + clen], kk[c0 : c0 + clen]
        t3c = L[j, k] @ R[i] - L[i, k] @ R[j] - L[j, i] @ R[k]
        t3d = (
            t1[i][:, :, None] * W[j, k][:, None, :]
            - t1[j][:, :, None] * W[i, k][:, None, :]
            + t1[k][:, :, None] * W[i, j][:, None, :]
        )
        C = len(i)
        total = total + triples_finale_plain(
            t3c.reshape(C, v, v, v), t3d.reshape(C, v, v, v), eo_sum[c0 : c0 + clen], e_v
        )
    return total


def _pinned(arr, dev: torch.device) -> torch.Tensor:
    """A host array on `dev` by an asynchronous copy from pinned memory:
    no stream synchronisation, unlike a copy from pageable memory."""
    return torch.from_numpy(arr).pin_memory().to(dev, non_blocking=True)


@on_its_device
def triples_fused(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk, split=None) -> torch.Tensor:
    """K1.  Spin-orbital (T) over the given (i,j,k) triples: t1 (o,v),
    t2/oovv (o,o,v,v), vovv (v,o,v,v), ovoo (o,v,o,o), e_o (o,), e_v (v,),
    ii/jj/kk (C,) integer.  Returns the sum over the triples of
    P(t3c)(P(t3c)+P(t3d))/D; the caller applies the strict-grid 1/6.
    On a card the operands must be in block spin order (o and v even) and
    Sz-conserving, as an RHF reference leaves them: every forbidden spin
    block of t1, t2, vovv, ovoo and oovv exactly zero, or ValueError (the
    kernel computes only the allowed blocks of t3).  With a list `split`
    (CUDA only), CUDA events time each launch and the list gets one
    (numerator ms, energy ms) pair per chunk."""
    dev = t1.device
    if dev.type == "cpu":
        return triples_fused_plain(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk)
    if dev.type != "cuda":
        raise ValueError(f"triples_fused: unsupported device {dev}")
    _check("triples_fused", dev, t1=t1, t2=t2, vovv=vovv, ovoo=ovoo, oovv=oovv,
           e_o=e_o, e_v=e_v)
    o, v = t1.shape
    shapes = {"t2": (t2, (o, o, v, v)), "oovv": (oovv, (o, o, v, v)),
              "vovv": (vovv, (v, o, v, v)), "ovoo": (ovoo, (o, v, o, o)),
              "e_o": (e_o, (o,)), "e_v": (e_v, (v,))}
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"triples_fused: {key} is {tuple(t.shape)}, expected {want}")
    n = ii.shape[0]
    for key, t in (("ii", ii), ("jj", jj), ("kk", kk)):
        if t.device != dev or t.dtype not in (torch.int32, torch.int64) or t.shape != (n,):
            raise ValueError(f"triples_fused: {key} must be a ({n},) integer tensor on {dev}")
    _, h = spin_halves(o, v)
    if n == 0:
        return t1.new_zeros(())
    idx = torch.stack([x.to(torch.int32) for x in (ii, jj, kk)])
    lib = load("triples_fused")
    numerator = lib.triples_fused_numerator_launch
    numerator.argtypes = [_VP] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong, _VP, _VP]
    numerator.restype = ctypes.c_int
    energy = lib.triples_fused_energy_launch
    energy.argtypes = [_VP] * 8 + [ctypes.c_int] * 5 + [_VP] * 3
    energy.restype = ctypes.c_int
    finish = lib.triples_sum_launch
    finish.argtypes = [_VP, ctypes.c_longlong, _VP, _VP]
    finish.restype = ctypes.c_int

    Np, Kp, MMp = fused_tile_dims(o, v)
    Lbuf, Rbuf = fused_tile_operands(t2, vovv, ovoo)
    named = dict(t1=t1, t2=t2, vovv=vovv, ovoo=ovoo, oovv=oovv)
    norms = [sz_block_norms(x) for x in named.values()]
    # the one readback: the triples (the plan is built from them on the
    # host) and the contract's block norms; the card builds the operands
    # above meanwhile
    back = torch.cat([idx.reshape(-1).to(F64), *(x.reshape(-1) for x in norms)]).cpu().numpy()
    trace.synced()
    ih, jh, kh = back[: 3 * n].astype(np.int64).reshape(3, n)
    if min(ih.min(), jh.min(), kh.min()) < 0 or max(ih.max(), jh.max(), kh.max()) >= o:
        raise ValueError(f"triples_fused: triple indices outside [0, {o})")
    ends = np.cumsum([3 * n] + [x.numel() for x in norms])
    bad = [k for k, x, a, b in zip(named, norms, ends, ends[1:])
           if sz_forbidden_nonzero(back[a:b].reshape(x.shape))]
    if bad:
        raise ValueError(f"triples_fused: a forbidden spin block of {', '.join(bad)} is not "
                         "zero; K1 takes Sz-conserving operands in block spin order")
    plan = fused_block_plan(ih, jh, kh, o, v)
    gdesc, edesc = _pinned(plan["gemm"], dev), _pinned(plan["energy"], dev)
    chunks = fused_chunks(plan["starts"], h)
    rows = len(plan["gemm"])
    t3c = torch.empty((max(r1 - r0 for r0, r1 in chunks), h, h, h), dtype=F64, device=dev)
    per_row = energy_blocks(h)
    partials = torch.empty(rows * per_row, dtype=F64, device=dev)
    out = torch.empty((), dtype=F64, device=dev)
    eo_sum = _triple_sums(e_o, *idx.long()).contiguous()
    ii32, jj32, kk32 = (x.contiguous() for x in idx)
    stream = _stream(dev)
    for r0, r1 in chunks:
        marks = None if split is None else [torch.cuda.Event(enable_timing=True)
                                            for _ in range(3)]
        if marks:
            marks[0].record()
        rc = numerator(_ptr(Lbuf), _ptr(Rbuf), _ptr(gdesc[r0:]), r1 - r0, h, Kp, Np, MMp,
                       _ptr(t3c), stream)
        _raise_on("triples_fused", rc)
        if marks:
            marks[1].record()
        rc = energy(_ptr(t3c), _ptr(edesc[r0:]), _ptr(oovv), _ptr(t1), _ptr(ii32),
                    _ptr(jj32), _ptr(kk32), _ptr(eo_sum), r0, r1 - r0, o, v, h, _ptr(e_v),
                    _ptr(partials[r0 * per_row:]), stream)
        _raise_on("triples_fused", rc)
        if marks:
            marks[2].record()
            marks[2].synchronize()
            split.append((marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])))
    _raise_on("triples_fused", finish(_ptr(partials), partials.numel(), _ptr(out), stream))
    triples_fused.launches += 1
    triples_fused.issued_macs += fused_issued_macs(o, v, plan["gemm"][:, 6])
    triples_fused.cube_macs += fused_cube_macs(o, v, n)
    return out


triples_fused.launches = triples_fused.issued_macs = triples_fused.cube_macs = 0
trace.register("triples_fused.issued_macs", triples_fused, "issued_macs")
trace.register("triples_fused.cube_macs", triples_fused, "cube_macs")
