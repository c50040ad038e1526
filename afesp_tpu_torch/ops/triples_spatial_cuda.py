"""The restricted (spatial) triples kernels: wrappers, plain versions,
counters.

K3 `triples_fused_spatial` (csrc/triples_fused_spatial.cu) replaces
`afesp_tpu/ops/triples_pallas.py:triples_fused_spatial` (body
`_fused_spatial_kernel`); K4 `triples_tiled_spatial`
(csrc/triples_tiled_spatial.cu) replaces
`afesp_tpu/ops/triples_tiled.py:triples_tiled_spatial` (stage 1
`_chunk_cubes`, XLA einsums there, as a tensor-core GEMM kernel; stage 2
`_tiled_kernel` as an orbit-tile kernel; `_chunk_cubes` here is its
plain stage 1).  On the card K3 and K4 run the same kernels
(csrc/sorted_triples.cuh, `_sorted_triples_cuda`), each from its own
library and with its own counter.  K5 `triples_finale_spatial`
(csrc/triples_finale_spatial.cu) replaces
`afesp_tpu/ops/triples_pallas.py:triples_finale_spatial` (body
`_make_spatial_kernel`).  All compute in f64 with f64 accumulation (the
TPU kernels are f32 only because Mosaic has no f64).  Each CUDA source's
head note gives the kernel's bound on the H100 and what its design
leaves on the table.

K3 and K4 return the six sorted-triple sums, weighted by the orbits
(1, 1/2, 1/6) of `methods/triples_spatial.strict_spatial_plan`:

    s0 = x.M(t3)  s1 = x.M(z3)  s2 = y.M(t3)
    s3 = y.M(z3)  s4 = m.M(t3)  s5 = m.M(z3)

with x = t3_D, m = m3, t3 = x/D, z3 = zn/D and the class operator
M = 8 I - 4 (T_ab + T_ac + T_bc) + 2 (C + C^2).  (The JAX K3 returns
f32 partial grids and its caller weights them; here the kernel's last
pass applies the f64 weights.)  K5 returns the six xbar sums of one
i-slab's (j,k) panels, each divided by 3.  A sum whose variant is off
(z3 without (T), y without R/CR, m3 without CR) is exactly 0.

Each wrapper returns a (6,) f64 tensor on the inputs' device.  Tensors
on the CPU go to the plain PyTorch version beside it; tensors on a CUDA
device launch the kernel, or raise — there is no fallback.  `launches`
on each wrapper counts the calls that launched its kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import trace
from ._build import load
from .triples_cuda import F64, _check, _ptr, _raise_on, _stream, _VP, on_its_device

# Static term tables of the twelve joint (occ, virt) permutations of the
# two base contractions (ccsd.f90:2168-2173 / 2188-2193), copied from
# afesp_tpu/ops/triples_pallas.py.  Each entry: (lhs pair roles, rhs
# third role, axes permutation applied to the raw dot output).  Roles:
# 0 = i, 1 = j, 2 = k.
_ID = (0, 1, 2)
_SPATIAL_F_TERMS = (  # lhs t2[p,q] (a,f) @ rhs VvF/IvF[r] (f, b*c)
    ((0, 1), 2, _ID),
    ((1, 0), 2, (1, 0, 2)),
    ((2, 1), 0, (2, 1, 0)),
    ((0, 2), 1, (0, 2, 1)),
    ((1, 2), 0, (2, 0, 1)),
    ((2, 0), 1, (1, 2, 0)),
)
_SPATIAL_M_TERMS = (  # lhs VoL[r,q] (c,m) @ rhs t2M2[x] (m, b*a), sign -1
    ((2, 1), 0, (1, 2, 0)),
    ((2, 0), 1, (2, 1, 0)),
    ((0, 1), 2, (0, 2, 1)),
    ((1, 2), 0, (1, 0, 2)),
    ((0, 2), 1, _ID),
    ((1, 0), 2, (2, 0, 1)),
)
_SPATIAL_M3M_TERMS = (  # lhs JoT[p,q] (c,m) @ rhs t2M2[x] (m, b*a), sign -1
    ((1, 2), 0, (1, 2, 0)),
    ((0, 2), 1, (2, 1, 0)),
    ((1, 0), 2, (0, 2, 1)),
    ((2, 1), 0, (1, 0, 2)),
    ((2, 0), 1, _ID),
    ((0, 1), 2, (2, 0, 1)),
)
# the v_oovv (and t2) pair blocks of the z3 and y numerators: [j,k], [i,k], [i,j]
_WVV_PAIRS = ((1, 2), (0, 2), (0, 1))

# scratch budget of one chunk of K3's plain version: its x and m cubes
FUSED_SCRATCH_BYTES = 2e9
# budget of one chunk of K4's plain version: stage 1's four cubes plus its
# GEMM transients, ~8 (B, v, v, v) f64 arrays
TILED_SCRATCH_BYTES = 4e9


# ----------------------------------------------------- shared pieces -----


def spatial_operands(t1, t2, v_vvov, v_oovo, v_oovv, Iv, Jo):
    """The chunk-invariant operand layouts of the term tables (those of
    the JAX kernels, without their 128-lane padding), contiguous f64:
      VvF[r, f, y, z] = v_vvov[z, y, r, f]      IvF[r, f, y, z] = Iv[f, r, y, z]
      VoL[p, q, x, m] = v_oovo[p, q, x, m]      JoT[p, q, x, m] = Jo[p, q, m, x]
      t2M2[r, m, y, z] = t2[m, r, z, y]
    Iv/Jo may be None (no CR): IvF/JoT are then None."""
    c = lambda x: x.contiguous()
    return dict(
        t1=c(t1), t2=c(t2), W=c(v_oovv),
        VvF=c(v_vvov.permute(2, 3, 1, 0)),
        VoL=c(v_oovo),
        t2M2=c(t2.permute(1, 0, 3, 2)),
        IvF=None if Iv is None else c(Iv.permute(1, 0, 2, 3)),
        JoT=None if Jo is None else c(Jo.permute(0, 1, 3, 2)),
    )


def _chunk_cubes(ops: dict, ii, jj, kk, *, has_z: bool, has_y: bool, has_m: bool) -> dict:
    """Stage 1 of K4's and K3's plain versions: per-triple
    (B, v, v, v) f64 cubes of one chunk of sorted triples — "x" = t3_D,
    "m" = m3, "z" = the z3 numerator, "y" — as batched matmuls.  Port of
    afesp_tpu/ops/triples_tiled.py:_chunk_cubes, one orientation only."""
    idx = (ii, jj, kk)
    t2 = ops["t2"]
    B = ii.shape[0]
    o, v = t2.shape[0], t2.shape[2]

    def f_side(rhs_tab):
        acc = None
        for (pa, pb), r, perm in _SPATIAL_F_TERMS:
            lhs = t2[idx[pa], idx[pb]]  # (B, v, f)
            rhs = rhs_tab[idx[r]].reshape(B, v, v * v)  # (B, f, y*z)
            raw = torch.bmm(lhs, rhs).reshape(B, v, v, v)
            raw = raw.permute(0, *(q + 1 for q in perm))
            acc = raw if acc is None else acc + raw
        return acc

    def m_side(lhs_tab, terms):
        acc = None
        for (pa, pb), r, perm in terms:
            lhs = lhs_tab[idx[pa], idx[pb]]  # (B, v, m)
            rhs = ops["t2M2"][idx[r]].reshape(B, o, v * v)  # (B, m, y*z)
            raw = torch.bmm(lhs, rhs).reshape(B, v, v, v)
            raw = raw.permute(0, *(q + 1 for q in perm))
            acc = raw if acc is None else acc + raw
        return acc

    out = {"x": (f_side(ops["VvF"]) - m_side(ops["VoL"], _SPATIAL_M_TERMS)).contiguous()}
    if has_m:
        out["m"] = (f_side(ops["IvF"]) - m_side(ops["JoT"], _SPATIAL_M3M_TERMS)).contiguous()
    t1i, t1j, t1k = (ops["t1"][x] for x in idx)

    def rank3(X1, X2, X3):
        # r[a,b,c] = t1[i,a] X1[b,c] + t1[j,b] X2[a,c] + t1[k,c] X3[a,b]
        return (
            t1i[:, :, None, None] * X1[:, None, :, :]
            + t1j[:, None, :, None] * X2[:, :, None, :]
            + t1k[:, None, None, :] * X3[:, :, :, None]
        ).contiguous()

    pairs = lambda tab: [tab[idx[p], idx[q]] for p, q in _WVV_PAIRS]
    if has_z:  # z3 numerator (Piecuch Eq. 60; ccsd.f90:2178-2179), W = v_oovv
        out["z"] = rank3(*pairs(ops["W"]))
    if has_y:  # y (Piecuch Eq. 66; ccsd.f90:2183-2184)
        ujk, uik, uij = pairs(t2)
        out["y"] = rank3(t1j[:, :, None] * t1k[:, None, :] + ujk, uik, uij)
    return out


def _m_op(u: torch.Tensor) -> torch.Tensor:
    """M(u) = 8u - 4(T_ab + T_ac + T_bc)u + 2(C + C^2)u on the last three
    axes of (B, v, v, v)."""
    p = lambda *perm: u.permute(0, *perm)
    return 8.0 * u - 4.0 * (p(2, 1, 3) + p(3, 2, 1) + p(1, 3, 2)) + 2.0 * (p(2, 3, 1) + p(3, 1, 2))


def _denominator(eo_sum, e_v):
    return (
        eo_sum[:, None, None, None]
        - e_v[None, :, None, None]
        - e_v[None, None, :, None]
        - e_v[None, None, None, :]
    )


def _m_sums_plain(cubes: dict, eo_sum, e_v) -> torch.Tensor:
    """(B, 6) per-triple sums s0..s5 of the M-operator reductions."""
    x = cubes["x"]
    D = _denominator(eo_sum, e_v)
    mt = _m_op(x) / D
    mz = _m_op(cubes["z"]) / D if "z" in cubes else None
    zero = x.new_zeros(x.shape[0])
    dot = lambda g, f: (g * f).sum(dim=(1, 2, 3))
    y, m = cubes.get("y"), cubes.get("m")
    s = [
        dot(x, mt),
        dot(x, mz) if mz is not None else zero,
        dot(y, mt) if y is not None else zero,
        dot(y, mz) if y is not None and mz is not None else zero,
        dot(m, mt) if m is not None else zero,
        dot(m, mz) if m is not None and mz is not None else zero,
    ]
    return torch.stack(s, dim=1)


def _sorted_triples_plain(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
                          *, doing_T, doing_R, doing_CR, chunk: int) -> torch.Tensor:
    has_z, has_y, has_m = doing_T, doing_R or doing_CR, doing_CR
    ops = spatial_operands(t1, t2, v_vvov, v_oovo, v_oovv,
                           Iv if has_m else None, Jo if has_m else None)
    ii, jj, kk = (x.long() for x in (ii, jj, kk))
    total = t1.new_zeros(6)
    for c0 in range(0, ii.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        i, j, k = ii[sl], jj[sl], kk[sl]
        cubes = _chunk_cubes(ops, i, j, k, has_z=has_z, has_y=has_y, has_m=has_m)
        sums = _m_sums_plain(cubes, e_o[i] + e_o[j] + e_o[k], e_v)
        total = total + (w[sl][:, None] * sums).sum(dim=0)
    return total


def _check_sorted_triples(name, dev, t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo,
                          ii, jj, kk, w, has_m):
    tensors = dict(t1=t1, t2=t2, v_vvov=v_vvov, v_oovo=v_oovo, v_oovv=v_oovv,
                   e_o=e_o, e_v=e_v, w=w)
    if has_m:
        tensors.update(Iv=Iv, Jo=Jo)
    _check(name, dev, **tensors)
    o, v = t1.shape
    shapes = {"t2": (t2, (o, o, v, v)), "v_oovv": (v_oovv, (o, o, v, v)),
              "v_vvov": (v_vvov, (v, v, o, v)), "v_oovo": (v_oovo, (o, o, v, o)),
              "e_o": (e_o, (o,)), "e_v": (e_v, (v,))}
    if has_m:
        shapes.update(Iv=(Iv, (v, o, v, v)), Jo=(Jo, (o, o, o, v)))
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} is {tuple(t.shape)}, expected {want}")
    n = ii.shape[0]
    if w.shape != (n,):
        raise ValueError(f"{name}: w must be ({n},)")
    for key, t in (("ii", ii), ("jj", jj), ("kk", kk)):
        if t.device != dev or t.dtype not in (torch.int32, torch.int64) or t.shape != (n,):
            raise ValueError(f"{name}: {key} must be a ({n},) integer tensor on {dev}")
    idx = torch.stack([x.to(torch.int32) for x in (ii, jj, kk)])
    if n:
        # both ends in one read-back: on a card each read-back synchronises
        lo, hi = torch.stack(torch.aminmax(idx)).tolist()
        trace.synced()
        if lo < 0 or hi >= o:
            raise ValueError(f"{name}: triple indices outside [0, {o})")
    return idx


def _weighted_sum(lib, partials, w, nb, dev):
    fn = lib.triples_spatial_weighted_sum_launch
    fn.argtypes = [_VP, ctypes.c_longlong, _VP, ctypes.c_int, _VP, _VP]
    fn.restype = ctypes.c_int
    out = torch.empty(6, dtype=F64, device=dev)
    return out, fn(_ptr(partials), partials.numel() // 6, _ptr(w), nb, _ptr(out), _stream(dev))


# --------------------------------------------------------------- K5 -----


def triples_finale_spatial_plain(t3_D, m3, mats, vecs, eo_sum, t1_i, e_v, *,
                                 doing_T: bool, doing_Y: bool, doing_CR: bool) -> torch.Tensor:
    """The six xbar sums of the (P, v, v, v) panels, each divided by 3:
    t3 = t3_D/D, t_bar = xbar(t3), z3/z_bar and y from their factors."""
    D = _denominator(eo_sum, e_v)

    def xbar3(u):  # 3 * xbar(u) (make_x_bar, ccsd.f90:2313-2318)
        return 4.0 * u - 6.0 * u.permute(0, 1, 3, 2) + 2.0 * u.permute(0, 3, 1, 2)

    t3 = t3_D / D
    tb = xbar3(t3)
    t1j, t1k = vecs[:, 0], vecs[:, 1]
    zero = t3_D.new_zeros(())
    s = [torch.sum(tb * t3_D)] + [zero] * 5
    if doing_T:
        zn = (
            t1_i[None, :, None, None] * mats[:, 0, None, :, :]
            + t1j[:, None, :, None] * mats[:, 1, :, None, :]
            + t1k[:, None, None, :] * mats[:, 2, :, :, None]
        )
        zb = xbar3(zn / D)
        s[1] = torch.sum(zb * t3_D)
    if doing_Y:
        ujk = t1j[:, :, None] * t1k[:, None, :] + mats[:, 3]
        y = (
            t1_i[None, :, None, None] * ujk[:, None, :, :]
            + t1j[:, None, :, None] * mats[:, 4, :, None, :]
            + t1k[:, None, None, :] * mats[:, 5, :, :, None]
        )
        s[2] = torch.sum(tb * y)
        if doing_T:
            s[3] = torch.sum(zb * y)
    if doing_CR:
        s[4] = torch.sum(tb * m3)
        if doing_T:
            s[5] = torch.sum(zb * m3)
    return torch.stack(s) / 3.0


@on_its_device
def triples_finale_spatial(t3_D, m3, mats, vecs, eo_sum, t1_i, e_v, *,
                           doing_T: bool, doing_Y: bool, doing_CR: bool) -> torch.Tensor:
    """K5.  t3_D/m3: (P, v, v, v) numerator cubes (m3 read only for CR);
    mats: (P, 6, v, v) = [v_oovv[j,k], v_oovv[i,k], v_oovv[i,j], t2[j,k],
    t2[i,k], t2[i,j]]; vecs: (P, 2, v) = [t1[j], t1[k]]; eo_sum: (P,);
    t1_i, e_v: (v,).  Returns the six sums s0..s5, each divided by 3."""
    dev = t3_D.device
    flags = dict(doing_T=doing_T, doing_Y=doing_Y, doing_CR=doing_CR)
    if dev.type == "cpu":
        return triples_finale_spatial_plain(t3_D, m3, mats, vecs, eo_sum, t1_i, e_v, **flags)
    if dev.type != "cuda":
        raise ValueError(f"triples_finale_spatial: unsupported device {dev}")
    tensors = dict(t3_D=t3_D, mats=mats, vecs=vecs, eo_sum=eo_sum, t1_i=t1_i, e_v=e_v)
    if doing_CR:
        tensors["m3"] = m3
    _check("triples_finale_spatial", dev, **tensors)
    P, v = t3_D.shape[0], t3_D.shape[1]
    want = {"t3_D": (P, v, v, v), "m3": (P, v, v, v), "mats": (P, 6, v, v),
            "vecs": (P, 2, v), "eo_sum": (P,), "t1_i": (v,), "e_v": (v,)}
    for key, t in tensors.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"triples_finale_spatial: {key} is {tuple(t.shape)}, "
                             f"expected {want[key]}")
    if P == 0:
        return t3_D.new_zeros(6)
    lib = load("triples_finale_spatial")
    fn = lib.triples_finale_spatial_launch
    fn.argtypes = [_VP] * 8 + [ctypes.c_int] * 6 + [_VP] * 3
    fn.restype = ctypes.c_int
    tiles = orbit_tiles(v, dev)
    nT = tiles.shape[0]
    partials = torch.empty(P * nT * 6, dtype=F64, device=dev)
    out = torch.empty(6, dtype=F64, device=dev)
    rc = fn(_ptr(t3_D), _ptr(m3) if doing_CR else None, _ptr(mats), _ptr(vecs),
            _ptr(eo_sum), _ptr(t1_i), _ptr(e_v), _ptr(tiles), nT, P, v, int(doing_T),
            int(doing_Y), int(doing_CR), _ptr(partials), _ptr(out), _stream(dev))
    _raise_on("triples_finale_spatial", rc)
    triples_finale_spatial.launches += 1
    return out


triples_finale_spatial.launches = 0


# --------------------------------------------------------------- K4 -----

# the tiles of the numerator GEMM, csrc/spatial_gemm.cuh launch_group_tile:
# (p, q) rows x group-axis columns x K rows of a stage, and each tile's
# warps: WARPS_M rows of MT m16 tiles, WARPS_N columns sharing the tile's
# n8 tiles (the first ones one more where they do not divide evenly)
TILE_CONFIGS = ((128, 136, 16), (128, 160, 16), (128, 112, 16), (128, 56, 16))
TILE_WARPS = ((4, 2, 2), (2, 4, 4), (4, 2, 2), (4, 2, 2))
# K rows of one fragment step: a stage's steps wholly past K are skipped
GEMM_KSTEP = 8
# budget of one chunk of K3's and K4's kernels: the three GEMM groups' x
# (and m) cubes.  Chunks small enough for their cubes to stay in the
# H100's 50 MB L2 were slower (PERF.md §6), so a chunk is as large as
# this allows.
CUBE_BYTES = 6e9
_ORBIT_TILE = 8  # edge of the reductions' tiles, csrc/orbit_tile.cuh OT


def tiled_chunk_len(total: int, v: int) -> int:
    """Triples per chunk of K4's plain version: stage 1's ~8 live
    (B, v^3) f64 arrays stay under TILED_SCRATCH_BYTES, and the chunks are
    of near-equal length."""
    cmax = max(1, min(65535, int(TILED_SCRATCH_BYTES // (8 * 8 * v**3))))
    nchunk = -(-total // cmax)
    return -(-total // nchunk)


def cube_chunk_len(total: int, v: int, has_m: bool) -> int:
    """Triples per chunk of K3's and K4's kernels: the three groups' x
    (and m) cubes stay under CUBE_BYTES, the GEMM's grid holds the
    chunk's (cube, triple) pairs on z, and the chunks are of near-equal
    length."""
    ncube = 2 if has_m else 1
    cmax = max(1, min(65535 // ncube, int(CUBE_BYTES // (3 * ncube * 8 * v**3))))
    nchunk = -(-total // cmax)
    return -(-total // nchunk)


def _gemm_dims(o: int, v: int) -> tuple[int, int, int, int]:
    """(Np, Kv, Ko, NNp): the group axis padded to a multiple of 8 (the
    MMA's N), the t2 terms' K = v and the m terms' K = o each padded to an
    even count (16-byte copies never straddle two terms), the (p, q) rows
    v*v padded to a multiple of 8."""
    return -(-v // 8) * 8, -(-v // 2) * 2, -(-o // 2) * 2, -(-(v * v) // 8) * 8


def gemm_macs(o: int, v: int, tile: int) -> int:
    """The multiply-adds one group GEMM of one cube and triple issues
    with tile `tile` of TILE_CONFIGS: its row tiles over the NNp rows, its
    column tiles over the Np columns, its GEMM_KSTEP-deep steps over K."""
    Np, Kv, Ko, NNp = _gemm_dims(o, v)
    BM, BN, _ = TILE_CONFIGS[tile]
    up = lambda x, b: -(-x // b) * b
    return up(NNp, BM) * up(Np, BN) * up(2 * Kv + 2 * Ko, GEMM_KSTEP)


def useful_macs(o: int, v: int) -> int:
    """The multiply-adds of one group GEMM of one cube and triple at its
    true shape: v^2 rows, v columns, K = 2v + 2o."""
    return v**3 * (2 * v + 2 * o)


def tiled_tile_dims(o: int, v: int) -> tuple[int, int, int, int, int]:
    """(Np, Kv, Ko, NNp, tile) of the numerator GEMM (`_gemm_dims`), with
    the tile of TILE_CONFIGS that issues the fewest multiply-adds at this
    shape (`gemm_macs`), the first on a tie."""
    tile = min(range(len(TILE_CONFIGS)), key=lambda t: (gemm_macs(o, v, t), t))
    return (*_gemm_dims(o, v), tile)


def tiled_layout(o: int, v: int, has_m: bool):
    """Where the operand tables lie in their two flat buffers: (lefts,
    rights, lbase, rbase, lsize, rsize).  lefts: [(name, K)] of the
    (o, o, Np, K) left tables; rights: [(name, K)] of the (o, K, NNp)
    right tables, each in both (p, q) orders; the bases are element
    offsets, keyed by name and by (name, y_first)."""
    Np, Kv, Ko, NNp, _ = tiled_tile_dims(o, v)
    lefts = [("t2", Kv), ("VoL", Ko)] + ([("JoT", Ko)] if has_m else [])
    rights = [("VvF", Kv), ("t2M2", Ko)] + ([("IvF", Kv)] if has_m else [])
    lbase, off = {}, 0
    for name, K in lefts:
        lbase[name], off = off, off + o * o * Np * K
    lsize = off
    rbase, off = {}, 0
    for name, K in rights:
        for y_first in (True, False):
            rbase[name, y_first], off = off, off + o * K * NNp
    return lefts, rights, lbase, rbase, lsize, off


def layout_bases(o: int, v: int, has_m: bool) -> list[int]:
    """The nine element offsets that the layout kernel takes
    (csrc/spatial_gemm.cuh Layout): the left tables t2, VoL, JoT in
    Lbuf, then the right tables VvF, t2M2, IvF in Rbuf, each in the
    (y, z) order and its transpose; 0 for a table absent without CR."""
    lefts, rights, lbase, rbase, _, _ = tiled_layout(o, v, has_m)
    lb = [lbase[name] for name, _ in lefts]
    rb = [rbase[name, y_first] for name, _ in rights for y_first in (True, False)]
    return lb + [0] * (3 - len(lb)) + rb + [0] * (6 - len(rb))


def tiled_operands(ops: dict, has_m: bool):
    """What the layout kernel (csrc/spatial_gemm.cuh layout_kernel) lays
    out, in torch, for the CPU tests: the operand tables of the
    numerator GEMM, zero-padded to tiled_tile_dims and laid end to end
    (tiled_layout) in two flat f64 buffers:
      Lbuf: "t2" (o, o, Np, Kv) = t2;  "VoL" (o, o, Np, Ko) = -VoL;
            "JoT" = -JoT (CR)  — A[x][K] of a term at row x;
      Rbuf: (name, y_first) (o, K, NNp) for "VvF", "t2M2" and "IvF"
            (CR): the table with its last two axes flattened in (y, z)
            order (y_first) or (z, y) order — B[K][p, q] of a term.
    The m terms' tables are negated so that one accumulator takes the
    four terms of a group."""
    t2 = ops["t2"]
    o, v = t2.shape[0], t2.shape[2]
    Np, _, _, NNp, _ = tiled_tile_dims(o, v)
    lefts, rights, lbase, rbase, lsize, rsize = tiled_layout(o, v, has_m)
    Lbuf = t2.new_zeros(lsize)
    for name, K in lefts:
        tab = ops[name]  # (o, o, v, K')
        view = Lbuf[lbase[name] : lbase[name] + o * o * Np * K].view(o, o, Np, K)
        view[:, :, :v, : tab.shape[3]] = tab if name == "t2" else -tab
    Rbuf = t2.new_zeros(rsize)
    for name, K in rights:
        tab = ops[name]  # (o, K', v, v)
        for y_first in (True, False):
            b = rbase[name, y_first]
            src = tab if y_first else tab.transpose(2, 3)
            Rbuf[b : b + o * K * NNp].view(o, K, NNp)[:, : tab.shape[1], : v * v] = \
                src.reshape(o, tab.shape[1], v * v)
    return Lbuf, Rbuf


@functools.lru_cache(maxsize=16)
def _term_tables(o: int, v: int, cubes: tuple[str, ...], device: torch.device):
    """The per-shape (base, coef) tables of the term offsets on `device`:
    an offset is base + sum over the roles (i, j, k) of the triple's
    index times coef."""
    Np, Kv, Ko, NNp, _ = tiled_tile_dims(o, v)
    _, _, lbase, rbase, _, _ = tiled_layout(o, v, "m" in cubes)
    base = np.zeros((len(cubes), 3, 8), dtype=np.int64)
    coef = np.zeros((len(cubes), 3, 8, 3), dtype=np.int64)
    for q, cube in enumerate(cubes):
        for g, terms in enumerate(fused_term_groups(o, v, cube)):
            assert [d["A"] == "t2" for d in terms] == [True, True, False, False]
            for t, d in enumerate(terms):
                lk = Kv if d["A"] == "t2" else Ko
                rk = Ko if d["B"] == "t2M2" else Kv
                # L: (idx[pa] o + idx[pb]) Np lk;  R: idx[r] rk NNp
                base[q, g, 2 * t] = lbase[d["A"]]
                coef[q, g, 2 * t, d["pa"]] += o * Np * lk
                coef[q, g, 2 * t, d["pb"]] += Np * lk
                base[q, g, 2 * t + 1] = rbase[d["B"], d["y_first"]]
                coef[q, g, 2 * t + 1, d["r"]] += rk * NNp
    return torch.as_tensor(base, device=device), torch.as_tensor(coef, device=device)


def tiled_term_offsets(ii, jj, kk, o: int, v: int, cubes: tuple[str, ...]) -> torch.Tensor:
    """The term offsets that the layout kernel writes, in torch, for the
    CPU tests: (len(cubes), C, 3, 8) int64, for each cube, triple and
    group of fused_term_groups, the element offsets into Lbuf and Rbuf
    of tiled_operands (with CR iff "m" is among the cubes) of its four
    terms, (L0, R0, L1, R1, L2, R2, L3, R3): two t2 terms (K = Kv), then
    two m terms (K = Ko)."""
    base, coef = _term_tables(o, v, tuple(cubes), ii.device)
    idx = torch.stack([x.long() for x in (ii, jj, kk)], 1)  # (C, 3)
    desc = base + (idx[:, None, None, None, :] * coef).sum(-1)
    return desc.permute(1, 0, 2, 3).contiguous()


@functools.lru_cache(maxsize=16)
def orbit_tiles(v: int, device=None) -> torch.Tensor:
    """(nT, 3) int32: the sorted triples A <= B <= C of the reductions'
    8-wide tiles, one block each; every tile of a cube lies in the orbit
    of exactly one."""
    nt = -(-v // _ORBIT_TILE)
    return torch.combinations(torch.arange(nt, dtype=torch.int32), 3,
                              with_replacement=True).contiguous().to(device)


def spatial_gemm(name: str, group_fn, args: tuple, *, o: int, v: int, tile: int, ncube: int,
                 C: int) -> None:
    """One launch of the numerator group GEMM (csrc/spatial_gemm.cuh)
    through `group_fn`, the `spatial_group_launch` of K3's or K4's library
    (`name`), over ncube cubes of C triples; raises if it is refused.
    Counts the launches (`launches`), the multiply-adds the launch issues
    over its tiles (`issued_macs`, `gemm_macs`) and those of the true
    shapes (`useful_macs`)."""
    _raise_on(name, group_fn(*args))
    spatial_gemm.launches += 1
    spatial_gemm.issued_macs += ncube * C * gemm_macs(o, v, tile)
    spatial_gemm.useful_macs += ncube * C * useful_macs(o, v)


spatial_gemm.launches = spatial_gemm.issued_macs = spatial_gemm.useful_macs = 0
trace.register("spatial_gemm.launches", spatial_gemm)
trace.register("spatial_gemm.issued_macs", spatial_gemm, "issued_macs")
trace.register("spatial_gemm.useful_macs", spatial_gemm, "useful_macs")


def _sorted_triples_cuda(wrapper, args, *, doing_T, doing_R, doing_CR, split) -> torch.Tensor:
    """K3's and K4's path on the card (csrc/sorted_triples.cuh, built
    into the library named after `wrapper`): one layout launch a call,
    then a chunk at a time (cube_chunk_len) three group GEMMs, each
    writing its own x and m cubes, and one orbit-tile reduction over
    their sums, then the weighted sum; `wrapper.launches` counts the
    calls that launch.  With a list `split`, CUDA events time the call's
    parts and the list gets [group-0 ms, group-1 ms, group-2 ms,
    reduction ms, operand ms]: the group GEMMs and the reduction summed
    over the chunks, the operand part from the wrapper's first device
    work through the layout launch."""
    name = wrapper.__name__
    t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w = args
    dev = t1.device
    has_z, has_y, has_m = doing_T, doing_R or doing_CR, doing_CR
    idx = _check_sorted_triples(name, dev, *args, has_m)
    n = ii.shape[0]
    if n == 0:
        return t1.new_zeros(6)
    o, v = t1.shape
    lib = load(name)
    layout_fn = lib.spatial_layout_launch
    layout_fn.argtypes = ([_VP] * 11 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                          + [ctypes.c_int] * 7 + [ctypes.c_longlong] + [_VP] * 4)
    layout_fn.restype = ctypes.c_int
    group_fn = lib.spatial_group_launch
    group_fn.argtypes = ([_VP] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                         + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                         + [_VP] * 2)
    group_fn.restype = ctypes.c_int
    orbit_fn = lib.spatial_orbit_launch
    orbit_fn.argtypes = ([_VP] * 2 + [ctypes.c_longlong] + [_VP] * 9 + [ctypes.c_int] * 6
                         + [_VP] * 2)
    orbit_fn.restype = ctypes.c_int

    timed = split is not None
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if timed else []
    if timed:
        marks[0].record()
    cubes = ("x", "m") if has_m else ("x",)
    ncube = len(cubes)
    Np, Kv, Ko, NNp, tile = tiled_tile_dims(o, v)
    lefts, rights, _, _, lsize, rsize = tiled_layout(o, v, has_m)
    bases = (ctypes.c_longlong * 9)(*layout_bases(o, v, has_m))
    dbase, dcoef = _term_tables(o, v, cubes, dev)
    ii32, jj32, kk32 = (x.contiguous() for x in idx)
    Lbuf = torch.empty(lsize, dtype=F64, device=dev)
    Rbuf = torch.empty(rsize, dtype=F64, device=dev)
    desc = torch.empty((ncube, n, 3, 8), dtype=torch.int64, device=dev)
    stream = _stream(dev)
    rc = layout_fn(_ptr(t2), _ptr(v_vvov), _ptr(v_oovo), _ptr(Iv) if has_m else None,
                   _ptr(Jo) if has_m else None, _ptr(dbase), _ptr(dcoef), _ptr(ii32),
                   _ptr(jj32), _ptr(kk32), ctypes.cast(bases, _VP), len(lefts), len(rights),
                   lsize, rsize, ncube, n, o, v, Np, Kv, Ko, NNp, _ptr(Lbuf), _ptr(Rbuf),
                   _ptr(desc), stream)
    _raise_on(name, rc)
    tiles = orbit_tiles(v, dev)
    nT = tiles.shape[0]
    clen = cube_chunk_len(n, v, has_m)
    # (group, cube, triple): each group's GEMM writes cubes of its own
    scratch = torch.empty((3, ncube, clen, v, v, v), dtype=F64, device=dev)
    partials = torch.empty(n * nT * 6, dtype=F64, device=dev)
    if timed:
        marks[1].record()
    spans = []
    for c0 in range(0, n, clen):
        C = min(clen, n - c0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)] if timed else []
        if timed:
            ev[0].record()
        for group in range(3):
            spatial_gemm(name, group_fn, (_ptr(Lbuf), _ptr(Rbuf), _ptr(desc[0, c0:]), n * 24,
                                          ncube, C, v, Kv, Ko, Np, NNp, tile, group,
                                          clen * v**3, _ptr(scratch[group]), stream),
                         o=o, v=v, tile=tile, ncube=ncube, C=C)
            if timed:
                ev[group + 1].record()
        rc = orbit_fn(_ptr(scratch[0, 0]), _ptr(scratch[0, 1]) if has_m else None,
                      ncube * clen * v**3, _ptr(t1), _ptr(t2), _ptr(v_oovv), _ptr(e_v), _ptr(e_o),
                      _ptr(ii32[c0:]), _ptr(jj32[c0:]), _ptr(kk32[c0:]), _ptr(tiles), nT, C, o,
                      v, int(has_z), int(has_y), _ptr(partials[c0 * nT * 6:]), stream)
        _raise_on(name, rc)
        if timed:
            ev[4].record()
            spans.append(ev)
    out, rc = _weighted_sum(lib, partials, w, nT, dev)
    _raise_on(name, rc)
    if timed:
        torch.cuda.synchronize(dev)
        split.extend([sum(e[q].elapsed_time(e[q + 1]) for e in spans) for q in range(4)]
                     + [marks[0].elapsed_time(marks[1])])
    wrapper.launches += 1
    return out


def triples_tiled_spatial_plain(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo,
                                ii, jj, kk, w, *, doing_T, doing_R, doing_CR) -> torch.Tensor:
    """K4's function in plain torch: stage 1's cubes per chunk, then the
    M-operator sums, weighted and summed."""
    return _sorted_triples_plain(
        t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
        doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR,
        chunk=tiled_chunk_len(max(1, ii.shape[0]), t1.shape[1]),
    )


@on_its_device
def triples_tiled_spatial(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
                          *, doing_T: bool, doing_R: bool, doing_CR: bool,
                          split=None) -> torch.Tensor:
    """K4.  t1 (o,v), t2/v_oovv (o,o,v,v), v_vvov (v,v,o,v), v_oovo
    (o,o,v,o), e_o (o,), e_v (v,), Iv = I_vovv'' (v,o,v,v) and Jo =
    I_ooov'' (o,o,o,v) (read only for CR; may be None otherwise), the
    sorted triples ii/jj/kk (C,) with their orbit weights w (C,).
    Returns the six weighted sums s0..s5.  On the card it runs the
    kernels of K3 (`_sorted_triples_cuda`), from its own library;
    `split` (CUDA only) is that function's."""
    flags = dict(doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR)
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w)
    dev = t1.device
    if dev.type == "cpu":
        return triples_tiled_spatial_plain(*args, **flags)
    if dev.type != "cuda":
        raise ValueError(f"triples_tiled_spatial: unsupported device {dev}")
    return _sorted_triples_cuda(triples_tiled_spatial, args, **flags, split=split)


triples_tiled_spatial.launches = 0


# --------------------------------------------------------------- K3 -----


def fused_term_groups(o: int, v: int, cube: str) -> list[list[dict]]:
    """The numerator GEMM's term descriptors for one numerator cube
    ("x" = t3_D, "m" = m3), derived from the term tables: three groups
    (the cube axis a, b or c that a term's single index lands on), four
    terms each.  A term is
        cube[a,b,c] += sign * sum_K A[x][K] * B[K][y, z]
    with A[x][K] at  A + (idx[pa] o + idx[pb]) a_pair + x a_x + K a_k  and
    B[K][p, q] at    B + idx[r] b_r + K b_k + p b_p + q b_q,
    (p, q) being the two cube axes other than the group's, ascending;
    "y_first" says whether (p, q) is the B table's (y, z) order (the
    GEMM reads the table flattened in that order).  "A"/"B" name
    operands of `spatial_operands`.  Within a group the two t2 terms
    come first."""
    v2, v3 = v * v, v**3
    f_lhs = dict(A="t2", a_pair=v2, a_x=v, a_k=1, K=v, sign=1.0)
    f_rhs = dict(B="VvF" if cube == "x" else "IvF", b_r=v3, b_k=v2, b_y=v, b_z=1)
    if cube == "x":
        m_lhs = dict(A="VoL", a_pair=v * o, a_x=o, a_k=1, K=o, sign=-1.0)
        m_terms = _SPATIAL_M_TERMS
    else:
        m_lhs = dict(A="JoT", a_pair=v * o, a_x=o, a_k=1, K=o, sign=-1.0)
        m_terms = _SPATIAL_M3M_TERMS
    m_rhs = dict(B="t2M2", b_r=o * v2, b_k=v2, b_y=v, b_z=1)
    groups = [[], [], []]
    for terms, lhs, rhs in ((_SPATIAL_F_TERMS, f_lhs, f_rhs), (m_terms, m_lhs, m_rhs)):
        for (pa, pb), r, perm in terms:
            # transpose(raw, perm): cube axis n holds raw axis perm[n]
            axis, y_ax, z_ax = (perm.index(q) for q in range(3))
            y_first = y_ax < z_ax  # y is the lower of the two pair axes
            b_y, b_z = rhs["b_y"], rhs["b_z"]
            groups[axis].append(dict(
                A=lhs["A"], a_pair=lhs["a_pair"], a_x=lhs["a_x"], a_k=lhs["a_k"],
                K=lhs["K"], sign=lhs["sign"],
                B=rhs["B"], b_r=rhs["b_r"], b_k=rhs["b_k"],
                b_p=b_y if y_first else b_z, b_q=b_z if y_first else b_y,
                y_first=y_first, pa=pa, pb=pb, r=r,
            ))
    return groups


def fused_spatial_chunk_len(total: int, v: int, has_m: bool) -> int:
    """Triples per chunk of K3's plain version: the x (and m) cubes stay
    under FUSED_SCRATCH_BYTES, and the chunks are of near-equal length."""
    ncube = 2 if has_m else 1
    cmax = max(1, min(65535, int(FUSED_SCRATCH_BYTES // (ncube * 8 * v**3))))
    nchunk = -(-total // cmax)
    return -(-total // nchunk)


def triples_fused_spatial_plain(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo,
                                ii, jj, kk, w, *, doing_T, doing_R, doing_CR) -> torch.Tensor:
    """K3's function in plain torch: the numerator cubes per chunk as
    batched matmuls, z3/y from their factors, the M-operator sums,
    weighted and summed."""
    return _sorted_triples_plain(
        t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
        doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR,
        chunk=fused_spatial_chunk_len(max(1, ii.shape[0]), t1.shape[1], doing_CR),
    )


@on_its_device
def triples_fused_spatial(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
                          *, doing_T: bool, doing_R: bool, doing_CR: bool,
                          split=None) -> torch.Tensor:
    """K3.  The arguments of `triples_tiled_spatial`; returns the same six
    weighted sums s0..s5.  On the card it runs `_sorted_triples_cuda`
    (one layout launch, three group GEMMs and one orbit-tile reduction a
    chunk, the weighted sum) from its own library; `split` (CUDA only)
    is that function's."""
    flags = dict(doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR)
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w)
    dev = t1.device
    if dev.type == "cpu":
        return triples_fused_spatial_plain(*args, **flags)
    if dev.type != "cuda":
        raise ValueError(f"triples_fused_spatial: unsupported device {dev}")
    return _sorted_triples_cuda(triples_fused_spatial, args, **flags, split=split)


triples_fused_spatial.launches = 0
