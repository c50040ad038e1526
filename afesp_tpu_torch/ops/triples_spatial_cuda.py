"""The restricted (spatial) triples kernels: wrappers, plain versions,
counters.

K3 `triples_fused_spatial` (csrc/triples_fused_spatial.cu) replaces
`afesp_tpu/ops/triples_pallas.py:triples_fused_spatial` (body
`_fused_spatial_kernel`); K4 `triples_tiled_spatial`
(csrc/triples_tiled_spatial.cu) replaces
`afesp_tpu/ops/triples_tiled.py:triples_tiled_spatial` (stage 2,
`_tiled_kernel`; stage 1 `_chunk_cubes` is batched torch matmuls here as
it is XLA there); K5 `triples_finale_spatial`
(csrc/triples_finale_spatial.cu) replaces
`afesp_tpu/ops/triples_pallas.py:triples_finale_spatial` (body
`_make_spatial_kernel`).  All compute in f64 with f64 accumulation (the
TPU kernels are f32 only because Mosaic has no f64).  Each CUDA source's
head note gives the kernel's bound on the H100 and what its simple
design leaves on the table.

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

import torch

from ._build import load
from .triples_cuda import F64, _check, _ptr, _raise_on, _stream, _VP

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

# scratch budget of one K3 chunk: its x and m cubes (C, v, v, v) f64
FUSED_SCRATCH_BYTES = 2e9
# budget of one K4 chunk: stage 1's four cubes plus its GEMM transients,
# ~8 (B, v, v, v) f64 arrays
TILED_SCRATCH_BYTES = 4e9
_REDUCE_SPAN = 8 * 256  # cube elements per reduction block (8 per thread)
_MAX_REDUCE_BLOCKS = 64  # per triple or panel


def _reduce_blocks(v: int) -> int:
    return max(1, min(_MAX_REDUCE_BLOCKS, -(-(v**3) // _REDUCE_SPAN)))


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
    """Stage 1 of K4 (and the cubes of K3's plain version): per-triple
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
    if n and (int(idx.min()) < 0 or int(idx.max()) >= o):
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
    fn.argtypes = [_VP] * 7 + [ctypes.c_int] * 6 + [_VP] * 3
    fn.restype = ctypes.c_int
    nb = _reduce_blocks(v)
    partials = torch.empty(P * nb * 6, dtype=F64, device=dev)
    out = torch.empty(6, dtype=F64, device=dev)
    rc = fn(_ptr(t3_D), _ptr(m3) if doing_CR else None, _ptr(mats), _ptr(vecs),
            _ptr(eo_sum), _ptr(t1_i), _ptr(e_v), P, v, int(doing_T), int(doing_Y),
            int(doing_CR), nb, _ptr(partials), _ptr(out), _stream(dev))
    _raise_on("triples_finale_spatial", rc)
    triples_finale_spatial.launches += 1
    return out


triples_finale_spatial.launches = 0


# --------------------------------------------------------------- K4 -----


def tiled_chunk_len(total: int, v: int) -> int:
    """Triples per K4 chunk: stage 1's ~8 live (B, v^3) f64 arrays stay
    under TILED_SCRATCH_BYTES, and the chunks are of near-equal length."""
    cmax = max(1, min(65535, int(TILED_SCRATCH_BYTES // (8 * 8 * v**3))))
    nchunk = -(-total // cmax)
    return -(-total // nchunk)


def triples_tiled_spatial_plain(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo,
                                ii, jj, kk, w, *, doing_T, doing_R, doing_CR) -> torch.Tensor:
    """K4's function in plain torch: stage 1's cubes per chunk, then the
    M-operator sums, weighted and summed."""
    return _sorted_triples_plain(
        t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
        doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR,
        chunk=tiled_chunk_len(max(1, ii.shape[0]), t1.shape[1]),
    )


def triples_tiled_spatial(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
                          *, doing_T: bool, doing_R: bool, doing_CR: bool) -> torch.Tensor:
    """K4.  t1 (o,v), t2/v_oovv (o,o,v,v), v_vvov (v,v,o,v), v_oovo
    (o,o,v,o), e_o (o,), e_v (v,), Iv = I_vovv'' (v,o,v,v) and Jo =
    I_ooov'' (o,o,o,v) (read only for CR; may be None otherwise), the
    sorted triples ii/jj/kk (C,) with their orbit weights w (C,).
    Returns the six weighted sums s0..s5."""
    flags = dict(doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR)
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w)
    dev = t1.device
    if dev.type == "cpu":
        return triples_tiled_spatial_plain(*args, **flags)
    if dev.type != "cuda":
        raise ValueError(f"triples_tiled_spatial: unsupported device {dev}")
    has_z, has_y, has_m = doing_T, doing_R or doing_CR, doing_CR
    idx = _check_sorted_triples("triples_tiled_spatial", dev, *args, has_m)
    n = ii.shape[0]
    if n == 0:
        return t1.new_zeros(6)
    o, v = t1.shape
    lib = load("triples_tiled_spatial")
    chunk = lib.triples_tiled_spatial_chunk_launch
    chunk.argtypes = [_VP] * 6 + [ctypes.c_int] * 3 + [_VP] * 2
    chunk.restype = ctypes.c_int

    ops = spatial_operands(t1, t2, v_vvov, v_oovo, v_oovv,
                           Iv if has_m else None, Jo if has_m else None)
    ii64, jj64, kk64 = idx.long()
    eo_sum = (e_o[ii64] + e_o[jj64] + e_o[kk64]).contiguous()
    clen = tiled_chunk_len(n, v)
    nb = _reduce_blocks(v)
    partials = torch.empty(n * nb * 6, dtype=F64, device=dev)
    stream = _stream(dev)
    for c0 in range(0, n, clen):
        sl = slice(c0, c0 + clen)
        B = min(clen, n - c0)
        cubes = _chunk_cubes(ops, ii64[sl], jj64[sl], kk64[sl],
                             has_z=has_z, has_y=has_y, has_m=has_m)
        rc = chunk(_ptr(cubes["x"]),
                   *(_ptr(cubes[k]) if k in cubes else None for k in ("m", "z", "y")),
                   _ptr(eo_sum[c0:]), _ptr(e_v), B, v, nb,
                   _ptr(partials[c0 * nb * 6:]), stream)
        _raise_on("triples_tiled_spatial", rc)
    out, rc = _weighted_sum(lib, partials, w, nb, dev)
    _raise_on("triples_tiled_spatial", rc)
    triples_tiled_spatial.launches += 1
    return out


triples_tiled_spatial.launches = 0


# --------------------------------------------------------------- K3 -----


class _Term(ctypes.Structure):
    _fields_ = [
        ("A", _VP), ("B", _VP),
        ("a_pair", ctypes.c_longlong), ("a_x", ctypes.c_longlong), ("a_k", ctypes.c_longlong),
        ("b_r", ctypes.c_longlong), ("b_k", ctypes.c_longlong),
        ("b_p", ctypes.c_longlong), ("b_q", ctypes.c_longlong),
        ("sign", ctypes.c_double),
        ("K", ctypes.c_int), ("pa", ctypes.c_int), ("pb", ctypes.c_int), ("r", ctypes.c_int),
    ]


class _Group(ctypes.Structure):
    _fields_ = [("t", _Term * 4), ("nterms", ctypes.c_int), ("axis", ctypes.c_int)]


def fused_term_groups(o: int, v: int, cube: str) -> list[list[dict]]:
    """K3's GEMM descriptors for one numerator cube ("x" = t3_D, "m" =
    m3), derived from the term tables: three groups (the cube axis a, b
    or c that a term's single index lands on), four terms each.  A term
    is
        cube[a,b,c] += sign * sum_K A[x][K] * B[K][y, z]
    with A[x][K] at  A + (idx[pa] o + idx[pb]) a_pair + x a_x + K a_k  and
    B[K][p, q] at    B + idx[r] b_r + K b_k + p b_p + q b_q,
    (p, q) being the two cube axes other than the group's, ascending.
    "A"/"B" name operands of `spatial_operands`."""
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
                pa=pa, pb=pb, r=r,
            ))
    return groups


def _ctypes_groups(groups: list[list[dict]], ops: dict):
    arr = (_Group * 3)()
    for g, terms in enumerate(groups):
        arr[g].nterms = len(terms)
        arr[g].axis = g
        for q, d in enumerate(terms):
            t = arr[g].t[q]
            t.A, t.B = ops[d["A"]].data_ptr(), ops[d["B"]].data_ptr()
            for key in ("a_pair", "a_x", "a_k", "b_r", "b_k", "b_p", "b_q", "sign",
                        "K", "pa", "pb", "r"):
                setattr(t, key, d[key])
    return arr


def fused_spatial_chunk_len(total: int, v: int, has_m: bool) -> int:
    """Triples per K3 chunk: the x (and m) cubes stay under
    FUSED_SCRATCH_BYTES, and the chunks are of near-equal length."""
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


def triples_fused_spatial(t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w,
                          *, doing_T: bool, doing_R: bool, doing_CR: bool) -> torch.Tensor:
    """K3.  The arguments of `triples_tiled_spatial`; returns the same six
    weighted sums s0..s5, with the numerator GEMMs in the kernel."""
    flags = dict(doing_T=doing_T, doing_R=doing_R, doing_CR=doing_CR)
    args = (t1, t2, v_vvov, v_oovo, v_oovv, e_o, e_v, Iv, Jo, ii, jj, kk, w)
    dev = t1.device
    if dev.type == "cpu":
        return triples_fused_spatial_plain(*args, **flags)
    if dev.type != "cuda":
        raise ValueError(f"triples_fused_spatial: unsupported device {dev}")
    has_z, has_y, has_m = doing_T, doing_R or doing_CR, doing_CR
    idx = _check_sorted_triples("triples_fused_spatial", dev, *args, has_m)
    n = ii.shape[0]
    if n == 0:
        return t1.new_zeros(6)
    o, v = t1.shape
    lib = load("triples_fused_spatial")
    cube_fn = lib.triples_fused_spatial_cube_launch
    cube_fn.argtypes = [_VP] * 4 + [ctypes.c_int] * 3 + [_VP] * 2
    cube_fn.restype = ctypes.c_int
    reduce_fn = lib.triples_fused_spatial_reduce_launch
    reduce_fn.argtypes = [_VP] * 10 + [ctypes.c_int] * 6 + [_VP] * 3
    reduce_fn.restype = ctypes.c_int

    ops = spatial_operands(t1, t2, v_vvov, v_oovo, v_oovv,
                           Iv if has_m else None, Jo if has_m else None)
    groups = {c: _ctypes_groups(fused_term_groups(o, v, c), ops)
              for c in (("x", "m") if has_m else ("x",))}
    ii32, jj32, kk32 = (x.contiguous() for x in idx)
    eo_sum = (e_o[ii32.long()] + e_o[jj32.long()] + e_o[kk32.long()]).contiguous()
    clen = fused_spatial_chunk_len(n, v, has_m)
    nb = _reduce_blocks(v)
    cubes = {c: torch.empty((clen, v, v, v), dtype=F64, device=dev) for c in groups}
    ujk = torch.empty((clen, v, v), dtype=F64, device=dev)
    partials = torch.empty(n * nb * 6, dtype=F64, device=dev)
    stream = _stream(dev)
    for c0 in range(0, n, clen):
        C = min(clen, n - c0)
        tri = (_ptr(ii32[c0:]), _ptr(jj32[c0:]), _ptr(kk32[c0:]))
        for c, arr in groups.items():
            rc = cube_fn(ctypes.addressof(arr), *tri, C, o, v, _ptr(cubes[c]), stream)
            _raise_on("triples_fused_spatial", rc)
        rc = reduce_fn(
            _ptr(cubes["x"]), _ptr(cubes["m"]) if has_m else None, _ptr(ops["t1"]),
            _ptr(ops["t2"]), _ptr(ops["W"]), _ptr(e_v), _ptr(eo_sum[c0:]), *tri,
            C, o, v, int(has_z), int(has_y), nb, _ptr(ujk),
            _ptr(partials[c0 * nb * 6:]), stream,
        )
        _raise_on("triples_fused_spatial", rc)
    out, rc = _weighted_sum(lib, partials, w, nb, dev)
    _raise_on("triples_fused_spatial", rc)
    triples_fused_spatial.launches += 1
    return out


triples_fused_spatial.launches = 0
