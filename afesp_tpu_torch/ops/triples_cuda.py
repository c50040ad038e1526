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

import torch

from ..device import current
from ._build import load

F64 = torch.float64
_VP = ctypes.c_void_p
# scratch budget of one K1 chunk: its t3c panels (C, v, v, v) f64
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

# rows (bc) of K1's GEMM block tile, csrc/triples_fused.cu BM
GEMM_BM = 192


def fused_operands(t2, vovv, ovoo):
    """The K-concatenated GEMM operands of K1 (layout of the TPU
    kernel's lhs/rhs blocks):
      L[p,q,a,:] = [t2[p,q,a,f] (f<v) | ovoo[m,a,p,q] (m<o)]   (o,o,v,v+o)
      R[x,:,bc]  = [vovv[f,x,b,c]     ; t2[m,x,b,c]]           (o,v+o,v*v)
    The m-sums enter with flipped sign through t2's (b,c) antisymmetry:
    sum_m t2[m,i,c,b] <ma||jk> = -sum_m t2[m,i,b,c] <ma||jk>."""
    o, v = t2.shape[0], t2.shape[2]
    L = torch.cat([t2, ovoo.permute(2, 3, 1, 0)], dim=3).contiguous()
    R = torch.cat([vovv.permute(1, 0, 2, 3), t2.permute(1, 0, 2, 3)], dim=1)
    return L, R.reshape(o, v + o, v * v).contiguous()


def fused_tile_dims(o: int, v: int) -> tuple[int, int, int]:
    """(Np, Kp, NNp): a padded to a multiple of 8 (the MMA's N), K = v + o
    to an even count (16-byte copies never straddle two terms), bc = v*v
    to a multiple of GEMM_BM (the MMA's M)."""
    return -(-v // 8) * 8, -(-(v + o) // 2) * 2, -(-(v * v) // GEMM_BM) * GEMM_BM


def fused_tile_operands(t2, vovv, ovoo):
    """The operands of K1's GEMM as its tiles read them, zero-padded to
    fused_tile_dims:
      Lbuf (2, o, o, Np, Kp): Lbuf[0] = L of fused_operands, Lbuf[1] = -L
      Rbuf (o, Kp, NNp):      R of fused_operands
    The negated copy carries the two minus terms, so the kernel's single
    accumulator takes all three products."""
    o, v = t2.shape[0], t2.shape[2]
    Np, Kp, NNp = fused_tile_dims(o, v)
    Lbuf = t2.new_zeros((2, o, o, Np, Kp))
    Lbuf[0, :, :, :v, :v] = t2
    Lbuf[0, :, :, :v, v : v + o] = ovoo.permute(2, 3, 1, 0)
    Lbuf[1] = -Lbuf[0]
    Rbuf = t2.new_zeros((o, Kp, NNp))
    Rbuf[:, :v, : v * v] = vovv.permute(1, 0, 2, 3).reshape(o, v, v * v)
    Rbuf[:, v : v + o, : v * v] = t2.permute(1, 0, 2, 3).reshape(o, o, v * v)
    return Lbuf, Rbuf


def fused_term_offsets(ii, jj, kk, o: int, v: int) -> torch.Tensor:
    """(C, 6) int64: for each triple the element offsets into Lbuf and
    Rbuf of its three terms' blocks, (L0, R0, L1, R1, L2, R2):
      +L[j,k] R[i],   -L[i,k] R[j],   -L[j,i] R[k]."""
    Np, Kp, NNp = fused_tile_dims(o, v)
    ii, jj, kk = (x.long() for x in (ii, jj, kk))
    lblock = torch.stack([jj * o + kk, o * o + ii * o + kk, o * o + jj * o + ii], 1)
    rblock = torch.stack([ii, jj, kk], 1)
    return torch.stack([lblock * (Np * Kp), rblock * (Kp * NNp)], 2).reshape(-1, 6).contiguous()


def energy_blocks(v: int) -> int:
    """Blocks of the energy walk (K1's energy pass, K2) a panel, one
    partial each: (a, c) tiles of 32 a side times ranges of 16 b."""
    return (-(-v // 32)) ** 2 * -(-v // 16)


def fused_chunk_len(total: int, v: int) -> int:
    """Triples per K1 chunk: the t3c scratch, one (v, v, v) panel a
    triple, stays under FUSED_SCRATCH_BYTES, the energy pass's grid keeps
    under 65535 blocks along z (ceil(v / 16) a triple), and the chunks
    are of near-equal length."""
    zmax = 65535 // -(-v // 16)
    cmax = max(1, min(zmax, int(FUSED_SCRATCH_BYTES // (8 * v**3))))
    nchunk = -(-total // cmax)
    return -(-total // nchunk)


def _triple_sums(e_o, ii, jj, kk):
    return e_o[ii] + e_o[jj] + e_o[kk]


def triples_fused_plain(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk) -> torch.Tensor:
    """K1's arithmetic in plain torch: the K-concatenated numerator
    products as batched matmuls, t3d, then the finale, chunk by chunk."""
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


@on_its_device
def triples_fused(t1, t2, vovv, ovoo, oovv, e_o, e_v, ii, jj, kk, split=None) -> torch.Tensor:
    """K1.  Spin-orbital (T) over the given (i,j,k) triples: t1 (o,v),
    t2/oovv (o,o,v,v), vovv (v,o,v,v), ovoo (o,v,o,o), e_o (o,), e_v (v,),
    ii/jj/kk (C,) integer.  Returns the sum over the triples of
    P(t3c)(P(t3c)+P(t3d))/D; the caller applies the strict-grid 1/6.
    With a list `split` (CUDA only), CUDA events time each launch and the
    list gets one (numerator ms, energy ms) pair per chunk."""
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
    if n == 0:
        return t1.new_zeros(())
    idx = torch.stack([x.to(torch.int32) for x in (ii, jj, kk)])
    lib = load("triples_fused")
    numerator = lib.triples_fused_numerator_launch
    numerator.argtypes = [_VP] * 3 + [ctypes.c_int] * 4 + [ctypes.c_longlong, _VP, _VP]
    numerator.restype = ctypes.c_int
    energy = lib.triples_fused_energy_launch
    energy.argtypes = [_VP] * 8 + [ctypes.c_int] * 3 + [_VP, _VP]
    energy.restype = ctypes.c_int
    finish = lib.triples_sum_launch
    finish.argtypes = [_VP, ctypes.c_longlong, _VP, _VP]
    finish.restype = ctypes.c_int

    Np, Kp, NNp = fused_tile_dims(o, v)
    Lbuf, Rbuf = fused_tile_operands(t2, vovv, ovoo)
    desc = fused_term_offsets(*idx, o, v)
    clen = fused_chunk_len(n, v)
    t3c = torch.empty((clen, v, v, v), dtype=F64, device=dev)
    per_triple = energy_blocks(v)
    partials = torch.empty(n * per_triple, dtype=F64, device=dev)
    out = torch.empty((), dtype=F64, device=dev)
    # the bounds check reads the indices back: the card builds the
    # operands above meanwhile, and nothing has gathered with them yet
    lo, hi = torch.stack(torch.aminmax(idx)).tolist()
    if lo < 0 or hi >= o:
        raise ValueError(f"triples_fused: triple indices outside [0, {o})")
    eo_sum = _triple_sums(e_o, *idx.long()).contiguous()
    ii32, jj32, kk32 = (x.contiguous() for x in idx)
    stream = _stream(dev)
    for c0 in range(0, n, clen):
        C = min(clen, n - c0)
        marks = None if split is None else [torch.cuda.Event(enable_timing=True)
                                            for _ in range(3)]
        if marks:
            marks[0].record()
        rc = numerator(_ptr(Lbuf), _ptr(Rbuf), _ptr(desc[c0:]), C, v, Kp, Np, NNp,
                       _ptr(t3c), stream)
        _raise_on("triples_fused", rc)
        if marks:
            marks[1].record()
        rc = energy(_ptr(t3c), _ptr(oovv), _ptr(t1), _ptr(ii32[c0:]), _ptr(jj32[c0:]),
                    _ptr(kk32[c0:]), _ptr(eo_sum[c0:]), _ptr(e_v), C, o, v,
                    _ptr(partials[c0 * per_triple:]), stream)
        _raise_on("triples_fused", rc)
        if marks:
            marks[2].record()
            marks[2].synchronize()
            split.append((marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])))
    _raise_on("triples_fused", finish(_ptr(partials), partials.numel(), _ptr(out), stream))
    triples_fused.launches += 1
    return out


triples_fused.launches = 0
