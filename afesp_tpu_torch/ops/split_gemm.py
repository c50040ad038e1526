"""Hi/lo split-f32 GEMMs (Ozaki split) for f64-grade contractions.

Port of `afesp_tpu/ops/split_gemm.py`.  Each f64 operand is split into
two f32 halves (48-bit combined mantissa); the three significant products
(hh, hl, lh) run as f32 GEMMs with the contraction axis chunked to `kc`,
so no accumulator sums more than kc terms, and the chunks combine in
f64.  Not exact: the f32 products round as they accumulate, so the card
and the CPU differ in the last f32 bits.  TF32 would void the split and
is refused (`exact_gemm._check_f32_exact`).

In the CCSD iterations this is the route of the hybrid contractions
only when no prechunked constants exist (`consts is None`); the solvers
always build them, so the digit GEMMs run there.
"""

from __future__ import annotations

import math

import torch

from ..device import F64
from .exact_gemm import F32, _check_f32_exact


def _chunk_A(Tm: torch.Tensor, kc: int):
    """(M,K) f64 -> hi/lo f32 halves in the (c, M, kc) chunk layout."""
    M, K = Tm.shape
    nc = -(-K // kc)
    Tc = torch.nn.functional.pad(Tm, (0, nc * kc - K)).reshape(M, nc, kc).transpose(0, 1)
    Ah = Tc.to(F32)
    return Ah, (Tc - Ah.to(F64)).to(F32)


def _chunk_B(Vm: torch.Tensor, kc: int):
    """(K,N) f64 -> hi/lo f32 halves in the (c, kc, N) chunk layout."""
    K, N = Vm.shape
    nc = -(-K // kc)
    Vc = torch.nn.functional.pad(Vm, (0, 0, 0, nc * kc - K)).reshape(nc, kc, N)
    Bh = Vc.to(F32)
    return Bh, (Vc - Bh.to(F64)).to(F32)


def split_matmul(Tm=None, Vm=None, kc: int = 64, A_pre=None, B_pre=None) -> torch.Tensor:
    """(M,K) @ (K,N) f64 as split-f32 GEMMs.  A_pre/B_pre take already
    split (hi, lo) chunk-layout halves of loop-constant operands."""
    Ah, Al = A_pre if A_pre is not None else _chunk_A(Tm, kc)
    Bh, Bl = B_pre if B_pre is not None else _chunk_B(Vm, kc)
    _check_f32_exact(Ah)
    return (
        torch.bmm(Ah, Bh).to(F64) + torch.bmm(Ah, Bl).to(F64) + torch.bmm(Al, Bh).to(F64)
    ).sum(0)


def split_einsum(sub: str, A: torch.Tensor, B: torch.Tensor, kc: int = 64) -> torch.Tensor:
    """Two-operand einsum as a split-f32 GEMM (split_matmul).  Plain
    contractions only: the shared subscripts are contracted, the free
    ones appear in the output in the order the caller wrote."""
    ins, out = sub.split("->")
    sa, sb = ins.split(",")
    contr = [c for c in sa if c in sb]
    fa = [c for c in sa if c not in contr]
    fb = [c for c in sb if c not in contr]
    if set(out) != set(fa + fb) or len(set(sa)) != len(sa):
        raise ValueError(f"split_einsum takes plain contractions only: {sub!r}")
    Ap = A.permute([sa.index(c) for c in fa + contr])
    Bp = B.permute([sb.index(c) for c in contr + fb])
    M = math.prod(Ap.shape[: len(fa)])
    K = math.prod(Ap.shape[len(fa):])
    N = math.prod(Bp.shape[len(contr):])
    C = split_matmul(Ap.reshape(M, K), Bp.reshape(K, N), kc)
    C = C.reshape(Ap.shape[: len(fa)] + Bp.shape[len(contr):])
    return C.permute([(fa + fb).index(c) for c in out])
