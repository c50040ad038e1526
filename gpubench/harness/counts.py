"""The yardstick's arithmetic: operation counts, bytes, the card's
published peaks and the roofline bound.

The counts are frozen copies of `afesp_tpu_torch/flops.py`'s
`digit_pairs`, `spatial_ccsd_iteration_flops` and
`spatial_triples_flops` (2x the multiply-accumulates of the algorithm's
contractions), so that a change to the program, or a kernel that does
the work another way, is still measured against the same work.  The
bound is `chip_smoke.py`'s: the larger of operations over the published
peak and bytes over the HBM bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates: f64 on the tensor cores,
# int8 on the tensor cores, HBM3 bandwidth
PEAK_F64 = 67e12
PEAK_INT8 = 1979e12
HBM_BYTES_S = 3.35e12
HYBRID = ("hybrid", "pallas", "fused")


def digit_pairs(L: int, maxdeg: int = 7) -> int:
    """Digit-pair products of one exact digit GEMM: pairs (i, j) with
    i, j < L and (i+1)+(j+1) <= maxdeg.  L=6/maxdeg=7 -> 21."""
    return sum(1 for i in range(L) for j in range(L) if i + j + 2 <= maxdeg)


def spatial_ccsd_iteration_flops(o: int, v: int, precision: str = "hybrid") -> float:
    """One spin-free CCSD iteration, dominant contractions only; on the
    digit-GEMM route ("hybrid") each contraction counts once per digit
    pair (int8 operations), at "f64" once (f64 operations)."""
    if precision in HYBRID:
        p6, p5, p4 = digit_pairs(6), digit_pairs(5), digit_pairs(4)
    else:
        p6 = p5 = p4 = 1
    mac = p6 * 1.0 * o * o * v**4    # c_oovv x v_vvvv
    mac += p6 * 6.0 * o**3 * v**3    # I_ovov / I_voov / x_voov family
    mac += (p5 + p4) * 1.0 * o**2 * v**3  # the v_vvov matricisations
    mac += p6 * 2.0 * o**4 * v * v   # I_oooo and its T2 consumer
    return 2.0 * mac


def spatial_ccsd_iteration_bytes(o: int, v: int) -> float:
    """Bytes one iteration has to move at least: every f64 ERI slice it
    contracts read once, the amplitudes read and their update written."""
    slices = v**4 + v**3 * o + 2 * o * o * v * v + o**3 * v + o**4
    amplitudes = 2 * (o * v + o * o * v * v)
    return 8.0 * (slices + amplitudes)


def spatial_triples_flops(o: int, v: int, doing_CR: bool = True, strict: bool = False) -> float:
    """The spin-free triples family: twelve t3 GEMMs a triple, doubled for
    the CR moment M3, plus the elementwise finale; `strict` counts the
    sorted triples i<=j<=k (what these inputs need), else the full cube."""
    ntrip = o * (o + 1) * (o + 2) // 6 if strict else o**3
    gemm_mac = ntrip * (6.0 * v**4 + 6.0 * o * v**3)
    if doing_CR:
        gemm_mac *= 2.0
    return 2.0 * gemm_mac + 20.0 * ntrip * v**3


def spatial_triples_bytes(o: int, v: int) -> float:
    """The amplitudes, integrals and CR intermediates the triples read
    once, in f64: t1, t2, v_vvov, v_oovo, v_oovv, I_vovv'', I_ooov''."""
    return 8.0 * (o * v + 2 * o * o * v * v + 2 * v**3 * o + 2 * o**3 * v)


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: ops at `peak` or bytes at the
    HBM bandwidth, whichever is longer."""
    return max(ops / peak, nbytes / HBM_BYTES_S)
