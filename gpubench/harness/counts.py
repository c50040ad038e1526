"""The yardstick's arithmetic: operation counts, bytes, the card's
published peaks and the roofline bound.

The counts are frozen copies of `afesp_tpu_torch/flops.py`'s
`digit_pairs`, `spatial_ccsd_iteration_flops`, `spatial_triples_flops`,
`sz_fraction` and `spinorb_ccsd_iteration_flops` (2x the
multiply-accumulates of the algorithm's contractions), so that a change
to the program, or a kernel that does the work another way, is still
measured against the same work.  `spinorb_triples_flops` departs from
its namesake there: it counts the spin blocks an RHF reference leaves
nonzero, as the spin-orbital CCSD count does, where the program's counts
the dense cube.  The spin-orbital counts take spin-orbital extents:
twice the spatial nocc and nvirt.  The
bound is `chip_smoke.py`'s: the larger of operations over the published
peak and bytes over the HBM bandwidth.
"""

from __future__ import annotations

from itertools import product
from math import comb

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


def sz_fraction(spec: str) -> float:
    """The share of a dense contraction's multiply-accumulates that Sz
    block sparsity leaves: of the 2^letters spin assignments, those in
    which every operand's block is allowed (a 2-index operand: equal
    spins; a 4-index one: s0 + s1 == s2 + s3), each (1/2)^letters."""
    ins = spec.split("->")[0].split(",")
    letters = sorted(set("".join(ins)))
    ok = 0
    for bits in range(2 ** len(letters)):
        s = {c: (bits >> i) & 1 for i, c in enumerate(letters)}
        good = True
        for sp in ins:
            sig = [s[c] for c in sp]
            if len(sig) == 2 and sig[0] != sig[1]:
                good = False
            if len(sig) == 4 and sig[0] + sig[1] != sig[2] + sig[3]:
                good = False
        ok += good
    return ok / 2 ** len(letters)


def spinorb_ccsd_iteration_flops(o: int, v: int, precision: str = "f64") -> float:
    """One spin-orbital CCSD iteration with its DIIS (o, v spin-orbital):
    at "f64" the contractions evaluated Sz-block-sparse carry their
    surviving share (`sz_fraction`); on the digit-GEMM route ("hybrid")
    every contraction with an ERI operand counts digit_pairs(5, 6) = 15
    pair products over the dense operands."""
    hybrid = precision in HYBRID
    p = float(digit_pairs(5, 6))
    h = (lambda spec: p) if hybrid else sz_fraction
    f = h
    d = (lambda spec: p) if hybrid else (lambda spec: 1.0)
    mac = 0.0
    # F intermediates
    mac += f("mf,mafe->ae") * v * v * o * v
    mac += f("mnaf,mnfe->ae") * v * v * o * o * v
    mac += f("ne,nmie->mi") * o * o * o * v
    mac += f("mnef,inef->mi") * o * o * o * v * v
    mac += o * v * o * v
    # W intermediates
    mac += d("mnie,je->mnij") * o**4 * v
    mac += h("mnef,ijef->mnij") * o**4 * v * v
    mac += h("mbef,jf->mbej") * o * o * v**3
    mac += d("nb,nmej->mbej") * o**3 * v * v
    mac += h("mnef,jnfb->mbej") * o**3 * v**3
    # T1
    mac += o * v * v + o * o * v + 2 * (o * v) ** 2
    mac += f("mife,mafe->ia") * o * o * v**3
    mac += d("mnea,mnei->ia") * o**3 * v * v
    # T2
    mac += o**3 * v * v
    mac += h("miea,mbej->ijab") * o**3 * v**3
    mac += h("ijae,be->ijab") * o * o * v**3
    mac += o * o * v**3
    mac += o**3 * v * v
    mac += d("ijbm,ma->ijab") * o**3 * v * v
    mac += h("ie,ejab->ijab") * o * o * v**3
    mac += o**3 * v * v
    mac += h("mnij,mnab->ijab") * o**4 * v * v
    # tau.vvvv as three spin-block GEMMs
    mac += (3 * p if hybrid else 3) * o * o * (v // 2) ** 4
    mac += h("ijef,maef->ijma") * o**3 * v**3
    mac += 2 * o**3 * v * v
    mac += o * o * v * v
    # the DIIS Gram matrix
    mac += 64 * (o * v + o * o * v * v)
    return 2.0 * mac


def spinorb_ccsd_iteration_bytes(o: int, v: int) -> float:
    """Bytes one spin-orbital iteration has to move at least (o, v
    spin-orbital): the Sz-allowed spin blocks (6 of 16) of each
    antisymmetrised slice it reads (oooo, ooov, oovo, oovv, ovvo, ovvv,
    vovv, vvvv) read once, the amplitudes read and their update written,
    in f64."""
    slices = o**4 + 2 * o**3 * v + 2 * o * o * v * v + 2 * o * v**3 + v**4
    amplitudes = 2 * (o * v + o * o * v * v)
    return 8.0 * (6 / 16 * slices + amplitudes)


def _spin_share(allowed, n: int) -> float:
    """The share of the 2^n spin assignments of n free indices that
    `allowed` keeps."""
    return sum(bool(allowed(*s)) for s in product((0, 1), repeat=n)) / 2**n


def _triple_spins(o: int, strict: bool) -> list:
    """The triples (i, j, k) of o spin-orbitals, half of them alpha, by
    their spins: [(number of triples, (si, sj, sk))].  The strict ones
    i<j<k by their number of beta spins: the work of a triple, summed
    over its three P(i/jk) terms, depends on nothing else."""
    h = o // 2
    if strict:
        return [(comb(h, 3 - n) * comb(h, n), (0,) * (3 - n) + (1,) * n) for n in range(4)]
    return [(h**3, s) for s in product((0, 1), repeat=3)]


def spinorb_triples_flops(o: int, v: int, strict: bool = False) -> float:
    """Spin-orbital (T) (o, v spin-orbital) on an RHF reference, over the
    spin blocks its operands allow.  For each index x of a triple (y, z
    the other two) it makes the f-sum t2[y,z,a,e] <ex||bc> over e, the
    m-sum t2[x,m,b,c] <ma||yz> over m and the outer product t1[x,a]
    <yz||bc>, each where every operand's block is allowed (a 2-index
    one: equal spins; a 4-index one: s0 + s1 == s2 + s3), and the
    P(a/bc), denominator and energy finale over the allowed blocks of
    t3 (sa + sb + sc == sx + sy + sz).  `strict` counts the triples
    i<j<k (C(o, 3), what the kernels run), else the full cube, where the
    shares are `sz_fraction`'s.  `afesp_tpu_torch/flops.py` counts the
    dense cube, whose forbidden blocks the RHF reference leaves zero."""
    mac = elementwise = 0.0
    for n, s in _triple_spins(o, strict):
        for x in range(3):
            sx, s1, s2 = s[x], s[(x + 1) % 3], s[(x + 2) % 3]
            f = _spin_share(lambda a, b, c, e: s1 + s2 == a + e and e + sx == b + c, 4)
            m = _spin_share(lambda a, b, c, k: sx + k == b + c and k + a == s1 + s2, 4)
            outer = _spin_share(lambda a, b, c: sx == a and s1 + s2 == b + c, 3)
            mac += n * (f * v**4 + m * o * v**3 + outer * v**3)
        elementwise += n * 10 * _spin_share(lambda a, b, c: a + b + c == sum(s), 3) * v**3
    return 2.0 * mac + elementwise


def spinorb_triples_bytes(o: int, v: int) -> float:
    """The amplitudes and slices the spin-orbital (T) reads once, in f64
    (o, v spin-orbital): the allowed blocks (t1 half, a 4-index operand
    6 of 16) of t1, t2, <ei||bc>, <ma||jk> and <jk||bc>."""
    return 8.0 * (o * v / 2 + 6 / 16 * (2 * o * o * v * v + v * o * v * v + o * v * o * o))


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: ops at `peak` or bytes at the
    HBM bandwidth, whichever is longer."""
    return max(ops / peak, nbytes / HBM_BYTES_S)
