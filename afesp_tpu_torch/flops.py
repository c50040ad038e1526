"""Analytic operation counts of the CC iterations and the triples.

Port of `afesp_tpu/flops.py` (every function; the JAX module's TPU peaks
are not carried over).  Counts are 2x the multiply-accumulate counts of
every contraction, in algorithmic f64 FLOPs: what the math requires.
With `precision` "hybrid" (and "pallas"/"fused", which run the same CCSD)
a contraction that takes the digit-GEMM route (`ops/exact_gemm`) counts
once per digit-pair product (`digit_pairs`), which is the work the card
issues on that route.  Plain integers and floats: no torch.
"""

from __future__ import annotations


def sz_fraction(spec: str) -> float:
    """Fraction of a dense contraction's MACs that survive Sz-block
    sparsity (ops/spin_einsum.py): enumerate the 2^letters spin
    assignments, keep those where every operand block is allowed
    (2-index: equal spins; 4-index: s0+s1 == s2+s3); each surviving
    assignment costs (1/2)^letters of the dense MACs."""
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
    """One spin-orbital CCSD iteration with its DIIS, in FLOPs as
    executed: f64 contractions evaluated Sz-block-sparse carry their
    surviving-block fraction (sz_fraction); on the digit route every
    contraction with an ERI operand counts digit_pairs(5, 6) = 15 pair
    products over the dense operands (exact_gemm at L=5/maxdeg=6)."""
    hybrid = precision in ("hybrid", "pallas", "fused")
    p = float(digit_pairs(5, 6))
    # `h`: digit-GEMM contractions in hybrid, Sz-blocked fraction in f64
    h = (lambda spec: p) if hybrid else sz_fraction
    f = h  # the F intermediates take the digit route too
    # terms evaluated dense in f64 mode but digit in hybrid
    d = (lambda spec: p) if hybrid else (lambda spec: 1.0)
    mac = 0.0
    # F intermediates
    mac += f("mf,mafe->ae") * v * v * o * v
    mac += f("mnaf,mnfe->ae") * v * v * o * o * v
    mac += f("ne,nmie->mi") * o * o * o * v
    mac += f("mnef,inef->mi") * o * o * o * v * v
    mac += o * v * o * v            # nf,mnef->me (dense)
    # W intermediates
    mac += d("mnie,je->mnij") * o**4 * v
    mac += h("mnef,ijef->mnij") * o**4 * v * v
    mac += h("mbef,jf->mbej") * o * o * v**3
    mac += d("nb,nmej->mbej") * o**3 * v * v
    mac += h("mnef,jnfb->mbej") * o**3 * v**3  # w4
    # T1
    mac += o * v * v + o * o * v + 2 * (o * v) ** 2
    mac += f("mife,mafe->ia") * o * o * v**3
    mac += d("mnea,mnei->ia") * o**3 * v * v
    # T2
    mac += o**3 * v * v             # ie,ma,mbej chain (dense)
    mac += h("miea,mbej->ijab") * o**3 * v**3
    mac += h("ijae,be->ijab") * o * o * v**3
    mac += o * o * v**3             # ijae,mb,me (dense)
    mac += o**3 * v * v             # ie,me,mjab
    mac += d("ijbm,ma->ijab") * o**3 * v * v
    mac += h("ie,ejab->ijab") * o * o * v**3
    mac += o**3 * v * v             # mi,mjab
    mac += h("mnij,mnab->ijab") * o**4 * v * v
    # blocked tau*vvvv: 3 spin-block GEMMs; x15 digit pairs in hybrid
    mac += (3 * p if hybrid else 3) * o * o * (v // 2) ** 4
    mac += h("ijef,maef->ijma") * o**3 * v**3  # G
    mac += 2 * o**3 * v * v         # G*t1 (two terms)
    mac += o * o * v * v            # energy reduction
    # DIIS gram matrix: nerr^2 * size ~ 64 * (ov + o^2 v^2)
    mac += 64 * (o * v + o * o * v * v)
    return 2.0 * mac


def spinorb_triples_flops(o: int, v: int, strict: bool = False) -> float:
    """Spin-orbital (T): six contraction GEMMs + three t1 outer products
    per (i,j,k) panel + the P(a/bc)/denominator/energy elementwise
    finale.  strict=False counts the full cube (o^3 panels, the
    reference's loop nest, ccsd.f90:1868-1914); strict=True the
    strict-triangle panels (C(o,3)) the kernels execute."""
    ntrip = o * (o - 1) * (o - 2) // 6 if strict else o**3
    gemm_mac = ntrip * (3 * v**4 + 3 * o * v**3)  # f-sums (K=v) + m-sums (K=o)
    outer = 3 * ntrip * v**3        # disconnected t3d
    elementwise = 10 * ntrip * v**3  # P(a/bc) x2, D, product, reduction
    return 2.0 * gemm_mac + 2.0 * outer + elementwise


def ao_to_mo_flops(n: int) -> float:
    return 2.0 * 4 * n**5


def digit_pairs(L: int, maxdeg: int = 7) -> int:
    """Digit-pair products per exact_gemm contraction: pairs (i, j) with
    i, j < L and (i+1)+(j+1) <= maxdeg (ops/exact_gemm.py).
    L=6/maxdeg=7 -> 21, L=5/maxdeg=6 -> 15."""
    return sum(1 for i in range(L) for j in range(L) if i + j + 2 <= maxdeg)


def spatial_ccsd_iteration_flops(o: int, v: int, precision: str = "hybrid") -> float:
    """One spatial (Piecuch) CCSD iteration as executed on the digit-GEMM
    route, dominant contractions only (a lower bound: small o^2v^2-scale
    terms and elementwise tails are dropped).  Each contraction is
    weighted by its digit-pair count: the L=5/L=4 v_vvov matricisations
    of ccsd_spatial._DIG_L have fewer pairs than the L=6/maxdeg=7
    heavyweights (21).  precision "f64" (not in the JAX package) counts
    the same contractions once each, the f64 iteration's work."""
    if precision in ("hybrid", "pallas", "fused"):
        p6, p5, p4 = digit_pairs(6), digit_pairs(5), digit_pairs(4)
    else:
        p6 = p5 = p4 = 1
    mac = p6 * 1.0 * o * o * v**4    # c_oovv x v_vvvv (ccsd.f90:1669)
    mac += p6 * 6.0 * o**3 * v**3    # I_ovov/I_voov/x_voov family
    # the L=5 "efia,jkef" + L=4 "efma,mief" v_vvov matricisations
    mac += (p5 + p4) * 1.0 * o**2 * v**3
    mac += p6 * 2.0 * o**4 * v * v   # I_oooo + its T2 consumer
    return 2.0 * mac


def spatial_triples_flops(o: int, v: int, doing_CR: bool = True, strict: bool = False) -> float:
    """Spatial triples family: twelve t3_D GEMMs per (i,j,k) panel (six
    K=v f-sums + six K=o m-sums, ccsd.f90:2168-2173), doubled when the
    CR moment M3 is built (2186-2194), plus the z3/y/xbar/denominator
    elementwise finale.  strict=True counts the sorted-triples grid
    (i<=j<=k, ~o^3/6 panels) the kernels execute; False the full cube."""
    ntrip = o * (o + 1) * (o + 2) // 6 if strict else o**3
    gemm_mac = ntrip * (6.0 * v**4 + 6.0 * o * v**3)
    if doing_CR:
        gemm_mac *= 2.0
    elementwise = 20.0 * ntrip * v**3
    return 2.0 * gemm_mac + elementwise
