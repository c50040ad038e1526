"""The breakdown a calculation prints, as numbers, and the comparison
that decides `correct`.

`program_values` reads the program's result object (full precision,
not the report's ten decimals); the reference module returns the same
keys.  Four numbers are compared, each against its own limit from
`limits/<cell>.json`: the largest absolute gap, in hartree, over the
keys of its group that the reference gives.  The CR values are a group
of their own, since they alone read the CR chain, which runs in f32
where the mix asks for "hybrid" and the other triples values do not.
A spin-orbital CCSD(T) has one triples value, its CCSD(T) correlation
energy (`RunResult.e_ccsd_t`), which goes under "e_ccsd_tt", the key of
that energy in the restricted family, and so into the "e_triples" group.
"""

from __future__ import annotations

import math

TRIPLES = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t", "e_crccsd_tt")
GROUPS = {
    "e_hf": ("e_hf",),
    "e_corr": ("e_mp2", "e_ccsd"),
    "e_triples": TRIPLES[:4],
    "e_cr": TRIPLES[4:],
}


def spinorb_triples_ran(res) -> bool:
    """Whether `res` is of a spin-orbital CCSD(T): no restricted triples,
    an unrestricted configuration and a CCSD(T) calc type."""
    cfg = getattr(res, "cfg", None)
    return (getattr(res, "triples", None) is None and cfg is not None
            and not cfg.restricted and cfg.wants_triples)


def program_values(res) -> dict:
    """The breakdown values of the program's `RunResult`: the RHF total
    energy, the MP2 and CCSD correlation energies and, where the restricted
    triples ran, their six correlation energies, where the spin-orbital
    ones ran, its CCSD(T) correlation energy as "e_ccsd_tt"; with the
    iteration counts."""
    out = {"e_hf": res.e_hf + res.e_nuc, "e_mp2": res.e_mp2, "e_ccsd": res.e_ccsd}
    hf, cc, tr = getattr(res, "hf", None), getattr(res, "cc", None), getattr(res, "triples", None)
    if hf is not None:
        out["scf_iterations"] = hf.iterations
    if cc is not None:
        out["cc_iterations"] = cc.iterations
    if tr is not None:
        out.update({k: getattr(tr, k) for k in TRIPLES})
    elif spinorb_triples_ran(res):
        out["e_ccsd_tt"] = res.e_ccsd_t
    return out


def gaps(got: dict, ref: dict) -> dict:
    """Each group's largest |got - ref|; a value the program left out, or
    one that is not finite, reads infinite."""
    out = {}
    for group, keys in GROUPS.items():
        keys = [k for k in keys if k in ref]
        if not keys:
            continue
        worst = 0.0
        for k in keys:
            g = abs(got[k] - ref[k]) if k in got else math.inf
            worst = max(worst, g if math.isfinite(g) else math.inf)
        out[group] = worst
    return out


def judge(pairs: list[tuple[dict, dict]], limits: dict) -> tuple[int, dict]:
    """(failed calculations, {number: worst gap over them}) of each
    calculation's values against its reference's, given as pairs."""
    worst = {g: 0.0 for g in limits}
    failed = 0
    for got, ref in pairs:
        g = gaps(got, ref)
        bad = False
        for name, limit in limits.items():
            x = g.get(name, math.inf)
            worst[name] = max(worst[name], x)
            bad |= not x <= limit
        failed += bad
    return failed, worst
