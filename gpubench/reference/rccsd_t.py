"""The plain reference of the restricted calculation types: RHF, MP2,
CCSD and the [T]/(T)/R-/CR- triples family, from a run directory's
input files (`files.py`), in one dtype on one device.

`run(workdir, els, device, dtype)` returns the breakdown the program
prints, as full-precision floats: "e_hf" (the RHF total energy),
"e_mp2" and "e_ccsd" (correlation energies) and, for a (T) calc_type,
the six triples correlation energies; with the SCF and CC iteration
counts.  TF32 is switched off while it runs.  It imports nothing of the
program and reads nothing the program wrote.

`lower` puts single stages in another dtype, each stage's results
entering the next in `dtype`: the controls of the correctness limits
(one layer computed in a lower precision, the rest as stated).  Its
keys are STAGES: "fock" the SCF's J/K build, "corr" MP2 and CCSD,
"triples" the (T) family with its CR chain, "cr" the CR chain alone.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

from . import cc, files, scf, triples

CALC_TYPES = ("MP2_spatial", "CCSD_spatial", "CCSD(T)_spatial", "CCSD[T]_spatial",
              "RCCSD(T)_spatial", "RCCSD[T]_spatial", "CRCCSD(T)_spatial",
              "CRCCSD[T]_spatial")
STAGES = ("fock", "corr", "triples", "cr")
TRIPLES = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t", "e_crccsd_tt")


@contextlib.contextmanager
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def run(workdir: str | Path, els: dict, device, dtype=torch.float64,
        lower: dict | None = None) -> dict:
    calc = els["calc_type"]
    if calc not in CALC_TYPES:
        raise ValueError(f"the restricted reference does not run calc_type {calc!r}")
    lower = lower or {}
    if set(lower) - set(STAGES):
        raise ValueError(f"no reference stage {sorted(set(lower) - set(STAGES))}; have {STAGES}")
    corr_dt, triples_dt = lower.get("corr", dtype), lower.get("triples", dtype)
    d = Path(workdir)
    dev = torch.device(device)
    with no_tf32():
        S_np = files.read_matrix(d / "s.dat")
        n = S_np.shape[0]
        as_t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        S = as_t(S_np)
        H = as_t(files.read_matrix(d / "t.dat") + files.read_matrix(d / "v.dat"))
        charges, coords = files.read_geometry(d / "geom.dat")
        e_nuc = files.nuclear_repulsion(charges, coords)
        nocc = int(round(charges.sum())) // 2
        eri = files.dense_eri(files.packed_eri(d, n), n, dev, dtype)

        hf = scf.rhf(S, H, eri, nocc, e_tol=els["scf_e_tol"], d_tol=els["scf_d_tol"],
                     n_errmat=els["scf_diis_n_errmat"], maxiter=els["scf_maxiter"],
                     fock_dtype=lower.get("fock"))
        out = {"e_hf": hf.energy + e_nuc, "scf_iterations": hf.iterations}
        mo = cc.ao_to_mo(eri, hf.coeff)
        del eri
        v = cc.slices(mo, nocc)
        del mo
        e_o, e_v = hf.levels[:nocc], hf.levels[nocc:]
        vc = cc.cast_slices(v, corr_dt)
        out["e_mp2"] = cc.mp2_energy(vc, e_o.to(corr_dt), e_v.to(corr_dt))
        if calc == "MP2_spatial":
            return out
        res = cc.ccsd(vc, e_o.to(corr_dt), e_v.to(corr_dt), e_tol=els["ccsd_e_tol"],
                      t_tol=els["ccsd_t_tol"], n_errmat=els["ccsd_diis_n_errmat"],
                      maxiter=els["ccsd_maxiter"])
        del vc
        out.update(e_ccsd=res.energy, cc_iterations=res.iterations)
        if calc == "CCSD_spatial":
            return out
        vt = cc.cast_slices(v, triples_dt)
        del v
        out.update(triples.triples(cc.cast_ccsd(res, triples_dt), vt, e_o.to(triples_dt),
                                   e_v.to(triples_dt), res.energy, cr_dtype=lower.get("cr")))
        return out
