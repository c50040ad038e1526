"""Run configuration: the `els.in` Fortran-namelist config surface.

Port of `afesp_tpu/config.py:16-209` (kept as an independent copy: the
port imports nothing of the JAX package).  Input-compatible with the
reference parser (system.f90:81-167): a single `&elsinput ... /`
namelist with the eleven calc_type strings mapped onto (calc_type enum,
restricted, triples-variant flags).

`ccsd_precision` "f64" runs every contraction in f64; "hybrid", "pallas"
and "fused" run the digit-GEMM (exact int8) CCSD of either formulation,
and "pallas" and "fused" also name the restricted (T) kernel tier.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from pathlib import Path


class CalcType(enum.Enum):
    HARTREE_FOCK = "hf"
    MP2 = "mp2"
    CCSD = "ccsd"
    CCSD_T = "ccsd_t"


# calc_type string -> (CalcType, restricted, paren, renorm, comp_renorm)
# Mirrors the select-case table at system.f90:116-165.
_CALC_TABLE = {
    "RHF": (CalcType.HARTREE_FOCK, True, False, False, False),
    "UHF": (CalcType.HARTREE_FOCK, False, False, False, False),
    "MP2_spinorb": (CalcType.MP2, False, False, False, False),
    "MP2_spatial": (CalcType.MP2, True, False, False, False),
    "CCSD_spinorb": (CalcType.CCSD, False, False, False, False),
    "CCSD_spatial": (CalcType.CCSD, True, False, False, False),
    "CCSD(T)_spinorb": (CalcType.CCSD_T, False, False, False, False),
    "CCSD(T)_spatial": (CalcType.CCSD_T, True, True, False, False),
    "CCSD[T]_spatial": (CalcType.CCSD_T, True, False, False, False),
    "RCCSD(T)_spatial": (CalcType.CCSD_T, True, True, True, False),
    "RCCSD[T]_spatial": (CalcType.CCSD_T, True, False, True, False),
    "CRCCSD(T)_spatial": (CalcType.CCSD_T, True, True, False, True),
    "CRCCSD[T]_spatial": (CalcType.CCSD_T, True, False, False, True),
}


@dataclasses.dataclass
class Config:
    """All run options, with the reference defaults (system.f90:43-50)."""

    calc_type: CalcType = CalcType.HARTREE_FOCK
    calc_type_str: str = "RHF"
    restricted: bool = True
    # triples variants (system.f90:58-60)
    ccsd_t_paren: bool = False
    ccsd_t_renorm: bool = False
    ccsd_t_comp_renorm: bool = False

    scf_e_tol: float = 1e-6
    scf_d_tol: float = 1e-6
    scf_diis_n_errmat: int = 6
    ccsd_e_tol: float = 1e-6
    ccsd_t_tol: float = 1e-6
    ccsd_diis_n_errmat: int = 8
    scf_maxiter: int = 50
    ccsd_maxiter: int = 50

    write_fcidump: bool = False
    scf_read_guess: bool = False
    scf_write_guess: bool = False
    # New (not in the reference): CC amplitude checkpoint/restart
    ccsd_read_amplitudes: bool = False
    ccsd_write_amplitudes: bool = False
    # New: spin-orbital CCSD F_oo form.  "code" reproduces the current
    # reference binary (its F_mi tau~ contraction is transposed relative
    # to Stanton Eq. 5 — a bug introduced after 2022-02); "paper" runs
    # the literature equations, which match Psi4 and the reference's own
    # older outputs (e.g. h2o-cc-pvdz/1.80_104.45/ref_out) to <1e-8 Ha.
    ccsd_spinorb_equations: str = "code"
    # New: CCSD arithmetic.  "hybrid"/"pallas"/"fused" run the JAX
    # package's digit-GEMM CCSD iteration (ops/exact_gemm); "pallas" and
    # "fused" also pick those triples tiers.  "f64" runs every contraction
    # in f64.
    ccsd_precision: str = "f64"
    # Runtime permutational-symmetry self-check of the antisymmetrised
    # spin-orbital slices (always on in the reference, ccsd.f90:150-173)
    spinorb_selfcheck: bool = True
    # New: bit-parity switch for the reference's plain-CCSD(T)_spatial
    # quirk (ccsd.f90:2211-2215): upstream only forms z3_bar when a
    # renormalised variant is requested, so its plain CCSD(T)_spatial
    # silently prints the CCSD[T] value.  Default False = compute the
    # correct (T); True = reproduce the reference's output exactly.
    ccsd_t_spatial_bug_compat: bool = False
    # New (no reference counterpart — upstream MPI is an unticked TODO,
    # README.md:35): device-mesh width for the multi-chip CC/triples
    # paths of the JAX package.  0 (default) and 1 = single device, -1 =
    # every visible device; a width of 2 or more runs the CC and (T)
    # stages on a mesh of that many devices (`parallel/`).
    mesh_devices: int = 0

    # Raw text of the input file (echoed into the output, integrals.f90:240-249)
    raw_text: str = ""

    @property
    def wants_mp2(self) -> bool:
        return self.calc_type in (CalcType.MP2, CalcType.CCSD, CalcType.CCSD_T)

    @property
    def wants_ccsd(self) -> bool:
        return self.calc_type in (CalcType.CCSD, CalcType.CCSD_T)

    @property
    def wants_triples(self) -> bool:
        return self.calc_type is CalcType.CCSD_T


def _parse_fortran_value(text: str):
    """Parse a Fortran namelist literal: logicals, ints, reals, strings."""
    t = text.strip().rstrip(",").strip()
    low = t.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    if (t.startswith('"') and t.endswith('"')) or (
        t.startswith("'") and t.endswith("'")
    ):
        return t[1:-1]
    # Fortran reals allow d/D exponents
    num = t.replace("d", "e").replace("D", "E")
    try:
        return int(num)
    except ValueError:
        pass
    try:
        return float(num)
    except ValueError:
        return t


def parse_els_in(text: str) -> Config:
    """Parse the contents of an `els.in` namelist file into a Config.

    Mirrors system.f90:96-114 + the calc_type dispatch at 116-165.  Keys
    missing from the file keep the dataclass defaults (the reference
    technically reads uninitialised locals in that case; the committed
    sample inputs rely on defaults being false/off, which we honour).
    """
    cfg = Config(raw_text=text)

    m = re.search(r"&elsinput(.*?)(?:^|\n)\s*/", text, re.S | re.I)
    body = m.group(1) if m else text

    for key, val in re.findall(r"([A-Za-z_][A-Za-z0-9_]*)\s*=\s*([^,\n]+)", body):
        key = key.lower()
        v = _parse_fortran_value(val)
        if key == "calc_type":
            if v not in _CALC_TABLE:
                raise ValueError(f"Unrecognised calculation type: {v!r}")
            ct, restr, paren, ren, cren = _CALC_TABLE[v]
            cfg.calc_type = ct
            cfg.calc_type_str = v
            cfg.restricted = restr
            cfg.ccsd_t_paren = paren
            cfg.ccsd_t_renorm = ren
            cfg.ccsd_t_comp_renorm = cren
        elif key in (
            "scf_e_tol",
            "scf_d_tol",
            "ccsd_e_tol",
            "ccsd_t_tol",
        ):
            setattr(cfg, key, float(v))
        elif key in (
            "scf_diis_n_errmat",
            "ccsd_diis_n_errmat",
            "scf_maxiter",
            "ccsd_maxiter",
            "mesh_devices",
        ):
            setattr(cfg, key, int(v))
        elif key in (
            "write_fcidump",
            "scf_read_guess",
            "scf_write_guess",
            "ccsd_read_amplitudes",
            "ccsd_write_amplitudes",
            "spinorb_selfcheck",
            "ccsd_t_spatial_bug_compat",
        ):
            setattr(cfg, key, bool(v))
        elif key == "ccsd_spinorb_equations":
            if v not in ("code", "paper"):
                raise ValueError(f"ccsd_spinorb_equations must be 'code' or 'paper', got {v!r}")
            cfg.ccsd_spinorb_equations = v
        elif key == "ccsd_precision":
            if v not in ("f64", "hybrid", "pallas", "fused"):
                raise ValueError(
                    "ccsd_precision must be 'f64', 'hybrid', 'pallas' "
                    f"or 'fused', got {v!r}"
                )
            cfg.ccsd_precision = v
        # unknown keys are ignored (the Fortran namelist would reject them,
        # but being lenient here costs nothing)
    return cfg


def read_els_in(directory: str | Path = ".") -> Config:
    path = Path(directory) / "els.in"
    if not path.exists():
        raise FileNotFoundError("input file els.in does not exist")
    return parse_els_in(path.read_text())
