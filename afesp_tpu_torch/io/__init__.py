"""Input files and the stdout report (port of `afesp_tpu/io/`)."""

from .dat import (
    IntStore,
    System,
    read_dat_matrix,
    read_eri_dense,
    read_geometry,
    read_integrals,
    read_scf_guess,
    write_scf_guess,
)
from .fcidump import write_fcidump

__all__ = [
    "IntStore",
    "System",
    "read_dat_matrix",
    "read_eri_dense",
    "read_geometry",
    "read_integrals",
    "read_scf_guess",
    "write_scf_guess",
    "write_fcidump",
]
