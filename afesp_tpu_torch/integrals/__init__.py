"""The Gaussian-integral engine on a device (port of `afesp_tpu/integrals/`)."""

from .engine import BasisSet, build_basis, eri_tensor, kinetic, nuclear, overlap

__all__ = [
    "BasisSet",
    "build_basis",
    "overlap",
    "kinetic",
    "nuclear",
    "eri_tensor",
]
