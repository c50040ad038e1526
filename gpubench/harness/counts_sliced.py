"""The yardstick of the sliced f64 tier: the operations and bytes of its
Fock build and of its AO->MO transform, frozen here so that a change to
the program's tier, or a kernel that does the work another way, is
still measured against the same work (`counts.py` keeps the others).

- A Fock build reads every unique two-electron integral once: the 8-fold
  packed store, npair (npair + 1) / 2 f64 values, npair = n (n + 1) / 2.
- The sliced transform turns the unique integrals into the restricted
  CCSD slices with f64 GEMMs, as 2x the multiply-accumulates of its half
  transforms: over each AO pair (ij), (C M)[r, l] for all r (n^3), then
  (ij|rs) for s occupied (n^2 o) and for r, s virtual (n v^2); over each
  occupied-s column (rs), its two n^3 GEMMs; over each virtual pair
  c >= d, C_v U (v n^2) and (C_v U) C_v^T (v^2 n).  Its operands are
  the packed store, read once, and the slices it writes (v_vvvv,
  v_vvov, v_oovv, v_ovov, v_oovo, v_oooo), in f64.
"""

from __future__ import annotations


def _npair(n: int) -> int:
    return n * (n + 1) // 2


def fock_build_bytes(n: int) -> float:
    """The bytes one Fock build must read: the packed store, in f64."""
    npair = _npair(n)
    return 8.0 * npair * (npair + 1) // 2


def sliced_transform_flops(n: int, o: int) -> float:
    """f64 operations of the sliced transform at nbasis n, o occupied."""
    v = n - o
    first = _npair(n) * (n**3 + n * n * o + n * v * v)
    occupied = n * o * 2 * n**3
    virtual = _npair(v) * (v * n * n + v * v * n)
    return 2.0 * (first + occupied + virtual)


def sliced_transform_bytes(n: int, o: int) -> float:
    """The transform's operands at least once, in f64: the packed store
    read, the slices written."""
    v = n - o
    slices = v**4 + v**3 * o + 2 * o * o * v * v + o**3 * v + o**4
    return fock_build_bytes(n) + 8.0 * slices
