"""FCIDUMP export of MO ERIs (mp2.f90:451-487).

Port of `afesp_tpu/io/fcidump.py`, kept as an independent copy.

Writes every canonically-ordered (pq|rs) with |value| > 1e-7 in the
reference's format '(I3,I3,I3,I3,ES17.9)'.  The canonical ordering is the
triangular-of-triangular loop p>=q, r<=p, s<=(q if p==r else r)
(mp2.f90:468-476).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_fcidump(path: str | Path, eri_mo: np.ndarray, threshold: float = 1e-7):
    """eri_mo: dense chemist-notation MO ERI tensor (pq|rs)."""
    n = eri_mo.shape[0]
    with open(path, "w") as f:
        for p in range(1, n + 1):
            for q in range(1, p + 1):
                for r in range(1, p + 1):
                    s_up = q if p == r else r
                    for s in range(1, s_up + 1):
                        v = eri_mo[p - 1, q - 1, r - 1, s - 1]
                        if abs(v) > threshold:
                            f.write(f"{p:3d}{q:3d}{r:3d}{s:3d}{v:17.9E}\n")
