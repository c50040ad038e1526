"""AO->MO ERI transformation + MP2 energy (mp2.f90:261-449).

Port of `afesp_tpu/methods/mp2.py:144-333` (`ao_to_mo`, `mp2_energy`,
`do_mp2_spatial`).  The four O(N^5) quarter transforms (mp2.f90:320-386)
are four dense f64 matmuls on the device; XLA ran them outside any
kernel in the JAX package, and so does the port.  The dense MO chemist
tensor (pq|rs) stays on the device and feeds CCSD directly.

MP2 energy (mp2.f90:418-440):
    E2 = sum_{ijab} (ia|jb) [2(ia|jb) - (ib|ja)] / (e_i+e_j-e_a-e_b)

Which MO integral forms the stage makes, and which AO forms it frees, are
the memory tier's (`methods/tiers.py`).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

from .. import trace
from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.fcidump import write_fcidump
from ..io.report import Reporter
from .hf import HFResult


@dataclasses.dataclass
class MP2Result:
    e_mp2: float
    # dense chemist (pq|rs) in the canonical MO basis; None on the
    # sliced tiers, where `slices` (and on the streaming tier `vvvv_B`)
    # carry the MO integrals
    eri_mo: torch.Tensor | None
    slices: object = None  # ccsd_spatial.Slices (v_vvvv None on the streaming tier)
    vvvv_B: object = None  # prechunk_B_chunkscaled limbs of v_vvvv (streaming tier)


def ao_to_mo(eri: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(ij|kl) -> (pq|rs) with C[p, mu] (rows = MO, sys%canon_coeff
    layout), as four quarter transforms (mp2.f90:320-386)."""
    n = eri.shape[0]
    # stage 1: A[p, jkl] = sum_i C[p,i] eri[i, jkl]
    t = (C @ eri.reshape(n, n**3)).reshape(n, n, n, n)
    # stage 2: B[p, q, kl] = sum_j C[q,j] A[p, j, kl]
    t = torch.matmul(C, t.reshape(n, n, n * n))
    # stage 3: A[pq, r, l] = sum_k C[r,k] B[pq, k, l]
    t = torch.matmul(C, t.reshape(n * n, n, n))
    # stage 4: B[pqr, s] = sum_l A[pqr, l] C[s,l]
    return (t.reshape(n**3, n) @ C.T).reshape(n, n, n, n)


def mp2_energy(eri_mo: torch.Tensor, levels: torch.Tensor, nocc: int) -> torch.Tensor:
    ov = eri_mo[:nocc, nocc:, :nocc, nocc:]  # (ia|jb)
    e_o = levels[:nocc]
    e_v = levels[nocc:]
    denom = (
        e_o[:, None, None, None]
        + e_o[None, None, :, None]
        - e_v[None, :, None, None]
        - e_v[None, None, None, :]
    )
    exch = ov.permute(0, 3, 2, 1)  # (ib|ja)
    return torch.sum(ov * (2.0 * ov - exch) / denom)


def mp2_energy_from_oovv(v_oovv: torch.Tensor, levels_o: torch.Tensor,
                         levels_v: torch.Tensor) -> torch.Tensor:
    """MP2 energy from the physicist <ij|ab> slice: (ia|jb) = v_oovv[ijab]
    (mp2.f90:418-440 on the slice the streaming transform has)."""
    denom = (
        levels_o[:, None, None, None]
        + levels_o[None, :, None, None]
        - levels_v[None, None, :, None]
        - levels_v[None, None, None, :]
    )
    exch = v_oovv.permute(0, 1, 3, 2)  # (ib|ja) = <ij|ba>
    return torch.sum(v_oovv * (2.0 * v_oovv - exch) / denom)


def do_mp2_spatial(
    sys_: dat.System,
    ints: dat.IntStore,
    cfg: Config,
    hf: HFResult,
    rep: Reporter | None = None,
    workdir: str | Path = ".",
    device: str | torch.device | None = None,
    tier=None,
) -> MP2Result:
    """The MP2 stage, its MO integrals the memory tier's
    (`methods/tiers.py`; None: the calculation's)."""
    dev = default_device(device)
    rep = rep or Reporter()
    t_start = time.perf_counter()
    rep.section("MP2")
    rep.write(" Performing AO to MO ERI transformation...")

    nocc = sys_.nel // 2
    C = torch.as_tensor(hf.coeff, dtype=F64, device=dev)
    from .tiers import calc_tier

    tier = tier or calc_tier(sys_.nbasis, cfg, dev)
    eri_mo, slices, vvvv_B, energy = tier.mo_integrals(ints, C, nocc)

    rep.write(" Calculating MP2 energy...")
    e_mp2 = float(energy(torch.as_tensor(hf.levels, dtype=F64, device=dev)))
    trace.synced()
    rep.write(f" MP2 correlation energy (Hartree): {e_mp2:15.8f}")

    if cfg.write_fcidump and eri_mo is None:
        rep.write(f" FCIDUMP skipped: no dense MO tensor on the {tier.label} tier.")
    elif cfg.write_fcidump:
        rep.write(" Writing FCIDUMP file...")
        write_fcidump(Path(workdir) / "FCIDUMP", eri_mo.cpu().numpy())
        trace.synced()
        rep.write(" Done writing FCIDUMP file!")

    rep.stage_time("Time taken for restricted MP2:", time.perf_counter() - t_start)
    return MP2Result(e_mp2=e_mp2, eri_mo=eri_mo, slices=slices, vvvv_B=vvvv_B)
