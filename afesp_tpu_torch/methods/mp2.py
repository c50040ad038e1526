"""AO->MO ERI transformation + MP2 energy (mp2.f90:261-449).

Port of `afesp_tpu/methods/mp2.py:144-333` (`ao_to_mo`, `mp2_energy`,
`do_mp2_spatial`).  The four O(N^5) quarter transforms (mp2.f90:320-386)
are four dense f64 matmuls on the device; XLA ran them outside any
kernel in the JAX package, and so does the port.  The dense MO chemist
tensor (pq|rs) stays on the device and feeds CCSD directly.

MP2 energy (mp2.f90:418-440):
    E2 = sum_{ijab} (ia|jb) [2(ia|jb) - (ib|ja)] / (e_i+e_j-e_a-e_b)

The JAX package streams at nbasis >= `STREAM_NBASIS` only on a TPU, or
at any size under `AFESP_FORCE_STREAM=1` (`afesp_tpu/methods/mp2.py:266`);
everywhere else it runs this dense path at any size.  The port never
runs on a TPU, so it is dense at every nbasis unless AFESP_FORCE_STREAM=1
selects the streaming tier: the packed store goes through the sliced
transform (`methods/mo_slices.py`) to the CCSD slices, with v_vvvv held
only as per-chunk int8 limbs (`vvvv_B`), and the MP2 energy comes from
the <ij|ab> slice (`mp2_energy_from_oovv`).  No dense MO tensor exists
there, so no FCIDUMP is written.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path

import torch

from ..config import Config
from ..device import F64, default_device
from ..io import dat
from ..io.fcidump import write_fcidump
from ..io.report import Reporter
from .hf import HFResult

# Above this basis size the JAX package switches to its streaming tier on
# a TPU (`afesp_tpu/methods/mp2.py:48`).  The port, never on a TPU,
# streams only under AFESP_FORCE_STREAM=1; the value names the tier in
# the driver's refusal of the spin-orbital CCSD there.
STREAM_NBASIS = 140


def _force_stream() -> bool:
    """AFESP_FORCE_STREAM=1: the JAX package's hook that routes any size
    through the streaming tier (`afesp_tpu/methods/mp2.py:335`)."""
    return os.environ.get("AFESP_FORCE_STREAM", "") == "1"


@dataclasses.dataclass
class MP2Result:
    e_mp2: float
    # dense chemist (pq|rs) in the canonical MO basis; None on the
    # streaming tier, where `slices` and `vvvv_B` carry the MO integrals
    eri_mo: torch.Tensor | None
    slices: object = None  # ccsd_spatial.Slices (v_vvvv None)
    vvvv_B: object = None  # prechunk_B_chunkscaled limbs of v_vvvv


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
) -> MP2Result:
    dev = default_device(device)
    rep = rep or Reporter()
    t_start = time.perf_counter()
    rep.section("MP2")
    rep.write(" Performing AO to MO ERI transformation...")

    nocc = sys_.nel // 2
    C = torch.as_tensor(hf.coeff, dtype=F64, device=dev)
    if _force_stream():
        # streaming tier: packed store -> physicist slices, each vvvv
        # chunk digitized to L=5 limbs with its own scales as it is
        # computed (JAX `:266-293`); the packed store is freed once the
        # transform's row table supersedes it
        from .mo_slices import ao_to_mo_slices

        slices, vvvv_B = ao_to_mo_slices(
            ints.packed_on_device(dev), C, n=sys_.nbasis, nocc=nocc, digit_L=5,
            free_packed=ints.free_device_packed,
        )
        rep.write(" Calculating MP2 energy...")
        lv = torch.as_tensor(hf.levels, dtype=F64, device=dev)
        e_mp2 = float(mp2_energy_from_oovv(slices.v_oovv, lv[:nocc], lv[nocc:]))
        rep.write(f" MP2 correlation energy (Hartree): {e_mp2:15.8f}")
        if cfg.write_fcidump:
            rep.write(" FCIDUMP skipped: no dense MO tensor on the streaming tier.")
        rep.stage_time("Time taken for restricted MP2:", time.perf_counter() - t_start)
        return MP2Result(e_mp2=e_mp2, eri_mo=None, slices=slices, vvvv_B=vvvv_B)

    eri_mo = ao_to_mo(ints.eri_on_device(dev), C)
    # nothing downstream reads the AO ERI: free the device copy (1.45 GB
    # at 116 bf) before the CC stages, as `afesp_tpu/methods/mp2.py:315`
    if sys_.nbasis >= 100:
        ints.free_device_eri()

    rep.write(" Calculating MP2 energy...")
    levels = torch.as_tensor(hf.levels, dtype=F64, device=dev)
    e_mp2 = float(mp2_energy(eri_mo, levels, nocc))
    rep.write(f" MP2 correlation energy (Hartree): {e_mp2:15.8f}")

    if cfg.write_fcidump:
        rep.write(" Writing FCIDUMP file...")
        write_fcidump(Path(workdir) / "FCIDUMP", eri_mo.cpu().numpy())
        rep.write(" Done writing FCIDUMP file!")

    rep.stage_time("Time taken for restricted MP2:", time.perf_counter() - t_start)
    return MP2Result(e_mp2=e_mp2, eri_mo=eri_mo)
