"""AO->MO ERI transformation + MP2 energy (mp2.f90:261-449).

Port of `afesp_tpu/methods/mp2.py:144-333` (`ao_to_mo`, `mp2_energy`,
`do_mp2_spatial`).  The four O(N^5) quarter transforms (mp2.f90:320-386)
are four dense f64 matmuls on the device; XLA ran them outside any
kernel in the JAX package, and so does the port.  The dense MO chemist
tensor (pq|rs) stays on the device and feeds CCSD directly.

MP2 energy (mp2.f90:418-440):
    E2 = sum_{ijab} (ia|jb) [2(ia|jb) - (ib|ja)] / (e_i+e_j-e_a-e_b)

The tier is `calc_tier`'s, shared by `methods/hf.py` and `driver.py`.  The
JAX package streams at nbasis >= `STREAM_NBASIS` only on a TPU, or at
any size under `AFESP_FORCE_STREAM=1` (`afesp_tpu/methods/mp2.py:266`);
everywhere else it runs this dense path at any size.  The port departs
from it here: on a card it reckons the dense path's need at the
precision asked (`dense_need_bytes`) against the card's memory less
`TIER_HEADROOM_BYTES`, and above that takes a sliced tier:

  "stream" (ccsd_precision "hybrid"/"pallas"/"fused", or any precision
           under AFESP_FORCE_STREAM=1): the packed store goes through
           the sliced transform (`methods/mo_slices.py`) to the CCSD
           slices, with v_vvvv held only as per-chunk int8 limbs
           (`vvvv_B`);
  "sliced" (ccsd_precision "f64"): RHF builds its Fock matrices from
           the f64 pair-row table (`IntStore.rows_on_device`), and the
           sliced f64 transform (`mo_slices.ao_to_mo_slices_f64`) turns
           that table into the f64 slices, v_vvvv among them.

On both the MP2 energy comes from the <ij|ab> slice
(`mp2_energy_from_oovv`).  No dense MO tensor exists there, so no
FCIDUMP is written.  On the CPU the rule keeps the dense path unless a
caller passes a budget.
"""

from __future__ import annotations

import dataclasses
import os
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
from .mo_slices import ao_to_mo_slices, ao_to_mo_slices_f64

# Above this basis size the JAX package switches to its streaming tier on
# a TPU (`afesp_tpu/methods/mp2.py:48`).  The port, never on a TPU,
# takes a sliced tier by the memory rule (`calc_tier`) or under
# AFESP_FORCE_STREAM=1; the value names the tier in the driver's refusal
# of the spin-orbital CCSD under the variable, as the JAX driver words it.
STREAM_NBASIS = 140

# Card memory the tier rule keeps free beside the dense path's n^4
# tensors: the CUDA context, the allocator's slack and the CC stages'
# working set.
TIER_HEADROOM_BYTES = 8e9
# The dense path's peak in units of one dense n^4 f64 tensor: at "f64"
# the AO tensor and `ao_to_mo`'s two live quarter transforms (the
# trimer's measured 22.04 GB = 3 x 7.33); on the digit-GEMM route the
# trimer's measured 40.99 GB = 5.6 x 7.33.
_DENSE_N4_TENSORS = {"f64": 3.0, "hybrid": 5.6}
_DIGIT_PRECISIONS = ("hybrid", "pallas", "fused")


def _force_stream() -> bool:
    """AFESP_FORCE_STREAM=1: the JAX package's hook that routes any size
    through the streaming tier (`afesp_tpu/methods/mp2.py:335`)."""
    return os.environ.get("AFESP_FORCE_STREAM", "") == "1"


def dense_need_bytes(n: int, precision: str) -> float:
    """The dense path's card memory at nbasis n: its n^4 f64 tensors
    (`_DENSE_N4_TENSORS`) plus the packed store resident beside them."""
    npair = n * (n + 1) // 2
    route = "hybrid" if precision in _DIGIT_PRECISIONS else "f64"
    return _DENSE_N4_TENSORS[route] * 8.0 * n**4 + 8.0 * npair * (npair + 1) // 2


def choose_tier(n: int, precision: str, device, budget_bytes: float | None = None) -> str:
    """The tier at nbasis n: "dense", or where the dense path's need and
    `TIER_HEADROOM_BYTES` pass `budget_bytes` the sliced tier of the
    precision ("stream" for the digit-GEMM route, "sliced" at "f64").
    The budget is by default the card's total memory
    (`torch.cuda.mem_get_info`); on the CPU, with no budget given, the
    tier is always "dense"."""
    if budget_bytes is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return "dense"
        budget_bytes = torch.cuda.mem_get_info(dev)[1]
    if dense_need_bytes(n, precision) + TIER_HEADROOM_BYTES <= budget_bytes:
        return "dense"
    return "stream" if precision in _DIGIT_PRECISIONS else "sliced"


def calc_tier(n: int, cfg: Config, device) -> str:
    """The tier of a calculation: "stream" under AFESP_FORCE_STREAM=1
    (any precision; the f64 CCSD then refuses it, as in the JAX
    package), else `choose_tier`."""
    if _force_stream():
        return "stream"
    return choose_tier(n, cfg.ccsd_precision, device)


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
    tier: str | None = None,
) -> MP2Result:
    """The MP2 stage on `tier` ("dense", "stream" or "sliced"; None:
    `calc_tier`)."""
    dev = default_device(device)
    rep = rep or Reporter()
    t_start = time.perf_counter()
    rep.section("MP2")
    rep.write(" Performing AO to MO ERI transformation...")

    nocc = sys_.nel // 2
    C = torch.as_tensor(hf.coeff, dtype=F64, device=dev)
    tier = tier or calc_tier(sys_.nbasis, cfg, dev)
    if tier != "dense":
        if tier == "stream":
            # streaming tier: packed store -> physicist slices, each vvvv
            # chunk digitized to L=5 limbs with its own scales as it is
            # computed (JAX `:266-293`); the packed store is freed once the
            # transform's row table supersedes it
            slices, vvvv_B = ao_to_mo_slices(
                ints.packed_on_device(dev), C, n=sys_.nbasis, nocc=nocc, digit_L=5,
                free_packed=ints.free_device_packed,
            )
        else:
            # sliced f64 tier: RHF's row table -> the f64 slices, v_vvvv
            # among them; the table is freed once its first half transform
            # has consumed it
            slices = ao_to_mo_slices_f64(ints, C, nocc=nocc)
            vvvv_B = None
        rep.write(" Calculating MP2 energy...")
        lv = torch.as_tensor(hf.levels, dtype=F64, device=dev)
        e_mp2 = float(mp2_energy_from_oovv(slices.v_oovv, lv[:nocc], lv[nocc:]))
        trace.synced()
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
    trace.synced()
    rep.write(f" MP2 correlation energy (Hartree): {e_mp2:15.8f}")

    if cfg.write_fcidump:
        rep.write(" Writing FCIDUMP file...")
        write_fcidump(Path(workdir) / "FCIDUMP", eri_mo.cpu().numpy())
        trace.synced()
        rep.write(" Done writing FCIDUMP file!")

    rep.stage_time("Time taken for restricted MP2:", time.perf_counter() - t_start)
    return MP2Result(e_mp2=e_mp2, eri_mo=eri_mo)
