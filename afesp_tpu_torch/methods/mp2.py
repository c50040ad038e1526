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
runs on a TPU, so it is dense at every nbasis, and raises "not ported
yet" only where JAX would be forced to stream.
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
# a TPU (`afesp_tpu/methods/mp2.py:48`).  Kept for parity of the two
# modules; the port reads it nowhere, since it never runs on a TPU.
STREAM_NBASIS = 140


def _force_stream() -> bool:
    """AFESP_FORCE_STREAM=1: the JAX package's hook that routes any size
    through the streaming tier (`afesp_tpu/methods/mp2.py:335`)."""
    return os.environ.get("AFESP_FORCE_STREAM", "") == "1"


@dataclasses.dataclass
class MP2Result:
    e_mp2: float
    eri_mo: torch.Tensor  # dense chemist (pq|rs) in the canonical MO basis


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
    if _force_stream():
        raise NotImplementedError(
            "AFESP_FORCE_STREAM=1: the streaming tier is not ported yet"
        )
    rep.section("MP2")
    rep.write(" Performing AO to MO ERI transformation...")

    nocc = sys_.nel // 2
    C = torch.as_tensor(hf.coeff, dtype=F64, device=dev)
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
