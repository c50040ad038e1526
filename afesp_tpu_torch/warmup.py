"""Compile-ahead of the CUDA kernels.

Port of what `afesp_tpu/warmup.py:1-27,451-529` promises: as soon as the
system's dimensions are known, a daemon thread prepares what the
triples stage will need, so that the host-bound stages before it (RHF,
MP2, CCSD) hide the cost.  In the JAX package that cost is compiling
the CC programs; in the port it is building the hand-written kernels
with `nvcc` (`ops/_build.py`), seconds a library, which without this
module the triples stage pays at its first launch.

`start(sys_, cfg, dev)` runs right after the integral read-in
(`driver.run_calculation`, where the JAX driver calls it).  On a CUDA
device it starts a thread that runs `_build.build` for the libraries the
triples tier of this calc_type will load (`libraries`): K1 for the
spin-orbital (T) (the driver's tier on a card, "fused"), K3, K4 or K5
for the restricted tier `ccsd_precision` and nvirt pick, nothing
without (T) and nothing on the CPU.  `join()` waits for that thread;
`_build.load` joins before it builds anything itself, so no library is
compiled twice.  A failure in the thread is kept and raised by the next
`join` (so by `load`): it is never swallowed, and nothing falls back to
a plain version.  Correctness is untouched; only when the build happens
changes.  `stats()` says how long the build took and how long `join`
waited for it.

The JAX module's foreground gate (`clear_for_cc`, `_FG_GATE`) exists
because its dummy executions queue on the TPU ahead of the pipeline's
own work.  `nvcc` runs on the host and issues no device work, so there
is nothing to queue behind and no gate here.
"""

from __future__ import annotations

import threading
import time

import torch

from .config import Config
from .io import dat
from .ops import _build

# the library each restricted triples tier loads
_SPATIAL = {"fused": "triples_fused_spatial", "tiled": "triples_tiled_spatial",
            "pallas": "triples_finale_spatial"}


class _Build:
    """One compile-ahead build: its thread, and what the thread found."""

    def __init__(self, names: list[str]):
        self.names, self.built, self.error, self.seconds = names, {}, None, 0.0
        self.thread = threading.Thread(target=self._run, name="afesp-torch-warmup",
                                       daemon=True)

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            self.built = _build.build(self.names)
        except Exception as e:  # kept for join(), which raises it
            self.error = e
        self.seconds = time.perf_counter() - t0


_LOCK = threading.Lock()
_PENDING: list[_Build] = []  # the build in flight, if any
_STATS: dict = {}


def libraries(sys_: dat.System, cfg: Config, dev: torch.device) -> list[str]:
    """The kernel libraries the driver's triples stage will load for this
    system and config on `dev`: the tier `driver.run_calculation` hands
    the triples function (the spin-orbital default, "fused" on a card;
    the restricted `spatial_tier`)."""
    if dev.type != "cuda" or not cfg.wants_triples:
        return []
    if cfg.restricted:
        from .methods.triples_spatial import spatial_tier

        name = _SPATIAL.get(spatial_tier(cfg, dev, sys_.nvirt))
    else:
        name = "triples_fused"
    return [name] if name else []


def start(sys_: dat.System, cfg: Config, dev: torch.device) -> None:
    """Begin building this run's kernel libraries in a daemon thread; a
    no-op when there are none or a build is already in flight."""
    names = libraries(sys_, cfg, dev)
    with _LOCK:
        if not names or _PENDING:
            return
        _PENDING.append(_Build(names))
        _PENDING[0].thread.start()


def join() -> None:
    """Wait for the build in flight, if any; raise its failure."""
    with _LOCK:
        jobs = list(_PENDING)
        _PENDING.clear()
    for job in jobs:
        t0 = time.perf_counter()
        job.thread.join()
        _STATS.clear()
        _STATS.update(names=job.names, built=sorted(job.built), build_s=job.seconds,
                      waited_s=time.perf_counter() - t0)
        if job.error is not None:
            raise job.error


def stats() -> dict:
    """Of the last build joined: the libraries asked for (`names`), those
    compiled (`built`), the thread's wall (`build_s`) and how long the
    join waited for it (`waited_s`); the part of `build_s` the stages
    before the join hid is `build_s - waited_s`."""
    return dict(_STATS)
