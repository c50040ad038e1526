"""Pipeline driver — the program `main` equivalent (main.F90:24-186).

Port of `afesp_tpu/driver.py:28-243` (`RunResult`, `_enable_compile_cache`'s
fingerprint check, `run_calculation` with its compile-ahead and profiler
trace, `_final_breakdown`).  Dispatch on (restricted, calc_type):

  restricted:   RHF -> MP2_spatial -> CCSD_spatial -> (T)_spatial family
  spin-orbital: RHF -> MP2_spatial -> CCSD_spinorb -> (T)_spinorb

Under AFESP_FORCE_STREAM=1 the restricted chain runs the streaming tier
(the MP2 stage hands CCSD its slices and vvvv limbs, no dense MO
tensor); the spin-orbital CCSD needs the dense tensor and is refused
there with the JAX driver's ValueError.

with the reference's timing lines and final energy-breakdown table
(labels are scraped by the binding-curve wrapper, so they are API).

The JAX package's run-time plumbing, in the port's terms: on a CUDA
device the kernel build directory's fingerprint is checked first
(`cachemeta.check`, a warning on a mismatch, as JAX checks its compile
cache), and right after the read-in `warmup.start` builds the kernels
the triples stage will load while RHF, MP2 and CCSD run.  With
AFESP_TORCH_PROFILE=<dir> (JAX: AFESP_JAX_PROFILE and jax.profiler) the
run is traced by torch.profiler, CPU and, on a card, CUDA activities,
with one `record_function` range for each span of `trace.py`: the root
`calc`, each stage section of the report ("Integral read-in",
"Restricted Hartree-Fock", "MP2", "CCSD", "CCSD(T)") and the spans
inside them, and a Chrome trace is written into <dir> when the run ends
or raises.  Without the variable there is no profiler and no range.
With `trace.enable()` the same spans are recorded in memory, one record
a calculation.

The device mesh follows JAX's width rule (`afesp_tpu/driver.py:112-129`): 0 and 1
run on one device, -1 means every visible device (`parallel.mesh.
visible_devices`: the cards on a CUDA device, the CPU alone on the
CPU), a width above the visible count raises JAX's ValueError, and a
width of 2 or more runs the CC stages on a mesh of the first that many
(`parallel/`; the report says so), handed to both CCSD and both triples
functions as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from pathlib import Path

import torch

from . import cachemeta, trace, warmup
from .config import CalcType, Config, read_els_in
from .device import default_device
from .io import dat
from .io.report import Reporter
from .methods import hf as hf_mod
from .methods import mp2 as mp2_mod
from .methods.ccsd_spatial import CCSDResult, do_ccsd_spatial
from .methods.ccsd_spinorb import CCSDSpinorbResult, do_ccsd_spinorb
from .methods.triples_spatial import TriplesResult, do_ccsd_t_spatial
from .methods.triples_spinorb import do_ccsd_t_spinorb
from .ops import _build
from .parallel import mesh as pmesh

PROFILE_ENV = "AFESP_TORCH_PROFILE"


@dataclasses.dataclass
class RunResult:
    cfg: Config
    sys: dat.System
    e_nuc: float
    e_hf: float = 0.0  # electronic
    e_mp2: float = 0.0
    e_ccsd: float = 0.0
    e_ccsd_t: float = 0.0  # spinorb CCSD(T)
    triples: TriplesResult | None = None  # the restricted triples family
    t1_diagnostic: float = 0.0
    e_highest: float = 0.0
    # the stage results a caller may want to continue from
    hf: hf_mod.HFResult | None = None
    cc: CCSDSpinorbResult | CCSDResult | None = None

    @property
    def total_energy(self) -> float:
        return self.e_hf + self.e_highest + self.e_nuc


@contextlib.contextmanager
def _profiled(directory: str, dev: torch.device):
    """torch.profiler around the run, each span a range of it; its Chrome
    trace is written into `directory` when the run ends or raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        with trace.ranges():
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"afesp_torch_{os.getpid()}_{time.time_ns()}.json"))


def run_calculation(
    workdir: str | Path = ".",
    rep: Reporter | None = None,
    cfg: Config | None = None,
    device: str | torch.device | None = None,
) -> RunResult:
    dev = default_device(device)
    if dev.type == "cuda":
        # the kernels' build directory, as the JAX driver checks its
        # compile cache (a mismatch warns, the run goes on)
        cachemeta.check(_build.BUILD_DIR)
    profile_dir = os.environ.get(PROFILE_ENV)
    with _profiled(profile_dir, dev) if profile_dir else contextlib.nullcontext():
        with trace.span("calc"):
            return _run(workdir, rep, cfg, dev)


def _run(workdir, rep: Reporter | None, cfg: Config | None, dev: torch.device) -> RunResult:
    """run_calculation's pipeline, a span for each report section."""
    rep = rep or Reporter()
    workdir = Path(workdir)
    t_glob = time.perf_counter()

    rep.banner()
    t0 = time.perf_counter()
    if cfg is None:
        cfg = read_els_in(workdir)

    with trace.span("Integral read-in"):
        rep.section("Integral read-in")
        rep.write(" Getting number of basis functions...")
        rep.write(" Allocating integral store...")
        rep.write(" Reading overlap matrix...")
        rep.write(" Reading kinetic integrals...")
        rep.write(" Reading nuclear-electron integrals...")
        rep.write(" Constructing core Hamiltonian...")
        rep.write(" Reading two-body integrals...")
        # on a card only the packed ERI store is kept on the host
        sys_, ints = dat.read_integrals(workdir, cfg.restricted, host_dense=dev.type == "cpu")
        rep.write(" Done reading integrals!")
    # compile-ahead: the kernels the triples stage will load are built
    # while the stages before it run
    warmup.start(sys_, cfg, dev)
    rep.sys_info(sys_, ints, cfg)
    rep.stage_time(
        "Time taken for system initialisation:", time.perf_counter() - t0
    )

    res = RunResult(cfg=cfg, sys=sys_, e_nuc=ints.e_nuc)

    # optional device mesh for the CC and triples stages (els.in knob
    # `mesh_devices`)
    mesh = None
    if cfg.mesh_devices and cfg.mesh_devices != 1:
        ndev = len(pmesh.visible_devices(dev))
        want = ndev if cfg.mesh_devices < 0 else cfg.mesh_devices
        if want > ndev:
            raise ValueError(
                f"mesh_devices={cfg.mesh_devices} but only {ndev} devices visible"
            )
        if want >= 2:
            mesh = pmesh.default_mesh(want, dev)
            rep.write(f" Using a {want}-device mesh for CC stages.")

    with trace.span("Restricted Hartree-Fock"):
        hf = hf_mod.do_rhf(sys_, ints, cfg, rep, workdir, device=dev)
    res.hf = hf
    res.e_hf = hf.e_hf
    res.e_highest = 0.0

    if cfg.wants_mp2:
        with trace.span("MP2"):
            mp2 = mp2_mod.do_mp2_spatial(sys_, ints, cfg, hf, rep, workdir, device=dev)
        res.e_mp2 = mp2.e_mp2
        res.e_highest = mp2.e_mp2

        if cfg.wants_ccsd and cfg.restricted:
            t_cc = time.perf_counter()
            with trace.span("CCSD"):
                cc = do_ccsd_spatial(sys_, mp2.eri_mo, cfg, hf, rep, workdir, device=dev,
                                     slices=mp2.slices, vvvv_B=mp2.vvvv_B, mesh=mesh)
            mp2.vvvv_B = None  # the limbs' last reader was the CC stage
            rep.stage_time(
                "Time taken for restricted CCSD:", time.perf_counter() - t_cc
            )
            res.cc = cc
            res.e_ccsd = cc.e_ccsd
            res.t1_diagnostic = cc.t1_diagnostic
            res.e_highest = cc.e_ccsd
            if cfg.wants_triples:
                with trace.span("CCSD(T)"):
                    tr = do_ccsd_t_spatial(sys_, cc, cfg, hf.levels, rep, mesh=mesh)
                res.triples = tr
                res.e_highest = tr.e_highest
        elif cfg.wants_ccsd:
            if mp2.eri_mo is None:
                raise ValueError(
                    "spin-orbital CCSD needs the dense MO tensor; the"
                    f" streaming tier (nbasis >= {mp2_mod.STREAM_NBASIS})"
                    " currently serves the spatial formulation only —"
                    " use a *_spatial calc_type at this scale"
                )
            t_cc = time.perf_counter()
            with trace.span("CCSD"):
                cc = do_ccsd_spinorb(sys_, mp2.eri_mo, cfg, hf, rep, workdir, device=dev,
                                     mesh=mesh)
            rep.stage_time(
                "Time taken for unrestricted CCSD:", time.perf_counter() - t_cc
            )
            res.cc = cc
            res.e_ccsd = cc.e_ccsd
            res.e_highest = cc.e_ccsd
            if cfg.wants_triples:
                with trace.span("CCSD(T)"):
                    e_t = do_ccsd_t_spinorb(sys_, cc, cfg, hf.levels, rep, mesh=mesh)
                res.e_ccsd_t = e_t
                res.e_highest = e_t

    _final_breakdown(rep, res)
    rep.finish(time.perf_counter() - t_glob)
    return res


def _final_breakdown(rep: Reporter, res: RunResult) -> None:
    """The breakdown table (main.F90:123-175); labels are scraped by
    els_wrapper.py:104-127 and must not change."""
    cfg = res.cfg
    e0 = res.e_hf + res.e_nuc
    rep.write(" " + "=" * 64)
    rep.write(" Final energy breakdown")
    rep.breakdown_line("RHF energy:", e0)
    ct = cfg.calc_type
    if ct in (CalcType.MP2, CalcType.CCSD, CalcType.CCSD_T):
        rep.breakdown_line("MP2 correlation energy:", res.e_mp2)
        rep.breakdown_line("MP2 energy:", res.e_mp2 + e0)
        if ct in (CalcType.CCSD, CalcType.CCSD_T):
            rep.breakdown_line("CCSD correlation energy:", res.e_ccsd)
            rep.breakdown_line("CCSD energy:", res.e_ccsd + e0)
            if ct is CalcType.CCSD_T and cfg.restricted:
                tr = res.triples
                rep.breakdown_line("CCSD[T] correlation energy:", tr.e_ccsd_t)
                rep.breakdown_line("CCSD[T] energy:", tr.e_ccsd_t + e0)
                if cfg.ccsd_t_paren:
                    rep.breakdown_line("CCSD(T) correlation energy:", tr.e_ccsd_tt)
                    rep.breakdown_line("CCSD(T) energy:", tr.e_ccsd_tt + e0)
                if cfg.ccsd_t_renorm or cfg.ccsd_t_comp_renorm:
                    rep.breakdown_line("R-CCSD[T] correlation energy:", tr.e_rccsd_t)
                    rep.breakdown_line("R-CCSD[T] energy:", tr.e_rccsd_t + e0)
                    if cfg.ccsd_t_paren:
                        rep.breakdown_line("R-CCSD(T) correlation energy:", tr.e_rccsd_tt)
                        rep.breakdown_line("R-CCSD(T) energy:", tr.e_rccsd_tt + e0)
                    if cfg.ccsd_t_comp_renorm:
                        rep.breakdown_line("CR-CCSD[T] correlation energy:", tr.e_crccsd_t)
                        rep.breakdown_line("CR-CCSD[T] energy:", tr.e_crccsd_t + e0)
                        if cfg.ccsd_t_paren:
                            rep.breakdown_line(
                                "CR-CCSD(T) correlation energy:", tr.e_crccsd_tt
                            )
                            rep.breakdown_line("CR-CCSD(T) energy:", tr.e_crccsd_tt + e0)
            elif ct is CalcType.CCSD_T:
                rep.breakdown_line("CCSD(T) correlation energy:", res.e_ccsd_t)
                rep.breakdown_line("CCSD(T) energy:", res.e_ccsd_t + e0)
    if ct in (CalcType.CCSD, CalcType.CCSD_T) and cfg.restricted:
        rep.breakdown_bar()
        rep.breakdown_line("T1 diagnostic:", res.t1_diagnostic)
    if cfg.ccsd_t_renorm or cfg.ccsd_t_comp_renorm:
        rep.breakdown_line("D[T]:", res.triples.D_T)
        if cfg.ccsd_t_paren:
            rep.breakdown_line("D(T):", res.triples.D_TT)
    rep.breakdown_bar()
    rep.breakdown_line("Total electronic energy:", res.e_hf + res.e_highest)
    rep.breakdown_line("Nuclear repulsion:", res.e_nuc)
    rep.breakdown_line("Total energy:", res.e_hf + res.e_highest + res.e_nuc)
