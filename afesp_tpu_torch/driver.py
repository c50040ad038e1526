"""Pipeline driver — the program `main` equivalent (main.F90:24-186).

Port of `afesp_tpu/driver.py:28-243` (`RunResult`, `run_calculation`,
`_final_breakdown`).  Dispatch on (restricted, calc_type):

  restricted:   RHF -> MP2_spatial -> CCSD_spatial -> (T)_spatial family
  spin-orbital: RHF -> MP2_spatial -> CCSD_spinorb -> (T)_spinorb

with the reference's timing lines and final energy-breakdown table
(labels are scraped by the binding-curve wrapper, so they are API).
The device mesh, the JAX compile cache, warmup and profiler are not
ported: `mesh_devices != 0` raises "not ported yet".
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import torch

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


def run_calculation(
    workdir: str | Path = ".",
    rep: Reporter | None = None,
    cfg: Config | None = None,
    device: str | torch.device | None = None,
) -> RunResult:
    dev = default_device(device)
    rep = rep or Reporter()
    workdir = Path(workdir)
    t_glob = time.perf_counter()

    rep.banner()
    t0 = time.perf_counter()
    if cfg is None:
        cfg = read_els_in(workdir)
    if cfg.mesh_devices != 0:
        raise NotImplementedError("mesh_devices: multi-device runs are not ported yet")

    rep.section("Integral read-in")
    rep.write(" Getting number of basis functions...")
    rep.write(" Allocating integral store...")
    rep.write(" Reading overlap matrix...")
    rep.write(" Reading kinetic integrals...")
    rep.write(" Reading nuclear-electron integrals...")
    rep.write(" Constructing core Hamiltonian...")
    rep.write(" Reading two-body integrals...")
    sys_, ints = dat.read_integrals(workdir, cfg.restricted)
    rep.write(" Done reading integrals!")
    rep.sys_info(sys_, ints, cfg)
    rep.stage_time(
        "Time taken for system initialisation:", time.perf_counter() - t0
    )

    res = RunResult(cfg=cfg, sys=sys_, e_nuc=ints.e_nuc)

    hf = hf_mod.do_rhf(sys_, ints, cfg, rep, workdir, device=dev)
    res.hf = hf
    res.e_hf = hf.e_hf
    res.e_highest = 0.0

    if cfg.wants_mp2:
        mp2 = mp2_mod.do_mp2_spatial(sys_, ints, cfg, hf, rep, workdir, device=dev)
        res.e_mp2 = mp2.e_mp2
        res.e_highest = mp2.e_mp2

        if cfg.wants_ccsd and cfg.restricted:
            t_cc = time.perf_counter()
            cc = do_ccsd_spatial(sys_, mp2.eri_mo, cfg, hf, rep, workdir, device=dev)
            rep.stage_time(
                "Time taken for restricted CCSD:", time.perf_counter() - t_cc
            )
            res.cc = cc
            res.e_ccsd = cc.e_ccsd
            res.t1_diagnostic = cc.t1_diagnostic
            res.e_highest = cc.e_ccsd
            if cfg.wants_triples:
                tr = do_ccsd_t_spatial(sys_, cc, cfg, hf.levels, rep)
                res.triples = tr
                res.e_highest = tr.e_highest
        elif cfg.wants_ccsd:
            t_cc = time.perf_counter()
            cc = do_ccsd_spinorb(sys_, mp2.eri_mo, cfg, hf, rep, workdir, device=dev)
            rep.stage_time(
                "Time taken for unrestricted CCSD:", time.perf_counter() - t_cc
            )
            res.cc = cc
            res.e_ccsd = cc.e_ccsd
            res.e_highest = cc.e_ccsd
            if cfg.wants_triples:
                e_t = do_ccsd_t_spinorb(sys_, cc, cfg, hf.levels, rep)
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
