"""Stdout report formatting, label-compatible with the reference.

Port of `afesp_tpu/io/report.py`, kept as an independent copy: every
line format must stay identical to the JAX package's.

The binding-curve wrapper scrapes stdout by substring match
(els_wrapper.py:104-127), so every label below is part of the public API.
Formats mirror the Fortran edit descriptors in main.F90 / hf.f90 /
ccsd.f90 / integrals.f90.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class Reporter:
    stream: object = field(default_factory=lambda: sys.stdout)

    def write(self, line: str = "") -> None:
        print(line, file=self.stream)

    # -- banners ---------------------------------------------------------
    def banner(self) -> None:
        self.write(" " + "=" * 64)
        self.write(" A Fortran Electronic Structure Programme (AFESP)")
        self.write(" " + "=" * 64)
        t = time.localtime()
        self.write(
            f" Started running on {t.tm_mday:02d}/{t.tm_mon:02d}/{t.tm_year:04d}"
            f" at {t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}"
        )

    def finish(self, total_seconds: float) -> None:
        t = time.localtime()
        self.write(" " + "=" * 64)
        self.write(
            f" Finished running on {t.tm_mday:02d}/{t.tm_mon:02d}/{t.tm_year:04d}"
            f" at {t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d}"
        )
        self.write(f" Total execution time: {total_seconds:16.8f}")

    def section(self, title: str) -> None:
        bar = "-" * len(title)
        self.write(f" {bar}")
        self.write(f" {title}")
        self.write(f" {bar}")

    def stage_time(self, label: str, seconds: float) -> None:
        # main.F90:43 '(1X, A, 1X, F16.8, A)'
        self.write(f" {label} {seconds:16.8f}s")

    # -- system info (integrals.f90:212-251) ------------------------------
    def sys_info(self, sys_, ints, cfg) -> None:
        self.section("System information")
        self.write(f" Number of electrons: {sys_.nel}")
        self.write(f" Number of basis functions: {sys_.nbasis}")
        self.write(f" Number of occupied orbitals: {sys_.nocc}")
        self.write(f" Number of virtual orbitals: {sys_.nvirt}")
        self.write(f" E_nuc: {ints.e_nuc:15.8E}")
        self.write(f" scf_e_tol: {cfg.scf_e_tol:8.2E}")
        self.write(f" scf_d_tol: {cfg.scf_d_tol:8.2E}")
        self.write(f" ccsd_e_tol: {cfg.ccsd_e_tol:8.2E}")
        self.write(f" ccsd_t_tol: {cfg.ccsd_t_tol:8.2E}")
        self.write(f" Number of SCF DIIS error matrices: {cfg.scf_diis_n_errmat}")
        self.write(f" Number of CCSD DIIS error matrices: {cfg.ccsd_diis_n_errmat}")
        self.write(f" Maximum number of SCF iterations: {cfg.scf_maxiter}")
        self.write(f" Maximum number of CCSD iterations: {cfg.ccsd_maxiter}")
        self.write(" Printing out the input file...")
        self.write("-" * 30)
        for line in cfg.raw_text.rstrip("\n").split("\n"):
            self.write(line)
        self.write("-" * 30)

    # -- iteration tables --------------------------------------------------
    def scf_table_header(self) -> None:
        self.write("-" * 75)
        self.write(
            " Iteration        Energy           deltaE           delta RMS D      Time  "
        )
        self.write("-" * 75)

    def scf_row(self, it: int, e: float, de: float, rms: float, t: float) -> None:
        # hf.f90:111 '(1X, I9, 3X, F15.10, 3X, F15.10, 3X, F15.10, 3X, F8.6)'
        self.write(f" {it:9d}   {e:15.10f}   {de:15.10f}   {rms:15.10f}   {t:8.6f}")

    def cc_table_header(self) -> None:
        self.write("-" * 75)
        self.write(
            " Iteration        Energy           deltaE          delta RMS T2      Time  "
        )
        self.write("-" * 75)

    def cc_row(self, it, e: float, de: float, rms: float, t: float | None = None):
        # ccsd.f90:226/249 '(1X, I9/A9, 3X, F15.12, 3X, F15.12, 3X, F15.12[, 3X, F8.6])'
        tag = f"{it:>9}" if isinstance(it, str) else f"{it:9d}"
        row = f" {tag}   {e:15.12f}   {de:15.12f}   {rms:15.12f}"
        if t is not None:
            row += f"   {t:8.6f}"
        self.write(row)

    def table_close(self) -> None:
        self.write("-" * 75)

    # -- final breakdown (main.F90:123-175) --------------------------------
    def breakdown_line(self, label: str, value: float) -> None:
        # '(1X, A, 1X, F15.10)' with 31-char labels
        self.write(f" {label:<31} {value:15.10f}")

    def breakdown_bar(self) -> None:
        self.write(" " + "-" * 47)
