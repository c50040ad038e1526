#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives `afesp_tpu_torch` — never the JAX package — through its paths:
on H2O/cc-pVTZ (58 basis functions) CCSD(T)_spinorb (10 occupied and
106 virtual spin orbitals) and restricted CRCCSD(T)_spatial (5 occupied
and 53 virtual spatial orbitals), and on the water dimer/cc-pVTZ (116
basis functions, 10 occupied and 106 virtual spatial orbitals)
restricted CRCCSD(T)_spatial and CCSD(T)_spinorb (20 occupied and 212
virtual spin orbitals, the vvvv slice held as its spin blocks), and on
the water trimer/cc-pVTZ (174 basis functions, 15 occupied and 159
virtual spatial orbitals) restricted CRCCSD(T)_spatial, both from
integrals the port's engine builds on the card; each of these paths at
ccsd_precision "f64" and at "hybrid" (the JAX package's digit-GEMM
CCSD, ops/exact_gemm), the committed inputs as written.  Each phase
prints one line with its wall time:

  1. the device: torch's name and count, and nvidia-smi's name and
     power limit;
  2. the build of the C scanner (`io/_fastparse.c`) and of every CUDA
     kernel with nvcc, all five sources in parallel, timed (the
     `-Xptxas -v` report is printed);
  3. each kernel against its plain PyTorch version on the card, on
     seeded random inputs: K1 and K2 at the spin-orbital path's shapes;
     K3, K4 and K5 at the spatial path's (o=5, v=53), the 116-bf dimer's
     (o=10, v=106) and, for K4, the 174-bf trimer's (o=15, v=159), with
     all variants on (T, R, CR).  Relative error <= 1e-11 of each sum
     (both sides f64, only the order of summation differs; a sum nearer
     0 than 1e-6 of the largest is held to that floor instead), and two
     launches agree bit for bit; kernel, plain and library times by CUDA
     events at every shape (above the paths' shapes the kernel over 2
     launches, the plain version and the library over 1), K1's split
     between its numerator and energy-pass launches, K3's and K4's
     between their numerator GEMMs (and each of the three groups), their
     reduction and their operand and host work; then K1 alone at the
     spin-orbital dimer's shape (o=20, v=212, 1140 strict triples), held
     and timed the same way; then the digit GEMM (`digit_gemm*`):
     bit for bit against its CPU run at the pVTZ paths' shapes on every
     flat-scale route, and timed at the dimer's vvvv shapes against
     f64 torch.matmul, beside its int8 bound;
  4. the spin-orbital path, `run_calculation` on a staged copy of
     data/h2o-cc-pvtz-2.00_104.45 with the committed eri.dat, default
     "fused" triples tier (K1): HF, MP2, CCSD and CCSD(T) totals within
     1e-8 Ha of the JAX package's CPU run (expected_jax_cpu.json) and
     equal SCF and CC iteration counts; then the same inputs at
     "hybrid", bench.py's headline configuration (`hybrid_pvtz_spinorb`);
  5. its "pallas" triples tier (K2) on the same converged amplitudes:
     E(T) within 1e-9 of the fused tier and of JAX's f64 E(T);
  6. the restricted path, `run_calculation` on the same inputs with the
     CRCCSD(T)_spatial els.in of expected_jax_cpu_crccsd_t_spatial.json,
     default "fused" triples tier (K3): every breakdown value within
     1e-8 of that file (the JAX package's CPU run) and equal SCF and CC
     iteration counts; then at "hybrid" (`hybrid_pvtz_spatial`, after
     phase 7);
  7. its "tiled" (K4) and "pallas" (K5) triples tiers on the same
     converged amplitudes: the six triples energies, D[T] and D(T) within
     1e-9 of the fused tier and of JAX's f64 values;
  8. information, not a gate: CCSD_spatial writes its amplitudes on the
     CPU and on the card, and the CC iterations each file takes to
     restart a run on the card (the restarted energies are held to
     1e-8 of the writers');
  9. the pVTZ read-in (`read_integrals`) by the scanner and by the numpy
     route, in turns, on the same files;
 10. the engine on the card at pVTZ ("fixture-cc-pvtz" at the committed
     geometry): S, T, V against the committed s/t/v.dat, the ERIs within
     1e-12 of the JAX engine's sample and no farther from the committed
     eri.dat than the JAX engine is (an earlier form of that engine wrote
     it);
 11. the dimer: s/t/v.dat and a packed eri.npy from the engine on the
     card (the ERIs within 1e-12 of the JAX sample in
     data/h2o-dimer-cc-pvtz/expected_jax_cpu_crccsd_t_spatial.json),
     `run_calculation` through that eri.npy with the committed els.in at
     "f64": every breakdown value within 1e-8 of the JAX package's f64
     CPU run, equal SCF and CC iteration counts, HF and MP2 within 1e-8
     of oracle.json, K3 launched once and no other kernel; then K3, K4
     and K5 held and timed on the path's own amplitudes, and the "tiled"
     and "pallas" tiers within 1e-10 of the K3 path; then the committed
     els.in as written, "hybrid" (`dimer_hybrid_path`);
 12. the spin-orbital dimer: the same inputs with the committed els.in
     at calc_type "CCSD(T)_spinorb" and ccsd_precision "f64" through
     `run_calculation`: vvvv held as its two spin blocks by the 4e9-byte
     rule, every breakdown value within 1e-8 of the JAX package's CPU
     run (expected_jax_cpu_ccsd_t_spinorb.json), E(T) within 1e-8 of
     JAX's f64 tier, equal SCF and CC iteration counts, K1 once and no
     other kernel, the card's peak memory; CCSD corr and E(T) against the
     restricted dimer printed, not gated; then K1 held and timed on the
     path's amplitudes, and the "pallas" tier (K2) within 1e-9 of K1's
     E(T), with K2's row on its first chunk of panels; then at "hybrid"
     (`spinorb_dimer_hybrid_path`);
 13. the trimer: the engine's one-electron integrals against the
     committed s/t/v.dat and its ERIs packed into eri.npy beside copies
     of the committed inputs; the committed els.in at "f64" through
     `run_calculation`: every breakdown value within 1e-8 of the JAX
     package's f64 CPU run and equal SCF and CC iteration counts
     (data/h2o-trimer-cc-pvtz/expected_jax_cpu_crccsd_t_spatial.json,
     whose ERI sample holds the engine's to 1e-12), HF and MP2 within
     1e-8 of oracle.json, K4 once and no other kernel, the card's peak
     memory; then K4 held and timed on the path's amplitudes; then the
     committed els.in as written, "hybrid" (`trimer_hybrid_path`);
 14. the streaming-slices tier (`stream_pieces`, `dimer_stream_path`,
     `trimer_stream_path`): its pieces at small seeded shapes on the card
     against the port's CPU run bit for bit (the stream Fock consts and
     build, the sliced transform's slices, vvvv limbs and scales over
     several chunks, the CR term from the limbs); then the dimer (after
     its hybrid path) and the trimer (after its hybrid path, through the
     same eri.npy) with AFESP_FORCE_STREAM=1 set for the phase alone and
     the committed els.in as written: every breakdown value within 1e-8
     of the JAX package's stream run (`expected_jax_cpu*_stream.json`),
     equal SCF, prelude and CC iteration counts, MP2, CCSD and the six
     triples within 1e-10 of it (JAX's f64 triples on its own stream
     amplitudes and CR term), and against the port's own dense hybrid
     run MP2 within 1e-10, CCSD 1e-8, the triples 5e-8, D[T] and D(T)
     1e-6; K3 (dimer) or K4 (trimer) once and no other kernel, then held
     and timed on the stream path's amplitudes; each prints its wall,
     stage walls, CC ms an iteration and peak memory beside the dense
     hybrid run's;
 15. the device mesh (`mesh_*` phases): with `parallel.mesh.
     visible_devices` giving cuda:0 twice, `mesh_devices = 2` added to
     the els.in runs the CC stages on a mesh that lists the one card
     twice, which runs every sharded code path and every kernel once per
     entry (a speed or memory gain needs two cards; none is measured):
     `mesh_pvtz_*`, both pVTZ calc_types at "f64" and at "hybrid" (K1 or
     K3 once an entry), and `mesh_pvtz_pallas_tiers`, the "pallas" tiers
     on the f64 runs' amplitudes (K2 on each entry's chunks, K5 on each
     entry's slabs); `mesh_dimer_hybrid`, the dimer's committed els.in
     (the vvvv digit GEMMs split over both entries); `mesh_spinorb_dimer`,
     the spin-orbital dimer at "f64" on the (aa, ab) store;
     `mesh_dimer_stream`, the dimer on the streaming tier (the limbs' 53
     chunks padded to 54 and split, each entry's bytes printed beside the
     total, the CR term from the split limbs); each held to its JAX file
     as its one-device phase is, within 1e-12 of the port's one-device run
     with equal counts, and the mesh line printed; `mesh_trimer_k4`, K4
     once on each entry at the trimer path's shape on its amplitudes,
     within 1e-12 of one launch;
 16. the f32 "hybrid" (T) tiers (`hybrid_triples_*`): on the converged
     amplitudes of the pVTZ spin-orbital and restricted paths and of the
     restricted and spin-orbital dimer paths, do_ccsd_t_spinorb and
     do_ccsd_t_spatial at precision "hybrid" on the card (f32 panel
     GEMMs, TF32 refused; the restricted one with the f32 CR chain): E(T)
     or the six energies, D[T] and D(T) within 5e-9 of the f64 kernel
     tier the path ran, no kernel launched, and on the pVTZ amplitudes
     within 1e-9 of the same tier on the CPU; each tier's wall beside the
     kernel tier's;
 17. `compile_ahead`: the dimer's hybrid path again, in a fresh process
     whose kernel build directory is an empty one, so the compile-ahead
     build (`warmup.py`) compiles K3 while RHF, MP2 and CCSD run: the
     breakdown the warm run's line for line, K3 compiled once, the build
     directory's fingerprint check passing; the build's seconds, the
     seconds the triples stage waited for it, and the cold walls (path,
     RHF, triples) beside the warm ones;
 18. `profile`, the last phase (no timed phase runs after the
     profiler has traced the card): the pVTZ restricted path with
     AFESP_TORCH_PROFILE set:
     one Chrome trace, holding a range for each stage section and K3's
     kernels, the breakdown the unprofiled run's line for line; the
     trace's split of one CCSD iteration (GEMM kernels, other kernels,
     time with no kernel running) printed;
 19. one JSON line of every path's metrics (`paths`: wall, CC iteration
     ms, CCSD TFLOP/s by flops.py, peak memory; the mesh paths marked
     with the card's name and power limit), and one of the kernels, a
     row for each kernel at each shape timed: launches on the path that
     runs it, its launches over the mesh phases, times, bound, the
     bound's share of the time and errors, and the splits of K1, K3 and
     K4.

Each hybrid path (`hybrid_path`) is held to the JAX package's CPU run at
"hybrid" (`expected_jax_cpu*_hybrid.json`, tools/make_torch_dimer_fixture.py
--precision hybrid): the CCSD ran the digit GEMMs (precision_used
"hybrid", digit-pair GEMMs launched, no line beyond JAX's report),
every breakdown value within 1e-8, CCSD correlation within 1e-10,
equal SCF and CC iteration counts, the triples within 1e-10 of JAX's
f64 triples on its own hybrid amplitudes, K1, K3 or K4 launched once
and no other kernel; it prints its metrics beside those of the f64 path
at the same input.  A restricted hybrid path runs the f32 CR chain into
K3 or K4, as the JAX package's TPU branch does at "hybrid": the two
values the chain feeds, e_crccsd_t and e_crccsd_tt, are held within
5e-9 (JAX's bound between its f32 and f64 tiers; JAX's own f32 chain
moves e_crccsd_t by 1.1e-10 at pVTZ), and the same kernel tier with the
f64 chain on the same amplitudes is held within 1e-10 on all eight
values; both sets of gaps are printed (`triples_err`,
`triples_err_f64_chain`).

On every path each text table must be parsed by the C scanner: a file
that went through the numpy route fails the check.

Every check raises on failure (nonzero exit, no `ok` line).  The last
line is {"ok": true, "device": {...}}.  The script writes nothing into
the checkout except the kernels' gitignored build directory; its work
directories are temporary ones, removed at the end.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "data" / "h2o-cc-pvtz-2.00_104.45"
ERI = REPO / "data" / "h2o-cc-pvtz" / "eri.dat"
SPATIAL_EXPECTED = FIXTURE / "expected_jax_cpu_crccsd_t_spatial.json"
PVTZ_ERI_SAMPLE = FIXTURE / "expected_jax_cpu_eri_sample.json"
DIMER = REPO / "data" / "h2o-dimer-cc-pvtz"
DIMER_EXPECTED = DIMER / "expected_jax_cpu_crccsd_t_spatial.json"
SPINORB_DIMER_EXPECTED = DIMER / "expected_jax_cpu_ccsd_t_spinorb.json"
TRIMER = REPO / "data" / "h2o-trimer-cc-pvtz"
TRIMER_EXPECTED = TRIMER / "expected_jax_cpu_crccsd_t_spatial.json"
# the JAX package's CPU runs at ccsd_precision "hybrid" (digit-GEMM CCSD),
# with its f64 triples on its own hybrid amplitudes
# (tools/make_torch_dimer_fixture.py --precision hybrid)
HYBRID_EXPECTED = {
    "hybrid_pvtz_spinorb": FIXTURE / "expected_jax_cpu_hybrid.json",
    "hybrid_pvtz_spatial": FIXTURE / "expected_jax_cpu_crccsd_t_spatial_hybrid.json",
    "dimer_hybrid_path": DIMER / "expected_jax_cpu_crccsd_t_spatial_hybrid.json",
    "spinorb_dimer_hybrid_path": DIMER / "expected_jax_cpu_ccsd_t_spinorb_hybrid.json",
    "trimer_hybrid_path": TRIMER / "expected_jax_cpu_crccsd_t_spatial_hybrid.json",
}
# the JAX package's CPU runs of the streaming-slices tier (AFESP_FORCE_STREAM=1,
# the committed els.in), with its f64 triples on its own stream amplitudes and
# CR term (tools/make_torch_dimer_fixture.py --stream)
STREAM_EXPECTED = {
    "dimer_stream_path": DIMER / "expected_jax_cpu_crccsd_t_spatial_stream.json",
    "trimer_stream_path": TRIMER / "expected_jax_cpu_crccsd_t_spatial_stream.json",
}
# a stream path against the JAX stream run: MP2, CCSD and the six triples
STREAM_TOL = 1e-10
# ... and against the port's own dense "hybrid" run of the same input, at
# the tolerances the JAX package holds its stream tier to its dense one
# (tests/test_stream_tier.py): MP2, CCSD, the six triples, D[T] and D(T)
STREAM_VS_DENSE_TOL = {"e_mp2": 1e-10, "e_ccsd": 1e-8, "triples": 5e-8, "D": 1e-6}
SIX_TRIPLES = ("e_ccsd_t", "e_ccsd_tt", "e_rccsd_t", "e_rccsd_tt", "e_crccsd_t",
               "e_crccsd_tt")
# each path's energies, for the stream-vs-dense checks
PATH_VALUES: dict = {}
# each one-device path's results (result_values), for the mesh phases
ONE_DEVICE: dict = {}
# each path's report text, for the compile-ahead and profile phases
PATH_TEXT: dict = {}
# the mesh phases: the width asked for in els.in, and how far a mesh run
# may be from the same path on one device (only the order of f64 sums
# differs: the shares' partial sums, the limbs' chunk partials)
MESH_WIDTH = 2
MESH_TOL = 1e-12
# each kernel's launches over the mesh phases
MESH_LAUNCHES: dict = {}
DIMER_BASIS = "cc-pvtz"  # tools/make_dimer.py
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the f64 tensor-core
# peak (the f64 work of every kernel could at best run there)
HBM_BYTES_PER_S = 3.35e12
PEAK_F64_PER_S = 67e12
# ... and its dense int8 tensor-core peak (the digit-pair GEMMs' work)
PEAK_INT8_PER_S = 1979e12
# a device-side wait (~25 ms) while the host queues the timed calls
QUEUE_CYCLES = 50_000_000
KERNEL_RTOL = 1e-11
KERNEL_FLOOR = 1e-6  # of the largest of a kernel's six sums
ENERGY_TOL = 1e-8
TRIPLES_TOL = 1e-9
DIMER_TIER_TOL = 1e-10
# the hybrid paths against the JAX package's hybrid CPU runs: CCSD
# correlation, and the triples on the path's amplitudes against JAX's f64
# triples on its own
HYBRID_CCSD_TOL = 1e-10
HYBRID_TRIPLES_TOL = 1e-10
# the f32 "hybrid" (T) tiers on a path's amplitudes: against the f64 kernel
# tier on the same amplitudes (JAX's bound between its two tiers,
# tests/test_triples_precision.py), and against the port's CPU "hybrid" run
# (f32 GEMMs blocked otherwise by cuBLAS and the CPU's BLAS)
HYBRID_VS_KERNEL_TOL = 5e-9
HYBRID_VS_CPU_TOL = 1e-9
# the values the f32 CR chain feeds (m3 only), on a restricted hybrid path:
# held to JAX's f64 triples at JAX's bound between its f32 and f64 tiers,
# since an f32 chain is no closer (JAX's own chain moves e_crccsd_t by
# 1.1e-10 at pVTZ on the CPU, tools/hybrid_triples_gaps.py); the same
# tier with the f64 chain on the same amplitudes keeps HYBRID_TRIPLES_TOL
CR_KEYS = ("e_crccsd_t", "e_crccsd_tt")
CR_F32_TOL = 5e-9
# a CUDA kernel of K3 in a profiler trace (csrc/spatial_gemm.cuh,
# csrc/sorted_triples.cuh)
K3_TRACE_KERNELS = ("group_gemm_kernel", "sorted_orbit_kernel")
ERI_TOL = 1e-12
# one chunk of K4's kernels at the pentamer's shape (o = 25, v = 265:
# cube_chunk_len gives 6 triples): sorted triples with i = j, j = k and
# all three distinct
PENTAMER_CHUNK = [(0, 0, 1), (3, 3, 24), (2, 7, 7), (0, 1, 2), (4, 13, 22), (9, 10, 17)]
# generated s/t/v.dat against committed ones, both printed to 15 decimals:
# |difference| / max(1, |value|)
DAT_RTOL = 1e-14


@contextmanager
def phase(name: str, info: dict):
    t0 = time.perf_counter()
    yield
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s {extra}".rstrip(), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5, warm: bool = True) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up
    unless the caller has just run it (`warm=False`).  The calls queue
    behind a device-side wait of QUEUE_CYCLES, so a wrapper that does not
    synchronise is timed at the device's pace, not the host's."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_problem(torch, dev, o: int, v: int, seed: int = 7):
    """Antisymmetry-respecting random (T) inputs, as in
    tests/test_triples_pallas.py, made with numpy from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t1 = rng.standard_normal((o, v)) * 0.02
    t2 = rng.standard_normal((o, o, v, v)) * 0.02
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    oovv = rng.standard_normal((o, o, v, v)) * 0.02
    oovv = oovv - oovv.transpose(1, 0, 2, 3)
    oovv = (oovv - oovv.transpose(0, 1, 3, 2)) / 2
    ovoo = rng.standard_normal((o, v, o, o)) * 0.02
    ovoo = ovoo - ovoo.transpose(0, 1, 3, 2)
    vovv = rng.standard_normal((v, o, v, v)) * 0.02
    vovv = vovv - vovv.transpose(0, 1, 3, 2)
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    return tuple(
        torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)
        for x in (t1, t2, vovv, ovoo, oovv, e[:o], e[o:])
    )


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F64_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(o: int, v: int, n: int, args) -> tuple[float, str]:
    """K1 over n triples: 2 v^3 3(v+o) GEMM flops and ~16 an element for
    t3d, P and the sum; inputs read once, the sum written once."""
    in_bytes = sum(x.numel() * 8 for x in args) + 3 * n * 8
    return bound_ms(n * v**3 * (6 * (v + o) + 5 + 11), in_bytes + 8)


K1_SOURCE = "afesp_tpu_torch/csrc/triples_fused.cu"
K1_REPLACES = "afesp_tpu/ops/triples_pallas.py:926 (triples_fused, body _fused_kernel :308)"


def k1_split(K, args, idx, reps: int = 3) -> list[float]:
    """K1's numerator and energy-pass launches, each summed over the
    chunks by CUDA events around it: the mean [numerator, energy] ms of
    `reps` calls (launches counted as any call's)."""
    tot = [0.0, 0.0]
    for _ in range(reps):
        split = []
        K.triples_fused(*args, *idx, split=split)
        tot = [t + sum(s[q] for s in split) / reps for q, t in enumerate(tot)]
    return tot


def k1_dimer_check(torch, dev, o: int = 20, v: int = 212, args=None, label: str = "") -> dict:
    """K1 at the spin-orbital dimer's shape (data/h2o-dimer-cc-pvtz: 20
    occupied, 212 virtual spin orbitals, 1140 strict triples) on seeded
    random inputs, or on `args` (the path's own): held against its plain
    version to KERNEL_RTOL, two launches bit-identical, kernel ms over 2
    launches after a warm-up, the plain version's and the all-torch f64
    tier's ms over one launch each, its bound and its split."""
    from afesp_tpu_torch.methods import triples_spinorb as T
    from afesp_tpu_torch.ops import triples_cuda as K

    if args is None:
        args = random_problem(torch, dev, o, v)
    idx = tuple(torch.as_tensor(x, dtype=torch.long, device=dev)
                for x in T.strict_triple_list(o))
    n = idx[0].numel()
    got = K.triples_fused(*args, *idx)
    again = K.triples_fused(*args, *idx)
    want = K.triples_fused_plain(*args, *idx)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), f"triples_fused (o={o}, v={v}): two launches differ")
    g, w = float(got), float(want)
    rel = abs(g - w) / max(abs(w), 1e-300)
    check(rel <= KERNEL_RTOL, f"triples_fused (o={o}, v={v}): kernel {g!r} vs plain {w!r} "
                              f"(rel {rel:.3e})")
    pi, pj, pk, clen = (torch.as_tensor(x, dtype=torch.long, device=dev)
                        if not isinstance(x, int) else x for x in T.strict_plan(o, v))
    library = lambda: 6.0 * T._triples_total_strict(*args, pi, pj, pk, clen=clen,
                                                    precision="f64")
    return dict(shape=f"o={o}, v={v}, {n} strict triples{label}", max_abs_err=abs(g - w),
                max_rel_err=rel, ms=cuda_ms(torch, lambda: K.triples_fused(*args, *idx), 2),
                plain_ms=cuda_ms(torch, lambda: K.triples_fused_plain(*args, *idx), 1,
                                 warm=False),
                library_ms=cuda_ms(torch, library, 1, warm=False),
                bound=k1_bound(o, v, n, args), split_ms=k1_split(K, args, idx, 1))


def k2_row(torch, dev, args, o: int, v: int, label: str = "") -> dict:
    """K2 at the "pallas" tier's chunk shape, (clen, v, v, v) panels of
    the first chunk of strict triples of `args`: two launches
    bit-identical; the kernel's and the plain version's ms over 5 calls;
    the caller holds `got` against `want`."""
    from afesp_tpu_torch.methods import triples_spinorb as T
    from afesp_tpu_torch.ops import triples_cuda as K

    pi, pj, pk, clen = (torch.as_tensor(x, dtype=torch.long, device=dev)
                        if not isinstance(x, int) else x for x in T.strict_plan(o, v))
    t3c, t3d = T._chunk_panels(pi[:clen], pj[:clen], pk[:clen], *args[:5])
    e_o, e_v = args[5], args[6]
    eo_sum = (e_o[pi[:clen]] + e_o[pj[:clen]] + e_o[pk[:clen]]).contiguous()
    fin = (t3c.contiguous(), t3d.contiguous(), eo_sum, e_v)
    got = K.triples_finale(*fin)
    again = K.triples_finale(*fin)
    want = K.triples_finale_plain(*fin)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), f"triples_finale (v={v}): two launches differ")
    plain_ms = cuda_ms(torch, lambda: K.triples_finale_plain(*fin))
    return dict(
        got=got, want=want,
        ms=cuda_ms(torch, lambda: K.triples_finale(*fin)),
        plain_ms=plain_ms,
        # the plain version is already one torch expression of the same
        # function over all panels, so the library call is that same call
        library_ms=plain_ms,
        bound=bound_ms(clen * v**3 * 11, 2 * clen * v**3 * 8 + (clen + v + 1) * 8),
        shape=f"({clen}, v, v, v) panels x2, v={v}{label}",
        source="afesp_tpu_torch/csrc/triples_finale.cu",
        replaces="afesp_tpu/ops/triples_pallas.py:1042 (triples_finale, body _finale_kernel :46)",
    )


def kernel_checks(torch, dev, o: int, v: int) -> dict:
    from afesp_tpu_torch.methods import triples_spinorb as T
    from afesp_tpu_torch.ops import triples_cuda as K

    args = random_problem(torch, dev, o, v)
    ii, jj, kk = (torch.as_tensor(x, dtype=torch.long, device=dev)
                  for x in T.strict_triple_list(o))
    n = ii.numel()
    rows = {}

    # K1 at the main path's shapes: all strict triples of o = 10, v = 106
    got = K.triples_fused(*args, ii, jj, kk)
    again = K.triples_fused(*args, ii, jj, kk)
    want = K.triples_fused_plain(*args, ii, jj, kk)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), "triples_fused: two launches differ")
    pi, pj, pk, clen = (torch.as_tensor(x, dtype=torch.long, device=dev)
                        if not isinstance(x, int) else x for x in T.strict_plan(o, v))
    library = lambda: 6.0 * T._triples_total_strict(
        *args, pi, pj, pk, clen=clen, precision="f64")
    rows["triples_fused"] = dict(
        got=got, want=want,
        ms=cuda_ms(torch, lambda: K.triples_fused(*args, ii, jj, kk)),
        plain_ms=cuda_ms(torch, lambda: K.triples_fused_plain(*args, ii, jj, kk)),
        library_ms=cuda_ms(torch, library),
        split_ms=k1_split(K, args, (ii, jj, kk)),
        bound=k1_bound(o, v, n, args), shape=f"o={o}, v={v}, {n} strict triples",
        source=K1_SOURCE, replaces=K1_REPLACES,
    )

    rows["triples_finale"] = k2_row(torch, dev, args, o, v)
    for name, r in rows.items():
        g, w = float(r["got"]), float(r["want"])
        r["max_abs_err"] = abs(g - w)
        r["max_rel_err"] = abs(g - w) / max(abs(w), 1e-300)
        check(r["max_rel_err"] <= KERNEL_RTOL,
              f"{name}: kernel {g!r} vs plain {w!r} (rel {r['max_rel_err']:.3e})")
    return rows


def random_spatial_problem(torch, dev, o: int, v: int, seed: int = 11):
    """Random restricted-triples inputs (t1, t2, v_vvov, v_oovo, v_oovv,
    e_o, e_v, I_vovv'', I_ooov''), made with numpy from a seed as in
    tests/test_triples_tiled.py: t2 and v_oovv carry the pair-exchange
    symmetry X[i,j,a,b] = X[j,i,b,a] that the sorted-triple identity of
    the z3/y sums needs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s) * 0.02
    sym = lambda x: (x + x.transpose(1, 0, 3, 2)) / 2
    e = np.sort(rng.standard_normal(o + v))
    e[o:] += 4.0
    arrs = (r(o, v), sym(r(o, o, v, v)), r(v, v, o, v), r(o, o, v, o), sym(r(o, o, v, v)),
            e[:o], e[o:], r(v, o, v, v), r(o, o, o, v))
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64, device=dev)
                 for x in arrs)


def six_sum_error(got, want) -> tuple[float, float]:
    """(max abs error, max relative error) over six sums; a sum nearer 0
    than KERNEL_FLOOR of the largest is held relative to that floor."""
    g, w = got.tolist(), want.tolist()
    floor = KERNEL_FLOOR * max(abs(x) for x in w)
    abs_err = max(abs(a - b) for a, b in zip(g, w))
    rel_err = max(abs(a - b) / max(abs(b), floor, 1e-300) for a, b in zip(g, w))
    return abs_err, rel_err


def spatial_kernel_checks(torch, dev, o: int, v: int, args=None, flags=None,
                          label: str = "", names: tuple | None = None,
                          triples: list | None = None) -> dict:
    """K3, K4 and K5 against their plain versions at (o, v), all variants
    on (K3 and K5 up to nvirt 128, as their tiers run), with the kernels',
    the plain versions' and the library's times, the bounds and K3's and
    K4's splits.  Up to the spatial path's shape every time is a mean of 5
    launches; above it the kernels take 2, and the plain versions and
    the all-torch f64 tier one launch each.  The inputs are seeded random
    ones unless `args` (and the path's variant `flags`) are given; `names`
    keeps only those kernels' rows; `triples` (sorted (i, j, k), with
    their orbit weights) replaces the whole sorted plan, and then the
    all-torch tier, which runs every triple, is not timed."""
    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    if args is None:
        args = random_spatial_problem(torch, dev, o, v)
    if triples is None:
        (si, sj, sk), w = TS._sorted_plan(o, dev)
    else:
        si, sj, sk = (torch.tensor([t[q] for t in triples], dtype=torch.int32, device=dev)
                      for q in range(3))
        w = torch.tensor([1.0 if i < j < k else 1.0 / 6.0 if i == j == k else 0.5
                          for i, j, k in triples], dtype=torch.float64, device=dev)
    n = si.numel()
    flags = flags or dict(doing_T=True, doing_R=True, doing_CR=True)
    rows = {}

    small = v <= 53
    reps = 5 if small else 2

    def held(name, fn, plain):
        got, again = fn(), fn()
        want = plain()
        torch.cuda.synchronize()
        check(bool(torch.equal(got, again)), f"{name} (o={o}, v={v}): two launches differ")
        abs_err, rel_err = six_sum_error(got, want)
        check(rel_err <= KERNEL_RTOL,
              f"{name} (o={o}, v={v}): kernel {got.tolist()} vs plain {want.tolist()} "
              f"(rel {rel_err:.3e})")
        return dict(max_abs_err=abs_err, max_rel_err=rel_err, ms=cuda_ms(torch, fn, reps),
                    plain_ms=cuda_ms(torch, plain, 5) if small else
                    cuda_ms(torch, plain, 1, warm=False))

    # bytes of the sorted-triple function: every input read once, six sums out
    in_bytes = sum(x.numel() * 8 for x in args) + n * (3 * 4 + 8) + 6 * 8
    # its operations: 24 numerator GEMMs of 2 v^3 K flops (K = v for 12, o for
    # 12), and ~90 flops an element for D, M(x), M(zn), y and the six sums
    ops = n * (12 * 2 * v**3 * (v + o) + 90 * v**3)
    jlen = TS.pick_spatial_jlen(o, v, "f64")
    f64_total = lambda: torch.stack(TS._triples_total_spatial(
        *args, nocc=o, jlen=jlen, precision="f64", **flags))
    for name, fn, plain in (
        ("triples_fused_spatial", S.triples_fused_spatial, S.triples_fused_spatial_plain),
        ("triples_tiled_spatial", S.triples_tiled_spatial, S.triples_tiled_spatial_plain),
    ):
        if name == "triples_fused_spatial" and v > 128:
            continue  # K3 is the default up to nvirt 128: checked up to the dimer's
        if names is not None and name not in names:
            continue
        rows[name] = held(name, lambda fn=fn: fn(*args, si, sj, sk, w, **flags),
                          lambda plain=plain: plain(*args, si, sj, sk, w, **flags))
        rows[name].update(library_ms=None if triples is not None else
                          cuda_ms(torch, f64_total) if small else
                          cuda_ms(torch, f64_total, 1, warm=False),
                          bound=bound_ms(ops, in_bytes))
    # K3's and K4's split: the three group GEMMs (each in group_ms), the
    # reduction, the operand and host work
    for name, fn in (("triples_tiled_spatial", S.triples_tiled_spatial),
                     ("triples_fused_spatial", S.triples_fused_spatial)):
        if name not in rows:
            continue
        parts = None
        for _ in range(reps):
            split = []
            fn(*args, si, sj, sk, w, **flags, split=split)
            parts = split if parts is None else [a + b for a, b in zip(parts, split)]
        parts = [p / reps for p in parts]
        rows[name]["group_ms"] = parts[:3]
        rows[name]["split_ms"] = [sum(parts[:3]), parts[3], parts[4]]

    if v <= 128 and (names is None or "triples_finale_spatial" in names):
        # K5 is checked up to the dimer's shape, as K3
        # the panels of one i-slab, as the "pallas" tier builds them
        fa = TS.finale_panels(0, 0, *args, jlen=TS.pick_spatial_jlen(o, v, "pallas"),
                              doing_CR=flags["doing_CR"])
        fk = dict(doing_T=flags["doing_T"], doing_Y=flags["doing_R"] or flags["doing_CR"],
                  doing_CR=flags["doing_CR"])
        r = rows["triples_finale_spatial"] = held(
            "triples_finale_spatial", lambda: S.triples_finale_spatial(*fa, **fk),
            lambda: S.triples_finale_spatial_plain(*fa, **fk))
        P = fa[0].shape[0]
        r["shape"] = f"{P} panels of (v, v, v), v={v}{label}"
        # the plain version is one torch expression of the same function
        r["library_ms"] = r["plain_ms"]
        # ~45 flops an element: D, xbar of x and zn, zn at three points,
        # y, six products
        fin_bytes = sum(x.numel() * 8 for x in fa if x is not None) + 6 * 8
        r["bound"] = bound_ms(P * v**3 * 45, fin_bytes)
    sources = {
        "triples_fused_spatial": (
            "afesp_tpu_torch/csrc/triples_fused_spatial.cu",
            "afesp_tpu/ops/triples_pallas.py:784 (triples_fused_spatial, body "
            "_fused_spatial_kernel :470)"),
        "triples_tiled_spatial": (
            "afesp_tpu_torch/csrc/triples_tiled_spatial.cu",
            "afesp_tpu/ops/triples_tiled.py:347 (triples_tiled_spatial: stage 1 "
            "_chunk_cubes :71, stage 2 _tiled_kernel :151 via _pallas_partials :279)"),
        "triples_finale_spatial": (
            "afesp_tpu_torch/csrc/triples_finale_spatial.cu",
            "afesp_tpu/ops/triples_pallas.py:222 (triples_finale_spatial, body "
            "_make_spatial_kernel :97)"),
    }
    for name, r in rows.items():
        r["shape"] = r.get("shape", f"o={o}, v={v}, {n} sorted triples{label}")
        r["source"], r["replaces"] = sources[name]
    return rows


def scanner_routes_check(fastparse, path: str, at_least: int) -> dict:
    """Every text table a path read went through the C scanner: none by
    numpy, and at least `at_least` by the scanner."""
    routes = dict(fastparse.ROUTES)
    check(routes.get("numpy", 0) == 0, f"{path}: {routes.get('numpy')} file(s) parsed by numpy")
    check(routes.get("scanner", 0) >= at_least,
          f"{path}: {routes.get('scanner', 0)} file(s) through the scanner, {at_least} expected")
    return routes


def stage_wall(text: str, label: str) -> float:
    """Seconds of the report's 'Time taken for <label>' line."""
    line = next(ln for ln in text.splitlines() if f"Time taken for {label}" in ln)
    return float(line.rsplit(None, 1)[1].rstrip("s"))


def dat_agree(a: Path, b: Path) -> float:
    """Two i-j-value `.dat` files: the same index columns, and the largest
    difference of their values relative to max(1, |value|)."""
    from afesp_tpu_torch.io import dat

    ta, tb = dat._parse_numeric_table(a, 3), dat._parse_numeric_table(b, 3)
    check(ta.shape == tb.shape and bool((ta[:, :2] == tb[:, :2]).all()),
          f"{b.name}: the index columns differ from {a}")
    rel = abs(ta[:, 2] - tb[:, 2]) / (abs(ta[:, 2]).clip(min=1.0))
    return float(rel.max())


def eri_sample_error(torch, packed, sample: dict) -> dict:
    """The engine's packed store against a JAX sample: the largest error
    over the sampled elements, and the sum's and Frobenius norm's."""
    check(packed.numel() == sample["count"],
          f"packed store of {packed.numel()} values, the sample's has {sample['count']}")
    idx = torch.as_tensor(sample["index"], device=packed.device)
    want = torch.as_tensor(sample["value"], dtype=torch.float64, device=packed.device)
    err = float((packed[idx] - want).abs().max())
    check(err <= ERI_TOL, f"ERIs off the JAX sample by {err:.3e}")
    return dict(max_abs_err=err, sum_diff=float(packed.sum()) - sample["sum"],
                frobenius_diff=float(torch.linalg.vector_norm(packed)) - sample["frobenius"])


def engine_pvtz(torch, dev) -> None:
    """The engine on the card against files it did not write: H2O at the
    committed pVTZ geometry with "fixture-cc-pvtz"; S, T, V against the
    committed s/t/v.dat; the ERIs against the JAX engine's sample and the
    committed data/h2o-cc-pvtz/eri.dat, parsed by the scanner.  That file
    was written by an earlier form of the JAX engine: the limit is the
    JAX engine's own distance from it (in the sample file) plus ERI_TOL."""
    from afesp_tpu_torch.integrals import engine as E
    from afesp_tpu_torch.io import dat

    sample = json.loads(PVTZ_ERI_SAMPLE.read_text())
    info = {}
    with phase("engine_pvtz", info):
        # the Boys function on the card over T from 0 (the T < 1e-13
        # branch) to 1e7, past what the dimer's primitives reach
        T_ = torch.cat([torch.tensor([0.0, 1e-14, 1e-12], dtype=torch.float64),
                        torch.logspace(-9, 7, 4000, dtype=torch.float64)])
        boys_err = float((E.boys(12, T_.to(dev)).cpu() - E.boys(12, T_)).abs().max())
        check(boys_err <= 1e-14, f"Boys function on the card off the CPU's by {boys_err:.3e}")
        _, charges, coords = dat.read_geometry(FIXTURE / "geom.dat")
        basis = E.build_basis(charges, coords, "fixture-cc-pvtz")
        walls = {"1e": [], "eri": []}
        for _ in range(2):  # the first pass pays the card's first use of each op
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mats = {"s.dat": E.overlap(basis, dev), "t.dat": E.kinetic(basis, dev),
                    "v.dat": E.nuclear(basis, charges, coords, dev)}
            torch.cuda.synchronize()
            walls["1e"].append(round(time.perf_counter() - t0, 4))
            t0 = time.perf_counter()
            packed = E.eri_packed(basis, dev)
            torch.cuda.synchronize()
            walls["eri"].append(round(time.perf_counter() - t0, 4))
        for name, M in mats.items():
            ref = torch.as_tensor(dat.read_dat_matrix(FIXTURE / name, basis.nbf))
            rel = float(((M.cpu() - ref).abs() / ref.abs().clamp(min=1.0)).max())
            check(rel <= DAT_RTOL, f"{name}: engine off the committed file by {rel:.3e}")
            info[f"{name}_rel_err"] = f"{rel:.3e}"
        sampled = eri_sample_error(torch, packed, sample["eri_sample"])
        committed = dat.pack_from_quadruple_table(dat.read_eri_table(ERI), basis.nbf)
        d_file = float((packed - torch.as_tensor(committed, device=dev)).abs().max())
        jax_file = sample["vs_committed_eri_dat"]["max_abs_diff"]
        check(d_file <= jax_file + ERI_TOL,
              f"ERIs off the committed eri.dat by {d_file:.3e}; the JAX engine by {jax_file:.3e}")
        info.update(nbasis=basis.nbf, walls_cold_warm_s=json.dumps(walls),
                    boys_err=f"{boys_err:.3e}", vs_jax_sample=json.dumps(sampled),
                    vs_committed_eri_dat=f"{d_file:.3e}", jax_engine_vs_committed=f"{jax_file:.3e}")


def read_in_walls(torch) -> None:
    """The pVTZ read-in (`read_integrals` as a card run calls it, packed
    store only) by the scanner and by the numpy route, on the same files
    in the same call."""
    from afesp_tpu_torch.io import dat, fastparse

    wd = stage_workdir()
    info = {}
    try:
        with phase("read_in_pvtz", info):
            walls = {}
            for route in ("numpy", "scanner", "numpy", "scanner"):
                fastparse._LIB = False if route == "numpy" else None
                t0 = time.perf_counter()
                dat.read_integrals(wd, True, host_dense=False)
                walls.setdefault(route, []).append(time.perf_counter() - t0)
            fastparse._LIB = None
            info.update({f"{k}_s": json.dumps([round(x, 4) for x in v])
                         for k, v in walls.items()})
    finally:
        fastparse._LIB = None
        shutil.rmtree(wd, ignore_errors=True)


def dimer_phases(torch, dev, kernels: dict, wd: Path) -> tuple[dict, list]:
    """The 116-bf water dimer, CRCCSD(T)_spatial, end to end on the card:
    its integrals by the port's engine (ERIs packed into eri.npy), held
    against the JAX sample and the committed s/t/v.dat; run_calculation
    through the eri.npy read-in, held against the JAX package's CPU run
    (every breakdown value within ENERGY_TOL, equal SCF and CC iteration
    counts) and cross-checked against oracle.json; K3 once and no other
    kernel on that path; then K3, K4 and K5 on the path's own amplitudes,
    held against their plain versions and timed, and the "tiled" (K4) and
    "pallas" (K5) tiers against the K3 path within DIMER_TIER_TOL.  The
    dimer's inputs are left in `wd` for the spin-orbital dimer.  The
    committed els.in asks for "hybrid"; this path runs it at "f64"
    (dimer_hybrid_path runs it as written).  Returns the kernels'
    launches on the path and its tiers, the kernel rows at the path's
    amplitudes, and the path's metrics (cc_metrics)."""
    import io

    import numpy as np

    from afesp_tpu_torch.integrals import engine as E
    from afesp_tpu_torch.integrals.generate import write_dat_files
    from afesp_tpu_torch.io import dat, fastparse
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import triples_spatial as TS

    want = json.loads(DIMER_EXPECTED.read_text())
    oracle = json.loads((DIMER / "oracle.json").read_text())
    info = {}
    with phase("dimer_integrals", info):
        _, charges, coords = dat.read_geometry(DIMER / "geom.dat")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        basis = write_dat_files(wd, charges, coords, DIMER_BASIS, write_eri=False,
                                device=dev)
        wall_1e_files = time.perf_counter() - t0
        t0 = time.perf_counter()
        E.overlap(basis, dev), E.kinetic(basis, dev), E.nuclear(basis, charges, coords, dev)
        torch.cuda.synchronize()
        wall_1e = time.perf_counter() - t0
        t0 = time.perf_counter()
        packed = E.eri_packed(basis, dev)
        torch.cuda.synchronize()
        wall_eri = time.perf_counter() - t0
        np.save(wd / "eri.npy", packed.cpu().numpy())
        sampled = eri_sample_error(torch, packed, want["eri_sample"])
        del packed
        rels = {f: dat_agree(DIMER / f, wd / f) for f in ("s.dat", "t.dat", "v.dat")}
        for f, rel in rels.items():
            check(rel <= DAT_RTOL, f"dimer {f}: off the committed file by {rel:.3e}")
        check((wd / "geom.dat").read_bytes() == (DIMER / "geom.dat").read_bytes(),
              "the generated geom.dat differs from the committed one")
        (wd / "els.in").write_text(els_at(DIMER, "f64"))
        check((wd / "els.in").read_text() == want["els_in"],
              "the staged els.in differs from the f64 reference's")
        info.update(nbasis=basis.nbf, wall_1e_s=f"{wall_1e:.3f}",
                    wall_1e_with_files_s=f"{wall_1e_files:.3f}",
                    wall_eri_s=f"{wall_eri:.3f}", vs_jax_sample=json.dumps(sampled),
                    dat_rel_err=json.dumps({k: f"{v:.3e}" for k, v in rels.items()}))

    info = {}
    with phase("dimer_path", info):
        fastparse.ROUTES.clear()
        res, text, wall, peak, launches = run_path(torch, wd, kernels)
        routes = scanner_routes_check(fastparse, "dimer path", 3)
        tr = res.triples
        e0 = res.e_hf + res.e_nuc
        got = {"e_hf_total": e0, "e_mp2_corr": res.e_mp2, "e_ccsd_corr": res.e_ccsd,
               "t1_diagnostic": res.t1_diagnostic}
        got.update({k: getattr(tr, k) for k in want["triples"]})
        ref = {k: want[k] for k in ("e_hf_total", "e_mp2_corr", "e_ccsd_corr",
                                    "t1_diagnostic")} | want["triples"]
        errs = {k: abs(got[k] - ref[k]) for k in ref}
        for label, val in printed_values(text, want["breakdown"]).items():
            errs[label] = abs(val - want["breakdown_values"][label])
        check(len(errs) == len(got) + len(want["breakdown_values"]),
              "the dimer breakdown block lacks a line of the reference's")
        for key, err in errs.items():
            check(err <= ENERGY_TOL, f"dimer {key}: off the JAX value by {err:.3e}")
        check(res.hf.iterations == want["scf_iterations"],
              f"dimer SCF iterations {res.hf.iterations} vs JAX {want['scf_iterations']}")
        check(res.cc.iterations == want["cc_iterations"],
              f"dimer CC iterations {res.cc.iterations} vs JAX {want['cc_iterations']}")
        oracle_err = {"e_hf_total": abs(e0 - oracle["e_hf_total"]),
                      "e_mp2_corr": abs(res.e_mp2 - oracle["e_mp2_corr"])}
        for key, err in oracle_err.items():
            check(err <= ENERGY_TOL, f"dimer {key}: off oracle.json by {err:.3e}")
        check(tr.precision_used == "fused", f"dimer triples tier {tr.precision_used}")
        check(res.cc.precision_used == "f64", f"dimer CCSD ran {res.cc.precision_used}")
        check(launches["triples_fused_spatial"] == 1,
              f"K3 launched {launches['triples_fused_spatial']} times on the dimer path")
        others = {n: c for n, c in launches.items() if n != "triples_fused_spatial" and c}
        check(not others, f"other kernels launched on the dimer path: {others}")
        walls = path_walls(text, "restricted CCSD:", "restricted completely renormalised",
                           res.cc.iterations)
        metrics = cc_metrics(text, res, wall, peak)
        info.update(wall_s=f"{wall:.3f}", launches=json.dumps(launches),
                    cc_iter_ms=metrics["cc_iter_ms"], ccsd_tflops=metrics["ccsd_tflops"],
                    peak_memory_gb=metrics["peak_memory_gb"],
                    max_abs_err=f"{max(errs.values()):.3e}",
                    scf_iterations=res.hf.iterations, cc_iterations=res.cc.iterations,
                    oracle_scf_iterations=oracle["scf_iterations"],
                    oracle_err=json.dumps({k: f"{v:.3e}" for k, v in oracle_err.items()}),
                    walls_s=json.dumps(walls),
                    routes=json.dumps(routes))
    for line in text.splitlines():
        if line.lstrip().startswith("Time taken for"):
            print(f"  {line.strip()}", flush=True)

    # K3, K4 and K5 on the path's own amplitudes, held and timed
    info = {}
    with phase("dimer_kernels", info):
        cfg, cc, nocc = res.cfg, res.cc, res.sys.nocc
        lv = torch.as_tensor(res.hf.levels, dtype=torch.float64, device=dev)
        Iv, Jo = TS.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, cc.slices, nocc)
        v = cc.slices
        args = (cc.t1, cc.t2, v.v_vvov, v.v_oovo, v.v_oovv, lv[:nocc],
                lv[nocc : nocc + res.sys.nvirt], Iv, Jo)
        flags = dict(doing_T=cfg.ccsd_t_paren, doing_R=cfg.ccsd_t_renorm,
                     doing_CR=cfg.ccsd_t_comp_renorm)
        rows = spatial_kernel_checks(torch, dev, o=nocc, v=res.sys.nvirt, args=args,
                                     flags=flags, label=", dimer path's amplitudes")
        info.update({n: f"rel={r['max_rel_err']:.3e},ms={r['ms']:.4f}"
                     for n, r in rows.items()})

    tier_launches = {"triples_fused_spatial": launches["triples_fused_spatial"]}
    for tier, kname in (("tiled", "triples_tiled_spatial"),
                        ("pallas", "triples_finale_spatial")):
        info = {}
        with phase(f"dimer_{tier}_tier", info):
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.perf_counter()
            ttr = TS.do_ccsd_t_spatial(res.sys, res.cc, res.cfg, res.hf.levels,
                                       Reporter(stream=io.StringIO()), precision=tier)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tier_launches[kname] = kernels[kname].launches
            check(tier_launches[kname] > 0, f"{kname} not launched on the dimer {tier} tier")
            check(ttr.precision_used == tier, f"dimer {tier} tier ran {ttr.precision_used}")
            err = max(abs(getattr(ttr, k) - getattr(tr, k)) for k in want["triples"])
            check(err <= DIMER_TIER_TOL, f"dimer {tier} tier off the K3 path by {err:.3e}")
            info.update(wall_s=f"{wall:.3f}", max_abs_vs_fused=f"{err:.3e}",
                        launches=json.dumps({kname: tier_launches[kname]}))
    hybrid_triples_phase(torch, "dimer_spatial", res, text, kernels, cpu=False)
    for name, r in rows.items():
        r["launches"] = tier_launches[name]
    return tier_launches, list(rows.items()), metrics


def path_walls(text: str, cc_label: str, triples_label: str, cc_iterations: int) -> dict:
    """The report's stage walls of a path, and CCSD's per iteration."""
    walls = {"read_in": stage_wall(text, "system initialisation"),
             "rhf": stage_wall(text, "restricted Hartree-Fock"),
             "mp2": stage_wall(text, "restricted MP2"),
             "ccsd": stage_wall(text, cc_label),
             "triples": stage_wall(text, triples_label)}
    walls["ccsd_per_iteration"] = walls["ccsd"] / cc_iterations
    return {k: round(v, 4) for k, v in walls.items()}


def spinorb_dimer_phases(torch, dev, kernels: dict, wd: Path) -> tuple[dict, list]:
    """The 116-bf water dimer as CCSD(T)_spinorb (20 occupied and 212
    virtual spin orbitals) through run_calculation on the card, on the
    dimer's inputs in `wd` (written by dimer_phases) and the committed
    els.in with that calc_type at ccsd_precision "f64".  The vvvv slice
    must be held as its spin blocks by the 4e9-byte rule; every
    breakdown value within ENERGY_TOL of the JAX package's CPU run
    (expected_jax_cpu_ccsd_t_spinorb.json), E(T) within ENERGY_TOL of
    JAX's f64 tier there, equal SCF and CC iteration counts; K1 once
    and no other kernel.  CCSD corr and E(T) against the restricted
    dimer reference are printed, not gated.  Then K1 on the path's
    amplitudes, held and timed, and the "pallas" tier (panels + K2) on
    the same amplitudes, within TRIPLES_TOL of K1's E(T), with K2's row
    on its first chunk.  Returns K1's and K2's launches, their rows and
    the path's metrics (cc_metrics)."""
    import io

    from afesp_tpu_torch.io import fastparse
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import ccsd_spinorb as CS
    from afesp_tpu_torch.methods.triples_spinorb import do_ccsd_t_spinorb
    from afesp_tpu_torch.ops.spin import spinorb_levels

    want = json.loads(SPINORB_DIMER_EXPECTED.read_text())
    spatial = json.loads(DIMER_EXPECTED.read_text())
    els = els_at(DIMER, "f64", spinorb=True)
    check(els == want["els_in"], "the staged els.in differs from the spin-orbital reference's")
    (wd / "els.in").write_text(els)

    info = {}
    with phase("spinorb_dimer_path", info):
        fastparse.ROUTES.clear()
        held_before = torch.cuda.memory_allocated()
        res, text, wall, peak, launches = run_path(torch, wd, kernels)
        routes = scanner_routes_check(fastparse, "spin-orbital dimer path", 3)
        check(res.cc.precision_used == "f64", f"spin-orbital dimer CCSD ran {res.cc.precision_used}")
        sl = res.cc.slices
        check(CS._BLOCK_VVVV_BYTES == 4e9, f"_BLOCK_VVVV_BYTES is {CS._BLOCK_VVVV_BYTES!r}")
        check(res.sys.nvirt**4 * 8 > CS._BLOCK_VVVV_BYTES,
              f"nvirt {res.sys.nvirt}: the dense vvvv is within the byte rule")
        check(sl.vvvv is None and sl.vvvv_blocks is not None,
              "the spin-orbital dimer held its vvvv dense")
        check(launches["triples_fused"] == 1,
              f"K1 launched {launches['triples_fused']} times on the spin-orbital dimer path")
        others = {n: c for n, c in launches.items() if n != "triples_fused" and c}
        check(not others, f"other kernels launched on the spin-orbital dimer path: {others}")
        metrics = cc_metrics(text, res, wall, peak)
        ONE_DEVICE["spinorb_dimer_path"] = result_values(res, launches)
        e_t = res.e_ccsd_t - res.e_ccsd
        errs = {label: abs(val - want["breakdown_values"][label])
                for label, val in printed_values(text, want["breakdown"]).items()}
        check(len(errs) == len(want["breakdown_values"]),
              "the spin-orbital dimer breakdown lacks a line of the reference's")
        errs["E(T) vs JAX f64 tier"] = abs(e_t - want["spinorb_triples"]["e_t_f64"])
        for key, err in errs.items():
            check(err <= ENERGY_TOL, f"spin-orbital dimer {key}: off the JAX value by {err:.3e}")
        check(res.hf.iterations == want["scf_iterations"],
              f"spin-orbital dimer SCF iterations {res.hf.iterations} vs JAX "
              f"{want['scf_iterations']}")
        check(res.cc.iterations == want["cc_iterations"],
              f"spin-orbital dimer CC iterations {res.cc.iterations} vs JAX "
              f"{want['cc_iterations']}")
        cross = {"ccsd_corr": res.e_ccsd - spatial["e_ccsd_corr"],
                 "e_t": e_t - (spatial["triples"]["e_ccsd_tt"] - spatial["e_ccsd_corr"])}
        info.update(wall_s=f"{wall:.3f}", launches=json.dumps(launches),
                    cc_iter_ms=metrics["cc_iter_ms"], ccsd_tflops=metrics["ccsd_tflops"],
                    max_abs_err=f"{max(errs.values()):.3e}", e_t=repr(e_t),
                    scf_iterations=res.hf.iterations, cc_iterations=res.cc.iterations,
                    walls_s=json.dumps(path_walls(text, "unrestricted CCSD:",
                                                  "unrestricted CCSD(T)", res.cc.iterations)),
                    vvvv_blocks_gb=f"{sum(b.numel() for b in sl.vvvv_blocks) * 8 / 1e9:.3f}",
                    peak_memory_gb=f"{peak / 1e9:.3f}",
                    held_before_gb=f"{held_before / 1e9:.3f}",
                    vs_spatial_dimer_not_gated=json.dumps({k: f"{v:.3e}" for k, v in cross.items()}),
                    routes=json.dumps(routes))
    for line in text.splitlines():
        if line.lstrip().startswith("Time taken for"):
            print(f"  {line.strip()}", flush=True)

    nocc = res.sys.nocc
    lv = spinorb_levels(torch.as_tensor(res.hf.levels, dtype=torch.float64, device=dev),
                        nocc // 2)
    args = (res.cc.t1, res.cc.t2, sl.vovv, sl.ovoo, sl.oovv, lv[:nocc], lv[nocc:])
    info = {}
    with phase("spinorb_dimer_kernels", info):
        k1 = k1_dimer_check(torch, dev, o=nocc, v=res.sys.nvirt, args=args,
                            label=", spin-orbital dimer path's amplitudes")
        info.update(triples_fused=json.dumps(k1))
    info = {}
    with phase("spinorb_dimer_pallas_tier", info):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        e_pallas = do_ccsd_t_spinorb(res.sys, res.cc, res.cfg, res.hf.levels,
                                     Reporter(stream=io.StringIO()), precision="pallas")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pallas_launches = {n: fn.launches for n, fn in kernels.items()}
        check(pallas_launches["triples_finale"] > 0,
              "triples_finale not launched on the spin-orbital dimer's pallas tier")
        diff = (e_pallas - res.e_ccsd) - e_t
        check(abs(diff) <= TRIPLES_TOL, f"spin-orbital dimer E(T) pallas off K1's by {diff:.3e}")
        k2 = k2_row(torch, dev, args, nocc, res.sys.nvirt,
                    ", spin-orbital dimer path's amplitudes")
        g, w = float(k2["got"]), float(k2["want"])
        k2.update(max_abs_err=abs(g - w), max_rel_err=abs(g - w) / max(abs(w), 1e-300))
        check(k2["max_rel_err"] <= KERNEL_RTOL,
              f"triples_finale (dimer): kernel {g!r} vs plain {w!r}")
        info.update(wall_s=f"{wall:.3f}", e_t_pallas_minus_k1=f"{diff:.3e}",
                    launches=json.dumps(pallas_launches),
                    triples_finale=json.dumps({k: v for k, v in k2.items()
                                               if k not in ("got", "want")}))
    hybrid_triples_phase(torch, "dimer_spinorb", res, text, kernels, cpu=False)
    k1.update(source=K1_SOURCE, replaces=K1_REPLACES, launches=launches["triples_fused"])
    k2["launches"] = pallas_launches["triples_finale"]
    return ({"triples_fused": k1["launches"], "triples_finale": k2["launches"]},
            [("triples_fused", k1), ("triples_finale", k2)], metrics)


def trimer_phases(torch, dev, kernels: dict) -> tuple[int, list]:
    """The 174-bf water trimer, CRCCSD(T)_spatial, end to end on the
    card: the engine computes its one-electron integrals (held against
    the committed s/t/v.dat) and writes its ERIs, packed, as eri.npy in
    a temporary directory beside copies of the committed s/t/v.dat and
    geom.dat and the committed els.in at "f64" (K4 at nvirt 159);
    run_calculation there.  The gate is the JAX package's f64 CPU run
    (expected_jax_cpu_crccsd_t_spatial.json: the ERIs within ERI_TOL of
    its sample, every breakdown value within ENERGY_TOL, equal SCF and CC
    iteration counts), with HF and MP2 cross-checked against oracle.json
    as for the dimer.  K4 once and no other kernel; then K4 on the path's
    own amplitudes, held and timed; then the committed els.in as written
    ("hybrid", trimer_hybrid_path), and on the streaming-slices tier
    (trimer_stream_path).  Returns K4's launches, its rows and the three
    paths' metrics."""
    import numpy as np

    from afesp_tpu_torch.integrals import engine as E
    from afesp_tpu_torch.io import dat, fastparse
    from afesp_tpu_torch.methods import triples_spatial as TS

    want = json.loads(TRIMER_EXPECTED.read_text())
    oracle = json.loads((TRIMER / "oracle.json").read_text())
    wd = Path(tempfile.mkdtemp(prefix="afesp_chip_trimer_"))
    try:
        info = {}
        with phase("trimer_integrals", info):
            _, charges, coords = dat.read_geometry(TRIMER / "geom.dat")
            basis = E.build_basis(charges, coords, DIMER_BASIS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mats = {"s.dat": E.overlap(basis, dev), "t.dat": E.kinetic(basis, dev),
                    "v.dat": E.nuclear(basis, charges, coords, dev)}
            torch.cuda.synchronize()
            wall_1e = time.perf_counter() - t0
            t0 = time.perf_counter()
            packed = E.eri_packed(basis, dev)
            torch.cuda.synchronize()
            wall_eri = time.perf_counter() - t0
            np.save(wd / "eri.npy", packed.cpu().numpy())
            sampled = eri_sample_error(torch, packed, want["eri_sample"])
            del packed
            rels = {}
            for name, M in mats.items():
                ref = torch.as_tensor(dat.read_dat_matrix(TRIMER / name, basis.nbf))
                rels[name] = float(((M.cpu() - ref).abs() / ref.abs().clamp(min=1.0)).max())
                check(rels[name] <= DAT_RTOL,
                      f"trimer {name}: engine off the committed file by {rels[name]:.3e}")
            for f in ("s.dat", "t.dat", "v.dat", "geom.dat"):
                shutil.copy(TRIMER / f, wd / f)
            (wd / "els.in").write_text(els_at(TRIMER, "f64"))
            check((wd / "els.in").read_text() == want["els_in"],
                  "the staged trimer els.in differs from the f64 reference's")
            info.update(nbasis=basis.nbf, wall_1e_s=f"{wall_1e:.3f}",
                        wall_eri_s=f"{wall_eri:.3f}", vs_jax_sample=json.dumps(sampled),
                        dat_rel_err=json.dumps({k: f"{v:.3e}" for k, v in rels.items()}))

        info = {}
        with phase("trimer_path", info):
            fastparse.ROUTES.clear()
            held_before = torch.cuda.memory_allocated()
            res, text, wall, peak, launches = run_path(torch, wd, kernels)
            routes = scanner_routes_check(fastparse, "trimer path", 3)
            check(res.cc.precision_used == "f64", f"trimer CCSD ran {res.cc.precision_used}")
            tr = res.triples
            check(tr.precision_used == "tiled", f"trimer triples tier {tr.precision_used}")
            check(launches["triples_tiled_spatial"] == 1,
                  f"K4 launched {launches['triples_tiled_spatial']} times on the trimer path")
            others = {n: c for n, c in launches.items() if n != "triples_tiled_spatial" and c}
            check(not others, f"other kernels launched on the trimer path: {others}")
            e0 = res.e_hf + res.e_nuc
            got = {"e_hf_total": e0, "e_mp2_corr": res.e_mp2, "e_ccsd_corr": res.e_ccsd,
                   "t1_diagnostic": res.t1_diagnostic}
            got.update({k: getattr(tr, k) for k in want["triples"]})
            ref = {k: want[k] for k in ("e_hf_total", "e_mp2_corr", "e_ccsd_corr",
                                        "t1_diagnostic")} | want["triples"]
            errs = {k: abs(got[k] - ref[k]) for k in ref}
            for label, val in printed_values(text, want["breakdown"]).items():
                errs[label] = abs(val - want["breakdown_values"][label])
            check(len(errs) == len(ref) + len(want["breakdown_values"]),
                  "the trimer breakdown lacks a line of the reference's")
            for key, err in errs.items():
                check(err <= ENERGY_TOL, f"trimer {key}: off the JAX value by {err:.3e}")
            check(res.hf.iterations == want["scf_iterations"],
                  f"trimer SCF iterations {res.hf.iterations} vs JAX {want['scf_iterations']}")
            check(res.cc.iterations == want["cc_iterations"],
                  f"trimer CC iterations {res.cc.iterations} vs JAX {want['cc_iterations']}")
            oracle_err = {"e_hf_total": abs(e0 - oracle["e_hf_total"]),
                          "e_mp2_corr": abs(res.e_mp2 - oracle["e_mp2_corr"])}
            for key, err in oracle_err.items():
                check(err <= ENERGY_TOL, f"trimer {key}: off oracle.json by {err:.3e}")
            metrics = cc_metrics(text, res, wall, peak)
            info.update(wall_s=f"{wall:.3f}", launches=json.dumps(launches),
                        cc_iter_ms=metrics["cc_iter_ms"], ccsd_tflops=metrics["ccsd_tflops"],
                        max_abs_err=f"{max(errs.values()):.3e}",
                        scf_iterations=res.hf.iterations, cc_iterations=res.cc.iterations,
                        oracle_err=json.dumps({k: f"{v:.3e}" for k, v in oracle_err.items()}),
                        walls_s=json.dumps(path_walls(
                            text, "restricted CCSD:", "restricted completely renormalised",
                            res.cc.iterations)),
                        peak_memory_gb=f"{peak / 1e9:.3f}",
                        held_before_gb=f"{held_before / 1e9:.3f}",
                        routes=json.dumps(routes))
        lines = text.splitlines()
        start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
        for line in [ln for ln in lines if ln.lstrip().startswith("Time taken for")] + \
                lines[start - 1 : start - 1 + len(want["breakdown"])]:
            print(f"  {line.rstrip()}", flush=True)

        info = {}
        with phase("trimer_kernels", info):
            cfg, cc, nocc = res.cfg, res.cc, res.sys.nocc
            lv = torch.as_tensor(res.hf.levels, dtype=torch.float64, device=dev)
            Iv, Jo = TS.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, cc.slices, nocc)
            v = cc.slices
            args = (cc.t1, cc.t2, v.v_vvov, v.v_oovo, v.v_oovv, lv[:nocc],
                    lv[nocc : nocc + res.sys.nvirt], Iv, Jo)
            flags = dict(doing_T=cfg.ccsd_t_paren, doing_R=cfg.ccsd_t_renorm,
                         doing_CR=cfg.ccsd_t_comp_renorm)
            rows = spatial_kernel_checks(torch, dev, o=nocc, v=res.sys.nvirt, args=args,
                                         flags=flags, label=", trimer path's amplitudes")
            check(list(rows) == ["triples_tiled_spatial"], f"trimer kernel rows {list(rows)}")
            info.update({n: json.dumps(r) for n, r in rows.items()})
        rows["triples_tiled_spatial"]["launches"] = launches["triples_tiled_spatial"]
        mesh_trimer_k4(torch, args, flags, nocc, dev)
        del res, cc, v, args, Iv, Jo
        torch.cuda.empty_cache()
        # the committed els.in as written: the digit-GEMM CCSD
        shutil.copy(TRIMER / "els.in", wd / "els.in")
        hybrid = hybrid_path(torch, "trimer_hybrid_path", wd, kernels, "triples_tiled_spatial",
                             metrics)
        # the same inputs (the engine's eri.npy, the committed els.in) on
        # the streaming-slices tier
        stream, stream_rows = stream_path(torch, "trimer_stream_path", wd, kernels,
                                          "triples_tiled_spatial", "trimer_hybrid_path",
                                          hybrid, dev)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return launches["triples_tiled_spatial"], list(rows.items()) + stream_rows, {
        "trimer_path": metrics, "trimer_hybrid_path": hybrid, "trimer_stream_path": stream}


def cc_metrics(text: str, res, wall: float, peak: int) -> dict:
    """A path's wall, CC iterations, CC iteration ms (the report's CCSD
    stage over its iterations, the hybrid constants' digitizing
    included), CCSD TFLOP/s (flops.py's count for the arithmetic that
    ran, over that time) and peak card memory."""
    from afesp_tpu_torch import flops

    cc = res.cc
    o, v = res.sys.nocc, res.sys.nvirt
    restricted = res.cfg.restricted
    ccsd_s = stage_wall(text, "restricted CCSD:" if restricted else "unrestricted CCSD:")
    count = (flops.spatial_ccsd_iteration_flops(o, v, cc.precision_used) if restricted
             else flops.spinorb_ccsd_iteration_flops(o, v, cc.precision_used))
    per_it = ccsd_s / cc.iterations
    return {"wall_s": round(wall, 4), "ccsd_s": ccsd_s, "cc_iterations": cc.iterations,
            "cc_iter_ms": round(1e3 * per_it, 3),
            "ccsd_tflops": round(count / per_it / 1e12, 4),
            "flops_per_iteration": count, "precision_used": cc.precision_used,
            "peak_memory_gb": round(peak / 1e9, 3)}


def run_path(torch, wd: Path, kernels: dict):
    """run_calculation on `wd` with every kernel count and the digit
    pair GEMMs' count set to 0 just before and read just after, the peak
    card memory reset before.  Returns (res, report text, wall, peak,
    launches)."""
    import io

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.ops import exact_gemm as EG

    for fn in kernels.values():
        fn.launches = 0
    EG.digit_pair_gemm.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    res = run_calculation(wd, Reporter(stream=buf))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {n: fn.launches for n, fn in kernels.items()}
    launches["digit_pair_gemm"] = EG.digit_pair_gemm.launches
    return res, buf.getvalue(), wall, peak, launches


def hybrid_path(torch, name: str, wd: Path, kernels: dict, kernel: str, f64: dict) -> dict:
    """One hybrid path: run_calculation on `wd`, whose els.in must equal
    the JAX package's hybrid reference's, on the card.  The CCSD must run
    the digit GEMMs (precision_used "hybrid", digit-pair GEMMs launched,
    no extra report line); every breakdown value within ENERGY_TOL of
    the reference, CCSD correlation within HYBRID_CCSD_TOL, equal SCF
    and CC iteration counts, the triples within HYBRID_TRIPLES_TOL of
    JAX's f64 triples on its hybrid amplitudes, `kernel` launched once
    and no other kernel.  A restricted path runs the f32 CR chain: the
    two values it feeds (CR_KEYS) are held within CR_F32_TOL, and the
    same tier with the f64 chain on the same amplitudes within
    HYBRID_TRIPLES_TOL on all eight, both sets of gaps printed.  Prints
    the path's metrics beside `f64`, those of the f64 path at the same
    input.  Returns the metrics."""
    import dataclasses
    import io

    from afesp_tpu_torch.io import fastparse
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial

    want = json.loads(HYBRID_EXPECTED[name].read_text())
    check((wd / "els.in").read_text() == want["els_in"],
          f"{name}: the staged els.in differs from the hybrid reference's")
    info = {}
    with phase(name, info):
        fastparse.ROUTES.clear()
        res, text, wall, peak, launches = run_path(torch, wd, kernels)
        routes = scanner_routes_check(fastparse, name, 3)
        check(res.cc.precision_used == "hybrid",
              f"{name}: the CCSD ran {res.cc.precision_used}, not the digit GEMMs")
        check(launches["digit_pair_gemm"] > 0, f"{name}: no digit-pair GEMM launched")
        check("CCSD arithmetic" not in text, f"{name}: the report has a line JAX's has not")
        errs = {label: abs(val - want["breakdown_values"][label])
                for label, val in printed_values(text, want["breakdown"]).items()}
        check(len(errs) == len(want["breakdown_values"]),
              f"{name}: the breakdown lacks a line of the reference's")
        for key, err in errs.items():
            check(err <= ENERGY_TOL, f"{name} {key}: off the JAX hybrid value by {err:.3e}")
        ccsd_err = abs(res.e_ccsd - want["e_ccsd_corr"])
        check(ccsd_err <= HYBRID_CCSD_TOL,
              f"{name}: CCSD corr {res.e_ccsd!r} vs JAX hybrid {want['e_ccsd_corr']!r}")
        check(res.hf.iterations == want["scf_iterations"],
              f"{name}: SCF iterations {res.hf.iterations} vs JAX {want['scf_iterations']}")
        check(res.cc.iterations == want["cc_iterations"],
              f"{name}: CC iterations {res.cc.iterations} vs JAX {want['cc_iterations']}")
        chain_errs = None
        if res.cfg.restricted:
            check(res.triples.cr_precision == "f32",
                  f"{name}: the CR intermediates ran {res.triples.cr_precision}, not f32")
            t_errs = {k: abs(getattr(res.triples, k) - w) for k, w in want["triples"].items()}
            # the same tier on the same amplitudes with the f64 chain (the
            # arithmetic of this phase before the f32 chain was ported)
            cfg64 = dataclasses.replace(res.cfg, ccsd_precision="f64")
            tr64 = do_ccsd_t_spatial(res.sys, res.cc, cfg64, res.hf.levels,
                                     Reporter(stream=io.StringIO()),
                                     precision=res.triples.precision_used)
            check(tr64.cr_precision == "f64", f"{name}: the f64-chain rerun ran {tr64.cr_precision}")
            chain_errs = {k: abs(getattr(tr64, k) - w) for k, w in want["triples"].items()}
            for key, err in chain_errs.items():
                check(err <= HYBRID_TRIPLES_TOL,
                      f"{name} {key}: the f64 chain off JAX's f64 triples by {err:.3e}")
        else:
            t_errs = {"e_t": abs(res.e_ccsd_t - res.e_ccsd - want["spinorb_triples"]["e_t_f64"])}
        for key, err in t_errs.items():
            tol = CR_F32_TOL if chain_errs is not None and key in CR_KEYS else HYBRID_TRIPLES_TOL
            check(err <= tol,
                  f"{name} {key}: off JAX's f64 triples on its hybrid amplitudes by {err:.3e}")
        check(launches[kernel] == 1, f"{name}: {kernel} launched {launches[kernel]} times")
        others = {n: c for n, c in launches.items()
                  if n not in (kernel, "digit_pair_gemm") and c}
        check(not others, f"{name}: other kernels launched: {others}")
        metrics = cc_metrics(text, res, wall, peak)
        PATH_TEXT[name] = text
        ONE_DEVICE[name] = result_values(res, launches)
        if res.cfg.restricted:
            PATH_VALUES[name] = {"e_mp2": res.e_mp2, "e_ccsd": res.e_ccsd} | {
                k: getattr(res.triples, k) for k in SIX_TRIPLES + ("D_T", "D_TT")}
        info.update(**{k: metrics[k] for k in ("wall_s", "cc_iterations", "cc_iter_ms",
                                               "ccsd_tflops", "peak_memory_gb")},
                    f64_path=json.dumps({k: f64[k] for k in ("wall_s", "cc_iterations",
                                                             "cc_iter_ms", "ccsd_tflops",
                                                             "peak_memory_gb")}),
                    launches=json.dumps(launches),
                    max_abs_err_breakdown=f"{max(errs.values()):.3e}",
                    ccsd_corr_err=f"{ccsd_err:.3e}",
                    triples_err=json.dumps({k: f"{v:.3e}" for k, v in t_errs.items()}),
                    scf_iterations=res.hf.iterations, routes=json.dumps(routes))
        if chain_errs is not None:
            info.update(cr_precision=res.triples.cr_precision,
                        triples_err_f64_chain=json.dumps({k: f"{v:.3e}"
                                                          for k, v in chain_errs.items()}))
    for line in text.splitlines():
        if line.lstrip().startswith("Time taken for"):
            print(f"  {line.strip()}", flush=True)
    return metrics


def on_cpu(x):
    """`x` (a stage result, its slices, a tuple or a tensor) with every
    tensor copied to the CPU."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return tuple(on_cpu(y) for y in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: on_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


def hybrid_triples_phase(torch, label: str, res, text: str, kernels: dict,
                         cpu: bool) -> None:
    """The f32 "hybrid" (T) tier on a path's converged amplitudes
    (`res`, from the f64 kernel tier the path ran): do_ccsd_t_spinorb or
    do_ccsd_t_spatial at precision "hybrid" on the card, E(T) (or the six
    energies, D[T] and D(T)) within HYBRID_VS_KERNEL_TOL of the path's
    kernel tier, no kernel launched; with `cpu` the same on the
    amplitudes copied to the CPU, within HYBRID_VS_CPU_TOL of the card.
    f32 must mean f32: TF32 matmuls fail the phase.  Prints each tier's
    wall beside the kernel tier's (the path's stage wall)."""
    import io

    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial
    from afesp_tpu_torch.methods.triples_spinorb import do_ccsd_t_spinorb

    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}")
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmuls are allowed")
    restricted = res.cfg.restricted

    def hybrid(cc):
        t0 = time.perf_counter()
        rep = Reporter(stream=io.StringIO())
        if restricted:
            tr = do_ccsd_t_spatial(res.sys, cc, res.cfg, res.hf.levels, rep, precision="hybrid")
            check(tr.precision_used == "hybrid", f"{label}: the tier ran {tr.precision_used}")
            vals = {k: getattr(tr, k) for k in SIX_TRIPLES + ("D_T", "D_TT")}
        else:
            vals = {"e_t": do_ccsd_t_spinorb(res.sys, cc, res.cfg, res.hf.levels, rep,
                                             precision="hybrid") - res.e_ccsd}
        if cc.t1.device.type == "cuda":
            torch.cuda.synchronize()
        return vals, time.perf_counter() - t0

    if restricted:
        kernel_vals = {k: getattr(res.triples, k) for k in SIX_TRIPLES + ("D_T", "D_TT")}
        kernel_label = "restricted completely renormalised"
    else:
        kernel_vals = {"e_t": res.e_ccsd_t - res.e_ccsd}
        kernel_label = "unrestricted CCSD(T)"
    info = {}
    with phase(f"hybrid_triples_{label}", info):
        for fn in kernels.values():
            fn.launches = 0
        card, wall = hybrid(res.cc)
        launched = {n: fn.launches for n, fn in kernels.items() if fn.launches}
        check(not launched, f"{label}: the hybrid tier launched kernels: {launched}")
        vs_kernel = {k: abs(card[k] - kernel_vals[k]) for k in card}
        for key, err in vs_kernel.items():
            check(err <= HYBRID_VS_KERNEL_TOL,
                  f"{label} {key}: hybrid off the kernel tier by {err:.3e}")
        info.update(wall_s=f"{wall:.3f}", kernel_tier_wall_s=stage_wall(text, kernel_label),
                    vs_kernel_tier=json.dumps({k: f"{v:.3e}" for k, v in vs_kernel.items()}))
        if cpu:
            host, cpu_wall = hybrid(on_cpu(res.cc))
            vs_cpu = {k: abs(card[k] - host[k]) for k in card}
            for key, err in vs_cpu.items():
                check(err <= HYBRID_VS_CPU_TOL, f"{label} {key}: card off the CPU by {err:.3e}")
            info.update(cpu_wall_s=f"{cpu_wall:.3f}",
                        vs_cpu_hybrid=json.dumps({k: f"{v:.3e}" for k, v in vs_cpu.items()}))
        info["values"] = json.dumps({k: repr(v) for k, v in card.items()})


# run in a fresh process by compile_ahead_phase: argv = repo, workdir, build
# directory.  The kernels' build directory is the empty one given; every
# build is recorded with what it compiled.
COLD_RUN = r"""
import io, json, sys, time
from pathlib import Path
sys.dont_write_bytecode = True
repo, wd, build_dir = sys.argv[1:4]
sys.path.insert(0, repo)
import torch
from afesp_tpu_torch import cachemeta, warmup
from afesp_tpu_torch.ops import _build
_build.BUILD_DIR = Path(build_dir)
calls = []
inner = _build.build
def counted(names):
    out = inner(names)
    calls.append({"names": list(names), "compiled": sorted(out),
                  "seconds": {n: b["seconds"] for n, b in out.items()}})
    return out
_build.build = counted
from afesp_tpu_torch.driver import run_calculation
from afesp_tpu_torch.io.report import Reporter
torch.zeros(1, device="cuda").sum().item()
buf = io.StringIO()
t0 = time.perf_counter()
res = run_calculation(wd, Reporter(stream=buf))
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(json.dumps({"wall_s": wall, "report": buf.getvalue(), "calls": calls,
                  "warmup": warmup.stats(), "fingerprint_ok": cachemeta.check(build_dir),
                  "fingerprint": cachemeta.read_fingerprint(build_dir),
                  "libraries": sorted(p.name for p in Path(build_dir).glob("*.so")),
                  "values": [res.total_energy, res.e_ccsd] + [
                      getattr(res.triples, k) for k in ("e_crccsd_t", "e_crccsd_tt")]}))
"""


def compile_ahead_phase(torch, wd: Path, warm: dict) -> None:
    """The dimer's hybrid CRCCSD(T)_spatial (the committed els.in in
    `wd`) in a fresh process whose kernel build directory
    (`_build.BUILD_DIR`) is a new empty one, so the compile-ahead build
    (`warmup.py`) compiles K3 while RHF, MP2 and CCSD run.  Gates: the
    breakdown is the warm run's (dimer_hybrid_path, `warm`) bit for bit,
    each library was compiled once, and the build directory's
    fingerprint check passes.  Prints the build's seconds, the seconds
    the triples stage's load waited, and the cold path's wall and RHF
    wall beside the warm run's."""
    info = {}
    build_dir = Path(tempfile.mkdtemp(prefix="afesp_chip_build_"))
    try:
        with phase("compile_ahead", info):
            torch.cuda.empty_cache()
            proc = subprocess.run([sys.executable, "-c", COLD_RUN, str(REPO), str(wd),
                                   str(build_dir)],
                                  capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0, f"the cold run failed:\n{proc.stderr[-4000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            text, warm_text = out["report"], PATH_TEXT["dimer_hybrid_path"]
            block = breakdown_lines(text)
            check(block == breakdown_lines(warm_text) and len(block) > 20,
                  "the cold run's breakdown differs from the warm run's")
            warm_vals = ONE_DEVICE["dimer_hybrid_path"]
            value_diff = max(abs(a - b) for a, b in zip(out["values"], [
                warm_vals[k] for k in ("total_energy", "e_ccsd", "e_crccsd_t", "e_crccsd_tt")]))
            compiled = [n for c in out["calls"] for n in c["compiled"]]
            check(compiled == ["triples_fused_spatial"],
                  f"the cold run compiled {compiled}, not K3 once")
            check(out["warmup"].get("built") == ["triples_fused_spatial"],
                  f"the compile-ahead thread built {out['warmup'].get('built')}")
            check(out["fingerprint_ok"] and len(out["fingerprint"]) == 1,
                  f"the build directory's fingerprint: {out['fingerprint']}")
            check(len(out["libraries"]) == 1
                  and out["libraries"][0].startswith("libtriples_fused_spatial-"),
                  f"the build directory holds {out['libraries']}")
            info.update(build_s=f"{out['warmup']['build_s']:.3f}",
                        load_waited_s=f"{out['warmup']['waited_s']:.3f}",
                        hidden_s=f"{out['warmup']['build_s'] - out['warmup']['waited_s']:.3f}",
                        cold_wall_s=f"{out['wall_s']:.3f}", warm_wall_s=warm["wall_s"],
                        cold_rhf_s=stage_wall(text, "restricted Hartree-Fock"),
                        warm_rhf_s=stage_wall(warm_text, "restricted Hartree-Fock"),
                        cold_triples_s=stage_wall(text, "restricted completely renormalised"),
                        warm_triples_s=stage_wall(warm_text,
                                                  "restricted completely renormalised"),
                        max_abs_value_diff_vs_warm=f"{value_diff:.3e}",
                        builds=json.dumps(out["calls"]),
                        fingerprint=json.dumps(out["fingerprint"][0]))
    finally:
        shutil.rmtree(build_dir, ignore_errors=True)


GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas")


def trace_split(trace: dict, range_name: str, iterations: int) -> dict:
    """From a Chrome trace of torch.profiler: the window of the CPU range
    `range_name`, and in it the device time of GEMM kernels (a name with
    gemm, cutlass, xmma or cublas in it), of the other kernels, and the
    gaps in which no kernel ran, each in ms over `iterations`."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    window = next(e for e in events if e.get("name") == range_name
                  and e.get("cat") == "user_annotation")
    t0, t1 = window["ts"], window["ts"] + window["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel" and t0 <= e["ts"] < t1]
    gemm = sum(e["dur"] for e in kernels if any(g in e["name"].lower() for g in GEMM_NAMES))
    other = sum(e["dur"] for e in kernels) - gemm
    busy, end = 0.0, t0
    for e in sorted(kernels, key=lambda e: e["ts"]):
        start, stop = max(e["ts"], end), min(e["ts"] + e["dur"], t1)
        if stop > start:
            busy += stop - start
            end = stop
    per = lambda us: round(us / 1e3 / iterations, 4)
    return {"window_ms": per(t1 - t0), "gemm_ms": per(gemm), "other_kernels_ms": per(other),
            "idle_ms": per(t1 - t0 - busy), "kernels": len(kernels) / iterations}


def profile_phase(torch, kernels: dict, spatial: dict, unprofiled: dict) -> None:
    """The pVTZ restricted path (the f64 els.in of spatial_path) with
    AFESP_TORCH_PROFILE set for this phase alone.  Gates: one Chrome
    trace in the directory, holding a range for each stage section and
    at least one K3 kernel, and the breakdown the unprofiled run's
    (spatial_path) line for line.  Prints the trace's split of one CCSD
    iteration: GEMM kernels, other kernels, and the time no kernel ran."""
    import os

    from afesp_tpu_torch import driver

    trace_dir = Path(tempfile.mkdtemp(prefix="afesp_chip_trace_"))
    wd = stage_workdir(spatial["els_in"])
    info = {}
    try:
        with phase("profile", info):
            os.environ[driver.PROFILE_ENV] = str(trace_dir)
            try:
                res, text, wall, _, launches = run_path(torch, wd, kernels)
            finally:
                del os.environ[driver.PROFILE_ENV]
            traces = list(trace_dir.glob("*.json"))
            check(len(traces) == 1, f"the profile directory holds {traces}")
            trace = json.loads(traces[0].read_text())
            names = {e.get("name") for e in trace["traceEvents"]}
            stages = ("Integral read-in", "Restricted Hartree-Fock", "MP2", "CCSD", "CCSD(T)")
            check(all(s in names for s in stages),
                  f"the trace lacks a stage range: {[s for s in stages if s not in names]}")
            k3 = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"
                  and any(k in e.get("name", "") for k in K3_TRACE_KERNELS)]
            check(len(k3) > 0 and launches["triples_fused_spatial"] == 1,
                  "no K3 kernel in the trace")
            check(breakdown_lines(text) == breakdown_lines(PATH_TEXT["spatial_path"]),
                  "the profiled run's breakdown differs from the unprofiled run's")
            split = trace_split(trace, "CCSD", res.cc.iterations)
            info.update(wall_s=f"{wall:.3f}", unprofiled_wall_s=unprofiled["wall_s"],
                        trace_mb=f"{traces[0].stat().st_size / 1e6:.1f}",
                        k3_kernel_events=len(k3), ccsd_iteration_split=json.dumps(split),
                        cc_iterations=res.cc.iterations)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
        shutil.rmtree(wd, ignore_errors=True)


def stream_pieces_phase(torch, dev) -> None:
    """The streaming tier's pieces on the card against the port's own
    CPU run, bit for bit (every step is an exact digit GEMM or an
    elementwise f64 operation, so nothing may differ), on seeded inputs
    (n=30, nocc=5): the stream Fock consts (digits and scales) and the
    Fock build, whole and as the packed upper triangle in f32; the
    sliced transform with its virtual rows forced into chunks of 5 and
    its stage 1 into passes of two chunks: the five slices, the vvvv
    limbs and their per-chunk scales; and the CR term from those limbs.
    The card's times of each are printed."""
    import numpy as np

    from afesp_tpu_torch.methods import ccsd_spatial as CS
    from afesp_tpu_torch.methods import hf as HF
    from afesp_tpu_torch.methods import mo_slices as MS
    from afesp_tpu_torch.ops.packed_eri import pack_eri

    info = {}
    with phase("stream_pieces", info):
        n, nocc = 30, 5
        nv = n - nocc
        rng = np.random.default_rng(2026)
        e = rng.standard_normal((n,) * 4)
        e = e + e.transpose(1, 0, 2, 3)
        e = e + e.transpose(0, 1, 3, 2)
        e = (e + e.transpose(2, 3, 0, 1)) / 8.0
        packed = pack_eri(torch.from_numpy(e))
        H = rng.standard_normal((n, n))
        H = torch.from_numpy(H + H.T)
        Cc = rng.standard_normal((nocc, n))
        D = torch.from_numpy(Cc.T @ Cc)
        C = torch.from_numpy(rng.standard_normal((n, n)) / np.sqrt(n))
        t1 = torch.from_numpy(0.05 * rng.standard_normal((nocc, nv)))
        tk, tl = (torch.from_numpy(x) for x in np.tril_indices(n))
        iu = tuple(torch.from_numpy(x) for x in np.triu_indices(n))
        pick, group_bytes = MS._pick_chunk, MS._GROUP_BYTES

        def run(d):
            to = lambda x: x.to(d)
            consts = HF._fock_stream_consts(to(packed), to(tk), to(tl), n=n)
            F = HF._fock_build_stream(to(H), to(D), consts, to(tk), to(tl))
            Fp = HF._fock_build_stream(to(H), to(D), consts, to(tk), to(tl),
                                       tuple(map(to, iu)), packed_f32=True)
            MS._pick_chunk = lambda nvirt, n_: 5
            MS._GROUP_BYTES = 2 * 8.0 * n**3 * 5
            try:
                sl, B = MS.ao_to_mo_slices(to(packed), to(C), n=n, nocc=nocc, digit_L=5)
            finally:
                MS._pick_chunk, MS._GROUP_BYTES = pick, group_bytes
            cr = CS._cr_vvvv_term_from_B(to(t1), B, nv=nv)
            return consts, F, Fp, sl, B, cr

        cpu = run(torch.device("cpu"))
        card = run(dev)
        (cJ, cK), cF, cFp, csl, cB, ccr = cpu
        (gJ, gK), gF, gFp, gsl, gB, gcr = card
        same = lambda a, b: bool(torch.equal(a, b.cpu()))
        for what, (cd, cs), (gd, gs) in (("J", cJ, gJ), ("K", cK, gK)):
            check(all(same(a, b) for a, b in zip(cd, gd)) and same(cs, gs),
                  f"stream Fock consts {what}: the card's digits or scales differ from the CPU's")
        check(same(cF, gF) and same(cFp, gFp), "stream Fock build: the card differs from the CPU")
        for f in ("v_oovv", "v_ovov", "v_vvov", "v_oovo", "v_oooo"):
            check(same(getattr(csl, f), getattr(gsl, f)), f"sliced transform {f}: card != CPU")
        check(cB[1].shape[0] == nv // 5 and all(same(a, b) for a, b in zip(cB[0], gB[0]))
              and same(cB[1], gB[1]), "vvvv limbs or scales: the card's differ from the CPU's")
        check(same(ccr, gcr), "CR term from the limbs: the card differs from the CPU")
        consts = (gJ, gK)
        ms = {
            "fock_stream_consts": cuda_ms(torch, lambda: HF._fock_stream_consts(
                packed.to(dev), tk.to(dev), tl.to(dev), n=n), 3),
            "fock_build_stream": cuda_ms(torch, lambda: HF._fock_build_stream(
                H.to(dev), D.to(dev), consts, tk.to(dev), tl.to(dev)), 3),
            "cr_vvvv_term_from_B": cuda_ms(torch, lambda: CS._cr_vvvv_term_from_B(
                t1.to(dev), gB, nv=nv), 3),
        }
        info.update(bitwise="fock_consts,fock_build,slices,vvvv_limbs,cr_term",
                    limb_chunks=int(cB[1].shape[0]),
                    card_ms=json.dumps({k: round(v, 4) for k, v in ms.items()}))


def stream_path(torch, name: str, wd: Path, kernels: dict, kernel: str, dense: str,
                dense_metrics: dict, dev) -> tuple[dict, list]:
    """One path of the streaming-slices tier: run_calculation on `wd`
    (the committed els.in as written) with AFESP_FORCE_STREAM=1 set for
    this phase alone.  The CCSD must have run the tier (no dense MO
    tensor, v_vvvv as limbs, the CR term from them), the device SCF
    prelude must have run; every breakdown value within ENERGY_TOL of
    the JAX stream run, equal SCF, prelude and CC iteration counts, MP2,
    CCSD and the six triples within STREAM_TOL of it; against the port's
    dense hybrid run of the same input (`dense`) within
    STREAM_VS_DENSE_TOL, its metrics printed beside `dense_metrics`;
    `kernel` launched once and no other kernel.  Then `kernel` on the
    path's amplitudes, held and timed.  Returns the path's metrics and
    its kernel row."""
    import os
    import re

    from afesp_tpu_torch.io import fastparse
    from afesp_tpu_torch.methods import triples_spatial as TS

    want = json.loads(STREAM_EXPECTED[name].read_text())
    check((wd / "els.in").read_text() == want["els_in"],
          f"{name}: the staged els.in differs from the reference's")
    torch.cuda.empty_cache()
    info = {}
    with phase(name, info):
        old = os.environ.get("AFESP_FORCE_STREAM")
        os.environ["AFESP_FORCE_STREAM"] = "1"
        try:
            fastparse.ROUTES.clear()
            res, text, wall, peak, launches = run_path(torch, wd, kernels)
        finally:
            if old is None:
                os.environ.pop("AFESP_FORCE_STREAM", None)
            else:
                os.environ["AFESP_FORCE_STREAM"] = old
        routes = scanner_routes_check(fastparse, name, 3)
        cc, tr = res.cc, res.triples
        check(cc.precision_used == "hybrid" and cc.slices.v_vvvv is None
              and cc.cr_vvvv_term is not None, f"{name}: the CCSD did not run the stream tier")
        prelude = re.search(r"Device SCF prelude: (\d+) iterations", text)
        check(prelude is not None, f"{name}: no device SCF prelude ran")
        prelude = int(prelude.group(1))
        got = {"e_mp2": res.e_mp2, "e_ccsd": res.e_ccsd} | {
            k: getattr(tr, k) for k in SIX_TRIPLES + ("D_T", "D_TT")}
        tol = {"e_mp2": STREAM_VS_DENSE_TOL["e_mp2"], "e_ccsd": STREAM_VS_DENSE_TOL["e_ccsd"],
               "D_T": STREAM_VS_DENSE_TOL["D"], "D_TT": STREAM_VS_DENSE_TOL["D"]}
        tol |= {k: STREAM_VS_DENSE_TOL["triples"] for k in SIX_TRIPLES}
        vs_dense = {k: abs(got[k] - PATH_VALUES[dense][k]) for k in tol}
        for k, err in vs_dense.items():
            check(err <= tol[k], f"{name} {k}: off the dense hybrid path by {err:.3e}")
        ref = {"e_mp2": want["e_mp2_corr"], "e_ccsd": want["e_ccsd_corr"]} | want["triples"]
        vs_jax = {k: abs(got[k] - ref[k]) for k in ref}
        for k in ("e_mp2", "e_ccsd") + SIX_TRIPLES:
            check(vs_jax[k] <= STREAM_TOL,
                  f"{name} {k}: off the JAX stream run by {vs_jax[k]:.3e}")
        errs = {label: abs(val - want["breakdown_values"][label])
                for label, val in printed_values(text, want["breakdown"]).items()}
        check(len(errs) == len(want["breakdown_values"]),
              f"{name}: the breakdown lacks a line of the reference's")
        for key, err in errs.items():
            check(err <= ENERGY_TOL, f"{name} {key}: off the JAX stream value by {err:.3e}")
        check(prelude == want["prelude_iterations"],
              f"{name}: prelude iterations {prelude} vs JAX {want['prelude_iterations']}")
        check(res.hf.iterations == want["scf_iterations"],
              f"{name}: SCF iterations {res.hf.iterations} vs JAX {want['scf_iterations']}")
        check(cc.iterations == want["cc_iterations"],
              f"{name}: CC iterations {cc.iterations} vs JAX {want['cc_iterations']}")
        check(launches["digit_pair_gemm"] > 0, f"{name}: no digit-pair GEMM launched")
        check(launches[kernel] == 1, f"{name}: {kernel} launched {launches[kernel]} times")
        others = {n: c for n, c in launches.items()
                  if n not in (kernel, "digit_pair_gemm") and c}
        check(not others, f"{name}: other kernels launched: {others}")
        metrics = cc_metrics(text, res, wall, peak)
        ONE_DEVICE[name] = result_values(res, launches)
        metrics["stage_walls_s"] = path_walls(text, "restricted CCSD:",
                                              "restricted completely renormalised",
                                              cc.iterations)
        metrics["prelude_iterations"] = prelude
        info.update(**{k: metrics[k] for k in ("wall_s", "cc_iterations", "cc_iter_ms",
                                               "peak_memory_gb")},
                    dense_hybrid_path=json.dumps({k: dense_metrics[k] for k in (
                        "wall_s", "cc_iterations", "cc_iter_ms", "peak_memory_gb")}),
                    stage_walls_s=json.dumps(metrics["stage_walls_s"]),
                    scf_iterations=res.hf.iterations, prelude_iterations=prelude,
                    launches=json.dumps(launches),
                    max_abs_err_breakdown=f"{max(errs.values()):.3e}",
                    vs_jax=json.dumps({k: f"{v:.3e}" for k, v in vs_jax.items()}),
                    vs_dense=json.dumps({k: f"{v:.3e}" for k, v in vs_dense.items()}),
                    routes=json.dumps(routes))
    for line in text.splitlines():
        if line.lstrip().startswith("Time taken for") or "Device SCF prelude" in line:
            print(f"  {line.strip()}", flush=True)

    info = {}
    with phase(f"{name}_kernels", info):
        cfg, nocc = res.cfg, res.sys.nocc
        lv = torch.as_tensor(res.hf.levels, dtype=torch.float64, device=dev)
        Iv, Jo = TS.cr_intermediates(cc.t1, cc.t2, cc.t1_prev, cc.t2_prev, cc.slices, nocc,
                                     vvvv_term=cc.cr_vvvv_term)
        v = cc.slices
        args = (cc.t1, cc.t2, v.v_vvov, v.v_oovo, v.v_oovv, lv[:nocc],
                lv[nocc : nocc + res.sys.nvirt], Iv, Jo)
        flags = dict(doing_T=cfg.ccsd_t_paren, doing_R=cfg.ccsd_t_renorm,
                     doing_CR=cfg.ccsd_t_comp_renorm)
        rows = spatial_kernel_checks(torch, dev, o=nocc, v=res.sys.nvirt, args=args,
                                     flags=flags, label=f", {name}'s amplitudes",
                                     names=(kernel,))
        check(list(rows) == [kernel], f"{name} kernel rows {list(rows)}")
        rows[kernel]["launches"] = launches[kernel]
        info.update({n: json.dumps(r) for n, r in rows.items()})
    del res, cc, v, args, Iv, Jo
    torch.cuda.empty_cache()
    return metrics, list(rows.items())


def digit_gemm_phase(torch, dev) -> None:
    """The digit GEMM (ops/exact_gemm) on the card.  At the pVTZ paths'
    shapes, on seeded inputs: exact_gemm and exact_einsum equal the
    port's own CPU result bit for bit on every flat-scale route (direct,
    A_pre, B_pre, both, the int8 recombination) and on both pair routes
    (_int_mm, f32); prechunk_B_chunkscaled through exact_gemm and
    gemm_B_pre_streamed within 1e-14 of scale of the CPU's.  At the
    dimer's vvvv shapes (spatial: v_vvvv (11236, 11236) at L=6/maxdeg=7
    against c_oovv (11236, 100), as the iteration calls it; spin-orbital:
    a tau block (400, 11236) against a vvvv spin block (11236, 11236) at
    L=5/maxdeg=6): the digit GEMM's ms (the constant digitized once, the
    other operand digitized in the call) on each route against
    torch.matmul's f64 ms for the same product, the int8 bound (the
    pair products' ops over the int8 peak, or the bytes over HBM), and
    the error against the f64 product.  Nothing here counts toward a
    path's launches."""
    import numpy as np

    from afesp_tpu_torch.flops import digit_pairs
    from afesp_tpu_torch.ops import exact_gemm as EG

    check(torch.backends.cuda.matmul.allow_tf32 is False, "f32 matmul runs TF32")
    check(torch.get_float32_matmul_precision() == "highest", "f32 matmul precision is not highest")
    rng = np.random.default_rng(20261017)
    info = {}
    with phase("digit_gemm", info):
        # (M, K, N, L, maxdeg): the spin-orbital pVTZ vvvv block
        # (o^2 = 100, (v/2)^2 = 2809) and the restricted one (v_vvvv
        # (2809, 2809) against c_oovv (2809, 25))
        checked = 0
        for M, K, N, L, maxdeg in ((100, 2809, 2809, 5, 6), (2809, 2809, 25, 6, 7)):
            A = torch.as_tensor(rng.standard_normal((M, K)))
            B = torch.as_tensor(rng.standard_normal((K, N)) * 0.05)
            Ad, Bd = A.to(dev), B.to(dev)
            want = EG.exact_gemm(A, B, L=L, maxdeg=maxdeg)
            want8 = EG.exact_gemm(A, B, L=L, maxdeg=maxdeg, digit_dtype=torch.int8)
            for route in EG.ROUTES:
                got = {
                    "direct": EG.exact_gemm(Ad, Bd, L=L, maxdeg=maxdeg, route=route),
                    "A_pre": EG.exact_gemm(B=Bd, A_pre=EG.prechunk_A(Ad, L), maxdeg=maxdeg,
                                           route=route),
                    "B_pre": EG.exact_gemm(A=Ad, B_pre=EG.prechunk_B(Bd, L), maxdeg=maxdeg,
                                           route=route),
                    "both": EG.exact_gemm(A_pre=EG.prechunk_A(Ad, L),
                                          B_pre=EG.prechunk_B(Bd, L), maxdeg=maxdeg,
                                          route=route),
                    "int8_dtype": EG.exact_gemm(Ad, Bd, L=L, maxdeg=maxdeg,
                                                digit_dtype=torch.int8, route=route),
                }
                for key, g in got.items():
                    ref = want8 if key == "int8_dtype" else want
                    check(torch.equal(g.cpu(), ref),
                          f"digit GEMM ({M},{K},{N}) {route} {key}: the card differs from the CPU")
                    checked += 1
        # exact_einsum at call sites of the two pVTZ iterations
        for spec, (o, v), L, maxdeg in (("miea,mbej->ijab", (10, 106), 5, 6),
                                        ("mjae,iemb->ijab", (5, 53), 6, 7),
                                        ("efab,ijef->ijab", (5, 53), 6, 7)):
            ins = spec.split("->")[0].split(",")
            ops = [torch.as_tensor(rng.standard_normal([v if c in "abef" else o for c in t]))
                   for t in ins]
            want = EG.exact_einsum(spec, *ops, L=L, maxdeg=maxdeg)
            got = EG.exact_einsum(spec, *(x.to(dev) for x in ops), L=L, maxdeg=maxdeg)
            check(torch.equal(got.cpu(), want), f"exact_einsum {spec}: the card differs")
            checked += 1
        K, N, M = 2809, 25, 100
        B = torch.as_tensor(rng.standard_normal((K, N)))
        B[K // 3:] *= 1e-6
        A = torch.as_tensor(rng.standard_normal((M, K)))
        Bp, Bpd = EG.prechunk_B_chunkscaled(B, 6), EG.prechunk_B_chunkscaled(B.to(dev), 6)
        want = EG.exact_gemm(A=A, B_pre=Bp, maxdeg=7)
        scale = float(want.abs().max())
        chunk_err = max(float((g.cpu() - want).abs().max()) / scale for g in (
            EG.exact_gemm(A=A.to(dev), B_pre=Bpd, maxdeg=7),
            EG.gemm_B_pre_streamed(A.to(dev), Bpd, maxdeg=7)))
        check(chunk_err <= 1e-14, f"chunk-scaled digit GEMM off the CPU's by {chunk_err:.3e}")
        info.update(bitwise_checks=checked, chunkscaled_rel_err=f"{chunk_err:.3e}")

    # the dimer's vvvv shapes, timed
    for label, (M, K, N, L, maxdeg, const) in {
            "spatial_vvvv": (11236, 11236, 100, 6, 7, "A"),
            "spinorb_vvvv_block": (400, 11236, 11236, 5, 6, "B")}.items():
        info = {}
        with phase(f"digit_gemm_{label}", info):
            A = torch.as_tensor(rng.standard_normal((M, K)), device=dev)
            B = torch.as_tensor(rng.standard_normal((K, N)) * 0.05, device=dev)
            pre = EG.prechunk_A(A, L) if const == "A" else EG.prechunk_B(B, L)
            call = {"A": lambda route: EG.exact_gemm(B=B, A_pre=pre, maxdeg=maxdeg, route=route),
                    "B": lambda route: EG.exact_gemm(A=A, B_pre=pre, maxdeg=maxdeg,
                                                     route=route)}[const]
            ref = A @ B
            ms = {route: cuda_ms(torch, lambda: call(route), reps=3) for route in EG.ROUTES}
            f64_ms = cuda_ms(torch, lambda: A @ B, reps=3)
            err = float((call("int8") - ref).abs().max() / ref.abs().max())
            # the truncation at depth L: ~2^-7L of the row x column scale,
            # summed over K (the CPU tests' bound)
            check(err <= 2.0 ** (10 - 7 * L), f"digit GEMM {label}: off the f64 product by {err:.3e}")
            pairs = digit_pairs(L, maxdeg)
            ops = pairs * 2.0 * M * K * N
            nbytes = L * M * K + K * N * 8 + M * N * 8 if const == "A" else \
                M * K * 8 + L * K * N + M * N * 8
            bound = max(ops / PEAK_INT8_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            info.update(shape=f"({M},{K})x({K},{N})", L=L, maxdeg=maxdeg, pairs=pairs,
                        int8_ms=f"{ms['int8']:.4f}", f32_ms=f"{ms['f32']:.4f}",
                        f64_matmul_ms=f"{f64_ms:.4f}", int8_bound_ms=f"{bound:.4f}",
                        bound_by="operations" if ops / PEAK_INT8_PER_S
                        >= nbytes / HBM_BYTES_PER_S else "bytes",
                        rel_err_vs_f64=f"{err:.3e}")
            del A, B, pre, ref
        torch.cuda.empty_cache()


def printed_values(text: str, reference_block: list) -> dict:
    """label -> value of the breakdown block in `text`, over as many lines
    as `reference_block` has."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
    out = {}
    for line in lines[start - 1 : start - 1 + len(reference_block)]:
        label, sep, val = line.strip().rpartition(" ")
        label = label.strip()
        if sep and label.endswith(":"):
            out[label] = float(val)
    return out


def breakdown_lines(text: str) -> list[str]:
    """The lines of the breakdown block, from its title to Total energy."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
    end = next(i for i in range(start, len(lines)) if "Total energy:" in lines[i])
    return lines[start : end + 1]


def els_at(d: Path, precision: str, spinorb: bool = False) -> str:
    """The committed `d`/els.in (which asks for "hybrid") at
    `precision`, with `spinorb` at calc_type "CCSD(T)_spinorb": the
    els.in of the JAX references (tools/make_torch_dimer_fixture.py)."""
    els = (d / "els.in").read_text()
    for old, new in (('ccsd_precision = "hybrid"', f'ccsd_precision = "{precision}"'),
                     ('calc_type="CRCCSD(T)_spatial"',
                      'calc_type="CCSD(T)_spinorb"' if spinorb else None)):
        check(old in els, f"{d / 'els.in'} has no line {old!r}")
        if new is not None:
            els = els.replace(old, new)
    return els


def stage_workdir(els_in: str | None = None) -> Path:
    wd = Path(tempfile.mkdtemp(prefix="afesp_chip_smoke_"))
    for f in ("s.dat", "t.dat", "v.dat", "geom.dat", "els.in"):
        shutil.copy(FIXTURE / f, wd / f)
    if els_in is not None:
        (wd / "els.in").write_text(els_in)
    (wd / "eri.dat").symlink_to(ERI)
    return wd


def spatial_phases(torch, kernels: dict, spatial: dict, device=None) -> tuple[int, dict]:
    """Phases 6 and 7: the restricted path through run_calculation (on
    `device`; None is the entry point's default, the card) against the
    JAX reference file, then its "tiled" and "pallas" triples tiers on
    the converged amplitudes; then the same inputs at "hybrid"
    (hybrid_pvtz_spatial).  Returns K3's launches on the path, K4's and
    K5's on their tiers, and the two paths' metrics."""
    import io

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io import fastparse
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods.triples_spatial import do_ccsd_t_spatial

    wd = stage_workdir(spatial["els_in"])
    try:
        info = {}
        with phase("spatial_path", info):
            for fn in kernels.values():
                fn.launches = 0
            fastparse.ROUTES.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            sres = run_calculation(wd, Reporter(stream=buf), device=device)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            metrics = cc_metrics(buf.getvalue(), sres, wall, torch.cuda.max_memory_allocated())
            spatial_launches = {n: fn.launches for n, fn in kernels.items()}
            routes = scanner_routes_check(fastparse, "restricted path", 4)
            tr = sres.triples
            e0 = sres.e_hf + sres.e_nuc
            got = {"e_hf_total": e0, "e_mp2_corr": sres.e_mp2, "e_ccsd_corr": sres.e_ccsd,
                   "t1_diagnostic": sres.t1_diagnostic}
            got.update({k: getattr(tr, k) for k in spatial["triples"]})
            want = {k: spatial[k] for k in ("e_hf_total", "e_mp2_corr", "e_ccsd_corr",
                                            "t1_diagnostic")} | spatial["triples"]
            errs = {k: abs(got[k] - want[k]) for k in want}
            # and every printed value of the breakdown block, as printed
            lines = buf.getvalue().splitlines()
            start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
            block = lines[start - 1 : start - 1 + len(spatial["breakdown"])]
            for label, val in printed_values(buf.getvalue(), spatial["breakdown"]).items():
                errs[label] = abs(val - spatial["breakdown_values"][label])
            check(len(errs) == len(want) + len(spatial["breakdown_values"]),
                  "the breakdown block lacks a line of the reference's")
            for key, err in errs.items():
                check(err <= ENERGY_TOL, f"{key}: off the JAX value by {err:.3e}")
            check(sres.hf.iterations == spatial["scf_iterations"],
                  f"SCF iterations {sres.hf.iterations} vs JAX {spatial['scf_iterations']}")
            check(sres.cc.iterations == spatial["cc_iterations"],
                  f"CC iterations {sres.cc.iterations} vs JAX {spatial['cc_iterations']}")
            check(tr.precision_used == "fused", f"spatial tier {tr.precision_used}")
            ONE_DEVICE["spatial_path"] = result_values(sres)
            PATH_TEXT["spatial_path"] = buf.getvalue()
            check(spatial_launches["triples_fused_spatial"] > 0,
                  "triples_fused_spatial not launched on the spatial path")
            stage_walls = [ln.strip() for ln in buf.getvalue().splitlines()
                           if ln.lstrip().startswith("Time taken for")]
            info.update(wall_s=f"{wall:.3f}", launches=json.dumps(spatial_launches),
                        cc_iter_ms=metrics["cc_iter_ms"], ccsd_tflops=metrics["ccsd_tflops"],
                        max_abs_err=f"{max(errs.values()):.3e}",
                        scf_iterations=sres.hf.iterations, cc_iterations=sres.cc.iterations,
                        read_in_s=stage_wall(buf.getvalue(), "system initialisation"),
                        routes=json.dumps(routes))
        for line in stage_walls:
            print(f"  {line}", flush=True)
        for line in block:
            print(f"  {line}", flush=True)

        tier_launches = {}
        for tier, kname in (("tiled", "triples_tiled_spatial"),
                            ("pallas", "triples_finale_spatial")):
            info = {}
            with phase(f"spatial_{tier}_tier", info):
                for fn in kernels.values():
                    fn.launches = 0
                t0 = time.perf_counter()
                ttr = do_ccsd_t_spatial(sres.sys, sres.cc, sres.cfg, sres.hf.levels,
                                        Reporter(stream=io.StringIO()), precision=tier)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                tier_launches[kname] = kernels[kname].launches
                check(tier_launches[kname] > 0, f"{kname} not launched on the {tier} tier")
                check(ttr.precision_used == tier, f"{tier} tier ran {ttr.precision_used}")
                err_f = max(abs(getattr(ttr, k) - getattr(tr, k)) for k in spatial["triples"])
                err_j = max(abs(getattr(ttr, k) - spatial["triples"][k])
                            for k in spatial["triples"])
                check(err_f <= TRIPLES_TOL, f"{tier} tier off the fused tier by {err_f:.3e}")
                check(err_j <= TRIPLES_TOL, f"{tier} tier off JAX's f64 by {err_j:.3e}")
                ONE_DEVICE[f"spatial_{tier}_tier"] = {k: getattr(ttr, k)
                                                      for k in SIX_TRIPLES + ("D_T", "D_TT")}
                info.update(wall_s=f"{wall:.3f}", max_abs_vs_fused=f"{err_f:.3e}",
                            max_abs_vs_jax_f64=f"{err_j:.3e}",
                            launches=json.dumps({kname: tier_launches[kname]}))
        hybrid_triples_phase(torch, "pvtz_spatial", sres, PATH_TEXT["spatial_path"], kernels,
                             cpu=True)
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    # the same inputs at "hybrid": the digit-GEMM CCSD, then K3
    want = json.loads(HYBRID_EXPECTED["hybrid_pvtz_spatial"].read_text())
    wd = stage_workdir(want["els_in"])
    try:
        hybrid = hybrid_path(torch, "hybrid_pvtz_spatial", wd, kernels, "triples_fused_spatial",
                             metrics)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return spatial_launches["triples_fused_spatial"], tier_launches, {
        "spatial_path": metrics, "hybrid_pvtz_spatial": hybrid}


def amplitudes_restart(torch, spatial: dict) -> None:
    """Information, not a gate: CCSD_spatial on the pVTZ inputs writes
    its amplitudes on the CPU and on the card, and each file restarts a
    run on the card (ccsd_read_amplitudes).  MO column signs may differ
    between the CPU's and the card's Fock builds, so a CPU-written file
    need not restart in one iteration (README.md, the port's caveats)."""
    import io

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io.report import Reporter

    els = spatial["els_in"].replace('"CRCCSD(T)_spatial"', '"CCSD_spatial"')
    check(els != spatial["els_in"], "the restricted els.in names no CRCCSD(T)_spatial")
    head, _, tail = els.rpartition("/")
    els = head + "ccsd_write_amplitudes = .true.,\nccsd_read_amplitudes = .true.,\n/" + tail
    info = {}
    with phase("amplitudes_restart", info):
        iters = {}
        for writer in ("cpu", "cuda"):
            wd_w, wd_r = stage_workdir(els), stage_workdir(els)
            try:
                res = run_calculation(wd_w, Reporter(stream=io.StringIO()), device=writer)
                shutil.copy(wd_w / "amplitudes_out.npz", wd_r / "amplitudes_in.npz")
                again = run_calculation(wd_r, Reporter(stream=io.StringIO()))
                torch.cuda.synchronize()
                iters[writer] = (res.cc.iterations, again.cc.iterations)
                check(abs(again.e_ccsd - res.e_ccsd) <= ENERGY_TOL,
                      f"restart from the {writer} file: CCSD {again.e_ccsd!r} vs {res.e_ccsd!r}")
            finally:
                shutil.rmtree(wd_w, ignore_errors=True)
                shutil.rmtree(wd_r, ignore_errors=True)
        info.update(cc_iterations_fresh_cpu=iters["cpu"][0],
                    restart_on_card_from_cpu_file=iters["cpu"][1],
                    cc_iterations_fresh_card=iters["cuda"][0],
                    restart_on_card_from_card_file=iters["cuda"][1])


def result_values(res, launches: dict | None = None) -> dict:
    """A path's energies and counts, for the mesh phases' comparison with
    the same path on one device."""
    vals = {"e_hf": res.e_hf, "e_mp2": res.e_mp2, "e_ccsd": res.e_ccsd,
            "total_energy": res.total_energy, "scf_iterations": res.hf.iterations,
            "cc_iterations": res.cc.iterations}
    if res.triples is not None:
        vals |= {k: getattr(res.triples, k) for k in SIX_TRIPLES + ("D_T", "D_TT")}
        vals["t1_diagnostic"] = res.t1_diagnostic
    else:
        vals["e_ccsd_t"] = res.e_ccsd_t
    if launches is not None:
        vals["digit_pair_gemm"] = launches["digit_pair_gemm"]
    return vals


def mesh_els(els: str) -> str:
    """`els` with `mesh_devices = MESH_WIDTH` added."""
    head, _, tail = els.rpartition("/")
    return head + f"mesh_devices = {MESH_WIDTH},\n/" + tail


@contextmanager
def two_entry_mesh(dev):
    """parallel.mesh.visible_devices giving `dev` twice: the driver's
    width rule then builds a mesh that lists the one card twice, which
    runs every sharded code path and every kernel per entry."""
    from afesp_tpu_torch.parallel import mesh as pmesh

    visible = pmesh.visible_devices
    pmesh.visible_devices = lambda d: [dev] * MESH_WIDTH
    try:
        yield pmesh.Mesh((dev,) * MESH_WIDTH)
    finally:
        pmesh.visible_devices = visible


def jax_gate(name: str, want: dict, res, text: str, kind: str) -> dict:
    """A run against the JAX file `want`, as its one-device phase holds
    it: every printed breakdown value within ENERGY_TOL (the totals where
    the file has no breakdown values), equal SCF and CC iteration counts,
    and by `kind`: "f64" the triples within ENERGY_TOL of JAX's f64 ones;
    "hybrid" CCSD correlation within HYBRID_CCSD_TOL and the triples
    within HYBRID_TRIPLES_TOL of JAX's f64 triples on its amplitudes
    (CR_F32_TOL for the two the f32 CR chain feeds);
    "stream" MP2, CCSD and the six triples within STREAM_TOL and the
    prelude's count.  Returns the errors."""
    import re

    if "breakdown_values" in want:
        errs = {label: abs(val - want["breakdown_values"][label])
                for label, val in printed_values(text, want["breakdown"]).items()}
        check(len(errs) == len(want["breakdown_values"]),
              f"{name}: the breakdown lacks a line of the reference's")
    else:
        e0 = res.e_hf + res.e_nuc
        got = {"e_hf_total": e0, "e_mp2_total": e0 + res.e_mp2,
               "e_ccsd_total": e0 + res.e_ccsd, "e_ccsd_t_total": e0 + res.e_ccsd_t}
        errs = {k: abs(v - want[k]) for k, v in got.items()}
    e_t = None if res.cfg.restricted else res.e_ccsd_t - res.e_ccsd
    tol = ENERGY_TOL
    if kind == "stream":
        tol = STREAM_TOL
        ref = {"e_mp2": want["e_mp2_corr"], "e_ccsd": want["e_ccsd_corr"]} | {
            k: want["triples"][k] for k in SIX_TRIPLES}
        got = {"e_mp2": res.e_mp2, "e_ccsd": res.e_ccsd} | {
            k: getattr(res.triples, k) for k in SIX_TRIPLES}
        prelude = re.search(r"Device SCF prelude: (\d+) iterations", text)
        check(prelude is not None and int(prelude.group(1)) == want["prelude_iterations"],
              f"{name}: prelude iterations vs JAX {want['prelude_iterations']}")
    elif kind == "hybrid":
        tol = HYBRID_TRIPLES_TOL
        check(abs(res.e_ccsd - want["e_ccsd_corr"]) <= HYBRID_CCSD_TOL,
              f"{name}: CCSD corr {res.e_ccsd!r} vs JAX hybrid {want['e_ccsd_corr']!r}")
    f32_chain = res.cfg.restricted and res.triples.cr_precision == "f32"
    if kind != "stream" and res.cfg.restricted:
        ref = dict(want["triples"])
        got = {k: getattr(res.triples, k) for k in ref}
    elif kind != "stream":
        ref = {"e_t": want["spinorb_triples"]["e_t_f64"] if "spinorb_triples" in want
               else want["e_t_f64"]}
        got = {"e_t": e_t}
    for k in ref:
        err = abs(got[k] - ref[k])
        k_tol = CR_F32_TOL if kind == "hybrid" and f32_chain and k in CR_KEYS else tol
        check(err <= k_tol, f"{name} {k}: off JAX's value by {err:.3e}")
        errs[f"{k}_vs_jax"] = err
    for key, err in errs.items():
        check(err <= ENERGY_TOL, f"{name} {key}: off the JAX value by {err:.3e}")
    check(res.hf.iterations == want["scf_iterations"],
          f"{name}: SCF iterations {res.hf.iterations} vs JAX {want['scf_iterations']}")
    check(res.cc.iterations == want["cc_iterations"],
          f"{name}: CC iterations {res.cc.iterations} vs JAX {want['cc_iterations']}")
    return errs


def mesh_path(torch, name: str, wd: Path, kernels: dict, base: str, kernel: str, want: dict,
              kind: str, smi: str, dev) -> tuple:
    """One path under a mesh: the els.in in `wd` with mesh_devices = 2
    added, run_calculation on the card with the visible devices cuda:0
    twice (two_entry_mesh), AFESP_FORCE_STREAM=1 for `kind` "stream".
    Held to the JAX file `want` as the one-device path is (jax_gate), to
    the port's one-device run `base` within MESH_TOL (equal counts), the
    mesh line printed, `kernel` launched once on each entry and no other
    kernel.  Returns (res, its metrics marked with the card)."""
    import os

    from afesp_tpu_torch.io import fastparse
    from afesp_tpu_torch.parallel import ccsd_shard as CSH

    els = (wd / "els.in").read_text()
    limbs = []
    shard_limbs = CSH.shard_vvvv_limbs
    info = {}
    with phase(name, info):
        old = os.environ.get("AFESP_FORCE_STREAM")
        try:
            (wd / "els.in").write_text(mesh_els(els))
            if kind == "stream":
                os.environ["AFESP_FORCE_STREAM"] = "1"
            CSH.shard_vvvv_limbs = lambda m, b: limbs.append(shard_limbs(m, b)) or limbs[-1]
            fastparse.ROUTES.clear()
            held_before = torch.cuda.memory_allocated()
            with two_entry_mesh(dev) as mesh:
                res, text, wall, peak, launches = run_path(torch, wd, kernels)
        finally:
            CSH.shard_vvvv_limbs = shard_limbs
            (wd / "els.in").write_text(els)
            if old is None:
                os.environ.pop("AFESP_FORCE_STREAM", None)
            else:
                os.environ["AFESP_FORCE_STREAM"] = old
        scanner_routes_check(fastparse, name, 3)
        check(text.count(f" Using a {MESH_WIDTH}-device mesh for CC stages.") == 1,
              f"{name}: no mesh line in the report")
        errs = jax_gate(name, want, res, text, kind)
        one = ONE_DEVICE[base]
        vs_one = {k: abs(v - one[k]) for k, v in result_values(res).items()
                  if not k.endswith("iterations")}
        for k, err in vs_one.items():
            check(err <= MESH_TOL, f"{name} {k}: off the one-device {base} by {err:.3e}")
        for k in ("scf_iterations", "cc_iterations"):
            check(result_values(res)[k] == one[k], f"{name}: {k} differ from {base}'s")
        check(launches[kernel] == MESH_WIDTH,
              f"{name}: {kernel} launched {launches[kernel]} times, not once an entry")
        others = {n: c for n, c in launches.items() if n not in (kernel, "digit_pair_gemm") and c}
        check(not others, f"{name}: other kernels launched: {others}")
        MESH_LAUNCHES[kernel] = MESH_LAUNCHES.get(kernel, 0) + launches[kernel]
        sub = CSH._fitting_mesh(mesh, res.cc.t2.shape[3])
        metrics = cc_metrics(text, res, wall, peak) | {
            "card": smi, "held_before_gb": round(held_before / 1e9, 3)}
        info.update(wall_s=metrics["wall_s"], cc_iter_ms=metrics["cc_iter_ms"],
                    peak_memory_gb=metrics["peak_memory_gb"],
                    held_before_gb=f"{held_before / 1e9:.3f}",
                    peak_above_held_gb=f"{(peak - held_before) / 1e9:.3f}",
                    ccsd_entries=0 if sub is None else sub.size,
                    launches=json.dumps(launches),
                    one_device_digit_pairs=one.get("digit_pair_gemm"),
                    max_abs_vs_jax=f"{max(errs.values()):.3e}",
                    max_abs_vs_one_device=f"{max(vs_one.values()):.3e}",
                    scf_iterations=res.hf.iterations, cc_iterations=res.cc.iterations)
        if limbs:
            check(all(x is limbs[0] for x in limbs), f"{name}: the limbs were split twice")
            per = limbs[0].nbytes()
            check(all(b * MESH_WIDTH == sum(per) for b in per),
                  f"{name}: the limb shards hold {per} bytes, not 1/{MESH_WIDTH} each")
            metrics["limb_bytes_per_entry"] = per
            info.update(limb_chunks_padded=limbs[0].nc, limb_bytes_per_entry=json.dumps(per),
                        limb_bytes_total=sum(per))
    for line in text.splitlines():
        if line.lstrip().startswith("Time taken for"):
            print(f"  {line.strip()}", flush=True)
    return res, metrics


def mesh_pvtz_phases(torch, kernels: dict, spatial: dict, smi: str, dev) -> dict:
    """mesh_pvtz: both pVTZ calc_types at "f64" and at "hybrid" under the
    two-entry mesh (mesh_path; K1 or K3 once an entry), then the "pallas"
    tiers on the f64 runs' amplitudes under the same mesh: K2 on each
    entry's share of the strict triples (chunks), K5 on each entry's
    share of the (i, j-slab) grid, each within MESH_TOL of its one-device
    tier and TRIPLES_TOL of JAX's f64 values.  Returns the paths'
    metrics."""
    import io

    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.methods import triples_spinorb as T

    paths, runs = {}, {}
    cases = (("mesh_pvtz_spinorb", None, "main_path", "triples_fused",
              json.loads((FIXTURE / "expected_jax_cpu.json").read_text()), "f64"),
             ("mesh_pvtz_spinorb_hybrid", "hybrid_pvtz_spinorb", "hybrid_pvtz_spinorb",
              "triples_fused", None, "hybrid"),
             ("mesh_pvtz_spatial", spatial["els_in"], "spatial_path", "triples_fused_spatial",
              spatial, "f64"),
             ("mesh_pvtz_spatial_hybrid", "hybrid_pvtz_spatial", "hybrid_pvtz_spatial",
              "triples_fused_spatial", None, "hybrid"))
    for name, els, base, kernel, want, kind in cases:
        if want is None:
            want = json.loads(HYBRID_EXPECTED[els].read_text())
            els = want["els_in"]
        wd = stage_workdir(els)
        try:
            res, paths[name] = mesh_path(torch, name, wd, kernels, base, kernel, want, kind,
                                         smi, dev)
        finally:
            shutil.rmtree(wd, ignore_errors=True)
        if kind == "f64":  # the pallas tiers below run on these amplitudes
            runs[name] = res
        del res
    expected = cases[0][4]
    info = {}
    with phase("mesh_pvtz_pallas_tiers", info), two_entry_mesh(dev) as mesh:
        res = runs["mesh_pvtz_spinorb"]
        for fn in kernels.values():
            fn.launches = 0
        e_t = T.do_ccsd_t_spinorb(res.sys, res.cc, res.cfg, res.hf.levels,
                                  Reporter(stream=io.StringIO()), precision="pallas",
                                  mesh=mesh) - res.e_ccsd
        # each entry's share: equal whole chunks of the padded strict list
        # (triples_total_sharded), one K2 launch a chunk
        per_raw = -(-len(T.strict_triple_list(res.sys.nocc)[0]) // MESH_WIDTH)
        clen = T._pick_clen(res.sys.nvirt, per_raw)
        chunks = [-(-per_raw // clen)] * MESH_WIDTH
        k2 = kernels["triples_finale"].launches
        check(min(chunks) >= 1 and k2 == sum(chunks),
              f"K2 launched {k2} times under the mesh, its shares have {chunks} chunks")
        err_t = abs(e_t - ONE_DEVICE["pallas_tier"]["e_t"])
        check(err_t <= MESH_TOL, f"mesh pallas E(T) off the one-device tier by {err_t:.3e}")
        check(abs(e_t - expected["e_t_f64"]) <= TRIPLES_TOL,
              f"mesh pallas E(T) {e_t!r} vs JAX f64 {expected['e_t_f64']!r}")
        sres = runs["mesh_pvtz_spatial"]
        for fn in kernels.values():
            fn.launches = 0
        ttr = TS.do_ccsd_t_spatial(sres.sys, sres.cc, sres.cfg, sres.hf.levels,
                                   Reporter(stream=io.StringIO()), precision="pallas", mesh=mesh)
        nocc = sres.sys.nocc
        nslab = nocc // TS.pick_spatial_jlen(nocc, sres.sys.nvirt, "pallas")
        per = -(-nocc * nslab // MESH_WIDTH)
        slabs = [min(per, nocc * nslab - k * per) for k in range(MESH_WIDTH)]
        k5 = kernels["triples_finale_spatial"].launches
        check(ttr.precision_used == "pallas", f"mesh spatial pallas tier ran {ttr.precision_used}")
        check(min(slabs) >= 1 and k5 == sum(slabs),
              f"K5 launched {k5} times under the mesh, its shares have {slabs} slabs")
        one = ONE_DEVICE["spatial_pallas_tier"]
        err_one = max(abs(getattr(ttr, k) - one[k]) for k in one)
        err_j = max(abs(getattr(ttr, k) - spatial["triples"][k]) for k in spatial["triples"])
        check(err_one <= MESH_TOL, f"mesh spatial pallas tier off one device by {err_one:.3e}")
        check(err_j <= TRIPLES_TOL, f"mesh spatial pallas tier off JAX's f64 by {err_j:.3e}")
        for kname, n in (("triples_finale", k2), ("triples_finale_spatial", k5)):
            MESH_LAUNCHES[kname] = MESH_LAUNCHES.get(kname, 0) + n
        info.update(k2_launches=k2, k2_chunks_per_entry=json.dumps(chunks),
                    k5_launches=k5, k5_slabs_per_entry=json.dumps(slabs),
                    e_t_pallas_vs_one_device=f"{err_t:.3e}",
                    spatial_pallas_vs_one_device=f"{err_one:.3e}",
                    spatial_pallas_vs_jax_f64=f"{err_j:.3e}")
    return paths


def mesh_dimer_phases(torch, wd: Path, kernels: dict, smi: str, dev) -> dict:
    """mesh_dimer and mesh_dimer_stream, on the dimer's inputs in `wd`:
    the committed els.in ("hybrid": the digit GEMMs of the vvvv term on
    both entries, K3 once an entry), the spin-orbital dimer at "f64" (its
    vvvv as the (aa, ab) spin blocks, each entry a slice of both, K1 once
    an entry), and the committed els.in on the streaming tier (the limbs'
    53 chunks padded to 54 and split, the CR term from them, K3 once an
    entry), each under the two-entry mesh (mesh_path) against its JAX
    file and the port's one-device run.  Returns the paths' metrics."""
    from afesp_tpu_torch.methods import ccsd_spinorb as CS

    paths = {}
    shutil.copy(DIMER / "els.in", wd / "els.in")
    res, paths["mesh_dimer_hybrid"] = mesh_path(
        torch, "mesh_dimer_hybrid", wd, kernels, "dimer_hybrid_path", "triples_fused_spatial",
        json.loads(HYBRID_EXPECTED["dimer_hybrid_path"].read_text()), "hybrid", smi, dev)
    del res
    (wd / "els.in").write_text(els_at(DIMER, "f64", spinorb=True))
    res, paths["mesh_spinorb_dimer"] = mesh_path(
        torch, "mesh_spinorb_dimer", wd, kernels, "spinorb_dimer_path", "triples_fused",
        json.loads(SPINORB_DIMER_EXPECTED.read_text()), "f64", smi, dev)
    check(res.cc.slices.vvvv is None and res.cc.slices.vvvv_blocks is not None
          and res.sys.nvirt**4 * 8 > CS._BLOCK_VVVV_BYTES,
          "the spin-orbital dimer under the mesh held its vvvv dense")
    del res
    torch.cuda.empty_cache()
    shutil.copy(DIMER / "els.in", wd / "els.in")
    res, paths["mesh_dimer_stream"] = mesh_path(
        torch, "mesh_dimer_stream", wd, kernels, "dimer_stream_path", "triples_fused_spatial",
        json.loads(STREAM_EXPECTED["dimer_stream_path"].read_text()), "stream", smi, dev)
    check(res.cc.slices.v_vvvv is None and res.cc.cr_vvvv_term is not None,
          "mesh_dimer_stream did not run the streaming tier")
    check("limb_bytes_per_entry" in paths["mesh_dimer_stream"],
          "mesh_dimer_stream split no limbs")
    return paths


def mesh_trimer_k4(torch, args: tuple, flags: dict, nocc: int, dev) -> None:
    """K4 on each entry of the two-entry mesh at the trimer path's shape,
    on that path's amplitudes (`args`): its share of the sorted triples,
    once an entry, the six sums within MESH_TOL (relative) of the
    one-device launch on the same amplitudes."""
    from afesp_tpu_torch.methods import triples_spatial as TS
    from afesp_tpu_torch.ops import triples_spatial_cuda as S
    from afesp_tpu_torch.parallel import mesh as pmesh
    from afesp_tpu_torch.parallel import triples_shard as P

    info = {}
    with phase("mesh_trimer_k4", info):
        (si, sj, sk), w = TS._sorted_plan(nocc, dev)
        s = S.triples_tiled_spatial(*args, si, sj, sk, w, **flags)
        one = torch.stack([s[0], s[0] + s[1], s[2], s[2] + s[3], s[4], s[4] + s[5]])
        before = S.triples_tiled_spatial.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = torch.stack(P.triples_spatial_sharded(
            pmesh.Mesh((dev,) * MESH_WIDTH), *args, nocc=nocc,
            jlen=TS.pick_spatial_jlen(nocc, args[0].shape[1], "tiled"), precision="tiled",
            **flags))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = S.triples_tiled_spatial.launches - before
        check(launches == MESH_WIDTH, f"K4 launched {launches} times on the mesh, not once an entry")
        rel = float((got - one).abs().max() / one.abs().max())
        check(rel <= MESH_TOL, f"K4 on the mesh off its one-device launch by {rel:.3e} (rel)")
        MESH_LAUNCHES["triples_tiled_spatial"] = (MESH_LAUNCHES.get("triples_tiled_spatial", 0)
                                                  + launches)
        info.update(launches=launches, sorted_triples=si.numel(), rel_vs_one_device=f"{rel:.3e}",
                    wall_s=f"{wall:.3f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    # no __pycache__ in the checkout: the build directory is all it leaves
    sys.dont_write_bytecode = True
    sys.path.insert(0, str(REPO))
    import io

    from afesp_tpu_torch.driver import run_calculation
    from afesp_tpu_torch.io import fastparse
    from afesp_tpu_torch.io.report import Reporter
    from afesp_tpu_torch.methods.triples_spinorb import do_ccsd_t_spinorb
    from afesp_tpu_torch.ops import _build
    from afesp_tpu_torch.ops import triples_cuda as K
    from afesp_tpu_torch.ops import triples_spatial_cuda as S

    expected = json.loads((FIXTURE / "expected_jax_cpu.json").read_text())
    spatial = json.loads(SPATIAL_EXPECTED.read_text())
    kernels = {"triples_fused": K.triples_fused, "triples_finale": K.triples_finale,
               "triples_fused_spatial": S.triples_fused_spatial,
               "triples_tiled_spatial": S.triples_tiled_spatial,
               "triples_finale_spatial": S.triples_finale_spatial}

    info = {}
    with phase("device", info):
        dev = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        info.update(kind=json.dumps(kind), count=count, torch=torch.__version__,
                    cuda=torch.version.cuda)
    print(f"nvidia-smi: {smi}", flush=True)

    info = {}
    with phase("build", info):
        t0 = time.perf_counter()
        scanner = fastparse.build()
        scanner_s = time.perf_counter() - t0
        built = _build.build(list(kernels))
        info.update(built={n: round(b["seconds"], 3) for n, b in built.items()},
                    scanner=f"{scanner.name} {scanner_s:.3f}")
    for name, b in built.items():
        for line in b["log"].strip().splitlines():
            print(f"  nvcc[{name}] {line}", flush=True)

    # every timed row of the kernels line: (name, row), the paths' shapes first
    table = []
    info = {}
    with phase("kernels", info):
        rows = kernel_checks(torch, dev, o=expected["nocc"], v=expected["nvirt"])
        rows.update(spatial_kernel_checks(torch, dev, o=spatial["nocc"], v=spatial["nvirt"]))
        info.update({n: f"rel={r['max_rel_err']:.3e},ms={r['ms']:.4f}" for n, r in rows.items()})
        info["triples_fused_split_ms"] = json.dumps(rows["triples_fused"]["split_ms"])
        for name in ("triples_tiled_spatial", "triples_fused_spatial"):
            info[f"{name}_split_ms"] = json.dumps(rows[name]["split_ms"])
        table += list(rows.items())
    # K1 at the spin-orbital dimer's shape, seeded random inputs
    info = {}
    with phase("kernels_o20_v212", info):
        dimer_k1 = k1_dimer_check(torch, dev)
        for key in ("source", "replaces"):
            dimer_k1[key] = rows["triples_fused"][key]
        info.update(triples_fused=json.dumps(dimer_k1))
        table.append(("triples_fused", dimer_k1))
    # the spatial kernels at the dimer's and the trimer's shapes (K3 and K5
    # up to the dimer's), seeded random inputs: held and timed
    for o, v in ((10, 106), (15, 159)):
        info = {}
        with phase(f"kernels_o{o}_v{v}", info):
            big = spatial_kernel_checks(torch, dev, o=o, v=v)
            info.update({n: json.dumps(r) for n, r in big.items()})
            table += list(big.items())
    # K4 at the pentamer's shape on one chunk of its kernels
    # (cube_chunk_len: 6 of its 2925 sorted triples), seeded random inputs
    info = {}
    with phase("kernels_o25_v265", info):
        big = spatial_kernel_checks(torch, dev, o=25, v=265, triples=PENTAMER_CHUNK,
                                    label=", one chunk of the pentamer's", names=(
                                        "triples_tiled_spatial",))
        info.update({n: json.dumps(r) for n, r in big.items()})
        table += list(big.items())
    digit_gemm_phase(torch, dev)
    stream_pieces_phase(torch, dev)

    wd = stage_workdir()
    try:
        info = {}
        with phase("main_path", info):
            for fn in kernels.values():
                fn.launches = 0
            fastparse.ROUTES.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            buf = io.StringIO()
            t0 = time.perf_counter()
            res = run_calculation(wd, Reporter(stream=buf))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            paths = {"main_path": cc_metrics(buf.getvalue(), res, wall,
                                             torch.cuda.max_memory_allocated())}
            launches = {n: fn.launches for n, fn in kernels.items()}
            routes = scanner_routes_check(fastparse, "spin-orbital path", 4)
            e0 = res.e_hf + res.e_nuc
            got = {
                "e_hf_total": e0,
                "e_mp2_total": e0 + res.e_mp2,
                "e_ccsd_total": e0 + res.e_ccsd,
                "e_ccsd_t_total": e0 + res.e_ccsd_t,
            }
            for key, val in got.items():
                check(abs(val - expected[key]) <= ENERGY_TOL,
                      f"{key}: {val!r} vs JAX {expected[key]!r}")
            check(res.hf.iterations == expected["scf_iterations"],
                  f"SCF iterations {res.hf.iterations} vs JAX {expected['scf_iterations']}")
            check(res.cc.iterations == expected["cc_iterations"],
                  f"CC iterations {res.cc.iterations} vs JAX {expected['cc_iterations']}")
            check(launches["triples_fused"] > 0, "triples_fused not launched on the main path")
            ONE_DEVICE["main_path"] = result_values(res)
            stage_walls = [ln.strip() for ln in buf.getvalue().splitlines()
                           if ln.lstrip().startswith("Time taken for")]
            info.update(wall_s=f"{wall:.3f}", launches=json.dumps(launches),
                        cc_iter_ms=paths["main_path"]["cc_iter_ms"],
                        ccsd_tflops=paths["main_path"]["ccsd_tflops"],
                        max_abs_energy_err=f"{max(abs(v - expected[k]) for k, v in got.items()):.3e}",
                        scf_iterations=res.hf.iterations, cc_iterations=res.cc.iterations,
                        read_in_s=stage_wall(buf.getvalue(), "system initialisation"),
                        routes=json.dumps(routes))
        for line in stage_walls:
            print(f"  {line}", flush=True)
        lines = buf.getvalue().splitlines()
        start = next(i for i, ln in enumerate(lines) if "Final energy breakdown" in ln)
        for line in lines[start : start + len(expected["breakdown"]) - 1]:
            print(f"  {line}", flush=True)
        main_launches = launches

        info = {}
        with phase("pallas_tier", info):
            for fn in kernels.values():
                fn.launches = 0
            e_t_fused = res.e_ccsd_t - res.e_ccsd
            e_pallas = do_ccsd_t_spinorb(res.sys, res.cc, res.cfg, res.hf.levels,
                                         Reporter(stream=io.StringIO()), precision="pallas")
            e_t_pallas = e_pallas - res.e_ccsd
            ONE_DEVICE["pallas_tier"] = {"e_t": e_t_pallas}
            pallas_launches = {n: fn.launches for n, fn in kernels.items()}
            check(pallas_launches["triples_finale"] > 0,
                  "triples_finale not launched on the pallas tier")
            check(abs(e_t_pallas - e_t_fused) <= TRIPLES_TOL,
                  f"E(T) pallas {e_t_pallas!r} vs fused {e_t_fused!r}")
            check(abs(e_t_pallas - expected["e_t_f64"]) <= TRIPLES_TOL,
                  f"E(T) pallas {e_t_pallas!r} vs JAX f64 {expected['e_t_f64']!r}")
            info.update(e_t_fused=repr(e_t_fused), e_t_pallas=repr(e_t_pallas),
                        e_t_jax_f64=repr(expected["e_t_f64"]),
                        launches=json.dumps(pallas_launches))
        hybrid_triples_phase(torch, "pvtz_spinorb", res, buf.getvalue(), kernels, cpu=True)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    # bench.py's headline configuration: the same inputs at "hybrid"
    wd = stage_workdir(json.loads(HYBRID_EXPECTED["hybrid_pvtz_spinorb"].read_text())["els_in"])
    try:
        paths["hybrid_pvtz_spinorb"] = hybrid_path(torch, "hybrid_pvtz_spinorb", wd, kernels,
                                                   "triples_fused", paths["main_path"])
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    spatial_launches, tier_launches, spatial_paths = spatial_phases(torch, kernels, spatial)
    paths |= spatial_paths
    paths |= mesh_pvtz_phases(torch, kernels, spatial, smi, dev)
    amplitudes_restart(torch, spatial)
    read_in_walls(torch)
    engine_pvtz(torch, dev)
    wd = Path(tempfile.mkdtemp(prefix="afesp_chip_dimer_"))
    try:
        dimer_launches, dimer_rows, paths["dimer_path"] = dimer_phases(torch, dev, kernels, wd)
        table += dimer_rows
        # the committed els.in as written: the digit-GEMM CCSD, then K3
        shutil.copy(DIMER / "els.in", wd / "els.in")
        paths["dimer_hybrid_path"] = hybrid_path(torch, "dimer_hybrid_path", wd, kernels,
                                                 "triples_fused_spatial", paths["dimer_path"])
        # the same run in a fresh process with an empty kernel build directory
        compile_ahead_phase(torch, wd, paths["dimer_hybrid_path"])
        # the same inputs on the streaming-slices tier
        paths["dimer_stream_path"], stream_rows = stream_path(
            torch, "dimer_stream_path", wd, kernels, "triples_fused_spatial",
            "dimer_hybrid_path", paths["dimer_hybrid_path"], dev)
        table += stream_rows
        _, spinorb_rows, paths["spinorb_dimer_path"] = spinorb_dimer_phases(torch, dev,
                                                                            kernels, wd)
        table += spinorb_rows
        (wd / "els.in").write_text(els_at(DIMER, "hybrid", spinorb=True))
        paths["spinorb_dimer_hybrid_path"] = hybrid_path(
            torch, "spinorb_dimer_hybrid_path", wd, kernels, "triples_fused",
            paths["spinorb_dimer_path"])
        torch.cuda.empty_cache()
        paths |= mesh_dimer_phases(torch, wd, kernels, smi, dev)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    torch.cuda.empty_cache()
    _, trimer_rows, trimer_paths = trimer_phases(torch, dev, kernels)
    paths |= trimer_paths
    table += trimer_rows
    # last, so that no timed phase runs in a process whose CUDA
    # activity torch.profiler has traced
    profile_phase(torch, kernels, spatial, paths["spatial_path"])

    # the path that runs each kernel: K1 the spin-orbital main path, K2 its
    # "pallas" tier, K3 the restricted path, K4 and K5 its "tiled" and
    # "pallas" tiers
    path_launches = {"triples_fused": main_launches["triples_fused"],
                     "triples_finale": pallas_launches["triples_finale"],
                     "triples_fused_spatial": spatial_launches,
                     **tier_launches}
    out = []
    for name, r in table:
        b_ms, b_by = r["bound"]
        out.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": r.get("launches", path_launches[name]),
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": r["library_ms"], "shape": r["shape"],
            "bound_share": b_ms / r["ms"], "mesh_launches": MESH_LAUNCHES.get(name, 0),
            **{k: r[k] for k in ("split_ms", "group_ms") if k in r},
        })
    # every path's metrics (cc_metrics), f64 and hybrid
    print(json.dumps({"paths": paths}), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(f"{smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
