"""The benchmark of `afesp_tpu_torch`, the PyTorch/CUDA port: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (BENCHMARK.json `workloads`) is a configuration (a molecule, its
basis and its committed els.in) under a traffic mix (calc_type,
ccsd_precision, a fixed set of displaced geometries).  One run:

1. Set-up (`setup_s`, from the process's start): the mix's environment,
   the inputs of every geometry of the mix's set (each moved by its
   displacement draw, its integral files written to TMPDIR by the
   benchmark's frozen engine, `inputs/`), the kernel libraries this
   cell's path loads built or found in the program's build directory in
   the checkout, and one calculation of the set's first geometry, the
   process's first (`first_calc_s`, a per-layer metric).
2. The window: `afesp_tpu_torch.driver.run_calculation` back to back, a
   fresh work directory each, one calculation at a time (a closed loop
   of one client), cycling through the set in an order drawn from
   `--seed`, until the first calculation that ends after `--seconds`;
   so every seed does the same work.  `calc_s` is the window's wall over
   its calculations, `peak_gb` the card's allocation peak in it.  With
   `--trace 1` the window runs with the per-layer metrics' spans and
   probes, and one more calculation runs under torch.profiler (CUDA
   activity) for the device's busy time, in all and a span, idle gaps
   and operations.
3. Correctness: every calculation's breakdown against the plain
   reference (`reference/`), run once a geometry on the same input
   files after the window, each compared number within its limit
   (`limits/<cell>.json`).
4. One JSON line on stdout: correct, attempted, failed, metrics (the
   cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
   device, [breakdown], checks.

Exit codes: 2 no CUDA device or too few; 3 the program cannot be
imported; 4 JAX or the JAX package was loaded; 1 a set-up failure.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.harness import answers, spec, trace  # noqa: E402
from gpubench.harness.patch import Patches  # noqa: E402

# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "afesp_tpu")
INPUT_FILES = ("s.dat", "t.dat", "v.dat", "geom.dat", "eri.npy", "els.in")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_window(one, seconds: float, clock=time.perf_counter) -> tuple[float, list[float]]:
    """Call `one()` back to back until the first call that ends after
    `seconds`: whole calls only.  Returns (window wall, each call's wall)."""
    t0 = clock()
    walls = []
    while True:
        c = clock()
        one()
        end = clock()
        walls.append(end - c)
        if end - t0 >= seconds:
            return end - t0, walls


def metric_file(bench: Path, name: str) -> Path:
    """The reader of a per-layer metric: `<bench>/metrics/<name>.py`."""
    return bench / "metrics" / f"{name}.py"


def window_order(draws: list, seed: int) -> list:
    """The mix's geometries in the order `seed` draws; every seed gets
    the same set."""
    import numpy as np

    rng = np.random.default_rng(np.random.SeedSequence(seed % 2**64))
    return [draws[i] for i in rng.permutation(len(draws))]


def load_metric(bench: Path, name: str):
    path = metric_file(bench, name)
    mod_name = "gpubench_metric_" + re.sub(r"\W", "_", path.stem)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Traced:
    """What a traced run hands each per-layer metric's `read`."""

    calcs: int  # calculations in the traced window
    span_s: dict  # span name -> seconds summed over them
    values: list  # the program's breakdown values, one dict a calculation
    sizes: dict  # nbasis, nocc, nvirt
    precision: str  # the mix's ccsd_precision
    probes: dict  # a metric file's name -> its probe
    profile: trace.Profile | None  # the profiled calculation, on a card
    profiled: dict | None  # that calculation's breakdown values
    first_calc_s: float  # the set-up's calculation, the process's first

    def span_ms(self, name: str) -> float | None:
        """A span's mean milliseconds a calculation, None if it never ran."""
        if name not in self.span_s or not self.calcs:
            return None
        return self.span_s[name] / self.calcs * 1e3

    def total(self, key: str) -> float:
        return sum(v.get(key, 0) for v in self.values)


class Session:
    """The program under test, a cell's inputs, and one calculation."""

    def __init__(self, cell: spec.Cell, dev, tmp: Path):
        import torch

        from afesp_tpu_torch import driver
        from afesp_tpu_torch.io.report import Reporter

        self.torch, self.driver, self.Reporter = torch, driver, Reporter
        self.cell, self.dev, self.tmp = cell, dev, tmp
        self.last_report = ""

    def cuda(self) -> bool:
        return self.dev.type == "cuda"

    def sync(self) -> None:
        if self.cuda():
            self.torch.cuda.synchronize(self.dev)

    def inputs(self, draw: int) -> Path:
        return self.tmp / f"inputs-{draw}"

    def make_inputs(self, draw: int) -> dict:
        """The input files of the geometry that displacement draw `draw`
        gives (draw 0: the configuration's own)."""
        from gpubench import inputs

        c = self.cell.config
        info = inputs.make_inputs(self.inputs(draw), c["charges"], c["coords_bohr"],
                                  c["basis"], seed=draw,
                                  amplitude=self.cell.traffic["displacement_bohr"],
                                  device=self.dev)
        (self.inputs(draw) / "els.in").write_text(self.cell.els_in())
        self.sync()
        return info

    def prebuild(self) -> None:
        """Build (or find built) the kernel libraries that this cell's
        calculation loads, as the program's compile-ahead names them,
        and its C scanner, so that no calculation compiles.  Where the
        program no longer offers these, its first calculation builds."""
        if not self.cuda():
            return
        try:
            from afesp_tpu_torch import warmup
            from afesp_tpu_torch.config import parse_els_in
            from afesp_tpu_torch.ops import _build

            names = warmup.libraries(SimpleNamespace(nvirt=self.cell.config["nvirt"]),
                                     parse_els_in(self.cell.els_in()), self.dev)
            _build.build(names)
            log(f"prebuild: {names}")
        except (ImportError, AttributeError, TypeError) as e:
            log(f"prebuild: the program's kernel build is not reachable ({e})")
        try:
            from afesp_tpu_torch.io import fastparse
            fastparse.build()
        except (ImportError, AttributeError) as e:
            log(f"prebuild: the program's scanner build is not reachable ({e})")

    def calc(self, draw: int, els_in: str | None = None) -> dict:
        """One calculation of geometry `draw` in a fresh work directory
        (with `els_in` in place of the cell's); its breakdown values."""
        wd = Path(tempfile.mkdtemp(dir=self.tmp, prefix="calc-"))
        stream = io.StringIO()
        try:
            for f in INPUT_FILES:
                (wd / f).symlink_to(self.inputs(draw) / f)
            if els_in is not None:
                (wd / "els.in").unlink()
                (wd / "els.in").write_text(els_in)
            res = self.driver.run_calculation(wd, self.Reporter(stream=stream), device=self.dev)
            self.sync()
            return answers.program_values(res) | {"geometry": draw}
        finally:
            self.last_report = stream.getvalue()
            shutil.rmtree(wd, ignore_errors=True)

    def reference(self, draw: int, dtype=None, lower: dict | None = None) -> dict:
        """The cell's plain reference on geometry `draw`'s input files."""
        import torch

        mod = importlib.import_module(f"gpubench.reference.{self.cell.traffic['reference']}")
        return mod.run(self.inputs(draw), self.cell.settings(), self.dev,
                       dtype or torch.float64, lower)


def span_recorder(record, sync, clock):
    """A wrap factory for Patches: the span `name` around a call."""

    def for_name(name):
        def make(fn):
            def wrapped(*a, **k):
                sync()
                t0 = clock()
                try:
                    return fn(*a, **k)
                finally:
                    sync()
                    record(name, t0, clock())
            return wrapped
        return make
    return for_name


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().split("\n")[0])
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, root: Path | None = None, device: str | None = None) -> int:
    """One run of one cell.  `device` is for the CPU tests alone: "cpu"
    skips the card-only steps (memory, profiler, kernel build); without
    it a run needs the CUDA devices the cell asks for."""
    args = parse_args(argv)
    root = Path(root) if root else ROOT
    cell = spec.load_cell(root, args.workload)
    # the mix's environment and the cache directories, before torch loads
    for key, value in cell.traffic.get("env", {}).items():
        os.environ[key] = str(value)
    for key, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[key] = str(root / ".gpubench_cache" / sub)
    import torch

    log(f"set-up: torch imported at {time.perf_counter() - T_START:.3f} s")
    if device is None and not torch.cuda.is_available():
        log("no CUDA device is available: the benchmark runs on a card only")
        return 2
    if device is None and torch.cuda.device_count() < cell.chips:
        log(f"the cell asks for {cell.chips} CUDA devices, {torch.cuda.device_count()} visible")
        return 2
    dev = torch.device(device or "cuda:0")
    try:
        import afesp_tpu_torch.driver  # noqa: F401
    except ImportError as e:
        log(f"the program under test cannot be imported: {e}")
        return 3
    log(f"set-up: the program imported at {time.perf_counter() - T_START:.3f} s")

    tmp = Path(tempfile.mkdtemp(prefix="gpubench-"))
    try:
        return _run(args, cell, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def span_targets(metric_mods) -> list[tuple[str, str]]:
    """Every (span, target) the metrics declare, each once."""
    pairs = []
    for mod in metric_mods:
        for span, targets in getattr(mod, "SPANS", {}).items():
            pairs += [(span, t) for t in targets if (span, t) not in pairs]
    return pairs


def _run(args, cell: spec.Cell, dev, tmp: Path) -> int:
    import torch as torch_mod
    s = Session(cell, dev, tmp)
    cuda = s.cuda()
    sizes = {k: cell.config[k] for k in ("nbasis", "nocc", "nvirt")}
    clock = time.perf_counter

    # ---- set-up ----
    if cuda:
        torch_mod.ones(1, device=dev).sum().item()
    log(f"set-up: the device ready at {clock() - T_START:.3f} s")
    draws = cell.traffic["geometry_draws"]
    for draw in draws:
        t = clock()
        made = s.make_inputs(draw)
        log(f"inputs: geometry {draw}, {made['nbasis']} basis functions, {clock() - t:.3f} s "
            + json.dumps({k: round(v, 3) for k, v in made["walls"].items()}))
        if made["nbasis"] != sizes["nbasis"]:
            raise RuntimeError(f"the inputs have {made['nbasis']} basis functions, "
                               f"the configuration says {sizes['nbasis']}")
    t = clock()
    s.prebuild()
    plimit = power_limit_w() if cuda else None
    log(f"prebuild and power limit: {clock() - t:.3f} s")
    t = clock()
    try:
        first = s.calc(draws[0])
    except Exception:
        log(traceback.format_exc())
        log(s.last_report[-4000:])
        return 1
    first_calc_s = clock() - t
    setup_s = clock() - T_START
    setup_peak = torch_mod.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch_mod.cuda.reset_peak_memory_stats(dev)

    # ---- the window ----
    order = window_order(draws, args.seed)
    log(f"window order: {order}")
    next_draw = itertools.cycle(order).__next__
    per_calc = [first]
    window_vals: list[dict] = []
    cpu_s: list[float] = []
    failures: list[str] = []
    metrics_mods = {m["name"]: load_metric(cell.bench, m["name"]) for m in cell.per_layer} \
        if args.trace else {}
    span_s: dict[str, float] = {}
    probes: dict = {}
    sync = s.sync

    def one():
        before = dict(span_s)
        c = time.thread_time()
        try:
            window_vals.append(s.calc(next_draw()))
            cpu_s.append(time.thread_time() - c)
            if args.trace:
                log("calc spans: " + json.dumps(
                    {k: round(v - before.get(k, 0.0), 4) for k, v in span_s.items()}))
        except Exception:
            failures.append(traceback.format_exc())
            raise

    def record(name, t0, t1):
        span_s[name] = span_s.get(name, 0.0) + (t1 - t0)

    with Patches() as patches:
        if args.trace:
            wrap = span_recorder(record, sync, clock)
            for span, target in span_targets(metrics_mods.values()):
                patches.wrap_everywhere(target, wrap(span))
            for name, mod in metrics_mods.items():
                if hasattr(mod, "Probe") and cuda:
                    probe = probes[name] = mod.Probe()
                    probe.install(patches)
        try:
            window_s, walls = run_window(one, args.seconds, clock)
        except Exception:
            window_s, walls = None, []
            log(failures[-1] if failures else traceback.format_exc())
            log(s.last_report[-4000:])
    window_peak = torch_mod.cuda.max_memory_allocated(dev) if cuda else 0
    per_calc += window_vals

    profile, profiled = None, []
    if args.trace and cuda and window_s is not None:
        host_spans: list = []
        wrap = span_recorder(lambda n, a, b: host_spans.append((n, a, b)), sync, time.time_ns)
        with Patches() as patches:
            for span, target in span_targets(metrics_mods.values()):
                patches.wrap_everywhere(target, wrap(span))
            try:
                profile = trace.profile_calc(lambda: profiled.append(s.calc(next_draw())),
                                             host_spans)
            except Exception:
                failures.append(traceback.format_exc())
                log(failures[-1])
        per_calc += profiled
    memory_peak = max(setup_peak, torch_mod.cuda.max_memory_allocated(dev) if cuda else 0)

    # ---- correctness, after the program's state is freed ----
    gc.collect()
    if cuda:
        torch_mod.cuda.empty_cache()
    t = clock()
    refs = {draw: s.reference(draw) for draw in sorted({v["geometry"] for v in per_calc})}
    s.sync()
    ref_s = clock() - t
    failed, worst = answers.judge([(v, refs[v["geometry"]]) for v in per_calc], cell.limits)
    failed += len(failures)
    attempted = len(per_calc) + len(failures)
    correct = failed == 0 and window_s is not None
    bad = forbidden_loaded()
    if bad:
        log(f"forbidden modules loaded in the measured process: {', '.join(bad)}")
        return 4

    # ---- the result ----
    if window_s is not None:
        calc_s = window_s / len(walls)
        log(f"window: {len(walls)} calculations in {window_s:.4f} s, calc_s {calc_s:.4f}"
            f"{' (traced)' if args.trace else ''}; walls min {min(walls):.4f} median "
            f"{statistics.median(walls):.4f} max {max(walls):.4f}")
        log("walls (wall/main thread's cpu time, s): " + " ".join(
            f"{w:.4f}/{c:.4f}" for w, c in zip(walls, cpu_s)))
    log(f"first_calc_s {first_calc_s:.4f}, setup_s {setup_s:.4f}, reference {ref_s:.3f} s")
    log("iterations: program scf/cc " + ", ".join(
        f"g{v['geometry']} {v.get('scf_iterations')}/{v.get('cc_iterations')}"
        for v in per_calc[:len(draws) + 1])
        + "; reference " + ", ".join(f"g{d} {r.get('scf_iterations')}/{r.get('cc_iterations')}"
                                     for d, r in refs.items()))
    e2e = {"setup_s": setup_s}
    if window_s is not None:
        e2e["calc_s"] = calc_s
        if cuda:
            e2e["peak_gb"] = window_peak / 1e9
    metrics = {}
    if args.trace:
        traced = Traced(calcs=len(window_vals), span_s=span_s, values=window_vals,
                        sizes=sizes, precision=cell.traffic["ccsd_precision"],
                        probes=probes, profile=profile,
                        profiled=profiled[0] if profiled else None,
                        first_calc_s=first_calc_s)
        for name, mod in metrics_mods.items():
            value = mod.read(traced)
            if value is not None:
                metrics[name] = {"value": value, "unit": next(
                    m["unit"] for m in cell.per_layer if m["name"] == name)}
        log("spans (s summed over the traced window): "
            + json.dumps({k: round(v, 4) for k, v in span_s.items()}))
        if profile is not None:
            log("device busy a span (s, the profiled calculation): "
                + json.dumps({k: round(v, 4) for k, v in profile.span_busy_s.items()}))
    else:
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch_mod.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(memory_peak),
              "power_limit_w": plimit}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if profile is not None:
        device.update(busy_s=profile.busy_s, window_s=profile.window_s)
        out["breakdown"] = {"device_ops": profile.device_ops, "idle_gaps": profile.idle_gaps}
    checks = {k: {"value": worst[k], "limit": cell.limits[k]} for k in cell.limits}
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']:.6e} limit {c['limit']:.6e}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
