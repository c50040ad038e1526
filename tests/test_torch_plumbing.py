"""The port's run-time plumbing, on the CPU: the kernel build
directory's fingerprint (`cachemeta`, the counterpart of
tests/test_aux.py's compile-cache fingerprint test), the libraries' key
(`ops/_build.py`), the compile-ahead build (`warmup`) with `_build.build`
replaced by fakes (nvcc exists only on the card's machine), and the
AFESP_TORCH_PROFILE trace.  The kernels' real build ahead of use is
driven on the card by chip_smoke.py (phase `compile_ahead`)."""

import io
import json
import threading
import time
from pathlib import Path

import pytest
import torch
from torch_fixtures import breakdown_block, masked_report, write_h2o

from afesp_tpu_torch import cachemeta, warmup
from afesp_tpu_torch import driver as tdriver
from afesp_tpu_torch.cli import main as cli_main
from afesp_tpu_torch.config import parse_els_in
from afesp_tpu_torch.io.dat import System
from afesp_tpu_torch.io.report import Reporter
from afesp_tpu_torch.ops import _build

CUDA = torch.device("cuda", 0)  # a device object only: nothing runs on it here
STAGES = ("Integral read-in", "Restricted Hartree-Fock", "MP2", "CCSD", "CCSD(T)")


def test_cache_fingerprint_roundtrip_and_mismatch(tmp_path):
    """No fingerprint passes; a recorded environment passes silently; a
    doctored one warns naming the changed keys; a corrupt file counts as
    none."""
    assert cachemeta.check(tmp_path) is True

    env = cachemeta.record(tmp_path)
    assert set(env) == {"torch", "cuda", "nvcc", "nvcc_flags", "device_name", "capability"}
    assert env["torch"] == torch.__version__ and env["nvcc_flags"] == " ".join(_build.NVCC_FLAGS)
    buf = io.StringIO()
    assert cachemeta.check(tmp_path, stream=buf) is True
    assert buf.getvalue() == ""
    cachemeta.record(tmp_path)  # idempotent
    path = tmp_path / cachemeta.FINGERPRINT_NAME
    assert len(json.loads(path.read_text())["environments"]) == 1

    envs = json.loads(path.read_text())["environments"]
    envs[0]["nvcc"] = "Cuda compilation tools, release 9.9"
    envs[0]["device_name"] = "NVIDIA Z1"
    path.write_text(json.dumps({"environments": envs}))
    buf = io.StringIO()
    assert cachemeta.check(tmp_path, stream=buf) is False
    msg = buf.getvalue()
    assert "different" in msg and "release 9.9" in msg and "NVIDIA Z1" in msg

    path.write_text("not json")
    assert cachemeta.check(tmp_path) is True


def test_cachemeta_cli_records(tmp_path, capsys):
    cachemeta.main([str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert out["build_dir"] == str(tmp_path)
    assert cachemeta.read_fingerprint(tmp_path) == [out["recorded"]]


@pytest.fixture
def fresh_key(monkeypatch):
    """The libraries' key recomputed under the test's patches, and again
    once they are undone."""
    _build._source_hash.cache_clear()
    _build.nvcc_version.cache_clear()
    yield
    monkeypatch.undo()
    _build._source_hash.cache_clear()
    _build.nvcc_version.cache_clear()


def test_library_key_covers_flags_and_toolchain(monkeypatch, fresh_key):
    """The key changes with NVCC_FLAGS and with `nvcc --version`, so a
    library built by another toolchain or with other flags is not
    loaded; without a toolkit no nvcc runs."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", Path("/nonexistent/nvcc"))
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda *a, **k: pytest.fail("nvcc run on the CPU"))
    assert _build.nvcc_version() == ""
    base = _build.lib_path("triples_fused")
    assert base == _build.lib_path("triples_fused")  # cached, as is the toolchain

    _build._source_hash.cache_clear()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    flags = _build.lib_path("triples_fused")
    _build._source_hash.cache_clear()
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 9.9")
    toolchain = _build.lib_path("triples_fused")
    assert len({base, flags, toolchain}) == 3
    assert all(p.parent == _build.BUILD_DIR and p.name.startswith("libtriples_fused-")
               for p in (base, flags, toolchain))


def _system(nvirt: int) -> System:
    return System(nbasis=24, nel=10, nocc=5, nvirt=nvirt, natoms=3,
                  charges=None, coords=None)


def _cfg(calc: str, extra: str = ""):
    return parse_els_in(f'&elsinput\ncalc_type="{calc}",\n{extra}/\n')


@pytest.mark.parametrize("calc,extra,nvirt,want", [
    ("CCSD(T)_spinorb", "", 38, ["triples_fused"]),
    ("CRCCSD(T)_spatial", "", 53, ["triples_fused_spatial"]),
    ("CRCCSD(T)_spatial", 'ccsd_precision = "hybrid",\n', 159, ["triples_tiled_spatial"]),
    ("CCSD(T)_spatial", 'ccsd_precision = "pallas",\n', 53, ["triples_finale_spatial"]),
    ("CCSD_spatial", "", 53, []),
    ("MP2_spinorb", "", 53, []),
])
def test_warmup_builds_what_the_triples_stage_loads(calc, extra, nvirt, want):
    cfg = _cfg(calc, extra)
    assert warmup.libraries(_system(nvirt), cfg, CUDA) == want
    assert warmup.libraries(_system(nvirt), cfg, torch.device("cpu")) == []


class FakeBuild:
    """_build.build as the tests need it: each call recorded with its
    thread, compiling (after `delay`) what was not compiled before, or
    raising `error`."""

    def __init__(self, delay: float = 0.0, error: Exception | None = None):
        self.delay, self.error = delay, error
        self.compiled, self.calls, self.done = set(), [], threading.Event()

    def __call__(self, names):
        self.calls.append((threading.current_thread().name, list(names)))
        time.sleep(self.delay)
        self.done.set()
        if self.error is not None:
            raise self.error
        todo = [n for n in names if n not in self.compiled]
        self.compiled.update(todo)
        return {n: {"seconds": self.delay, "log": ""} for n in todo}


@pytest.fixture
def fake_build(monkeypatch):
    """A fresh warmup and library cache, libraries 'loaded' as their
    paths; the test installs its FakeBuild with `use`."""
    monkeypatch.setattr(warmup, "_PENDING", [])
    monkeypatch.setattr(warmup, "_STATS", {})
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("library", path))

    def use(fake):
        monkeypatch.setattr(_build, "build", fake)
        return fake

    yield use
    warmup.join()


def test_warmup_on_the_cpu_builds_nothing(fake_build):
    fake = fake_build(FakeBuild())
    warmup.start(_system(38), _cfg("CCSD(T)_spinorb"), torch.device("cpu"))
    assert warmup._PENDING == []
    warmup.join()
    assert fake.calls == [] and warmup.stats() == {}


def test_load_waits_for_the_thread_and_builds_once(fake_build):
    fake = fake_build(FakeBuild(delay=0.3))
    warmup.start(_system(53), _cfg("CRCCSD(T)_spatial"), CUDA)
    warmup.start(_system(53), _cfg("CRCCSD(T)_spatial"), CUDA)  # one in flight: no-op
    t0 = time.perf_counter()
    lib = _build.load("triples_fused_spatial")
    assert fake.done.is_set() and time.perf_counter() - t0 >= 0.2
    assert lib == ("library", str(_build.lib_path("triples_fused_spatial")))
    # the thread compiled it; load's own build found it built
    assert [c[0] for c in fake.calls] == ["afesp-torch-warmup", "MainThread"]
    assert fake.compiled == {"triples_fused_spatial"}
    stats = warmup.stats()
    assert stats["built"] == ["triples_fused_spatial"] and stats["build_s"] >= 0.3
    assert 0.2 <= stats["waited_s"] <= stats["build_s"] + 0.1
    assert _build.load("triples_fused_spatial") is lib and len(fake.calls) == 2


def test_failed_build_is_raised_at_load(fake_build):
    fake_build(FakeBuild(delay=0.05, error=RuntimeError("CUDA kernel build failed: nvcc exited 1")))
    warmup.start(_system(38), _cfg("CCSD(T)_spinorb"), CUDA)
    with pytest.raises(RuntimeError, match="nvcc exited 1"):
        _build.load("triples_fused")
    assert "triples_fused" not in _build._LIBS


def test_cli_error_exit_joins_the_build(fake_build, tmp_path, capsys):
    """The CLI's error exit waits for the build in flight, and reports a
    failure of it beside the run's own."""
    fake = fake_build(FakeBuild(delay=0.3))
    warmup.start(_system(38), _cfg("CCSD(T)_spinorb"), CUDA)
    thread = warmup._PENDING[0].thread
    assert cli_main([str(tmp_path), "--device", "cpu"]) == 999
    assert not thread.is_alive() and fake.done.is_set() and warmup._PENDING == []
    assert "els.in does not exist" in capsys.readouterr().err

    fake_build(FakeBuild(delay=0.05, error=RuntimeError("nvcc exited 2")))
    warmup.start(_system(38), _cfg("CCSD(T)_spinorb"), CUDA)
    assert cli_main([str(tmp_path), "--device", "cpu"]) == 999
    err = capsys.readouterr().err
    assert err.count(" Reason:") == 2 and "nvcc exited 2" in err and " EXITING..." in err


@pytest.fixture(scope="module")
def h2o(tmp_path_factory):
    return write_h2o(tmp_path_factory.mktemp("h2o"))


def _report(wd) -> str:
    rep = Reporter(stream=io.StringIO())
    tdriver.run_calculation(wd, rep, device="cpu")
    return rep.stream.getvalue()


def test_profile_trace_written_with_the_report_unchanged(h2o, tmp_path, monkeypatch):
    """AFESP_TORCH_PROFILE=<dir>: a Chrome trace in <dir> holding a range
    for each stage section, the report the unprofiled run's line for line
    (timings masked, every number equal); and a trace also when the run
    raises."""
    plain = _report(h2o)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv(tdriver.PROFILE_ENV, str(trace_dir))
    profiled = _report(h2o)
    assert breakdown_block(profiled) == breakdown_block(plain)
    assert masked_report(profiled) == masked_report(plain)
    traces = list(trace_dir.glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert set(STAGES) <= names

    bad = tmp_path / "bad"
    bad.mkdir()
    for f in h2o.iterdir():
        if f.name != "els.in":
            (bad / f.name).symlink_to(f)
    (bad / "els.in").write_text(h2o.joinpath("els.in").read_text().replace(
        "/\n", "mesh_devices = 9,\n/\n"))
    with pytest.raises(ValueError, match="mesh_devices=9"):
        _report(bad)
    assert len(list(trace_dir.glob("*.json"))) == 2


def test_no_profiler_without_the_variable(h2o, monkeypatch):
    """Without AFESP_TORCH_PROFILE no profiler is made and no range is
    opened."""
    monkeypatch.delenv(tdriver.PROFILE_ENV, raising=False)
    import torch.profiler as tp

    def refuse(*a, **k):
        raise AssertionError("profiler used without AFESP_TORCH_PROFILE")

    monkeypatch.setattr(tp, "profile", refuse)
    monkeypatch.setattr(tp, "record_function", refuse)
    text = _report(h2o)
    assert "Final energy breakdown" in text
