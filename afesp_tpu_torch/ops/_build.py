"""Build the CUDA kernels of `csrc/` with `nvcc` and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/lib<name>-<hash>.so`, a shared
library with a plain C interface; `<hash>` is taken over every file in
`csrc/`, so an edited source never loads a stale library.  The build
runs at first use, one `nvcc` per source, all started together and each
bounded by `NVCC_TIMEOUT_S`.  There is no lock: each compiler writes a
file of its own, which is renamed into place when it is complete.
(No JAX counterpart: Pallas kernels are compiled by XLA.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NVCC_TIMEOUT_S = 300
# where the CUDA toolkit installs nvcc when it is not on PATH
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or (str(CUDA_NVCC) if CUDA_NVCC.exists() else None)
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash()}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every library of `names` that is not built yet, all in
    parallel.  Returns {name: {"seconds": wall, "log": nvcc output}} for
    the ones compiled (the log holds `-Xptxas -v`'s register and spill
    report).  Raises with the compiler's output when a build fails or
    outlasts NVCC_TIMEOUT_S."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    out, failed = {}, []
    for n, (tmp, proc) in procs.items():
        remaining = max(1.0, NVCC_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            log, _ = proc.communicate(timeout=remaining)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            failed.append(f"{n}: nvcc timed out after {NVCC_TIMEOUT_S} s\n{log}")
            continue
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib_path(n))
        out[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(lib_path(name)))
    return _LIBS[name]
