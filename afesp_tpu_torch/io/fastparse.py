"""ctypes loader for the native `.dat` table scanner (`_fastparse.c`).

Port of `afesp_tpu/io/fastparse.py:31-114`.  The shared object is built
at first use with the system C compiler (`cc -O2 -shared -fPIC`, or
`$CC`) into the package's gitignored `_build/` directory, the one the
CUDA kernels use (`ops/_build.py`), as `lib_fastparse-<hash>.so`, where
`<hash>` is taken over the source, so an edited scanner never loads a
stale library.  It is never built next to its source.

`AFESP_NO_FASTPARSE` (any non-empty value) keeps the numpy route, as in
the JAX package; so does a failed build, quietly, as there.  Which route
parsed each file is counted in `ROUTES` ("scanner" or "numpy"), so a
caller can tell that no file fell back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import mmap
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

_SRC = Path(__file__).with_name("_fastparse.c")
CC_TIMEOUT_S = 120
# files parsed by each route since the counts were last cleared
ROUTES: collections.Counter = collections.Counter()
_LIB = None  # ctypes.CDLL once loaded; False if unavailable


def lib_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib_fastparse-{tag}.so"


def build() -> Path:
    """Compile the scanner unless it is built already; raises with the
    compiler's output when the build fails."""
    so = lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=CC_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"C scanner build failed: {exc}") from exc
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"C scanner build failed:\n{out.stdout}{out.stderr}")
    os.replace(tmp, so)  # atomic against a concurrent compile
    return so


def _load():
    global _LIB
    if _LIB is None:
        if os.environ.get("AFESP_NO_FASTPARSE"):
            _LIB = False
            return _LIB
        try:
            so = build()
        except RuntimeError:
            _LIB = False
            return _LIB
        lib = ctypes.CDLL(str(so))
        lib.afesp_parse_doubles.restype = ctypes.c_long
        lib.afesp_parse_doubles.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ]
        lib.afesp_count_tokens.restype = ctypes.c_long
        lib.afesp_count_tokens.argtypes = [ctypes.c_void_p, ctypes.c_long]
        _LIB = lib
    return _LIB


def available() -> bool:
    return bool(_load())


def parse_doubles_file(path: Path, ncols: int) -> np.ndarray | None:
    """Parse a whitespace-separated numeric table; None if the scanner
    is unavailable (the caller then takes the numpy route)."""
    lib = _load()
    if not lib:
        return None
    size = path.stat().st_size
    if size == 0:
        ROUTES["scanner"] += 1
        return np.zeros((0, ncols))
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        # zero-copy: a uint8 view of the mmap carries the buffer address
        view = np.frombuffer(mm, dtype=np.uint8)
        # a counting pass sizes the output exactly and faults the pages in
        max_out = lib.afesp_count_tokens(ctypes.c_void_p(view.ctypes.data), size)
        out = np.empty(max_out, dtype=np.float64)
        n = lib.afesp_parse_doubles(
            ctypes.c_void_p(view.ctypes.data), size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out,
        )
        del view
    if n < 0:
        raise ValueError(f"{path}: malformed numeric token at byte {-(n + 1)}")
    if n % ncols != 0:
        raise ValueError(f"{path}: expected {ncols} columns, got {n} values")
    ROUTES["scanner"] += 1
    return out[:n].reshape(-1, ncols).copy()
