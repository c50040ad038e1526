"""Build fingerprinting of the CUDA kernel libraries.

Port of `afesp_tpu/cachemeta.py`'s contract onto the port's build
directory (`ops/_build.BUILD_DIR`).  The JAX package ships an XLA
compile cache and warns when the running jaxlib or topology is not among
the environments its entries were built for.  The port's counterpart is
the directory of `nvcc`-built libraries: each library's key covers its
sources, `NVCC_FLAGS` and the toolchain (`ops/_build.py`), so a library
of another toolchain is never loaded, but a directory built elsewhere
then rebuilds every kernel on first use, and a library built for
another device fails to launch.  `build()` records the environment that
compiled into `FINGERPRINT.json` there; `check` warns loudly when the
running environment is not among those recorded.

Writer CLI (records the running environment):
    python -m afesp_tpu_torch.cachemeta [build_dir]
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

FINGERPRINT_NAME = "FINGERPRINT.json"


def current_env() -> dict:
    """The build-relevant identity of the running environment: the torch
    and CUDA versions, `nvcc --version` ("" without a toolkit), the nvcc
    flags, and the current CUDA device's name and capability (None
    without one).  Runs no compiler beyond the one cached `nvcc
    --version`."""
    import torch

    from .ops import _build

    dev = name = cap = None
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        name = torch.cuda.get_device_name(dev)
        cap = ".".join(map(str, torch.cuda.get_device_capability(dev)))
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": _build.nvcc_version(),
        "nvcc_flags": " ".join(_build.NVCC_FLAGS),
        "device_name": name,
        "capability": cap,
    }


def read_fingerprint(build_dir: str | Path) -> list[dict]:
    path = Path(build_dir) / FINGERPRINT_NAME
    try:
        data = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    envs = data.get("environments", []) if isinstance(data, dict) else []
    return envs if isinstance(envs, list) else []


def record(build_dir: str | Path) -> dict:
    """Append the current environment to the fingerprint (idempotent);
    the file is replaced whole, so a reader never sees half of it."""
    path = Path(build_dir) / FINGERPRINT_NAME
    envs = read_fingerprint(build_dir)
    env = current_env()
    if env not in envs:
        envs.append(env)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps({"environments": envs}, indent=1) + "\n")
        os.replace(tmp, path)
    return env


def check(build_dir: str | Path, stream=None) -> bool:
    """True when the current environment matches a recorded one (or no
    fingerprint exists: nothing was built there).  On a mismatch print a
    warning naming both sides: the run still works, but rebuilds every
    kernel it loads, or finds libraries built for another device."""
    envs = read_fingerprint(build_dir)
    if not envs:
        return True
    env = current_env()
    if env in envs:
        return True
    stream = stream if stream is not None else sys.stderr
    rec = envs[0]
    diff = ", ".join(
        f"{k}: {rec.get(k)!r} -> {env.get(k)!r}" for k in env if env.get(k) != rec.get(k)
    )
    print(
        f" WARNING: kernel build directory {build_dir} was built for a different "
        f"environment ({diff}); expect every CUDA kernel to be compiled again "
        f"with nvcc on first use.",
        file=stream,
    )
    return False


def main(argv: list[str] | None = None) -> None:
    from .ops import _build

    argv = sys.argv[1:] if argv is None else argv
    build_dir = argv[0] if argv else str(_build.BUILD_DIR)
    env = record(build_dir)
    print(json.dumps({"recorded": env, "build_dir": build_dir}))


if __name__ == "__main__":
    main()
