"""`els`-style console entry point for the port.

Port of `afesp_tpu/cli.py`: runs the calculation described by ./els.in
(or a directory argument) against the .dat integral files in that
directory and prints the reference-format report to stdout.

    python -m afesp_tpu_torch.cli [workdir] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="els",
        description="AFESP on PyTorch/CUDA: RHF / MP2 / CCSD and the (T) family",
    )
    p.add_argument(
        "workdir",
        nargs="?",
        default=".",
        help="directory containing els.in and the .dat integral files",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="computation device (default: cuda:0; there is no silent CPU run)",
    )
    args = p.parse_args(argv)

    from .driver import run_calculation

    try:
        run_calculation(args.workdir, device=None if args.device == "cuda" else "cpu")
    except (FileNotFoundError, ValueError, RuntimeError) as e:
        # error() analogue (error_handling.f90:7-20): code 999
        print(" ERROR.", file=sys.stderr)
        print(f" Reason: {e}.", file=sys.stderr)
        print(" EXITING...", file=sys.stderr)
        return 999
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
