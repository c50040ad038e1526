"""Device selection for the port's entry points.

There is no JAX counterpart: `afesp_tpu` takes whatever backend jax
picked.  The port runs on the card unless the caller asks for the CPU,
and never drops to the CPU silently.
"""

from __future__ import annotations

import contextlib

import torch

F64 = torch.float64


def default_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> `cuda:0`, raising when no card is present; anything else
    is taken as given (`"cpu"` is how the tests run the port)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", 0)
    return torch.device(device)


def current(dev: torch.device):
    """A context in which `dev` is the current CUDA device (nothing on
    another device): a kernel launched into a card's stream must run with
    that card current, which a multi-device mesh does not otherwise make
    it."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
