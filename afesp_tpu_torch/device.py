"""Device selection for the port's entry points.

There is no JAX counterpart: `afesp_tpu` takes whatever backend jax
picked.  The port runs on the card unless the caller asks for the CPU,
and never drops to the CPU silently.
"""

from __future__ import annotations

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
