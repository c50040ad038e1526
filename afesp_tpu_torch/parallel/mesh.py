"""The device mesh of one process.

Port of `afesp_tpu/parallel/mesh.py:19-23` (`default_mesh`).  A JAX mesh
is one controller over a list of devices; so is this one: a tuple of
`torch.device`s that one process addresses in turn, with no process
group, launcher or rendezvous.  The multi-device paths hand each entry
its share of the work (`triples_shard.py`) or its slice of the vvvv
operand (`ccsd_shard.py`) and add or gather the parts on the first
entry, in mesh order.  An entry may repeat a device: a mesh that lists
the CPU, or one card, twice runs every sharded code path on that one
device (that is how the tests and the one-card check run it).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]
    axis_name: str = "p"

    @property
    def size(self) -> int:
        return len(self.devices)


def visible_devices(dev: torch.device) -> list[torch.device]:
    """The devices a run on `dev` can put into a mesh: every card
    (`cuda:0` .. `cuda:n-1`) on a CUDA device, the CPU alone on the CPU."""
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def default_mesh(n_devices: int | None = None, device: str | torch.device | None = None,
                 axis: str = "p") -> Mesh:
    """The first `n_devices` visible devices (all without it) as a mesh;
    `device` picks the kind as the entry points do (a card unless told)."""
    from ..device import default_device

    devices = visible_devices(default_device(device))
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis)
