"""The serve mesh: a 1-D data axis over devices of one process.

Counterpart of the data-mesh part of the JAX package's ``launch/mesh.py``
(``make_data_mesh``). The JAX package is single-controller: one Python
process drives every device through ``shard_map``, and the host forest
(trees, placement, facts) exists once. The port keeps that shape: a
``DataMesh`` is an ordered tuple of ``torch.device``s, each shard's rows are
a tensor on its device, and the one process launches each shard's kernel on
its device in turn; no ``torch.distributed``. A mesh may name one device more
than once, which is how the sharded path runs on one card or on the CPU (the
JAX package's tests force several host devices for the same purpose).

The model-sharding half of the JAX module (``make_production_mesh``,
``make_mesh``, ``activate_mesh``, ``make_host_mesh``) is not ported yet: it
belongs with the port's model sharding (``ROADMAP.md``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _canonical(device) -> torch.device:
    """``device`` with its CUDA index filled in, so that equal cards compare
    equal (``cuda`` and ``cuda:0`` are one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class DataMesh:
    """A 1-D mesh: shard ``s`` lives on ``devices[s]``. Repeats are allowed:
    shards on one device are separate tensors there."""
    devices: Tuple[torch.device, ...]
    axis: str = "data"

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        if not devs:
            raise ValueError("DataMesh: no devices")
        if len({d.type for d in devs}) != 1:
            raise ValueError("DataMesh: the shards lie on CPU and CUDA "
                             f"devices at once ({[str(d) for d in devs]})")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return {self.axis: len(self.devices)}

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def make_data_mesh(devices: int = 0, axis: str = "data") -> Optional[DataMesh]:
    """1-D serve mesh over the first ``devices`` visible CUDA cards (0 = all).
    Returns None when fewer than 2 cards are available/requested — callers
    treat None as the single-device path (``Forest.set_mesh(None)``).

    To run the sharded path on one card or on the CPU, build the mesh
    yourself: ``DataMesh(("cuda:0",) * 4)`` or ``DataMesh(("cpu",) * 4)``."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = avail if devices <= 0 else min(devices, avail)
    if n <= 1:
        return None
    return DataMesh(tuple(torch.device("cuda", i) for i in range(n)), axis)
