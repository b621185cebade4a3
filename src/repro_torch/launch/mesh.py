"""Meshes of devices in one process: the serve mesh and the model mesh.

Counterpart of the JAX package's ``launch/mesh.py``. The JAX package is
single-controller: one Python process drives every device through
``shard_map``. The port keeps that shape; no ``torch.distributed``. A mesh
names each position's ``torch.device`` and may name one device more than
once, which is how the sharded paths run on one card or on the CPU (the JAX
package's tests force several host devices for the same purpose).

- ``DataMesh``: the serve mesh, a 1-D data axis (``make_data_mesh``): the
  memory's fact index and its flush and browse batches are split over it
  (``kernels/shard_ops.py``).
- ``Mesh``: an N-D mesh with named axes, ``("data", "model")`` or ``("pod",
  "data", "model")`` (``make_mesh``, ``make_production_mesh``,
  ``make_host_mesh``): model sharding (``launch/sharding.py``, the lockstep
  collectives of ``launch/spmd.py``). ``activate_mesh`` makes one the
  thread's ambient mesh, which ``Model.loss`` and the train step read
  (``current_mesh``, the reference's ``get_abstract_mesh``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


@dataclass(frozen=True)
class Mesh:
    """An N-D mesh: ``devices`` in C order over ``dims``, one entry per
    position, axes named ``axis_names`` (major to minor). Position ``pos``
    has coordinates ``coords(pos)``. Repeats are allowed: the positions on
    one device hold separate tensors there."""
    devices: Tuple[torch.device, ...]
    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        devs = tuple(_canonical(d) for d in self.devices)
        dims, names = tuple(int(n) for n in self.dims), tuple(self.axis_names)
        if len(dims) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"Mesh: dims {dims} and axis names {names} "
                             "must pair up, each name once")
        if any(n < 1 for n in dims) or len(devs) != math.prod(dims):
            raise ValueError(f"Mesh: {len(devs)} devices for a mesh of "
                             f"shape {dims}")
        if len({d.type for d in devs}) != 1:
            raise ValueError("Mesh: the positions lie on devices of several "
                             f"types ({sorted({str(d) for d in devs})})")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "dims", dims)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` in axis order, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, pos: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.dims):
            pos, c = divmod(pos, n)
            out.append(c)
        return tuple(reversed(out))

    def coord(self, pos: int, axis: str) -> int:
        """Position ``pos``'s index along ``axis`` (0 for an axis the mesh
        lacks): the reference's ``axis_index``."""
        if axis not in self.axis_names:
            return 0
        return self.coords(pos)[self.axis_names.index(axis)]

    def axis_size(self, axes: Sequence[str]) -> int:
        """The product of the sizes of ``axes`` (1 for an absent one)."""
        sizes = self.shape
        return math.prod(sizes.get(a, 1) for a in axes)

    def index_over(self, pos: int, axes: Sequence[str]) -> int:
        """Position ``pos``'s index over ``axes`` taken together, the first
        one major: its shard of a dimension sharded over ``axes``."""
        idx = 0
        for a in axes:
            idx = idx * self.shape.get(a, 1) + self.coord(pos, a)
        return idx

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The positions that differ only along ``axes``: one group per
        coordinate on the other axes, groups in mesh order, each group's
        members ordered by ``index_over(pos, axes)``."""
        axes = [a for a in axes if a in self.axis_names]
        rest = [a for a in self.axis_names if a not in axes]
        by_key: Dict[Tuple[int, ...], List[int]] = {}
        for pos in range(self.size):
            by_key.setdefault(tuple(self.coord(pos, a) for a in rest),
                              []).append(pos)
        return [sorted(g, key=lambda p: self.index_over(p, axes))
                for g in by_key.values()]

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-use order."""
        return tuple(dict.fromkeys(self.devices))


def _device_grid(shape: Tuple[int, ...], devices) -> Tuple[torch.device,
                                                          ...]:
    n = math.prod(shape)
    if devices is None:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if avail < n:
            raise RuntimeError(f"a mesh of shape {shape} needs {n} CUDA "
                               f"cards, {avail} are visible; pass devices= "
                               "to repeat one")
        return tuple(torch.device("cuda", i) for i in range(n))
    if isinstance(devices, (str, torch.device)):
        return (torch.device(devices),) * n
    devices = tuple(devices)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of shape "
                         f"{shape} ({n} positions)")
    return devices


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              devices=None) -> Mesh:
    """A mesh of ``shape`` with axes ``axes``. ``devices``: None takes the
    first prod(shape) visible CUDA cards; one device (``"cuda:0"``,
    ``"cpu"``) is repeated at every position; a sequence gives one device
    per position in C order."""
    shape = tuple(shape)
    return Mesh(_device_grid(shape, devices), shape, tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices) -> Mesh:
    """The reference's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``. No host
    holds 256 cards, so ``devices`` is required: one device repeated at every
    position (``"meta"`` for a mesh used by shape only, as the sharding rules
    use it; ``"cpu"`` or a card to run on) or one device per position."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


_AMBIENT = threading.local()


@contextlib.contextmanager
def activate_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` the calling thread's ambient mesh for the ``with``
    block (the reference's ``jax.set_mesh``); the previous one comes back
    after it. Only the thread that entered sees it: the layers take the mesh
    as an argument, since autograd runs a remat body's recompute on its own
    threads."""
    prev = getattr(_AMBIENT, "mesh", None)
    _AMBIENT.mesh = mesh
    try:
        yield mesh
    finally:
        _AMBIENT.mesh = prev


def current_mesh() -> Optional[Mesh]:
    """The calling thread's ambient mesh, None outside ``activate_mesh``
    (the reference's ``get_abstract_mesh`` when it is empty)."""
    return getattr(_AMBIENT, "mesh", None)


def make_host_mesh(model_parallel: int = 1) -> Optional[Mesh]:
    """The largest ("data", "model") mesh over the visible CUDA cards:
    (n // model_parallel, model_parallel), over the first cards it covers.
    None with fewer than 2 cards: callers treat None as the single-device
    path."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n <= 1:
        return None
    data = n // model_parallel
    if data < 1:
        raise ValueError(f"model_parallel {model_parallel} exceeds the {n} "
                         "visible cards")
    return make_mesh((data, model_parallel), ("data", "model"))
