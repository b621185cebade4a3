"""Collective bytes of a lockstep step, counted where the port's collectives
run.

Counterpart of the JAX package's ``launch/hlo_analysis.py``
(``collective_bytes``), which reads them off XLA's compiled HLO and expands
every while loop by its trip count. The port has no compiled program: its
collectives are the lockstep's copies between mesh positions, and each
records itself here (``record``) while a ``CollectiveCounter`` is active:

- ``launch/spmd.py``: ``psum`` (an all-reduce, forward and backward),
  ``all_gather`` (an all-gather; its backward a reduce-scatter), ``pmax``
  (an all-reduce); ``pmean`` through its ``psum``;
- ``training/optimizer.py``: ``reduce_grads`` (an all-reduce of each
  gradient block over the positions that hold it, a train step's largest),
  ``global_norm``'s partial sums (an all-reduce of one float32), the
  ZeRO-1 update's gather of each parameter block's slices (an all-gather),
  its scalars and the step counter sent from the first position to the
  others (collective-permutes);
- ``training/grad_compress.py``: the top-k threshold's histograms and the
  int8 scales' maxima over the ZeRO-1 blocks (all-reduces) and the cut
  sent to every position (a collective-permute).

The reference's convention: a collective counts its result's bytes at
each member position, and a reduce-scatter counts the gathered whole, as
the reference scales a reduce-scatter's result by its group. Placing a
cell's arguments (``sharding.place``, ``gather``) is not part of a step and
is not counted. An eager step runs every layer, and remat's recompute, as
it goes, so no trip count needs expanding. Counts are per mesh position,
also where positions share one card (every CPU mesh, one card), which then
copies nothing between them. Each call records its site: the first frame
of the package outside ``spmd.py`` (a gradient's: its forward's, marked
``backward``).
"""
from __future__ import annotations

import functools
import os
import sys
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "collective-permute")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SKIP = tuple(os.path.join(_PACKAGE, "launch", f)
              for f in ("spmd.py", "collectives.py"))
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
           torch.float64: "f64", torch.int32: "s32", torch.int64: "s64",
           torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}

_ACTIVE: List["CollectiveCounter"] = []
_ACTIVE_LOCK = threading.Lock()


def shape_str(x: torch.Tensor) -> str:
    """``x``'s type and shape as HLO prints them: ``f32[4,512,4096]``."""
    dims = ",".join(str(n) for n in x.shape)
    return f"{_DTYPES.get(x.dtype, str(x.dtype))}[{dims}]"


@functools.lru_cache(maxsize=None)
def _in_package(filename: str) -> Optional[str]:
    """``filename`` relative to the package, None outside it or in
    ``spmd.py`` and this module (a relative ``PYTHONPATH`` gives relative
    code paths)."""
    name = os.path.abspath(filename)
    if not name.startswith(_PACKAGE + os.sep) or name in _SKIP:
        return None
    return os.path.relpath(name, _PACKAGE)


def caller_site() -> str:
    """``file:line function`` of the first frame of the package outside
    ``spmd.py`` and this module, the file relative to the package."""
    f = sys._getframe(1)
    while f is not None:
        rel = _in_package(f.f_code.co_filename)
        if rel is not None:
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


def record(kind: str, like: torch.Tensor, positions: Sequence[int], *,
           nbytes: Optional[int] = None, site: Optional[str] = None
           ) -> Optional[str]:
    """Record one collective of ``kind`` whose result at each of
    ``positions`` is ``like`` (its bytes, or ``nbytes``). Returns the site
    (``caller_site`` unless given), None when no counter is active."""
    if not _ACTIVE:
        return None
    if kind not in KINDS:
        raise ValueError(f"unknown collective {kind!r}")
    positions = tuple(positions)
    if len(positions) < (1 if kind == "collective-permute" else 2):
        return None                 # a group of one exchanges nothing
    site = site or caller_site()
    n = like.numel() * like.element_size() if nbytes is None else nbytes
    shape = shape_str(like)
    for counter in list(_ACTIVE):
        counter.add(kind, n, positions, site, shape)
    return site


class CollectiveCounter:
    """``with CollectiveCounter() as c:`` records every collective of the
    block, from any thread (autograd runs a gradient's collectives on its
    own threads)."""

    def __init__(self):
        self.calls: List[Tuple[str, int, Tuple[int, ...], str, str]] = []
        self._lock = threading.Lock()

    def __enter__(self) -> "CollectiveCounter":
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _ACTIVE_LOCK:
            _ACTIVE.remove(self)

    def add(self, kind: str, nbytes: int, positions: Tuple[int, ...],
            site: str, shape: str) -> None:
        with self._lock:
            self.calls.append((kind, nbytes, positions, site, shape))

    def per_position(self) -> Dict[int, Dict[str, float]]:
        """{position: {kind: bytes}}, every position some call reached."""
        out: Dict[int, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        for kind, n, positions, _, _ in self.calls:
            for p in positions:
                out[p][kind] += n
        return {p: dict(v) for p, v in sorted(out.items())}

    def busiest(self) -> int:
        """The position whose collectives carry the most bytes (the lowest
        of a tie; 0 when nothing was recorded)."""
        per = self.per_position()
        return max(per, key=lambda p: (sum(per[p].values()), -p), default=0)

    def totals(self, position: Optional[int] = None) -> Dict[str, float]:
        """The reference's ``collective_bytes`` keys at ``position`` (the
        busiest by default): bytes of each kind, ``total`` and
        ``num_collectives``, a device a step."""
        pos = self.busiest() if position is None else position
        out: Dict[str, float] = defaultdict(float)
        count = 0
        for kind, n, positions, _, _ in self.calls:
            if pos in positions:
                out[kind] += n
                count += 1
        result = {k: float(v) for k, v in out.items()}
        result["total"] = float(sum(out.values()))
        result["num_collectives"] = float(count)
        return result

    def sites(self, position: Optional[int] = None
              ) -> List[Tuple[float, str, int, List[str], str]]:
        """(bytes, kind, calls, shapes, site) at ``position`` (the busiest
        by default) for each (site, kind), largest first: the rows
        ``attribution.attribute`` sorts as the reference sorts its own."""
        pos = self.busiest() if position is None else position
        rows: Dict[Tuple[str, str], list] = {}
        for kind, n, positions, site, shape in self.calls:
            if pos not in positions:
                continue
            row = rows.setdefault((site, kind), [0.0, 0, []])
            row[0] += n
            row[1] += 1
            if shape not in row[2] and len(row[2]) < 4:
                row[2].append(shape)
        return sorted(((b, kind, calls, shapes, site) for (site, kind),
                       (b, calls, shapes) in rows.items()), reverse=True)
