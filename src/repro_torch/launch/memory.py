"""Per-position device memory of a lockstep step: live bytes and their
peak, and the position a tensor belongs to.

The reference reads a compiled program's memory analysis: the bytes of a
device's arguments, outputs and temporaries. The port has no compiled
program; ``MemoryTracker``, a ``TorchDispatchMode``, watches a step run
instead (on real tensors, or on fake ones under ``FakeTensorMode``, where
nothing is allocated) and keeps, for each mesh position, the bytes its
live storages hold and their peak. Each storage is rounded up to the
caching allocator's 512 bytes (``ROUND``), so that on a card the figure is
comparable with ``torch.cuda.memory_allocated``; a storage is freed when
its last tensor dies (a finalizer on the storage).

A mesh may name one device at several positions (every CPU mesh, one
card), so a tensor's position cannot be read from its device. Each new
storage takes the position set by ``at`` around the code that made it
(``spmd.each`` sets it for each position's step, the collectives for each
member's copy, ``sharding.place`` for each block), else the position of
the operation's first input whose storage the tracker knows (an
elementwise ``torch._foreach_*`` call: the matching entry's), else (a
factory call inside a loop over positions: ``torch.arange`` for a
position's rotary angles) the position the thread's last storage took
(``untagged`` counts those). A storage placed that last way is a guess:
an input placed otherwise wins over it (autograd adds a gradient into
zeros it made from nothing).

The same pass counts the step's operations (``flops``) as
``torch.utils.flop_counter.FlopCounterMode`` counts them, by its
``flop_registry`` of aten ops, without a second mode's dispatch.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

ROUND = 512                 # the caching allocator's block granularity

_TLS = threading.local()


class at:
    """``with at(pos):`` the tensors made in the block belong to mesh
    position ``pos``."""

    __slots__ = ("pos", "prev")

    def __init__(self, pos: int):
        self.pos = pos

    def __enter__(self):
        self.prev = getattr(_TLS, "pos", None)
        _TLS.pos = self.pos

    def __exit__(self, *exc):
        _TLS.pos = self.prev


def position() -> Optional[int]:
    """The position ``at`` sets on the calling thread, None outside it."""
    return getattr(_TLS, "pos", None)


def rounded(nbytes: int) -> int:
    """``nbytes`` as the caching allocator reserves them: 0 for an empty
    storage, else a multiple of ``ROUND``."""
    return -(-nbytes // ROUND) * ROUND


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in ``tree``: a tensor, or lists, tuples and dicts of
    them (an aten op's arguments and results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class MemoryTracker(TorchDispatchMode):
    """Live and peak bytes of each of ``positions`` mesh positions while the
    mode is active. ``add_arguments`` registers a step's arguments first;
    after the step, ``report(outputs)`` gives each position's figures."""

    def __init__(self, positions: int):
        super().__init__()
        self.positions = positions
        self.live = [0] * positions
        self.peak = [0] * positions
        self.arguments = [0] * positions
        self.total_live = self.total_peak = 0   # all positions together
        self.untagged = 0
        self.flops = 0
        self._last = threading.local()         # a thread's last position
        self._where: Dict[int, int] = {}       # id(storage) -> position
        self._args: set = set()                # the arguments' storages
        self._guessed: set = set()             # placed by the last position
        # reentrant: a finalizer may run inside the mode's own bookkeeping
        self._lock = threading.RLock()

    # -- bookkeeping --------------------------------------------------------
    def _placed(self, inputs) -> Tuple[Optional[int], bool]:
        """(the first of ``inputs``' known positions, not a guess where one
        is; whether it is a guess)."""
        guess = None
        for t in inputs:
            if not isinstance(t, torch.Tensor):
                continue
            key = id(t.untyped_storage())
            pos = self._where.get(key)
            if pos is None:
                continue
            if key not in self._guessed:
                return pos, False
            if guess is None:
                guess = pos
        return guess, guess is not None

    def _add(self, storage, pos: int) -> int:
        key = id(storage)
        nbytes = rounded(storage.nbytes())
        self._where[key] = pos
        self.live[pos] += nbytes
        self.peak[pos] = max(self.peak[pos], self.live[pos])
        self.total_live += nbytes
        self.total_peak = max(self.total_peak, self.total_live)
        weakref.finalize(storage, self._free, key, pos, nbytes)
        return nbytes

    def _free(self, key: int, pos: int, nbytes: int) -> None:
        with self._lock:
            if self._where.pop(key, None) is not None:
                self._guessed.discard(key)
                self.live[pos] -= nbytes
                self.total_live -= nbytes

    def add_arguments(self, parts_by_position: Dict[int, List[torch.Tensor]]
                      ) -> None:
        """Register each position's argument tensors: their storages count
        as that position's arguments (each storage once)."""
        with self._lock:
            for pos, ts in parts_by_position.items():
                for t in ts:
                    st = t.untyped_storage()
                    if id(st) not in self._where:
                        self.arguments[pos] += self._add(st, pos)
                        self._args.add(id(st))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            with self._lock:
                self.flops += n
        outs = _tensors(out)
        if not outs:
            return out
        with self._lock:
            forced = position()
            inputs = _tensors(kwargs, _tensors(args))
            seen = {id(t.untyped_storage()) for t in inputs}
            lists = [a for a in args if isinstance(a, (list, tuple))]
            per_entry = isinstance(out, (list, tuple)) and lists and all(
                len(a) == len(out) for a in lists)
            for i, t in enumerate(outs):
                if t.device.type == "meta":
                    continue            # a shape probe: nothing is held
                st = t.untyped_storage()
                if id(st) in self._where or id(st) in seen:
                    continue            # a view, in place, or an input's
                pos, guessed = forced, False
                if pos is None:
                    pos, guessed = self._placed(
                        [a[i] for a in lists] if per_entry else inputs)
                if pos is None:
                    pos, guessed = getattr(self._last, "pos", 0), True
                    self.untagged += 1
                self._last.pos = pos
                self._add(st, pos)
                if guessed:
                    self._guessed.add(id(st))
        return out

    # -- results ------------------------------------------------------------
    def report(self, outputs: Any = None) -> Dict[str, Any]:
        """Each position's bytes (``argument``, ``output``: the new storages
        ``outputs`` holds, ``peak``: the most live at once, arguments
        included, ``temp`` = peak - argument) and the position with the
        highest peak (``position``) with its figures in GB, the reference's
        keys; ``all_positions_peak_gb`` is the most all positions held at
        once, what one card holding every position would need."""
        out_bytes = [0] * self.positions
        with self._lock:
            done = set()
            for t in _tensors(outputs):
                st = t.untyped_storage()
                pos = self._where.get(id(st))
                if (pos is not None and id(st) not in done
                        and id(st) not in self._args):
                    done.add(id(st))
                    out_bytes[pos] += rounded(st.nbytes())
            peak = list(self.peak)
        top = max(range(self.positions), key=lambda p: (peak[p], -p))
        return {
            "position": top,
            "argument_gb": self.arguments[top] / 1e9,
            "output_gb": out_bytes[top] / 1e9,
            "temp_gb": (peak[top] - self.arguments[top]) / 1e9,
            "peak_gb": peak[top] / 1e9,
            "all_positions_peak_gb": self.total_peak / 1e9,
            "per_position_bytes": {
                "argument": list(self.arguments), "output": out_bytes,
                "peak": peak},
            "untagged_allocations": self.untagged,
        }
