"""Sharded checkpoints of the train state with an atomic two-phase commit,
and the LATEST-marker protocol they share with the memory substrate's
snapshot + journal store (``core/journal.py``).

A copy of the JAX package's ``runtime/checkpoint.py``, in its on-disk
format, so a checkpoint written by either package restores in the other::

    <dir>/step_<N>.tmp/...   (write phase)
    <dir>/step_<N>/
        manifest.json        (step, extra, process index and count, and per
                             leaf its path, shard, dtype and shape)
        shard_<i>.bin        (compressed msgpack of up to 64 (path, bytes,
                             dtype, shape) tuples; ``compression.py``'s
                             tagged zstd or zlib)

Commit = fsync the files -> atomic rename of the directory -> fsync the
parent (the rename itself must be durable) -> update LATEST. A crash
mid-write leaves only a ``.tmp`` directory, which ``restore`` ignores.

The port's trees are dicts of tensors whose layers are a list, so its paths
read ``params/layers/0/attn/wq`` where the reference's stacked tree reads
``params/layers/attn/wq`` with a leading layer axis: a dict tree without
lists (a state of numpy arrays, say) has the same paths in both. Leaves are
written as their bytes: a bf16 tensor crosses as the reference's bf16 bytes
(dtype ``bfloat16``). msgpack goes through the port's own codec
(``core/codec.py``).

A state placed on a model mesh (leaves ``launch.sharding.Sharded``) is
written leaf by leaf as each leaf's whole tensor, gathered straight to the
host, so its directory is byte for byte the one ``save`` writes of the
gathered state: it restores unsharded, or onto any mesh. ``restore`` places
each leaf from the host tensor: by the ``Sharded`` leaves of ``state_like``,
or by ``shardings`` (``train_state_shardings`` of a mesh) beside a tree of
``meta`` specs (``train_state_specs``), so that no whole leaf is ever made on
a card. Onto another mesh shape the ZeRO-1 moments and the error state take
that mesh's ``zero1_shardings``: the elastic restart that
``fault_tolerance.ElasticScaler.replan`` plans.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import compression
from repro_torch.core import codec
from repro_torch.launch.sharding import (NamedSharding, Sharded, _spec_leaves,
                                         gather, place)
from repro_torch.tree import leaves_with_paths, path_str, unflatten

_LEAVES_PER_SHARD = 64
# threads that compress a shard's chunks and decompress the shards
_WORKERS = min(8, os.cpu_count() or 1)


def fsync_dir(dir_path: str) -> None:
    """fsync a directory so a just-committed rename survives power loss —
    os.replace alone orders the data, not the directory entry. Best-effort
    on platforms whose directory fds reject fsync."""
    try:
        fd = os.open(dir_path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_latest(dir_path: str, name: str) -> None:
    """Atomically point <dir>/LATEST at `name` (fsync'd tmp + rename +
    directory fsync)."""
    tmp = os.path.join(dir_path, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(dir_path, "LATEST"))
    fsync_dir(dir_path)


def read_latest(dir_path: str) -> Optional[str]:
    """Name the LATEST marker points at, or None when absent."""
    marker = os.path.join(dir_path, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return f.read().strip()


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Step of the checkpoint directory ``step_<N>`` the marker points at;
    when that one is torn (no manifest), the newest complete one."""
    name = read_latest(ckpt_dir)
    if name is None:
        return None
    path = os.path.join(ckpt_dir, name)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        # torn checkpoint: fall back to newest complete one
        for d in sorted(os.listdir(ckpt_dir), reverse=True):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                return int(d.split("_")[1])
        return None
    return int(name.split("_")[1])


def _leaf_record(path: str, leaf) -> Tuple[str, bytes, str, List[int]]:
    """(path, raw bytes, dtype name, shape) of a tensor or array leaf; a
    ``Sharded`` leaf's whole tensor, gathered to the host."""
    if isinstance(leaf, Sharded):
        leaf = gather(leaf, device="cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return (path, t.view(torch.int16).numpy().tobytes(), "bfloat16",
                    list(t.shape))
        arr = t.numpy()
    else:
        arr = np.ascontiguousarray(np.asarray(leaf))
    return path, arr.tobytes(), str(arr.dtype), [int(n) for n in arr.shape]


def _read_shard(dirname: str, fname: str):
    with open(os.path.join(dirname, fname), "rb") as f:
        return codec.unpackb(compression.decompress(f.read()))


def _leaf_tensor(data: bytes, dtype: str, shape: List[int]) -> torch.Tensor:
    if dtype == "bfloat16":
        raw = np.frombuffer(data, dtype=np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(data, dtype=dtype).copy()
                            ).reshape(shape)


def save(ckpt_dir: str, step: int, state: Any, *,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write ``state`` (a tree of tensors, arrays or ``Sharded``) as
    ``step_<step>``, commit it, point LATEST at it and keep the newest
    ``keep`` checkpoints. Returns the committed directory. The leaves are
    read one at a time in flattening order; each shard compresses on
    several threads (``compression.compress``'s ``pool``)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest: Dict[str, Any] = {
        "step": step,
        "extra": extra or {},
        "process_index": 0,
        "num_processes": 1,
        "leaves": [],
    }
    shard_idx = 0
    buf: List[Tuple[str, bytes, str, List[int]]] = []
    pool = ThreadPoolExecutor(_WORKERS)

    def flush_shard():
        nonlocal shard_idx, buf
        if not buf:
            return
        payload = codec.packb(list(buf))
        fname = f"shard_{shard_idx:04d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(compression.compress(payload, pool=pool))
            f.flush()
            os.fsync(f.fileno())
        for p, _d, dt, sh in buf:
            manifest["leaves"].append({"path": p, "shard": fname,
                                       "dtype": dt, "shape": sh})
        shard_idx += 1
        buf = []

    with pool:
        for path, leaf in leaves_with_paths(state):
            buf.append(_leaf_record(path_str(path), leaf))
            if len(buf) >= _LEAVES_PER_SHARD:
                flush_shard()
        flush_shard()

    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    fsync_dir(ckpt_dir)
    write_latest(ckpt_dir, os.path.basename(final))

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def restore(ckpt_dir: str, state_like: Any, step: Optional[int] = None, *,
            shardings: Any = None) -> Tuple[Any, Dict]:
    """(state, extra): the checkpoint at ``step`` (default: LATEST, or the
    newest complete one when LATEST's is torn) in the structure of
    ``state_like``. Each leaf takes the ``state_like`` leaf's dtype and
    device; a numpy leaf gives a CPU tensor. A ``Sharded`` leaf comes back
    ``Sharded`` on its mesh by its spec, placed from the host tensor.
    ``shardings``: a tree of ``NamedSharding``s of the same structure (say
    ``train_state_shardings(mesh, specs, cfg)``), each leaf placed by its
    own; ``state_like`` may then hold ``meta`` specs
    (``train_state_specs``). Without ``shardings`` a ``meta`` leaf has no
    device to put data on and is refused."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    by_path: Dict[str, Tuple[bytes, str, List[int]]] = {}
    names = sorted({e["shard"] for e in manifest["leaves"]})
    with ThreadPoolExecutor(_WORKERS) as pool:
        for payload in pool.map(lambda n: _read_shard(path, n), names):
            for p, data, dt, sh in payload:
                by_path[p] = (data, dt, sh)

    pairs = leaves_with_paths(state_like)
    places = ([None] * len(pairs) if shardings is None
              else _spec_leaves(shardings))
    if len(places) != len(pairs):
        raise ValueError(f"restore: {len(places)} shardings for "
                         f"{len(pairs)} leaves")
    out = []
    for (keypath, leaf), sh in zip(pairs, places):
        t = _leaf_tensor(*by_path[path_str(keypath)])
        if isinstance(leaf, Sharded):
            sh = NamedSharding(leaf.mesh, leaf.spec)
        if sh is not None:
            if isinstance(leaf, (torch.Tensor, Sharded)):
                t = t.to(leaf.dtype)
            t = place(t, sh.mesh, sh.spec)
        elif isinstance(leaf, torch.Tensor):
            if leaf.device.type == "meta":
                raise ValueError(f"restore: {path_str(keypath)} is a meta "
                                 "tensor; restore into a state on a device "
                                 "or pass its shardings")
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        out.append(t)
    return unflatten(state_like, out), manifest["extra"]
