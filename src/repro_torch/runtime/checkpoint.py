"""The LATEST-marker commit protocol: a crash-safe "current checkpoint"
pointer, shared by the memory substrate's snapshot + journal store
(``core/journal.py``).

A copy of the marker helpers of the JAX package's ``runtime/checkpoint.py``.
The sharded pytree ``save`` and ``restore`` of model state come with
training (ROADMAP.md, queue 1, item 7).
"""
from __future__ import annotations

import os
from typing import Optional


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
