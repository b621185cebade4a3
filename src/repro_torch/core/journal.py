"""Write-ahead journal + durable exactly-once write path.

Counterpart of the JAX package's ``core/journal.py``, with the same frames,
records and snapshots: a store written by either package opens in the other.

The serve loop's lifecycle writes (``ingest_batch``, ``delete_session``,
``migrate_merge``, ``compact_tree``) are record-then-apply: every op is
framed into an append-only journal — WITH a client-supplied idempotency key
— before it touches the Forest. Durability story:

  * **crash mid-op**: the in-memory forest is gone either way; recovery is
    latest snapshot + replay of the journal tail. A record appended but
    never applied replays once; an op that crashed before its append was
    never acknowledged and the client retries it.
  * **duplicated webhook delivery**: a key already in ``forest.applied_ops``
    (persisted inside every snapshot) is skipped before it reaches the
    journal — replayed deliveries are exactly-once end to end.
  * **snapshot + tail**: ``checkpoint()`` writes an atomic snapshot tagged
    with the journal sequence watermark (via the LATEST-marker commit
    protocol of runtime/checkpoint.py), then rotates the journal; replay
    applies only records past the watermark whose key is unapplied.

Journal format: back-to-back frames, each ``<u32 body_len, u32 crc32>`` +
msgpack body ``{seq, op, key, payload}`` (``core/codec.py``). A torn tail
frame (crash mid-append) fails its length or CRC check and cleanly ends
replay; recovery then truncates the file to its valid prefix, so frames
appended after the crash never sit behind garbage bytes.

Fault injection: a :class:`repro_torch.runtime.fault_tolerance.CrashInjector`
passed as ``crash=`` gets a ``tick()`` at every durability transition, so a
sweep can kill the "process" at every boundary and check that recovered
state is digest-identical to an uninterrupted run.

The store is not thread-safe by itself. Under a background
``MaintenancePlane`` the plane's worker appends merges and compactions, so
every other call on the store holds ``plane.lock`` too.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core import codec, maintenance, persistence
from repro_torch.core.types import Session, Turn
from repro_torch.device import resolve_device
from repro_torch.obs import Observability, get_obs
from repro_torch.runtime import checkpoint as ckpt

_FRAME_HEADER = struct.Struct("<II")          # (body_len, crc32)
JOURNAL_NAME = "journal.waj"
SNAPSHOT_FMT = "snapshot_{:08d}.mfz"


# ---------------------------------------------------------------------------
# framed append-only journal
# ---------------------------------------------------------------------------
class JournalWriter:
    """Append-only framed record log. ``fsync=True`` makes every append a
    durability point (webhook-ack semantics); ``fsync=False`` leaves
    flush-to-OS group commit (a crash can lose the tail but never tear the
    exactly-once contract, because unacked ops are retried by the client
    and deduped by key)."""

    def __init__(self, path: str, *, fsync: bool = True,
                 obs: Optional[Observability] = None):
        self.path = path
        self.fsync = fsync
        self.obs = get_obs(obs)
        self._m_appends = self.obs.registry.counter("journal/appends")
        self._m_bytes = self.obs.registry.counter("journal/appended_bytes")
        existed = os.path.exists(path)
        self._f = open(path, "ab")
        if fsync and not existed:
            # a fresh journal's directory entry must be durable too, or the
            # first acked append can vanish with the file on power loss
            ckpt.fsync_dir(os.path.dirname(os.path.abspath(path)))

    @property
    def appends(self) -> int:
        return self._m_appends.value

    def append(self, record: Dict[str, Any]) -> None:
        body = codec.packb(record)
        with self.obs.span("journal.append",
                           bytes=_FRAME_HEADER.size + len(body)):
            self._f.write(_FRAME_HEADER.pack(len(body), zlib.crc32(body)))
            self._f.write(body)
            self._f.flush()
            if self.fsync:
                with self.obs.span("journal.fsync"):
                    os.fsync(self._f.fileno())
        self._m_appends.inc()
        self._m_bytes.inc(_FRAME_HEADER.size + len(body))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def scan_journal(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """(complete records, byte length of the valid prefix). A torn/corrupt
    tail frame ends the scan; recovery truncates the file to the returned
    offset so new appends never land after garbage bytes."""
    if not os.path.exists(path):
        return [], 0
    out: List[Dict[str, Any]] = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + _FRAME_HEADER.size <= len(data):
        length, crc = _FRAME_HEADER.unpack_from(data, pos)
        body = data[pos + _FRAME_HEADER.size: pos + _FRAME_HEADER.size + length]
        if len(body) < length or zlib.crc32(body) != crc:
            break                                   # torn tail
        out.append(codec.unpackb(body))
        pos += _FRAME_HEADER.size + length
    return out, pos


def read_journal(path: str) -> List[Dict[str, Any]]:
    """All complete records; a torn/corrupt tail frame ends the scan."""
    return scan_journal(path)[0]


# ---------------------------------------------------------------------------
# op payload (de)serialization
# ---------------------------------------------------------------------------
def _session_rec(s: Session) -> Dict[str, Any]:
    return {"id": s.session_id, "ts": s.ts,
            "turns": [[t.role, t.text, t.ts, t.turn_id] for t in s.turns]}


def _session_from(rec: Dict[str, Any]) -> Session:
    return Session(rec["id"],
                   [Turn(role=r, text=x, ts=ts, turn_id=tid)
                    for r, x, ts, tid in rec["turns"]],
                   ts=rec["ts"])


# ---------------------------------------------------------------------------
# durable store
# ---------------------------------------------------------------------------
class DurableMemForest:
    """Durability shell around a :class:`MemForestSystem`.

    Directory layout::

        <root>/journal.waj             append-only op log (rotated)
        <root>/snapshot_<seq>.mfz      atomic forest snapshots
        <root>/LATEST                  current-snapshot marker

    Open an existing store (or a fresh directory) with :meth:`open` — it
    performs snapshot + journal-tail recovery. ``snapshot_every=N`` takes an
    automatic checkpoint after every N applied ops (0 = manual only).
    """

    def __init__(self, system, root_dir: str, *, fsync: bool = True,
                 snapshot_every: int = 0, crash=None, keep_snapshots: int = 2,
                 _next_seq: int = 1, obs: Optional[Observability] = None):
        self.system = system
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.crash = crash
        self.snapshot_every = snapshot_every
        self.keep_snapshots = keep_snapshots
        self._seq = _next_seq
        # share the wrapped system's observability handle unless given one,
        # so journal/* metrics and span histograms land in the same registry
        # the forest/flush instrumentation reports to
        self.obs = obs if obs is not None else get_obs(
            getattr(system, "obs", None))
        self.writer = JournalWriter(os.path.join(root_dir, JOURNAL_NAME),
                                    fsync=fsync, obs=self.obs)
        self._m_commits = self.obs.registry.counter("journal/commits")
        self._m_checkpoints = self.obs.registry.counter("journal/checkpoints")
        self.ops_applied = 0
        self.duplicates_skipped = 0
        self.ops_replayed = 0
        self.snapshots_taken = 0
        self._ops_since_snapshot = 0

    # -- plumbing ----------------------------------------------------------
    @property
    def forest(self):
        return self.system.forest

    def _tick(self, event: str) -> None:
        if self.crash is not None:
            self.crash.tick(event)

    def _already_applied(self, key: Optional[str]) -> bool:
        if key is not None and key in self.forest.applied_ops:
            self.duplicates_skipped += 1
            return True
        return False

    def _record(self, op: str, key: Optional[str], payload: Dict[str, Any]) -> str:
        """Append the intent frame; returns the (possibly auto) key."""
        seq = self._seq
        self._seq += 1
        if key is None:
            # auto keys are unique, so they never dedup client retries —
            # they exist so replay bookkeeping is uniform for callers that
            # did not supply one
            key = f"auto:{op}:{seq}"
        self._tick(f"submit:{op}")
        self.writer.append({"seq": seq, "op": op, "key": key,
                            "payload": payload})
        self._tick("journal:append")
        return key

    def _committed(self, key: str) -> None:
        self.forest.applied_ops.add(key)
        self.ops_applied += 1
        self._m_commits.inc()
        self._ops_since_snapshot += 1
        self.obs.event("journal.commit", key=key)
        self._tick("apply")
        if self.snapshot_every and self._ops_since_snapshot >= self.snapshot_every:
            self.checkpoint()

    # -- the durable write path -------------------------------------------
    def ingest_batch(self, sessions: Iterable[Session], *,
                     idempotency_key: Optional[str] = None,
                     defer_flush: bool = False):
        """Journaled, exactly-once ``MemForestSystem.ingest_batch``. Returns
        the per-session WriteStats, or None when the key was already
        applied (duplicate delivery)."""
        sessions = list(sessions)
        if self._already_applied(idempotency_key):
            return None
        key = self._record("ingest_batch", idempotency_key,
                           {"sessions": [_session_rec(s) for s in sessions]})
        stats = self.system.ingest_batch(sessions, defer_flush=defer_flush)
        self._committed(key)
        return stats

    def delete_session(self, session_id: str, *,
                       idempotency_key: Optional[str] = None,
                       flush: bool = True):
        """Journaled, exactly-once targeted deletion."""
        if self._already_applied(idempotency_key):
            return None
        key = self._record("delete_session", idempotency_key,
                           {"session_id": session_id})
        out = maintenance.delete_session(self.forest, session_id, flush=flush)
        self._committed(key)
        return out

    def merge_from(self, other, *, idempotency_key: Optional[str] = None,
                   flush: bool = True):
        """Journaled, exactly-once migration merge. ``other`` is a
        MemForestSystem or a bare Forest; its full state rides in the
        journal record, so replay reproduces the merge byte-identically
        even if the source forest is gone by recovery time."""
        if self._already_applied(idempotency_key):
            return None
        src = getattr(other, "forest", other)
        doc_z = persistence.doc_to_bytes(
            persistence.forest_to_doc(src, with_derived=True))
        key = self._record("migrate_merge", idempotency_key,
                           {"forest_doc_z": doc_z})
        out = maintenance.migrate_merge(self.forest, src, flush=flush)
        self._committed(key)
        return out

    def compact_tree(self, scope_key: str, *,
                     idempotency_key: Optional[str] = None):
        """Journaled tombstone compaction. Compaction rewrites persistent
        state (the tree and its placement rows), so it rides the journal
        like any other lifecycle write; the rebuild is deterministic, so
        replay reproduces it exactly."""
        if self._already_applied(idempotency_key):
            return None
        key = self._record("compact_tree", idempotency_key,
                           {"scope_key": scope_key})
        out = maintenance.compact_tree(self.forest, scope_key)
        self._committed(key)
        return out

    # -- replay ------------------------------------------------------------
    def _apply_record(self, rec: Dict[str, Any]) -> None:
        op, payload = rec["op"], rec["payload"]
        if op == "ingest_batch":
            self.system.ingest_batch(
                [_session_from(r) for r in payload["sessions"]])
        elif op == "delete_session":
            maintenance.delete_session(self.forest, payload["session_id"])
        elif op == "migrate_merge":
            src = persistence.forest_from_doc(
                persistence.bytes_to_doc(payload["forest_doc_z"]),
                device=self.forest.device)
            maintenance.migrate_merge(self.forest, src)
        elif op == "compact_tree":
            maintenance.compact_tree(self.forest, payload["scope_key"])
        else:
            raise ValueError(f"unknown journal op {op!r}")
        self.forest.applied_ops.add(rec["key"])
        self.ops_replayed += 1

    # -- snapshot + rotation ----------------------------------------------
    def checkpoint(self, *, residency: Optional[Dict[str, Any]] = None) -> str:
        """Snapshot current state (tagged with the journal watermark), move
        the LATEST marker, rotate the journal. Crash-safe at every step:
        the snapshot write is tmp+rename-atomic, the marker flips last, and
        un-rotated journal records are filtered by the watermark on
        replay. ``residency`` rides in the snapshot's ``extra`` (the
        demotion record :meth:`demote` writes), which the state digest
        excludes."""
        with self.obs.span("journal.checkpoint",
                           watermark=self._seq - 1):
            return self._checkpoint(residency=residency)

    def _checkpoint(self, *, residency: Optional[Dict[str, Any]] = None) -> str:
        self._tick("snapshot:begin")
        watermark = self._seq - 1
        name = SNAPSHOT_FMT.format(watermark)
        extra: Dict[str, Any] = {"journal_seq": watermark}
        if residency is not None:
            extra["residency"] = residency
        persistence.save_forest(self.forest, os.path.join(self.root, name),
                                extra=extra)
        ckpt.write_latest(self.root, name)
        self._tick("snapshot:commit")
        # rotate: atomically replace the journal with an empty file — every
        # framed record is <= the watermark now
        self.writer.close()
        jpath = os.path.join(self.root, JOURNAL_NAME)
        tmp = jpath + ".tmp"
        with open(tmp, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, jpath)
        ckpt.fsync_dir(self.root)
        self.writer = JournalWriter(jpath, fsync=self.writer.fsync,
                                    obs=self.obs)
        self._tick("journal:rotate")
        # GC old snapshots (keep the newest keep_snapshots; the one the
        # LATEST marker points at is always kept)
        snaps = sorted(n for n in os.listdir(self.root)
                       if n.startswith("snapshot_") and n.endswith(".mfz"))
        for n in snaps[:max(0, len(snaps) - self.keep_snapshots)]:
            if n != name:
                os.remove(os.path.join(self.root, n))
        self.snapshots_taken += 1
        self._m_checkpoints.inc()
        self._ops_since_snapshot = 0
        return name

    def demote(self) -> Tuple[str, int]:
        """Demotion as a **checkpoint-class** durable event: snapshot (with a
        residency record in the doc's ``extra``) + rotate, then free the
        device caches — the fact and root indexes and the node arena
        (``Forest.detach_device``). Returns (snapshot name, device bytes
        freed). Not a journal op: a demote interrupted at any boundary
        recovers digest-identical and is safely retried whole. Rehydration
        afterwards is exactly :meth:`open`, or the next query on this store
        (the caches re-upload from host state)."""
        self._tick("demote:begin")
        name = self.checkpoint(residency={"demoted": True,
                                          "journal_seq": self._seq - 1})
        freed = self.forest.detach_device()
        self._tick("demote:commit")
        return name, freed

    def close(self) -> None:
        self.writer.close()

    def __enter__(self) -> "DurableMemForest":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- recovery ----------------------------------------------------------
    @classmethod
    def open(cls, root_dir: str, *, config=None, encoder=None, device=None,
             fsync: bool = True, snapshot_every: int = 0, crash=None,
             keep_snapshots: int = 2,
             obs: Optional[Observability] = None) -> "DurableMemForest":
        """Crash-safe restore on ``device`` (None: the CUDA card): latest
        snapshot (if any) + journal-tail replay. Records at or below the
        snapshot watermark, or whose idempotency key the snapshot already
        carries, are skipped — duplicated or crash-replayed ops apply
        exactly once."""
        from repro_torch.core.memforest import MemForestSystem

        dev = resolve_device(device)
        os.makedirs(root_dir, exist_ok=True)
        watermark = 0
        name = ckpt.read_latest(root_dir)
        snap_path = os.path.join(root_dir, name) if name else None
        if snap_path and os.path.exists(snap_path):
            doc = persistence.read_doc(snap_path)
            forest = persistence.forest_from_doc(doc, config, device=dev)
            watermark = int(doc.get("extra", {}).get("journal_seq", 0))
            system = MemForestSystem(forest.config, encoder, device=dev,
                                     obs=obs)
            system.adopt(forest)
        else:
            system = MemForestSystem(config, encoder, device=dev, obs=obs)

        jpath = os.path.join(root_dir, JOURNAL_NAME)
        records, valid_len = scan_journal(jpath)
        if os.path.exists(jpath) and os.path.getsize(jpath) > valid_len:
            # crash mid-append left a torn tail frame. It MUST be cut before
            # the writer reopens in append mode: frames written after the
            # garbage would be fsync-acked yet unreachable
            with open(jpath, "rb+") as f:
                f.truncate(valid_len)
                f.flush()
                os.fsync(f.fileno())
        next_seq = max([watermark] + [r["seq"] for r in records]) + 1
        store = cls(system, root_dir, fsync=fsync,
                    snapshot_every=snapshot_every, crash=crash,
                    keep_snapshots=keep_snapshots, _next_seq=next_seq,
                    obs=obs)
        for rec in records:
            if rec["seq"] <= watermark:
                continue
            if rec["key"] in store.forest.applied_ops:
                continue
            store._apply_record(rec)
        return store

    # everything else (query, query_batch, scale_stats, save, ...) is
    # read-only or derived-state work — delegate to the wrapped system
    def __getattr__(self, item):
        return getattr(self.system, item)
