"""The port's msgpack codec (``repro_torch.core.codec``) against msgpack: the
bytes of ``packb`` equal ``msgpack.packb(obj, use_bin_type=True)`` and
``unpackb`` returns what ``msgpack.unpackb(data, raw=False)`` returns, on
the documents the port writes (a snapshot of the slice workload, a journal
record of each op, the state digest's document) and on generated values
over the covered types, with the boundaries of every size class."""
import hashlib
import math
import os

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch import MemForestSystem
from repro_torch.core import codec, persistence
from repro_torch.core.journal import JOURNAL_NAME, DurableMemForest
from repro_torch.core.journal import _FRAME_HEADER, read_journal
from repro_torch.data.synthetic import make_workload


def _same(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = codec.packb(obj)
    assert got == want
    assert _eq(codec.unpackb(want), msgpack.unpackb(want, raw=False))
    return got


def _eq(a, b):
    """Equal values, NaN equal to NaN, of the same types."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_eq, a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_eq(a[k], b[k]) for k in a)
    return a == b


# ---------------------------------------------------------------------------
# the documents the port writes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def slice_system():
    """The slice workload (``chip_smoke.py``'s: 500 sessions, 20,420 turns)
    ingested on the CPU, with one session deleted."""
    wl = make_workload(num_entities=16, num_sessions=500,
                       transitions_per_entity=4, distractor_turns=20,
                       num_queries=64, seed=0)
    mf = MemForestSystem(device="cpu")
    for i in range(0, len(wl.sessions), 64):
        mf.ingest_batch(wl.sessions[i:i + 64])
    mf.delete_session(wl.sessions[3].session_id)
    return mf, wl


def test_snapshot_document_of_the_slice(slice_system):
    mf, _ = slice_system
    doc = persistence.forest_to_doc(mf.forest, extra={"journal_seq": 7})
    data = _same(doc)
    assert len(data) > 20 * 2**20        # the embeddings ride as bin32
    assert persistence.bytes_to_doc(persistence.doc_to_bytes(doc)) == \
        msgpack.unpackb(data, raw=False)


def test_digest_document_of_the_slice(slice_system):
    mf, _ = slice_system
    doc = persistence.forest_to_doc(mf.forest, with_derived=False)
    doc.pop("extra")
    data = _same(doc)
    assert mf.state_digest() == hashlib.sha256(data).hexdigest()


def test_journal_record_of_each_op(tmp_path):
    """Every frame body of a journal holding each op — ingest, deletion,
    merge, compaction — is msgpack's encoding of its record."""
    wl = make_workload(num_entities=4, num_sessions=6,
                       transitions_per_entity=2, num_queries=2, seed=11)
    src = MemForestSystem(device="cpu")
    src.ingest_batch(make_workload(num_entities=3, num_sessions=2,
                                   transitions_per_entity=2, num_queries=1,
                                   seed=12).sessions)
    store = DurableMemForest(MemForestSystem(device="cpu"),
                             str(tmp_path / "s"))
    store.ingest_batch(wl.sessions, idempotency_key="i")
    store.delete_session(wl.sessions[0].session_id, idempotency_key="d")
    store.merge_from(src, idempotency_key="m")
    store.compact_tree(next(iter(store.forest.trees)))
    store.close()
    path = os.path.join(str(tmp_path / "s"), JOURNAL_NAME)
    with open(path, "rb") as f:
        data = f.read()
    recs, pos = read_journal(path), 0
    assert [r["op"] for r in recs] == ["ingest_batch", "delete_session",
                                       "migrate_merge", "compact_tree"]
    for rec in recs:
        length, _crc = _FRAME_HEADER.unpack_from(data, pos)
        body = data[pos + _FRAME_HEADER.size: pos + _FRAME_HEADER.size + length]
        assert _same(rec) == body
        assert msgpack.unpackb(body, raw=False) == rec
        pos += _FRAME_HEADER.size + length
    assert pos == len(data)
    # the merge's payload is itself a compressed document of the same codec
    merge_doc = persistence.bytes_to_doc(recs[2]["payload"]["forest_doc_z"])
    _same(merge_doc)


# ---------------------------------------------------------------------------
# every size class, at its boundaries
# ---------------------------------------------------------------------------
INTS = [0, 1, 31, 32, 127, 128, 255, 256, 2**16 - 1, 2**16, 2**32 - 1, 2**32,
        2**63 - 1, 2**63, 2**64 - 1, -1, -31, -32, -33, -127, -128, -129,
        -2**15, -2**15 - 1, -2**31, -2**31 - 1, -2**63]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 2**16 - 1, 2**16]


@pytest.mark.parametrize("x", INTS)
def test_integer_boundaries(x):
    _same(x)
    _same([x, -x if abs(x) < 2**63 else 0])


@pytest.mark.parametrize("n", LENGTHS)
def test_length_boundaries(n):
    _same("s" * n)
    _same("é" * (n // 2))                # length counts UTF-8 bytes
    _same(b"\x00" * n)
    _same(list(range(n)))
    _same(tuple(range(min(n, 300))))
    _same({f"k{i}": i for i in range(min(n, 2**16))})


def test_scalars_and_floats():
    for x in (None, True, False, 0.0, -0.0, 1.5, 1e300, -2.5e-300,
              float("inf"), float("-inf"), float("nan")):
        _same(x)


def test_refusals_match_msgpack():
    for bad in (object(), np.float32(1.0), np.int64(3), {1, 2}):
        with pytest.raises(TypeError):
            msgpack.packb(bad, use_bin_type=True)
        with pytest.raises(TypeError):
            codec.packb(bad)
    # subclasses of the covered types, which msgpack takes and no document
    # holds, are refused: the codec checks exact types
    for sub in (bytearray(b"\x01"), np.float64(0.25)):
        msgpack.packb(sub, use_bin_type=True)
        with pytest.raises(TypeError):
            codec.packb(sub)
    for big in (2**64, -2**63 - 1):
        with pytest.raises(OverflowError):
            codec.packb(big)
    data = msgpack.packb({"a": [1, 2, 3]}, use_bin_type=True)
    with pytest.raises(ValueError):
        codec.unpackb(data[:-1])              # truncated
    with pytest.raises(ValueError):
        codec.unpackb(data + b"\x00")         # extra data
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb({1: 2}))  # non-string map key


# ---------------------------------------------------------------------------
# generated values over the covered types
# ---------------------------------------------------------------------------
_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=True, allow_infinity=True)
            | st.text(max_size=300) | st.binary(max_size=300))
_values = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=20)
                   | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=40), inner,
                                     max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_generated_values(obj):
    _same(obj)
