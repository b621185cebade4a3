"""Codec negotiation for on-disk blobs (forest snapshots).

A copy of the JAX package's ``compression.py``, with the same tags, so that
a blob written by either package reads in the other. ``zstandard`` is an
optional wheel: when present it is preferred (better ratio and speed),
otherwise stdlib ``zlib`` is used. Every blob written through
:func:`compress` carries a one-byte codec tag so a reader on a machine
*without* zstd can still refuse a zstd blob with a clear error instead of
garbage, and vice versa. Legacy tag-less zstd blobs (written before the flag
byte existed) are recognized by the zstd frame magic. :func:`compress` can
spread zlib's work over threads, for checkpoints' shards.
"""
from __future__ import annotations

import zlib

try:
    import zstandard as _zstd
except ImportError:          # optional dependency
    _zstd = None

TAG_ZSTD = b"\x01"
TAG_ZLIB = b"\x02"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

HAVE_ZSTD = _zstd is not None


_CHUNK = 16 << 20


def compress(data: bytes, level: int = 3, pool=None) -> bytes:
    """Compress with the best available codec; output is tagged. zlib's
    stream is written in 16 MiB chunks, each deflated alone and ended by a
    full flush (the last by the stream's end), behind one zlib header and
    the Adler-32 of all of ``data``: up to 16 MiB it is
    ``zlib.compress``'s stream byte for byte, and past it still one stream
    that ``zlib.decompress`` reads. With ``pool`` (a
    ``concurrent.futures`` executor; zlib releases the GIL) the chunks
    deflate on its threads."""
    if _zstd is not None:
        return TAG_ZSTD + _zstd.ZstdCompressor(level=level).compress(data)
    view = memoryview(data)
    starts = list(range(0, len(view), _CHUNK)) or [0]

    def chunk(i):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        last = i == len(starts) - 1
        return c.compress(view[starts[i]:starts[i] + _CHUNK]) + c.flush(
            zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)

    body = b"".join((map if pool is None else pool.map)(
        chunk, range(len(starts))))
    head = zlib.compress(b"", level)[:2]
    return TAG_ZLIB + head + body + zlib.adler32(view).to_bytes(4, "big")


def decompress(blob: bytes) -> bytes:
    if blob[:1] == TAG_ZLIB:
        return zlib.decompress(blob[1:])
    if blob[:1] == TAG_ZSTD:
        body = blob[1:]
    elif blob[:4] == _ZSTD_MAGIC:   # legacy: untagged zstd frame
        body = blob
    else:
        raise ValueError("unrecognized compression tag in blob")
    if _zstd is None:
        raise ModuleNotFoundError(
            "blob was written with zstandard, which is not installed; "
            "install the 'zstandard' wheel to read it")
    return _zstd.ZstdDecompressor().decompress(body)
