"""Codec negotiation for on-disk blobs (forest snapshots).

A copy of the JAX package's ``compression.py``, with the same tags, so that
a blob written by either package reads in the other. ``zstandard`` is an
optional wheel: when present it is preferred (better ratio and speed),
otherwise stdlib ``zlib`` is used. Every blob written through
:func:`compress` carries a one-byte codec tag so a reader on a machine
*without* zstd can still refuse a zstd blob with a clear error instead of
garbage, and vice versa. Legacy tag-less zstd blobs (written before the flag
byte existed) are recognized by the zstd frame magic.
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


def compress(data: bytes, level: int = 3) -> bytes:
    """Compress with the best available codec; output is tagged."""
    if _zstd is not None:
        return TAG_ZSTD + _zstd.ZstdCompressor(level=level).compress(data)
    return TAG_ZLIB + zlib.compress(data, level)


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
