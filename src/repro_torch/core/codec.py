"""The msgpack subset the port's documents use: snapshots, journal records and
the state digest.

    packb(obj) -> bytes        the bytes of msgpack.packb(obj, use_bin_type=True)
    unpackb(data) -> obj       what msgpack.unpackb(data, raw=False) returns

Covered types: ``None``, ``bool``, ``int`` (-2**63 .. 2**64 - 1), ``float``
(always float64), ``str`` (UTF-8, ``str8/16/32``), ``bytes``
(``bin8/16/32``), ``list`` and ``tuple`` (decoded as lists) and ``dict`` (in
iteration order; decoded keys must be ``str`` or ``bytes``), each of exactly
that type: a subclass (a numpy scalar among them) raises ``TypeError``.
Every value is written in its smallest form, as msgpack writes it. The bytes
must be msgpack's exactly: the state digest is a SHA-256 over them and the
journal's frames are CRC'd over them, so a snapshot or a journal written by
either package reads in the other and digests equal. The port keeps its own
codec so that it needs no package beyond PyTorch and numpy.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------
_BYTE = [bytes((i,)) for i in range(256)]     # one-byte forms, by value


def _pack_int(x: int, out: List[bytes]) -> None:
    if x >= 0:
        if x < 0x80:
            out.append(_BYTE[x])
        elif x < 0x100:
            out.append(b"\xcc" + _BYTE[x])
        elif x < 0x10000:
            out.append(b"\xcd" + _H.pack(x))
        elif x < 0x100000000:
            out.append(b"\xce" + _I.pack(x))
        elif x < 0x10000000000000000:
            out.append(b"\xcf" + _Q.pack(x))
        else:
            raise OverflowError(f"integer {x} does not fit in 64 bits")
    elif x >= -32:
        out.append(_BYTE[x & 0xff])                  # negative fixint
    elif x >= -0x80:
        out.append(b"\xd0" + _b.pack(x))
    elif x >= -0x8000:
        out.append(b"\xd1" + _h.pack(x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + _i.pack(x))
    elif x >= -0x8000000000000000:
        out.append(b"\xd3" + _q.pack(x))
    else:
        raise OverflowError(f"integer {x} does not fit in 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, tags: bytes,
              out: List[bytes]) -> None:
    """Header of a str, bin, array or map of length ``n``: a fix form below
    ``fix_max`` (when ``fix`` is given), then 8-, 16- or 32-bit lengths from
    ``tags`` (bin and str have an 8-bit form, array and map do not)."""
    if fix >= 0 and n < fix_max:
        out.append(_BYTE[fix | n])
    elif tags[0] and n < 0x100:
        out.append(bytes((tags[0], n)))
    elif n < 0x10000:
        out.append(bytes((tags[1],)) + _H.pack(n))
    elif n < 0x100000000:
        out.append(bytes((tags[2],)) + _I.pack(n))
    else:
        raise ValueError(f"length {n} is too large for msgpack")


def _pack_str(s: str, out: List[bytes]) -> None:
    data = s.encode("utf-8")
    n = len(data)
    if n < 32:
        out.append(_BYTE[0xa0 | n])
    elif n < 0x100:
        out.append(b"\xd9" + _BYTE[n])
    else:
        _pack_len(n, -1, 0, b"\x00\xda\xdb", out)
    out.append(data)


def _pack(obj: Any, out: List[bytes]) -> None:
    t = type(obj)
    if t is int:
        _pack_int(obj, out)
    elif t is str:
        _pack_str(obj, out)
    elif t is float:
        out.append(b"\xcb" + _d.pack(obj))
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif t is list or t is tuple:
        _pack_len(len(obj), 0x90, 16, b"\x00\xdc\xdd", out)
        for v in obj:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(obj), 0x80, 16, b"\x00\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif t is bytes:
        _pack_len(len(obj), -1, 0, b"\xc4\xc5\xc6", out)
        out.append(obj)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoding: each reader takes (data, position) and returns (value, next
# position)
# ---------------------------------------------------------------------------
def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    end = pos + n
    if end > len(data):
        raise ValueError("truncated msgpack data")
    return data[pos:end], end


def _array(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    append = out.append
    for _ in range(n):
        tag = data[pos]
        if tag < 0x80:                             # the common element
            append(tag)
            pos += 1
        else:
            v, pos = _unpack(data, pos)
            append(v)
    return out, pos


def _map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        if type(k) is not str and type(k) is not bytes:
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k], pos = _unpack(data, pos)
    return out, pos


def _num(s: struct.Struct, data: bytes, pos: int) -> Tuple[Any, int]:
    if pos + s.size > len(data):
        raise ValueError("truncated msgpack data")
    return s.unpack_from(data, pos)[0], pos + s.size


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    tag = data[pos]
    pos += 1
    if tag < 0x80:
        return tag, pos
    if tag >= 0xe0:
        return tag - 0x100, pos
    if tag < 0x90:
        return _map(data, pos, tag & 0x0f)
    if tag < 0xa0:
        return _array(data, pos, tag & 0x0f)
    if tag < 0xc0:
        raw, pos = _take(data, pos, tag & 0x1f)
        return raw.decode("utf-8"), pos
    if tag == 0xc0:
        return None, pos
    if tag == 0xc2:
        return False, pos
    if tag == 0xc3:
        return True, pos
    kind = _SIZED.get(tag)
    if kind is not None:                           # str, bin, array, map
        length, read = kind
        n, pos = _num(length, data, pos)
        if read is _array or read is _map:
            return read(data, pos, n)
        raw, pos = _take(data, pos, n)
        return (raw.decode("utf-8") if read is str else raw), pos
    s = _NUMBERS.get(tag)
    if s is None:
        raise ValueError(f"unsupported msgpack type 0x{tag:02x}")
    return _num(s, data, pos)


# tag -> (struct of the length, what follows) for the sized types
_SIZED = {0xc4: (_B, bytes), 0xc5: (_H, bytes), 0xc6: (_I, bytes),
          0xd9: (_B, str), 0xda: (_H, str), 0xdb: (_I, str),
          0xdc: (_H, _array), 0xdd: (_I, _array),
          0xde: (_H, _map), 0xdf: (_I, _map)}
# tag -> struct of the number that follows
_NUMBERS = {0xcb: _d, 0xcc: _B, 0xcd: _H, 0xce: _I, 0xcf: _Q,
            0xd0: _b, 0xd1: _h, 0xd2: _i, 0xd3: _q}


def unpackb(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the covered types."""
    data = bytes(data)
    try:
        obj, pos = _unpack(data, 0)
    except IndexError:
        raise ValueError("truncated msgpack data") from None
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data after the "
                         "msgpack value")
    return obj
