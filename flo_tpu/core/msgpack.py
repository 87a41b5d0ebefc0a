"""MessagePack for the types flo metadata uses.

``packb`` writes what ``msgpack.packb(obj, use_bin_type=True,
use_single_float=True)`` writes, byte for byte: the smallest integer form
(unsigned forms for non-negative values), float32 floats, str8 strings, bin
for bytes, and maps in insertion order. ``unpackb`` reads every MessagePack
type as ``msgpack.unpackb(data, raw=False, strict_map_key=False)`` does,
with extension types returned as :class:`ExtType`. Malformed input raises
``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np

#: Nesting depth past which input is refused rather than recursed into.
MAX_DEPTH = 512


class ExtType(NamedTuple):
    code: int
    data: bytes


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        out += struct.pack("b" if x < 0 else "B", x)
    elif x >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < top:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise OverflowError("int too big to pack")
    else:
        for tag, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                 (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if x >= bottom:
                out.append(tag)
                out += struct.pack(fmt, x)
                return
        raise OverflowError("int too small to pack")


def _pack_len(n: int, fix_tag: int | None, fix_max: int, tags: tuple, out: bytearray) -> None:
    """Length header: a fix form up to ``fix_max``, then 8-, 16- and 32-bit
    forms (``tags`` lists the ones the type has, None where it has none)."""
    if fix_tag is not None and n <= fix_max:
        out.append(fix_tag | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError("object too large to pack")


def _pack(obj: Any, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise ValueError("nesting too deep to pack")
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCA)
        with np.errstate(over="ignore"):
            out += np.asarray(obj, dtype=">f4").tobytes()
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out, depth + 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out, depth + 1)
            _pack(value, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


_FIXED = {  # tag -> (struct format, size) for fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("Unpack failed: incomplete input")
        chunk = self.data[self.pos : end]
        self.pos = end
        return chunk

    def length(self, size: int) -> int:
        return struct.unpack(_LEN[size], self.take(size))[0]

    def read(self, depth: int) -> Any:
        if depth > MAX_DEPTH:
            raise ValueError("nesting too deep to unpack")
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F, depth)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F, depth)
        if 0xA0 <= tag <= 0xBF:
            return self.take(tag & 0x1F).decode("utf-8")
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in _FIXED:
            fmt, size = _FIXED[tag]
            return struct.unpack(fmt, self.take(size))[0]
        if 0xC4 <= tag <= 0xC6:
            return self.take(self.length(1 << (tag - 0xC4)))
        if 0xD9 <= tag <= 0xDB:
            return self.take(self.length(1 << (tag - 0xD9))).decode("utf-8")
        if tag in (0xDC, 0xDD):
            return self.array(self.length(2 if tag == 0xDC else 4), depth)
        if tag in (0xDE, 0xDF):
            return self.map(self.length(2 if tag == 0xDE else 4), depth)
        if tag in _FIXEXT or 0xC7 <= tag <= 0xC9:
            n = _FIXEXT[tag] if tag in _FIXEXT else self.length(1 << (tag - 0xC7))
            code = struct.unpack(">b", self.take(1))[0]
            return ExtType(code, self.take(n))
        raise ValueError(f"Unpack failed: invalid type byte 0x{tag:02x}")

    def array(self, n: int, depth: int) -> list:
        return [self.read(depth + 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read(depth + 1)
            if isinstance(key, list):
                raise ValueError("list is not allowed for map key")
            out[key] = self.read(depth + 1)
        return out


def unpackb(data: bytes) -> Any:
    reader = _Reader(bytes(data))
    obj = reader.read(0)
    if reader.pos != len(reader.data):
        raise ValueError("Unpack failed: extra data")
    return obj
