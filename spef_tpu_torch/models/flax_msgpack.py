"""Read a flax ``parameters.msgpack`` checkpoint without flax or msgpack.

``flax.serialization.to_bytes`` writes the variable tree as msgpack maps
keyed by strings, with every array as msgpack ext type 1 (``ndarray``) and
numpy scalars as ext type 3 (``npscalar``).  Both payloads are themselves
msgpack: the array ``(shape, dtype name, C-order buffer)``.  This module
decodes exactly that subset of msgpack (the whole format's scalar, string,
binary, array, map and ext types), returning nested dicts of numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

__all__ = ["read_flax_msgpack", "unpackb"]

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:  # noqa: C901 - one branch per msgpack type byte
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = unpackb(payload)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr.copy() if code == _EXT_NDARRAY else arr.reshape(())[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack document (flax's ext types as numpy values)."""
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack document")
    return value


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """The variable tree of a flax msgpack file: nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a flax variable tree")
    return tree
