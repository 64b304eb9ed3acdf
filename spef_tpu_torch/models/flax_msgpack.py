"""Read and write flax ``parameters.msgpack`` checkpoints without flax or msgpack.

``flax.serialization.to_bytes`` writes the variable tree as msgpack maps
keyed by strings, with every array as msgpack ext type 1 (``ndarray``) and
numpy scalars as ext type 3 (``npscalar``).  Both payloads are themselves
msgpack: the array ``(shape, dtype name, C-order buffer)``.  The reader
decodes the whole format's scalar, string, binary, array, map and ext types,
returning nested dicts of numpy arrays; the writer emits the subset
``to_bytes`` does (maps with string keys, arrays, numpy scalars, and the
Python numbers, strings and bytes inside their payloads), with the same
encodings msgpack picks, so that flax reads the file back.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

__all__ = ["read_flax_msgpack", "unpackb", "packb", "write_flax_msgpack"]

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


def _pack_uint(n: int, small: int, codes) -> bytes:
    """An unsigned length or value in the smallest of msgpack's widths:
    ``small`` is the fix-form limit, ``codes`` the 8/16/32-bit type bytes
    (None where the form does not exist)."""
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                                 (0xD2, ">i", 0x80000000), (0xD3, ">q", 0x8000000000000000)):
            if -n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: integer {n} out of range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fix[n]]) if n in fix else _pack_uint(n, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _pack_array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject:
        raise ValueError("msgpack: object arrays are not serializable")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def packb(value: Any) -> bytes:
    """Encode one value as ``flax.serialization.to_bytes`` does (through
    ``msgpack.packb(..., use_bin_type=True)``)."""
    if value is None:
        return b"\xc0"
    if isinstance(value, (bool, np.bool_)) and not isinstance(value, np.ndarray):
        if isinstance(value, np.bool_):
            return _pack_ext(_EXT_NPSCALAR, _pack_array_payload(np.asarray(value)))
        return b"\xc3" if value else b"\xc2"
    if isinstance(value, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _pack_array_payload(value))
    if isinstance(value, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_array_payload(np.asarray(value)))
    if isinstance(value, int):
        return _pack_int(value)
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, str):
        raw = value.encode("utf-8")
        head = (bytes([0xA0 | len(raw)]) if len(raw) < 32
                else _pack_uint(len(raw), -1, (0xD9, 0xDA, 0xDB)))
        return head + raw
    if isinstance(value, (bytes, bytearray)):
        return _pack_uint(len(value), -1, (0xC4, 0xC5, 0xC6)) + bytes(value)
    if isinstance(value, (list, tuple)):
        head = (bytes([0x90 | len(value)]) if len(value) < 16
                else _pack_uint(len(value), -1, (None, 0xDC, 0xDD)))
        return head + b"".join(packb(v) for v in value)
    if isinstance(value, dict):
        head = (bytes([0x80 | len(value)]) if len(value) < 16
                else _pack_uint(len(value), -1, (None, 0xDE, 0xDF)))
        return head + b"".join(packb(str(k)) + packb(v) for k, v in value.items())
    raise TypeError(f"msgpack: cannot serialize {type(value).__name__}")


def write_flax_msgpack(path: str, tree: Dict[str, Any]) -> str:
    """Write a variable tree (nested dicts of numpy arrays) as flax would."""
    with open(path, "wb") as f:
        f.write(packb(tree))
    return path
