"""Reading the weight files the benchmark serves, with their sha256 checked:
a flax ``parameters.msgpack`` (msgpack maps keyed by strings, arrays as
ext type 1 and numpy scalars as ext type 3, each payload the msgpack triple
``(shape, dtype name, C-order buffer)``) and a pickled int8 graph (a dict of
numpy arrays and Python scalars).  Plain Python and numpy."""

from __future__ import annotations

import hashlib
import os
import pickle
import struct
from typing import Any, Dict

import numpy as np


def checked_bytes(root: str, spec: Dict[str, str]) -> bytes:
    """The bytes of ``spec["path"]`` under ``root``; raises unless their
    sha256 is ``spec["sha256"]``."""
    with open(os.path.join(root, spec["path"]), "rb") as f:
        data = f.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{spec['path']}: sha256 {digest}, the configuration pins "
                         f"{spec['sha256']}")
    return data


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sized = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
                 0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
                 0xDC: ("list", ">H"), 0xDD: ("list", ">I"), 0xDE: ("map", ">H"),
                 0xDF: ("map", ">I"), 0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"),
                 0xC9: ("ext", ">I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return bytes(self.take(n)).decode()
            if kind == "list":
                return [self.value() for _ in range(n)]
            return self.map(n) if kind == "map" else self.ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = _Reader(bytes(self.take(n)))
        shape, dtype, buf = payload.value()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        if code == 1:
            return arr
        if code == 3:
            return arr.reshape(())[()]
        raise ValueError(f"unsupported msgpack ext type {code}")


def flax_tree(root: str, spec: Dict[str, str]) -> Dict[str, Any]:
    """The variable tree of a flax msgpack file (``params``, ``batch_stats``)."""
    return _Reader(checked_bytes(root, spec)).value()


def int8_graph(root: str, spec: Dict[str, str]) -> Dict[str, Any]:
    """The int8 graph dict, 0-d leaves as Python scalars."""
    def scalars(v):
        if isinstance(v, dict):
            return {k: scalars(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(scalars(x) for x in v)
        return v.item() if getattr(v, "ndim", None) == 0 else v

    return scalars(pickle.loads(checked_bytes(root, spec)))  # a file this repo pins by hash
