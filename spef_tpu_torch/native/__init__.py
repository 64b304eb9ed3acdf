"""The native host code: the JPEG / PNG loader and the yaw-rotation warp.

Counterpart of ``spef_tpu.native`` (``build``, ``load_library``,
``load_batch``, ``available``), over the port's own copy of
``impreproc.cpp``.  ``g++`` builds it on first use into
``build/native/libimpreproc-<hash>.so`` at the repo root, the hash over the
source, the flags and the host's CPU model (``-march=native`` builds for
that CPU alone); JAX's flags plus ``-ffp-contract=off``, so that the float
resize gives the same bytes on any host (no fused multiply-adds).

Unlike the JAX wrapper, nothing here falls back silently:

  * :func:`missing` names what the build needs and this host lacks (g++,
    ``jpeglib.h``, ``png.h``, ``libjpeg``, ``libpng``); :func:`build` and
    :func:`load_library` raise with that list, and :func:`available` is
    true only where it is empty;
  * :func:`load_batch` raises ``IOError`` naming every file that failed to
    decode.

:func:`resize_bilinear_plain` is the numpy twin of the C++
``resize_bilinear``, in float32 with the same order of operations, so the
native resize can be held against it on a machine without JAX.

``warp.cpp`` is the host warp of ``data/augment_host.py`` (OpenCV 5.0's
``warpPerspective`` arithmetic with explicit FMAs), which needs g++ alone:
:func:`build_warp`, :func:`warp_available`, :func:`warp_perspective`; its
numpy twin is ``augment_host.warp_perspective_plain``.

Nothing is probed, built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["SOURCE", "WARP_SOURCE", "BUILD_DIR", "FLAGS", "missing", "available", "require",
           "build", "load_library", "load_batch", "resize_bilinear_plain", "warp_available",
           "build_warp", "warp_perspective"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "impreproc.cpp")
WARP_SOURCE = os.path.join(_DIR, "warp.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
_HEADERS = ("jpeglib.h", "png.h")
_LIBRARIES = (("libjpeg", "libjpeg.so"), ("libpng", "libpng.so"))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_warp_lib: Optional[ctypes.CDLL] = None


def _gxx() -> Optional[str]:
    return shutil.which("g++")


def _has_header(gxx: str, header: str) -> bool:
    """Whether ``g++`` finds ``header`` (``jpeglib.h`` needs ``<cstdio>``
    first, as the source includes it)."""
    src = f"#include <cstdio>\n#include <{header}>\n"
    proc = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull], input=src,
                          capture_output=True, text=True)
    return proc.returncode == 0


def _has_library(gxx: str, filename: str) -> bool:
    """Whether the linker finds ``filename`` (``-l`` links ``lib<x>.so``):
    ``-print-file-name`` prints a path only for a file it found."""
    proc = subprocess.run([gxx, f"-print-file-name={filename}"], capture_output=True, text=True)
    return os.path.isabs(proc.stdout.strip())


@functools.lru_cache(maxsize=None)
def missing() -> Tuple[str, ...]:
    """What the native loader needs and this host lacks, by name (empty
    where it can be built): ``g++``, the ``jpeglib.h`` / ``png.h`` headers,
    the ``libjpeg`` / ``libpng`` libraries."""
    gxx = _gxx()
    if gxx is None:
        return ("g++",) + _HEADERS + tuple(name for name, _ in _LIBRARIES)
    return tuple([h for h in _HEADERS if not _has_header(gxx, h)]
                 + [name for name, f in _LIBRARIES if not _has_library(gxx, f)])


def available() -> bool:
    """True where g++, the headers and the libraries are all present."""
    return not missing()


def require() -> None:
    """Raise, naming what is missing, where the loader cannot be built."""
    lacking = missing()
    if lacking:
        raise RuntimeError("the native JPEG / PNG loader cannot be built on this host: missing "
                           + ", ".join(lacking) + " (install g++ and the libjpeg / libpng "
                           "development packages)")


def _cpu_model() -> str:
    """The CPU's model name (``/proc/cpuinfo``), else the platform's."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + " " + platform.processor()


def _compile(source: str, libs: Sequence[str]) -> str:
    """``g++`` of ``source`` into ``build/native/lib<name>-<hash>.so`` (the
    hash over the source, the flags and the CPU model), unless it is built;
    its path."""
    name = os.path.splitext(os.path.basename(source))[0]
    with open(source, "rb") as f:
        key = f.read() + " ".join(FLAGS + tuple(libs) + (_cpu_model(),)).encode()
    digest = hashlib.sha1(key).hexdigest()[:12]
    target = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_gxx(), *FLAGS, source, "-o", tmp, *libs], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: a concurrent build or load sees old or new, never half
    return target


def build() -> str:
    """Compile the loader if it is not built yet; returns its path.
    Raises, naming what is missing, where the toolchain is incomplete."""
    require()
    return _compile(SOURCE, LIBS)


def load_library() -> ctypes.CDLL:
    """The built library, loaded once a process, its C ABI declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.spef_load_batch.restype = ctypes.c_int
            lib.spef_load_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.spef_load_image.restype = ctypes.c_int
            lib.spef_load_image.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
        return _lib


def load_batch(paths: Sequence[str], out_h: int, out_w: int, n_threads: int = 0) -> np.ndarray:
    """Decode and resize ``paths`` (JPEG or PNG, told apart by their bytes)
    into an ``(N, out_h, out_w, 3)`` uint8 RGB batch, on ``n_threads``
    threads (0: one a core).  Raises ``IOError`` naming the files that
    failed."""
    lib = load_library()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    encoded = [os.fsencode(p) for p in paths]
    c_paths = (ctypes.c_char_p * n)(*encoded)
    ok = lib.spef_load_batch(c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             out_h, out_w, n_threads)
    if ok != n:
        probe = np.empty((out_h, out_w, 3), np.uint8)
        ptr = probe.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        failed = [p for p, e in zip(paths, encoded) if lib.spef_load_image(e, ptr, out_h,
                                                                            out_w) != 1]
        raise IOError(f"native loader: {n - ok} of {n} images failed to decode: {failed}")
    return out


def warp_available() -> bool:
    """True where g++ is present (the warp links no library)."""
    return _gxx() is not None


def build_warp() -> str:
    """Compile the warp if it is not built yet; returns its path.  Raises
    where g++ is missing."""
    if not warp_available():
        raise RuntimeError("the native warp cannot be built on this host: missing g++")
    return _compile(WARP_SOURCE, ())


def _load_warp() -> ctypes.CDLL:
    global _warp_lib
    with _lock:
        if _warp_lib is None:
            lib = ctypes.CDLL(build_warp())
            u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.spef_warp_perspective.restype = None
            lib.spef_warp_perspective.argtypes = [
                u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            _warp_lib = lib
        return _warp_lib


def warp_perspective(image: np.ndarray, minv: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``warp.cpp`` on an (H, W) or (H, W, C) uint8 image: each output pixel
    samples ``image`` at ``minv @ (x, y, 1)`` (``minv`` the 3x3 inverse map,
    cast to float32 here)."""
    lib = _load_warp()
    src = np.ascontiguousarray(image, np.uint8)
    h, w = src.shape[:2]
    c = src.shape[2] if src.ndim == 3 else 1
    out = np.empty((out_h, out_w) + src.shape[2:], np.uint8)
    m = np.ascontiguousarray(minv, np.float32).reshape(9)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.spef_warp_perspective(src.ctypes.data_as(u8), h, w, c, out.ctypes.data_as(u8), out_h,
                              out_w, m.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def resize_bilinear_plain(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The C++ ``resize_bilinear`` in numpy: ``(H, W, 3)`` uint8 ->
    ``(out_h, out_w, 3)`` uint8, float32 throughout, each operation of the
    source in its order and rounded to float32 (no fused multiply-add)."""
    f32 = np.float32
    sh, sw = image.shape[:2]

    def axis(n_out: int, n_src: int):
        scale = f32(n_src) / f32(n_out)
        f = (np.arange(n_out, dtype=f32) + f32(0.5)) * scale - f32(0.5)
        i0 = np.minimum(np.maximum(f, f32(0)).astype(np.int64), n_src - 1)
        i1 = np.minimum(i0 + 1, n_src - 1)
        d = f - i0.astype(f32)
        return i0, i1, np.where(d < 0, f32(0), d).astype(f32)

    y0, y1, dy = axis(out_h, sh)
    x0, x1, dx = axis(out_w, sw)
    src = image.astype(f32)
    dx = dx[None, :, None]
    dy = dy[:, None, None]
    one = f32(1)
    top = src[y0][:, x0] * (one - dx) + src[y0][:, x1] * dx
    bot = src[y1][:, x0] * (one - dx) + src[y1][:, x1] * dx
    v = top * (one - dy) + bot * dy
    return (v + f32(0.5)).astype(np.uint8)
