"""PNG files and the bilinear resize of the data path, in numpy and ``zlib``.

The port's counterpart of what the JAX package leaves to PIL and OpenCV:

  * :func:`decode_png` reads 8-bit gray, gray + alpha, RGB and RGBA PNGs
    (not interlaced), undoes all five row filters and returns RGB, as
    ``PIL.Image.open(...).convert("RGB")`` does (alpha dropped, gray
    repeated).  Rows filtered with None, Sub or Up are undone a row at a
    time; Average and Paeth need the pixel to their left, so an image that
    holds such rows is undone over anti-diagonals (pixel ``(r, c)`` needs
    only ``(r, c-1)``, ``(r-1, c)`` and ``(r-1, c-1)``): ``H + W - 1``
    vector steps in place of ``H * W`` scalar ones.
  * :func:`write_png` takes the BGR array that ``render_frame`` gives and
    stores it as RGB, as ``cv2.imwrite`` does.  Every row is filtered with
    None: the files are not byte-identical to OpenCV's, their pixels are.
  * :func:`resize_bilinear` is ``PIL.Image.resize(size, Image.BILINEAR)``
    on uint8 RGB: PIL's separable triangle filter, widened by the scale
    factor where it shrinks, fixed-point coefficients of 22 bits, the
    horizontal pass first and a uint8 clip between the passes.  A resize to
    the same size is a copy.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

__all__ = ["decode_png", "read_png", "encode_png", "write_png", "resize_bilinear"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel (gray, RGB, gray+A, RGBA)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND chunk)")


def _unfilter_rows(raw: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """None / Sub / Up rows, one row at a time (uint8 arithmetic wraps mod 256)."""
    h, stride = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        row = raw[r]
        if kinds[r] == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kinds[r] == 2:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_wavefront(raw: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Any mix of the five filters, over the anti-diagonals of the pixel grid.

    The grid is held skewed, ``y[r + 1, r + c + 2] = x[r, c]``, so that one
    anti-diagonal ``d = r + c`` is a column: its left neighbours are column
    ``d + 1`` of the same rows, the ones above column ``d + 1`` of the rows
    above, the ones above-left column ``d``.  Cells left of a row's start
    stay zero, as PNG's edges are; cells past its end are never read by a
    pixel of the image."""
    h, stride = raw.shape
    w = stride // bpp
    src = np.zeros((h, h + w, bpp), np.int32)
    rows = np.arange(h)[:, None] + np.arange(w)[None, :]
    src[np.arange(h)[:, None], rows] = raw.reshape(h, w, bpp)
    y = np.zeros((h + 1, h + w + 2, bpp), np.int32)
    k = kinds.astype(np.int32)[:, None]
    m_sub, m_up, m_avg, m_paeth = (k == 1), (k == 2), (k == 3), (k == 4)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        left, up, ul = y[r0 + 1:r1 + 1, d + 1], y[r0:r1, d + 1], y[r0:r1, d]
        pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = (m_sub[r0:r1] * left + m_up[r0:r1] * up + m_avg[r0:r1] * ((left + up) >> 1)
                + m_paeth[r0:r1] * paeth)
        y[r0 + 1:r1 + 1, d + 2] = (src[r0:r1, d] + pred) & 0xFF
    out = y[np.arange(1, h + 1)[:, None], rows + 2]
    return out.astype(np.uint8).reshape(h, stride)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W, 3)`` uint8 RGB."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} (8-bit gray, RGB and RGBA, not interlaced)")
    bpp = _CHANNELS[colour]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {h * (stride + 1)} expected")
    raw = raw.reshape(h, stride + 1)
    kinds, rows = raw[:, 0], raw[:, 1:]
    if kinds.max() > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} (0-4 exist)")
    if (kinds >= 3).any():
        pix = _unfilter_wavefront(rows, kinds, bpp)
    else:
        pix = _unfilter_rows(rows, kinds, bpp)
    pix = pix.reshape(h, w, bpp)
    if bpp <= 2:  # gray (+ alpha): repeat the gray sample
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(rgb: np.ndarray) -> bytes:
    """``(H, W, 3)`` uint8 RGB -> PNG bytes (8-bit RGB, filter None, zlib
    level 1: the noisy frames hardly compress at any level, and level 1
    spends the least time on them)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, w * 3 + 1), np.uint8)
    rows[:, 1:] = rgb.reshape(h, -1)
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def write_png(path: str, bgr: np.ndarray) -> None:
    """Store a BGR frame as an RGB PNG, as ``cv2.imwrite`` does."""
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(bgr[..., ::-1])))


# ---------------------------------------------------------------------------
# PIL's BILINEAR resize
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), fixed-point weights (out, ksize)) of one
    axis, as PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``."""
    scale = in_size / out_size
    filterscale = max(1.0, scale)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    w = np.abs(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where((w < 1.0) & (taps[None, :] < xmax[:, None]), 1.0 - w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # in tap order, as PIL sums them
        ww += w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * float(1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0: rows, 1: columns) of ``(H, W, C)``."""
    in_size = img.shape[axis]
    xmin, kk = _coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)  # (out, ksize) in place of the axis
    if axis == 0:
        acc = np.einsum("okwc,ok->owc", src, kk)
    else:
        acc = np.einsum("hokc,ok->hoc", src, kk)
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``(H, W, C)`` uint8 -> ``(h, w, C)`` as ``PIL.Image.resize((w, h), BILINEAR)``."""
    h, w = size
    out = img
    if w != img.shape[1]:
        out = _pass(out, w, axis=1)
    if h != img.shape[0]:
        out = _pass(out, h, axis=0)
    return out.copy() if out is img else out
