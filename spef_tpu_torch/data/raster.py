"""OpenCV's anti-aliased line and filled circle, in plain Python.

``spef_tpu.data.synthetic.render_frame`` draws with ``cv2.line`` and
``cv2.circle`` (``lineType=cv2.LINE_AA``); the machine with the card has no
OpenCV, and the port's calibration frames must equal the JAX package's bit
for bit.  This module reproduces OpenCV's 8-bit 3-channel drawing
(``imgproc/src/drawing.cpp``) in the same fixed-point arithmetic
(16 fractional bits):

  * ``LineAA``: the Wu-style three-pixel anti-aliased line with its filter
    and slope-correction tables and end-point corrections, clipped to the
    image (``clipLine``);
  * ``ThickLine``: a line thicker than one pixel is first clipped to the
    image grown by the thickness on every side, then drawn as a convex
    quadrilateral plus a filled round cap at each end;
  * ``EllipseEx`` / ``ellipse2Poly``: a filled circle is a convex polygon
    of points on the circle (the sine table, a step of 5 to 90 degrees by
    radius), filled by ``FillConvexPoly``, whose edges are ``LineAA`` lines.

Each blend of a colour ``c`` into a pixel ``p`` with weight ``a`` is
OpenCV's ``p += ((c - p) * a + 127) >> 8`` applied twice.  The image is a
``bytearray`` of ``h * w * 3`` bytes, row-major, while it is drawn.
"""

from __future__ import annotations

import math
import struct
from typing import List, Sequence, Tuple

__all__ = ["Canvas"]

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

_SLOPE_CORR = (
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
    203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254,
)
_FILTER = (
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5,
)


def _f32(v: float) -> float:
    """A float rounded to single precision (the sine table is float)."""
    return struct.unpack("f", struct.pack("f", v))[0]


# sin(i degrees), i = 0..450, as OpenCV tabulates it: 7 decimals, in float.
_SIN = tuple(_f32(float(f"{math.sin(math.radians(i)):.7f}")) for i in range(451))


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _round(v: float) -> int:
    """cvRound: nearest, ties to even."""
    return round(v)


class Canvas:
    """An ``h x w`` 8-bit 3-channel image being drawn on."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.buf = bytearray(h * w * 3)

    # -- pixels ----------------------------------------------------------
    def _blend(self, x: int, y: int, color: Sequence[int], a: int) -> None:
        o = (y * self.w + x) * 3
        buf = self.buf
        for ch in range(3):
            c = color[ch]
            v = buf[o + ch]
            v += ((c - v) * a + 127) >> 8
            v += ((c - v) * a + 127) >> 8
            buf[o + ch] = v

    def _hline(self, y: int, x1: int, x2: int, color: Sequence[int]) -> None:
        o = (y * self.w + x1) * 3
        self.buf[o:o + (x2 - x1 + 1) * 3] = bytes(color) * (x2 - x1 + 1)

    # -- clipLine ----------------------------------------------------------
    @staticmethod
    def _clip(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
        right, bottom = width - 1, height - 1
        if width <= 0 or height <= 0:
            return None

        def code(x, y):
            return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

        c1, c2 = code(x1, y1), code(x2, y2)
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1 & 12:
                a = 0 if c1 < 8 else bottom
                x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
                y1 = a
                c1 = (x1 < 0) + (x1 > right) * 2
            if c2 & 12:
                a = 0 if c2 < 8 else bottom
                x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
                y2 = a
                c2 = (x2 < 0) + (x2 > right) * 2
            if (c1 & c2) == 0 and (c1 | c2) != 0:
                if c1:
                    a = 0 if c1 == 1 else right
                    y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                    x1 = a
                    c1 = 0
                if c2:
                    a = 0 if c2 == 1 else right
                    y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                    x2 = a
                    c2 = 0
        if c1 | c2:
            return None
        return x1, y1, x2, y2

    # -- LineAA ------------------------------------------------------------
    def line_aa(self, p1: Tuple[int, int], p2: Tuple[int, int], color: Sequence[int]) -> None:
        """An anti-aliased line between fixed-point points (16 fraction bits)."""
        clipped = self._clip(self.w << XY_SHIFT, self.h << XY_SHIFT, *p1, *p2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
        dx, dy = x2 - x1, y2 - y1
        j = -1 if dx < 0 else 0
        ax = (dx ^ j) - j
        i = -1 if dy < 0 else 0
        ay = (dy ^ i) - i

        if ax > ay:
            dy = (dy ^ j) - j
            if j:  # swap the end points
                x1, x2, y1, y2 = x2, x1, y2, y1
            x_step = XY_ONE
            y_step = _tdiv(dy << XY_SHIFT, ax | 1)
            x2 += XY_ONE
            ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
            j = -(x1 & (XY_ONE - 1))
            y1 += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1)
            slope = (y_step >> (XY_SHIFT - 5)) & 0x3F
            slope ^= 0x3F if y_step < 0 else 0
            i = (x1 >> (XY_SHIFT - 7)) & 0x78
            j = (x2 >> (XY_SHIFT - 7)) & 0x78
        else:
            dx = (dx ^ i) - i
            if i:
                x1, x2, y1, y2 = x2, x1, y2, y1
            x_step = _tdiv(dx << XY_SHIFT, ay | 1)
            y_step = XY_ONE
            y2 += XY_ONE
            ecount = (y2 >> XY_SHIFT) - (y1 >> XY_SHIFT)
            j = -(y1 & (XY_ONE - 1))
            x1 += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1)
            slope = (x_step >> (XY_SHIFT - 5)) & 0x3F
            slope ^= 0x3F if x_step < 0 else 0
            i = (y1 >> (XY_SHIFT - 7)) & 0x78
            j = (y2 >> (XY_SHIFT - 7)) & 0x78

        slope = 0x100 if slope & 0x20 else _SLOPE_CORR[slope]
        # End-point correction table.
        t0 = slope << 7
        t1 = ((0x78 - i) | 4) * slope
        t2 = (j | 4) * slope
        ep = [0] * 9
        ep[8] = slope
        ep[1] = ep[3] = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
        ep[2] = (t1 >> 8) & 0x1FF
        ep[4] = ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF
        ep[5] = ((t1 + t0) >> 8) & 0x1FF
        ep[6] = (t2 >> 8) & 0x1FF
        ep[7] = ((t2 + t0) >> 8) & 0x1FF

        w, h = self.w, self.h
        scount = 0
        if ax > ay:
            x = x1 >> XY_SHIFT
            while ecount >= 0:
                if 0 <= x < w:
                    y = (y1 >> XY_SHIFT) - 1
                    ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                                 + (((ecount >= 2) + 1) & (ecount | 2))]
                    dist = (y1 >> (XY_SHIFT - 5)) & 31
                    for k, f in ((0, _FILTER[dist + 32]), (1, _FILTER[dist]),
                                 (2, _FILTER[63 - dist])):
                        if 0 <= y + k < h:
                            self._blend(x, y + k, color, (ep_corr * f >> 8) & 0xFF)
                x += 1
                y1 += y_step
                scount += 1
                ecount -= 1
        else:
            y = y1 >> XY_SHIFT
            while ecount >= 0:
                if 0 <= y < h:
                    x = (x1 >> XY_SHIFT) - 1
                    ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3
                                 + (((ecount >= 2) + 1) & (ecount | 2))]
                    dist = (x1 >> (XY_SHIFT - 5)) & 31
                    for k, f in ((0, _FILTER[dist + 32]), (1, _FILTER[dist]),
                                 (2, _FILTER[63 - dist])):
                        if 0 <= x + k < w:
                            self._blend(x + k, y, color, (ep_corr * f >> 8) & 0xFF)
                y += 1
                x1 += x_step
                scount += 1
                ecount -= 1

    # -- FillConvexPoly (anti-aliased, points at 16 fraction bits) ---------
    def fill_convex_poly(self, v: List[Tuple[int, int]], color: Sequence[int]) -> None:
        npts = len(v)
        delta = XY_ONE >> 1
        delta1, delta2 = XY_ONE - 1, 0
        p0 = v[-1]
        xmin = xmax = v[0][0]
        ymin = ymax = v[0][1]
        imin = 0
        for idx, p in enumerate(v):
            if p[1] < ymin:
                ymin, imin = p[1], idx
            ymax = max(ymax, p[1])
            xmax = max(xmax, p[0])
            xmin = min(xmin, p[0])
            self.line_aa(p0, p, color)
            p0 = p
        xmin = (xmin + delta) >> XY_SHIFT
        xmax = (xmax + delta) >> XY_SHIFT
        ymin = (ymin + delta) >> XY_SHIFT
        ymax = (ymax + delta) >> XY_SHIFT
        if npts < 3 or xmax < 0 or ymax < 0 or xmin >= self.w or ymin >= self.h:
            return
        ymax = min(ymax, self.h - 1)
        edges = npts
        # [idx, di, x, dx, ye] of the two edges
        edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
        y = ymin
        while True:
            if y < ymax or y == ymin:
                for e in edge:
                    if y >= e[4]:
                        idx0, di = e[0], e[1]
                        idx = idx0 + di
                        if idx >= npts:
                            idx -= npts
                        while True:
                            edges -= 1
                            if edges + 1 <= 0:
                                break
                            ty = (v[idx][1] + delta) >> XY_SHIFT
                            if ty > y:
                                xs, xe = v[idx0][0], v[idx][0]
                                e[4] = ty
                                e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                                e[2] = xs
                                e[0] = idx
                                break
                            idx0 = idx
                            idx += di
                            if idx >= npts:
                                idx -= npts
            if edges < 0:
                break
            if y >= 0:
                left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
                xx1 = (edge[left][2] + delta1) >> XY_SHIFT
                xx2 = (edge[right][2] + delta2) >> XY_SHIFT
                if xx2 >= 0 and xx1 < self.w:
                    self._hline(y, max(xx1, 0), min(xx2, self.w - 1), color)
            edge[0][2] += edge[0][3]
            edge[1][2] += edge[1][3]
            y += 1
            if y > ymax:
                break

    # -- EllipseEx (full, filled circles) ----------------------------------
    def _filled_circle_fixed(self, cx: int, cy: int, r: int, color: Sequence[int]) -> None:
        """A filled anti-aliased circle, center and radius at 16 fraction bits."""
        r = abs(r)
        delta = (r + (XY_ONE >> 1)) >> XY_SHIFT
        delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
        alpha, beta = _SIN[450], _SIN[0]  # cos and sin of the angle 0
        pts: List[Tuple[float, float]] = []
        for deg in range(0, 360 + delta, delta):
            ang = min(deg, 360)
            x = r * _SIN[450 - ang]
            y = r * _SIN[ang]
            pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
        if len(pts) == 1:
            pts = [(float(cx), float(cy))] * 2
        v: List[Tuple[int, int]] = []
        prev = None
        for px, py in pts:
            ix = _round(px / XY_ONE) << XY_SHIFT
            iy = _round(py / XY_ONE) << XY_SHIFT
            ix += _round(px - ix)
            iy += _round(py - iy)
            if (ix, iy) != prev:
                v.append((ix, iy))
                prev = (ix, iy)
        if len(v) == 1:
            v = [(cx, cy)] * 2
        self.fill_convex_poly(v, color)

    # -- the two calls render_frame makes ------------------------------------
    def line(self, pa: Tuple[int, int], pb: Tuple[int, int], color: Sequence[int],
             thickness: int) -> None:
        """``cv2.line(img, pa, pb, color, thickness, lineType=cv2.LINE_AA)``."""
        if thickness <= 1:
            self.line_aa((pa[0] << XY_SHIFT, pa[1] << XY_SHIFT),
                         (pb[0] << XY_SHIFT, pb[1] << XY_SHIFT), color)
            return
        t = thickness
        clipped = self._clip(self.w + 2 * t, self.h + 2 * t, pa[0] + t, pa[1] + t,
                             pb[0] + t, pb[1] + t)
        if clipped is None:
            return
        x0, y0, x1, y1 = ((c - t) << XY_SHIFT for c in clipped)
        dx = (x0 - x1) / XY_ONE
        dy = (y1 - y0) / XY_ONE
        r = dx * dx + dy * dy
        odd = thickness & 1
        half = thickness << (XY_SHIFT - 1)
        if abs(r) > 2.220446049250313e-16:
            r = (half + odd * XY_ONE * 0.5) / math.sqrt(r)
            dpx, dpy = _round(dy * r), _round(dx * r)
            self.fill_convex_poly([(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                   (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)], color)
        for cx, cy in ((x0, y0), (x1, y1)):
            self._filled_circle_fixed(cx, cy, half, color)

    def filled_circle(self, center: Tuple[int, int], radius: int, color: Sequence[int]) -> None:
        """``cv2.circle(img, center, radius, color, -1, lineType=cv2.LINE_AA)``."""
        self._filled_circle_fixed(center[0] << XY_SHIFT, center[1] << XY_SHIFT,
                                  radius << XY_SHIFT, color)
