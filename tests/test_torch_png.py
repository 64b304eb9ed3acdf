"""The port's PNG decoder, writer and bilinear resize (``data/png.py``)
against PIL and OpenCV.

  * Files written by ``cv2.imwrite`` (every row Sub) and by PIL (adaptive
    filters: with ``optimize`` and at several compression levels a random
    image's rows use all five filter types), in gray, gray + alpha, RGB and
    RGBA: decoded bit for bit as ``PIL.Image.open(...).convert("RGB")``.
  * The port's files: read back by PIL bit for bit, in RGB where the writer
    was given BGR (``cv2.imwrite``'s convention), and by OpenCV as the BGR
    array it was given.
  * ``resize_bilinear`` against ``PIL.Image.resize(..., BILINEAR)`` on
    random images, up and down and mixed: bit for bit (0 values differ).

Tolerance: none; every comparison is exact.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from spef_tpu_torch.data import png


def _images(seed):
    rs = np.random.RandomState(seed)
    for _ in range(6):
        h, w = rs.randint(1, 40), rs.randint(1, 60)
        noise = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        ramp = (np.add.outer(np.arange(h), np.arange(w))[..., None] * np.array([1, 2, 3])
                + rs.randint(0, 3, (h, w, 3))).astype(np.uint8)
        yield noise
        yield ramp


def _filters(data):
    """The row filter types a PNG file uses."""
    header = dict(png._chunks(data))[b"IHDR"]
    idat = b"".join(body for kind, body in png._chunks(data) if kind == b"IDAT")
    h = struct.unpack(">II", header[:8])[1]
    return set(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
def test_decode_pil_files_bit_for_bit(mode):
    seen = set()
    for i, img in enumerate(_images({"RGB": 0, "L": 1, "RGBA": 2, "LA": 3}[mode])):
        src = {"RGB": img, "L": img[..., 0], "RGBA": np.dstack([img, img[..., :1]]),
               "LA": np.dstack([img[..., 0], img[..., 1]])}[mode]
        for kw in ({}, {"optimize": True}, {"compress_level": 0}, {"compress_level": 9}):
            buf = io.BytesIO()
            Image.fromarray(src, mode).save(buf, "PNG", **kw)
            data = buf.getvalue()
            want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            got = png.decode_png(data)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
            seen |= _filters(data)
    if mode == "RGB":
        assert seen == {0, 1, 2, 3, 4}  # every filter type was decoded


def test_decode_cv2_files_bit_for_bit():
    for img in _images(7):
        ok, buf = cv2.imencode(".png", img)
        assert ok
        data = buf.tobytes()
        np.testing.assert_array_equal(png.decode_png(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        np.testing.assert_array_equal(png.decode_png(data), img[..., ::-1])  # BGR stored as RGB


def test_port_files_read_back_by_pil_and_cv2(tmp_path):
    for i, bgr in enumerate(_images(11)):
        path = str(tmp_path / f"f{i}.png")
        png.write_png(path, bgr)
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), bgr[..., ::-1])
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR), bgr)
        np.testing.assert_array_equal(png.read_png(path), bgr[..., ::-1])
        assert _filters(open(path, "rb").read()) == {0}


def test_decode_refuses_what_it_does_not_read():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")  # 16-bit gray
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"\xff\xd8\xff\xe0 a JPEG")
    good = png.encode_png(np.zeros((2, 3, 3), np.uint8))
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(good[:-12])


@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_pil_bilinear(seed):
    rs = np.random.RandomState(seed)
    for _ in range(12):
        h, w = rs.randint(2, 90), rs.randint(2, 90)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        oh, ow = rs.randint(1, 130), rs.randint(1, 130)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(png.resize_bilinear(img, (oh, ow)), want)
    # the data path's sizes: the sensor frame down to 240x384, and 2x up
    img = rs.randint(0, 256, (300, 480, 3)).astype(np.uint8)
    for size in ((240, 384), (600, 960), (240, 480)):
        want = np.asarray(Image.fromarray(img).resize(size[::-1], Image.BILINEAR))
        np.testing.assert_array_equal(png.resize_bilinear(img, size), want)


def test_resize_to_the_same_size_is_a_copy():
    img = np.random.RandomState(0).randint(0, 256, (24, 40, 3)).astype(np.uint8)
    out = png.resize_bilinear(img, (24, 40))
    np.testing.assert_array_equal(out, img)
    assert out is not img and not np.shares_memory(out, img)
