"""``spef_tpu_torch.native`` (the port's copy of ``impreproc.cpp``) and the
loaders' decoder choice, against the JAX package on the CPU.

Frames are written by the test with cv2 (PNG, and JPEG at quality 90): a
noise frame and a smooth gradient, at SPEED's 1920x1200 and at 120x192.

  * ``native.load_batch`` against ``spef_tpu.native.load_batch``, bit for
    bit, on PNG and JPEG: at the written size, at 1920x1200 -> 240x384 (the
    flagship's input from a SPEED frame) and at 120x192 -> 37x61.  At an
    upscale (120x192 -> 300x480) the two differ by 1 on about 1e-4 of the
    values: JAX's library is built without ``-ffp-contract=off`` and, on a
    host with FMA, contracts the resize's sums into fused multiply-adds.  So
    there the port's source is built with JAX's flags alone and held to
    JAX's library bit for bit, and the port's library to its numpy twin.
  * ``native.resize_bilinear_plain`` (the numpy twin) against the native
    resize of lossless PNG frames at five sizes, bit for bit.
  * ``BatchLoader(decoder="auto")`` resolves to ``"native"`` here, as JAX's
    loader picks its native loader, and its batches of JPEG frames equal
    JAX's ``BatchLoader``'s; ``decoder="png"`` equals JAX's PIL
    ``_load_image`` at a resize.
  * The refusals: with the headers monkeypatched missing, ``"auto"``
    resolves to ``"png"``, ``"native"`` raises naming them and a JPEG under
    ``"png"`` raises naming them; a file that does not decode raises
    ``IOError`` naming it.
  * ``CachedBatchLoader`` records its decoder beside the sidecar, and a
    loader with another decoder decodes the split again.

Tolerance: none; every comparison is exact.
"""

import ctypes
import json
import os
import subprocess

import cv2
import numpy as np
import pytest

from spef_tpu import native as jnative
from spef_tpu.data import dataset as jdataset
from spef_tpu_torch import native
from spef_tpu_torch.data import dataset


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    """JAX's native library, built and loaded in this process.

    ``spef_tpu.native.build`` writes its library in place, and JAX's
    ``load_library`` gives up for the whole process after one failed load;
    test processes that start together (pytest-xdist) could load a file
    another one is still writing.  So it is built here under a lock, into a
    temporary file moved into place (JAX's command and flags), and JAX's
    loader is let to try again."""
    import fcntl
    import tempfile

    with open(os.path.join(tempfile.gettempdir(), "spef_tpu_native_build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (os.path.exists(jnative._LIB)
                    and os.path.getmtime(jnative._LIB) >= os.path.getmtime(jnative._SRC)):
                tmp = jnative._LIB + f".{os.getpid()}.tmp"
                subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                                jnative._SRC, "-o", tmp, "-ljpeg", "-lpng", "-lpthread"],
                               check=True, capture_output=True)
                os.replace(tmp, jnative._LIB)
            if jnative._lib is None:
                jnative._tried = False
            assert jnative.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _frames(h, w, seed):
    rs = np.random.RandomState(seed)
    noise = rs.randint(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                       (xx + yy) * 255 // (h + w)], -1).astype(np.uint8)
    return {"noise": noise, "smooth": smooth}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{(size, kind, ext): path}, every frame written as PNG and JPEG (BGR
    order in the file, as cv2 writes it)."""
    root = tmp_path_factory.mktemp("native")
    out = {}
    for size, seed in (((1200, 1920), 0), ((120, 192), 1)):
        for kind, rgb in _frames(*size, seed).items():
            for ext in ("png", "jpg"):
                path = str(root / f"{kind}_{size[0]}.{ext}")
                cv2.imwrite(path, rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
                out[size, kind, ext] = path
    return out


def _paths(files, size, ext):
    return [files[size, kind, ext] for kind in ("noise", "smooth")]


@pytest.mark.parametrize("ext", ["png", "jpg"])
@pytest.mark.parametrize("src,out", [((1200, 1920), (1200, 1920)), ((1200, 1920), (240, 384)),
                                     ((120, 192), (120, 192)), ((120, 192), (37, 61))])
def test_native_batch_equals_jax(files, ext, src, out):
    paths = _paths(files, src, ext)
    got = native.load_batch(paths, *out)
    assert got.shape == (2, *out, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jnative.load_batch(paths, *out))
    if src == out and ext == "png":  # lossless, no resize: the pixels as written
        np.testing.assert_array_equal(got[0], _frames(*src, 0 if src[0] == 1200 else 1)["noise"])


def _load_with(lib_path, paths, h, w):
    lib = ctypes.CDLL(lib_path)
    lib.spef_load_batch.restype = ctypes.c_int
    lib.spef_load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
    out = np.empty((len(paths), h, w, 3), np.uint8)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    assert lib.spef_load_batch(c_paths, len(paths),
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
                               1) == len(paths)
    return out


def test_upscale_against_jax_and_the_twin(files, tmp_path):
    paths = _paths(files, (120, 192), "png")
    got = native.load_batch(paths, 300, 480)
    jax_flags = [f for f in native.FLAGS if f != "-ffp-contract=off"]
    lib = str(tmp_path / "libimpreproc_jax_flags.so")
    subprocess.run(["g++", *jax_flags, native.SOURCE, "-o", lib, *native.LIBS], check=True)
    np.testing.assert_array_equal(_load_with(lib, paths, 300, 480),
                                  jnative.load_batch(paths, 300, 480))
    for i, path in enumerate(paths):
        full = cv2.imread(path)[..., ::-1]
        np.testing.assert_array_equal(got[i], native.resize_bilinear_plain(full, 300, 480))


@pytest.mark.parametrize("out", [(240, 384), (37, 61), (120, 192), (300, 480), (1201, 7)])
def test_numpy_twin_equals_the_native_resize(files, out):
    paths = _paths(files, (120, 192), "png") + _paths(files, (1200, 1920), "png")[:1]
    got = native.load_batch(paths, *out)
    for i, path in enumerate(paths):
        full = cv2.imread(path)[..., ::-1]
        np.testing.assert_array_equal(native.resize_bilinear_plain(full, *out), got[i],
                                      err_msg=os.path.basename(path))


def _split(root, files, ext, size):
    """A D-SPEED-like split of the four frames of one extension."""
    images = root / "images"
    images.mkdir(parents=True)
    entries = []
    for i, path in enumerate(_paths(files, (1200, 1920), ext) + _paths(files, (120, 192), ext)):
        name = f"img{i:06d}.{ext}"
        os.symlink(path, images / name)
        entries.append({"filename": name, "q": [1.0, 0.0, 0.0, 0.0], "t": [0.0, 0.0, 9.0 + i]})
    labels = root / "pose.json"
    labels.write_text(json.dumps(entries))
    return str(labels), str(images)


def test_auto_picks_what_jax_picks_and_loads_jpeg_as_jax(files, tmp_path):
    assert native.available() and jdataset._native_loader() is not None
    labels, images = _split(tmp_path, files, "jpg", (240, 384))
    mine = dataset.BatchLoader(dataset.Manifest.from_json(labels, images), 3, (240, 384),
                               n_workers=2)
    theirs = jdataset.BatchLoader(jdataset.Manifest.from_json(labels, images), 3, (240, 384),
                                  n_workers=2)
    assert mine.decoder == "native"
    for a, b in zip(mine, theirs):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    one = dataset.load_image(os.path.join(images, "img000001.jpg"), (240, 384))
    np.testing.assert_array_equal(one, jnative.load_batch(
        [os.path.join(images, "img000001.jpg")], 240, 384)[0])


@pytest.mark.parametrize("size", [(240, 384), (77, 100), (150, 250)])
def test_png_decoder_is_jax_pil_path(files, size):
    for path in _paths(files, (120, 192), "png"):
        np.testing.assert_array_equal(dataset.load_image(path, size, "png"),
                                      jdataset._load_image(path, size))


def test_refusals_name_what_is_missing(files, tmp_path, monkeypatch):
    jpg = files[(120, 192), "noise", "jpg"]
    bad = tmp_path / "broken.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0" + bytes(32))
    with pytest.raises(IOError, match="broken.jpg"):
        native.load_batch([files[(120, 192), "noise", "png"], str(bad)], 24, 32)
    with pytest.raises(ValueError, match="'png' decoder reads PNG only.*can build"):
        dataset.load_image(jpg, (24, 32), "png")

    monkeypatch.setattr(native, "missing", lambda: ("jpeglib.h", "png.h"))
    assert not native.available() and dataset.resolve_decoder("auto") == "png"
    with pytest.raises(RuntimeError, match="missing jpeglib.h, png.h"):
        dataset.resolve_decoder("native")
    with pytest.raises(ValueError, match="cannot build: missing jpeglib.h, png.h"):
        dataset.load_image(jpg, (24, 32))
    labels, images = _split(tmp_path / "split", files, "png", (24, 32))
    loader = dataset.BatchLoader(dataset.Manifest.from_json(labels, images), 2, (24, 32))
    assert loader.decoder == "png"


def test_missing_probes_the_compiler(monkeypatch):
    native.missing.cache_clear()
    try:
        monkeypatch.setattr(native, "_gxx", lambda: None)
        assert native.missing() == ("g++", "jpeglib.h", "png.h", "libjpeg", "libpng")
        monkeypatch.setattr(native, "_gxx", lambda: "g++")
        monkeypatch.setattr(native, "_has_header", lambda gxx, h: h != "png.h")
        monkeypatch.setattr(native, "_has_library", lambda gxx, f: f != "libjpeg.so")
        native.missing.cache_clear()
        assert native.missing() == ("png.h", "libjpeg")
    finally:
        native.missing.cache_clear()


def test_sidecar_records_its_decoder(files, tmp_path):
    labels, images = _split(tmp_path, files, "png", (48, 64))

    def loader(decoder):
        return dataset.CachedBatchLoader(dataset.Manifest.from_json(labels, images), 2,
                                         (48, 64), n_workers=2, decoder=decoder, device="cpu")

    first = loader("native")
    native_batches = [b["images"] for b in first]
    records = [f for f in os.listdir(images) if f.startswith(".decoder_")]
    assert len(records) == 1
    with open(os.path.join(images, records[0])) as f:
        assert json.load(f) == {"decoder": "native"}
    again = loader("native")
    list(again)
    assert isinstance(again._cache, np.memmap)  # the sidecar, read back
    other = loader("png")
    png_batches = [b["images"] for b in other]
    assert not isinstance(other._cache, np.memmap)  # decoded again
    with open(os.path.join(images, records[0])) as f:
        assert json.load(f) == {"decoder": "png"}
    # 1920x1200 -> 48x64: the two resizes differ; 120x192 -> 48x64 too.
    assert any((a != b).any() for a, b in zip(native_batches, png_batches))
