"""Port parity: ``spef_tpu_torch.data.dataset`` against
``spef_tpu.data.dataset``.

  * ``BatchLoader`` on a tiny D-SPEED still dataset written by the JAX
    writer (``cv2.imwrite``): every batch's images, ``ori``, ``pos`` and
    ``mask`` equal to the JAX loader's, bit for bit, in order and shuffled
    (seed + epoch, two epochs), the last batch padded.  At the written size
    every decoder returns the pixels as they are; at another size the port's
    ``"png"`` decoder is held to PIL's resize (the native decoder is held to
    JAX's native loader in ``tests/test_torch_native.py``).
  * ``Manifest``: the label-key aliases and the numeric filename sort.
  * ``detect_dataset`` / ``load_dataset`` on the four layouts (SPEED, SPEED+,
    D-SPEED still and video): the same family, split names and loader
    lengths as JAX's, the SPEED layout's JPEG frame decoded as JAX's loader
    decodes it.  What the loaders refuse: an unknown decoder, a JPEG under
    the ``"png"`` decoder (naming the native loader), the host warp on a
    crop-refine manifest and on device-resident data (the split cache,
    ``CachedBatchLoader``, is held in ``tests/test_torch_cached_loader.py``).

Tolerance: none; every comparison is exact.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest

from spef_tpu.data import dataset as jdataset
from spef_tpu.data.synthetic import create_synthetic_dataset as jax_create
from spef_tpu_torch.data import dataset

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_native import jax_native_library  # noqa: E402,F401 - JAX's library, built safely

HW = (36, 60)


@pytest.fixture(scope="module")
def still(tmp_path_factory):
    return jax_create(str(tmp_path_factory.mktemp("ds")), n_train=7, n_valid=3, n_test=5,
                      img_size=HW, seed=3)


def _batches(loader):
    return [{k: np.array(v) for k, v in b.items()} for b in loader]


@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_loader_matches_jax(still, shuffle):
    labels = os.path.join(still, "train", "pose.json")
    images = os.path.join(still, "train", "images")
    mine = dataset.BatchLoader(dataset.Manifest.from_json(labels, images), 3, HW,
                               shuffle=shuffle, seed=5, n_workers=2)
    theirs = jdataset.BatchLoader(jdataset.Manifest.from_json(labels, images), 3, HW,
                                  shuffle=shuffle, seed=5, n_workers=2)
    assert len(mine) == len(theirs) == 3 and mine.n_samples == 7
    for _ in range(2):  # two epochs: the shuffle moves with the epoch
        got, want = _batches(mine), _batches(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == ["images", "mask", "ori", "pos"]
            for k in g:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got[-1]["mask"].tolist() == [1.0, 0.0, 0.0]
        assert not got[-1]["images"][1:].any()  # padding rows are zero
    drop = dataset.BatchLoader(mine.manifest, 3, HW, drop_remainder=True)
    assert len(drop) == 2 and len(_batches(drop)) == 2


def test_images_are_rgb_and_resized_as_pil(still):
    from PIL import Image

    path = os.path.join(still, "test", "images", "img000002.png")
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(dataset.load_image(path, HW), bgr[..., ::-1])
    for size in ((24, 40), (72, 120)):
        with Image.open(path) as im:
            want = np.asarray(im.convert("RGB").resize(size[::-1], Image.BILINEAR))
        np.testing.assert_array_equal(dataset.load_image(path, size, "png"), want)


def test_manifest_aliases_and_numeric_sort(tmp_path):
    entries = [{"filename": f"img{i}.png", "q_vbs2tango_true": [1.0, 0, 0, 0],
                "r_Vo2To_vbs_true": [0.0, 0.0, float(i)]} for i in (10, 2, 1)]
    entries[0]["crop"] = [0.5, 0.5, 0.3]
    path = tmp_path / "labels.json"
    path.write_text(json.dumps(entries))
    mine = dataset.Manifest.from_json(str(path), "imgs")
    theirs = jdataset.Manifest.from_json(str(path), "imgs")
    assert [r.image_path for r in mine.records] == [r.image_path for r in theirs.records] == [
        os.path.join("imgs", f"img{i}.png") for i in (1, 2, 10)]
    for a, b in zip(mine.records, theirs.records):
        np.testing.assert_array_equal(a.ori, b.ori)
        np.testing.assert_array_equal(a.pos, b.pos)
        assert (a.crop is None) == (b.crop is None)
    np.testing.assert_array_equal(mine.records[2].crop, np.float32([0.5, 0.5, 0.3]))
    path.write_text(json.dumps([{"filename": "a.png", "quat": [1, 0, 0, 0], "t": [0, 0, 1]}]))
    with pytest.raises(ValueError, match="Unrecognized label schema"):
        dataset.Manifest.from_json(str(path), "imgs")


def _labels(path, names, ori_key="q", pos_key="t"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump([{"filename": n, ori_key: [1.0, 0.0, 0.0, 0.0], pos_key: [0.0, 0.0, 5.0]}
                   for n in names], f)


def _layouts(root, still):
    """The four layouts: SPEED (bundled split, one JPEG in ``real``),
    SPEED+, D-SPEED still (the JAX writer's) and D-SPEED video."""
    speed = os.path.join(root, "speed")
    _labels(os.path.join(speed, "real.json"), ["img000001real.jpg"],
            "q_vbs2tango", "r_Vo2To_vbs_true")
    os.makedirs(os.path.join(speed, "images", "real"))
    cv2.imwrite(os.path.join(speed, "images", "real", "img000001real.jpg"),
                np.full((8, 8, 3), 100, np.uint8))
    plus = os.path.join(root, "speed_plus")
    _labels(os.path.join(plus, "synthetic", "train.json"), ["a.jpg", "b.jpg"],
            "q_vbs2tango_true", "r_Vo2To_vbs_true")
    _labels(os.path.join(plus, "lightbox", "test.json"), ["c.jpg"],
            "q_vbs2tango_true", "r_Vo2To_vbs_true")
    video = os.path.join(root, "video")
    for seq in ("seq_b", "seq_a"):
        _labels(os.path.join(video, seq, "pose.json"), ["img000000.png", "img000001.png"])
    return {"speed": speed, "speed_plus": plus, "dspeed": still, "dspeed_video": video}


def test_detect_and_load_the_four_layouts(tmp_path, still):
    for kind, path in _layouts(str(tmp_path), still).items():
        assert dataset.detect_dataset(path) == jdataset.detect_dataset(path) == kind
        data, split = dataset.load_dataset(path, batch_size=2, img_size=HW)
        jdata, jsplit = jdataset.load_dataset(path, batch_size=2, img_size=HW)
        assert split == jsplit, kind
        assert sorted(data) == sorted(jdata), kind
        for name in data:
            assert len(data[name]) == len(jdata[name]), (kind, name)
            assert data[name].shuffle == jdata[name].shuffle
    with pytest.raises(ValueError, match="not implemented"):
        dataset.detect_dataset(str(tmp_path / "speed" / "images"))
    with pytest.raises(FileNotFoundError):
        dataset.detect_dataset(str(tmp_path / "nowhere"))
    # The bundled SPEED split is the JAX package's.
    data, _ = dataset.load_dataset(os.path.join(str(tmp_path), "speed"), 64, HW)
    jdata, _ = jdataset.load_dataset(os.path.join(str(tmp_path), "speed"), 64, HW)
    assert [r.image_path for r in data["valid"].manifest.records] == [
        r.image_path for r in jdata["valid"].manifest.records]
    assert data["train"].n_samples == 10200 and data["valid"].n_samples == 1800
    # shuffle=True shuffles the train split only
    data, _ = dataset.load_dataset(still, 2, HW, shuffle=True)
    assert [data[k].shuffle for k in ("train", "valid", "test")] == [True, False, False]


def test_what_is_not_ported_raises(tmp_path, still):
    from spef_tpu_torch.data.augment_host import HostRotationAugment
    from spef_tpu_torch.data.camera import DSPEED_CAMERA

    speed = _layouts(str(tmp_path), still)["speed"]
    data, _ = dataset.load_dataset(speed, 1, HW)
    jdata, _ = jdataset.load_dataset(speed, 1, HW)
    assert data["real"].decoder == "native"  # JAX's loader also reads it natively here
    np.testing.assert_array_equal(next(iter(data["real"]))["images"],
                                  next(iter(jdata["real"]))["images"])
    real = data["real"].manifest
    with pytest.raises(ValueError, match="JPEG file.*native loader"):
        next(iter(dataset.BatchLoader(real, 1, HW, decoder="png")))
    with pytest.raises(ValueError, match="decoder must be one of"):
        dataset.BatchLoader(real, 1, HW, decoder="pil")
    aug = HostRotationAugment(DSPEED_CAMERA)
    with pytest.raises(ValueError, match="device-resident data cannot take the host-side warp"):
        dataset.load_dataset(still, 2, HW, rot_augment=aug, cache="device", device="cpu")
    crop = tmp_path / "crop.json"
    crop.write_text(json.dumps([{"filename": "a.png", "q": [1, 0, 0, 0], "t": [0, 0, 5],
                                 "crop": [0.5, 0.5, 0.3]}]))
    with pytest.raises(ValueError, match="crop-refine manifests"):
        dataset.BatchLoader(dataset.Manifest.from_json(str(crop), "imgs"), 1, HW,
                            rot_augment=aug)
