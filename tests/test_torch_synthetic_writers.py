"""Port parity: the dataset writers of ``spef_tpu_torch.data.synthetic``
against the JAX writers (``cv2.imwrite``), at a tiny size.

  * ``create_synthetic_dataset``, ``create_crop_dataset`` and
    ``create_synthetic_video``: the same ``pose.json`` (equal JSON) and the
    same pixels (both files decoded by PIL, bit for bit).  The port writes
    other bytes (every row filtered with None), not other pixels.
  * ``_create_test_split``: the writer's test split, with the train and
    valid splits' draws replayed and not rendered, in one process and with
    the frames rendered and written by two worker processes.
  * ``_create_eval_splits``: the writer's valid and test splits, the
    train split's draws replayed once, with one and two processes, in two
    roots: the full writer's files byte for byte, and JAX's writer's pixels
    and ``pose.json``.
  * ``create_synthetic_dataset(workers=2)``: the files of one process.

Tolerance: none; every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from spef_tpu.data import synthetic as jsynthetic
from spef_tpu_torch.data import synthetic

HW = (48, 72)


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _same_split(mine, theirs):
    with open(os.path.join(mine, "pose.json")) as f:
        got = json.load(f)
    with open(os.path.join(theirs, "pose.json")) as f:
        want = json.load(f)
    assert got == want
    for entry in want:
        a = _pixels(os.path.join(mine, "images", entry["filename"]))
        b = _pixels(os.path.join(theirs, "images", entry["filename"]))
        np.testing.assert_array_equal(a, b, err_msg=entry["filename"])
    return want


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("writers")
    jax_still = jsynthetic.create_synthetic_dataset(str(root / "jax"), 3, 2, 4, img_size=HW)
    still = synthetic.create_synthetic_dataset(str(root / "port"), 3, 2, 4, img_size=HW)
    return root, still, jax_still


def test_create_synthetic_dataset_matches_jax(written):
    _, still, jax_still = written
    assert still.endswith("still")
    for split, n in (("train", 3), ("valid", 2), ("test", 4)):
        assert len(_same_split(os.path.join(still, split), os.path.join(jax_still, split))) == n


def test_create_crop_dataset_matches_jax(written):
    root, still, jax_still = written
    kw = dict(img_size=(40, 40), n_jitter=2)
    mine = synthetic.create_crop_dataset(still, str(root / "port_crop"), **kw)
    theirs = jsynthetic.create_crop_dataset(jax_still, str(root / "jax_crop"), **kw)
    for split in ("train", "valid", "test"):
        labels = _same_split(os.path.join(mine, split), os.path.join(theirs, split))
        assert all("crop" in t for t in labels)
    assert len(labels) == 4  # test: one window a frame; train: n_jitter


def test_create_synthetic_video_matches_jax(tmp_path):
    mine = synthetic.create_synthetic_video(str(tmp_path / "port"), n_frames=5, img_size=HW)
    theirs = jsynthetic.create_synthetic_video(str(tmp_path / "jax"), n_frames=5, img_size=HW)
    labels = _same_split(os.path.join(mine, "seq_000"), os.path.join(theirs, "seq_000"))
    assert len(labels) == 5 and labels[0]["q"] != labels[1]["q"]  # it tumbles


@pytest.mark.parametrize("workers", [1, 2])
def test_test_split_replay_gives_the_writers_test_split(written, tmp_path, workers):
    _, _, jax_still = written
    still = synthetic._create_test_split(str(tmp_path), 3, 2, 4, img_size=HW, workers=workers)
    assert sorted(os.listdir(still)) == ["test"]  # train and valid are not rendered
    assert len(_same_split(os.path.join(still, "test"), os.path.join(jax_still, "test"))) == 4


@pytest.mark.parametrize("workers", [1, 2])
def test_valid_split_replay_gives_the_writers_valid_split(written, tmp_path, workers):
    _, port_still, jax_still = written
    valid, test = synthetic._create_eval_splits(str(tmp_path / "v"), str(tmp_path / "t"), 3, 2,
                                                4, img_size=HW, workers=workers)
    assert sorted(os.listdir(valid)) == ["valid"]  # train is not rendered
    assert sorted(os.listdir(test)) == ["test"]
    for split, still, n in (("valid", valid, 2), ("test", test, 4)):
        mine, full = os.path.join(still, split), os.path.join(port_still, split)
        labels = _same_split(mine, os.path.join(jax_still, split))
        assert len(labels) == n
        for name in ["pose.json"] + [os.path.join("images", t["filename"]) for t in labels]:
            with open(os.path.join(mine, name), "rb") as a, \
                    open(os.path.join(full, name), "rb") as b:
                assert a.read() == b.read(), (split, name)


def test_create_synthetic_dataset_in_worker_processes(written, tmp_path):
    _, _, jax_still = written
    still = synthetic.create_synthetic_dataset(str(tmp_path), 3, 2, 4, img_size=HW, workers=2)
    for split, n in (("train", 3), ("valid", 2), ("test", 4)):
        assert len(_same_split(os.path.join(still, split), os.path.join(jax_still, split))) == n
