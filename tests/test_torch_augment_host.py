"""``data/augment_host.py`` against OpenCV and against
``spef_tpu.data.augment_host`` on the CPU.

  * :func:`warp_perspective` (``native/warp.cpp`` here, where g++ is) and
    ``warp_perspective_plain`` (numpy) against ``cv2.warpPerspective(image,
    M, (w, h))`` (OpenCV 5.0 here: a float32 warp with fused
    multiply-adds), on the yaw warps ``K R K^-1`` of uint8 noise frames: the
    flagship's 240x384 at seven angles, and sizes whose widths leave 0 to
    15 columns to OpenCV's scalar tail.  Bit for bit: no value differs.
  * Without g++ (monkeypatched) the augment warps in numpy.
  * ``host_yaw_rotation``: the warped frame, ``ori`` and ``pos`` equal to
    JAX's (its frame by cv2) for random poses and angles.
  * ``HostRotationAugment``: the same draws as JAX's for the same seed (a
    frame skipped where ``rand() >= p``), so the same frames out, in order;
    ``draw`` / ``apply`` split the call without changing it.
  * ``BatchLoader`` and ``CachedBatchLoader`` with ``rot_augment``: every
    batch of two shuffled epochs equal to JAX's loaders' with JAX's augment
    (the draws taken in frame order, the warps on the loader's threads).
  * A loader given a data-parallel ``mesh`` of two ranks: each rank's rows
    of every batch equal the unsharded loader's, the poses, masks and
    draws are the global batch's, and the other rows are neither decoded
    nor warped (zero; the two ranks warp as many frames as one loader).
  * ``apps.train`` with ``ROT_AUGMENT`` and no ``--device-augment`` trains
    on the CPU with the host warp (one epoch of a tiny set), and its warps
    are counted.

Tolerance: none; every comparison is exact.
"""

import os

import cv2
import numpy as np
import pytest

from spef_tpu.data import dataset as jdataset
from spef_tpu.data.augment_host import HostRotationAugment as JAugment
from spef_tpu.data.augment_host import host_yaw_rotation as jhost_yaw_rotation
from spef_tpu.data.camera import DSPEED_CAMERA as JCAMERA
from spef_tpu.data.synthetic import create_synthetic_dataset as jax_create
from spef_tpu_torch.data import dataset
from spef_tpu_torch.data.augment_host import (HostRotationAugment, host_yaw_rotation,
                                              warp_backend, warp_perspective,
                                              warp_perspective_plain)
from spef_tpu_torch.data.camera import DSPEED_CAMERA


def _yaw(deg, h, w):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    k = DSPEED_CAMERA.K.copy()
    k[0] *= w / DSPEED_CAMERA.nu
    k[1] *= h / DSPEED_CAMERA.nv
    return k @ np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ np.linalg.inv(k)


WARPS = {"native": warp_perspective, "numpy": warp_perspective_plain}


@pytest.mark.parametrize("warp", sorted(WARPS))
@pytest.mark.parametrize("deg", [-50.0, -31.7, -4.2, 0.0, 0.9, 17.3, 49.99])
def test_warp_equals_opencv_at_the_flagship_size(deg, warp):
    img = np.random.RandomState(int(deg * 100) % 1000).randint(0, 256, (240, 384, 3), np.uint8)
    m = _yaw(deg, 240, 384)
    np.testing.assert_array_equal(WARPS[warp](img, m, (384, 240)),
                                  cv2.warpPerspective(img, m, (384, 240)))


@pytest.mark.parametrize("warp", sorted(WARPS))
@pytest.mark.parametrize("hw", [(48, 64), (37, 61), (120, 200), (33, 17), (90, 143), (1, 5)])
def test_warp_equals_opencv_at_other_sizes(hw, warp):
    rs = np.random.RandomState(hw[0] * 1000 + hw[1])
    for deg in rs.uniform(-60, 60, 4):
        img = rs.randint(0, 256, hw + (3,), np.uint8)
        m = _yaw(deg, *hw)
        np.testing.assert_array_equal(WARPS[warp](img, m, hw[::-1]),
                                      cv2.warpPerspective(img, m, hw[::-1]), err_msg=str(deg))


def test_without_gxx_the_warp_is_numpy(monkeypatch):
    from spef_tpu_torch import native

    assert warp_backend() == "native" and HostRotationAugment(DSPEED_CAMERA).warp == "native"
    monkeypatch.setattr(native, "_gxx", lambda: None)
    aug = HostRotationAugment(DSPEED_CAMERA)
    assert warp_backend() == "numpy" and aug.warp == "numpy"
    with pytest.raises(RuntimeError, match="missing g\\+\\+"):
        native.build_warp()
    img = np.random.RandomState(0).randint(0, 256, (48, 64, 3), np.uint8)
    m = _yaw(21.0, 48, 64)
    np.testing.assert_array_equal(warp_perspective(img, m, (64, 48)),
                                  cv2.warpPerspective(img, m, (64, 48)))


def test_host_yaw_rotation_equals_jax():
    rs = np.random.RandomState(3)
    for _ in range(6):
        img = rs.randint(0, 256, (60, 96, 3), np.uint8)
        ori = rs.randn(4).astype(np.float32)
        ori /= np.linalg.norm(ori)
        pos = np.float32([rs.uniform(-1, 1), rs.uniform(-1, 1), rs.uniform(5, 30)])
        deg = float(rs.uniform(-50, 50))
        got = host_yaw_rotation(img, ori, pos, DSPEED_CAMERA, deg)
        want = jhost_yaw_rotation(img, ori, pos, JCAMERA, deg)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_augment_draws_equal_jax():
    rs = np.random.RandomState(4)
    mine = HostRotationAugment(DSPEED_CAMERA, seed=77)
    split = HostRotationAugment(DSPEED_CAMERA, seed=77)
    theirs = JAugment(JCAMERA, seed=77)
    for _ in range(12):
        img = rs.randint(0, 256, (36, 60, 3), np.uint8)
        ori, pos = np.float32([1, 0, 0, 0]), np.float32([0.1, -0.2, 9.0])
        a = mine(img, ori, pos)
        b = theirs(img, ori, pos)
        c = split.apply(img, ori, pos, split.draw())
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(z, y)
    assert mine.frames == 12 and 0 < mine.warped < 12 and mine.warp_seconds > 0


@pytest.fixture(scope="module")
def still(tmp_path_factory):
    return jax_create(str(tmp_path_factory.mktemp("ds")), n_train=7, n_valid=3, n_test=3,
                      img_size=(48, 64), seed=3)


@pytest.mark.parametrize("cached", [False, True])
def test_loaders_with_the_host_warp_equal_jax(still, cached):
    labels = os.path.join(still, "train", "pose.json")
    images = os.path.join(still, "train", "images")
    kw = {"device": "cpu"} if cached else {}
    mine = (dataset.CachedBatchLoader if cached else dataset.BatchLoader)(
        dataset.Manifest.from_json(labels, images), 3, (48, 64), shuffle=True, seed=5,
        n_workers=3, rot_augment=HostRotationAugment(DSPEED_CAMERA, seed=9), **kw)
    theirs = (jdataset.CachedBatchLoader if cached else jdataset.BatchLoader)(
        jdataset.Manifest.from_json(labels, images), 3, (48, 64), shuffle=True, seed=5,
        n_workers=3, rot_augment=JAugment(JCAMERA, seed=9))
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=k)
    assert mine.rot_augment.frames == 14 and mine.rot_augment.warped > 0


@pytest.mark.parametrize("cached", [False, True])
def test_a_ranks_loader_decodes_and_warps_only_its_rows(still, cached):
    from spef_tpu_torch.parallel.mesh import Mesh, shard_batch

    labels = os.path.join(still, "train", "pose.json")
    images = os.path.join(still, "train", "images")
    kw = {"device": "cpu"} if cached else {}

    def loader(mesh):
        out = (dataset.CachedBatchLoader if cached else dataset.BatchLoader)(
            dataset.Manifest.from_json(labels, images), 4, (48, 64), shuffle=True, seed=5,
            n_workers=2, rot_augment=HostRotationAugment(DSPEED_CAMERA, seed=9), **kw)
        out.mesh = mesh
        return out

    full = loader(None)
    want = [list(full) for _ in range(2)]
    warped = 0
    for rank in range(2):
        mesh = Mesh(rank, 2)
        mine = loader(mesh)
        got = [list(mine) for _ in range(2)]
        warped += mine.rot_augment.warped
        for g_epoch, w_epoch in zip(got, want):
            assert len(g_epoch) == len(w_epoch) == 2  # 7 frames: 4, then 3 and a padding row
            for g, w in zip(g_epoch, w_epoch):
                for k in ("ori", "pos", "mask"):  # the global batch's
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                mine_rows, want_rows = shard_batch(mesh, g), shard_batch(mesh, w)
                np.testing.assert_array_equal(mine_rows["images"], want_rows["images"])
                others = np.ones(4, bool)
                others[mesh.rows(4)] = False
                assert not g["images"][others].any()  # another rank's rows: not decoded
        assert mine.rot_augment.frames == full.rot_augment.frames == 14
    assert warped == full.rot_augment.warped > 0


def test_train_cli_warps_on_the_host(tmp_path, capsys):
    from spef_tpu_torch.apps import train as train_app
    from spef_tpu_torch.data.synthetic import create_synthetic_dataset

    still = create_synthetic_dataset(str(tmp_path / "dspeed"), 4, 2, 2, img_size=(48, 64),
                                     seed=1001)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "experiments", "train_synth", "exp_dspeed_synth",
                           "config.yaml")) as f:
        cfg = f.read()
    for old, new in {"PATH: /tmp/dspeed_syn/still": f"PATH: {still}",
                     "NAME: mobilenet_v2": "NAME: small_mobile", "BATCH_SIZE: 64": "BATCH_SIZE: 4",
                     "- 240": "- 48", "- 384": "- 64"}.items():
        assert old in cfg, old
        cfg = cfg.replace(old, new)
    assert "ROT_AUGMENT: true" in cfg
    (tmp_path / "exp_host.yaml").write_text(cfg)
    result = train_app.main(["--config", str(tmp_path / "exp_host.yaml"), "--out",
                             str(tmp_path / "out"), "--epochs", "1", "--device", "cpu"])
    record = result["exp_host"]
    assert record is not None and record["epochs"][0]["batches"] == 1
    assert record["host_warp"]["frames"] == 4 and record["decoder"] == "native"
    out = capsys.readouterr().out
    assert "Decoder: native; yaw-rotation warp: host (native)" in out and "Host warp:" in out
    assert record["host_warp"]["warp"] == "native"
    assert np.isfinite(record["loss"]["train"][0])
