"""Port parity of the pose viewer: ``python -m spef_tpu_torch.apps.viewer``
against ``spef_tpu.apps.viewer`` on one tiny experiment, and the overlays
(``utils/visualize.py``, ``data/raster.py``) against OpenCV and JAX's
``VisualizePose``.

  * ``Canvas``'s ``LINE_8`` calls (``arrowedLine`` at thickness 2 with
    ``tipLength`` 0.1, ``rectangle`` and ``line`` at thickness 2), its
    ``LINE_AA`` line and filled circle, and ``resize_linear``
    (``cv2.resize``, ``INTER_LINEAR``) against cv2 on random images and end
    points, some far off the image and cut by the clip: bit for bit.
  * ``VisualizePose.add_visualization`` against JAX's on the same frames and
    poses (degenerate ones that project to NaN included), every flag on and
    off, with and without ``resolution``: bit for bit.
  * Both viewer apps on a ``small_mobile_q`` + ``ursonet_q`` experiment with
    quantization off (float32 on both sides), random init from the port's
    seed, saved by the port; a still split and a video sequence written by
    the JAX writer, four frames each, still and ``--video``: the same files;
    each PNG is its own package's ``VisualizePose`` redraw of the poses that
    viewer drew (pixel for pixel); the true-pose overlays equal across the
    packages (pixel for pixel); the ESA, orientation and position errors in
    the two ``index.html`` files within 2e-3, 0.1 deg and 0.011 m (float32
    forwards whose decodes' ``eigh`` differs by rounding, printed at 3, 1
    and 2 decimals).
"""

import os
import re
import types

import cv2
import numpy as np
import pytest
import torch

from spef_tpu.data.camera import SPEED_CAMERA as JAX_CAMERA
from spef_tpu.utils.visualize import VisualizePose as JaxVisualizePose
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.data.png import read_png
from spef_tpu_torch.data.raster import Canvas, resize_linear
from spef_tpu_torch.utils.visualize import VisualizePose

torch.set_num_threads(1)

HW = (64, 96)


# ---- the drawing calls against cv2 ----------------------------------------------


def _end_points(rng, h, w, far):
    span = 3 if far else 1
    return (tuple(int(v) for v in (rng.randint(-span * w, (span + 1) * w),
                                   rng.randint(-span * h, (span + 1) * h))),
            tuple(int(v) for v in (rng.randint(-w // 2, 3 * w // 2),
                                   rng.randint(-h // 2, 3 * h // 2))))


CALLS = {
    "arrowedLine": (lambda img, a, b, c: cv2.arrowedLine(img, a, b, c, 2, tipLength=0.1),
                    lambda cv, a, b, c: cv.arrowed_line(a, b, c, 2, 0.1)),
    "rectangle": (lambda img, a, b, c: cv2.rectangle(img, a, b, c, 2),
                  lambda cv, a, b, c: cv.rectangle(a, b, c, 2)),
    "line8": (lambda img, a, b, c: cv2.line(img, a, b, c, 2),
              lambda cv, a, b, c: cv.line8(a, b, c, 2)),
    "line_aa": (lambda img, a, b, c: cv2.line(img, a, b, c, 1, cv2.LINE_AA),
                lambda cv, a, b, c: cv.line(a, b, c, 1)),
    "circle_aa": (lambda img, a, b, c: cv2.circle(img, a, 3, c, -1, cv2.LINE_AA),
                  lambda cv, a, b, c: cv.filled_circle(a, 3, c)),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_canvas_calls_match_cv2(call):
    want_fn, got_fn = CALLS[call]
    rng = np.random.RandomState(sorted(CALLS).index(call))
    for i in range(300):
        h, w = int(rng.randint(16, 80)), int(rng.randint(16, 120))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        a, b = _end_points(rng, h, w, far=i % 3 == 0)
        color = tuple(int(c) for c in rng.randint(0, 256, 3))
        want = img.copy()
        want_fn(want, a, b, color)
        canvas = Canvas.from_array(img)
        got_fn(canvas, a, b, color)
        np.testing.assert_array_equal(canvas.to_array(), want, err_msg=f"{call} {a} {b} {h}x{w}")


def test_resize_linear_matches_cv2():
    rng = np.random.RandomState(7)
    sizes = [((240, 384), (320, 200)), ((240, 384), (192, 120)), ((240, 384), (1920, 1200)),
             ((1200, 1920), (384, 240)), ((64, 96), (96, 64)), ((5, 3), (17, 2)),
             ((1, 1), (4, 4)), ((240, 384), (384, 240))]
    for _ in range(40):
        sizes.append(((int(rng.randint(1, 90)), int(rng.randint(1, 90))),
                      (int(rng.randint(1, 150)), int(rng.randint(1, 150)))))
    for (h, w), size in sizes:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(resize_linear(img, size), cv2.resize(img, size),
                                      err_msg=f"{h}x{w} -> {size}")


# ---- VisualizePose against JAX's --------------------------------------------------


def _pose(rng, degenerate=False):
    q = rng.randn(4)
    pos = [rng.uniform(-3, 3), rng.uniform(-2, 2), 0.0 if degenerate else rng.uniform(2, 30)]
    return {"ori": (q / np.linalg.norm(q)).astype(np.float32),
            "pos": np.asarray(pos, np.float32),
            "keypoints": rng.uniform(-0.3, 1.3, 24).astype(np.float32),
            "bbox": rng.uniform(-0.2, 1.2, 4).astype(np.float32)}


FLAGS = ("show_true_pose", "show_pred_pose", "show_temp_pose", "show_true_bbox",
         "show_pred_bbox", "show_temp_bbox", "show_true_keypoints", "show_pred_keypoints",
         "show_temp_keypoints")


@pytest.mark.parametrize("resolution", [None, (320, 200), (192, 120)])
def test_add_visualization_matches_jax(resolution):
    rng = np.random.RandomState(0 if resolution is None else resolution[0])
    mine = VisualizePose(types.SimpleNamespace(camera=SPEED_CAMERA), resolution)
    theirs = JaxVisualizePose(types.SimpleNamespace(camera=JAX_CAMERA), resolution)
    cases = [{f: True for f in FLAGS}, {f: False for f in FLAGS}]
    cases += [{f: f == one for f in FLAGS} for one in FLAGS]
    cases += [{f: bool(rng.rand() < 0.5) for f in FLAGS} for _ in range(4)]
    for i, flags in enumerate(cases):
        img = rng.randint(0, 256, (240, 384, 3)).astype(np.uint8)
        poses = [_pose(rng, degenerate=i == 3 and k == 1) for k in range(3)]
        if i == 4:
            poses[2] = None
        want = theirs.add_visualization(img, *poses, **flags)
        got = mine.add_visualization(img, *poses, **flags)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=str(flags))


# ---- the two viewer apps ----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from spef_tpu.data.synthetic import create_synthetic_dataset, create_synthetic_video
    from spef_tpu_torch.models.wrapper import import_model, save_model

    root = tmp_path_factory.mktemp("viewer")
    still = create_synthetic_dataset(str(root / "data"), n_train=1, n_valid=4, n_test=2,
                                     img_size=HW)
    video = create_synthetic_video(str(root), n_frames=5, img_size=HW)
    exp = root / "exp_tiny"
    model = import_model("small_mobile_q", "ursonet_q", quantization=False,
                         ori_mode="classification", n_ori_bins=64, pos_mode="classification",
                         n_pos_bins=64, img_size=HW, seed=7, device="cpu")
    save_model(str(exp / "model"), model)
    (exp / "config.yaml").write_text(f"""\
MODEL:
  QUANTIZATION: false
  BACKBONE:
    NAME: small_mobile_q
  HEAD:
    NAME: ursonet_q
    ORI: classification
    POS: classification
    N_ORI_BINS_PER_DIM: 4
    N_POS_BINS_PER_DIM: 4
DATA:
  PATH: {still}
  IMG_SIZE: [{HW[0]}, {HW[1]}]
""")
    return str(exp), still, video


_ROW = re.compile(r'<img src="(frame_\d+\.png)".*?esa=([0-9.]+) ori=([0-9.]+)deg '
                  r'pos=([0-9.]+)m lat=')


def _rows(path):
    with open(os.path.join(path, "index.html")) as f:
        return [(m.group(1), *map(float, m.groups()[1:])) for m in _ROW.finditer(f.read())]


class _Recorder:
    """Records what JAX's viewer hands ``add_visualization``."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = JaxVisualizePose.add_visualization

        def rec(viz, image, **kw):
            self.calls.append((np.asarray(image).copy(), kw))
            return orig(viz, image, **kw)

        monkeypatch.setattr(JaxVisualizePose, "add_visualization", rec)


def _true_only(kw):
    return dict(true_pose=kw["true_pose"], show_true_pose=True, show_true_keypoints=True,
                show_true_bbox=True)


@pytest.mark.parametrize("video", [False, True])
def test_viewer_app_matches_jax(tiny, tmp_path, monkeypatch, video):
    from spef_tpu.apps import viewer as jax_app
    from spef_tpu_torch.apps import viewer as port_app

    exp, still, video_root = tiny
    extra = ["--data", video_root, "--split", "seq_000", "--video"] if video else []
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    records = port_app.main(["--experiment", exp, "--out", mine, "--n", "4", "--device", "cpu",
                             *extra])
    recorder = _Recorder(monkeypatch)
    jax_app.main(["--experiment", exp, "--out", theirs, "--n", "4", *extra])
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    assert len(records) == len(recorder.calls) == 4

    utils = types.SimpleNamespace(camera=SPEED_CAMERA)
    mine_viz, theirs_viz = VisualizePose(utils), JaxVisualizePose(
        types.SimpleNamespace(camera=JAX_CAMERA))
    for rec, (frame, kw) in zip(records, recorder.calls):
        assert (rec["temp_pose"] is not None) == video == (kw["temp_pose"] is not None)
        # Each PNG is its viewer's overlays of the poses it drew.
        drawn = mine_viz.add_visualization(
            frame, true_pose=rec["true_pose"], pred_pose=rec["pred_pose"],
            temp_pose=rec["temp_pose"], show_true_pose=True, show_pred_pose=True,
            show_temp_pose=video, show_true_keypoints=True, show_pred_keypoints=True,
            show_true_bbox=True, show_pred_bbox=True)
        png = read_png(os.path.join(mine, rec["filename"]))
        np.testing.assert_array_equal(png[..., ::-1], drawn)
        np.testing.assert_array_equal(read_png(os.path.join(theirs, rec["filename"]))[..., ::-1],
                                      theirs_viz.add_visualization(frame, **kw))
        # The frames and the true poses are the same; their overlays pixel for pixel.
        np.testing.assert_array_equal(rec["true_pose"]["ori"], kw["true_pose"]["ori"])
        np.testing.assert_array_equal(rec["true_pose"]["pos"], kw["true_pose"]["pos"])
        np.testing.assert_array_equal(
            mine_viz.add_visualization(frame, **_true_only(rec)),
            theirs_viz.add_visualization(frame, **_true_only(kw)))

    got, want = _rows(mine), _rows(theirs)
    assert [r[0] for r in got] == [r[0] for r in want] == [r["filename"] for r in records]
    for g, w in zip(got, want):
        assert g[1] == pytest.approx(w[1], abs=2e-3), (g, w)
        assert g[2] == pytest.approx(w[2], abs=0.1), (g, w)
        assert g[3] == pytest.approx(w[3], abs=0.011), (g, w)


def test_viewer_refusals(tiny, tmp_path, monkeypatch):
    from spef_tpu_torch.apps import viewer as port_app

    exp, _, _ = tiny
    with pytest.raises(SystemExit):  # no int8_graph.pkl in the experiment
        port_app.main(["--experiment", exp, "--engine", "int8-carry", "--out",
                       str(tmp_path / "x"), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        port_app.main(["--experiment", exp, "--out", str(tmp_path / "y")])
