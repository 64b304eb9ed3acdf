"""Port parity: the calibration half of the int8 graph front end and the
synthetic frames it calibrates on, against the JAX package.

  * ``render_frame`` / ``generate_positions``: bit for bit (the port draws
    with ``data/raster.py``, OpenCV's anti-aliased drawing in plain
    Python; the JAX package with OpenCV itself), and the rasterizer's lines
    and circles against ``cv2`` directly;
  * ``HistogramCollector``: exact (the same numpy);
  * ``calibrate_graph`` on a few flagship frames: every step within one
    histogram bin of JAX's, taken as ``amax / 2048`` (the narrowest bin the
    99.99th percentile of a 2048-bin histogram can have picked): the tap
    forward's float32 convolutions sum in another order, which moves a
    site's maximum, and with it the histogram's range, by a few ulp;
  * ``write_scales_to_params``: exact.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.data import synthetic as jsynthetic
from spef_tpu.quant import calibrate as jcalibrate
from spef_tpu_torch.data import synthetic
from spef_tpu_torch.data.raster import Canvas
from spef_tpu_torch.quant import calibrate
from spef_tpu_torch.quant.int8_graph import load_int8_graph

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")


# ---------------------------------------------------------------------------
# synthetic frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("img_size,n,seed,window", [
    ((240, 384), 6, 0, None),   # the calibration frames' size and seed
    ((120, 192), 6, 7, None),
    ((96, 96), 3, 3, np.array([0.5, 0.5, 0.4])),  # a crop window
])
def test_render_frame_bit_for_bit(img_size, n, seed, window):
    rng = np.random.RandomState(seed)
    oris, poss = jsynthetic.generate_positions(rng, n)
    want = [jsynthetic.render_frame(q, p, img_size=img_size, rng=rng, window=window)
            for q, p in zip(oris, poss)]
    rng = np.random.RandomState(seed)
    oris2, poss2 = synthetic.generate_positions(rng, n)
    np.testing.assert_array_equal(oris2, oris)
    np.testing.assert_array_equal(poss2, poss)
    got = [synthetic.render_frame(q, p, img_size=img_size, rng=rng, window=window)
           for q, p in zip(oris2, poss2)]
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (*img_size, 3)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(synthetic.TANGO_3D_KEYPOINTS,
                                  __import__("spef_tpu.codec.keypoints", fromlist=["x"])
                                  .TANGO_3D_KEYPOINTS)


@pytest.mark.parametrize("kind", ["thin", "thick", "circle"])
def test_raster_matches_opencv(kind):
    """Random lines (endpoints up to far outside the image, so every clip
    path runs) and filled circles, anti-aliased, on random backgrounds."""
    rng = np.random.RandomState({"thin": 0, "thick": 1, "circle": 2}[kind])
    h, w = 40, 60
    for _ in range(60):
        base = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = base.copy()
        canvas = Canvas(h, w)
        canvas.buf[:] = base.tobytes()
        color = [int(c) for c in rng.randint(0, 256, 3)]
        if kind == "circle":
            p = (int(rng.randint(-10, w + 10)), int(rng.randint(-10, h + 10)))
            r = int(rng.randint(1, 20))
            cv2.circle(want, p, r, tuple(color), -1, lineType=cv2.LINE_AA)
            canvas.filled_circle(p, r, color)
        else:
            pa = (int(rng.randint(-200, w + 200)), int(rng.randint(-200, h + 200)))
            pb = (int(rng.randint(-20, w + 20)), int(rng.randint(-20, h + 20)))
            t = 1 if kind == "thin" else int(rng.randint(2, 14))
            cv2.line(want, pa, pb, tuple(color), t, lineType=cv2.LINE_AA)
            canvas.line(pa, pb, color, t)
        got = np.frombuffer(bytes(canvas.buf), np.uint8).reshape(h, w, 3)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["absmax", "percentile", "mse", "entropy"])
def test_histogram_collector_is_the_jax_one(method):
    rng = np.random.RandomState(5)
    mine, theirs = calibrate.HistogramCollector(256), jcalibrate.HistogramCollector(256)
    for scale in (1.0, 3.0, 0.5):
        x = rng.randn(2000).astype(np.float32) * scale
        mine.update(x)
        theirs.update(x)
    counts, _ = np.histogram(np.abs(rng.randn(500)) * 9, bins=64, range=(0, 40))
    mine.update_hist(counts, 40.0, 38.0)
    theirs.update_hist(counts, 40.0, 38.0)
    np.testing.assert_array_equal(mine.counts, theirs.counts)
    assert mine.range == theirs.range and mine.amax_observed == theirs.amax_observed
    for qmax in (7.0, 127.0):
        assert mine.amax(method, qmax) == theirs.amax(method, qmax)


def test_calibrate_graph_on_flagship_frames_within_one_bin():
    graph = load_int8_graph(ASSET)
    rng = np.random.RandomState(0)
    oris, poss = synthetic.generate_positions(rng, 4)
    frames = np.stack([synthetic.render_frame(q, p, img_size=(120, 192), rng=rng)[..., ::-1]
                       for q, p in zip(oris, poss)])  # the dataset's channel order
    batches = [frames[:2], frames[2:]]
    got, got_amax = calibrate.calibrate_graph(graph, batches, device="cpu")
    want, want_amax = jcalibrate.calibrate_graph(graph, batches)
    assert sorted(got_amax) == sorted(want_amax)
    for site, amax in want_amax.items():
        assert abs(got_amax[site] - amax) <= amax / 2048, (site, got_amax[site], amax)
    for key in ("stem", "head_conv"):
        assert abs(got[key]["act_step"] - want[key]["act_step"]) <= want[key]["act_step"] / 2048
    for b_got, b_want in zip(got["blocks"], want["blocks"]):
        if "shared_step" in b_want:
            assert abs(b_got["shared_step"] - b_want["shared_step"]) <= \
                b_want["shared_step"] / 2048
        assert "act_step" not in b_got["depthwise"]  # boundary recipe: no interior grid
    assert abs(got["head"]["pool_step"] - want["head"]["pool_step"]) <= \
        want["head"]["pool_step"] / 2048
    np.testing.assert_array_equal(got["blocks"][3]["project"]["w_int"],
                                  graph["blocks"][3]["project"]["w_int"])  # weights untouched


def test_write_scales_to_params_is_the_jax_one():
    from spef_tpu_torch.models.wrapper import flax_variables, import_model

    model = import_model("small_mobile_q", "ursonet_q", ori_mode="classification",
                         n_ori_bins=10, device="cpu")
    tree = flax_variables(model)
    amaxes = {"stem": 3.5, "block0.shared": 1.25, "block1.expand": 6.0,
              "block1.depthwise": 2.0, "final_shared": 0.75, "head_conv": 9.0,
              "head.pool": 0.5, "block7.shared": 1.0}
    got = calibrate.write_scales_to_params(tree, amaxes)
    want = jcalibrate.write_scales_to_params(tree, amaxes)
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (p, g), (_, w) in zip(got_l, want_l):
        assert g.dtype == np.asarray(w).dtype, p
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    assert tree["params"]["backbone"]["stem"]["act_quant"]["log2_scale"] != \
        got["params"]["backbone"]["stem"]["act_quant"]["log2_scale"]  # a new tree
    assert float(got["params"]["head"]["pool_quant"]["log2_scale"]) == -1.0
