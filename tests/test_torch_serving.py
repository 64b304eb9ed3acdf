"""Port parity of the serving runtime: ``spef_tpu_torch.serving`` against
``spef_tpu.serving`` (the counterpart of ``tests/test_serving.py``).

A ``small_mobile_q`` + ``ursonet_q`` model with quantization off (4 bins
per dimension for orientation, regression for position, 32x32), float32
on both sides, the port's weights read by JAX, so the two packages' poses
agree within float32 rounding (1e-6 on the soft-class PDFs and positions;
quaternions up to sign within 1e-2, the ``eigh`` decode of flat PDFs).
``serve_stream`` on the CPU (no pinning, no streams: the ``cuda`` lane
holds the pinned ring) keeps the order and count of its batches and gives
each batch exactly ``PoseServer.predict``'s result on it, through the
padding window.
"""

import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JaxUtils
from spef_tpu.data.camera import SPEED_CAMERA as JAX_CAMERA
from spef_tpu.engine import build_predict_fn as jax_predict_fn
from spef_tpu.models.wrapper import import_model as jax_import_model
from spef_tpu.serving import PoseServer as JaxServer
from spef_tpu.serving import serve_stream as jax_serve_stream
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.engine import build_predict_fn
from spef_tpu_torch.models.wrapper import import_model, save_model
from spef_tpu_torch.serving import PoseServer, serve_stream

torch.set_num_threads(1)

HW = (32, 32)
POSE_TOL = 1e-6  # float32 on both sides: PDFs and positions (1e-8 apart here)
# Up to sign.  The untrained model's PDFs are flat (1/24 +- 1e-4), where the
# eigh decode's eigenvalue gap is small: PDFs 1e-8 apart move its
# quaternion by up to 4e-3.
QUAT_TOL = 1e-2


@pytest.fixture(scope="module")
def predict_fns(tmp_path_factory):
    """(JAX predict, port predict) on the same weights: ``small_mobile_q`` +
    ``ursonet_q`` with quantization off (float32 in both packages), random
    init from the port's seed, saved by the port and read by JAX."""
    params = tmp_path_factory.mktemp("serving") / "model"
    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                          pos_mode="regression", use_keypoints=False, device="cpu")
    heads = dict(ori_mode="classification", n_ori_bins=spe.orientation.n_bins,
                 pos_mode="regression", img_size=HW, quantization=False)
    model = import_model("small_mobile_q", "ursonet_q", seed=7, device="cpu", **heads)
    save_model(str(params), model)
    jax_spe = JaxUtils.create(JAX_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                              pos_mode="regression", use_keypoints=False)
    jax_model = jax_import_model("small_mobile_q", "ursonet_q",
                                 params_path=str(params / "parameters.msgpack"), **heads)
    return jax_predict_fn(jax_model, jax_spe), build_predict_fn(model, spe)


def _frames(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3), np.uint8)


def _assert_pose_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k == "ori":
            sign = np.sign((g * w).sum(-1, keepdims=True))
            np.testing.assert_allclose(g * sign, w, atol=QUAT_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, atol=POSE_TOL, err_msg=k)


def test_server_pads_and_matches_jax(predict_fns):
    jax_fn, fn = predict_fns
    server = PoseServer(fn, img_shape=(*HW, 3), max_batch=16, device="cpu")
    assert server.warmup() > 0
    images = _frames(10, 0)
    out, latency = server.predict(images)
    assert out["ori"].shape == (10, 4) and out["pos"].shape == (10, 3) and latency > 0
    stats = server.stats()
    assert stats["requests"] == 1 and stats["devices"] == 1
    # The padding window is layout only: the unpadded call's poses.
    direct = fn(torch.from_numpy(images))
    for k in out:
        np.testing.assert_array_equal(out[k], direct[k].numpy(), err_msg=k)
    want, _ = JaxServer(jax_fn, img_shape=(*HW, 3), max_batch=16).predict(images)
    _assert_pose_close(out, want)


def test_server_rejects_oversize(predict_fns):
    server = PoseServer(predict_fns[1], img_shape=(*HW, 3), max_batch=8, device="cpu")
    with pytest.raises(ValueError, match="serving window"):
        server.predict(np.zeros((9, *HW, 3), np.uint8))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_serve_stream_order_count_and_each_batch_its_own(predict_fns, depth):
    """Distinct batches: each streamed result is ``PoseServer.predict``'s
    on that batch, bit for bit, in order; and JAX's stream's on it."""
    jax_fn, fn = predict_fns
    batches = [_frames(8, 10 + i) for i in range(5)]
    outs = list(serve_stream(fn, iter(batches), depth=depth, device="cpu"))
    assert len(outs) == 5
    server = PoseServer(fn, img_shape=(*HW, 3), max_batch=8, device="cpu")
    for batch, out in zip(batches, outs):
        want, _ = server.predict(batch)
        for k in want:
            np.testing.assert_array_equal(out[k].numpy(), want[k], err_msg=k)
    if depth == 2:
        for out, theirs in zip(outs, jax_serve_stream(jax_fn, batches, depth=2)):
            _assert_pose_close({k: v.numpy() for k, v in out.items()}, theirs)


def test_serve_stream_rejects_depth_zero(predict_fns):
    with pytest.raises(ValueError, match="depth"):
        list(serve_stream(predict_fns[1], [_frames(2, 0)], depth=0, device="cpu"))


class _Event:
    """A stand-in for the copy's CUDA event: records when it is waited on."""

    def __init__(self, log, i):
        self.log, self.i = log, i

    def synchronize(self):
        self.log.append(self.i)


def test_stager_ring_reuses_a_buffer_only_after_its_copy(monkeypatch):
    """The ``cuda`` path's staging thread with the pinning replaced by plain
    host tensors (this CPU has no pinned memory): each batch arrives in
    order with its own frames; a buffer is written again only after the
    event of the copy that last read it was waited on; errors of the source
    reach the consumer; ``close`` ends the thread."""
    import spef_tpu_torch.serving as serving

    monkeypatch.setattr(serving, "_pinned", lambda shape, dtype: torch.from_numpy(
        np.empty(shape, dtype)))
    batches = [_frames(2, 30 + i) for i in range(5)]
    waited = []
    stager = serving._Stager(iter(batches), depth=2)
    try:
        for i, batch in enumerate(batches):
            slot, buf = stager.next()
            assert slot == i % 2
            np.testing.assert_array_equal(buf.numpy(), batch)  # not yet overwritten
            # the copies of batches up to i - 2 (the last out of this buffer)
            # were waited on before it was written
            assert set(range(i - 1)) <= set(waited), (i, waited)
            stager.release(slot, _Event(waited, i))
        assert stager.next() is None
        assert sorted(waited) == [0, 1, 2]  # batches 2-4 each waited for one copy
    finally:
        stager.close()
    assert not stager._thread.is_alive()

    def broken():
        yield batches[0]
        raise OSError("frame source failed")

    stager = serving._Stager(broken(), depth=2)
    try:
        stager.next()
        with pytest.raises(OSError, match="frame source failed"):
            stager.next()
    finally:
        stager.close()
    assert not stager._thread.is_alive()
    # a consumer that stops early: the thread, waiting for a free buffer, ends
    stager = serving._Stager(iter(batches), depth=1)
    stager.next()
    stager.close()
    assert not stager._thread.is_alive()
