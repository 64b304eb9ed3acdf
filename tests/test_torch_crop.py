"""Port parity: ``codec/crop.py`` against ``spef_tpu.codec.crop`` on the CPU.

Seeded numpy inputs through both packages, float32:

  * ``crop_box_from_keypoints`` on 12-point label vectors (an even count:
    ``jnp.median`` averages the two middle values, ``torch.median`` would
    return the lower one), with gross outliers, with the outlier rule off,
    and on an input built so that the lower-middle median moves the box:
    within 1e-6 of JAX's;
  * ``clamp_box``, ``map_keypoints_to_crop`` / ``_from_crop`` (and their
    round trip), ``gate_keypoints``: within 1e-6, the keep masks equal;
  * ``jitter_box``'s deterministic half fed JAX's draws (the scale and
    shift ``jax.random.uniform`` gives under the same key): within 1e-6;
    the port's own draws from a ``torch.Generator`` are in range and
    repeat with the seed;
  * ``crop_resize`` (the per-sample bilinear operators contracted in
    float32) on 64x96 frames into 40x64 crops, boxes near the borders
    included: within 1e-5 of JAX's (the operator rows hold two taps; the
    contractions' sums differ by the order of two float32 products);
  * ``CropRefinePipeline`` with the same two linear keypoint functions in
    both packages: keypoints, boxes and gate masks within 1e-5;
  * the facade's keypoints mode (``codec/facade.py``): ``encode_targets``
    with and without crop windows, ``last_activ``, ``decode``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec import crop as jcrop
from spef_tpu_torch.codec import crop

torch.set_num_threads(1)

B = 16


def _kp(seed, outliers=True):
    rs = np.random.RandomState(seed)
    centre = rs.uniform(0.3, 0.7, (B, 1, 2))
    k = centre + rs.randn(B, 12, 2) * 0.03
    if outliers:
        k[:, 5] = rs.uniform(0, 1, (B, 2))
        k[:, 9] = rs.uniform(0, 1, (B, 2))
    return k.reshape(B, 24).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_median_is_jnp_median_not_torch_median():
    x = np.arange(12, dtype=np.float32)
    assert float(jnp.median(jnp.asarray(x))) == 5.5
    assert float(torch.median(_t(x))) == 5.0  # the trap: the lower middle value
    assert float(crop._median(_t(x))[0]) == 5.5
    rs = np.random.RandomState(0)
    for n in (11, 12):
        v = rs.rand(B, n).astype(np.float32)
        np.testing.assert_array_equal(crop._median(_t(v)).numpy(),
                                      np.asarray(jnp.median(jnp.asarray(v), axis=-1,
                                                            keepdims=True)))


@pytest.mark.parametrize("outliers,outlier_k,margin", [
    (True, 3.0, 1.25), (True, 3.0, 1.5), (False, 3.0, 1.5), (True, None, 1.5)])
def test_crop_box_from_keypoints_matches_jax(outliers, outlier_k, margin):
    k = _kp(1, outliers)
    want = np.asarray(jcrop.crop_box_from_keypoints(jnp.asarray(k), margin,
                                                    outlier_k=outlier_k))
    got = crop.crop_box_from_keypoints(_t(k), margin, outlier_k=outlier_k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_crop_box_where_the_lower_median_would_move_it():
    # 12 points: 6 in a tight cluster at x = 0.40 and 6 spread to the right.
    # The radius MAD is the mean of the 6th and 7th radii; with the lower
    # one alone the 3-MAD rule would drop the far points.
    x = np.r_[np.full(6, 0.40), 0.42, 0.46, 0.50, 0.56, 0.62, 0.70].astype(np.float32)
    y = np.full(12, 0.5, np.float32)
    k = np.stack([x, y], -1).reshape(1, 24)
    want = np.asarray(jcrop.crop_box_from_keypoints(jnp.asarray(k), 1.5))
    got = crop.crop_box_from_keypoints(_t(k), 1.5).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    def lower_median(v):
        return torch.median(v, dim=-1, keepdim=True).values

    real = crop._median
    try:
        crop._median = lower_median
        wrong = crop.crop_box_from_keypoints(_t(k), 1.5).numpy()
    finally:
        crop._median = real
    assert np.abs(wrong - want).max() > 1e-3, (wrong, want)


def test_clamp_map_and_gate_match_jax():
    rs = np.random.RandomState(2)
    box = np.stack([rs.uniform(-0.2, 1.2, B), rs.uniform(-0.2, 1.2, B),
                    rs.uniform(0.05, 1.4, B)], -1).astype(np.float32)
    np.testing.assert_allclose(crop.clamp_box(_t(box)).numpy(),
                               np.asarray(jcrop.clamp_box(jnp.asarray(box))), atol=1e-7)
    box = np.asarray(jcrop.clamp_box(jnp.asarray(box)))
    k = _kp(3)
    local = crop.map_keypoints_to_crop(_t(k), _t(box))
    np.testing.assert_allclose(local.numpy(), np.asarray(jcrop.map_keypoints_to_crop(
        jnp.asarray(k), jnp.asarray(box))), rtol=1e-6, atol=1e-6)
    back = crop.map_keypoints_from_crop(local, _t(box))
    np.testing.assert_allclose(back.numpy(), np.asarray(jcrop.map_keypoints_from_crop(
        jnp.asarray(local.numpy()), jnp.asarray(box))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), k, atol=1e-6)  # the round trip
    fine = (k + rs.randn(*k.shape).astype(np.float32) * 0.02).astype(np.float32)
    got, keep = crop.gate_keypoints(_t(fine), _t(k), 0.02)
    jgot, jkeep = jcrop.gate_keypoints(jnp.asarray(fine), jnp.asarray(k), 0.02)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < keep.float().mean() < 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


def test_jitter_box_apply_fed_jax_draws():
    box = np.asarray(jcrop.crop_box_from_keypoints(jnp.asarray(_kp(4)), 1.5))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jcrop.jitter_box(key, jnp.asarray(box)))
    ks, kc = jax.random.split(key)  # jitter_box's own draws under that key
    f = np.asarray(jax.random.uniform(ks, (B,), minval=1.05, maxval=1.5))
    d = np.asarray(jax.random.uniform(kc, (B, 2), minval=-0.08, maxval=0.08))
    got = crop.apply_jitter(_t(box), _t(f), _t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(3)
    a = crop.jitter_box(g, _t(box))
    f, d = crop.draw_jitter(torch.Generator().manual_seed(3), (B,))
    assert ((f >= 1.05) & (f < 1.5)).all() and (d.abs() <= 0.08).all()
    torch.testing.assert_close(a, crop.apply_jitter(_t(box), f, d), rtol=0, atol=0)
    assert ((a[:, 2] >= crop.MIN_BOX_SIZE) & (a[:, 2] <= 1.0)).all()


def test_crop_resize_matches_jax():
    rs = np.random.RandomState(5)
    images = rs.rand(4, 64, 96, 3).astype(np.float32)
    box = np.array([[0.5, 0.5, 0.3], [0.1, 0.1, 0.2], [0.95, 0.9, 0.25], [0.5, 0.5, 1.0]],
                   np.float32)
    want = np.asarray(jcrop.crop_resize(jnp.asarray(images), jnp.asarray(box), (40, 64)))
    got = crop.crop_resize(_t(images), _t(box), (40, 64))
    assert got.dtype == torch.float32 and got.shape == (4, 40, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # uint8 frames are resampled as their float values.
    u8 = (images * 255).astype(np.uint8)
    np.testing.assert_allclose(
        crop.crop_resize(_t(u8), _t(box), (40, 64)).numpy(),
        np.asarray(jcrop.crop_resize(jnp.asarray(u8), jnp.asarray(box), (40, 64))),
        rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("gate", [0.02, None])
def test_crop_refine_pipeline_matches_jax(gate):
    rs = np.random.RandomState(6)
    images = rs.rand(3, 48, 64, 3).astype(np.float32)
    wc = (rs.randn(48 * 64 * 3, 24) * 0.002).astype(np.float32)
    wf = (rs.randn(24 * 32 * 3, 24) * 0.002).astype(np.float32)
    bc = rs.randn(24).astype(np.float32)

    def jfn(w, b):
        return lambda x: x.reshape(x.shape[0], -1) @ jnp.asarray(w) + jnp.asarray(b)

    def fn(w, b):
        return lambda x: x.reshape(x.shape[0], -1) @ _t(w) + _t(b)

    jpipe = jcrop.CropRefinePipeline(jfn(wc, bc), jfn(wf, 0.5 * bc), crop_hw=(24, 32),
                                     gate=gate)
    pipe = crop.CropRefinePipeline(fn(wc, bc), fn(wf, 0.5 * bc), crop_hw=(24, 32), gate=gate)
    want = {k: np.asarray(v) for k, v in jax.jit(lambda x: jpipe(x))(jnp.asarray(images)).items()}
    got = {k: v.numpy() for k, v in pipe(_t(images)).items()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if w.dtype == bool:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5, err_msg=k)


def test_facade_keypoints_mode_matches_jax():
    """The facade in keypoints mode: ``encode_targets`` with crop windows
    (keypoints and box in crop-local coordinates) within 1e-6 of JAX's, the
    sigmoid, and the decode of the labels within 0.05 deg and 1 mm."""
    from spef_tpu.codec.facade import SPEUtils as JUtils
    from spef_tpu.data.camera import DSPEED_CAMERA as JCAM
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import DSPEED_CAMERA

    rs = np.random.RandomState(8)
    q = rs.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-0.5, 0.5, B), rs.uniform(-0.5, 0.5, B), rs.uniform(5, 15, B)],
                   -1).astype(np.float32)
    crop_w = np.stack([rs.uniform(0.4, 0.6, B), rs.uniform(0.4, 0.6, B),
                       rs.uniform(0.3, 0.6, B)], -1).astype(np.float32)
    kw = dict(ori_mode="keypoints", pos_mode="keypoints")
    jutils, utils = JUtils.create(JCAM, **kw), SPEUtils.create(DSPEED_CAMERA, device="cpu", **kw)
    for c in (None, crop_w):
        want = jutils.encode_targets(jnp.asarray(q), jnp.asarray(pos),
                                     None if c is None else jnp.asarray(c))
        got = utils.encode_targets(_t(q), _t(pos), None if c is None else _t(c))
        assert sorted(got) == sorted(want) == ["bbox", "keypoints", "ori", "pos"]
        for k in ("keypoints", "bbox"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    logits = rs.randn(B, 24).astype(np.float32)
    np.testing.assert_allclose(
        utils.last_activ({"keypoints": _t(logits)})["keypoints"].numpy(),
        np.asarray(jutils.last_activ({"keypoints": jnp.asarray(logits)})["keypoints"]),
        rtol=0, atol=1e-7)
    labels = np.asarray(jutils.encode_targets(jnp.asarray(q), jnp.asarray(pos))["keypoints"])
    mine = utils.decode({"keypoints": _t(labels)})
    theirs = jutils.decode({"keypoints": jnp.asarray(labels)})
    dot = np.clip(np.abs((mine["ori"].numpy().astype(np.float64)
                          * np.asarray(theirs["ori"], np.float64)).sum(-1)), 0, 1)
    assert np.degrees(2 * np.arccos(dot)).max() <= 0.05
    np.testing.assert_allclose(mine["pos"].numpy(), np.asarray(theirs["pos"]), atol=1e-3)
