"""Port parity: ESA scoring (``pose/score.py``, the facade's ``get_score`` /
``score_batch``) and the soft-class targets (``encode``,
``encode_targets``) against the JAX package.

Inputs come from seeded numpy, float32 on both sides.  Stated tolerance:
1e-6 absolute on every error, score and position target (the same float32
formulas; the two libraries' ``arccos``, ``exp`` and reductions may differ
in the last ulp; the orientation error in degrees is 180 / pi times the
radians').  ``2 * arccos`` of a dot near 1 is where float32 shows: one case
holds predictions within 1e-3 of the truth on purpose.

The orientation targets add 1e-4 relative: their Gaussian is narrow
(variance 0.0052 of the normalized angle at 12 bins) and ``arccos`` near 1
multiplies an ulp of the dot product by ``1 / sqrt(1 - dot^2)``, so one ulp
of the ``(B, 4) x (4, n_bins)`` product, which XLA and PyTorch sum in their
own orders, or of the bin quaternions (XLA's and PyTorch's ``sin`` and
``cos``), moves a target by up to 3.4e-5 of itself (seen over five seeds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JaxSPEUtils
from spef_tpu.data.camera import SPEED_CAMERA as JAX_CAMERA
from spef_tpu.pose import score as jscore
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.pose import score

torch.set_num_threads(1)

ATOL = 1e-6


def _poses(n=64, seed=0, near=False):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-5, 5, n), rs.uniform(-5, 5, n), rs.uniform(3, 35, n)], -1)
    dq = rs.randn(n, 4) * (1e-3 if near else 0.3)
    q_pred = q + dq
    q_pred /= np.linalg.norm(q_pred, axis=-1, keepdims=True)
    pos_pred = pos + rs.randn(n, 3) * (1e-3 if near else 0.5)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(q), f32(pos), f32(q_pred * np.where(rs.rand(n, 1) < 0.5, -1, 1)), f32(pos_pred)


@pytest.mark.parametrize("near", [False, True])
def test_pose_errors_and_score_batch_match_jax(near):
    args = _poses(near=near)
    got = score.pose_errors(*args)
    want = jscore.pose_errors(*map(jnp.asarray, args))
    for k in ("pos_error", "norm_pos_error", "ori_error"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0)
    assert int(got["invalid"]) == int(want["invalid"]) == 0
    got = score.score_batch(*args)
    want = jscore.score_batch(*map(jnp.asarray, args))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   atol=ATOL * (60 if k == "ori_error" else 1), rtol=0)


def test_get_score_matches_jax_and_raises_above_1_01():
    q, pos, q_pred, pos_pred = _poses(seed=1)
    true, pred = {"ori": q, "pos": pos}, {"ori": q_pred, "pos": pos_pred}
    got, want = score.get_score(true, pred), jscore.get_score(true, pred)
    assert sorted(got) == sorted(want) == ["esa_score", "ori_error", "ori_score", "pos_error",
                                           "pos_score"]
    for k in got:
        assert abs(got[k] - want[k]) <= ATOL * (60 if k == "ori_error" else 1), k
    # A dot just above 1 is clipped; one above 1.01 is a broken prediction.
    clipped = dict(pred, ori=q * 1.005)
    assert score.get_score(true, clipped)["ori_score"] == pytest.approx(
        jscore.get_score(true, clipped)["ori_score"], abs=ATOL)
    broken = dict(pred, ori=q * 1.02)
    assert int(score.score_batch(q, pos, broken["ori"], pos_pred)["invalid"]) == len(q)
    with pytest.raises(ValueError, match="Intermediate sum"):
        score.get_score(true, broken)
    with pytest.raises(ValueError, match="Intermediate sum"):
        jscore.get_score(true, broken)
    # the facade's staticmethods are the module's
    assert SPEUtils.get_score(true, pred) == got
    sb = SPEUtils.score_batch(true, pred)
    assert float(sb["esa_score"]) == pytest.approx(got["esa_score"], abs=0)


@pytest.mark.parametrize("bins,smooth,delete", [(12, 3, True), (12, 3, False), (6, 2, True)])
def test_encode_and_encode_targets_match_jax(bins, smooth, delete):
    q, pos, _, _ = _poses(n=16, seed=2)
    kw = dict(ori_mode="classification", n_ori_bins_per_dim=bins, ori_smooth_factor=smooth,
              ori_delete_unused_bins=delete, pos_mode="classification", n_pos_bins_per_dim=10,
              pos_smooth_factor=100)
    utils = SPEUtils.create(SPEED_CAMERA, device="cpu", **kw)
    jutils = JaxSPEUtils.create(JAX_CAMERA, use_keypoints=False, **kw)
    got = utils.encode_targets(torch.from_numpy(q), torch.from_numpy(pos))
    want = jutils.encode_targets(jnp.asarray(q), jnp.asarray(pos))
    assert sorted(got) == sorted(want) == ["ori", "ori_soft", "pos", "pos_soft"]
    for k, rtol in (("ori_soft", 1e-4), ("pos_soft", 0)):
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=rtol)
        np.testing.assert_allclose(got[k].sum(-1).numpy(), 1.0, atol=1e-5)
    if not delete:  # the redundant bins get no mass
        assert float(got["ori_soft"][:, utils.orientation.redundant_flags].abs().max()) == 0.0
    # One sample without a batch dimension encodes as its row.
    np.testing.assert_allclose(utils.orientation.encode(torch.from_numpy(q[0])).numpy(),
                               got["ori_soft"][0].numpy(), atol=ATOL, rtol=1e-4)
    # Regression modes add no soft targets.
    reg = SPEUtils.create(SPEED_CAMERA, device="cpu").encode_targets(
        torch.from_numpy(q), torch.from_numpy(pos))
    assert sorted(reg) == ["ori", "pos"]
