"""Port parity: ``codec/epnp.py`` and ``codec/keypoints.py`` against
``spef_tpu.codec.epnp`` / ``spef_tpu.codec.keypoints`` on the CPU.

The same poses (32 random D-SPEED poses, seeded numpy) and the same
keypoints go through both packages' solvers, float32 on both sides.  A
decoded pose is compared with JAX's by its orientation distance (deg,
quaternions up to sign, computed in float64) and its position distance:

  * noise-free projections through both ``epnp_solve_batch`` (and the
    unbatched ``epnp_solve``): within 0.05 deg and 1e-4 m of JAX's (seen:
    0.023 deg on one frame at 30 m; the float32 null space at far range
    leaves both packages up to 0.06 deg from the truth), and within 0.1 deg
    and 1 mm of the truth;
  * with noise, poses at 4-12 m (at 30 m 2 px of noise leaves near-equal
    minima, and float32 rounding picks between them: seen 122 deg apart):
  * RANSAC on 2 px of noise with two gross outliers a frame: the same
    inlier masks on at least 30 of 32 frames, the median distance at most
    0.01 deg, and within 0.5 deg on every frame where JAX's winner has at
    least 6 inliers.  A frame with fewer has no outlier-free subset among
    the 16, so both packages fall back to the all-point solve through the
    outliers: an ill-posed 12x12 null space whose float32 answer differs
    between any two implementations (seen: 117 deg apart, both ~19 m from
    the truth);
  * the border-gate weighted path (EPnP and RANSAC) within the same bounds,
    and its fallback to every point below ``min_gated_points``: the
    ungated solve within 0.05 deg, in both packages (unit weights take the
    weighted formulas);
  * collapsed configurations (all keypoints at one far point, NaN
    keypoints, infinite ones): the identity pose and
    ``t = [0, 0, 10]`` in both, no exception.  All keypoints on one pixel
    inside the frame (a saturated sigmoid) is exactly singular: JAX's LU
    meets an exactly zero pivot in the beta Gauss-Newton for all-0 and
    all-1 keypoints (the guard) but not for all-0.5 (a finite pose 1.7 km
    away); the port's pivots there are float32 noise and give finite
    poses.  The test asks of those only a finite pose and no exception;
  * ``undistort_points`` on SPEED+'s Brown coefficients within 1e-6 of
    JAX's, and the distorted projection of ``KeyPoints.project`` within
    1e-3 px;
  * :data:`RANSAC_SUBSETS` equal to ``jax.random.choice`` under
    ``PRNGKey(0)``; ``TANGO_AXES`` / ``TANGO_SUBSET_AXES`` equal to the
    directions of JAX's control points (signs included), and the port's
    control points JAX's whichever signs its ``eigh`` returns.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec import epnp as jepnp
from spef_tpu.codec.keypoints import KeyPoints as JKeyPoints
from spef_tpu.data import camera as jcamera
from spef_tpu.pose.rotations import dcm2quat as jdcm2quat
from spef_tpu_torch.codec import epnp
from spef_tpu_torch.codec.keypoints import TANGO_3D_KEYPOINTS, KeyPoints
from spef_tpu_torch.data import camera
from spef_tpu_torch.pose.rotations import dcm2quat

torch.set_num_threads(1)

B = 32


def _dist(got, want):
    q_a, q_b = np.asarray(got["ori"], np.float64), np.asarray(want["ori"], np.float64)
    dot = np.clip(np.abs((q_a * q_b).sum(-1)), 0.0, 1.0)
    pos = np.linalg.norm(np.asarray(got["pos"], np.float64) - np.asarray(want["pos"]), axis=-1)
    return 2.0 * np.degrees(np.arccos(dot)), pos


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _poses(seed, z_max):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-1, 1, B), rs.uniform(-1, 1, B), rs.uniform(4, z_max, B)],
                   -1).astype(np.float32)
    return q, pos


@pytest.fixture(scope="module")
def poses():
    return _poses(0, 30.0)


@pytest.fixture(scope="module")
def near(kps):
    """Poses at 4-12 m and their labels: with 2 px of noise the solve is
    well posed there (at 30 m the target spans ~110 px and 2 px of noise
    leaves near-equal minima that float32 rounding picks between)."""
    jkp, _ = kps
    q, pos = _poses(1, 12.0)
    return q, pos, np.asarray(jkp.create_keypoints2d(jnp.asarray(q), jnp.asarray(pos)))


@pytest.fixture(scope="module")
def kps():
    return (JKeyPoints.create(jcamera.DSPEED_CAMERA),
            KeyPoints.create(camera.DSPEED_CAMERA, device="cpu"))


@pytest.fixture(scope="module")
def decoders(kps):
    """JAX's decode_batch, jitted once per option set."""
    jkp, _ = kps
    cache = {}

    def decode(k, ransac, border_gate):
        key = (ransac, border_gate)
        if key not in cache:
            cache[key] = jax.jit(lambda x: jkp.decode_batch(x, ransac=ransac,
                                                            border_gate=border_gate))
        return _np(cache[key](jnp.asarray(k)))

    return decode


@pytest.fixture(scope="module")
def labels(poses, kps):
    jkp, pkp = kps
    q, pos = poses
    want = np.asarray(jkp.create_keypoints2d(jnp.asarray(q), jnp.asarray(pos)))
    got = pkp.create_keypoints2d(torch.from_numpy(q), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    return want


def _noisy(labels, seed, px=2.0, outliers=2):
    rs = np.random.RandomState(seed)
    k = labels.reshape(B, 12, 2).copy()
    k += rs.randn(*k.shape) * px / np.array([1920.0, 1200.0])
    for b in range(B):  # two gross outliers among the 11 keypoints
        for i in rs.choice(np.arange(1, 12), outliers, replace=False):
            k[b, i] = rs.uniform(0.05, 0.95, 2)
    return k.reshape(B, 24).astype(np.float32)


def test_ransac_subsets_are_jax_prngkey0():
    want = jax.vmap(lambda k: jax.random.choice(k, 11, shape=(6,), replace=False))(
        jax.random.split(jax.random.PRNGKey(0), 16))
    np.testing.assert_array_equal(np.asarray(epnp.RANSAC_SUBSETS), np.asarray(want))


def test_axis_tables_are_jax_control_frames():
    """TANGO_AXES / TANGO_SUBSET_AXES are the directions, signs included, of
    JAX's control points for the Tango points and each RANSAC subset, and
    with them the port's control points are JAX's, on whatever ``eigh``."""
    from spef_tpu_torch.codec.keypoints import TANGO_AXES, TANGO_SUBSET_AXES

    subsets = np.asarray(epnp.RANSAC_SUBSETS)
    pts = jnp.asarray(TANGO_3D_KEYPOINTS)
    want = np.stack([np.asarray(jax.jit(lambda p: jepnp._choose_control_points(p, None))(pts))]
                    + list(np.asarray(jax.jit(jax.vmap(
                        lambda p: jepnp._choose_control_points(p, None)))(pts[subsets]))))
    d = want[:, 1:] - want[:, :1]
    axes = np.concatenate([TANGO_AXES[None], TANGO_SUBSET_AXES])
    np.testing.assert_allclose(axes, d / np.linalg.norm(d, axis=-1, keepdims=True), atol=2e-6)
    full, sub = torch.from_numpy(TANGO_3D_KEYPOINTS), torch.from_numpy(TANGO_3D_KEYPOINTS[subsets])
    ax, sub_ax = torch.from_numpy(TANGO_AXES), torch.from_numpy(TANGO_SUBSET_AXES)
    np.testing.assert_allclose(epnp._choose_control_points(full, None, ax).numpy(), want[0],
                               atol=1e-5)
    np.testing.assert_allclose(epnp._choose_control_points(sub, None, sub_ax).numpy(), want[1:],
                               atol=1e-5)
    # Every axis flipped by the eigensolver is turned back.
    solver = epnp._sym_eigh
    try:
        epnp._sym_eigh = lambda a: (lambda ew, v: (ew, -v))(*solver(a))
        again = epnp._choose_control_points(full, None, ax)
    finally:
        epnp._sym_eigh = solver
    np.testing.assert_allclose(again.numpy(), want[0], atol=1e-5)


def test_noise_free_epnp_matches_jax_and_truth(poses, kps, labels, decoders):
    q, pos = poses
    _, pkp = kps
    want = decoders(labels, False, None)
    got = _np(pkp.decode_batch(torch.from_numpy(labels)))
    ang, d = _dist(got, want)
    assert ang.max() <= 0.05 and d.max() <= 1e-4, (ang.max(), d.max())
    ang, d = _dist(got, {"ori": q, "pos": pos})
    assert ang.max() <= 0.1 and d.max() <= 1e-3, (ang.max(), d.max())


def test_single_solve_and_no_refine_match_jax(poses, kps, labels):
    _, pkp = kps
    K = np.asarray(camera.DSPEED_CAMERA.K, np.float32)
    px = (labels.reshape(B, 12, 2) * np.array([1920.0, 1200.0], np.float32))[:, 1:]
    r, t = epnp.epnp_solve(TANGO_3D_KEYPOINTS, torch.from_numpy(px[0]), K)
    jr, jt = jepnp.epnp_solve(jnp.asarray(TANGO_3D_KEYPOINTS), jnp.asarray(px[0]),
                              jnp.asarray(K))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-3)
    r, t = epnp.epnp_solve_batch(TANGO_3D_KEYPOINTS, torch.from_numpy(px), K, refine=False)
    jr, jt = jepnp.epnp_solve_batch(jnp.asarray(TANGO_3D_KEYPOINTS), jnp.asarray(px),
                                    jnp.asarray(K), refine=False)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-3)


def test_ransac_with_noise_and_outliers_matches_jax(near):
    q, pos, labels = near
    k = _noisy(labels, 1)
    K = np.asarray(camera.DSPEED_CAMERA.K, np.float32)
    px = (k.reshape(B, 12, 2) * np.array([1920.0, 1200.0], np.float32))[:, 1:]
    jr, jt, jinl = jax.jit(lambda x: jepnp.epnp_ransac(
        jnp.asarray(TANGO_3D_KEYPOINTS), x, jnp.asarray(K)))(jnp.asarray(px))
    r, t, inl = epnp.epnp_ransac(TANGO_3D_KEYPOINTS, torch.from_numpy(px), K)
    assert (inl.numpy() == np.asarray(jinl)).all(-1).sum() >= B - 2
    got = {"ori": dcm2quat(r).numpy(), "pos": t.numpy()}
    ang, d = _dist(got, {"ori": np.asarray(jdcm2quat(jr)), "pos": np.asarray(jt)})
    posed = np.asarray(jinl).sum(-1) >= 6
    assert posed.sum() >= B // 2
    assert np.median(ang) <= 0.01 and ang[posed].max() <= 0.5, np.sort(ang[posed])[-4:]
    # The outliers do not drag the pose off the truth.
    assert np.median(_dist(got, {"ori": q, "pos": pos})[0]) < 5.0


@pytest.mark.parametrize("ransac", [False, True])
def test_border_gate_and_its_fallback_match_jax(kps, near, decoders, ransac):
    _, pkp = kps
    k = _noisy(near[2], 2, outliers=0).reshape(B, 12, 2)
    clean = k.reshape(B, 24).copy()
    k[:, 3] = [0.995, 0.5]  # one border-saturated point a frame: gated out
    k = k.reshape(B, 24)
    want = decoders(k, ransac, 0.02)
    got = _np(pkp.decode_batch(torch.from_numpy(k), ransac=ransac, border_gate=0.02))
    ang, d = _dist(got, want)
    assert np.median(ang) <= 0.01 and ang.max() <= 0.5, np.sort(ang)[-4:]
    # The gate changes the solve: the saturated point is an outlier to it.
    plain = _np(pkp.decode_batch(torch.from_numpy(k), ransac=ransac))
    assert _dist(got, plain)[0].max() > 1e-3
    # A margin of 0.45 leaves fewer than 6 points inside: every frame falls
    # back to the ungated solve, in both packages (unit weights take the
    # weighted formulas: the same solve in another summation order).
    got = _np(pkp.decode_batch(torch.from_numpy(clean), ransac=ransac, border_gate=0.45))
    want = decoders(clean, ransac, 0.45)
    for a, b in ((got, _np(pkp.decode_batch(torch.from_numpy(clean), ransac=ransac))),
                 (want, decoders(clean, ransac, None))):
        assert _dist(a, b)[0].max() <= 0.05


@pytest.mark.parametrize("ransac", [False, True])
def test_collapsed_configuration_hits_the_same_guard(kps, decoders, ransac):
    _, pkp = kps
    guarded = np.stack([np.full(24, 1e20), np.full(24, np.nan),
                        np.full(24, np.inf)]).astype(np.float32)
    saturated = np.stack([np.zeros(24), np.ones(24), np.full(24, 0.5)]).astype(np.float32)
    k = np.concatenate([guarded, saturated])
    want = decoders(k, ransac, None)
    got = _np(pkp.decode_batch(torch.from_numpy(k), ransac=ransac))
    n = len(guarded)
    for out in (want, got):
        np.testing.assert_array_equal(out["pos"][:n], np.tile([0.0, 0.0, 10.0], (n, 1)))
        np.testing.assert_array_equal(np.abs(out["ori"][:n]), np.tile([1.0, 0, 0, 0], (n, 1)))
    assert np.isfinite(got["pos"]).all() and np.isfinite(got["ori"]).all()


def test_undistort_and_distorted_projection_on_speed_plus(poses):
    q, pos = poses
    cam, jcam = camera.SPEED_PLUS_CAMERA, jcamera.SPEED_PLUS_CAMERA
    assert cam.dist_coeffs is not None
    jkp, pkp = JKeyPoints.create(jcam), KeyPoints.create(cam, device="cpu")
    want = np.asarray(jkp.project(jnp.asarray(q), jnp.asarray(pos)))
    got = pkp.project(torch.from_numpy(q), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    K = np.asarray(cam.K, np.float32)
    dist = np.asarray(cam.dist_coeffs, np.float32)
    jund = np.asarray(jepnp.undistort_points(jnp.asarray(want), jnp.asarray(K),
                                             jnp.asarray(dist)))
    und = epnp.undistort_points(torch.from_numpy(want), torch.from_numpy(K),
                                torch.from_numpy(dist)).numpy()
    np.testing.assert_allclose(und, jund, rtol=0, atol=1e-6)
    # The decode through the distortion recovers the pose as JAX's does.
    k = np.asarray(jkp.create_keypoints2d(jnp.asarray(q), jnp.asarray(pos)))
    ang, d = _dist(_np(pkp.decode_batch(torch.from_numpy(k))),
                   _np(jkp.decode_batch(jnp.asarray(k))))
    assert ang.max() <= 0.05 and d.max() <= 1e-3, (ang.max(), d.max())


def test_bbox_matches_jax(kps, labels):
    jkp, pkp = kps
    np.testing.assert_array_equal(
        pkp.create_bbox_from_keypoints(torch.from_numpy(labels)).numpy(),
        np.asarray(jkp.create_bbox_from_keypoints(jnp.asarray(labels))))
