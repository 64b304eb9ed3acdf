"""Port parity: ``data/augment.py`` against ``spef_tpu.data.augment``.

Each ``apply_*`` gets the values JAX drew (the test repeats JAX's
``split`` / ``uniform`` / ``normal`` calls on the same key) and the same
numpy images, and is held to the JAX transform's output within 1e-5
(float32 on both sides; the warp's source coordinates come from a 3x3
product summed in another order, a few ulp of a coordinate up to 384).
The yaw rotation keeps the pose consistent with the image: a point of the
body frame projects, after the augment, to where the warp moved it.  The
``draw_*`` parts are checked for their ranges and their use of the given
generator (same seed, same draws; another seed, other draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.data import augment as jaug
from spef_tpu_torch.data import augment as aug
from spef_tpu_torch.data.camera import DSPEED_CAMERA

torch.set_num_threads(1)

B, H, W = 4, 48, 64
TOL = 1e-5


def _images(seed):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


def _pose(seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-1, 1, B), rs.uniform(-1, 1, B),
                    rs.uniform(8, 20, B)], -1).astype(np.float32)
    return q, pos


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("seed", [0, 1])
def test_yaw_rotation_apply_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    images = _images(seed)
    ori, pos = _pose(seed)
    want = jaug.yaw_rotation_augment(key, jnp.asarray(images), jnp.asarray(ori),
                                     jnp.asarray(pos), DSPEED_CAMERA)
    # JAX's draws, repeated.
    k_apply, k_mag = jax.random.split(key)
    apply = jax.random.uniform(k_apply, (B,)) < 0.5
    deg = (jax.random.uniform(k_mag, (B,)) - 0.5) * 2.0 * 50.0
    deg = jnp.where(apply, deg, 0.0)
    assert 0 < int(apply.sum()) < B  # rotated and untouched samples in one batch
    got = aug.apply_yaw_rotation(_t(images), _t(ori), _t(pos), DSPEED_CAMERA,
                                 _t(np.asarray(apply)), _t(np.asarray(deg)))
    for g, w in zip(got, want):
        _close(g, w)


def test_yaw_rotation_keeps_the_pose_consistent():
    """A body point projected with the rotated pose lands where the warp
    takes the pixel it projected to with the original pose."""
    from spef_tpu_torch.pose.rotations import euler2dcm, quat2dcm

    cam = DSPEED_CAMERA
    ori, pos = _pose(3)
    deg = torch.tensor([30.0, -20.0, 0.0, 45.0])
    apply = deg != 0
    images = torch.zeros(B, H, W, 3)
    _, ori2, pos2 = aug.apply_yaw_rotation(images, _t(ori), _t(pos), cam, apply, deg)
    k = torch.tensor(cam.K, dtype=torch.float32)
    scale = torch.diag(torch.tensor([W / cam.nu, H / cam.nv, 1.0]))
    k_s = scale @ k
    point = torch.tensor([0.3, -0.2, 0.1])

    def project(q, p):
        cam_pt = quat2dcm(q) @ point + p
        uvw = k_s @ cam_pt
        return uvw[:2] / uvw[2]

    for i in range(B):
        r = euler2dcm(torch.tensor([float(deg[i]), 0.0, 0.0]))
        hom = k_s @ r @ torch.linalg.inv(k_s)
        uv = project(_t(ori[i]), _t(pos[i]))
        moved = hom @ torch.cat([uv, torch.ones(1)])
        want = moved[:2] / moved[2]
        got = project(ori2[i], pos2[i])
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)
        if not apply[i]:
            _close(ori2[i], ori[i], 0.0)
            _close(pos2[i], pos[i], 0.0)


def test_brightness_contrast_apply_matches_jax():
    key = jax.random.PRNGKey(7)
    images = _images(7)
    want = jaug.brightness_contrast(key, jnp.asarray(images))
    ka, kb = jax.random.split(key)
    loga = jax.random.uniform(ka, (B, 1, 1, 1), minval=jnp.log(0.5), maxval=jnp.log(2.0))
    bb = jax.random.uniform(kb, (B, 1, 1, 1), minval=-25.0 / 255, maxval=25.0 / 255)
    got = aug.apply_brightness_contrast(_t(images), _t(np.asarray(jnp.exp(loga))),
                                        _t(np.asarray(bb)))
    _close(got, want)


def test_gaussian_noise_apply_matches_jax():
    key = jax.random.PRNGKey(8)
    images = _images(8)
    want = jaug.gaussian_noise(key, jnp.asarray(images))
    noise = jax.random.normal(key, images.shape)
    _close(aug.apply_gaussian_noise(_t(images), _t(np.asarray(noise))), want)


@pytest.mark.parametrize("seed", [9, 10])
def test_gaussian_blur_apply_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    images = _images(seed)
    want = jaug.gaussian_blur(key, jnp.asarray(images))
    sigma = jax.random.uniform(key, (), minval=0.1, maxval=2.0)
    _close(aug.apply_gaussian_blur(_t(images), _t(np.asarray(sigma))), want)


@pytest.mark.parametrize("seed", [11, 12])
def test_color_jitter_apply_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    images = _images(seed)
    images[0, :4, :4] = 0.5  # grey pixels: delta == 0
    want = jaug.color_jitter(key, jnp.asarray(images))
    kb, kc, ks, kh = jax.random.split(key, 4)
    drawn = {
        "brightness": jax.random.uniform(kb, (B, 1, 1, 1), minval=0.8, maxval=1.2),
        "contrast": jax.random.uniform(kc, (B, 1, 1, 1), minval=0.8, maxval=1.2),
        "saturation": jax.random.uniform(ks, (B, 1, 1, 1), minval=0.8, maxval=1.2),
        "hue": jax.random.uniform(kh, (B, 1, 1), minval=-0.2, maxval=0.2),
    }
    got = aug.apply_color_jitter(_t(images), **{k: _t(np.asarray(v)) for k, v in drawn.items()})
    _close(got, want)


def test_hsv_round_trip_matches_jax():
    rgb = _images(13)
    _close(aug._rgb_to_hsv(_t(rgb)), jaug._rgb_to_hsv(jnp.asarray(rgb)))
    hsv = np.asarray(jaug._rgb_to_hsv(jnp.asarray(rgb)))
    _close(aug._hsv_to_rgb(_t(hsv)), jaug._hsv_to_rgb(jnp.asarray(hsv)))


def test_draws_come_from_the_generator_in_their_ranges():
    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        apply, deg = aug.draw_yaw_rotation(g, 4096)
        a, b = aug.draw_brightness_contrast(g, 4096)
        sigma = aug.draw_gaussian_blur(g)
        jit = aug.draw_color_jitter(g, 4096)
        noise = aug.draw_gaussian_noise(g, (4096,))
        return apply, deg, a, b, sigma, jit, noise

    apply, deg, a, b, sigma, jit, noise = draws(5)
    assert 0.45 < float(apply.float().mean()) < 0.55
    assert bool((deg[~apply] == 0).all()) and float(deg.abs().max()) <= 50.0
    assert float(deg[apply].abs().max()) > 45.0
    assert 0.5 <= float(a.min()) and float(a.max()) <= 2.0
    assert -25 / 255 <= float(b.min()) and float(b.max()) <= 25 / 255
    assert 0.1 <= float(sigma) <= 2.0 and sigma.dim() == 0
    for name in ("brightness", "contrast", "saturation"):
        assert 0.8 <= float(jit[name].min()) and float(jit[name].max()) <= 1.2
    assert jit["hue"].shape == (4096, 1, 1) and float(jit["hue"].abs().max()) <= 0.2
    assert abs(float(noise.std()) - 1.0) < 0.05
    again = draws(5)
    other = draws(6)
    assert torch.equal(again[1], deg) and torch.equal(again[6], noise)
    assert not torch.equal(other[6], noise)


def test_train_augment_runs_both_stacks_and_keeps_shapes():
    g = torch.Generator().manual_seed(0)
    images = _t(_images(14))
    ori, pos = map(_t, _pose(14))
    out, ori2, pos2 = aug.train_augment(g, images, ori, pos, DSPEED_CAMERA)
    assert out.shape == images.shape and ori2.shape == ori.shape and pos2.shape == pos.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert not torch.equal(out, images)
    same = aug.train_augment(g, images, ori, pos, DSPEED_CAMERA, False, False)
    assert all(torch.equal(x, y) for x, y in zip(same, (images, ori, pos)))
