"""Port parity: ``spef_tpu_torch.pose.rotations`` against
``spef_tpu.pose.rotations``, and the properties ``tests/test_rotations.py``
holds the JAX module to.

Inputs come from seeded numpy, in float32 on both sides.  Stated tolerance:
1e-5 absolute (the same float32 formulas; XLA's and PyTorch's ``sin``,
``cos``, ``atan2`` and ``sqrt`` may differ by an ulp); quaternions are
compared up to sign where the function leaves the sign free (``dcm2quat``
without ``north``).  Euler angles in degrees: 1e-3.  ``generate_orientation``
draws from a ``torch.Generator`` where JAX takes a key: it is held to unit
norm and to the moments of the uniform distribution on the 3-sphere, not to
JAX's bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.pose import rotations as jrot
from spef_tpu_torch.pose import rotations as rot

torch.set_num_threads(1)

ATOL = 1e-5


def _quats(n=64, seed=0):
    q = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _eulers(n=64, seed=0):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(-179, 179, n), rs.uniform(-89, 89, n),
                     rs.uniform(-179, 179, n)], -1).astype(np.float32)


def _same_up_to_sign(a, b, atol=ATOL):
    sign = np.where(np.sum(a * b, -1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose(a * sign, b, atol=atol)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["quat2dcm", "normalize_quaternion", "enforce_north",
                                  "conjugate_quaternion"])
def test_quaternion_functions_match_jax(name):
    q = _quats() * 1.5  # not unit: normalize_quaternion has work to do
    got = getattr(rot, name)(T(q)).numpy()
    want = np.asarray(getattr(jrot, name)(jnp.asarray(q)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL * 3)


def test_quat2euler_matches_jax():
    q = _quats()
    for degrees, atol in ((True, 1e-3), (False, ATOL)):
        got = rot.quat2euler(T(q), degrees=degrees).numpy()
        want = np.asarray(jrot.quat2euler(jnp.asarray(q), degrees=degrees))
        np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("north", [False, True])
def test_dcm2quat_matches_jax_all_branches(north):
    """Random rotations plus rotations by ~180 degrees about each axis, which
    force the three non-trace branches of Spurrier's selection."""
    e = np.concatenate([_eulers(32), np.array(
        [[0, 0, 0], [179, 0, 0], [0, 0, 179], [179, 0, 179]], np.float32)])
    dcm = np.asarray(jrot.euler2dcm(jnp.asarray(e)))
    got = rot.dcm2quat(T(dcm), north=north).numpy()
    want = np.asarray(jrot.dcm2quat(jnp.asarray(dcm), north=north))
    if north:
        np.testing.assert_allclose(got, want, atol=ATOL)
    else:
        _same_up_to_sign(got, want)
    # and the round trip of tests/test_rotations.py
    back = rot.quat2dcm(T(got)).numpy()
    np.testing.assert_allclose(back, dcm, atol=ATOL * 3)


@pytest.mark.parametrize("north", [False, True])
def test_euler2quat_and_euler2dcm_match_jax(north):
    e = _eulers()
    np.testing.assert_allclose(rot.euler2quat(T(e), north=north).numpy(),
                               np.asarray(jrot.euler2quat(jnp.asarray(e), north=north)),
                               atol=ATOL)
    np.testing.assert_allclose(rot.euler2dcm(T(e)).numpy(),
                               np.asarray(jrot.euler2dcm(jnp.asarray(e))), atol=ATOL)
    dcm = rot.euler2dcm(T(e))
    np.testing.assert_allclose(rot.dcm2euler(dcm).numpy(),
                               np.asarray(jrot.dcm2euler(jnp.asarray(dcm.numpy()))), atol=1e-3)
    np.testing.assert_allclose(rot.dcm2euler(dcm).numpy(), e, atol=1e-3)  # round trip
    np.testing.assert_allclose(rot.euler2dcm(T(e)).numpy(),
                               rot.quat2dcm(rot.euler2quat(T(e))).numpy(), atol=ATOL)


def test_multiply_rotate_and_angles_match_jax():
    qa, qb = _quats(16, 1), _quats(16, 2)
    v = np.random.RandomState(3).randn(16, 3).astype(np.float32)
    np.testing.assert_allclose(rot.multiply_quaternions(T(qa), T(qb)).numpy(),
                               np.asarray(jrot.multiply_quaternions(jnp.asarray(qa),
                                                                    jnp.asarray(qb))),
                               atol=ATOL)
    # the product composes the rotations; the conjugate inverts one
    np.testing.assert_allclose(
        rot.quat2dcm(rot.multiply_quaternions(T(qa), T(qb))).numpy(),
        np.einsum("bij,bjk->bik", rot.quat2dcm(T(qa)).numpy(), rot.quat2dcm(T(qb)).numpy()),
        atol=ATOL)
    ident = rot.multiply_quaternions(T(qa), rot.conjugate_quaternion(T(qa))).numpy()
    np.testing.assert_allclose(np.abs(ident[:, 0]), 1.0, atol=ATOL)
    np.testing.assert_allclose(ident[:, 1:], 0.0, atol=ATOL)
    np.testing.assert_allclose(rot.rotate_vector(T(qa), T(v)).numpy(),
                               np.asarray(jrot.rotate_vector(jnp.asarray(qa), jnp.asarray(v))),
                               atol=ATOL * 3)
    np.testing.assert_allclose(rot.quat_angle(T(qa), T(qb)).numpy(),
                               np.asarray(jrot.quat_angle(jnp.asarray(qa), jnp.asarray(qb))),
                               atol=1e-4)
    # Sign-invariant: q against -q is 0 but for float32's rounding of the
    # dot near 1, which 2 * arccos magnifies to 2 * sqrt(2 * 2^-24) ~ 7e-4.
    assert float(rot.quat_angle(T(qa), -T(qa)).abs().max()) < 2e-3


def test_euler_angle_difference_matches_jax_and_wraps():
    a = np.random.RandomState(4).uniform(-360, 360, 64).astype(np.float32)
    b = np.random.RandomState(5).uniform(-360, 360, 64).astype(np.float32)
    np.testing.assert_allclose(rot.euler_angle_difference(T(a), T(b)).numpy(),
                               np.asarray(jrot.euler_angle_difference(jnp.asarray(a),
                                                                      jnp.asarray(b))),
                               atol=1e-4)
    for x, y, want in ((170.0, -170.0, 20.0), (-170.0, 170.0, -20.0), (10.0, 30.0, 20.0)):
        got = float(rot.euler_angle_difference(torch.tensor(x), torch.tensor(y)))
        assert got == pytest.approx(want)


def test_quat2euler_golden_value():
    q = rot.euler2quat(torch.tensor([45.0, 30.0, -60.0]))
    np.testing.assert_allclose(rot.quat2euler(q).numpy(), [45.0, 30.0, -60.0], atol=1e-4)


def test_generate_orientation_unit_and_uniform():
    """Unit quaternions; on the uniform 3-sphere every component has mean 0
    and mean square 1/4, and ``|w|`` has mean 4 / (3 pi).  With 20,000
    draws the standard errors are about 0.004; the bounds are 5 of them."""
    gen = torch.Generator().manual_seed(1001)
    q = rot.generate_orientation(gen, 20000)
    assert q.shape == (20000, 4) and q.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(), 1.0, atol=1e-5)
    qn = q.double().numpy()
    np.testing.assert_allclose(qn.mean(0), 0.0, atol=0.02)
    np.testing.assert_allclose((qn ** 2).mean(0), 0.25, atol=0.01)
    assert abs(np.abs(qn[:, 0]).mean() - 4 / (3 * np.pi)) < 0.01
    again = rot.generate_orientation(torch.Generator().manual_seed(1001), 20000)
    assert torch.equal(q, again)  # the generator alone sets the draw
