"""Port parity: ``train/loss.py`` against ``spef_tpu.train.loss``.

Every loss and its gradient (``torch.autograd`` against ``jax.grad``) on
the same numpy inputs, within 1e-6 relative (float32 on both sides; a
gradient element is held to 1e-6 of the gradient's largest).  Both quirks
are exercised: the Frobenius norm over the whole batch in the position
loss, and dot products above 1 zeroed (not clipped) before ``arccos``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.train import loss as jloss
from spef_tpu_torch.train import loss

torch.set_num_threads(1)

RTOL = 1e-6
B = 6


def _unit(rs, n, d):
    v = rs.randn(n, d).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _softmax(rs, n, k):
    z = rs.randn(n, k).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    target_ori = _unit(rs, B, 4)
    pred_ori = _unit(rs, B, 4)
    # Two rows whose dot product exceeds 1: zeroed, so arccos gives pi/2.
    pred_ori[0] = target_ori[0] * 1.01
    pred_ori[1] = -target_ori[1] * 1.02
    target_pos = np.stack([rs.uniform(-2, 2, B), rs.uniform(-2, 2, B),
                           rs.uniform(5, 30, B)], -1).astype(np.float32)
    pred_pos = (target_pos + rs.randn(B, 3)).astype(np.float32)
    return {
        "ori": (pred_ori, target_ori), "pos": (pred_pos, target_pos),
        "ori_soft": (_softmax(rs, B, 40), _softmax(rs, B, 40)),
        "pos_soft": (_softmax(rs, B, 27), _softmax(rs, B, 27)),
        "keypoints": (rs.rand(B, 24).astype(np.float32), rs.rand(B, 24).astype(np.float32)),
    }


def _check(torch_fn, jax_fn, *arrays):
    """Value and gradient wrt the first argument, port against JAX."""
    want, want_grad = jax.value_and_grad(jax_fn)(*map(jnp.asarray, arrays))
    xs = [torch.from_numpy(np.array(a)) for a in arrays]
    xs[0].requires_grad_(True)
    got = torch_fn(*xs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(xs[0].grad.numpy(), want_grad, rtol=RTOL,
                               atol=RTOL * np.abs(want_grad).max())
    return float(got.detach())


@pytest.mark.parametrize("norm_distance", [True, False])
def test_pos_reg_loss_is_the_frobenius_norm_of_the_batch(norm_distance):
    pred, target = _inputs(0)["pos"]
    got = _check(lambda p, t: loss.pos_reg_loss(p, t, norm_distance),
                 lambda p, t: jloss.pos_reg_loss(p, t, norm_distance), pred, target)
    want = np.sqrt(np.sum((pred.astype(np.float64) - target) ** 2))
    if norm_distance:
        want /= np.sqrt(np.sum(target.astype(np.float64) ** 2))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("norm_distance", [True, False])
def test_ori_reg_loss_zeroes_dot_products_above_one(norm_distance):
    x = _inputs(1)
    (pred, target), (_, pos) = x["ori"], x["pos"]
    got = _check(lambda p, t, tp: loss.ori_reg_loss(p, t, tp, norm_distance),
                 lambda p, t, tp: jloss.ori_reg_loss(p, t, tp, norm_distance), pred, target, pos)
    dots = np.abs(np.sum(pred.astype(np.float64) * target, -1))
    assert (dots[:2] > 1).all()
    ang = np.arccos(np.where(dots > 1, 0.0, dots))
    assert np.allclose(ang[:2], np.pi / 2)
    if norm_distance:
        ang = ang / np.linalg.norm(pos.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got, ang.mean(), rtol=1e-6)


@pytest.mark.parametrize("key", ["ori_soft", "pos_soft"])
def test_soft_class_loss(key):
    pred, target = _inputs(2)[key]
    _check(loss.soft_class_loss, jloss.soft_class_loss, pred, target)


def test_keypoints_loss():
    pred, target = _inputs(3)["keypoints"]
    _check(loss.keypoints_loss, jloss.keypoints_loss, pred, target)


@pytest.mark.parametrize("ori_mode,pos_mode", [
    ("classification", "classification"), ("classification", "regression"),
    ("regression", "classification"), ("regression", "regression"), ("keypoints", "keypoints")])
def test_spe_loss_dispatch_and_gradients(ori_mode, pos_mode):
    x = _inputs(4)
    pred = {k: v[0] for k, v in x.items()}
    target = {k: v[1] for k, v in x.items()}
    keys = sorted(pred)
    jl = jloss.SPELoss(ori_mode, pos_mode, beta=0.7)
    tl = loss.SPELoss(ori_mode, pos_mode, beta=0.7)

    def jfn(*ps):
        return jl.compute_loss(dict(zip(keys, ps)), {k: jnp.asarray(v) for k, v in target.items()})

    want, want_grads = jax.value_and_grad(jfn, argnums=tuple(range(len(keys))))(
        *[jnp.asarray(pred[k]) for k in keys])
    ps = [torch.from_numpy(np.array(pred[k])).requires_grad_(True) for k in keys]
    got = tl(dict(zip(keys, ps)), {k: torch.from_numpy(v) for k, v in target.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    for p, g in zip(ps, want_grads):
        g = np.asarray(g)
        gp = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        np.testing.assert_allclose(gp, g, rtol=RTOL, atol=RTOL * max(np.abs(g).max(), 1e-30))


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        loss.SPELoss("classification", "bogus")
