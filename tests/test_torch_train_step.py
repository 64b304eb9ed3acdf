"""Port parity: ``train/step.py`` against ``spef_tpu.train.step``.

The float ``small_mobile`` and ``small`` backbones with the URSONet head,
float32 on both sides (``compute_dtype`` float32 in both packages), at
48x64, batch 4, ``dropout_rate=0`` on both heads, the same initial
variables (the port's init carried into the flax tree) and the same
targets (encoded once by JAX): three SGD steps (lr 0.01, momentum 0.9,
weight decay 1e-4) through JAX's jitted step and the port's.

  * The loss of every step within 1e-5 relative.
  * After the three steps every parameter and BN statistic within 1e-5
    absolute (their values are 1e-3 to 3; the convolutions' sums run in
    other orders, and the batch variance is two-pass here, one-pass in
    flax: seen up to 8e-7 on parameters, 4e-6 on running variances).
  * One ``small_mobile_q`` step (8-bit recipe) with ``clip_batchnorm``:
    BN scales drawn in [0.5, 1.5] are clamped to [0, 1] at the same places;
    the loss within 1e-5 relative; parameters within 1e-4, each BN
    statistic within 1e-3 of its tensor's largest.  Float32 noise in the
    batch statistics moves a few fake-quantized activations by one grid
    step (1/127 of a range), and the layers after them and the
    straight-through gradients with them.

Adam is held to optax in ``tests/test_torch_optimizer.py``, not through a
network: its ``m / (sqrt(v) + eps)`` turns ulp-level gradient differences
into visible ones wherever ``v`` is tiny.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JUtils
from spef_tpu.data.camera import DSPEED_CAMERA
from spef_tpu.models.heads import URSONetHead as JHead
from spef_tpu.models.mobilenet_v2 import SmallBackbone as JSmall
from spef_tpu.models.mobilenet_v2 import SmallMobile as JSmallMobile
from spef_tpu.models.wrapper import ModelWrapper as JWrapper
from spef_tpu.train import step as jstep
from spef_tpu.train.loss import SPELoss as JLoss
from spef_tpu.train.optimizer import import_optimizer as jimport_optimizer
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.models.layers import Dropout, set_dropout_generator
from spef_tpu_torch.models.wrapper import flax_variables, import_model
from spef_tpu_torch.quant import bitwidth
from spef_tpu_torch.train.loss import SPELoss
from spef_tpu_torch.train.optimizer import import_optimizer
from spef_tpu_torch.train.step import create_train_state, make_eval_step, make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_qat import qat_pair  # noqa: E402

torch.set_num_threads(1)

B, H, W = 4, 48, 64
LR = 0.01


def _utils(ori_mode, pos_mode):
    kw = dict(ori_mode=ori_mode, n_ori_bins_per_dim=4, pos_mode=pos_mode, n_pos_bins_per_dim=4)
    return JUtils.create(DSPEED_CAMERA, **kw), SPEUtils.create(DSPEED_CAMERA, device="cpu", **kw)


def _batches(seed, n):
    rs = np.random.RandomState(seed)
    images = rs.rand(n, B, H, W, 3).astype(np.float32)
    q = rs.randn(n, B, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-1, 1, (n, B)), rs.uniform(-1, 1, (n, B)),
                    rs.uniform(5, 30, (n, B))], -1).astype(np.float32)
    return images, q, pos


def _targets(jutils, q, pos):
    return {k: np.asarray(v) for k, v in
            jutils.encode_targets(jnp.asarray(q), jnp.asarray(pos)).items()}


def _jax_state(module, variables, tx):
    return jstep.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]), tx=tx,
                            apply_fn=module.apply)


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _assert_trees(got, want, atol, scaled=False):
    """Leaf by leaf within ``atol``, or within ``atol`` of the leaf's
    largest magnitude where ``scaled``."""
    got = dict(_leaves(got))
    want = dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        tol = atol * float(np.abs(w).max()) if scaled else atol
        np.testing.assert_allclose(got[k], w, rtol=0.0, atol=tol, err_msg=k)


CASES = {
    "small_mobile": ("small_mobile", JSmallMobile, "classification", "regression"),
    "small": ("small", JSmall, "regression", "classification"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sgd_steps_match_jax(case):
    backbone, jbackbone, ori_mode, pos_mode = CASES[case]
    jutils, utils = _utils(ori_mode, pos_mode)
    n_ori = utils.orientation.n_bins if ori_mode == "classification" else 4
    n_pos = utils.position.n_bins if pos_mode == "classification" else 3
    model = import_model(backbone, "ursonet", ori_mode=ori_mode, n_ori_bins=n_ori,
                         pos_mode=pos_mode, n_pos_bins=n_pos, device="cpu",
                         compute_dtype=torch.float32, seed=3)
    model.head.ori_dropout.rate = 0.0
    variables = flax_variables(model)
    module = JWrapper(backbone=jbackbone(compute_dtype=jnp.float32),
                      head=JHead(n_ori_outputs=n_ori, n_pos_outputs=n_pos, dropout_rate=0.0))
    tx, _ = jimport_optimizer(LR, "SGD", 0.9, 1e-4)
    jst = _jax_state(module, variables, tx)
    jtrain = jax.jit(jstep.make_train_step(jutils, JLoss(ori_mode, pos_mode)))
    opt, sched = import_optimizer(model.parameters(), LR, "SGD", 0.9, 1e-4)
    state = create_train_state(model, opt, sched)
    train = make_train_step(utils, SPELoss(ori_mode, pos_mode))
    gen = torch.Generator().manual_seed(0)
    images, q, pos = _batches(0, 3)
    for i in range(3):
        t = _targets(jutils, q[i], pos[i])
        jst, jm = jtrain(jst, jnp.asarray(images[i]), {k: jnp.asarray(v) for k, v in t.items()},
                         jax.random.PRNGKey(i))
        state, m = train(state, torch.from_numpy(images[i]),
                         {k: torch.from_numpy(v.copy()) for k, v in t.items()}, gen)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["esa_score"]), float(jm["esa_score"]), rtol=1e-4)
    assert state.step == 3 and int(jst.step) == 3
    got = flax_variables(model)
    _assert_trees(got["params"], jst.params, atol=1e-5)
    _assert_trees(got["batch_stats"], jst.batch_stats, atol=1e-5)

    # The eval step on the trained weights: running statistics, no update.
    t = _targets(jutils, q[0], pos[0])
    jmetrics, jdec = jax.jit(jstep.make_eval_step(jutils, JLoss(ori_mode, pos_mode)))(
        jst, jnp.asarray(images[0]), {k: jnp.asarray(v) for k, v in t.items()})
    metrics, dec = make_eval_step(utils, SPELoss(ori_mode, pos_mode))(
        state, torch.from_numpy(images[0]), {k: torch.from_numpy(v.copy()) for k, v in t.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(dec["pos"].numpy(), np.asarray(jdec["pos"]), rtol=1e-4, atol=1e-4)
    assert not model.training and state.step == 3


def test_clip_batchnorm_qat_step_matches_jax():
    bw = bitwidth.default_bit_width(2, w=8, a=8, shared=8)
    jutils, utils = _utils("classification", "regression")
    model, module, variables = qat_pair("small_mobile_q", bw, n_ori=utils.orientation.n_bins)
    model.head.ori_dropout.rate = 0.0
    module = module.clone(head=module.head.clone(dropout_rate=0.0))
    scales = {k: v for k, v in _leaves(variables["params"]) if k.endswith("bn/scale")}
    assert max(float(v.max()) for v in scales.values()) > 1.2  # the clamp has work to do
    tx, _ = jimport_optimizer(LR, "SGD", 0.9)
    jst = _jax_state(module, variables, tx)
    jtrain = jax.jit(jstep.make_train_step(jutils, JLoss("classification", "regression"),
                                           clip_batchnorm=True, compute_metrics=False))
    opt, _ = import_optimizer(model.parameters(), LR, "SGD", 0.9)
    state = create_train_state(model, opt)
    train = make_train_step(utils, SPELoss("classification", "regression"),
                            clip_batchnorm=True, compute_metrics=False)
    images, q, pos = _batches(1, 1)
    t = _targets(jutils, q[0], pos[0])
    jst, jm = jtrain(jst, jnp.asarray(images[0]), {k: jnp.asarray(v) for k, v in t.items()},
                     jax.random.PRNGKey(0))
    state, m = train(state, torch.from_numpy(images[0]),
                     {k: torch.from_numpy(v.copy()) for k, v in t.items()},
                     torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got = flax_variables(model)
    _assert_trees(got["params"], jst.params, atol=1e-4)
    _assert_trees(got["batch_stats"], jst.batch_stats, atol=1e-3, scaled=True)
    for name, want in _leaves(jst.params):
        if name.endswith("bn/scale"):
            mine = dict(_leaves(got["params"]))[name]
            assert mine.min() >= 0.0 and mine.max() <= 1.0
            np.testing.assert_array_equal(mine == 1.0, want == 1.0, err_msg=name)


def test_dropout_draws_from_the_generator_it_is_given():
    drop = Dropout(0.25).train()
    x = torch.ones(4000)
    with pytest.raises(RuntimeError, match="Generator"):
        drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(5))
    a = drop(x)
    set_dropout_generator(drop, torch.Generator().manual_seed(5))
    assert torch.equal(drop(x), a)
    kept = a != 0
    assert 0.7 < float(kept.float().mean()) < 0.8
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert torch.equal(drop.eval()(x), x)
