"""Port parity over several epochs: ``Trainer.fit`` against JAX's.

A still split written by the port's writer (48 train and 16 valid frames at
48x64, seed 1001), the float32 ``small_mobile`` + URSONet (soft classes,
4 bins a dimension) with JAX's initial variables carried into the port's
model, ``dropout_rate`` 0 and both augmentations off, so that the only
draw the two loops share is the loaders' numpy shuffle,
``RandomState(seed + epoch)`` in both.  Three epochs of Adam at 1e-3 with
MultiStepLR at [1, 2] (gamma 0.1) through both packages' ``fit``:

  * every epoch's mean train loss and valid loss and ESA within 1e-3
    relative;
  * the learning rate each scheduler step gave, the same;
  * the same best-on-valid epoch (JAX's default ``best_metric``, the
    valid loss), as each ``fit`` prints it;
  * every parameter ``fit`` leaves (the best epoch's) within a quarter of
    its own motion in JAX, ``max|p_port - p_jax| <= 0.25 max|p_jax -
    p_init|`` (worst readings 0.146 block_1/depthwise/conv/kernel, 0.131
    block_1/expand/conv/kernel, 0.104 block_0/expand/conv/kernel), and the
    median leaf's largest difference under 1e-3 (seen 1.8e-4);
  * except where JAX's gradient is nought to rounding: a leaf whose
    gradient RMS over the 18 steps (Adam's bias-corrected second moment in
    JAX's state) stays under 1e-6 everywhere.  Those are the project BN
    biases, whose shift the next BN's batch mean takes out (RMS 2.8e-8 and
    1.3e-9; the smallest other leaf 1.2e-5).  Adam moves such a leaf by a
    fraction of its learning rate a step in a direction the rounding picks
    (``tests/test_torch_train_step.py``), so the two runs part by up to
    their whole motion (seen 1.25 and 0.80 of it, 3.9e-3 and 5.2e-4); they
    are held to twice the sum of the steps' learning rates, the furthest
    Adam can move them (1.33e-2);
  * every BN running statistic within a twentieth of its own motion (worst
    0.0093 block_1/depthwise/bn/mean, 0.0061 head_conv/bn/var), except the
    running mean of the first BN after an exempt bias, which follows that
    bias's shift (seen 1.03 of its motion on head_conv, 3.4e-3) and is held
    to the exempt bound or 1% of its largest magnitude, whichever is
    larger.  The variances do not move with a shift and are all held.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JUtils
from spef_tpu.data.camera import DSPEED_CAMERA as JCAMERA
from spef_tpu.data.dataset import load_dataset as jload_dataset
from spef_tpu.models.heads import URSONetHead as JHead
from spef_tpu.models.mobilenet_v2 import SmallMobile as JSmallMobile
from spef_tpu.models.wrapper import ModelWrapper as JWrapper
from spef_tpu.train import step as jstep
from spef_tpu.train import trainer as jtrainer
from spef_tpu.train.loss import SPELoss as JLoss
from spef_tpu.train.optimizer import import_optimizer as jimport_optimizer
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import DSPEED_CAMERA
from spef_tpu_torch.data.dataset import load_dataset
from spef_tpu_torch.data.synthetic import create_synthetic_dataset
from spef_tpu_torch.models.wrapper import flax_variables, import_model, load_flax_variables
from spef_tpu_torch.train import trainer
from spef_tpu_torch.train.loss import SPELoss
from spef_tpu_torch.train.optimizer import import_optimizer
from spef_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)

HW = (48, 64)
BATCH = 8
EPOCHS = 3
LR = 1e-3
MILESTONES = (1, 2)
SEED = 1001
MODES = dict(ori_mode="classification", n_ori_bins_per_dim=4, pos_mode="classification",
             n_pos_bins_per_dim=4)
METRIC_RTOL = 1e-3
STEPS_AN_EPOCH = 48 // BATCH
PARAM_SHARE = 0.25  # of a parameter's own motion in JAX
STATS_SHARE = 0.05  # of a running statistic's own motion in JAX
GRAD_ROUNDING = 1e-6  # a gradient RMS under this is rounding
EXEMPT_ATOL = 2 * STEPS_AN_EPOCH * (LR + LR * 0.1 + LR * 0.01)
EXEMPT_STATS_SHARE = 1e-2  # of the leaf's largest magnitude
PARAM_MEDIAN = 1e-3


class _Recorded:
    """A scheduler that keeps every learning rate it gave."""

    def __init__(self, scheduler):
        self.scheduler, self.lrs = scheduler, []

    def step(self, epoch, metric=None):
        lr = self.scheduler.step(epoch, metric)
        self.lrs.append(float(lr))
        return lr


def _leaves(tree, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _adam_grad_rms(opt_state):
    """sqrt of Adam's second moment of every parameter (JAX's optimizer state
    after ``fit``): the gradient's running RMS, leaf by leaf."""
    found = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "nu")) if hasattr(x, "nu")]
    assert len(found) == 1, found
    corr = 1.0 - 0.999 ** int(found[0].count)  # optax's b2 bias correction
    return jax.tree_util.tree_map(lambda v: np.sqrt(np.asarray(v) / corr), found[0].nu)


def _in_order(tree, path=()):
    """The leaves' paths in the tree's own order (the port's forward order)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _in_order(v, path + (k,))
        else:
            yield "/".join(path + (k,))


def _best_epoch(text):
    return int(re.findall(r"^Best epoch: (\d+)$", text, re.M)[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    still = create_synthetic_dataset(str(tmp_path_factory.mktemp("fit")), 48, 16, 8,
                                     img_size=HW, seed=SEED)
    jutils = JUtils.create(JCAMERA, **MODES)
    utils = SPEUtils.create(DSPEED_CAMERA, device="cpu", **MODES)
    n_ori, n_pos = utils.orientation.n_bins, utils.position.n_bins

    # JAX's init, carried into the port's model.
    module = JWrapper(backbone=JSmallMobile(compute_dtype=jnp.float32),
                      head=JHead(n_ori_outputs=n_ori, n_pos_outputs=n_pos, dropout_rate=0.0))
    variables = module.init(jax.random.PRNGKey(3), jnp.zeros((1,) + HW + (3,)), False)
    model = import_model("small_mobile", "ursonet", ori_mode="classification",
                         n_ori_bins=n_ori, pos_mode="classification", n_pos_bins=n_pos,
                         device="cpu", compute_dtype=torch.float32, seed=3)
    model.head.ori_dropout.rate = 0.0
    init = jax.tree_util.tree_map(np.array, dict(variables))  # fit donates the buffers
    load_flax_variables(model, init)

    out = {}
    import contextlib
    import io

    tx, jsched = jimport_optimizer(LR, "Adam", milestones=MILESTONES, gamma=0.1)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]), tx=tx,
                              apply_fn=module.apply)
    jdata, jsplit = jload_dataset(still, BATCH, HW, shuffle=True, seed=SEED)
    jt = jtrainer.Trainer(jutils, JLoss("classification", "classification"), JCAMERA,
                          seed=SEED)
    jrec = _Recorded(jsched)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        jstate, *jrecords = jt.fit(jstate, jdata, EPOCHS, jrec, jsplit["train"])
    out["jax"] = {"records": jrecords, "lrs": jrec.lrs, "best": _best_epoch(text.getvalue()),
                  "variables": {"params": jstate.params, "batch_stats": jstate.batch_stats},
                  "init": init,
                  "grad_rms": {"params": _adam_grad_rms(jstate.opt_state)}}

    opt, sched = import_optimizer(model.parameters(), LR, "Adam", milestones=MILESTONES,
                                  gamma=0.1)
    state = create_train_state(model, opt, sched)
    data, split = load_dataset(still, BATCH, HW, shuffle=True, seed=SEED)
    t = trainer.Trainer(utils, SPELoss("classification", "classification"), DSPEED_CAMERA,
                        seed=SEED, device="cpu")
    rec = _Recorded(sched)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        state, *records = t.fit(state, data, EPOCHS, rec, split["train"])
    out["port"] = {"records": records, "lrs": rec.lrs, "best": _best_epoch(text.getvalue()),
                   "variables": flax_variables(state.model),
                   "lr_left": state.optimizer.param_groups[0]["lr"]}
    return out


def test_epoch_losses_and_valid_esa_match_jax(runs):
    (loss, score, _), (jloss, jscore, _) = runs["port"]["records"], runs["jax"]["records"]
    for phase in ("train", "valid"):
        assert len(loss[phase]) == len(jloss[phase]) == EPOCHS
        np.testing.assert_allclose(loss[phase], jloss[phase], rtol=METRIC_RTOL, err_msg=phase)
    np.testing.assert_allclose(score["valid"]["esa"], jscore["valid"]["esa"], rtol=METRIC_RTOL)
    # The run learns: the loss moves over the epochs (not a no-op fit).
    assert loss["train"][-1] < loss["train"][0]


def test_learning_rates_and_best_epoch_match_jax(runs):
    port, jax_ = runs["port"], runs["jax"]
    assert port["lrs"] == pytest.approx(jax_["lrs"], rel=1e-12)
    assert port["lrs"] == pytest.approx([LR * 0.1, LR * 0.01, LR * 0.01], rel=1e-12)
    assert port["lr_left"] == pytest.approx(port["lrs"][-1], rel=1e-12)
    assert port["best"] == jax_["best"]
    valid = runs["port"]["records"][0]["valid"]
    assert port["best"] == 1 + int(np.argmin(valid))


def test_final_parameters_match_jax(runs):
    got = dict(_leaves(runs["port"]["variables"]))
    want = dict(_leaves(runs["jax"]["variables"]))
    init = dict(_leaves(runs["jax"]["init"]))
    grad_rms = {"params/" + k: float(g.max())
                for k, g in _leaves(runs["jax"]["grad_rms"]["params"])}
    assert sorted(got) == sorted(want) == sorted(init)
    assert sorted(grad_rms) == sorted(k for k in want if k.startswith("params/"))
    exempt = {k for k, g in grad_rms.items() if g < GRAD_ROUNDING}
    # The running mean of the first BN after an exempt bias, in forward order.
    following, last_bias = set(), None
    order = [k for k in _in_order(runs["port"]["variables"]["params"])]
    for k in ["params/" + k for k in order if k.endswith("bn/bias")]:
        if last_bias in exempt:
            following.add("batch_stats/" + k[len("params/"):-len("bias")] + "mean")
        last_bias = k
    assert exempt and following <= set(want), (exempt, following)
    worst = {}
    for k, w in want.items():
        diff = float(np.abs(got[k] - w).max())
        motion = float(np.abs(w - init[k]).max())
        worst[k] = diff
        if k in exempt:
            bound = EXEMPT_ATOL
        elif k in following:
            bound = max(EXEMPT_ATOL, EXEMPT_STATS_SHARE * float(np.abs(w).max()))
        elif k.startswith("batch_stats/"):
            bound = STATS_SHARE * motion
        else:
            bound = PARAM_SHARE * motion
        assert motion > 0.0, k
        assert diff <= bound, (k, diff, motion, bound)
    assert len(exempt) < len(grad_rms) // 4, exempt
    assert float(np.median(list(worst.values()))) < PARAM_MEDIAN, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]
