"""``train/trainer.py::Trainer`` and ``train/checkpoint.py`` on the CPU.

  * ``_masked_metrics`` and the targets the trainer encodes against the
    JAX trainer's on the same poses and mask (a padded batch): within 1e-5
    (float32 scoring; the soft-class decode's ``eigh`` in two libraries).
  * ``fit`` on a tiny set written by the port's writer (``small_mobile`` at
    48x64, Adam, both augmentations on the device): the train loss falls;
    with ``best_metric="esa"`` the best epoch is the one of the lowest valid
    ESA and the model left in the state is the one ``best_model.msgpack``
    holds; ``max_to_keep`` epochs are kept on disk.
  * Resume: the optimizer state and the step come back from the latest
    checkpoint, only the remaining epochs run, and the best model is
    reloaded from ``best_model.msgpack``.
  * A non-finite loss raises at the flush, naming the epoch, phase and batch.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JUtils
from spef_tpu.train import trainer as jtrainer
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import DSPEED_CAMERA
from spef_tpu_torch.data.dataset import load_dataset
from spef_tpu_torch.data.synthetic import create_synthetic_dataset
from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
from spef_tpu_torch.models.wrapper import flax_variables, import_model
from spef_tpu_torch.train import trainer
from spef_tpu_torch.train.checkpoint import CheckpointManager
from spef_tpu_torch.train.loss import SPELoss
from spef_tpu_torch.train.optimizer import import_optimizer
from spef_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)

HW = (48, 64)
MODES = dict(ori_mode="classification", n_ori_bins_per_dim=4, pos_mode="classification",
             n_pos_bins_per_dim=4)


@pytest.fixture(scope="module")
def still(tmp_path_factory):
    return create_synthetic_dataset(str(tmp_path_factory.mktemp("ds")), 16, 8, 8,
                                    img_size=HW, seed=1001)


def _setup(still, seed=1001, lr=1e-3):
    utils = SPEUtils.create(DSPEED_CAMERA, device="cpu", **MODES)
    model = import_model("small_mobile", "ursonet", ori_mode="classification",
                         n_ori_bins=utils.orientation.n_bins, pos_mode="classification",
                         n_pos_bins=utils.position.n_bins, device="cpu", seed=seed)
    opt, sched = import_optimizer(model.parameters(), lr, "Adam", milestones=(40, 52))
    data, split = load_dataset(still, 8, HW, shuffle=True, seed=seed)
    t = trainer.Trainer(utils, SPELoss("classification", "classification"), DSPEED_CAMERA,
                        rot_augment=True, other_augment=True, seed=seed, device="cpu")
    return t, create_train_state(model, opt, sched), data, split


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_masked_metrics_and_targets_match_jax():
    rs = np.random.RandomState(0)
    n = 6
    q = rs.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-1, 1, n), rs.uniform(-1, 1, n), rs.uniform(5, 30, n)],
                   -1).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    jutils = JUtils.create(DSPEED_CAMERA, **MODES)
    utils = SPEUtils.create(DSPEED_CAMERA, device="cpu", **MODES)
    jt = jtrainer.Trainer(jutils, None)._encode_targets(jnp.asarray(q), jnp.asarray(pos))
    t = trainer.Trainer(utils, None, device="cpu")._encode_targets(torch.from_numpy(q),
                                                                  torch.from_numpy(pos))
    assert sorted(t) == sorted(jt)
    for k in jt:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(jt[k]), rtol=1e-5, atol=1e-7)
    logits = {k: rs.randn(n, v.shape[-1]).astype(np.float32) * 3 for k, v in t.items()
              if k.endswith("_soft")}
    pose = {k: torch.softmax(torch.from_numpy(v), -1) for k, v in logits.items()}
    want = jtrainer._masked_metrics(jutils, {k: jnp.asarray(v.numpy()) for k, v in pose.items()},
                                    jt, jnp.asarray(mask))
    got = trainer._masked_metrics(utils, pose, t, torch.from_numpy(mask))
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5, err_msg=k)


def test_fit_learns_and_keeps_the_best_on_esa(still, tmp_path):
    t, state, data, split = _setup(still)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    state, rec_loss, rec_score, _ = t.fit(state, data, 4, split=split["train"],
                                          checkpoint_manager=ckpt, best_metric="esa",
                                          verbose=False)
    assert rec_loss["train"][-1] < rec_loss["train"][0]
    assert all(np.isfinite(rec_loss[p]).all() for p in split["train"])
    esa = rec_score["valid"]["esa"]
    best = int(np.argmin(esa)) + 1
    with open(tmp_path / "ckpt" / "best_meta.json") as f:
        meta = json.load(f)
    assert meta["epoch"] == best and meta["best_metric"] == "esa"
    np.testing.assert_allclose(meta["best_value"], min(esa), rtol=1e-12)
    _tree_equal(flax_variables(state.model), read_flax_msgpack(str(tmp_path / "ckpt" /
                                                                   "best_model.msgpack")))
    assert ckpt.epochs() == [3, 4] and state.step == 4 * 2
    assert [s["epoch"] for s in t.epoch_stats] == [1, 2, 3, 4]
    assert all(s["batches"] == 2 and s["frames"] == 16 and s["peak_memory_bytes"] is None
               for s in t.epoch_stats)


def test_resume_restores_the_optimizer_and_the_best(still, tmp_path, capsys):
    t, state, data, split = _setup(still)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    t.fit(state, data, 2, split=split["train"], checkpoint_manager=ckpt, verbose=False)
    saved = torch.load(str(tmp_path / "ckpt" / "ckpt_2.pt"), weights_only=True)
    best_before = read_flax_msgpack(str(tmp_path / "ckpt" / "best_model.msgpack"))

    # A fresh process's view: new model, new optimizer, same directory.
    t2, state2, data2, _ = _setup(still, seed=7)
    restored, meta = CheckpointManager(str(tmp_path / "ckpt")).restore(
        create_train_state(state2.model, state2.optimizer))
    assert meta["epoch"] == 2 and restored.step == 4
    opt_sd = restored.optimizer.state_dict()
    for i, s in saved["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(opt_sd["state"][i][k], v), (i, k)
    for k, v in saved["model"].items():
        assert torch.equal(restored.model.state_dict()[k], v), k

    t3, state3, data3, _ = _setup(still, seed=8)
    state3, rec_loss, _, _ = t3.fit(state3, data3, 3, split=split["train"],
                                    checkpoint_manager=CheckpointManager(str(tmp_path / "ckpt")),
                                    resume=True)
    assert "Resumed from epoch 2" in capsys.readouterr().out
    assert t3.start_epoch == 3 and len(rec_loss["train"]) == 1 and state3.step == 6
    with open(tmp_path / "ckpt" / "best_meta.json") as f:
        best_epoch = json.load(f)["epoch"]
    final = flax_variables(state3.model)
    if best_epoch < 3:  # epoch 3 did not improve: the reloaded best is what is left
        _tree_equal(final, best_before)
    else:
        _tree_equal(final, read_flax_msgpack(str(tmp_path / "ckpt" / "best_model.msgpack")))


def test_non_finite_loss_raises(still):
    t, state, data, split = _setup(still)
    with torch.no_grad():
        state.model.head.pos_fc.bias.fill_(float("nan"))
    with pytest.raises(ValueError, match=r"Non-finite loss at epoch 1 \(train\), batch 0"):
        t.fit(state, data, 1, split=split["train"], verbose=False)


def test_fit_rejects_bad_arguments(still):
    t, state, data, split = _setup(still)
    with pytest.raises(ValueError):
        t.fit(state, data, 1, best_metric="iou")
    with pytest.raises(ValueError):
        t.fit(state, data, 1, split=("train",))
    crop = {"train": [{"images": np.zeros((1,) + HW + (3,), np.uint8),
                       "ori": np.array([[1.0, 0, 0, 0]], np.float32),
                       "pos": np.array([[0, 0, 10.0]], np.float32),
                       "mask": np.ones(1, np.float32), "crop": np.zeros((1, 3), np.float32)}],
            "valid": []}
    with pytest.raises(ValueError, match="crop-refine"):
        t.fit(state, crop, 1, verbose=False)
    assert os.path.isdir(still)
