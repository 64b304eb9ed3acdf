"""Data-parallel training (``parallel/mesh.py``) on the CPU, in gloo
process groups, against JAX's single-device step and the port's own.

JAX's mesh only places the data: its sharded step equals its single-device
step on the global batch (``tests/test_train_e2e.py``).  The port's mesh
keeps that meaning across processes.

  * Two gloo ranks, each with two rows of a global batch of 4 (48x64), take
    one SGD step of ``small_mobile`` + URSONet (float32, orientation
    classification, position regression: the Frobenius-norm loss is not a
    mean of per-frame terms, so it needs the global batch).  Rank 0's
    parameters and BN statistics against JAX's jitted single-device step on
    the same variables and batch: within 1e-5 (the
    ``tests/test_torch_train_step.py`` tolerance; summation orders differ
    and the synced BN takes flax's one-pass variance), the loss within
    1e-5 relative.  Against the port's single-process step, dropout 0.2 on
    (the ranks draw the global batch's mask): within 1e-6.
  * ``apps.train --data-parallel`` under ``torch.distributed.run`` with two
    CPU ranks (the flagship's config cut to ``small_mobile`` at 48x64:
    device augmentation and dropout on, SGD, one epoch of two batches of 4):
    its final weights and running variances within 2e-3 (half a bf16 step)
    of each tensor's largest magnitude of the single-process run's, each
    running mean within 2e-3 of its layer's activation scale (the square
    root of the largest running variance), plus 1e-6 (the BN biases move
    from 0 by about 1e-7 in two steps).  The CLI's model convolves in
    bf16, and two rows a rank instead of four change how the CPU convolution
    blocks its sums, so the bf16 rounding of a few activations (seen: 1.1e-4
    relative on a running variance, 5.5e-5 on means of about 1e-5 whose
    variances are about 1).  BatchNorm statistics taken per rank fail
    both this and the JAX comparison (a copy with the sync removed: 22 of
    192 values of one running variance beyond the bound).
  * ``--data-parallel`` without ``torch.distributed.run`` (world size 1)
    writes the same bytes as the run without the flag.
  * On a host with two or more cards (marked ``cuda``; they skip on one),
    over NCCL, one rank a card (4, or 2 on a host of 2-3 cards):
    - the float32 step of ``small_mobile`` (48x64, a global batch of 16,
      dropout 0.2, TF32 off) against one card's, within 1e-5 (the JAX
      comparison's bound; 6e-7 on 4 gloo ranks on the CPU);
    - ``apps.train`` on the flagship at 240x384 with the host warp (one
      epoch of two global batches of 16) against one card: rank 0's folder
      alone, finite weights, rank 0 warping fewer frames than one card
      while drawing for all 32, and the epoch's printed train and valid
      losses within 1e-3 relative of one card's.  Its weights are not held
      leaf by leaf: MobileNetV2 at its random init turns float32 rounding
      of BatchNorm's sums into step differences far above 1e-5 (on the CPU
      even one process differs from itself when the variance is taken in
      one pass instead of two), and the bf16 weight gradients are rounded
      on each rank before they are summed.
"""

import os
import pickle
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(1)

B, H, W = 4, 48, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: The steps compared: (backbone, global batch, (H, W), ranks).
SMALL = ("small_mobile", B, (H, W), 2)
FLAGSHIP = ("mobilenet_v2", 16, (240, 384), 4)


def _setup(dropout, backbone="small_mobile", device="cpu"):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import DSPEED_CAMERA
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state

    utils = SPEUtils.create(DSPEED_CAMERA, device=device, ori_mode="classification",
                            n_ori_bins_per_dim=4, pos_mode="regression", n_pos_bins_per_dim=4)
    model = import_model(backbone, "ursonet", ori_mode="classification",
                         n_ori_bins=utils.orientation.n_bins, pos_mode="regression",
                         n_pos_bins=3, device=device, compute_dtype=torch.float32, seed=3)
    model.head.ori_dropout.rate = dropout
    opt, sched = import_optimizer(model.parameters(), 0.01, "SGD", 0.9, 1e-4)
    return utils, model, create_train_state(model, opt, sched)


def _batch(b=B, hw=(H, W)):
    rs = np.random.RandomState(0)
    images = rs.rand(b, *hw, 3).astype(np.float32)
    q = rs.randn(b, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = np.stack([rs.uniform(-1, 1, b), rs.uniform(-1, 1, b), rs.uniform(5, 30, b)],
                   -1).astype(np.float32)
    return images, q, pos


def _step(mesh, dropout, out, case=SMALL, device="cpu"):
    """One float32 train step of ``case`` on ``device`` (TF32 off), the
    global batch's rows of ``mesh`` (all of them without one); rank 0
    pickles (loss, flax variables) to ``out``."""
    from spef_tpu_torch.models.layers import set_data_parallel
    from spef_tpu_torch.models.wrapper import flax_variables
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.step import train_update

    torch.set_num_threads(1)
    backbone, b, hw, _ = case
    if mesh is not None:
        device = mesh.device
    utils, model, state = _setup(dropout, backbone, device)
    images, q, pos = _batch(b, hw)
    q, pos = torch.from_numpy(q).to(device), torch.from_numpy(pos).to(device)
    targets = dict(utils.encode_targets(q, pos), ori=q, pos=pos)
    x = torch.from_numpy(images).to(device)
    if mesh is not None:
        set_data_parallel(model, mesh)
        x = x[mesh.rows(b)]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss, _ = train_update(state, x, targets, utils, SPELoss("classification", "regression"),
                               torch.Generator(device=device).manual_seed(7), mesh=mesh)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    if mesh is None or mesh.rank == 0:
        with open(out, "wb") as f:
            pickle.dump({"loss": float(loss), "vars": flax_variables(model)}, f)


def _rank(rank, port, dropout, out, case, device):
    import torch.distributed as dist

    from spef_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device, rank=rank, size=case[3], init_method=f"tcp://127.0.0.1:{port}")
    try:
        _step(mesh, dropout, out, case)
    finally:
        dist.destroy_process_group()


def _ranks(tmp_path, dropout, case=SMALL, device="cpu"):
    """Rank 0's (loss, variables) of ``case``'s step over its ranks."""
    out = str(tmp_path / f"dp_{dropout}.pkl")
    mp.spawn(_rank, args=(_free_port(), dropout, out, case, device), nprocs=case[3], join=True)
    with open(out, "rb") as f:
        return pickle.load(f)


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), np.asarray(tree)


def _close(got, want, atol, scaled=False):
    """Leaf by leaf within ``atol``; where ``scaled``, within ``atol`` of the
    leaf's largest magnitude, or for a running mean of its layer's largest
    standard deviation."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = 1.0
        if scaled:
            scale = float(np.abs(w).max())
            if k.endswith("/mean"):
                scale = float(np.sqrt(want[k[:-len("mean")] + "var"].max()))
        floor = 1e-6 if scaled else 0.0
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol * scale + floor, err_msg=k)


def test_two_gloo_ranks_take_jax_single_device_step(tmp_path):
    import jax
    import jax.numpy as jnp

    from spef_tpu.codec.facade import SPEUtils as JUtils
    from spef_tpu.data.camera import DSPEED_CAMERA as JCAMERA
    from spef_tpu.models.heads import URSONetHead
    from spef_tpu.models.mobilenet_v2 import SmallMobile
    from spef_tpu.models.wrapper import ModelWrapper
    from spef_tpu.train import step as jstep
    from spef_tpu.train.loss import SPELoss as JLoss
    from spef_tpu.train.optimizer import import_optimizer as jimport_optimizer
    from spef_tpu_torch.models.wrapper import flax_variables

    got = _ranks(tmp_path, 0.0)
    utils, model, _ = _setup(0.0)
    variables = flax_variables(model)
    jutils = JUtils.create(JCAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                           pos_mode="regression", n_pos_bins_per_dim=4)
    module = ModelWrapper(backbone=SmallMobile(compute_dtype=jnp.float32),
                          head=URSONetHead(n_ori_outputs=utils.orientation.n_bins,
                                           n_pos_outputs=3, dropout_rate=0.0))
    tx, _ = jimport_optimizer(0.01, "SGD", 0.9, 1e-4)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=tx.init(variables["params"]), tx=tx,
                             apply_fn=module.apply)
    images, q, pos = _batch()
    targets = jutils.encode_targets(jnp.asarray(q), jnp.asarray(pos))
    train = jax.jit(jstep.make_train_step(jutils, JLoss("classification", "regression")))
    state, metrics = train(state, jnp.asarray(images), targets, jax.random.PRNGKey(0))
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-5)
    _close(got["vars"]["params"], state.params, 1e-5)
    _close(got["vars"]["batch_stats"], state.batch_stats, 1e-5)


def test_two_gloo_ranks_take_the_single_process_step_with_dropout(tmp_path):
    got = _ranks(tmp_path, 0.2)
    _step(None, 0.2, str(tmp_path / "single.pkl"))
    with open(tmp_path / "single.pkl", "rb") as f:
        want = pickle.load(f)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    _close(got["vars"], want["vars"], 1e-6)


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """(config, output root) of one single-process run of the tiny experiment."""
    from spef_tpu_torch.apps import train as train_app

    tmp_path = tmp_path_factory.mktemp("plain")
    cfg = _tiny_experiment(tmp_path)
    out = str(tmp_path / "out")
    assert train_app.main(["--config", cfg, "--out", out, *_COMMON])["exp_dp"]
    return cfg, out


_COMMON = ["--epochs", "1", "--device-augment", "--device", "cpu"]


def _tiny_experiment(tmp_path, backbone="small_mobile", hw=(H, W), batch=B, n_train=8):
    """The flagship's config on a synthetic set of ``n_train`` frames (and 2
    + 2 to evaluate), with ``backbone`` at ``hw``, batches of ``batch`` and
    SGD (Adam's normalized step would magnify the bf16 rounding)."""
    from spef_tpu_torch.data.synthetic import create_synthetic_dataset

    still = create_synthetic_dataset(str(tmp_path / "dspeed"), n_train, 2, 2, img_size=hw,
                                     seed=1001)
    with open(os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth",
                           "config.yaml")) as f:
        cfg = f.read()
    for old, new in {"PATH: /tmp/dspeed_syn/still": f"PATH: {still}",
                     "NAME: mobilenet_v2": f"NAME: {backbone}",
                     "BATCH_SIZE: 64": f"BATCH_SIZE: {batch}",
                     "- 240": f"- {hw[0]}", "- 384": f"- {hw[1]}",
                     "OPTIM: Adam": "OPTIM: SGD"}.items():
        assert old in cfg, old
        cfg = cfg.replace(old, new)
    path = tmp_path / "exp_dp.yaml"
    path.write_text(cfg)
    return str(path)


def _distributed_train(cfg, out, nproc, *flags) -> str:
    """``apps.train --data-parallel`` under ``torch.distributed.run`` with
    ``nproc`` ranks, cut off after ten minutes; its standard output."""
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
         "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), "-m",
         "spef_tpu_torch.apps.train", "--config", cfg, "--out", out, *flags, "--data-parallel"],
        cwd=REPO, check=True, timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, text=True).stdout


def _weights(out):
    from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack

    return read_flax_msgpack(os.path.join(out, "exp_dp", "model", "parameters.msgpack"))


def test_train_cli_under_torch_distributed_run(plain_run, tmp_path):
    cfg, plain = plain_run
    _distributed_train(cfg, str(tmp_path / "dp"), 2, *_COMMON)
    _close(_weights(str(tmp_path / "dp")), _weights(plain), 2e-3, scaled=True)
    assert sorted(os.listdir(tmp_path / "dp")) == ["exp_dp"]  # one folder, rank 0's


def test_world_size_one_changes_nothing(plain_run, tmp_path):
    from spef_tpu_torch.apps import train as train_app

    cfg, plain = plain_run
    out = str(tmp_path / "flag")
    assert train_app.main(["--config", cfg, "--out", out, *_COMMON, "--data-parallel"])["exp_dp"]
    name = os.path.join("exp_dp", "model", "parameters.msgpack")
    with open(os.path.join(out, name), "rb") as f, open(os.path.join(plain, name), "rb") as g:
        assert f.read() == g.read()


def _card_ranks():
    """The ranks of the tests over cards: 4 where the host has them, else 2."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices (NCCL, one rank a card)")
    return 4 if torch.cuda.device_count() >= 4 else 2


@pytest.mark.cuda
def test_nccl_ranks_take_the_single_card_step(tmp_path):
    case = ("small_mobile", 16, (H, W), _card_ranks())
    got = _ranks(tmp_path, 0.2, case, "cuda")
    _step(None, 0.2, str(tmp_path / "single.pkl"), case, "cuda")
    with open(tmp_path / "single.pkl", "rb") as f:
        want = pickle.load(f)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    _close(got["vars"], want["vars"], 1e-5)


def _printed(text, pattern):
    """The floats of every match of ``pattern``'s groups in ``text``."""
    return [tuple(float(v) for v in m.groups()) for m in re.finditer(pattern, text)]


@pytest.mark.cuda
def test_train_cli_over_cards_under_torch_distributed_run(tmp_path):
    _flagship_cli_over_ranks(tmp_path, _card_ranks())


def _flagship_cli_over_ranks(tmp_path, nproc, *flags):
    """``apps.train`` on the flagship at 240x384 with the host warp, one
    epoch of two global batches of 16, over ``nproc`` ranks against one
    process (``flags``: e.g. the device)."""
    from spef_tpu_torch.apps import train as train_app

    cfg = _tiny_experiment(tmp_path, "mobilenet_v2", (240, 384), 16, 32)
    want = train_app.main(["--config", cfg, "--out", str(tmp_path / "plain"), "--epochs",
                           "1", *flags])["exp_dp"]
    text = _distributed_train(cfg, str(tmp_path / "dp"), nproc, "--epochs", "1", *flags)
    assert sorted(os.listdir(tmp_path / "dp")) == ["exp_dp"]  # one folder, rank 0's
    assert all(np.isfinite(w).all() for _, w in _leaves(_weights(str(tmp_path / "dp"))))
    [(warped, frames)] = _printed(text, r"Host warp: (\d+) of (\d+) frames warped")
    print(f"rank 0 warped {warped:.0f} of {frames:.0f} frames; one card "
          f"{want['host_warp']['warped']} of {want['host_warp']['frames']}")
    assert frames == want["host_warp"]["frames"] == 32
    assert 0 < warped < want["host_warp"]["warped"]
    for phase in ("train", "valid"):
        [(loss,)] = _printed(text, r"epoch +1 \[%s *\] loss=([-\d.]+)" % phase)
        print(f"{phase} loss over {nproc} cards {loss} against one card "
              f"{want['loss'][phase][0]:.6f}")
        np.testing.assert_allclose(loss, want["loss"][phase][0], rtol=1e-3, err_msg=phase)
