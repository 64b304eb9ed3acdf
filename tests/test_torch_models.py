"""Port parity: float models, weight carry, soft-class codec and config.

Everything runs on the CPU in float32 on both sides (the JAX backbone is
built with ``compute_dtype=float32``), on the trained flagship checkpoint
``experiments/train_synth/exp_dspeed_synth``.  Inputs come from numpy seeds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from spef_tpu.codec.facade import SPEUtils as JaxSPEUtils
from spef_tpu.codec.softclass import (
    OrientationSoftClassification as JaxOri,
    PositionSoftClassification as JaxPos,
)
from spef_tpu.config.train_config import load_config as jax_load_config
from spef_tpu.data.camera import SPEED_CAMERA as JAX_CAMERA
from spef_tpu.engine import build_predict_fn as jax_build_predict_fn
from spef_tpu.models.heads import URSONetHead as JaxHead
from spef_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from spef_tpu.models.wrapper import ModelWrapper as JaxWrapper
from spef_tpu.models.wrapper import SPEModel
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.codec.softclass import OrientationSoftClassification, PositionSoftClassification
from spef_tpu_torch.config import yamlite
from spef_tpu_torch.config.train_config import load_config
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.engine import SPETorch, build_predict_fn
from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
from spef_tpu_torch.models.wrapper import import_model, load_flax_variables

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
PARAMS = os.path.join(FLAGSHIP, "model", "parameters.msgpack")
N_ORI, N_POS = 1232, 1000


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def flax_tree():
    with open(PARAMS, "rb") as f:
        return serialization.msgpack_restore(f.read())


@pytest.fixture(scope="module")
def port_model():
    return import_model(params_path=PARAMS, ori_mode="classification", n_ori_bins=N_ORI,
                        pos_mode="classification", n_pos_bins=N_POS, device="cpu",
                        compute_dtype=torch.float32)


def test_msgpack_reader_matches_flax(flax_tree):
    ours = read_flax_msgpack(PARAMS)
    a, b = dict(_flatten(ours)), dict(_flatten(flax_tree))
    assert a.keys() == b.keys() and len(a) == 264
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def test_weight_carry_layouts(flax_tree, port_model):
    sd = port_model.state_dict()
    p, s = flax_tree["params"], flax_tree["batch_stats"]
    bb = p["backbone"]
    cases = {
        "backbone.stem.conv.weight": np.transpose(bb["stem"]["conv"]["kernel"], (3, 2, 0, 1)),
        "backbone.block_3.depthwise.conv.weight":
            np.transpose(bb["block_3"]["depthwise"]["conv"]["kernel"], (3, 2, 0, 1)),
        "backbone.block_16.project.conv.weight":
            np.transpose(bb["block_16"]["project"]["conv"]["kernel"], (3, 2, 0, 1)),
        "backbone.head_conv.bn.weight": bb["head_conv"]["bn"]["scale"],
        "backbone.block_5.expand.bn.bias": bb["block_5"]["expand"]["bn"]["bias"],
        "backbone.block_5.expand.bn.running_mean":
            s["backbone"]["block_5"]["expand"]["bn"]["mean"],
        "backbone.block_5.expand.bn.running_var":
            s["backbone"]["block_5"]["expand"]["bn"]["var"],
        "head.ori_fc.weight": p["head"]["ori_fc"]["kernel"].T,
        "head.pos_fc.bias": p["head"]["pos_fc"]["bias"],
    }
    assert sd["backbone.block_3.depthwise.conv.weight"].shape == (144, 1, 3, 3)
    for name, want in cases.items():
        np.testing.assert_array_equal(sd[name].numpy(), want, err_msg=name)


def test_weight_carry_rejects_a_tree_that_does_not_fit(flax_tree):
    model = import_model(ori_mode="classification", n_ori_bins=N_ORI,
                         pos_mode="classification", n_pos_bins=N_POS, device="cpu")
    broken = {"params": dict(flax_tree["params"]), "batch_stats": flax_tree["batch_stats"]}
    broken["params"]["head"] = {"ori_fc": flax_tree["params"]["head"]["ori_fc"]}
    with pytest.raises(ValueError, match="pos_fc"):
        load_flax_variables(model, broken)


def test_init_is_seeded_and_kaiming_fan_out():
    kw = dict(ori_mode="classification", n_ori_bins=N_ORI, pos_mode="classification",
              n_pos_bins=N_POS, device="cpu")
    a, b, c = import_model(seed=3, **kw), import_model(seed=3, **kw), import_model(seed=4, **kw)
    wa, wb, wc = (m.backbone.head_conv.conv.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # fan_out = 1280 * 1 * 1 -> std sqrt(2/1280); 409,600 draws.
    assert abs(wa.std().item() / np.sqrt(2.0 / 1280) - 1.0) < 0.01
    assert abs(a.head.ori_fc.weight.std().item() / 0.01 - 1.0) < 0.01


def _jax_flagship(flax_tree):
    module = JaxWrapper(backbone=JaxMobileNetV2(out_features=1280, compute_dtype=jnp.float32),
                        head=JaxHead(n_ori_outputs=N_ORI, n_pos_outputs=N_POS,
                                     compute_dtype=jnp.float32))
    return SPEModel(module=module, variables=flax_tree, backbone_name="mobilenet_v2",
                    head_name="ursonet")


def test_float_flagship_forward_and_pose_match_jax(flax_tree, port_model):
    """uint8 frames -> /255 -> MobileNetV2 + URSONet -> softmax -> decode, at
    batch 2, 240x384, float32 on both sides.  Stated tolerance: logits
    within 1e-3 absolute (two float32 conv stacks 54 layers deep, summing in
    different orders); decoded orientation within 0.05 degrees (compared up
    to quaternion sign) and position within 1 mm."""
    frames = np.random.RandomState(0).randint(0, 256, (2, 240, 384, 3), np.uint8)
    jax_utils = JaxSPEUtils.create(JAX_CAMERA, ori_mode="classification",
                                   pos_mode="classification", use_keypoints=False)
    jax_model = _jax_flagship(flax_tree)
    want_raw = jax.jit(lambda x: jax_model.apply(x.astype(jnp.float32) / 255.0))(frames)
    want = jax.jit(jax_build_predict_fn(jax_model, jax_utils))(frames)

    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification",
                            pos_mode="classification", device="cpu")
    with torch.inference_mode():
        got_raw = port_model(torch.from_numpy(frames).float() / 255.0)
    got = build_predict_fn(port_model, utils)(torch.from_numpy(frames))
    for g, w in zip(got_raw, want_raw):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)
    dots = np.abs((got["ori"].numpy() * np.asarray(want["ori"])).sum(-1))
    assert (2 * np.degrees(np.arccos(np.minimum(dots, 1.0))) < 0.05).all()
    np.testing.assert_allclose(got["pos"].numpy(), np.asarray(want["pos"]), rtol=0, atol=1e-3)
    assert got["ori_soft"].shape == (2, N_ORI) and got["pos_soft"].shape == (2, N_POS)

    pose, latency_ms = SPETorch(port_model, utils, device="cpu").predict(frames)
    torch.testing.assert_close(pose["pos"], got["pos"], rtol=0, atol=0)
    assert latency_ms > 0


def test_softclass_histograms_and_decode_match_jax():
    """Histograms within 1e-6 (float32 cos/sin); decode of random PDFs: the
    quaternions up to sign within 1e-4, the inverse within 1e-3 relative
    (float32 eigh / inv on both sides), positions within 1e-5 m."""
    ori, jori = OrientationSoftClassification.create(12, device="cpu"), JaxOri.create(12)
    pos, jpos = PositionSoftClassification.create(10, device="cpu"), JaxPos.create(10)
    assert ori.n_bins == jori.n_bins == N_ORI and pos.n_bins == jpos.n_bins == N_POS
    np.testing.assert_allclose(ori.histogram.numpy(), np.asarray(jori.histogram), atol=1e-6)
    np.testing.assert_array_equal(ori.redundant_flags.numpy(), np.asarray(jori.redundant_flags))
    np.testing.assert_allclose(pos.histogram.numpy(), np.asarray(jpos.histogram), atol=1e-6)

    rng = np.random.RandomState(1)
    logits = rng.randn(16, N_ORI).astype(np.float32) * 4.0
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    q, h_inv = ori.decode(torch.from_numpy(probs))
    jq, jh_inv = jori.decode(jnp.asarray(probs))
    sign = np.sign((q.numpy() * np.asarray(jq)).sum(-1, keepdims=True))
    np.testing.assert_allclose(q.numpy() * sign, np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(h_inv.numpy(), np.asarray(jh_inv), rtol=1e-3, atol=1e-3)
    q1, _ = ori.decode(torch.from_numpy(probs[0]))
    assert q1.shape == (4,)

    pprobs = rng.rand(16, N_POS).astype(np.float32)
    np.testing.assert_allclose(pos.decode(torch.from_numpy(pprobs)).numpy(),
                               np.asarray(jpos.decode(jnp.asarray(pprobs))), atol=1e-5)


def test_facade_keypoints_mode_names_the_roadmap_item():
    # The keypoints mode is ported (ROADMAP §A, item 8): the facade builds
    # its keypoint helper and applies the sigmoid; it refuses the mode only
    # without keypoint support.
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="keypoints", pos_mode="keypoints",
                            device="cpu")
    assert utils.keypoints is not None and utils.keypoints_mode
    x = torch.linspace(-3, 3, 24)[None]
    torch.testing.assert_close(utils.last_activ({"keypoints": x})["keypoints"], torch.sigmoid(x))
    with pytest.raises(ValueError, match="keypoint support"):
        SPEUtils.create(SPEED_CAMERA, ori_mode="keypoints", pos_mode="keypoints",
                        use_keypoints=False, device="cpu")


@pytest.mark.parametrize("rel", [
    "experiments/train_synth/exp_dspeed_synth/config.yaml",
    *sorted(os.path.relpath(os.path.join(d, f), REPO)
            for d in (os.path.join(REPO, "configs"),) if os.path.isdir(d)
            for f in os.listdir(d) if f.endswith(".yaml"))[:4],
])
def test_config_parser_matches_pyyaml(rel):
    path = os.path.join(REPO, rel)
    with open(path) as f:
        text = f.read()
    assert yamlite.safe_load(text) == yaml.safe_load(text)
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()
    cfg = load_config(path)
    assert yaml.safe_load(cfg.dump()) == yaml.safe_load(jax_load_config(path).dump())


def test_camera_copy_matches():
    import dataclasses

    assert dataclasses.asdict(SPEED_CAMERA) == dataclasses.asdict(JAX_CAMERA)
    np.testing.assert_array_equal(SPEED_CAMERA.K, JAX_CAMERA.K)
