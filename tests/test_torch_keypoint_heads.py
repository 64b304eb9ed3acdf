"""Port parity: the keypoint heads (``models/heads.py``) and their model
assembly (``models/wrapper.py``) against ``spef_tpu.models`` on the CPU.

``small_mobile`` backbones at 48x64 with each keypoint head, the flax
variables initialized by JAX (seeded) and carried onto the port's model
(``load_flax_variables``), the same seeded frames:

  * float32 on both sides (``compute_dtype`` float32 in both packages):
    keypoint logits within 1e-4 (the heatmap head's spatial softmax and
    expectations, the regression head's flatten in NHWC order);
  * the default bf16 convolutions on both sides: the normalized keypoints
    (sigmoid of the logits) within 2e-3 (the bf16 roundings of two
    convolution libraries);
  * ``flax_variables`` gives JAX's tree back, leaf for leaf and layout for
    layout;
  * ``import_model`` of the committed keypoint checkpoints (MobileNetV2 at
    240x384, heatmap and regression heads) holds every value of the file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.models.heads import KeypointHeatmapHead as JHeatmap
from spef_tpu.models.heads import KeypointRegressionHead as JRegression
from spef_tpu.models.mobilenet_v2 import SmallMobile as JSmallMobile
from spef_tpu.models.wrapper import ModelWrapper as JWrapper
from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
from spef_tpu_torch.models.heads import KeypointHeatmapHead, KeypointRegressionHead
from spef_tpu_torch.models.wrapper import flax_variables, import_model, load_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "experiments", "train_synth")
H, W, B = 48, 64, 3
HEADS = {"keypoints_heatmap": JHeatmap, "keypoints_regression": JRegression}


def _frames():
    return np.random.RandomState(0).rand(B, H, W, 3).astype(np.float32)


def _pair(head_name, f32):
    """(JAX module, its variables, the port's model with them carried)."""
    dt = jnp.float32 if f32 else jnp.bfloat16
    jhead = HEADS[head_name]
    head = jhead(n_outputs=24, compute_dtype=dt) if jhead is JHeatmap else jhead(n_outputs=24)
    module = JWrapper(backbone=JSmallMobile(compute_dtype=dt), head=head)
    variables = module.init({"params": jax.random.PRNGKey(4)}, jnp.zeros((1, H, W, 3)), False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if jhead is JHeatmap:  # BN statistics away from their init, so that they count
        rs = np.random.RandomState(1)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda v: (v + rs.uniform(0.1, 0.5, v.shape)).astype(np.float32),
            variables["batch_stats"])
    model = import_model("small_mobile", head_name, ori_mode="keypoints", pos_mode="keypoints",
                         img_size=(H, W), device="cpu",
                         compute_dtype=torch.float32 if f32 else torch.bfloat16)
    load_flax_variables(model, variables)
    return module, variables, model


@pytest.mark.parametrize("head_name", sorted(HEADS))
@pytest.mark.parametrize("f32", [True, False])
def test_keypoint_head_forward_matches_jax(head_name, f32):
    module, variables, model = _pair(head_name, f32)
    expected = {"keypoints_heatmap": KeypointHeatmapHead,
                "keypoints_regression": KeypointRegressionHead}[head_name]
    assert isinstance(model.head, expected)
    x = _frames()
    want = np.asarray(jax.jit(lambda v, i: module.apply(v, i, False))(variables,
                                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (B, 24) and got.dtype == torch.float32
    if f32:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(torch.sigmoid(got).numpy(), 1 / (1 + np.exp(-want)),
                                   rtol=0, atol=2e-3)


@pytest.mark.parametrize("head_name", sorted(HEADS))
def test_flax_variables_round_trip(head_name):
    _, variables, model = _pair(head_name, True)
    back = flax_variables(model)
    for collection in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_flatten_with_path(variables.get(collection, {}))[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back.get(collection, {}))[0])
        assert sorted(map(str, got)) == sorted(map(str, want)), collection
        for path, v in want.items():
            np.testing.assert_array_equal(got[path], v, err_msg=str(path))
    if head_name == "keypoints_regression":  # the NHWC flatten of a 12x16x64 map
        assert model.head.fc.in_features == 12 * 16 * 64


@pytest.mark.parametrize("exp", ["exp_keypoints_heatmap_synth", "exp_keypoints_synth"])
def test_committed_keypoint_checkpoints_load(exp):
    path = os.path.join(SYNTH, exp, "model", "parameters.msgpack")
    head = "keypoints_heatmap" if "heatmap" in exp else "keypoints_regression"
    model = import_model("mobilenet_v2", head, params_path=path, ori_mode="keypoints",
                         pos_mode="keypoints", img_size=(240, 384), device="cpu")
    tree, back = read_flax_msgpack(path), flax_variables(model)
    for collection in ("params", "batch_stats"):
        want = dict(jax.tree_util.tree_flatten_with_path(tree[collection])[0])
        got = dict(jax.tree_util.tree_flatten_with_path(back[collection])[0])
        assert len(got) == len(want)
        for p, v in want.items():
            np.testing.assert_array_equal(got[p], v, err_msg=str(p))
    if head == "keypoints_regression":
        assert model.head.fc.weight.shape == (24, 122880)
