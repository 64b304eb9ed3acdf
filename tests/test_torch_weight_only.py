"""Port parity: ``quant/weight_only.py`` against ``spef_tpu.quant.weight_only``.

The same flax variables (a ``small_mobile`` backbone with each keypoint
head, initialized by JAX, plus a conv's BatchNorm) through both
``quantize_model_weights``: every snapped kernel equal to JAX's bit for
bit once carried back into flax's layout (the grid is per output channel
in flax's layout: HWIO's last axis, a dense kernel's output axis), the
biases and BatchNorm values untouched, the stats equal, and the port's
input model unchanged.  ``min_size`` and ``per_channel=False`` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.models.heads import KeypointHeatmapHead as JHeatmap
from spef_tpu.models.heads import KeypointRegressionHead as JRegression
from spef_tpu.models.mobilenet_v2 import SmallMobile as JSmallMobile
from spef_tpu.models.wrapper import ModelWrapper as JWrapper
from spef_tpu.quant.weight_only import quantize_model_weights as jquantize
from spef_tpu_torch.models.wrapper import flax_variables, import_model, load_flax_variables
from spef_tpu_torch.quant.weight_only import quantize_model_weights

torch.set_num_threads(1)

H, W = 48, 64


def _pair(head_name):
    head = JHeatmap(n_outputs=24) if head_name == "keypoints_heatmap" else JRegression(24)
    module = JWrapper(backbone=JSmallMobile(), head=head)
    variables = module.init({"params": jax.random.PRNGKey(2)}, jnp.zeros((1, H, W, 3)), False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = import_model("small_mobile", head_name, ori_mode="keypoints", pos_mode="keypoints",
                         img_size=(H, W), device="cpu")
    return variables, load_flax_variables(model, variables)


def _flat(tree):
    return {str(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("head_name", ["keypoints_heatmap", "keypoints_regression"])
@pytest.mark.parametrize("bits,per_channel,min_size", [(8, True, 0), (4, True, 0),
                                                       (8, False, 0), (8, True, 1000)])
def test_grid_and_stats_match_jax_bit_for_bit(head_name, bits, per_channel, min_size):
    variables, model = _pair(head_name)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want, jstats = jquantize(variables, bits, per_channel, min_size)
    got, stats = quantize_model_weights(model, bits, per_channel, min_size)
    assert stats == jstats
    assert stats["n_quantized"] > 0 and stats["params_kept"] > 0
    mine, theirs = _flat(flax_variables(got)["params"]), _flat(want["params"])
    assert sorted(mine) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    np.testing.assert_equal(_flat(flax_variables(got)["batch_stats"]),
                            _flat(want["batch_stats"]))
    # The input model is left as it was.
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    # Snapped kernels differ from the float ones; a per-channel 8-bit grid
    # holds at most 255 values a channel.
    w = got.head.fc.weight if head_name == "keypoints_regression" else got.head.up0_conv.weight
    assert not torch.equal(w, before["head." + ("fc" if head_name == "keypoints_regression"
                                                 else "up0_conv") + ".weight"])
    if per_channel and bits == 8:
        assert max(len(torch.unique(w[i])) for i in range(w.shape[0])) <= 255
