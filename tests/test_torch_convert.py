"""Port parity: ``convert_qat_params`` against the JAX package's on the
same QAT parameters (a flax-layout numpy tree fed to both sides): an
identical graph dict — structure, ``w_int``, ``mult_core``, ``bias``, every
step and qmax, the head — with no tolerance, both being the same float64
numpy in the same order.  Also the flagship's full-width warm start from
``exp_dspeed_synth/model/parameters.msgpack`` (``copy_params`` then
``convert_qat_params``, no calibration).
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from spef_tpu.models.wrapper import SPEModel
from spef_tpu.quant.convert import convert_qat_params as jconvert
from spef_tpu.quant.warmstart import copy_params as jcopy_params
from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
from spef_tpu_torch.models.wrapper import flax_variables, import_model, load_flax_variables
from spef_tpu_torch.quant import bitwidth
from spef_tpu_torch.quant.convert import convert_qat_params
from spef_tpu_torch.quant.warmstart import copy_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_qat import qat_pair  # noqa: E402

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")


def assert_same_graph(got, want, path="graph"):
    """Equal dicts, lists and scalars of the same types; arrays of the same
    dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_graph(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same_graph(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def jax_graph(model, variables, bw):
    """The JAX package's conversion of the same parameters (JAX arrays
    taken to numpy; every other leaf as the converter left it)."""
    g = jconvert(SPEModel(model, variables, "", "", bw), bw)
    return jax.tree_util.tree_map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, g)


def _family(name):
    bw = bitwidth.default_bit_width(2, w=8, a=8, shared=8)
    if name == "dw_w1":
        bw["inverted_residual"] = [[(8, 8), (1, 8), (8,)] for _ in range(2)]
    elif name == "proj_w2":
        bw["inverted_residual"] = [[(8, 8), (8, 8), (2,)] for _ in range(2)]
    elif name == "one_block_mixed":
        bw["inverted_residual"] = [[(8, 3), (1, 8), (2,)], [(8, 8), (8, 8), (8,)]]
    return bw


RECIPES = {
    "default_a4": None,
    "boundary": bitwidth.boundary_bit_width(2),
    "w8a8": _family("w8a8"),
    "dw_w1": _family("dw_w1"),
    "proj_w2": _family("proj_w2"),
    "one_block_mixed": _family("one_block_mixed"),
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_convert_gives_the_jax_graph(recipe):
    bw = RECIPES[recipe]
    model, module, variables = qat_pair("small_mobile_q", bw)
    got = convert_qat_params(model)
    assert_same_graph(got, jax_graph(module, variables, bw or model.backbone.bit_width))
    assert got["head"]["ori_w_int"].dtype == np.int8 and len(got["blocks"]) == 2


def test_flagship_warm_start_converts_to_the_jax_graph():
    """The flagship float checkpoint warm-started into the boundary-recipe
    QAT twin and converted: the port's graph equals JAX's on the same tree,
    and has the committed asset's structure and integer weights (the asset
    differs only in its calibrated steps)."""
    from spef_tpu.quant.qmodels import build_quant_backbone, build_quant_head
    from spef_tpu.models.wrapper import ModelWrapper
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    bw = bitwidth.boundary_bit_width()
    model = import_model("mobilenet_v2_q", "ursonet_q", bit_width=bw, ori_mode="classification",
                         n_ori_bins=1232, pos_mode="classification", n_pos_bins=1000,
                         device="cpu")
    src = read_flax_msgpack(os.path.join(FLAGSHIP, "model", "parameters.msgpack"))
    tree = copy_params(src, flax_variables(model))
    load_flax_variables(model, tree)
    got = convert_qat_params(model)
    module = ModelWrapper(
        backbone=build_quant_backbone("mobilenet_v2_q", {"batchnorm": True, "residual": True},
                                      bw, True),
        head=build_quant_head("ursonet_q", 1232, 1000, bw, True))
    jtree = jcopy_params(src, flax_variables(model))
    assert_same_graph(got, jax_graph(module, jtree, bw))
    asset = load_int8_graph(os.path.join(REPO, "spef_tpu_torch", "assets",
                                         "flagship_boundary_int8_graph.pkl"))
    for mine, theirs in zip(got["blocks"], asset["blocks"]):
        for layer in ("expand", "depthwise", "project"):
            if layer in theirs:
                np.testing.assert_array_equal(mine[layer]["w_int"], theirs[layer]["w_int"])
                np.testing.assert_array_equal(mine[layer]["mult_core"],
                                              theirs[layer]["mult_core"])
    np.testing.assert_array_equal(got["head"]["ori_w_int"], asset["head"]["ori_w_int"])
