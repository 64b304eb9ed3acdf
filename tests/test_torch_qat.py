"""Port parity: the int8 graph front end's QAT half — fake quantization,
the quantized layers and models, the flax weight carry, ``save_model`` and
its msgpack writer, the bit-width files and the float -> QAT warm start —
against the JAX package on the same inputs (numpy from a seed).

Tolerances, stated:
  * ``ste_round``, ``quantize_input_image`` and ``quantize_weight`` at 3
    bits and more: bit for bit (max, divisions and rounds, all exact IEEE
    operations on both sides).
  * ``quantize_weight`` at 1 and 2 bits: the scale is a mean, which XLA's
    CPU reduction sums in another order than PyTorch (up to 3456 float32
    terms here): same levels, values within 1e-5 relative.
  * ``FakeQuantAct``: XLA's CPU ``exp2`` is ``exp(x ln 2)`` with its own
    ``exp``, up to 5 ulp from the correctly rounded value that
    ``torch.exp2`` gives, so the learned step differs by a few ulp: the
    grid levels ``round(x / step)`` agree except where ``x / step`` is
    within 1e-5 of a tie, and the values within 1e-6 relative.
  * The QAT model's logits (``small_mobile_q`` at 32x48, the default a4,
    the boundary and the w8a8 recipes): the same
    steps and ties again, and float32 convolutions summed in other orders,
    can move an activation by one grid step; logits within 5e-3 of JAX's
    (their scale is 0.1 to 1).
  * The weight carry, ``copy_params``, ``save_model`` / the msgpack writer
    and the bit-width files: exact (the writer's bytes are flax's).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from spef_tpu.models.wrapper import ModelWrapper as JaxModelWrapper
from spef_tpu.quant import bitwidth as jbitwidth
from spef_tpu.quant import fake_quant as jfq
from spef_tpu.quant.qmodels import build_quant_backbone, build_quant_head
from spef_tpu.quant.warmstart import copy_params as jcopy_params
from spef_tpu_torch.models.flax_msgpack import packb, read_flax_msgpack
from spef_tpu_torch.models.wrapper import (
    flax_variables, import_model, load_flax_variables, save_model)
from spef_tpu_torch.quant import bitwidth, fake_quant
from spef_tpu_torch.quant.warmstart import copy_params

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")


def _w8a8(n_blocks):
    return bitwidth.default_bit_width(n_blocks, w=8, a=8, shared=8)


RECIPES = {"default_a4": None, "boundary": bitwidth.boundary_bit_width, "w8a8": _w8a8}


def perturb(tree, seed):
    """A flax-layout QAT variable tree with parameters a trained network
    could have: BN statistics and affine terms, activation ranges and head
    weights drawn from ``seed`` (the init leaves BN at identity, every range
    at 6 and the head near 0, which makes trivial logits)."""
    rng = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k == "log2_scale":
                v = np.asarray(np.log2(rng.uniform(1.0, 4.0)), np.float32)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                v = (rng.randn(*v.shape) * 0.2).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            elif k.endswith("fc_kernel"):
                v = (rng.randn(*v.shape) * 0.05).astype(np.float32)
            out[k] = v
        return out

    return walk(tree)


def qat_pair(backbone, bw, seed=3, n_ori=64, n_pos=3):
    """(port model, JAX module, shared variables) of one QAT model."""
    model = import_model(backbone, "ursonet_q", bit_width=bw, ori_mode="classification",
                         n_ori_bins=n_ori, pos_mode="regression", device="cpu", seed=seed)
    variables = perturb(flax_variables(model), seed)
    load_flax_variables(model, variables)
    module = JaxModelWrapper(
        backbone=build_quant_backbone(backbone, {"batchnorm": True, "residual": True}, bw,
                                      True),
        head=build_quant_head("ursonet_q", n_ori, n_pos, bw, True))
    return model, module, variables


# ---------------------------------------------------------------------------
# fake quantization
# ---------------------------------------------------------------------------


def test_ste_round_and_input_image_bit_for_bit():
    x = np.random.RandomState(0).uniform(-1.5, 2.5, (4, 9, 7, 3)).astype(np.float32)
    x[0, 0, :4, 0] = [0.5, 1.5, -0.5, 2.5]  # ties round to even on both sides
    np.testing.assert_array_equal(fake_quant.ste_round(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfq.ste_round(jnp.asarray(x))))
    for bits in (8, 4):
        np.testing.assert_array_equal(
            fake_quant.quantize_input_image(torch.from_numpy(x), bits).numpy(),
            np.asarray(jfq.quantize_input_image(jnp.asarray(x), bits)))


@pytest.mark.parametrize("bits", [None, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_weight_matches_jax(bits, per_channel):
    w = np.random.RandomState(bits or 0).randn(3, 3, 16, 24).astype(np.float32)
    got = fake_quant.quantize_weight(torch.from_numpy(w), bits, per_channel).numpy()
    want = np.asarray(jfq.quantize_weight(jnp.asarray(w), bits, per_channel))
    if bits is None or bits >= 3:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.sign(got), np.sign(want))  # the same levels
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    scale = fake_quant.weight_scale(torch.from_numpy(w), bits or 8, per_channel).numpy()
    want_scale = np.asarray(jfq.weight_scale(jnp.asarray(w), bits or 8, per_channel))
    np.testing.assert_allclose(scale, want_scale, rtol=1e-5, atol=0)


@pytest.mark.parametrize("bits,signed", [(1, True), (2, True), (3, False), (4, True),
                                         (8, False), (8, True)])
def test_fake_quant_act_matches_jax(bits, signed):
    rng = np.random.RandomState(bits * 2 + signed)
    x = rng.uniform(-3.0, 8.0, (2, 7, 9, 5)).astype(np.float32)
    log2_scale = np.float32(np.log2(2.7))
    act = fake_quant.FakeQuantAct(bits, signed=signed)
    with torch.no_grad():
        act.log2_scale.fill_(float(log2_scale))
        got = act(torch.from_numpy(x)).numpy()
    jact = jfq.FakeQuantAct(bits=bits, signed=signed)
    want = np.asarray(jact.apply({"params": {"log2_scale": jnp.asarray(log2_scale)}},
                                 jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if bits > 2:
        qmax = 2.0 ** (bits - 1) - 1.0 if signed else 2.0 ** bits - 1.0
        step = np.float32(2.0 ** float(log2_scale) / qmax)
        lv_got, lv_want = np.round(got / step), np.round(want / step)
        t = x / step
        at_tie = np.abs(t - (np.floor(t) + 0.5)) <= 1e-5
        assert np.all((lv_got == lv_want) | at_tie)
    assert abs(act.scale_value() - 2.7) < 1e-5


# ---------------------------------------------------------------------------
# the QAT models and the weight carry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_qat_model_forward_matches_jax(recipe):
    bw = RECIPES[recipe] and RECIPES[recipe](2)
    model, module, variables = qat_pair("small_mobile_q", bw)
    x = np.random.RandomState(7).rand(2, 32, 48, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    want = module.apply(variables, jnp.asarray(x), False)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and np.abs(w).max() > 0.05  # not a trivial output
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-3)


@pytest.mark.parametrize("backbone", ["small_mobile_q", "mobilenet_v2_q", "small_q"])
def test_weight_carry_round_trips_the_jax_tree(backbone):
    """The port's QAT model holds exactly the leaves of the flax model's
    init tree (same paths, shapes and dtypes), and gives them back."""
    bw = None
    module = JaxModelWrapper(
        backbone=build_quant_backbone(backbone, {"batchnorm": True, "residual": True}, bw,
                                      True),
        head=build_quant_head("ursonet_q", 10, 3, bw, True))
    shapes = jax.eval_shape(lambda r, x: module.init(r, x, False),
                            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 48, 3)))
    rng = np.random.RandomState(1)
    tree = jax.tree_util.tree_map(lambda s: np.asarray(rng.randn(*s.shape), s.dtype), shapes)
    model = import_model(backbone, "ursonet_q", ori_mode="classification", n_ori_bins=10,
                         device="cpu")
    load_flax_variables(model, tree)
    back = flax_variables(model)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w)


def test_import_model_takes_the_q_aliases_and_a_float_head():
    m = import_model("mobilenet_v2_brevitas", "ursonet_brevitas", ori_mode="regression",
                     device="cpu")
    assert type(m.backbone).__name__ == "QMobileNetV2"
    assert type(m.head).__name__ == "QURSONetHead"
    assert m.bit_width is None and m.backbone.bit_width["shared_act"] == 4
    m = import_model("small_mobile_q", "ursonet", ori_mode="regression", device="cpu")
    assert type(m.head).__name__ == "URSONetHead" and m.head.ori_fc.in_features == 64
    # The keypoint heads are ported (ROADMAP §A, item 8): a _q backbone takes
    # one too, the regression head sized by the feature map at img_size.
    m = import_model("small_mobile_q", "keypoints_regression", ori_mode="keypoints",
                     pos_mode="keypoints", img_size=(48, 64), device="cpu")
    assert type(m.head).__name__ == "KeypointRegressionHead"
    assert m(torch.zeros(1, 48, 64, 3)).shape == (1, 24)


# ---------------------------------------------------------------------------
# save_model, msgpack, bit widths
# ---------------------------------------------------------------------------


def test_save_model_writes_what_flax_writes_and_reads(tmp_path):
    bw = bitwidth.boundary_bit_width(2)
    model, _, variables = qat_pair("small_mobile_q", bw)
    path = save_model(str(tmp_path / "model"), model)
    data = open(path, "rb").read()
    tree = flax_variables(model)
    assert data == serialization.to_bytes(tree)  # byte for byte flax's
    back = serialization.from_bytes(tree, data)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(p))
    assert jbitwidth.load_bit_width(str(tmp_path / "model" / "bit_width.json")) == bw
    again = import_model("small_mobile_q", "ursonet_q", params_path=path, bit_width=bw,
                         ori_mode="classification", n_ori_bins=64, device="cpu")
    for a, b in zip(again.state_dict().values(), model.state_dict().values()):
        assert torch.equal(a, b)


def test_msgpack_writer_covers_flax_types():
    tree = {"a": {"x": np.arange(6, dtype=np.int8).reshape(2, 3),
                  "s": np.asarray(1.5, np.float32), "long_name_" * 4: np.zeros(0, np.float64)},
            "n": np.float32(2.0), "i": np.int64(-7), "many": {str(i): np.ones(i, np.uint8)
                                                             for i in range(17)}}
    assert packb(tree) == serialization.to_bytes(tree)
    for value in (None, True, -1, -33, 200, 70000, -70000, 2 ** 40, 1.25, "s" * 40,
                  b"b" * 300, [1] * 20, list(range(70000))):
        assert packb(value) == serialization.msgpack_serialize(value), value


def test_bit_width_files_round_trip_between_packages(tmp_path):
    bw = bitwidth.default_bit_width(17)
    path = bitwidth.save_bit_width(str(tmp_path / "a"), bw)
    assert jbitwidth.load_bit_width(path) == bw
    jpath = jbitwidth.save_bit_width(str(tmp_path / "b"), jbitwidth.boundary_bit_width())
    assert open(jpath).read() == open(bitwidth.save_bit_width(
        str(tmp_path / "c"), bitwidth.boundary_bit_width())).read()
    assert bitwidth.load_bit_width(jpath) == jbitwidth.boundary_bit_width()
    os.makedirs(tmp_path / "exp" / "model")
    bitwidth.save_bit_width(str(tmp_path / "exp" / "model"), bw)
    names = bitwidth.experiment_model_names(str(tmp_path / "exp"), "mobilenet_v2_pytorch",
                                            "ursonet")
    assert names == jbitwidth.experiment_model_names(str(tmp_path / "exp"),
                                                     "mobilenet_v2_pytorch", "ursonet")
    assert names[:2] == ("mobilenet_v2_q", "ursonet_q") and names[2] == bw
    assert json.load(open(path))["first_conv"] == "(3, 3)"


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------


def test_copy_params_matches_jax_on_the_flagship():
    """The float flagship checkpoint into the boundary-recipe QAT twin:
    the same tree as JAX's ``copy_params`` gives (17 blocks: ``block_10``
    sorts before ``block_2`` on both sides)."""
    src = read_flax_msgpack(os.path.join(FLAGSHIP, "model", "parameters.msgpack"))
    model = import_model("mobilenet_v2_q", "ursonet_q",
                         bit_width=bitwidth.boundary_bit_width(), ori_mode="classification",
                         n_ori_bins=1232, pos_mode="classification", n_pos_bins=1000,
                         device="cpu")
    dst = flax_variables(model)
    got = copy_params(src, dst)
    want = jcopy_params(src, dst)
    got_l = jax.tree_util.tree_leaves_with_path(got)
    want_l = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (p, g), (_, w) in zip(got_l, want_l):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(p))
    bb = got["params"]["backbone"]
    np.testing.assert_array_equal(bb["block_10"]["expand"]["conv"]["kernel"],
                                  src["params"]["backbone"]["block_10"]["expand"]["conv"]
                                  ["kernel"])
    load_flax_variables(model, got)  # and it fits the port's model
    with pytest.raises(ValueError):
        copy_params({"params": {"k": {"kernel": np.zeros((2, 2))}}},
                    {"params": {"k": {"kernel": np.zeros((3, 3))}}})
