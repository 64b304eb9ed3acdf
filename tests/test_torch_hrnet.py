"""HRNet-W32 in the port (``models/hrnet.py``, ``models/heads.py::HRNetHeatmapHead``)
against the benchmark's plain float32 reference (``perfbench/reference/hrnet.py``)
on the CPU, at 64x96, on the reference's own seeded leaves (``init_leaves``:
nothing of the port's init) whose BatchNorm statistics and final-layer scale
it calibrates (``calibrate``), loaded into the port strictly (``load``):

  * the leaves name and shape every parameter and buffer of the port, and
    a leaf missing, extra or of another shape is refused; the port's own
    seed then changes nothing;

  * float32 on both sides: the keypoint logits within 1e-5, the heatmaps'
    log-probabilities within 1e-5 of their magnitude (about 6 at 16x24, where
    a float32 step is 5e-7): the same operations in another order
    (PyTorch's BatchNorm against the reference's ``rsqrt`` form);
  * the port's default bf16 convolutions and activations: logits within
    ``BF16_LOGIT`` and log-probabilities within ``BF16_LOGP`` (bf16 rounds
    each conv output and the residual stream, about 2^-9 of each value,
    through 32 residual blocks a branch; the first conv's outputs at the
    wireframe's bright pixels lie many standard deviations out, where a bf16
    step is a large share of the BatchNorm's scale); the reference with fp8
    operands fails them (CPU, leaves of seed 5: bf16 0.0125 / 0.079, fp8
    0.066 / 0.73);
  * the published sizes: 28.5 M parameters within 0.5%, the yardstick's
    convolutions (``perfbench/roofline_hrnet.py::convs``) named and shaped
    as the port's modules, and its multiply-accumulates at 256x192 equal to
    a count of the port's own convolutions (weight elements times output
    positions, the HRNet repository's rule): 7.645 G, where the paper's
    Table 1 gives 7.1 G for the same network;
  * under a profiler, the spans ``spef.hrnet.*`` and
    ``spef.heatmap.softargmax``, and the counters: the 37 1x1
    ``ConvBnAct`` calls of a forward take the fused path (its plain twin on
    the CPU) and the 255 others the unfused one;
  * ``import_model`` by name from ``configs/exp_hrnet_w32_keypoints.yaml``,
    served through ``build_predict_fn`` and ``serve_stream``.
"""

import collections
import json
import os
import sys

import numpy as np
import pytest
import torch

from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.config.train_config import load_config
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.engine import build_predict_fn
from spef_tpu_torch.models import layers
from spef_tpu_torch.models.wrapper import import_model
from spef_tpu_torch.serving import serve_stream
from spef_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from perfbench import frames, roofline_hrnet  # noqa: E402
from perfbench.reference import hrnet as ref  # noqa: E402

torch.set_num_threads(2)

H, W, B = 64, 96, 4
CFG = json.load(open(os.path.join(REPO, "perfbench", "configs", "hrnet_w32_kp.json")))
BF16_LOGIT, BF16_LOGP = 0.025, 0.25


def _model(dtype=torch.bfloat16, seed=5):
    return import_model("hrnet_w32", "hrnet_heatmap", ori_mode="keypoints", pos_mode="keypoints",
                        img_size=(H, W), seed=seed, device="cpu", compute_dtype=dtype)


@pytest.fixture(scope="module")
def setup():
    """(frames in [0, 1], calibrated leaves, float32 and bf16 models on them)."""
    gen = torch.Generator().manual_seed(7)
    images, _, _ = frames.make_frames(gen, 2 * B, CFG["camera"], (H, W), {
        "noise_std": 6.0, "z_range": [3.0, 35.0], "xy_over_z": 0.3, "min_visible": 8})
    x, calib = images[:B].float() / 255, images[B:].float() / 255
    leaves = ref.calibrate(ref.init_leaves(CFG, 5), calib, CFG)
    m32, mbf = ref.load(_model(torch.float32), leaves), ref.load(_model(), leaves)
    return x, leaves, m32, mbf


def _port(model, x):
    """The port's heatmap log-probabilities (B, K, H*W) and keypoint logits."""
    with torch.no_grad():
        heat = model.head.final_layer(model.backbone(x).permute(0, 3, 1, 2).float())
        logp = torch.log_softmax(heat.flatten(2), -1)
        return logp, model(x)


def _reference(leaves, x, lowp=None):
    with torch.no_grad(), ref.exact_f32():
        return ref.forward(leaves, x, CFG, lowp=lowp)


def test_float32_port_matches_the_reference(setup):
    x, leaves, m32, _ = setup
    (lp, lo), (rlp, rlo) = _port(m32, x), _reference(leaves, x)
    assert float((lo - rlo).abs().max()) < 1e-5
    assert float((lp - rlp).abs().max()) < 1e-5 * float(rlp.abs().max())


def test_bf16_port_is_within_its_tolerance_and_fp8_is_not(setup):
    x, leaves, _, mbf = setup
    (lp, lo), (rlp, rlo) = _port(mbf, x), _reference(leaves, x)
    assert float((lo - rlo).abs().max()) < BF16_LOGIT
    assert float((lp - rlp).abs().max()) < BF16_LOGP
    lp8, lo8 = _reference(leaves, x, "fp8")
    assert float((lo8 - rlo).abs().max()) > BF16_LOGIT or \
        float((lp8 - rlp).abs().max()) > BF16_LOGP


def test_the_reference_leaves_are_every_port_leaf_and_nothing_else(setup):
    _, leaves, m32, _ = setup
    state = {k: tuple(v.shape) for k, v in m32.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in leaves.items()} == state


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_a_leaf_that_does_not_fit_the_port_is_refused(setup, fault):
    _, leaves, _, _ = setup
    bad = dict(leaves)
    if fault == "missing":
        del bad["backbone.stage3.2.fuse.1.2.bn.weight"]
    elif fault == "extra":
        bad["backbone.stage3.2.fuse.1.2.bn.scale"] = bad["backbone.stage3.2.fuse.1.2.bn.weight"]
    else:
        bad["head.final_layer.weight"] = bad["head.final_layer.weight"][:, :16]
    with pytest.raises(RuntimeError):
        ref.load(_model(torch.float32), bad)


def test_the_port_seed_takes_no_part(setup):
    x, leaves, m32, _ = setup
    other = ref.load(_model(torch.float32, seed=6), leaves)
    assert torch.equal(_port(other, x)[1], _port(m32, x)[1])


def test_calibrated_layers_are_at_unit_scale_and_the_heatmaps_broad(setup):
    _, leaves, m32, _ = setup
    var = leaves["backbone.stage4.2.branches.0.3.conv2.bn.running_var"]
    assert var.min() > 0
    x, *_ = setup
    lp, _ = _port(m32, x)
    assert float(lp.exp().max()) < 0.05  # no pixel holds much of a heatmap


def test_published_widths_and_multiply_adds():
    model = _model()
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - 28.5e6) <= 0.005 * 28.5e6, n
    convs = {k[:-len(".weight")]: tuple(v.shape) for k, v in model.state_dict().items()
             if k.endswith("conv.weight") or k == "head.final_layer.weight"}
    cfg = dict(CFG, img_size=[256, 192])
    mine = {c["name"] + ("" if c["name"].startswith("head.") else ".conv"):
            (c["cout"], c["cin"], c["k"], c["k"]) for c in roofline_hrnet.convs(cfg)}
    assert mine == convs
    counted = []
    convs = [m.conv for m in model.modules() if isinstance(m, layers.ConvBnAct)]
    hooks = [m.register_forward_hook(  # a ConvBnAct's output is its conv's shape
        lambda m, i, o: counted.append(getattr(m, "conv", m).weight.numel() * o.shape[2]
                                       * o.shape[3]))
        for m in model.modules() if isinstance(m, layers.ConvBnAct) or m is model.head.final_layer]
    assert len(hooks) == len(convs) + 1
    with torch.no_grad():
        model(torch.zeros(1, 256, 192, 3))
    for h in hooks:
        h.remove()
    assert roofline_hrnet.model_macs(cfg) == sum(counted) == 7_644_512_256


def test_spans_and_counters_of_a_forward(monkeypatch):
    """The 1x1 convs run the fused path (its plain twin here), every other
    conv the unfused one; each stage and exchange is a span."""
    monkeypatch.setattr(layers, "_KERNEL_DEVICES", ("cuda", "cpu"))
    model = _model()
    convs = [m for m in model.modules() if isinstance(m, layers.ConvBnAct)]
    ones = sum(c.conv.kernel_size == (1, 1) for c in convs)
    assert (len(convs), ones) == (292, 37)
    profiling.reset_counters()
    try:
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            model(torch.rand(1, H, W, 3))
        got = profiling.counters()
    finally:
        profiling.reset_counters()
    assert got == {"forward.conv_fused": ones, "forward.conv_plain": len(convs) - ones}
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("spef.")]
    names = collections.Counter(s[0] for s in spans)
    assert names == {"spef.hrnet.stem": 1, "spef.hrnet.stage1": 1, "spef.hrnet.stage2": 1,
                     "spef.hrnet.stage3": 1, "spef.hrnet.stage4": 1, "spef.hrnet.fuse": 8,
                     "spef.heatmap.softargmax": 1}
    stages = [s for s in spans if s[0].startswith("spef.hrnet.stage")]
    for fuse in (s for s in spans if s[0] == "spef.hrnet.fuse"):
        assert any(a <= fuse[1] and fuse[2] <= b for _, a, b in stages)


def test_a_size_off_the_branches_grid_is_refused():
    with pytest.raises(ValueError, match="divisible by 32"):
        with torch.no_grad():
            _model().backbone(torch.zeros(1, 240, 384, 3)[:, :60])


def test_the_experiment_config_builds_and_serves_it():
    cfg = load_config(os.path.join(REPO, "configs", "exp_hrnet_w32_keypoints.yaml"))
    assert tuple(cfg.DATA.IMG_SIZE) == (480, 768)
    model = import_model(cfg.MODEL.BACKBONE.NAME, cfg.MODEL.HEAD.NAME,
                         residual=cfg.MODEL.BACKBONE.RESIDUAL, ori_mode=cfg.MODEL.HEAD.ORI,
                         pos_mode=cfg.MODEL.HEAD.POS, img_size=(H, W), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 28_535_948
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode=cfg.MODEL.HEAD.ORI,
                            pos_mode=cfg.MODEL.HEAD.POS, device="cpu")
    predict = build_predict_fn(model, utils)
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 256, (2, H, W, 3), np.uint8) for _ in range(3)]
    poses = list(serve_stream(predict, batches, depth=2, device="cpu"))
    assert len(poses) == 3
    for pose in poses:
        assert pose["keypoints"].shape == (2, 24)
        assert pose["ori"].shape == (2, 4) and pose["pos"].shape == (2, 3)
        assert torch.isfinite(pose["keypoints"]).all()
