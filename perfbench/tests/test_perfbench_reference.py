"""Each reference against a direct float64 recomputation, and against the
port where the two must agree, at small sizes on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import frames
from perfbench.reference import int8_graph, model, softclass, train, weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _frames(n, size=(64, 96), seed=3):
    cfg = _cfg("flagship_float")
    gen = torch.Generator().manual_seed(seed)
    spec = {"z_range": [3, 35], "xy_over_z": 0.3, "min_visible": 8, "noise_std": 6.0}
    return frames.make_frames(gen, n, cfg["camera"], size, spec)


def test_flax_reader_matches_the_port_reader():
    from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack

    cfg = _cfg("flagship_float")
    mine = weights.flax_tree(ROOT, cfg["weights"])
    theirs = read_flax_msgpack(os.path.join(ROOT, cfg["weights"]["path"]))

    def flat(t, p=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{p}/{k}") if isinstance(v, dict) else {f"{p}/{k}": v})
        return out

    a, b = flat(mine), flat(theirs)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_pinned_hash_is_checked(tmp_path):
    spec = dict(_cfg("flagship_float")["weights"], sha256="0" * 64)
    with pytest.raises(ValueError, match="sha256"):
        weights.checked_bytes(ROOT, spec)


def test_float_model_float32_against_float64():
    cfg = _cfg("flagship_float")
    leaves = model.from_flax(weights.flax_tree(ROOT, cfg["weights"]), "cpu")
    images, _, _ = _frames(2)
    x = images.float() / 255.0
    with model.exact_f32():
        lo32, lp32 = model.forward(leaves, x, cfg)
        lo64, lp64 = model.forward({k: v.double() for k, v in leaves.items()}, x.double(), cfg)
    assert lo64.dtype == torch.float64
    assert torch.allclose(lo32.double(), lo64, atol=1e-3, rtol=0)
    assert torch.allclose(lp32.double(), lp64, atol=1e-3, rtol=0)


def test_float_model_matches_the_port_in_float32():
    from spef_tpu_torch.models.wrapper import import_model

    cfg = _cfg("flagship_float")
    leaves = model.from_flax(weights.flax_tree(ROOT, cfg["weights"]), "cpu")
    port = import_model(params_path=os.path.join(ROOT, cfg["weights"]["path"]),
                        ori_mode="classification", n_ori_bins=cfg["n_ori_bins"],
                        pos_mode="classification", n_pos_bins=cfg["n_pos_bins"], device="cpu",
                        compute_dtype=torch.float32)
    images, _, _ = _frames(2)
    x = images.float() / 255.0
    with torch.no_grad(), model.exact_f32():
        ours, theirs = model.forward(leaves, x, cfg), port(x)
    for a, b in zip(ours, theirs):
        assert torch.allclose(a, b, atol=1e-4, rtol=0)


def test_checkpoint_leaves_cover_every_leaf_of_the_port_model():
    from spef_tpu_torch.models.wrapper import import_model

    cfg = _cfg("flagship_float")
    port = import_model(ori_mode="classification", n_ori_bins=cfg["n_ori_bins"],
                        pos_mode="classification", n_pos_bins=cfg["n_pos_bins"], device="cpu")
    leaves = model.trainable(cfg, model.from_flax(weights.flax_tree(ROOT, cfg["weights"]),
                                                  "cpu"))
    shapes = {k: tuple(p.shape) for k, p in port.named_parameters()}
    assert list(leaves) == list(shapes)
    assert all(tuple(v.shape) == shapes[k] for k, v in leaves.items())


def test_int8_reference_matches_the_port_plain_executor():
    """The integer reference is the port's readable executor, bit for bit."""
    from spef_tpu_torch.quant.int8_graph import load_int8_graph
    from spef_tpu_torch.quant.int8_model import build_int8_forward

    cfg = _cfg("flagship_int8")
    images, _, _ = _frames(2)
    g = int8_graph.prepare(weights.int8_graph(ROOT, cfg["weights"]), "cpu")
    with model.exact_f32():
        ours = int8_graph.forward(g, images)
    theirs = build_int8_forward(load_int8_graph(os.path.join(ROOT, cfg["weights"]["path"])),
                                "cpu")(images)
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)


def test_int8_integer_products_against_float64():
    cfg = _cfg("flagship_int8")
    graph = weights.int8_graph(ROOT, cfg["weights"])
    g = int8_graph.prepare(graph, "cpu")
    e = g["blocks"][3]["expand"]
    step = 0.05
    x = torch.randint(-128, 128, (1, 3, 5, e["w2d"].shape[0])).float() * step
    y = int8_graph._mm(x, e, step, relu=False).double()
    w = np.asarray(graph["blocks"][3]["expand"]["w_int"], np.float64)[0, 0]
    mult = np.float32(step) * np.asarray(e["mult_core"], np.float32)
    want = (np.round(x.numpy().astype(np.float64) / step).reshape(-1, w.shape[0]) @ w) \
        * mult.astype(np.float64) + np.asarray(e["bias"], np.float64)
    assert np.allclose(y.reshape(-1, w.shape[1]).numpy(), want, rtol=1e-6, atol=1e-5)


def test_int4_control_moves_every_weight_grid():
    cfg = _cfg("flagship_int8")
    g4 = int8_graph.prepare(weights.int8_graph(ROOT, cfg["weights"]), "cpu", lowp="int4")
    w = g4["blocks"][2]["project"]["w2d"]
    assert torch.all(torch.remainder(w, 16) == 0) and w.abs().max() <= 128


def test_codec_against_float64_and_the_port():
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import Camera

    cfg = _cfg("flagship_float")
    codec = softclass.Codec(cfg, "cpu")
    port = SPEUtils.create(Camera(**cfg["camera"]), ori_mode="classification",
                           pos_mode="classification", device="cpu")
    assert torch.allclose(codec.ori_hist, port.orientation.histogram, atol=1e-6)
    _, ori, pos = _frames(4)
    t_ori, t_pos = codec.encode(ori, pos)
    theirs = port.encode_targets(ori, pos)
    assert torch.allclose(t_ori, theirs["ori_soft"], atol=1e-6)
    assert torch.allclose(t_pos, theirs["pos_soft"], atol=1e-6)
    q, p, ev = codec.decode(t_ori, t_pos)
    h = codec.ori_hist.double().numpy()
    for i in range(4):
        a = h.T @ np.diag(t_ori[i].double().numpy()) @ h
        v = np.linalg.eigh(a)[1][:, -1]
        assert abs(abs(float(np.dot(v, q[i].double().numpy()))) - 1.0) < 1e-5
    want = (t_pos.double() @ codec.pos_hist.double()) / t_pos.double().sum(-1, keepdim=True)
    assert torch.allclose(p.double(), want, atol=1e-4)
    # A peaked target decodes to the pose it was made from, well posed.
    dots = (q * ori).sum(-1).abs()
    assert torch.all(dots > 0.99) and torch.all(ev[:, -1] > 0.9)


def test_augmentation_matches_the_port_on_the_same_draws():
    from spef_tpu_torch.data.augment import train_augment
    from spef_tpu_torch.data.camera import Camera

    cfg = _cfg("flagship_float")
    images, ori, pos = _frames(3)
    x = images.float() / 255.0
    ours = train.augment(torch.Generator().manual_seed(9), x)
    theirs, _, _ = train_augment(torch.Generator().manual_seed(9), x, ori, pos,
                                 Camera(**cfg["camera"]), rot_augment=False, other_augment=True)
    assert torch.allclose(ours, theirs, atol=1e-6)


def test_train_steps_float32_against_float64():
    """Three reference steps in float32 against the same in float64: the
    first step's loss and gradients agree to float32 rounding (each leaf
    against its own norm or the median leaf's, whichever is larger), the later
    losses to Adam's amplification of it (an element whose gradient is near
    zero moves by a full step of either sign), and every leaf moves."""
    cfg = _cfg("flagship_float")
    _, ori, pos = _frames(8, size=(64, 96))
    images = torch.randint(0, 256, (8, 64, 96, 3), generator=torch.Generator().manual_seed(2),
                           dtype=torch.uint8)
    batches = [(images[i:i + 4], ori[i:i + 4], pos[i:i + 4]) for i in (0, 4, 0)]
    leaves = model.trainable(cfg, model.from_flax(weights.flax_tree(ROOT, cfg["weights"]),
                                                  "cpu"))
    out32 = train.run_steps(cfg, leaves, batches, torch.Generator().manual_seed(5))
    out64 = train.run_steps(cfg, {k: v.double() for k, v in leaves.items()},
                            [(b[0], b[1].double(), b[2].double()) for b in batches],
                            torch.Generator().manual_seed(5))
    assert out32["losses"][0] == pytest.approx(out64["losses"][0], rel=1e-6)
    assert np.allclose(out32["losses"], out64["losses"], rtol=5e-3)
    g32, g64 = out32["first_grad"], out64["first_grad"]
    median = float(np.median([float(g.norm()) for g in g64.values()]))
    worst = max(float((g32[k].double() - g64[k]).norm()) / max(float(g64[k].norm()), median)
                for k in g64)
    assert worst < 1e-3
    assert all(float(c.norm()) > 0 for c in out32["change"].values())


def test_train_state_carries_over_and_statistics_decay_as_flax():
    """Three steps equal two and then one from the state and the draws the
    two leave; the stem's running mean after a step is flax's
    ``0.9 * running + 0.1 * batch mean``, the batch mean of its convolution
    recomputed in float64 on the same augmented frames."""
    cfg = _cfg("flagship_float")
    _, ori, pos = _frames(8, size=(64, 96))
    images = torch.randint(0, 256, (8, 64, 96, 3), generator=torch.Generator().manual_seed(2),
                           dtype=torch.uint8)
    batches = [(images[i:i + 4], ori[i:i + 4], pos[i:i + 4]) for i in (0, 4, 0)]
    tree = model.from_flax(weights.flax_tree(ROOT, cfg["weights"]), "cpu")
    leaves = model.trainable(cfg, tree)
    stats = {k: v for k, v in tree.items() if ".running_" in k}
    out3 = train.run_steps(cfg, leaves, batches, torch.Generator().manual_seed(5), stats=stats)
    gen = torch.Generator().manual_seed(5)
    out2 = train.run_steps(cfg, leaves, batches[:2], gen, stats=stats)
    out1 = train.run_steps(cfg, out2["params"], batches[2:], gen, stats=out2["stats"],
                           adam={"m": out2["m"], "v": out2["v"], "t": out2["t"]})
    assert out1["t"] == out3["t"] == 3
    assert out1["losses"][0] == out3["losses"][2]
    for key in ("params", "stats", "m", "v"):
        assert all(torch.equal(out1[key][k], out3[key][k]) for k in out3[key]), key

    first = train.run_steps(cfg, leaves, batches[:1], torch.Generator().manual_seed(5),
                            stats=stats)
    x = train.augment(torch.Generator().manual_seed(5), batches[0][0].float() / 255.0)
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   leaves["backbone.stem.conv.weight"].double(), stride=2,
                                   padding=1)
    key = "backbone.stem.bn.running_mean"
    want = 0.9 * stats[key].double() + 0.1 * y.mean(dim=(0, 2, 3))
    assert torch.allclose(first["stats"][key].double(), want, rtol=1e-5, atol=1e-6)
