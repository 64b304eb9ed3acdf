"""The int8 build chain's output served on the CPU: a QAT experiment in a
temporary directory (``config.yaml``, ``save_model``'s
``model/parameters.msgpack`` + ``bit_width.json`` with the calibrated
scales, and ``int8_graph.pkl``), as the chain leaves one, through the
engine's variants (``discover_engine_variants`` / ``build_engine_variant``)
and ``apps.serve`` (the QAT model, ``--int8-executor carry`` and
``weight-only``).  Each served path must give exactly what its forward
gives, through the padding window; the forwards themselves are held against
JAX in test_torch_qat.py and test_torch_int8_carry.py.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from spef_tpu_torch.apps import serve
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.data.synthetic import generate_positions, render_frame
from spef_tpu_torch.engine import build_engine_variant, discover_engine_variants
from spef_tpu_torch.models.wrapper import (
    flax_variables, import_model, load_flax_variables, save_model)
from spef_tpu_torch.quant import bitwidth
from spef_tpu_torch.quant.calibrate import calibrate_graph, write_scales_to_params
from spef_tpu_torch.quant.convert import convert_qat_params
from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
from spef_tpu_torch.quant.int8_model import build_weight_only_forward

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
HW = (32, 48)
N_ORI, N_POS = 1232, 1000  # the flagship config's bins


@pytest.fixture(scope="module")
def qat_experiment(tmp_path_factory):
    """A small QAT experiment (``small_mobile_q``, the boundary recipe,
    32x48, the flagship's head) built by the port's chain: the float ->
    QAT weights, ``convert_qat_params``, ``calibrate_graph`` on 4 rendered
    frames, ``save_model`` with the calibrated scales written back."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_qat import perturb

    exp = tmp_path_factory.mktemp("qat_exp")
    cfg = open(os.path.join(FLAGSHIP, "config.yaml")).read()
    cfg = cfg.replace("NAME: mobilenet_v2", "NAME: small_mobile")
    cfg = cfg.replace("IMG_SIZE:\n  - 240\n  - 384", f"IMG_SIZE:\n  - {HW[0]}\n  - {HW[1]}")
    assert "small_mobile" in cfg and f"- {HW[0]}" in cfg
    (exp / "config.yaml").write_text(cfg)
    bw = bitwidth.boundary_bit_width(2)
    model = import_model("small_mobile_q", "ursonet_q", bit_width=bw, ori_mode="classification",
                         n_ori_bins=N_ORI, pos_mode="classification", n_pos_bins=N_POS,
                         device="cpu", seed=4)
    load_flax_variables(model, perturb(flax_variables(model), 4))
    rng = np.random.RandomState(0)
    oris, poss = generate_positions(rng, 4)
    frames = np.stack([render_frame(q, p, img_size=HW, rng=rng) for q, p in zip(oris, poss)])
    graph, amaxes = calibrate_graph(convert_qat_params(model), [frames[:2], frames[2:]],
                                    device="cpu")
    load_flax_variables(model, write_scales_to_params(flax_variables(model), amaxes))
    save_model(str(exp / "model"), model)
    with open(exp / "int8_graph.pkl", "wb") as f:
        pickle.dump(graph, f, protocol=4)
    return str(exp), graph


def _frames(n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3), np.uint8)


def _utils():
    return SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=12,
                           pos_mode="classification", n_pos_bins_per_dim=10, device="cpu")


def _qat_model(exp):
    return import_model("small_mobile_q", "ursonet_q",
                        params_path=os.path.join(exp, "model", "parameters.msgpack"),
                        bit_width=bitwidth.load_bit_width(
                            os.path.join(exp, "model", "bit_width.json")),
                        ori_mode="classification", n_ori_bins=N_ORI,
                        pos_mode="classification", n_pos_bins=N_POS, device="cpu")


def test_engine_variants_of_a_qat_experiment(qat_experiment):
    exp, graph = qat_experiment
    assert discover_engine_variants(exp) == ["float", "weight-only", "int8-carry"]
    assert discover_engine_variants(FLAGSHIP) == ["float"]
    model, utils = _qat_model(exp), _utils()
    x = torch.from_numpy(_frames(2))
    with torch.inference_mode():
        forwards = {
            "float": model(x.float() / torch.tensor(255.0)),
            "weight-only": build_weight_only_forward(graph, device="cpu")(x),
            "int8-carry": build_int8_carry_forward(graph, device="cpu")(x),
        }
    for variant, (ori, pos) in forwards.items():
        engine = build_engine_variant(exp, model, utils, variant, device="cpu")
        pose, ms = engine.predict(x)
        assert ms > 0 and pose["ori"].shape == (2, 4) and torch.isfinite(pose["ori"]).all()
        torch.testing.assert_close(pose["ori_soft"], torch.softmax(ori, -1), rtol=0, atol=0)
        torch.testing.assert_close(pose["pos_soft"], torch.softmax(pos, -1), rtol=0, atol=0)
    with pytest.raises(KeyError):
        build_engine_variant(exp, model, utils, "int4", device="cpu")


def test_exported_and_crop_refine_variants_are_not_ported_yet(qat_experiment, tmp_path):
    exp, _ = qat_experiment
    (tmp_path / "model.spef").write_bytes(b"")
    assert discover_engine_variants(str(tmp_path)) == ["float", "exported"]
    # exported is ported (ROADMAP §A, item 10; tests/test_torch_deploy.py): a
    # model.spef that is not an artifact is refused by the loader.
    with pytest.raises(ValueError, match="not a .spef artifact"):
        build_engine_variant(str(tmp_path), None, _utils(), "exported", device="cpu")
    # crop-refine is ported (ROADMAP §A, item 8; tests/test_torch_crop_refine.py):
    # an experiment without a crop_refine.json registry has no fine model, as in JAX.
    for variant in ("crop-refine", "crop-refine-w8"):
        with pytest.raises(FileNotFoundError, match="crop_refine.json"):
            build_engine_variant(exp, None, _utils(), variant, device="cpu")


@pytest.mark.parametrize("executor", ["carry", "weight-only", None])
def test_serve_a_qat_experiment(qat_experiment, executor, capsys):
    """``serve`` on the QAT experiment: the QAT model itself (no int8
    graph), or its graph through ``--int8-executor carry`` / ``weight-only``;
    a request of 2 frames padded to the window of 3 gives the forward's."""
    exp, graph = qat_experiment
    argv = ["--experiment", exp, "--batch", "3", "--device", "cpu"]
    if executor:
        argv += ["--int8-graph", os.path.join(exp, "int8_graph.pkl"),
                 "--int8-executor", executor]
    server, img_size = serve.build_server(serve.parse_args(argv))
    assert img_size == HW
    out = capsys.readouterr().out
    frames = _frames(2, seed=9)
    pose, _ = server.predict(frames)
    assert pose["ori_soft"].shape == (2, N_ORI) and pose["pos_soft"].shape == (2, N_POS)
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        if executor == "carry":
            assert "carry executor" in out
            fwd = build_int8_carry_forward(graph, device="cpu")
            ori, pos = fwd(x)
        elif executor == "weight-only":
            assert "weight-only executor" in out
            ori, pos = build_weight_only_forward(graph, device="cpu")(x)
        else:
            assert "Serving the QAT model (small_mobile_q + ursonet_q)" in out
            ori, pos = _qat_model(exp)(x.float() / torch.tensor(255.0))
    np.testing.assert_array_equal(pose["ori_soft"], torch.softmax(ori, -1).numpy())
    np.testing.assert_array_equal(pose["pos_soft"], torch.softmax(pos, -1).numpy())


def test_serve_cli_selftest_on_the_carry_executor(qat_experiment, capsys):
    exp, _ = qat_experiment
    serve.main(["--experiment", exp, "--int8-graph", os.path.join(exp, "int8_graph.pkl"),
                "--int8-executor", "carry", "--batch", "2", "--selftest-frames", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "carry executor, cuda backend" in out and "selftest:" in out
