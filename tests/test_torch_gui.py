"""The port's GUI server (``spef_tpu_torch.apps.gui``) over a live HTTP loop
on the CPU: the counterparts of ``tests/test_gui.py``'s six tests, on the
port's own writer, configs and engines.

The routes and JSON fields are JAX's; the frame goes out as a PNG
(``png_b64``, decoded here by ``data/png.py``) where JAX sends a JPEG.
Where both packages can answer the same question on the same files, they
must answer alike: ``/api/state`` equals JAX's ``GuiBackend.state()`` on the
same directories, and ``discover_splits`` / ``discover_experiments`` give
JAX's dicts on the same trees (exact).
"""

import base64
import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from spef_tpu_torch.data.png import decode_png
from spef_tpu_torch.data.synthetic import create_synthetic_dataset

torch.set_num_threads(1)


def _experiment(exps, name, data, edit=None):
    from spef_tpu_torch.config.train_config import default_config, save_config

    cfg = default_config()
    cfg.MODEL.BACKBONE.NAME = "small"
    cfg.MODEL.HEAD.ORI = "classification"
    cfg.MODEL.HEAD.POS = "classification"
    cfg.MODEL.HEAD.N_ORI_BINS_PER_DIM = 4
    cfg.MODEL.HEAD.N_POS_BINS_PER_DIM = 4
    cfg.DATA.PATH = data
    cfg.DATA.IMG_SIZE = (48, 64)
    if edit is not None:
        edit(cfg)
    os.makedirs(exps / name)
    save_config(cfg, str(exps / name / "config.yaml"))
    return cfg


@pytest.fixture(scope="module")
def gui_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("gui")
    data = create_synthetic_dataset(str(root / "data"), n_train=4, n_valid=3, n_test=3,
                                    img_size=(120, 192))
    exps = root / "experiments"
    for name in ("exp_a", "exp_b"):
        _experiment(exps, name, data)

    from spef_tpu_torch.apps.gui import GuiBackend, make_server

    backend = GuiBackend(str(exps), data, device="cpu")
    server = make_server(backend, port=0)
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield backend, f"http://127.0.0.1:{port}", str(exps), data
    server.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        body = r.read()
    return r.status, body


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def test_index_and_state(gui_env):
    from spef_tpu.apps.gui import GuiBackend as JaxGuiBackend

    _, base, exps, data = gui_env
    status, page = _get(base + "/")
    assert status == 200 and b"spef_tpu pose viewer" in page
    assert b"data:image/png;base64," in page and b"d.png_b64" in page

    status, body = _get(base + "/api/state")
    state = json.loads(body)
    assert status == 200
    assert state["experiments"] == ["exp_a", "exp_b"]
    assert set(state["splits"]) == {"train", "valid", "test"}
    assert state["split"] == "test"  # first split alphabetically
    assert state["n_frames"] == 3
    assert state == JaxGuiBackend(exps, data).state()


def test_frame_inference_and_metrics(gui_env):
    _, base, _, _ = gui_env
    status, body = _get(base + "/api/frame?idx=1&video=0&overlays=true_pose,pred_pose,"
                               "true_kp,pred_bbox")
    d = json.loads(body)
    assert status == 200
    assert d["idx"] == 1 and d["n_frames"] == 3
    assert {"esa_score", "ori_error", "pos_error"} <= set(d["still"])
    assert d["latency_ms"] > 0
    assert "video" not in d  # still mode
    png = base64.b64decode(d["png_b64"])
    assert png[:8] == b"\x89PNG\r\n\x1a\n"  # PNG signature
    assert decode_png(png).shape == (48, 64, 3)
    assert len(d["pred"]["ori"]) == 4 and len(d["pred"]["pos"]) == 3  # flat, as the page reads

    # idx clamped to the valid range
    _, body = _get(base + "/api/frame?idx=999&video=0&overlays=")
    assert json.loads(body)["idx"] == 2


def test_temporal_mode_and_reset(gui_env):
    backend, base, _, _ = gui_env
    _, d = _post(base + "/api/reset", {})
    assert d["ok"]
    for i in range(2):
        _, body = _get(base + f"/api/frame?idx={i}&video=1&overlays=temp_pose")
        d = json.loads(body)
        assert {"esa_score", "ori_error", "pos_error"} <= set(d["video"])
    assert backend.inference.pdf_adapt_ori.previous_pdf is not None  # state advanced
    _, d = _post(base + "/api/reset", {})
    assert backend.inference.pdf_adapt_ori.previous_pdf is None


def test_switch_experiment_and_split(gui_env):
    backend, base, _, _ = gui_env
    _, state = _post(base + "/api/select", {"experiment": "exp_b", "split": "valid"})
    assert state["experiment"] == "exp_b" and state["split"] == "valid"
    assert state["n_frames"] == 3
    _, body = _get(base + "/api/frame?idx=0&video=0&overlays=pred_pose")
    assert json.loads(body)["n_frames"] == 3

    # unknown selection -> 500 with error payload, state unchanged
    req = urllib.request.Request(base + "/api/select",
                                 data=json.dumps({"experiment": "nope"}).encode(),
                                 method="POST")
    try:
        urllib.request.urlopen(req, timeout=30)
        raised = False
    except urllib.error.HTTPError as e:
        raised = e.code == 500 and "error" in json.loads(e.read())
    assert raised
    assert backend.exp_name == "exp_b"


def test_discover_splits_layouts(tmp_path):
    """Split discovery covers D-SPEED still / video and SPEED-style layouts,
    as JAX's does."""
    from spef_tpu.apps.gui import discover_experiments as jax_experiments
    from spef_tpu.apps.gui import discover_splits as jax_splits
    from spef_tpu_torch.apps.gui import discover_experiments, discover_splits

    for seq in ("Docking", "S"):
        os.makedirs(tmp_path / seq / "images")
        with open(tmp_path / seq / "pose.json", "w") as f:
            json.dump([], f)
    os.makedirs(tmp_path / "images" / "train")
    with open(tmp_path / "train.json", "w") as f:
        json.dump([], f)

    splits = discover_splits(str(tmp_path))
    assert set(splits) == {"Docking", "S", "train"}
    assert splits["train"][0].endswith(os.path.join("images", "train"))
    assert splits == jax_splits(str(tmp_path))
    os.makedirs(tmp_path / "exps" / "e1")
    (tmp_path / "exps" / "e1" / "config.yaml").write_text("MODEL: {}\n")
    assert discover_experiments(str(tmp_path / "exps")) == \
        jax_experiments(str(tmp_path / "exps")) == {"e1": str(tmp_path / "exps" / "e1")}


def test_engine_variants(tmp_path):
    """Engine selector: float / weight-only / int8-carry / exported, on a QAT
    experiment with an ``int8_graph.pkl`` and a ``model.spef`` written by the
    port; every variant serves frames through the same ``/api/frame`` path."""
    from spef_tpu_torch.apps.gui import GuiBackend
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.deploy import export_predict
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model, save_model
    from spef_tpu_torch.quant.bitwidth import default_bit_width
    from spef_tpu_torch.quant.convert import convert_qat_params

    data = create_synthetic_dataset(str(tmp_path / "data"), n_train=3, n_valid=2, n_test=2,
                                    img_size=(48, 64))
    exps = tmp_path / "experiments"
    def qat(cfg):
        cfg.MODEL.BACKBONE.NAME = "small_mobile"
        cfg.MODEL.HEAD.POS = "regression"
        cfg.MODEL.QUANTIZATION = True

    cfg = _experiment(exps, "exp_q", data, qat)
    exp = exps / "exp_q"

    bw = default_bit_width(n_blocks=2, w=8, a=8, shared=8)
    spe_utils = SPEUtils.create(
        load_camera(data), ori_mode="classification", n_ori_bins_per_dim=4,
        ori_smooth_factor=cfg.DATA.ORI_SMOOTH_FACTOR,
        ori_delete_unused_bins=cfg.MODEL.HEAD.ORI_DELETE_UNUSED_BINS,
        pos_mode="regression", device="cpu")
    model = import_model("small_mobile_q", "ursonet_q", img_size=(48, 64), bit_width=bw,
                         ori_mode="classification", n_ori_bins=spe_utils.orientation.n_bins,
                         pos_mode="regression", seed=5, device="cpu")
    save_model(str(exp / "model"), model, bw)
    graph = convert_qat_params(model)
    with open(exp / "int8_graph.pkl", "wb") as f:
        pickle.dump(graph, f)
    export_predict(build_predict_fn(model, spe_utils), 2, (48, 64), str(exp / "model.spef"),
                   device="cpu")

    backend = GuiBackend(str(exps), data, device="cpu")
    assert backend.engines == ["float", "weight-only", "int8-carry", "exported"]

    poses = {}
    for eng in backend.engines:
        backend.select(engine=eng)
        assert backend.engine_name == eng
        d = backend.frame(0, video=False, overlays={"pred_pose": True, "true_pose": True})
        assert d["latency_ms"] > 0 and "esa_score" in d["still"]
        assert decode_png(base64.b64decode(d["png_b64"])).shape == (48, 64, 3)
        poses[eng] = np.asarray(d["pred"]["ori"])

    # weight-only and int8-carry run the same integer weight grids as the QAT
    # network -> the same decoded orientation up to executor rounding, and up
    # to sign (the decode's eigh fixes none).
    a, b = poses["weight-only"], poses["int8-carry"]
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) <= 0.05, (a, b)

    with pytest.raises(KeyError, match="not available"):
        backend.select(engine="nope-not-real")
    assert backend.engine_name in backend.engines
