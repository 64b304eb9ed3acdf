"""The port's serving slice end to end on the CPU: the serve entry point
(``spef_tpu_torch.apps.serve``) on the flagship experiment, float and int8.

The float forward and the int8 forward are each held against JAX in
test_torch_models.py and test_torch_int8_asset.py; here the served path must
give exactly what those functions give, through the padding window.
"""

import os

import numpy as np
import pytest
import torch

from spef_tpu_torch.apps import serve
from spef_tpu_torch.serving import PoseServer

# The suite runs several test processes on the CPU's cores at once: one
# PyTorch thread each keeps their thread pools from oversubscribing them.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")


def _frames(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 240, 384, 3), np.uint8)


def test_int8_serve_pads_and_matches_the_forward():
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward, load_int8_graph

    args = serve.parse_args(["--experiment", FLAGSHIP, "--int8-graph", ASSET,
                             "--int8-backend", "plain", "--batch", "3", "--device", "cpu"])
    server, img_size = serve.build_server(args)
    assert img_size == (240, 384)
    frames = _frames(2)
    pose, latency_ms = server.predict(frames)  # padded 2 -> 3
    assert pose["ori"].shape == (2, 4) and pose["pos"].shape == (2, 3)
    assert pose["ori_soft"].shape == (2, 1232) and pose["pos_soft"].shape == (2, 1000)
    assert np.isfinite(pose["ori"]).all() and latency_ms > 0
    np.testing.assert_allclose(np.linalg.norm(pose["ori"], axis=-1), 1.0, atol=1e-5)

    ori, pos = build_cuda_forward(load_int8_graph(ASSET), backend="plain",
                                  device="cpu")(torch.from_numpy(frames))
    np.testing.assert_array_equal(pose["ori_soft"], torch.softmax(ori, -1).numpy())
    np.testing.assert_array_equal(pose["pos_soft"], torch.softmax(pos, -1).numpy())
    assert server.stats()["requests"] == 1 and server.stats()["devices"] == 1


def test_float_serve_cli_selftest_runs(capsys):
    serve.main(["--experiment", FLAGSHIP, "--batch", "1", "--selftest-frames", "1",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "selftest:" in out and "frames/s" in out


def test_pose_server_rejects_an_oversized_request():
    server = PoseServer(lambda x: {"y": x.float().mean(dim=(1, 2, 3))}, (2, 2, 3),
                        max_batch=2, device="cpu")
    assert server.warmup() >= 0
    out, _ = server.predict(np.full((1, 2, 2, 3), 4, np.uint8))
    assert out["y"].shape == (1,) and out["y"][0] == 4.0
    with pytest.raises(ValueError):
        server.predict(np.zeros((3, 2, 2, 3), np.uint8))


def test_serve_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        serve.main(["--experiment", FLAGSHIP, "--device", "cuda"])


def test_int8_serve_fused_executor_gets_the_uint8_frames():
    """``--int8-executor fused`` on a small graph: the served path hands the
    fused forward the raw uint8 frames (it folds the normalization) and gives
    what the forward gives, through the padding window."""
    import pickle
    import tempfile

    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    # The flagship graph cut to its first two blocks (still 1232 + 1000
    # bins), with a head conv of random weights on the narrower input.
    graph = load_int8_graph(ASSET)
    cin = np.asarray(graph["blocks"][1]["project"]["w_int"]).shape[-1]
    w_head = np.random.RandomState(3).randint(-8, 8, (1, 1, cin, 1280)).astype(np.int8)
    small = dict(graph, blocks=graph["blocks"][:2],
                 head_conv=dict(graph["head_conv"], w_int=w_head))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "int8_graph.pkl")
        with open(path, "wb") as f:
            pickle.dump(small, f, protocol=4)
        args = serve.parse_args(["--experiment", FLAGSHIP, "--int8-graph", path,
                                 "--int8-executor", "fused", "--int8-backend", "plain",
                                 "--batch", "3", "--device", "cpu"])
        server, _ = serve.build_server(args)
    frames = _frames(2, seed=5)
    pose, _ = server.predict(frames)  # padded 2 -> 3
    assert pose["ori"].shape == (2, 4) and pose["pos"].shape == (2, 3)
    assert np.isfinite(pose["ori"]).all()
    fwd = build_fused_forward(small, backend="plain", device="cpu")
    assert fwd.launches_per_call == {"fused_stem": 1, "fused_mbconv": 2,
                                     "int8_matmul_requant": 1}
    ori, pos = fwd(torch.from_numpy(frames))
    np.testing.assert_array_equal(pose["ori_soft"], torch.softmax(ori, -1).numpy())
    np.testing.assert_array_equal(pose["pos_soft"], torch.softmax(pos, -1).numpy())


def test_serve_int8_executor_defaults_to_layer():
    args = serve.parse_args(["--experiment", FLAGSHIP])
    assert args.int8_executor == "layer" and args.int8_backend == "cuda"
    with pytest.raises(SystemExit):
        serve.parse_args(["--experiment", FLAGSHIP, "--int8-executor", "xla"])
