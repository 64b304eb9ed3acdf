"""Port parity of inference sharded over a local mesh: the port's
``PoseServer(mesh=)``, ``SPETorch(mesh=)`` and ``SPECropRefine(mesh=)``
against JAX's on the conftest's 8 virtual CPU devices (the counterparts of
``tests/test_serving.py:15-47``, ``tests/test_train_e2e.py:151-167`` and the
sharded half of ``__graft_entry__.dryrun_multichip``), over 8 CPU replicas
(``make_local_mesh("cpu", 8)``).

Models are float32 on both sides (``compute_dtype`` float32 in both
packages), the port's random init carried into the flax tree
(``flax_variables``).  Tolerances:

  * soft-class PDFs within 1e-6, positions within 1e-4, quaternions up to
    sign within 1e-5.  The URSONet model's orientation head is scaled by
    100 after its init, so its PDFs peak (max 0.1-0.3 of 24 bins): an
    untrained head's PDFs are flat within 1e-4 of 1/24, where ``eigh``'s
    eigenvalue gap is so small that float32 rounding of the PDFs (1e-8)
    moves the quaternion by 1e-3 (``tests/test_torch_serving.py``).
  * crop-refine: keypoints and crop boxes within 1e-5 of JAX's; the decoded
    poses bit for bit the port's decode of the gathered keypoints (the
    EPnP of an untrained model's keypoints turns their 1e-7 float32
    rounding into 1e-2 of pose, so JAX's poses are not a reference here).
  * the int8 executors (``layer``, ``fused``, ``carry``, plain twins) on
    ``small_mobile_q`` over 4 CPU replicas against one: every output bit
    for bit (integer sums, and the decode runs once, on the gathered
    window, as on one device).  Float forwards over replicas against one
    device keep quaternions within 1e-2 where the PDFs are flat (an
    untrained head's; the CPU convolution's sum order depends on the
    batch).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JUtils
from spef_tpu.data.camera import SPEED_CAMERA as JAX_CAMERA
from spef_tpu.engine import SPECropRefine as JaxCropRefine
from spef_tpu.engine import SPEJax
from spef_tpu.engine import build_predict_fn as jax_predict_fn
from spef_tpu.models.heads import KeypointRegressionHead as JKeypointHead
from spef_tpu.models.heads import URSONetHead as JHead
from spef_tpu.models.mobilenet_v2 import SmallBackbone as JSmall
from spef_tpu.models.wrapper import ModelWrapper as JWrapper
from spef_tpu.models.wrapper import SPEModel
from spef_tpu.parallel.mesh import make_mesh
from spef_tpu.serving import PoseServer as JaxServer
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import SPEED_CAMERA
from spef_tpu_torch.engine import (SPECropRefine, SPETorch, ShardedPredict, StagedPredict,
                                   _replica, build_predict_fn)
from spef_tpu_torch.models.wrapper import flax_variables, import_model
from spef_tpu_torch.parallel.mesh import data_sharding, make_local_mesh
from spef_tpu_torch.serving import PoseServer, serve_stream

torch.set_num_threads(1)

HW = (32, 32)
SOFT_TOL = 1e-6
POS_TOL = 1e-4
QUAT_TOL = 1e-5
FLAT_QUAT_TOL = 1e-2  # flat PDFs of a float forward: see the module docstring
KP_TOL = 1e-5


def _frames(n, seed, hw=HW):
    return np.random.RandomState(seed).randint(0, 256, (n, *hw, 3), np.uint8)


def _replica_predict(model, utils, **kw):
    """``build(device)``: a predict function on a copy of ``model`` on
    ``device`` (the decode's tables stay ``utils``'s: it runs on the first
    device)."""
    return lambda device: build_predict_fn(copy.deepcopy(model).to(device), utils, **kw)


def _assert_pose(got, want, quat_tol=QUAT_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k == "ori":
            g = g * np.sign((g * w).sum(-1, keepdims=True))
            np.testing.assert_allclose(g, w, rtol=0, atol=quat_tol, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=SOFT_TOL if k.endswith("_soft")
                                       else POS_TOL, err_msg=k)


@pytest.fixture(scope="module")
def ursonet():
    """(port model, port utils, JAX SPEModel, JAX utils): ``small`` +
    ``ursonet``, 4 orientation bins a dimension, position by regression,
    32x32, float32 on both sides, the orientation head scaled by 100."""
    kw = dict(ori_mode="classification", n_ori_bins_per_dim=4, pos_mode="regression",
              use_keypoints=False)
    utils = SPEUtils.create(SPEED_CAMERA, device="cpu", **kw)
    n_ori = utils.orientation.n_bins
    model = import_model("small", "ursonet", img_size=HW, ori_mode="classification",
                         n_ori_bins=n_ori, pos_mode="regression", device="cpu",
                         compute_dtype=torch.float32, seed=7)
    with torch.no_grad():
        model.head.ori_fc.weight.mul_(100.0)
        model.head.ori_fc.bias.mul_(100.0)
    module = JWrapper(backbone=JSmall(compute_dtype=jnp.float32),
                      head=JHead(n_ori_outputs=n_ori, n_pos_outputs=3,
                                 compute_dtype=jnp.float32))
    jax_model = SPEModel(module, flax_variables(model), "small", "ursonet")
    return model.eval(), utils, jax_model, JUtils.create(JAX_CAMERA, **kw)


def test_server_sharded_over_mesh_matches_jax(ursonet):
    model, utils, jax_model, jax_utils = ursonet
    assert len(jax.devices()) == 8  # conftest mesh
    server = PoseServer(_replica_predict(model, utils), img_shape=(*HW, 3), max_batch=16,
                        mesh=make_local_mesh("cpu", 8))
    assert server.warmup() > 0
    images = _frames(10, 0)
    out, latency = server.predict(images)
    assert out["ori"].shape == (10, 4) and out["pos"].shape == (10, 3) and latency > 0
    stats = server.stats()
    assert stats["devices"] == 8 and stats["requests"] == 1
    assert out["ori_soft"].max() > 0.1  # peaked: the eigh decode is well posed
    want, _ = JaxServer(jax_predict_fn(jax_model, jax_utils), img_shape=(*HW, 3),
                        max_batch=16).predict(images)
    _assert_pose(out, want)
    # The mesh is layout only: the unsharded call's poses.
    one = PoseServer(build_predict_fn(model, utils), img_shape=(*HW, 3), max_batch=16,
                     device="cpu")
    _assert_pose(out, one.predict(images)[0])


def test_engine_sharded_matches_jax(ursonet):
    model, utils, jax_model, jax_utils = ursonet
    images = _frames(16, 1)
    engine = SPETorch(model, utils, mesh=make_local_mesh("cpu", 8))
    pose, ms = engine.predict(images)
    assert ms > 0 and engine.device == torch.device("cpu")
    assert pose["ori"].shape == (16, 4) and pose["pos"].shape == (16, 3)
    want, _ = SPEJax(jax_model, jax_utils, mesh=make_mesh(8)).predict(images)
    _assert_pose({k: v.numpy() for k, v in pose.items()}, want)
    plain, _ = SPETorch(model, utils, device="cpu").predict(images)
    _assert_pose({k: v.numpy() for k, v in pose.items()},
                 {k: v.numpy() for k, v in plain.items()})


def test_crop_refine_sharded_matches_jax():
    """The dry run's keypoints models (``small`` + regression head, seeds 0
    and 1, 64x64) through both two-pass engines over 8 devices."""
    kp = dict(ori_mode="keypoints", pos_mode="keypoints")
    utils = SPEUtils.create(SPEED_CAMERA, device="cpu", **kp)
    models = [import_model("small", "keypoints_regression", img_size=(64, 64),
                           n_keypoint_outputs=24, device="cpu", compute_dtype=torch.float32,
                           seed=seed, **kp) for seed in (0, 1)]
    jax_models = [SPEModel(JWrapper(backbone=JSmall(compute_dtype=jnp.float32),
                                    head=JKeypointHead(n_outputs=24)),
                           flax_variables(m), "small", "keypoints_regression") for m in models]
    images = _frames(16, 2, (64, 64))
    pose, _ = SPECropRefine(*models, utils, mesh=make_local_mesh("cpu", 8)).predict(images)
    want, _ = JaxCropRefine(*jax_models, JUtils.create(JAX_CAMERA, **kp),
                            mesh=make_mesh(8)).predict(images)
    assert sorted(pose) == sorted(want)
    for k in ("keypoints", "keypoints_coarse", "keypoints_fine", "crop_box"):
        np.testing.assert_allclose(pose[k].numpy(), np.asarray(want[k]), rtol=0, atol=KP_TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(pose["gate_keep"].numpy(), np.asarray(want["gate_keep"]))
    decoded = utils.keypoints.decode_batch(pose["keypoints"], ransac=False, border_gate=None)
    for k in ("ori", "pos"):
        assert pose[k].shape == np.asarray(want[k]).shape
        torch.testing.assert_close(pose[k], decoded[k], rtol=0, atol=0)
    torch.testing.assert_close(pose["ori"].norm(dim=-1), torch.ones(16), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def int8_graph():
    """(graph, utils): the port's boundary-recipe conversion of a random
    ``small_mobile_q`` + ``ursonet_q`` at 32x48."""
    from spef_tpu_torch.quant.bitwidth import boundary_bit_width
    from spef_tpu_torch.quant.convert import convert_qat_params

    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", n_ori_bins_per_dim=4,
                            pos_mode="regression", device="cpu")
    bw = boundary_bit_width(n_blocks=2)
    model = import_model("small_mobile_q", "ursonet_q", img_size=(32, 48), bit_width=bw,
                         ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
                         pos_mode="regression", device="cpu", seed=23)
    return convert_qat_params(model, bw), utils


@pytest.mark.parametrize("executor", ["layer", "fused", "carry"])
def test_int8_executors_over_a_mesh_bit_for_bit(int8_graph, executor):
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
    from spef_tpu_torch.quant.int8_fused import build_fused_forward

    graph, utils = int8_graph
    build_fwd = {"layer": build_cuda_forward, "fused": build_fused_forward,
                 "carry": build_int8_carry_forward}[executor]

    def build(device):
        return build_predict_fn(None, utils,
                                forward_fn=build_fwd(graph, backend="plain", device=device))

    images = _frames(6, 3, (32, 48))
    sharded = PoseServer(build, (32, 48, 3), max_batch=8, mesh=make_local_mesh("cpu", 4))
    one = PoseServer(build(torch.device("cpu")), (32, 48, 3), max_batch=8, device="cpu")
    got, _ = sharded.predict(images)
    want, _ = one.predict(images)
    assert sharded.stats()["devices"] == 4 and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_refusals(ursonet):
    """A window that does not divide over the mesh raises ``ValueError``
    (JAX's sharding refuses it); an oversize request ``AssertionError``, as
    JAX's server does."""
    model, utils, _, _ = ursonet
    with pytest.raises(ValueError, match="window of 10 rows .* 4-device mesh"):
        PoseServer(_replica_predict(model, utils), (*HW, 3), max_batch=10,
                   mesh=make_local_mesh("cpu", 4))
    server = PoseServer(_replica_predict(model, utils), (*HW, 3), max_batch=8,
                        mesh=make_local_mesh("cpu", 4))
    with pytest.raises(AssertionError, match="serving window"):
        server.predict(_frames(9, 0))
    with pytest.raises(ValueError, match="does not divide"):
        SPETorch(model, utils, mesh=make_local_mesh("cpu", 4)).predict(_frames(6, 0))
    with pytest.raises(ValueError, match="names one device"):
        make_local_mesh("cuda:1", 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            make_local_mesh("cuda")
    assert data_sharding(make_local_mesh("cpu", 4), 8)[3] == slice(6, 8)


def test_a_failing_replica_fails_the_request(ursonet):
    """No fallback: a replica that raises fails the whole request (the
    other replicas' parts are not served on their own)."""
    model, utils, _, _ = ursonet
    built = []

    def build(device):
        predict = build_predict_fn(copy.deepcopy(model), utils)
        if len(built) == 2:
            def predict(images):  # noqa: F811 - the third replica fails
                raise RuntimeError("replica 2 lost its device")
        built.append(predict)
        return predict

    server = PoseServer(build, (*HW, 3), max_batch=8, mesh=make_local_mesh("cpu", 4))
    with pytest.raises(RuntimeError, match="replica 2"):
        server.predict(_frames(8, 0))


def test_every_device_is_launched_before_any_is_finished(ursonet):
    """The sharded run queues every device's forward (``launch``), then
    runs one decode (``finish``, whose host syncs would otherwise keep the
    next device idle): the first replica's, on the gathered batch; the
    result is the unstaged call's."""
    model, utils, _, _ = ursonet
    built, order = [], []

    def build(device):
        predict, i = _replica_predict(model, utils)(device), len(built)
        built.append(device)
        return StagedPredict(lambda x: order.append(("launch", i)) or predict.launch(x),
                             lambda p: order.append(("finish", i)) or predict.finish(p))

    sharded = ShardedPredict.build(make_local_mesh("cpu", 4), build)
    images = torch.from_numpy(_frames(8, 0))
    got = sharded(images)
    assert order == [("launch", i) for i in range(4)] + [("finish", 0)]
    want = build_predict_fn(model, utils)(images)
    _assert_pose({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()})


def test_a_stream_is_served_over_the_mesh_in_two_stages(ursonet):
    """``ShardedPredict.staged()`` under ``serve_stream``: each window's
    rows scattered and every replica launched before the one decode, and
    each window's pose the one-device predict function's."""
    model, utils, _, _ = ursonet
    order = []

    def build(device):
        predict = _replica_predict(model, utils)(device)
        return StagedPredict(lambda x: order.append("launch") or predict.launch(x),
                             lambda p: order.append("finish") or predict.finish(p))

    staged = ShardedPredict.build(make_local_mesh("cpu", 4), build).staged()
    assert isinstance(staged, StagedPredict)
    windows = [_frames(8, seed) for seed in range(3)]
    got = list(serve_stream(staged, windows, depth=2, device="cpu"))
    assert order == (["launch"] * 4 + ["finish"]) * 3
    one = build_predict_fn(model, utils)
    for pose, window in zip(got, windows):
        want = one(torch.from_numpy(window))
        _assert_pose({k: v.numpy() for k, v in pose.items()},
                     {k: v.numpy() for k, v in want.items()})


@pytest.mark.parametrize("on_mesh", [False, True])
def test_update_model_preserves_forward_path(ursonet, on_mesh):
    """``SPEJax.update_model`` (``tests/test_engine_data.py:107-145``): a
    weight swap keeps ``decode`` and, without a new ``forward_fn``, the
    custom forward (a marker offset on the position branch shows it);
    with the rebuilt forward the new path takes effect.  Over a mesh a
    forward is given as ``build(device)``."""
    _, utils, _, _ = ursonet
    kw = dict(img_size=HW, ori_mode="classification", n_ori_bins=utils.orientation.n_bins,
              pos_mode="regression", device="cpu", compute_dtype=torch.float32)
    model = import_model("small", "ursonet", seed=3, **kw).eval()
    model2 = import_model("small", "ursonet", seed=99, **kw).eval()

    def marked(m, offset):
        def forward(images):
            o, p = m(images)
            return o, p + offset
        return forward

    def forward_fn(m, offset):
        if not on_mesh:
            return marked(m, offset)
        return lambda device: marked(copy.deepcopy(m).to(device), offset)

    mesh = make_local_mesh("cpu", 2) if on_mesh else None
    engine = SPETorch(model, utils, decode=False, forward_fn=forward_fn(model, 111.0), mesh=mesh,
                      device="cpu")
    images = _frames(2, 1)
    pose1, _ = engine.predict(images)
    assert "ori" not in pose1 and "ori_soft" in pose1  # decode=False honored
    assert float(pose1["pos"].mean()) > 50.0  # the marker
    engine.update_model(model2)
    pose2, _ = engine.predict(images)
    assert "ori" not in pose2 and engine.mesh is mesh
    torch.testing.assert_close(pose2["pos"], pose1["pos"], rtol=0, atol=0)
    engine.update_model(model2, forward_fn=forward_fn(model2, 222.0))
    pose3, _ = engine.predict(images)
    assert float(pose3["pos"].mean()) > 150.0
    assert not torch.allclose(pose3["pos"], pose2["pos"])
    # Without a custom forward the swap reaches the model itself.
    plain = SPETorch(model, utils, mesh=mesh, device="cpu")
    plain.update_model(model2)
    want, _ = SPETorch(model2, utils, device="cpu").predict(images)
    got, _ = plain.predict(images)
    _assert_pose({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()},
                 quat_tol=FLAT_QUAT_TOL)


def test_a_replica_copies_the_model_only_to_another_device(ursonet):
    """A replica on the model's own device is the model itself; on another
    device a copy (the caller's model stays where it was)."""
    model, _, _, _ = ursonet
    assert _replica(model, torch.device("cpu")) is model and _replica(None, "cpu") is None
    moved = _replica(model, torch.device("meta"))
    assert moved is not model
    assert all(t.device.type == "meta" for t in moved.state_dict().values())
    assert all(t.device.type == "cpu" for t in model.state_dict().values())


def test_kernel_launches_are_counted_by_card():
    """Each wrapper's ``launches`` and ``launches_by_card`` (the card's
    index) count one a launch (``_build.count_launch``, called at each
    wrapper's launch)."""
    from spef_tpu_torch.ops import _build
    from spef_tpu_torch.ops.fused_block import fused_mbconv, fused_stem
    from spef_tpu_torch.ops.int8_ops import int8_depthwise3x3, int8_matmul_requant

    for fn in (int8_matmul_requant, int8_depthwise3x3, fused_stem, fused_mbconv):
        assert isinstance(fn.launches, int) and isinstance(fn.launches_by_card, dict)

    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_card = 0, {}
    for index in (0, 3, 3):
        _build.count_launch(wrapper, torch.device("cuda", index))
    assert wrapper.launches == 3 and wrapper.launches_by_card == {0: 1, 3: 2}


def test_serve_refuses_a_window_that_does_not_divide(monkeypatch):
    """``apps.serve`` over 3 devices with ``--batch 4`` exits with a
    message naming the devices, before any model is built."""
    import os

    import spef_tpu_torch.parallel.mesh as mesh_lib
    from spef_tpu_torch.apps import serve

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setattr(mesh_lib, "make_local_mesh", lambda device: mesh_lib.LocalMesh(
        (torch.device("cpu"),) * 3))
    args = serve.parse_args(["--experiment", os.path.join(repo, "experiments", "train_synth",
                                                          "exp_dspeed_synth"),
                             "--batch", "4", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--batch 4 does not divide over the 3 devices"):
        serve.build_server(args)


def test_serve_builds_one_replica_a_device(monkeypatch, capsys):
    """``apps.serve`` over a mesh of 4 CPU replicas (the mesh ``--device
    cuda`` makes of 4 cards): every replica gets its own forward, the
    window splits over them, and the poses are the one-device server's;
    it prints ``on 4 device(s)``."""
    import os

    import spef_tpu_torch.parallel.mesh as mesh_lib
    from spef_tpu_torch.apps import serve

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = ["--experiment", os.path.join(repo, "experiments", "train_synth", "exp_dspeed_synth"),
            "--int8-graph", os.path.join(repo, "spef_tpu_torch", "assets",
                                         "flagship_boundary_int8_graph.pkl"),
            "--int8-executor", "fused", "--int8-backend", "plain", "--batch", "4",
            "--device", "cpu"]
    one, _ = serve.build_server(serve.parse_args(argv))
    monkeypatch.setattr(mesh_lib, "make_local_mesh", lambda device: mesh_lib.LocalMesh(
        (torch.device("cpu"),) * 4))
    four, img_size = serve.build_server(serve.parse_args(argv))
    assert four.stats()["devices"] == 4 and len(four.predict_fn.replicas) == 4
    frames = _frames(3, 4, img_size)
    got, _ = four.predict(frames)
    want, _ = one.predict(frames)
    assert sorted(got) == sorted(want)
    for k in want:  # the int8 logits, and one decode of the same window
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    serve.main([*argv[:-4], "--batch", "4", "--selftest-frames", "4", "--device", "cpu"])
    assert "on 4 device(s)" in capsys.readouterr().out
