"""Port parity: ``spef_tpu_torch.temporal.inference`` against
``spef_tpu.temporal.inference``.

  * ``quaternion_continuity_scan``: equal to JAX's, exactly, on a sequence
    with sign flips and an outlier the |dot| > 0.5 gate keeps out of the
    reference; batched over a leading dimension, equal to a loop.
  * ``sequence_inference``, ``multi_sequence_inference`` and the streaming
    ``Inference``: the trained flagship (MobileNetV2 + URSONet, 1232 + 1000
    bins) on both sides in float32, its weights carried across by
    ``models/wrapper.py::load_flax_variables``, on a 24-frame tumbling
    sequence at 64x96 in the dataset's channel order (and two sequences for
    the batched path), the js constants of ``dspeed_video``.  Soft and
    filtered PDFs within 1e-4, distances within 1e-4, poses within 0.05 deg
    (up to sign: ``eigh`` fixes none) and 1e-3 m.
  * The ``takes_uint8`` route: the int8-carry executor (plain backend, the
    committed flagship graph) gets uint8 frames as they are, and gives the
    same soft outputs, bit for bit, as the route that divides by 255 first
    (JAX's ``sequence_inference`` does, and the carry rounds the pixels
    back): ``round(clip(u / 255) * 255) == u`` for every byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.codec.facade import SPEUtils as JaxSPEUtils
from spef_tpu.data.camera import DSPEED_CAMERA as JAX_CAMERA
from spef_tpu.engine import SPEJax
from spef_tpu.models.heads import URSONetHead as JaxHead
from spef_tpu.models.mobilenet_v2 import MobileNetV2 as JaxMobileNetV2
from spef_tpu.models.wrapper import ModelWrapper as JaxWrapper
from spef_tpu.models.wrapper import SPEModel
from spef_tpu.temporal import inference as jinf
from spef_tpu_torch.apps.create_dspeed import _np_quat_mul, generate_sequence, scenario_table
from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.data.camera import DSPEED_CAMERA
from spef_tpu_torch.data.synthetic import render_frame
from spef_tpu_torch.engine import SPETorch
from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
from spef_tpu_torch.models.wrapper import import_model, load_flax_variables
from spef_tpu_torch.temporal import inference as inf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth", "model",
                      "parameters.msgpack")
GRAPH = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")
N_ORI, N_POS = 1232, 1000
HW, T = (64, 96), 24
PDF_TOL, DEG_TOL, M_TOL = 1e-4, 0.05, 1e-3


# ---------------------------------------------------------------------------
# Continuity
# ---------------------------------------------------------------------------


def _continuity_case(seed):
    """A slowly turning quaternion sequence with sign flips and an outlier."""
    rs = np.random.RandomState(seed)
    q = rs.randn(4)
    seq = []
    for _ in range(20):
        q = q + rs.randn(4) * 0.05
        seq.append(q / np.linalg.norm(q))
    seq = np.asarray(seq, np.float32)
    seq[[3, 4, 9]] *= -1.0  # eigh's arbitrary signs
    orth = rs.randn(4)
    orth -= orth @ seq[6] * seq[6]
    # dot -0.3 with frame 6: flipped, and kept out of the reference.
    seq[7] = -0.3 * seq[6] + np.sqrt(1 - 0.09) * orth / np.linalg.norm(orth)
    return seq


def test_continuity_scan_matches_jax_exactly():
    seq = _continuity_case(0)
    got = inf.quaternion_continuity_scan(torch.from_numpy(seq)).numpy()
    want = np.asarray(jinf.quaternion_continuity_scan(jnp.asarray(seq)))
    np.testing.assert_array_equal(got, want)
    assert (got[[3, 4, 7, 9]] == -seq[[3, 4, 7, 9]]).all()  # flipped
    # The outlier is kept out of the reference: frame 8 compares to frame 6.
    assert -0.5 < float(seq[7] @ seq[6]) < 0 and (got[8] == seq[8]).all()


def test_continuity_scan_batched_matches_a_loop():
    seqs = np.stack([_continuity_case(s) for s in range(3)])
    got = inf.quaternion_continuity_scan(torch.from_numpy(seqs))
    for i in range(3):
        assert torch.equal(got[i], inf.quaternion_continuity_scan(torch.from_numpy(seqs[i])))


# ---------------------------------------------------------------------------
# Sequence, multi-sequence and streaming inference on the flagship
# ---------------------------------------------------------------------------


def _frames(name, n=T):
    """A scenario's first ``n`` frames at 64x96, rendered, in the dataset's
    (RGB) channel order, and its poses."""
    initial_q = _np_quat_mul(np.array([0.0, -0.7071, 0.7071, 0.0]), np.array([1.0, 0, 0, 0]))
    sc = scenario_table(initial_q)[name]
    oris, poss = generate_sequence(n - 1, sc["init"], sc["evo"], DSPEED_CAMERA, sc["camera"])
    rng = np.random.RandomState(0)
    frames = np.stack([render_frame(o.astype(np.float32), p.astype(np.float32),
                                    DSPEED_CAMERA, HW, rng=rng)[..., ::-1] for o, p in
                       zip(oris, poss)])
    return np.ascontiguousarray(frames), oris, poss


@pytest.fixture(scope="module")
def pair():
    """(port utils, port model, JAX utils, JAX model), float32 both."""
    utils = SPEUtils.create(DSPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            use_keypoints=True, device="cpu")
    model = import_model(ori_mode="classification", n_ori_bins=N_ORI, pos_mode="classification",
                         n_pos_bins=N_POS, device="cpu", compute_dtype=torch.float32)
    tree = read_flax_msgpack(PARAMS)
    load_flax_variables(model, tree)
    jutils = JaxSPEUtils.create(JAX_CAMERA, ori_mode="classification",
                                pos_mode="classification")
    module = JaxWrapper(backbone=JaxMobileNetV2(out_features=1280, compute_dtype=jnp.float32),
                        head=JaxHead(n_ori_outputs=N_ORI, n_pos_outputs=N_POS,
                                     compute_dtype=jnp.float32))
    jmodel = SPEModel(module=module, variables=tree, backbone_name="mobilenet_v2",
                      head_name="ursonet")
    return utils, model, jutils, jmodel


def _angle_deg(a, b):
    dot = np.clip(np.abs(np.sum(np.asarray(a, np.float64) * np.asarray(b, np.float64), -1)),
                  0.0, 1.0)
    return np.degrees(2.0 * np.arccos(dot))


def _close_results(got, want, keys):
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.startswith("ori_") and g.shape[-1] == 4:
            assert _angle_deg(g, w).max() <= DEG_TOL, k
        elif k.startswith("pos_") and g.shape[-1] == 3:
            np.testing.assert_allclose(g, w, rtol=0, atol=M_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=PDF_TOL, err_msg=k)


def test_sequence_inference_matches_jax(pair):
    utils, model, jutils, jmodel = pair
    frames, _, _ = _frames("TIR")
    got = inf.sequence_inference(utils, model, frames, dataset="dspeed_video", frame_batch=16)
    want = jinf.sequence_inference(jutils, lambda x: jmodel.apply(x, False),
                                   jnp.asarray(frames), dataset="dspeed_video", frame_batch=16)
    assert sorted(got) == sorted(want)
    _close_results(got, want, sorted(want))
    # The filter moved the video poses off the still ones.
    assert _angle_deg(got["ori_video"].numpy(), got["ori_still"].numpy()).max() > 0.0
    # The continuity pass ties every frame to frame 0's hemisphere.
    q = got["ori_still"].numpy()
    assert (np.sum(q[1:] * q[:-1], -1) > 0).all()


def test_multi_sequence_inference_matches_jax(pair):
    utils, model, jutils, jmodel = pair
    seqs = np.stack([_frames(name)[0] for name in ("TIT", "CIR")])
    kw = dict(dataset="dspeed_video", ori_filter={"n": 0.9}, frame_batch=10)
    got = inf.multi_sequence_inference(utils, model, seqs, **kw)
    want = jinf.multi_sequence_inference(jutils, lambda x: jmodel.apply(x, False),
                                         jnp.asarray(seqs), **kw)
    assert sorted(got) == sorted(want)
    _close_results(got, want, sorted(want))
    one = inf.sequence_inference(utils, model, seqs[1], **kw)
    _close_results({k: v[1] for k, v in got.items()}, one, sorted(got))
    no_filter = inf.multi_sequence_inference(utils, model, seqs, filter_video=False, **kw)
    assert sorted(no_filter) == ["ori_still", "pos_still"]


def test_streaming_inference_matches_jax_and_the_scan(pair):
    utils, model, jutils, jmodel = pair
    frames, _, _ = _frames("TITR")
    mine = inf.Inference(SPETorch(model, utils, device="cpu"), utils, dataset="dspeed_video")
    theirs = jinf.Inference(SPEJax(jmodel, jutils), jutils, dataset="dspeed_video")
    fed, filtered = [], []
    for i in range(len(frames)):
        s, ms, v = mine.predict(frames[i:i + 1], "Adaptative")
        js, _, jv = theirs.predict(frames[i:i + 1], "Adaptative")
        assert ms > 0 and isinstance(v["ori_distance"], float)
        for got, want in ((s, js), (v, jv)):
            assert sorted(got) == sorted(want)
            assert _angle_deg(got["ori"], want["ori"]) <= DEG_TOL
            np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=M_TOL)
            for k in ("ori_soft", "pos_soft", "keypoints", "bbox"):
                np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0,
                                           atol=PDF_TOL if "soft" in k else 1e-3, err_msg=k)
        assert v["pos_distance"] == pytest.approx(jv["pos_distance"], abs=PDF_TOL)
        fed.append(s["ori_soft"])
        filtered.append(v["ori_soft"])
    # Frame by frame, the filter gives what the scan gives on what it was fed.
    from spef_tpu_torch.temporal.pdf_filter import filter_defaults, scan_filter

    cfg = filter_defaults("dspeed_video")[0]
    scan, _ = scan_filter(torch.from_numpy(np.stack(fed)), cfg["n"], cfg["alpha"],
                          cfg["distance_metric"])
    np.testing.assert_allclose(np.stack(filtered), scan.numpy(), rtol=0, atol=1e-6)
    still, _, none = mine.predict(frames[:1])
    assert none is None and "bbox" in still
    with pytest.raises(ValueError, match="not implemented"):
        mine.predict(frames[:1], "Kalman")
    mine.reset()
    assert mine.pdf_adapt_ori.previous_pdf is None and mine.prev_still_ori is None


# ---------------------------------------------------------------------------
# The uint8 route of the int8 executors
# ---------------------------------------------------------------------------


def test_takes_uint8_route_equals_the_divide_by_255_route():
    from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    u = torch.arange(256, dtype=torch.uint8)
    back = torch.round(torch.clamp(u.float() / torch.tensor(255.0), 0.0, 1.0) * 255.0)
    assert torch.equal(back.to(torch.uint8), u)

    forward = build_int8_carry_forward(load_int8_graph(GRAPH), backend="plain", device="cpu")
    assert forward.takes_uint8

    def divided(images):  # no takes_uint8: sequence_inference divides by 255 first
        assert images.dtype == torch.float32
        return forward(images)

    utils = SPEUtils.create(DSPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device="cpu")
    frames, _, _ = _frames("S", 6)
    raw = inf.sequence_inference(utils, forward, frames, dataset="dspeed_video")
    via = inf.sequence_inference(utils, divided, frames, dataset="dspeed_video")
    for k in ("ori_soft", "pos_soft", "ori_video", "pos_video"):
        assert torch.equal(raw[k], via[k]), k
