"""The card's JPEG reference (``spef_tpu_torch/assets/speed_jpeg/`` and
``speed_jpeg_ref.npz``), and the port's host data path on it, on the CPU.

The asset: 8 frames at SPEED's 1920x1200, rendered by the port's synthetic
writer (``render_frame``, the SPEED camera, poses of
``generate_positions(RandomState(11))``, noise std 3) and encoded to JPEG
(quality 85) by cv2 here, the test side; beside them JAX's decoded batch at
240x384 (``spef_tpu.native.load_batch``) and JAX's float flagship on it: the
bf16 model ``spef_tpu.apps.serve`` runs and the float32 one (poses and
soft-class PDFs).  ``speed_jpeg_ref.json`` records the files' sha256, the
libjpeg the decode used and the seconds it took.  Regenerate (JAX on the
CPU, about a minute):

    JAX_PLATFORMS=cpu python -m tests.test_torch_host_data_path

``chip_smoke.py`` phase 15 holds the port against it on the card.  Here:

  * the files are those the record names;
  * the port's native loader and JAX's decode the JPEGs to the recorded
    batch, bit for bit, and the port's ``BatchLoader`` on them too;
  * the port's float32 flagship on the recorded batch against JAX's: soft
    PDFs within 1e-4, positions within 1e-3 m (``chip_smoke.py`` phase 3's
    gates for a float32 forward on two devices);
  * ``apps.serve --frames-dir`` on the JPEG directory (float, bf16, on the
    CPU): the printed poses within 10 deg and 0.5 m of JAX's float32 ones
    (phase 3's gates for the served bf16 model) and within 1 deg and 0.05 m
    of JAX's bf16 ones (two bf16 forwards of one checkpoint).
"""

import hashlib
import json
import os
import re
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "spef_tpu_torch", "assets")
JPEG_DIR = os.path.join(ASSETS, "speed_jpeg")
REF_NPZ = os.path.join(ASSETS, "speed_jpeg_ref.npz")
RECORD = os.path.join(ASSETS, "speed_jpeg_ref.json")
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
N_FRAMES, SEED, NOISE_STD, QUALITY = 8, 11, 3.0, 85
HW = (240, 384)
LINE = re.compile(r"^(\S+\.jpg): q=(\[[^\]]*\]) t=(\[[^\]]*\])$")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_native import jax_native_library  # noqa: E402,F401 - JAX's library, built safely


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _names():
    return [f"img{i:06d}.jpg" for i in range(N_FRAMES)]


def _libjpeg_version():
    """``JPEG_LIB_VERSION`` / ``LIBJPEG_TURBO_VERSION`` of the headers g++ finds."""
    import subprocess

    out = subprocess.run(["g++", "-dM", "-E", "-x", "c++", "-"],
                         input="#include <cstdio>\n#include <jpeglib.h>\n",
                         capture_output=True, text=True).stdout
    found = dict(re.findall(r"#define (JPEG_LIB_VERSION|LIBJPEG_TURBO_VERSION) (\S+)", out))
    return ", ".join(f"{k} {v}" for k, v in sorted(found.items()))


def _angle_deg(qa, qb):
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    return 2 * np.degrees(np.arccos(np.clip(np.abs((qa * qb).sum(-1)), 0, 1)))


def regenerate() -> dict:
    """Write the JPEGs, the reference npz and the record (JAX on the CPU)."""
    import cv2
    import jax
    import jax.numpy as jnp
    from flax import serialization

    from spef_tpu import native as jnative
    from spef_tpu.codec.facade import SPEUtils as JUtils
    from spef_tpu.data.camera import SPEED_CAMERA as JCAMERA
    from spef_tpu.engine import build_predict_fn
    from spef_tpu.models.heads import URSONetHead
    from spef_tpu.models.mobilenet_v2 import MobileNetV2
    from spef_tpu.models.wrapper import ModelWrapper, SPEModel, import_model
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.data.synthetic import generate_positions, render_frame

    start = time.perf_counter()
    os.makedirs(JPEG_DIR, exist_ok=True)
    rng = np.random.RandomState(SEED)
    oris, poss = generate_positions(rng, N_FRAMES, SPEED_CAMERA)
    paths = [os.path.join(JPEG_DIR, n) for n in _names()]
    for i, path in enumerate(paths):
        bgr = render_frame(oris[i], poss[i], SPEED_CAMERA, (1200, 1920), NOISE_STD,
                           np.random.RandomState(SEED + i))
        cv2.imwrite(path, bgr, [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
    decoded = jnative.load_batch(paths, *HW)

    params = os.path.join(FLAGSHIP, "model", "parameters.msgpack")
    utils = JUtils.create(JCAMERA, ori_mode="classification", pos_mode="classification")
    bf16 = import_model(params_path=params, ori_mode="classification", n_ori_bins=1232,
                        pos_mode="classification", n_pos_bins=1000)
    with open(params, "rb") as f:
        variables = serialization.msgpack_restore(f.read())
    f32 = SPEModel(module=ModelWrapper(backbone=MobileNetV2(compute_dtype=jnp.float32),
                                       head=URSONetHead(n_ori_outputs=1232, n_pos_outputs=1000)),
                   variables=variables, backbone_name="mobilenet_v2", head_name="ursonet",
                   bit_width=None)
    out = {"decoded": decoded, "true_ori": oris, "true_pos": poss}
    for tag, model in (("bf16", bf16), ("f32", f32)):
        pose = jax.jit(build_predict_fn(model, utils))(jnp.asarray(decoded))
        out[f"ori_{tag}"] = np.asarray(pose["ori"])
        out[f"pos_{tag}"] = np.asarray(pose["pos"])
        if tag == "f32":
            out["ori_soft_f32"] = np.asarray(pose["ori_soft"])
            out["pos_soft_f32"] = np.asarray(pose["pos_soft"])
    np.savez_compressed(REF_NPZ, **out)
    record = {
        "frames": {n: _sha256(p) for n, p in zip(_names(), paths)},
        "npz": _sha256(REF_NPZ),
        "render": {"camera": "SPEED", "size": [1200, 1920], "seed": SEED,
                   "noise_std": NOISE_STD, "jpeg_quality": QUALITY, "encoder": cv2.__version__},
        "decode": {"size": list(HW), "library": "spef_tpu.native.load_batch",
                   "libjpeg": _libjpeg_version()},
        "model": "exp_dspeed_synth float flagship, JAX on the CPU, bf16 and float32",
        "seconds": round(time.perf_counter() - start, 1),
    }
    with open(RECORD, "w") as f:
        json.dump(record, f, indent=2)
    return record


@pytest.fixture(scope="module")
def ref():
    with open(RECORD) as f:
        record = json.load(f)
    assert {n: _sha256(os.path.join(JPEG_DIR, n)) for n in _names()} == record["frames"]
    assert _sha256(REF_NPZ) == record["npz"]
    with np.load(REF_NPZ) as z:
        return {k: z[k] for k in z.files}


def test_native_decode_is_the_recorded_batch(ref):
    from spef_tpu import native as jnative
    from spef_tpu_torch import native
    from spef_tpu_torch.data import dataset

    paths = [os.path.join(JPEG_DIR, n) for n in _names()]
    np.testing.assert_array_equal(native.load_batch(paths, *HW), ref["decoded"])
    np.testing.assert_array_equal(jnative.load_batch(paths, *HW), ref["decoded"])
    labels = [{"filename": n, "q": ref["true_ori"][i].tolist(), "t": ref["true_pos"][i].tolist()}
              for i, n in enumerate(_names())]
    manifest = dataset.Manifest([dataset.PoseRecord(os.path.join(JPEG_DIR, d["filename"]),
                                                    np.float32(d["q"]), np.float32(d["t"]))
                                 for d in labels])
    loader = dataset.BatchLoader(manifest, N_FRAMES, HW, n_workers=2)
    assert loader.decoder == "native"
    np.testing.assert_array_equal(next(iter(loader))["images"], ref["decoded"])


def test_float32_flagship_on_the_batch_matches_jax(ref):
    import torch

    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model

    model = import_model(params_path=os.path.join(FLAGSHIP, "model", "parameters.msgpack"),
                         ori_mode="classification", n_ori_bins=1232, pos_mode="classification",
                         n_pos_bins=1000, device="cpu", compute_dtype=torch.float32)
    utils = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                            device="cpu")
    pose = build_predict_fn(model, utils)(torch.from_numpy(ref["decoded"]))
    assert float((pose["ori_soft"] - torch.from_numpy(ref["ori_soft_f32"])).abs().max()) < 1e-4
    assert float((pose["pos_soft"] - torch.from_numpy(ref["pos_soft_f32"])).abs().max()) < 1e-4
    assert np.abs(pose["pos"].numpy() - ref["pos_f32"]).max() < 1e-3


def test_serve_frames_dir_on_the_jpegs(ref, capsys):
    from spef_tpu_torch.apps import serve

    serve.main(["--experiment", FLAGSHIP, "--batch", "8", "--frames-dir", JPEG_DIR, "--device",
                "cpu"])
    out = capsys.readouterr().out
    assert "Decoder: native" in out
    rows = {}
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            rows[m.group(1)] = (np.array(json.loads(m.group(2))), np.array(json.loads(m.group(3))))
    assert sorted(rows) == _names()
    q = np.stack([rows[n][0] for n in _names()])
    t = np.stack([rows[n][1] for n in _names()])
    assert _angle_deg(q, ref["ori_f32"]).max() < 10.0
    assert np.linalg.norm(t - ref["pos_f32"], axis=-1).max() < 0.5
    assert _angle_deg(q, ref["ori_bf16"]).max() < 1.0
    assert np.linalg.norm(t - ref["pos_bf16"], axis=-1).max() < 0.05


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    print(json.dumps(regenerate(), indent=2))
