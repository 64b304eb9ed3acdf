"""The accuracy suite's temporal reference: JAX on the CPU over the full-length
scenarios the port writes.

``spef_tpu_torch/assets/temporal_esa_1500.json`` holds the still and video
ESA a scenario of the flagship ``exp_dspeed_synth`` through
``spef_tpu.apps.temporal_eval`` (float, serial, the ``dspeed_video`` filter
constants) on the 11 scenarios of ``python -m spef_tpu_torch.apps.create_dspeed
--skip-still --render --img-height 240 --img-width 384`` (1,500 frames each,
the frames JAX's writer makes: ``tests/test_torch_create_dspeed.py``), with
each scenario's ``frames_sha256``.  ``apps/accuracy_suite.py`` holds the
asset's still ESA through the port to it scenario by scenario, on frames
whose hashes it checks.  The JAX package's own recorded table of these
scenarios (``experiments/accuracy_suite/temporal/temporal_metrics.json``, a
TPU run) is reported beside it: JAX on the CPU does not reproduce it on
these frames (the record's ``recorded_tpu`` rows and ``d_recorded``).

The frames are JAX's writer's: the record's ``jax_writer`` entry writes the
11 scenarios at this size with ``spef_tpu.apps.create_dspeed`` and with the
port's, and holds ``pose.json`` byte for byte and every frame's decoded
pixels equal, and the port's PNG files to ``frames_sha256`` (all 11 equal;
the two writers' PNG encoders differ, so the files' bytes are not
compared).

Regenerate it (about 35 minutes on 8 cores: the frames in the port's render
processes, then JAX's forward on the CPU; the record's ``seconds``), then
its ``jax_writer`` entry (about 9 minutes), from the repo root with

    JAX_PLATFORMS=cpu python -m tests.test_torch_temporal_full [workdir]
    JAX_PLATFORMS=cpu python -m tests.test_torch_temporal_full --writers [workdir]
"""

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "temporal_esa_1500.json")
RECORDED = os.path.join(REPO, "experiments", "accuracy_suite", "temporal",
                        "temporal_metrics.json")
N_FRAMES, IMG_SIZE = 1499, (240, 384)  # create_dspeed's defaults: 1,500 frames a scenario
SCENARIOS = ("CAR", "CATR", "CIR", "Docking", "S", "TAR", "TAT", "TATR", "TIR", "TIT", "TITR")


def test_recorded_full_length_temporal_esa():
    from spef_tpu_torch.apps import accuracy_suite

    with open(ASSET) as f:
        rec = json.load(f)
    assert accuracy_suite.JAX_RECORDS["temporal_same_frames"] == ASSET
    assert rec["n_frames"] == N_FRAMES + 1 and rec["img_size"] == list(IMG_SIZE)
    assert rec["dataset"] == "dspeed_video"
    assert tuple(sorted(rec["scenarios"])) == SCENARIOS
    with open(RECORDED) as f:
        recorded = json.load(f)
    for seq, row in rec["scenarios"].items():
        assert len(row["frames_sha256"]) == 64
        for mode in ("still", "video"):
            assert 0.0 < row[mode]["esa_score"] < 1.0, (seq, mode)
            assert row["recorded_tpu"][mode] == recorded[seq][mode]["esa_score"]


def measure(workdir):
    """Write the 11 scenarios with the port's generator and run JAX's
    ``temporal_eval`` over them on the CPU; returns the record."""
    import time

    import jax

    from spef_tpu.apps import temporal_eval as jax_temporal
    from spef_tpu_torch.apps import create_dspeed

    video = os.path.join(workdir, "video")
    t0 = time.perf_counter()
    create_dspeed.main(["--out", video, "--skip-still", "--render", "--img-height",
                        str(IMG_SIZE[0]), "--img-width", str(IMG_SIZE[1]), "--n-frames",
                        str(N_FRAMES)])
    t1 = time.perf_counter()
    out = os.path.join(workdir, "temporal")
    jax_temporal.main(["--experiment", FLAGSHIP, "--data", video, "--out", out])
    t2 = time.perf_counter()
    with open(os.path.join(out, "temporal_metrics.json")) as f:
        metrics = json.load(f)
    with open(RECORDED) as f:
        recorded = json.load(f)
    scenarios = {}
    for seq in SCENARIOS:
        row = {mode: metrics[seq][mode] for mode in ("still", "video")}
        row["frames_sha256"] = create_dspeed.frames_sha256(os.path.join(video, seq))
        row["recorded_tpu"] = {mode: recorded[seq][mode]["esa_score"] for mode in ("still", "video")}
        row["d_recorded"] = {mode: row[mode]["esa_score"] - row["recorded_tpu"][mode]
                             for mode in ("still", "video")}
        scenarios[seq] = row
    return {
        "what": "still and video (adaptive PDF filter) ESA of the flagship exp_dspeed_synth "
                "on the 11 D-SPEED video scenarios at full length, measured with the JAX "
                "package on the CPU",
        "how": "JAX_PLATFORMS=cpu python -m tests.test_torch_temporal_full",
        "written_by": "python -m spef_tpu_torch.apps.create_dspeed --skip-still --render "
                      f"--img-height {IMG_SIZE[0]} --img-width {IMG_SIZE[1]} "
                      f"--n-frames {N_FRAMES}",
        "n_frames": N_FRAMES + 1, "img_size": list(IMG_SIZE), "dataset": "dspeed_video",
        "executor": "spef_tpu.apps.temporal_eval (serial, bf16 flax forward)",
        "recorded_tpu_note": "experiments/accuracy_suite/temporal/temporal_metrics.json, the "
                             "JAX package's TPU run over these scenarios; d_recorded = this "
                             "record minus it",
        "scenarios": scenarios,
        "jax": jax.__version__, "device": jax.devices()[0].platform,
        "seconds": {"write": round(t1 - t0, 1), "temporal_eval": round(t2 - t1, 1)},
    }


def _pixels_sha256(folder):
    """sha256 of a folder's decoded RGB frames in frame order, and the frame count."""
    import hashlib

    import numpy as np
    from PIL import Image

    h = hashlib.sha256()
    names = sorted(os.listdir(os.path.join(folder, "images")))
    for name in names:
        with Image.open(os.path.join(folder, "images", name)) as im:
            h.update(np.ascontiguousarray(np.asarray(im.convert("RGB"))).tobytes())
    return h.hexdigest(), len(names)


def compare_writers(workdir):
    """Write the 11 scenarios at the reference's size with JAX's writer
    (``spef_tpu.apps.create_dspeed``) and with the port's, and compare them:
    the labels file byte for byte, every frame's decoded pixels (their
    sha256), and the port's PNG files against the reference's
    ``frames_sha256``.  The two writers encode PNG differently, so their file
    bytes are not compared.  Returns the record's ``jax_writer`` entry."""
    import time

    from spef_tpu.apps import create_dspeed as jax_create_dspeed
    from spef_tpu_torch.apps import create_dspeed

    with open(ASSET) as f:
        reference = json.load(f)
    args = ["--skip-still", "--render", "--img-height", str(IMG_SIZE[0]), "--img-width",
            str(IMG_SIZE[1]), "--n-frames", str(N_FRAMES)]
    mine, theirs = os.path.join(workdir, "port"), os.path.join(workdir, "jax")
    t0 = time.perf_counter()
    jax_create_dspeed.main(["--out", theirs, *args])
    t1 = time.perf_counter()
    create_dspeed.main(["--out", mine, *args])
    t2 = time.perf_counter()
    scenarios = {}
    for seq in SCENARIOS:
        with open(os.path.join(mine, seq, "pose.json"), "rb") as f:
            labels = f.read()
        with open(os.path.join(theirs, seq, "pose.json"), "rb") as f:
            labels_jax = f.read()
        pixels, n = _pixels_sha256(os.path.join(mine, seq))
        pixels_jax, n_jax = _pixels_sha256(os.path.join(theirs, seq))
        scenarios[seq] = {
            "frames": n, "frames_jax": n_jax, "labels_equal": labels == labels_jax,
            "pixels_sha256": pixels, "pixels_sha256_jax": pixels_jax,
            "pixels_equal": pixels == pixels_jax,
            "port_files_are_the_reference": create_dspeed.frames_sha256(
                os.path.join(mine, seq)) == reference["scenarios"][seq]["frames_sha256"],
        }
    return {
        "what": "the 11 scenarios at the reference's size written by JAX's writer and by "
                "the port's: pose.json byte for byte, decoded frames by sha256, and the "
                "port's PNG files against this record's frames_sha256",
        "how": "JAX_PLATFORMS=cpu python -m tests.test_torch_temporal_full --writers",
        "jax_writer": "python -m spef_tpu.apps.create_dspeed " + " ".join(args),
        "scenarios": scenarios,
        "seconds": {"jax_write": round(t1 - t0, 1), "port_write": round(t2 - t1, 1)},
    }


def test_reference_frames_are_jax_writers_frames():
    with open(ASSET) as f:
        check = json.load(f)["jax_writer"]
    assert tuple(sorted(check["scenarios"])) == SCENARIOS
    for seq, row in check["scenarios"].items():
        assert row["frames"] == row["frames_jax"] == N_FRAMES + 1, seq
        assert row["labels_equal"] and row["pixels_equal"], seq
        assert row["port_files_are_the_reference"], seq


if __name__ == "__main__":
    argv = sys.argv[1:]
    writers = "--writers" in argv
    argv = [a for a in argv if a != "--writers"]
    work = argv[0] if argv else os.path.join(REPO, "build", "temporal_esa_1500")
    if writers:
        with open(ASSET) as f:
            record = json.load(f)
        record["jax_writer"] = compare_writers(work)
        out = record["jax_writer"]
    else:
        record = measure(work)
        out = record
    with open(ASSET, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out, indent=2))
