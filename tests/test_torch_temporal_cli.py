"""Port parity: ``python -m spef_tpu_torch.apps.temporal_eval`` against
``spef_tpu.apps.temporal_eval`` on the same tiny experiment and video, and
the recorded JAX reference the card's temporal phase is held to.

  * Both apps on one ``small_mobile`` + URSONet experiment (4 + 4 bins per
    dimension, 64x96, random init from the port's seed, saved by the port
    and read by both) and one 24-frame video sequence (plus a second one
    for ``--batch-sequences``) written by the JAX writer: the serial mode,
    ``--batch-sequences``, ``--filter-constants
    experiments/accuracy_suite/temporal_tuning.json`` and ``--no-filter``.
    Each still and video ESA in ``temporal_metrics.json`` within 1e-3 of
    JAX's (both forwards float32 here; the decodes' ``eigh`` and the float32
    filter differ by rounding); the files written are the same.
  * ``spef_tpu_torch/assets/temporal_esa.json``: JAX's numbers on the CPU over
    the 11 scenarios the port's ``create_dspeed`` writes (300 frames each,
    240x384): the float flagship through ``spef_tpu.apps.temporal_eval`` and
    ``int8_carry`` on the committed graph through
    ``spef_tpu.temporal.inference.sequence_inference``.

Regenerate the asset (the frames written by the port's generator in its
render processes, then both JAX runs on the CPU; the record's ``seconds``) from the
repo root with

    JAX_PLATFORMS=cpu python -m tests.test_torch_temporal_cli [workdir]
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
GRAPH = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")
TEMPORAL_ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "temporal_esa.json")
TUNING = os.path.join(REPO, "experiments", "accuracy_suite", "temporal_tuning.json")
# The card's scenarios: create_dspeed --skip-still --render at 240x384,
# --n-frames 299 (300 frames a scenario).
N_FRAMES, IMG_SIZE = 299, (240, 384)


def file_sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _accuracy_md_rows():
    """The temporal table of ACCURACY.md (the JAX package's TPU-era run over
    all 1,500 frames a scenario): {scenario: (still ESA, filtered ESA)}."""
    rows, inside = {}, False
    with open(os.path.join(REPO, "ACCURACY.md")) as f:
        for line in f:
            if line.startswith("## Temporal filtering"):
                inside = True
            elif inside and line.startswith("| ") and not line.startswith("| Scenario"):
                cells = [c.strip() for c in line.strip().strip("|").split("|")]
                rows[cells[0]] = (float(cells[1]), float(cells[2]))
            elif rows and not line.startswith("|"):
                break  # the end of the table
    return rows


def _row(metrics):
    return {"esa": metrics["esa_score"], "ori_deg": metrics["ori_error"],
            "pos_m": metrics["pos_error"]}


# ---------------------------------------------------------------------------
# The port's app against JAX's on a tiny experiment
# ---------------------------------------------------------------------------

TINY_HW = (64, 96)
ESA_TOL = 1e-3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A ``small_mobile_q`` + ``ursonet_q`` experiment with quantization off
    (float32 on both sides: the packages' bf16 float models round apart by
    more than the tolerance on a model this far from trained), random init
    from the port's seed, saved by the port; two 24-frame video sequences
    written by the JAX writer."""
    from spef_tpu.data.synthetic import create_synthetic_video
    from spef_tpu_torch.models.wrapper import import_model, save_model

    root = tmp_path_factory.mktemp("temporal_cli")
    video = create_synthetic_video(str(root), n_frames=24, img_size=TINY_HW)
    create_synthetic_video(str(root), n_frames=24, img_size=TINY_HW, seed=11,
                           seq_name="seq_001")
    exp = root / "exp_tiny"
    model = import_model("small_mobile_q", "ursonet_q", quantization=False,
                         ori_mode="classification", n_ori_bins=64, pos_mode="classification",
                         n_pos_bins=64, img_size=TINY_HW, seed=7, device="cpu")
    save_model(str(exp / "model"), model)
    (exp / "config.yaml").write_text(f"""\
MODEL:
  QUANTIZATION: false
  BACKBONE:
    NAME: small_mobile_q
  HEAD:
    NAME: ursonet_q
    ORI: classification
    POS: classification
    N_ORI_BINS_PER_DIM: 4
    N_POS_BINS_PER_DIM: 4
DATA:
  PATH: {root}/still
  IMG_SIZE: [64, 96]
""")
    return str(exp), video


CLI_CASES = {
    "serial": [],
    "batch_sequences": ["--batch-sequences"],
    "filter_constants": ["--filter-constants", TUNING],
    "no_filter": ["--no-filter"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_temporal_eval_app_matches_jax(tiny, tmp_path, case):
    from spef_tpu.apps import temporal_eval as jax_app
    from spef_tpu_torch.apps import temporal_eval as port_app

    exp, video = tiny
    extra = CLI_CASES[case]
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    port_app.main(["--experiment", exp, "--data", video, "--out", mine, "--device", "cpu",
                   *extra])
    jax_app.main(["--experiment", exp, "--data", video, "--out", theirs, *extra])
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
    with open(os.path.join(mine, "temporal_metrics.json")) as f:
        got = json.load(f)
    with open(os.path.join(theirs, "temporal_metrics.json")) as f:
        want = json.load(f)
    modes = ["still"] if case == "no_filter" else ["still", "video"]
    assert sorted(got) == sorted(want) == ["seq_000", "seq_001"]
    for seq in want:
        assert sorted(got[seq]) == sorted(want[seq]) == modes
        for mode in modes:
            assert sorted(got[seq][mode]) == sorted(want[seq][mode])
            assert got[seq][mode]["esa_score"] == pytest.approx(
                want[seq][mode]["esa_score"], abs=ESA_TOL), (seq, mode)


def test_batch_sequences_matches_the_serial_mode(tiny, tmp_path):
    """As ``tests/test_temporal_cli.py`` holds JAX's two modes together."""
    from spef_tpu_torch.apps import temporal_eval as port_app

    exp, video = tiny
    out = {}
    for name, extra in (("serial", []), ("batched", ["--batch-sequences"])):
        port_app.main(["--experiment", exp, "--data", video, "--out", str(tmp_path / name),
                       "--device", "cpu", *extra])
        with open(tmp_path / name / "temporal_metrics.json") as f:
            out[name] = json.load(f)
    for seq in out["serial"]:
        for mode in ("still", "video"):
            assert out["batched"][seq][mode]["esa_score"] == pytest.approx(
                out["serial"][seq][mode]["esa_score"], rel=1e-4, abs=1e-5)


def test_cuda_device_without_a_card_exits(tiny):
    import torch

    from spef_tpu_torch.apps import temporal_eval as port_app

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    exp, video = tiny
    with pytest.raises(SystemExit, match="--device cpu"):
        port_app.main(["--experiment", exp, "--data", video])


# ---------------------------------------------------------------------------
# The recorded reference of the card's temporal phase
# ---------------------------------------------------------------------------


def test_recorded_temporal_esa():
    with open(TEMPORAL_ASSET) as f:
        rec = json.load(f)
    assert rec["n_frames"] == N_FRAMES + 1 and rec["img_size"] == list(IMG_SIZE)
    assert rec["dataset"] == "dspeed_video" and rec["filter"]["ori"]["distance_metric"] == "js"
    assert rec["int8_graph_sha256"] == file_sha256(GRAPH)
    assert len(rec["scenarios"]) == 11
    for seq, row in rec["scenarios"].items():
        assert len(row["frames_sha256"]) == 64
        for executor in ("float", "int8_carry"):
            for mode in ("still", "video"):
                assert 0.0 < row[executor][mode]["esa"] < 1.0, (seq, executor, mode)


def measure(workdir):
    """Write the 11 scenarios with the port's generator, then run the JAX
    package over them on the CPU: the float flagship through
    ``spef_tpu.apps.temporal_eval`` and ``int8_carry`` on the committed graph
    through ``sequence_inference``.  Returns the record ``temporal_esa.json``
    holds."""
    import time

    import jax
    import jax.numpy as jnp

    from spef_tpu.apps import temporal_eval as jax_temporal
    from spef_tpu.codec.facade import SPEUtils
    from spef_tpu.data.camera import load_camera
    from spef_tpu.data.dataset import detect_dataset, load_dataset
    from spef_tpu.pose.score import score_batch
    from spef_tpu.quant.int8_carry import build_int8_carry_forward
    from spef_tpu.temporal.inference import sequence_inference
    from spef_tpu.temporal.pdf_filter import filter_defaults
    from spef_tpu_torch.apps import create_dspeed
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    video = os.path.join(workdir, "video")
    t0 = time.perf_counter()
    create_dspeed.main(["--out", video, "--skip-still", "--render", "--img-height",
                        str(IMG_SIZE[0]), "--img-width", str(IMG_SIZE[1]), "--n-frames",
                        str(N_FRAMES)])
    t1 = time.perf_counter()
    out = os.path.join(workdir, "temporal_float")
    jax_temporal.main(["--experiment", FLAGSHIP, "--data", video, "--out", out])
    with open(os.path.join(out, "temporal_metrics.json")) as f:
        float_rec = json.load(f)
    t2 = time.perf_counter()

    kind = detect_dataset(video)
    utils = SPEUtils.create(load_camera(video), ori_mode="classification",
                            pos_mode="classification", use_keypoints=False)
    forward = build_int8_carry_forward(load_int8_graph(GRAPH))
    data, split = load_dataset(video, batch_size=32, img_size=IMG_SIZE)
    carry_rec = {}
    for seq in split["eval"]:
        frames, oris, poss = [], [], []
        for batch in data[seq]:
            n = int(batch["mask"].sum())
            frames.append(batch["images"][:n])
            oris.append(batch["ori"][:n])
            poss.append(batch["pos"][:n])
        res = sequence_inference(utils, forward, jnp.asarray(np.concatenate(frames)),
                                 dataset=kind)
        truth = (jnp.asarray(np.concatenate(oris)), jnp.asarray(np.concatenate(poss)))
        carry_rec[seq] = {
            mode: _row({k: float(v) for k, v in score_batch(
                *truth, res[f"ori_{mode}"], res[f"pos_{mode}"]).items()})
            for mode in ("still", "video")}
    t3 = time.perf_counter()

    ori_cfg, pos_cfg = filter_defaults(kind)
    tpu_rows = _accuracy_md_rows()
    scenarios = {}
    for seq in split["eval"]:
        scenarios[seq] = {
            "frames_sha256": create_dspeed.frames_sha256(os.path.join(video, seq)),
            "float": {mode: _row(float_rec[seq][mode]) for mode in ("still", "video")},
            "int8_carry": carry_rec[seq],
            "accuracy_md_tpu": dict(zip(("still", "video"), tpu_rows[seq])),
        }
    return {
        "what": "still and video (adaptive PDF filter) ESA of the flagship exp_dspeed_synth "
                "on the 11 D-SPEED video scenarios, measured with the JAX package on the CPU",
        "how": "JAX_PLATFORMS=cpu python -m tests.test_torch_temporal_cli",
        "written_by": "python -m spef_tpu_torch.apps.create_dspeed --skip-still --render "
                      f"--img-height {IMG_SIZE[0]} --img-width {IMG_SIZE[1]} "
                      f"--n-frames {N_FRAMES}",
        "n_frames": N_FRAMES + 1, "img_size": list(IMG_SIZE),
        "dataset": kind, "filter": {"ori": ori_cfg, "pos": pos_cfg},
        "float_executor": "spef_tpu.apps.temporal_eval (serial, bf16 flax forward)",
        "int8_carry_executor": "spef_tpu.temporal.inference.sequence_inference over "
                               "spef_tpu.quant.int8_carry.build_int8_carry_forward",
        "int8_graph": "spef_tpu_torch/assets/flagship_boundary_int8_graph.pkl",
        "int8_graph_sha256": file_sha256(GRAPH),
        "accuracy_md_tpu_note": "ACCURACY.md's table: a TPU run over all 1,500 frames a "
                                "scenario, other frames; for information only",
        "scenarios": scenarios,
        "jax": jax.__version__, "device": jax.devices()[0].platform,
        "seconds": {"write": round(t1 - t0, 1), "float": round(t2 - t1, 1),
                    "int8_carry": round(t3 - t2, 1)},
    }


if __name__ == "__main__":
    work = sys.argv[1] if len(sys.argv) > 1 else os.path.join(REPO, "build", "temporal_esa")
    record = measure(work)
    with open(TEMPORAL_ASSET, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(record, indent=2))
