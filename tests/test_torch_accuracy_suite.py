"""``apps/accuracy_suite.py`` end to end on the CPU, at ``--tiny``.

One run of every stage (a 32 + 8 + 8-frame still set and one 8-frame
scenario at 240x384, ``small_mobile`` for one epoch, the boundary build
for one QAT epoch, the int8 executors on the kernels' plain versions, both
temporal evaluations), then:

  * every stage's record, log and output, and the summary's keys and rows;
  * a second call skips every finished stage and writes the same summary;
  * a gate that cannot be met (``TINY_GATES`` patched) exits 1, after the
    summary is written with that gate marked failed;
  * the card is asked for unless ``--device cpu`` is given;
  * a trained ESA over the second-seed limit (``TINY_SECOND_SEED_OVER``
    patched to 0, in a copy of the run's folder) trains and evaluates seed
    1002 and reports both seeds.
"""

import json
import os
import shutil

import pytest
import torch

from spef_tpu_torch.apps import accuracy_suite as suite

torch.set_num_threads(2)

OUTPUTS = [
    "train/exp_dspeed_synth/model/parameters.msgpack",
    "train/exp_dspeed_synth/checkpoints/best_meta.json",
    "train/exp_dspeed_synth/eval_score_error.json",
    "jax_asset/exp_dspeed_synth/eval_score_error.json",
    "build/config/int8_graph.pkl",
    "build/config/ladder.json",
    "temporal_jax/temporal_metrics.json",
    "temporal_port/temporal_metrics.json",
    "summary.json",
    "summary.md",
]
SUMMARY_KEYS = {"mode", "device", "card", "sizes", "seed", "best_epoch", "best_epoch_seed2",
                "epochs", "max_memory_allocated_gib", "stage_seconds", "launches", "rows",
                "gates", "ok", "jax_records"}


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    root = tmp_path_factory.mktemp("suite")
    argv = ["--data", str(root / "dspeed"), "--out", str(root / "out"), "--device", "cpu",
            "--tiny"]
    assert suite.main(argv) == 0
    return root, argv


def _summary(root):
    with open(root / "out" / "summary.json") as f:
        return json.load(f)


def test_every_stage_writes_its_outputs_and_the_summary(ran):
    root, _ = ran
    out = root / "out"
    for stage in suite.STAGES:
        assert (out / "stages" / f"{stage}.json").is_file(), stage
        assert (out / "logs" / f"{stage}.log").is_file(), stage
    for path in OUTPUTS:
        assert (out / path).is_file(), path
    assert (root / "dspeed" / "still" / "test" / "pose.json").is_file()
    assert (root / "dspeed" / "video" / "TITR" / "images" / "img000007.png").is_file()
    summary = _summary(root)
    assert set(summary) == SUMMARY_KEYS
    assert summary["mode"] == "tiny" and summary["ok"]
    assert set(summary["stage_seconds"]) == set(suite.STAGES)
    assert [e["epoch"] for e in summary["epochs"]] == [1]
    assert {"train_loss", "valid_esa", "seconds", "frames_per_s"} <= set(summary["epochs"][0])
    assert summary["best_epoch"] == 1
    rows = {(r["row"], r["split"]) for r in summary["rows"]}
    for name in ("jax_asset", "port_trained", "boundarycal_qat", "boundarycal_int8",
                 "boundarycal_weight_only"):
        assert {(name, "valid"), (name, "test")} <= rows, name
    for name in ("layer", "fused", "carry"):
        assert (f"boundarycal_int8_{name}", "test") in rows
    for name in ("temporal_jax_asset", "temporal_port_trained"):
        assert {(name, "TITR/still"), (name, "TITR/video")} <= rows
    assert all("jax_esa" in r and "d_esa" in r for r in summary["rows"])
    assert {g["gate"] for g in summary["gates"]} == set(suite.GATES)
    assert set(summary["launches"]) == {"build", "layer", "fused", "carry"}


def test_a_second_call_skips_the_finished_stages(ran, capsys):
    root, argv = ran
    before = _summary(root)
    capsys.readouterr()
    assert suite.main(argv) == 0
    printed = capsys.readouterr().out
    for stage in suite.STAGES:
        assert f"[suite] {stage}: done (" in printed, stage
    assert "start" not in printed
    after = _summary(root)
    assert after["rows"] == before["rows"] and after["stage_seconds"] == before["stage_seconds"]


def test_a_failed_gate_exits_nonzero_after_the_summary(ran, monkeypatch, capsys):
    root, argv = ran
    monkeypatch.setitem(suite.TINY_GATES, "port_test_esa", -1.0)  # an ESA is never below 0
    assert suite.main(argv) == 1
    assert "port_test_esa" in capsys.readouterr().out
    summary = _summary(root)
    assert not summary["ok"]
    failed = [g["gate"] for g in summary["gates"] if not g["ok"]]
    assert failed == ["port_test_esa"]


def test_the_card_is_asked_for_unless_the_cpu_is(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        suite.main(["--data", str(tmp_path / "d"), "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_an_esa_over_the_limit_trains_a_second_seed(ran, tmp_path, monkeypatch):
    root, argv = ran
    out = tmp_path / "out"
    shutil.copytree(root / "out", out)
    monkeypatch.setattr(suite, "TINY_SECOND_SEED_OVER", 0.0)
    argv = [str(out) if a == str(root / "out") else a for a in argv]
    assert suite.main(argv) == 0
    for stage in ("train_seed2", "eval_seed2"):
        assert (out / "stages" / f"{stage}.json").is_file(), stage
    with open(out / "stages" / "train_seed2.json") as f:
        train2 = json.load(f)
    assert train2["seed"] == suite.SEED + 1 and "1002" in train2["argv"]
    assert (out / "train_seed2" / "exp_dspeed_synth" / "checkpoints" / "best_meta.json").is_file()
    with open(out / "summary.json") as f:
        summary = json.load(f)
    assert summary["seed"] == suite.SEED == 1001
    assert summary["best_epoch_seed2"] == 1
    rows = {(r["row"], r["split"]) for r in summary["rows"]}
    assert {("port_trained_seed2", "valid"), ("port_trained_seed2", "test")} <= rows
    assert {"train_seed2", "eval_seed2"} <= set(summary["stage_seconds"])
    assert summary["ok"]  # the gates stay on the first seed
