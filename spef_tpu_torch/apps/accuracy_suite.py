"""The port's accuracy suite: the flagship made from scratch and scored.

Counterpart of ``experiments/gen_dataset.sh`` and
``experiments/run_accuracy_suite.sh``, the repo's drivers of the JAX
package, on the port's own CLIs.  Its stages, in order, each writing
``<out>/stages/<stage>.json`` (and its log, ``<out>/logs/<stage>.log``) and
skipped when that file exists, so a run cut short goes on where it stopped:

  1. ``render``: the D-SPEED still set (``create_synthetic_dataset``, 20,000 +
     2,000 + 2,000 frames at 240x384, seed 1001) and the 11 video scenarios
     of 1,500 frames (``apps.create_dspeed --skip-still --render``) under
     ``--data``;
  2. ``train``: ``apps.train`` on the recorded recipe
     (``configs/exp_dspeed_synth.yaml`` with ``DATA.PATH`` at the render;
     ``--device-data --device-augment --checkpoint``, which resumes);
  3. ``eval_port`` / ``eval_jax``: ``apps.eval --cache-dataset`` of the
     trained model and of the committed JAX-trained asset
     (``experiments/train_synth/exp_dspeed_synth``) on the valid and test
     splits;
  4. ``build``: ``apps.build_int8 --recipe boundary --qat-epochs 3 --calibrate
     percentile --device-data`` from the trained checkpoint (the
     ``boundarycal`` ladder), then ``executors``: the built graph on the test
     split through ``layer`` (K1/K2), ``fused`` (K3/K4/K1) and ``carry``
     (K1/K2), each kernel's launches counted;
  5. ``temporal_jax`` / ``temporal_port``: ``apps.temporal_eval`` on every
     scenario, the asset's and the trained model's, one after the other;
  6. ``summary.json`` and ``summary.md`` in ``--out``: every row beside
     JAX's recorded figure, the gates, the card, the seconds of each stage
     and the epoch curve.  The temporal rows stand beside JAX's ESAs on the
     same frames (``spef_tpu_torch/assets/temporal_esa_1500.json``, JAX on
     the CPU over the frames the render writes, their sha256 checked) and
     beside JAX's recorded TPU table, which JAX does not reproduce on them.

Training takes the recipe's seed, ``SEED`` (1001), the one the gates were
stated for.  If the trained model's valid or test ESA lands more than 5%
over JAX's, a second seed (``SEED`` + 1) is trained and evaluated and both
are reported (``train_seed2`` / ``eval_seed2``); the gates stay on the
first.

Every number is printed and written before the gates are read; the suite
exits 1 if any failed.  No stage's failure is caught.

Usage:
    python -m spef_tpu_torch.apps.accuracy_suite --data ROOT --out DIR \\
        [--device cuda] [--tiny]

It runs on the card and raises where there is none; ``--device cpu`` runs it
on the CPU, where the int8 executors take the kernels' plain versions.
``--tiny`` runs every stage at a size for a test: 32 + 8 + 8 frames, one
8-frame scenario, ``small_mobile``, one epoch, one QAT epoch, and gates
(``TINY_GATES``) that only ask for finite numbers.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["FULL", "TINY", "GATES", "TINY_GATES", "STAGES", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, "configs", "exp_dspeed_synth.yaml")
FLAGSHIP = os.path.join(REPO, "experiments", "train_synth", "exp_dspeed_synth")
JAX_RECORDS = {
    "flagship": os.path.join(FLAGSHIP, "score_error.json"),
    "ladder": os.path.join(REPO, "experiments", "accuracy_suite", "ladder_boundarycal",
                           "config", "ladder.json"),
    "temporal": os.path.join(REPO, "experiments", "accuracy_suite", "temporal",
                             "temporal_metrics.json"),
    # JAX on the CPU over the scenarios the port writes (tests/test_torch_temporal_full.py):
    # the reference the asset's still ESA is gated on.  The TPU table above is
    # reported beside it; JAX does not reproduce it on these frames.
    "temporal_same_frames": os.path.join(REPO, "spef_tpu_torch", "assets",
                                         "temporal_esa_1500.json"),
}
EXP = "exp_dspeed_synth"
SEED = 1001  # the recipe's seed: the render's, the training's and the build's

# The sizes of a run: experiments/gen_dataset.sh's set and the recorded recipe,
# or a test's.
# ``eval_batch``: run_accuracy_suite.sh's apps.eval --batch-size at full size.
FULL = {"n_train": 20000, "n_valid": 2000, "n_test": 2000, "img_size": (240, 384),
        "n_frames": 1499, "scenarios": None, "epochs": 0, "qat_epochs": 3, "backbone": None,
        "batch": None, "eval_batch": 64}
TINY = {"n_train": 32, "n_valid": 8, "n_test": 8, "img_size": (240, 384), "n_frames": 7,
        "scenarios": ["TITR"], "epochs": 1, "qat_epochs": 1, "backbone": "small_mobile",
        "batch": 8, "eval_batch": 8}

# The gates, stated before the card run: each a limit on one number.
GATES = {
    "jax_valid_esa": 0.003,  # |asset's valid ESA - recorded 0.12932|
    "jax_still_esa": 0.005,  # |a scenario's still ESA - JAX's on the same frames|, the asset
    "scenario_frames": 0,  # scenarios whose frames are not the reference's (sha256)
    "port_test_esa": 0.1384,  # trained test ESA at most (10% over JAX's 0.1258)
    "port_valid_esa": 0.1422,  # trained valid ESA at most (10% over JAX's 0.1293)
    "int8_vs_qat": 0.002,  # |int8 - qat| test ESA of the boundarycal ladder
    "int8_over_float": 1.05,  # int8 test ESA at most this times the trained float's
    "executor_vs_carry": 0.01,  # |layer or fused - carry| test ESA
}
TINY_GATES = {name: math.inf for name in GATES}  # finite numbers only
SECOND_SEED_OVER = 1.05  # a second seed when a trained ESA is over this times JAX's
TINY_SECOND_SEED_OVER = math.inf  # none in --tiny (a test lowers it to take the branch)

# The kernels each int8 executor launches (ops/_build.py counts them).
EXECUTOR_KERNELS = {
    "layer": ("int8_matmul_requant", "int8_depthwise3x3"),
    "fused": ("fused_stem", "fused_mbconv", "int8_matmul_requant"),
    "carry": ("int8_matmul_requant", "int8_depthwise3x3"),
}


class _Tee:
    """stdout into a log file as well (appended: a resumed stage keeps the
    lines of the run it resumes)."""

    def __init__(self, path: str):
        self.file = open(path, "a")
        self.out = sys.stdout

    def write(self, text):
        self.file.write(text)
        return self.out.write(text)

    def flush(self):
        self.file.flush()
        self.out.flush()

    def close(self):
        self.file.close()


class Suite:
    """The stages over one data root and one output folder."""

    def __init__(self, data: str, out: str, device: str, tiny: bool):
        self.data, self.out, self.device, self.tiny = data, out, device, tiny
        self.size = TINY if tiny else FULL
        self.gates = TINY_GATES if tiny else GATES
        self.second_seed_over = TINY_SECOND_SEED_OVER if tiny else SECOND_SEED_OVER
        self.still = os.path.join(data, "still")
        self.video = os.path.join(data, "video")
        self.backend = "cuda" if torch.device(device).type == "cuda" else "plain"
        # Written last by the render: the data root holds this run's set.
        self.marker = os.path.join(data, ".rendered.json")
        for sub in ("stages", "logs"):
            os.makedirs(os.path.join(out, sub), exist_ok=True)

    # -- bookkeeping -----------------------------------------------------
    def _record_path(self, stage: str) -> str:
        return os.path.join(self.out, "stages", f"{stage}.json")

    def record(self, stage: str) -> Optional[dict]:
        path = self._record_path(stage)
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            return json.load(f)

    def run(self, stage: str, fn: Callable[[], dict]) -> dict:
        """``fn``'s record, written with its seconds; skipped where written."""
        done = self.record(stage)
        if done is not None:
            print(f"[suite] {stage}: done ({done['seconds']:.1f} s), skipped", flush=True)
            return done
        print(f"[suite] {stage}: start", flush=True)
        tee = _Tee(os.path.join(self.out, "logs", f"{stage}.log"))
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                rec = fn()
        finally:
            tee.close()
        rec["seconds"] = time.perf_counter() - t0
        rec["card"] = _card()
        tmp = self._record_path(stage) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, self._record_path(stage))
        print(f"[suite] {stage}: {rec['seconds']:.1f} s", flush=True)
        return rec

    # -- 1. render ---------------------------------------------------------
    def render(self) -> dict:
        from spef_tpu_torch.apps import create_dspeed
        from spef_tpu_torch.data.synthetic import create_synthetic_dataset, render_workers

        s = self.size
        h, w = s["img_size"]
        workers = render_workers()
        t0 = time.perf_counter()
        create_synthetic_dataset(self.data, n_train=s["n_train"], n_valid=s["n_valid"],
                                 n_test=s["n_test"], img_size=(h, w), seed=SEED,
                                 workers=workers)
        t1 = time.perf_counter()
        argv = ["--out", self.video, "--skip-still", "--render", "--img-height", str(h),
                "--img-width", str(w), "--n-frames", str(s["n_frames"])]
        if s["scenarios"]:
            argv += ["--scenarios", *s["scenarios"]]
        create_dspeed.main(argv)
        t2 = time.perf_counter()
        sha = {seq: create_dspeed.frames_sha256(os.path.join(self.video, seq))
               for seq in sorted(os.listdir(self.video))}
        with open(self.marker, "w") as f:
            json.dump(s, f)
        return {"still": self.still, "video": self.video, "workers": workers,
                "still_seconds": t1 - t0, "video_seconds": t2 - t1, "frames_sha256": sha,
                "frames": {k: s[k] for k in ("n_train", "n_valid", "n_test")},
                "scenario_frames": s["n_frames"] + 1}

    # -- 2. train ----------------------------------------------------------
    def _config(self, folder: str) -> str:
        """The recipe's config with DATA.PATH at the render (and, in
        ``--tiny``, the small backbone and batch); the file itself is left
        as it is."""
        from spef_tpu_torch.config.train_config import load_config, save_config

        cfg = load_config(RECIPE)
        cfg.DATA.PATH = self.still
        if self.size["backbone"]:
            cfg.MODEL.BACKBONE.NAME = self.size["backbone"]
            cfg.DATA.BATCH_SIZE = self.size["batch"]
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f"{EXP}.yaml")
        save_config(cfg, path)
        return path

    def train(self, seed: int, folder: str) -> dict:
        from spef_tpu_torch.apps import train as train_app

        cfg = self._config(folder)
        argv = ["--config", cfg, "--out", folder, "--device-data", "--device-augment",
                "--checkpoint", "--seed", str(seed), "--device", self.device]
        if self.size["epochs"]:
            argv += ["--epochs", str(self.size["epochs"])]
        print("apps.train " + " ".join(argv), flush=True)
        result = train_app.main(argv)[EXP]
        if result is None:
            raise RuntimeError(f"apps.train failed: see {os.path.join(folder, EXP, 'error.log')}")
        exp = result["folder"]
        with open(os.path.join(exp, "checkpoints", "best_meta.json")) as f:
            best = json.load(f)
        return {"experiment": exp, "seed": seed, "argv": argv, "best_epoch": best["epoch"],
                "best": best, "final": {"score": result["score"], "error": result["error"]}}

    # -- 3. eval -----------------------------------------------------------
    def jax_asset(self) -> str:
        """A copy of the committed asset's experiment whose ``model/`` is
        the asset's, so that what the apps write lands in the copy."""
        exp = os.path.join(self.out, "jax_asset", EXP)
        if not os.path.isdir(exp):
            os.makedirs(exp)
            shutil.copy(os.path.join(FLAGSHIP, "config.yaml"), exp)
            os.symlink(os.path.join(FLAGSHIP, "model"), os.path.join(exp, "model"))
        return exp

    def evaluate(self, exp: str) -> dict:
        from spef_tpu_torch.apps import eval as eval_app

        argv = ["--experiment", exp, "--data", self.still, "--batch-size", str(self.size["eval_batch"]),
                "--cache-dataset", "--device", self.device]
        print("apps.eval " + " ".join(argv), flush=True)
        score, error = eval_app.main(argv)
        return {"experiment": exp, "score": score, "error": error}

    # -- 4. build and executors ----------------------------------------------
    def build(self, exp: str) -> dict:
        from spef_tpu_torch.apps import build_int8 as build_app

        out = os.path.join(self.out, "build")
        shutil.rmtree(out, ignore_errors=True)  # a build cut short starts again
        argv = ["--config", os.path.join(exp, "config.yaml"), "--out", out,
                "--recipe", "boundary", "--fp32-checkpoint",
                os.path.join(exp, "model", "parameters.msgpack"),
                "--qat-epochs", str(self.size["qat_epochs"]), "--calibrate", "percentile",
                "--device-data", "--seed", str(SEED), "--device", self.device]
        print("apps.build_int8 " + " ".join(argv), flush=True)
        with _counting() as launches:
            result = build_app.main(argv)
        return {"folder": result["folder"], "argv": argv, "ladder": result["ladder"],
                "errors": result["errors"], "parity": result["parity"],
                "launches": launches}

    def executors(self, graph_folder: str) -> dict:
        from spef_tpu_torch.codec.facade import SPEUtils
        from spef_tpu_torch.config.train_config import load_config
        from spef_tpu_torch.data.camera import load_camera
        from spef_tpu_torch.data.dataset import load_dataset
        from spef_tpu_torch.engine import SPETorch
        from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
        from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
        from spef_tpu_torch.quant.int8_fused import build_fused_forward
        from spef_tpu_torch.quant.int8_graph import load_int8_graph
        from spef_tpu_torch.train.trainer import evaluation

        cfg = load_config(os.path.join(graph_folder, "config.yaml"))
        utils = SPEUtils.from_config(cfg, load_camera(self.still), device=self.device)
        data, _ = load_dataset(self.still, self.size["eval_batch"], tuple(cfg.DATA.IMG_SIZE),
                               cache=True, device=self.device)
        batches = {"test": list(data["test"])}
        graph = load_int8_graph(os.path.join(graph_folder, "int8_graph.pkl"))
        rec = {"backend": self.backend, "batches": len(batches["test"])}
        for name, build in (("layer", build_cuda_forward), ("fused", build_fused_forward),
                            ("carry", build_int8_carry_forward)):
            engine = SPETorch(None, utils, forward_fn=build(graph, backend=self.backend,
                                                            device=self.device),
                              device=self.device)
            t0 = time.perf_counter()
            with _counting() as launches:
                score, error = evaluation(engine, batches, utils, ("test",))
            if self.backend == "cuda":
                if torch.device(self.device).type == "cuda":
                    torch.cuda.synchronize(self.device)
                missing = [k for k in EXECUTOR_KERNELS[name] if not launches[k]]
                if missing:
                    raise RuntimeError(f"{name}: no launch of {missing} over the test split "
                                       f"({launches})")
            print(f"[executors] {name} ({self.backend}) test esa="
                  f"{score['test']['esa'][0]:.6f}; launches {launches}", flush=True)
            rec[name] = {"score": score, "error": error, "launches": launches,
                         "seconds": time.perf_counter() - t0}
        return rec

    # -- 5. temporal -------------------------------------------------------
    def temporal(self, exp: str, out: str) -> dict:
        from spef_tpu_torch.apps import temporal_eval

        argv = ["--experiment", exp, "--data", self.video, "--out", out, "--device",
                self.device]
        print("apps.temporal_eval " + " ".join(argv), flush=True)
        temporal_eval.main(argv)
        with open(os.path.join(out, "temporal_metrics.json")) as f:
            return {"experiment": exp, "metrics": json.load(f)}


@contextlib.contextmanager
def _counting():
    """Every kernel's launches from 0 over the block, read at its end into
    the dict it yields."""
    from spef_tpu_torch.ops.fused_block import fused_mbconv, fused_stem
    from spef_tpu_torch.ops.int8_ops import int8_depthwise3x3, int8_matmul_requant

    wrappers = {"int8_matmul_requant": int8_matmul_requant,
                "int8_depthwise3x3": int8_depthwise3x3, "fused_stem": fused_stem,
                "fused_mbconv": fused_mbconv}
    for fn in wrappers.values():
        fn.launches = 0
        fn.launches_by_card = {}
    counts: Dict[str, int] = {}
    try:
        yield counts
    finally:
        counts.update({name: fn.launches for name, fn in wrappers.items()})


# ---------------------------------------------------------------------------
# The summary
# ---------------------------------------------------------------------------

_EPOCH = re.compile(r"^epoch\s+(\d+) \[(train|valid) *\] loss=(\S+) esa=(\S+) ")
_TIMING = re.compile(r"^epoch\s+(\d+) \[timing\] .*?; ([\d.]+) frames/s, .*? of the phase's "
                     r"([\d.]+) s; peak memory (?:([\d.]+) GiB|n/a)")


def _number(text: str) -> Optional[float]:
    try:
        return float(text)
    except ValueError:  # "n/a"
        return None


def epoch_curve(log_path: str) -> List[dict]:
    """Per epoch, from the training log (a resumed epoch's last lines win):
    train loss and ESA, valid loss and ESA, the train phase's seconds,
    frames/s and peak memory."""
    epochs: Dict[int, dict] = {}
    if not os.path.isfile(log_path):
        return []
    with open(log_path) as f:
        for line in f:
            m = _EPOCH.match(line)
            if m:
                e = epochs.setdefault(int(m.group(1)), {"epoch": int(m.group(1))})
                e[f"{m.group(2)}_loss"] = _number(m.group(3))
                e[f"{m.group(2)}_esa"] = _number(m.group(4))
                continue
            m = _TIMING.match(line)
            if m:
                e = epochs.setdefault(int(m.group(1)), {"epoch": int(m.group(1))})
                e.update(frames_per_s=float(m.group(2)), seconds=float(m.group(3)),
                         peak_memory_gib=_number(m.group(4) or "n/a"))
    return [epochs[k] for k in sorted(epochs)]


def _row(name: str, split: str, score: dict, error: Optional[dict], ref: Optional[dict]) -> dict:
    """One row: ESA, orientation and position scores (and errors where the
    source has them) beside JAX's recorded ones."""
    row = {"row": name, "split": split, "esa": score["esa"][0], "ori_score": score["ori"][0],
           "pos_score": score["pos"][0]}
    if error is not None:
        row.update(ori_error_deg=error["ori"][0], pos_error_m=error["pos"][0])
    if ref is not None:
        row["jax_esa"] = ref["esa"][0]
        row["d_esa"] = row["esa"] - row["jax_esa"]
    return row


def _temporal_rows(name: str, metrics: dict, jax: dict) -> List[dict]:
    """A scenario's still and filtered rows beside JAX's on the same frames
    (``jax_esa``) and JAX's recorded TPU table (``recorded_esa``)."""
    rows = []
    same = jax["temporal_same_frames"]["scenarios"]
    for seq, entry in metrics.items():
        for mode in ("still", "video"):
            if mode not in entry:
                continue
            m = entry[mode]
            row = {"row": name, "split": f"{seq}/{mode}", "esa": m["esa_score"],
                   "ori_score": m["ori_score"], "pos_score": m["pos_score"],
                   "ori_error_deg": m["ori_error"], "pos_error_m": m["pos_error"]}
            if seq in same:
                row["jax_esa"] = same[seq][mode]["esa_score"]
                row["d_esa"] = row["esa"] - row["jax_esa"]
            if seq in jax["temporal"]:
                row["recorded_esa"] = jax["temporal"][seq][mode]["esa_score"]
                row["d_recorded"] = row["esa"] - row["recorded_esa"]
            rows.append(row)
    return rows


def _card() -> dict:
    """The card's name and power limit (nvidia-smi), torch and CUDA."""
    card = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        card["nvidia_smi"] = out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        card["nvidia_smi"] = None
    if torch.cuda.is_available():
        card["name"] = torch.cuda.get_device_name(0)
    return card


def gate_table(rec: Dict[str, dict], gates: Dict[str, float], jax: dict) -> List[dict]:
    """Each gate: its number, limit and verdict (a NaN fails)."""
    out = []

    def gate(name, what, value, limit, ok):
        out.append({"gate": name, "what": what, "value": value, "limit": limit,
                    "ok": bool(ok) and not math.isnan(value)})

    recorded_valid = jax["flagship"]["scores"]["valid"]["esa"][0]
    v = rec["eval_jax"]["score"]["valid"]["esa"][0]
    gate("jax_valid_esa", f"|asset's valid ESA - recorded {recorded_valid:.5f}|",
         abs(v - recorded_valid), gates["jax_valid_esa"],
         abs(v - recorded_valid) <= gates["jax_valid_esa"])
    same = jax["temporal_same_frames"]["scenarios"]
    rendered = rec["render"]["frames_sha256"]
    other = sorted(seq for seq in rendered
                   if rendered[seq] != same.get(seq, {}).get("frames_sha256"))
    gate("scenario_frames", f"scenarios whose frames are not the reference's: {other}",
         float(len(other)), gates["scenario_frames"], len(other) <= gates["scenario_frames"])
    for seq, entry in rec["temporal_jax"]["metrics"].items():
        ref = same.get(seq, {}).get("still")
        d = float("nan") if ref is None else abs(entry["still"]["esa_score"] - ref["esa_score"])
        gate("jax_still_esa", f"{seq}: |asset's still ESA - JAX's on the same frames|", d,
             gates["jax_still_esa"], d <= gates["jax_still_esa"])
    for split in ("test", "valid"):
        v = rec["eval_port"]["score"][split]["esa"][0]
        gate(f"port_{split}_esa", f"trained {split} ESA", v, gates[f"port_{split}_esa"],
             v <= gates[f"port_{split}_esa"])
    ladder = rec["build"]["ladder"]
    qat, int8 = ladder["qat"]["test"]["esa"][0], ladder["int8"]["test"]["esa"][0]
    gate("int8_vs_qat", "|int8 - qat| test ESA", abs(int8 - qat), gates["int8_vs_qat"],
         abs(int8 - qat) <= gates["int8_vs_qat"])
    f_esa = rec["eval_port"]["score"]["test"]["esa"][0]
    gate("int8_over_float", "int8 test ESA / trained float's", int8 / f_esa,
         gates["int8_over_float"], int8 <= gates["int8_over_float"] * f_esa)
    carry = rec["executors"]["carry"]["score"]["test"]["esa"][0]
    for name in ("layer", "fused"):
        d = abs(rec["executors"][name]["score"]["test"]["esa"][0] - carry)
        gate("executor_vs_carry", f"|{name} - carry| test ESA", d, gates["executor_vs_carry"],
             d <= gates["executor_vs_carry"])
    return out


def jax_records() -> dict:
    """JAX's recorded figures (``JAX_RECORDS``)."""
    jax = {}
    for key, path in JAX_RECORDS.items():
        with open(path) as f:
            jax[key] = json.load(f)
    return jax


def summarize(suite: Suite, rec: Dict[str, dict], jax: dict) -> dict:
    jax_scores = jax["flagship"]["scores"]
    jax_errors = jax["flagship"]["errors"]
    rows = []
    for key, label in (("eval_jax", "jax_asset"), ("eval_port", "port_trained"),
                       ("eval_seed2", "port_trained_seed2")):
        if key in rec:
            for split in ("valid", "test"):
                r = _row(label, split, rec[key]["score"][split], rec[key]["error"][split],
                         jax_scores[split])
                r["jax_ori_error_deg"] = jax_errors[split]["ori"][0]
                r["jax_pos_error_m"] = jax_errors[split]["pos"][0]
                rows.append(r)
    for stage, score in rec["build"]["ladder"].items():
        for split in ("valid", "test"):
            rows.append(_row(f"boundarycal_{stage}", split, score[split],
                             rec["build"]["errors"][stage][split],
                             jax["ladder"]["scores"][stage][split]))
    for name in ("layer", "fused", "carry"):
        e = rec["executors"][name]
        rows.append(_row(f"boundarycal_int8_{name}", "test", e["score"]["test"],
                         e["error"]["test"], jax["ladder"]["scores"]["int8"]["test"]))
    rows += _temporal_rows("temporal_jax_asset", rec["temporal_jax"]["metrics"], jax)
    rows += _temporal_rows("temporal_port_trained", rec["temporal_port"]["metrics"], jax)
    gates = gate_table(rec, suite.gates, jax)
    epochs = epoch_curve(os.path.join(suite.out, "logs", "train.log"))
    peaks = [e["peak_memory_gib"] for e in epochs if e.get("peak_memory_gib")]
    return {
        "mode": "tiny" if suite.tiny else "full",
        "device": suite.device,
        "card": rec["train"]["card"],
        "sizes": dict(suite.size),
        "seed": SEED,
        "best_epoch": rec["train"]["best_epoch"],
        "best_epoch_seed2": rec["train_seed2"]["best_epoch"] if "train_seed2" in rec else None,
        "epochs": epochs,
        "max_memory_allocated_gib": max(peaks) if peaks else None,
        "stage_seconds": {k: v["seconds"] for k, v in rec.items()},
        "launches": {"build": rec["build"]["launches"],
                     **{name: rec["executors"][name]["launches"]
                        for name in ("layer", "fused", "carry")}},
        "rows": rows,
        "gates": gates,
        "ok": all(g["ok"] for g in gates),
        "jax_records": {k: os.path.relpath(v, REPO) for k, v in JAX_RECORDS.items()},
    }


def _fmt(x, spec=".6f"):
    return "—" if x is None else format(x, spec)


def write_summary(out: str, summary: dict) -> None:
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    card = summary["card"]
    lines = [f"# Accuracy suite of the port ({summary['mode']})", "",
             f"Card: {card.get('nvidia_smi') or 'none (' + summary['device'] + ')'}; torch "
             f"{card['torch']}, CUDA {card['cuda']}. Written by "
             f"`python -m spef_tpu_torch.apps.accuracy_suite`.", "",
             f"Best-on-valid epoch: {summary['best_epoch']}"
             + (f" (seed 2: {summary['best_epoch_seed2']})"
                if summary["best_epoch_seed2"] is not None else "")
             + f"; max_memory_allocated {_fmt(summary['max_memory_allocated_gib'], '.3f')} GiB.",
             "", "JAX ESA: JAX's recorded figure; for the temporal rows JAX on the CPU over "
             "the same frames, and beside it JAX's recorded TPU table.", "",
             "| row | split | ESA | ori score | pos score | ori deg | pos m | JAX ESA | d "
             "| recorded TPU | d |", "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in summary["rows"]:
        lines.append(f"| {r['row']} | {r['split']} | {_fmt(r['esa'])} | "
                     f"{_fmt(r['ori_score'])} | {_fmt(r['pos_score'])} | "
                     f"{_fmt(r.get('ori_error_deg'), '.3f')} | "
                     f"{_fmt(r.get('pos_error_m'), '.4f')} | {_fmt(r.get('jax_esa'))} | "
                     f"{_fmt(r.get('d_esa'), '+.6f')} | {_fmt(r.get('recorded_esa'))} | "
                     f"{_fmt(r.get('d_recorded'), '+.6f')} |")
    lines += ["", "| gate | what | value | limit | ok |", "|---|---|---|---|---|"]
    for g in summary["gates"]:
        what = g["what"].replace("|", "\\|")
        lines.append(f"| {g['gate']} | {what} | {_fmt(g['value'])} | {g['limit']} | "
                     f"{'yes' if g['ok'] else 'NO'} |")
    lines += ["", "Seconds a stage: " + ", ".join(
        f"{k} {v:.1f}" for k, v in summary["stage_seconds"].items()), "",
        "| epoch | train loss | train ESA | valid loss | valid ESA | s | frames/s |",
        "|---|---|---|---|---|---|---|"]
    for e in summary["epochs"]:
        lines.append(f"| {e['epoch']} | {_fmt(e.get('train_loss'), '.4f')} | "
                     f"{_fmt(e.get('train_esa'), '.4f')} | {_fmt(e.get('valid_loss'), '.4f')} | "
                     f"{_fmt(e.get('valid_esa'), '.4f')} | {_fmt(e.get('seconds'), '.2f')} | "
                     f"{_fmt(e.get('frames_per_s'), '.1f')} |")
    with open(os.path.join(out, "summary.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _same_render(suite: Suite) -> bool:
    try:
        with open(suite.marker) as f:
            return json.load(f) == json.loads(json.dumps(suite.size))
    except (OSError, ValueError):
        return False


# ---------------------------------------------------------------------------

STAGES = ("render", "train", "eval_port", "eval_jax", "build", "executors", "temporal_jax",
          "temporal_port")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", required=True, help="dataset root: still/ and video/")
    parser.add_argument("--out", required=True, help="the suite's folder")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true", help="every stage at a test's size")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the suite on the CPU")

    suite = Suite(os.path.abspath(args.data), os.path.abspath(args.out), args.device,
                  args.tiny)
    if not _same_render(suite):  # another root, or a render cut short: render again
        with contextlib.suppress(FileNotFoundError):
            os.remove(suite._record_path("render"))
    rec = {"render": suite.run("render", suite.render)}
    rec["train"] = suite.run("train", lambda: suite.train(
        SEED, os.path.join(suite.out, "train")))
    rec["eval_port"] = suite.run("eval_port", lambda: suite.evaluate(rec["train"]["experiment"]))
    rec["eval_jax"] = suite.run("eval_jax", lambda: suite.evaluate(suite.jax_asset()))
    jax = jax_records()
    jax_scores = jax["flagship"]["scores"]
    over = max(rec["eval_port"]["score"][s]["esa"][0] / jax_scores[s]["esa"][0]
               for s in ("valid", "test"))
    if over > suite.second_seed_over or suite.record("train_seed2"):
        rec["train_seed2"] = suite.run("train_seed2", lambda: suite.train(
            SEED + 1, os.path.join(suite.out, "train_seed2")))
        rec["eval_seed2"] = suite.run("eval_seed2", lambda: suite.evaluate(
            rec["train_seed2"]["experiment"]))
    rec["build"] = suite.run("build", lambda: suite.build(rec["train"]["experiment"]))
    rec["executors"] = suite.run("executors", lambda: suite.executors(rec["build"]["folder"]))
    rec["temporal_jax"] = suite.run("temporal_jax", lambda: suite.temporal(
        suite.jax_asset(), os.path.join(suite.out, "temporal_jax")))
    rec["temporal_port"] = suite.run("temporal_port", lambda: suite.temporal(
        rec["train"]["experiment"], os.path.join(suite.out, "temporal_port")))

    summary = summarize(suite, rec, jax)
    write_summary(suite.out, summary)
    for r in summary["rows"]:
        print(f"[summary] {r['row']} {r['split']}: esa {r['esa']:.6f}"
              + (f" (JAX {r['jax_esa']:.6f}, d {r['d_esa']:+.6f})" if "jax_esa" in r else ""))
    for g in summary["gates"]:
        print(f"[gate] {g['gate']}: {g['what']} = {g['value']:.6f}, limit {g['limit']}: "
              f"{'ok' if g['ok'] else 'FAILED'}")
    print(f"[suite] summary: {os.path.join(suite.out, 'summary.json')}; "
          f"{'every gate met' if summary['ok'] else 'a gate FAILED'}", flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
