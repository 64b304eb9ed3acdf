"""Evaluation loop — the counterpart of ``spef_tpu.train.trainer.evaluation``.

The rest of the trainer (the fit loop, checkpoints, schedules) comes with
training (ROADMAP §A, item 6).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.pose.score import pose_errors
from spef_tpu_torch.utils.metrics import RunningAverage, mad

__all__ = ["evaluation"]


def evaluation(
    engine,
    data: Dict[str, Iterable[Dict[str, np.ndarray]]],
    spe_utils: SPEUtils,
    split: Tuple[str, ...] = ("valid",),
) -> Tuple[Dict, Dict]:
    """Engine-agnostic evaluation: ``engine.predict(images) -> (pose,
    latency_ms)``, duck-typed; ``data[phase]`` yields the loader's padded
    batches (``mask`` marks the real rows).  Returns ``(rec_score,
    rec_error)``: the running averages weighted by the valid rows of each
    batch, with the std and the MAD of the per-frame errors."""
    rec_score = {x: {"ori": [], "pos": [], "esa": []} for x in split}
    rec_error = {
        x: {"ori": [], "pos": [], "ori_std": [], "pos_std": [], "ori_mad": [], "pos_mad": []}
        for x in split
    }
    for phase in split:
        errors = {"ori": [], "pos": []}
        running = RunningAverage(keys=("esa_score", "ori_score", "pos_score", "ori_error",
                                       "pos_error"))
        for batch in data[phase]:
            pose, _ = engine.predict(batch["images"])
            n_valid = int(batch["mask"].sum())
            # The engine's pose lives on its device; scoring is on the host.
            ori_p = torch.as_tensor(pose["ori"]).cpu()[:n_valid]
            pos_p = torch.as_tensor(pose["pos"]).cpu()[:n_valid]
            e = pose_errors(batch["ori"][:n_valid], batch["pos"][:n_valid], ori_p, pos_p)
            if int(e["invalid"]) > 0:
                raise ValueError("Intermediate sum issue due to error in model prediction")
            ori_err = e["ori_error"].numpy()
            pos_err = e["pos_error"].numpy()
            norm_pos = e["norm_pos_error"].numpy()
            metrics = {
                "esa_score": float(np.mean(ori_err) + np.mean(norm_pos)),
                "ori_score": float(np.mean(ori_err)),
                "pos_score": float(np.mean(norm_pos)),
                "ori_error": float(np.rad2deg(np.mean(ori_err))),
                "pos_error": float(np.mean(pos_err)),
            }
            running.update(metrics, n_valid)
            errors["ori"].extend(np.rad2deg(ori_err).tolist())
            errors["pos"].extend(pos_err.tolist())

        rec_score[phase]["ori"].append(running.get("ori_score"))
        rec_score[phase]["pos"].append(running.get("pos_score"))
        rec_score[phase]["esa"].append(running.get("esa_score"))
        rec_error[phase]["ori"].append(running.get("ori_error"))
        rec_error[phase]["pos"].append(running.get("pos_error"))
        rec_error[phase]["ori_std"].append(float(np.std(errors["ori"])))
        rec_error[phase]["pos_std"].append(float(np.std(errors["pos"])))
        rec_error[phase]["ori_mad"].append(mad(errors["ori"]))
        rec_error[phase]["pos_mad"].append(mad(errors["pos"]))

    return rec_score, rec_error
