"""Experiment-directory management, seeding, and score persistence.

Counterpart of ``spef_tpu.utils.experiment``: ``prepare_directories``
(collision handling), ``set_seed`` and ``save_score_error`` /
``load_score_error``.  The scores go to ``{name}.json`` and one
``{name}_{sheet}.csv`` a sheet, with the header and values the JAX package
writes through pandas; the port writes them with the ``csv`` module (no
pandas) and writes no ``.xlsx``.
"""

from __future__ import annotations

import csv
import json
import os
import random
import shutil
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["prepare_directories", "set_seed", "save_score_error", "load_score_error"]


def prepare_directories(path: str, on_collision: str = "version") -> str:
    """Create an experiment directory.

    on_collision: 'version' -> append _v2, _v3...; 'delete' -> wipe and
    recreate; 'ask' -> interactive prompt; 'reuse' -> keep as is.
    """
    if os.path.exists(path) and os.listdir(path):
        if on_collision == "ask":
            ans = input(f"{path} exists. Delete (d), version (v), or reuse (r)? ")
            on_collision = {"d": "delete", "v": "version", "r": "reuse"}.get(ans.strip(), "version")
        if on_collision == "delete":
            shutil.rmtree(path)
        elif on_collision == "version":
            base = path.rstrip("/")
            i = 2
            while os.path.exists(f"{base}_v{i}") and os.listdir(f"{base}_v{i}"):
                i += 1
            path = f"{base}_v{i}"
    os.makedirs(path, exist_ok=True)
    return path


def set_seed(seed: int = 1001):
    """Seed Python's, numpy's and PyTorch's host generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def _columns(data: Dict) -> Dict[str, list]:
    """One sheet's columns: ``{split}/{metric}`` for nested dicts, the split
    itself otherwise; shorter columns padded with empty cells."""
    flat = {}
    for split, metrics in data.items():
        if isinstance(metrics, dict):
            for k, v in metrics.items():
                flat[f"{split}/{k}"] = v if isinstance(v, list) else [v]
        else:
            flat[split] = metrics if isinstance(metrics, list) else [metrics]
    if flat:
        maxlen = max(len(v) for v in flat.values())
        flat = {k: v + [None] * (maxlen - len(v)) for k, v in flat.items()}
    return flat


def save_score_error(folder: str, scores: Dict, errors: Dict, latency: Optional[Dict] = None,
                     name: str = "score_error") -> str:
    """Persist evaluation scores / errors as JSON plus one CSV a sheet."""
    os.makedirs(folder, exist_ok=True)
    payload = {"scores": scores, "errors": errors}
    if latency is not None:
        payload["latency"] = latency
    path = os.path.join(folder, f"{name}.json")
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    for sheet, data in payload.items():
        cols = _columns(data)
        if not cols:
            continue
        with open(os.path.join(folder, f"{name}_{sheet}.csv"), "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(cols)
            writer.writerows(zip(*cols.values()))
    return path


def load_score_error(folder: str, name: str = "score_error") -> Dict:
    with open(os.path.join(folder, f"{name}.json")) as f:
        return json.load(f)
