"""Training-pipeline config: defaults + YAML merge + validation.

Copy of ``spef_tpu.config.train_config``: the same key schema (MODEL / DATA /
TRAIN sections), so every experiment YAML of the JAX package loads unmodified.
"""

from __future__ import annotations

import os
from typing import Optional

from spef_tpu_torch.config.node import CfgNode

__all__ = ["default_config", "load_config", "save_config", "discover_experiments"]


def default_config() -> CfgNode:
    c = CfgNode()

    c.MODEL = CfgNode()
    c.MODEL.PRETRAINED_PATH = ""
    # torchvision-format MobileNetV2 ImageNet checkpoint (.npz or torch
    # state_dict) to ingest into the backbone (`model.py:268-277` analogue).
    c.MODEL.PRETRAINED_BACKBONE = ""
    c.MODEL.MANUAL_COPY = True
    c.MODEL.QUANTIZATION = False

    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = "mobilenet_v2"
    c.MODEL.BACKBONE.RESIDUAL = True

    c.MODEL.HEAD = CfgNode()
    c.MODEL.HEAD.NAME = "ursonet"
    c.MODEL.HEAD.ORI = "classification"
    c.MODEL.HEAD.POS = "regression"
    c.MODEL.HEAD.N_ORI_BINS_PER_DIM = 12
    c.MODEL.HEAD.N_POS_BINS_PER_DIM = 10
    c.MODEL.HEAD.ORI_DELETE_UNUSED_BINS = False
    c.MODEL.HEAD.KEYPOINTS_PATH = ""  # kept for schema compat; points are built-in

    c.DATA = CfgNode()
    c.DATA.BATCH_SIZE = 8
    c.DATA.PATH = "../datasets/speed"
    c.DATA.IMG_SIZE = (240, 384)
    c.DATA.ORI_SMOOTH_FACTOR = 3
    c.DATA.POS_SMOOTH_FACTOR = 100
    c.DATA.ROT_AUGMENT = True
    c.DATA.OTHER_AUGMENT = True
    c.DATA.SHUFFLE = True

    c.TRAIN = CfgNode()
    c.TRAIN.N_EPOCH = 2
    c.TRAIN.LR = 0.01
    c.TRAIN.OPTIM = "SGD"
    c.TRAIN.MOMENTUM = 0.9
    c.TRAIN.DECAY = 0.0
    c.TRAIN.SCHEDULER = "MultiStepLR"
    c.TRAIN.MILESTONES = (7, 20)
    c.TRAIN.GAMMA = 0.1
    c.TRAIN.CLIP_BATCHNORM = False
    # Validation quantity best-model selection runs on: "loss" (reference
    # parity) or "esa" (the deployment metric — use for keypoints runs,
    # where the coordinate loss is a poor proxy for decoded pose score).
    c.TRAIN.BEST_METRIC = "loss"

    return c


def load_config(path: Optional[str] = None) -> CfgNode:
    """Defaults merged with an optional YAML file, then validated
    (reference `train/config.py:46-60`)."""
    cfg = default_config()
    if path is not None:
        assert os.path.isfile(path), f"File {path} does not exist"
        cfg.merge_from_file(path)
    assert cfg.MODEL.HEAD.ORI in ("classification", "regression", "keypoints")
    assert cfg.MODEL.HEAD.POS in ("classification", "regression", "keypoints")
    if "keypoints" in (cfg.MODEL.HEAD.ORI, cfg.MODEL.HEAD.POS):
        assert cfg.MODEL.HEAD.ORI == cfg.MODEL.HEAD.POS == "keypoints", (
            "Both ORI and POS must be 'keypoints' if one is 'keypoints'"
        )
    return cfg


def save_config(cfg: CfgNode, path: str) -> None:
    assert os.path.exists(os.path.dirname(path)), f"Path {path} does not exist"
    with open(path, "w") as f:
        cfg.dump(stream=f)


def discover_experiments(folder: str) -> dict:
    """Find ``exp_*`` experiment configs in a folder.

    Mirrors the reference convention (`train.py:32-51`): a plain
    ``exp_*.yaml`` is a float experiment; an ``exp_*/`` directory holding a
    YAML + ``bit_width.json`` is a quantized experiment.  Returns
    {exp_name: {'config': yaml_path, 'bit_width': json_path | None}}.
    """
    out = {}
    for entry in sorted(os.listdir(folder)):
        full = os.path.join(folder, entry)
        if not entry.startswith("exp_"):
            continue
        if os.path.isfile(full) and entry.endswith((".yaml", ".yml")):
            out[os.path.splitext(entry)[0]] = {"config": full, "bit_width": None}
        elif os.path.isdir(full):
            yamls = [f for f in sorted(os.listdir(full)) if f.endswith((".yaml", ".yml"))]
            bws = [f for f in os.listdir(full) if f == "bit_width.json"]
            if yamls:
                out[entry] = {
                    "config": os.path.join(full, yamls[0]),
                    "bit_width": os.path.join(full, bws[0]) if bws else None,
                }
    return out
