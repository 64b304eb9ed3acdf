"""Keypoint serving traffic: the stream driver's closed loop of windows
through ``serving.serve_stream``, over a keypoint model's
``engine.build_predict_fn`` (keypoints mode: the uint8 normalization, the
forward and the keypoint logits in ``launch``; the sigmoid and the batched
EPnP decode in ``finish``).

The window loop, the pool, the spans and the end-to-end numbers are
``drivers/stream.py``'s own: its ``run`` is called with this module's
engine and comparison in place of its ``build_predict`` and ``compare``
(the same code object over other globals).  The mix's keys are the stream
driver's; its ``sample_pdf_windows`` must exceed the windows of any run, so
that every served window is kept whole and compared.

The model: ``import_model(<backbone>, <head>)`` given the plain reference's
leaves, drawn from the seed (``reference/hrnet.py::init_leaves``), their
BatchNorm running statistics and final-layer scale set by its calibration
(``calibrate``) over ``calibration_frames`` frames drawn from the seed
beside the pool's, and loaded strictly (``load``): the program's own init
takes no part, and a parameter it names or shapes otherwise fails the run.

The comparison, over every frame of every served window, against the
reference's float32 forward of the same pool window: ``kp_px``, the widest
gap of a keypoint coordinate in pixels of the frame (the normalized
coordinate times its width or height), and ``kp_logit``, the widest gap of
the 24 keypoint logits (the logit of the served sigmoid, in float64).  The
EPnP poses are decoded in the timed path and not compared: seeded weights
put keypoints where the solve is ill-posed.
"""

from __future__ import annotations

import types
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench import frames
from perfbench.drivers import stream
from perfbench.harness import Run

KEYS = stream.KEYS


def _import(ctx, device):
    from spef_tpu_torch.models.wrapper import import_model

    cfg = ctx.cfg
    return import_model(cfg["backbone"], cfg["head"], ori_mode=cfg["ori_mode"],
                        pos_mode=cfg["pos_mode"], n_keypoint_outputs=cfg["n_keypoint_outputs"],
                        img_size=tuple(cfg["img_size"]), device=device)


def _img_size(ctx):
    return tuple(ctx.size("img_size", ctx.cfg["img_size"]))


def seeded_leaves(ctx) -> Dict[str, torch.Tensor]:
    """The reference's float32 leaves from the seed on the device,
    calibrated there (``reference/hrnet.py::calibrate``) over frames drawn
    from ``seed + 1``."""
    from perfbench.reference import hrnet

    dev = ctx.device
    leaves = {k: v.to(dev) for k, v in hrnet.init_leaves(ctx.cfg, ctx.seed).items()}
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    n = ctx.size("calibration_frames", ctx.cfg["calibration_frames"])
    images, _, _ = frames.make_frames(gen, n, ctx.cfg["camera"], _img_size(ctx),
                                      ctx.traffic["frames"])
    return hrnet.calibrate(leaves, images.float() / 255.0, ctx.cfg)


def build_predict(ctx) -> Callable:
    """The port's keypoints predict function on the reference's seeded,
    calibrated leaves."""
    from perfbench.reference import hrnet
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import Camera
    from spef_tpu_torch.engine import build_predict_fn

    cfg, dev = ctx.cfg, ctx.device
    if cfg["engine"] != "float":
        raise ValueError(f"unknown engine {cfg['engine']!r}")
    model = hrnet.load(_import(ctx, dev), seeded_leaves(ctx))
    utils = SPEUtils.create(Camera(**cfg["camera"]), ori_mode=cfg["ori_mode"],
                            pos_mode=cfg["pos_mode"], keypoints_ransac=cfg["ransac"], device=dev)
    return build_predict_fn(model, utils)


def reference_logits(ctx, pool: List[np.ndarray], used, lowp=None, leaves=None
                     ) -> Dict[int, np.ndarray]:
    """The reference's keypoint logits (float32) of each used pool window,
    in blocks of rows, on ``leaves`` (the seeded ones by default); with
    ``lowp`` the control's."""
    from perfbench.reference import hrnet

    dev = ctx.device
    leaves = seeded_leaves(ctx) if leaves is None else leaves
    block = ctx.size("ref_block", ctx.traffic["ref_block"])
    out = {}
    with torch.no_grad(), hrnet.exact_f32():
        for i in sorted(set(used)):
            parts = []
            for r in range(0, pool[i].shape[0], block):
                x = torch.from_numpy(pool[i][r:r + block]).to(dev).float() / 255.0
                parts.append(hrnet.forward(leaves, x, ctx.cfg, lowp=lowp)[1].cpu().numpy())
            out[i] = np.concatenate(parts)
    return out


def keypoint_gaps(keypoints: np.ndarray, ref_logits: np.ndarray, img_size) -> Dict[str, float]:
    """Widest gap in pixels of the frame and of the logits, between
    normalized keypoints (B, 2K) and the reference's logits."""
    kp = keypoints.astype(np.float64)
    logits = np.log(kp / (1.0 - kp))
    ref = 1.0 / (1.0 + np.exp(-ref_logits.astype(np.float64)))
    scale = np.tile([img_size[1], img_size[0]], kp.shape[1] // 2)
    return {"kp_px": float(np.max(np.abs(kp - ref) * scale)),
            "kp_logit": float(np.max(np.abs(logits - ref_logits)))}


def compare(ctx, pool, served, poses, sample) -> Dict[str, float]:
    """Every frame of every served window against the reference, by name;
    none where no window was served or a served window was not kept."""
    if not poses or len(sample) != len(poses):
        return {}
    ref = reference_logits(ctx, pool, served[:len(poses)])
    worst: Dict[str, float] = {}
    for out in sample.values():
        gaps = keypoint_gaps(out["keypoints"], ref[served[out["window"]]], _img_size(ctx))
        for name, v in gaps.items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst


# stream.run's window loop over this driver's engine and comparison.
_loop = types.FunctionType(stream.run.__code__,
                           dict(vars(stream), build_predict=build_predict, compare=compare),
                           "run")


def run(ctx) -> Run:
    return _loop(ctx)


def control_readings(ctx) -> Dict[str, float]:
    """The control (the reference in ``control_lowp``) against the
    reference, over every frame of the pool, named as ``compare`` names."""
    pool = stream.make_pool(ctx)
    used = list(range(len(pool)))
    leaves = seeded_leaves(ctx)
    ref = reference_logits(ctx, pool, used, leaves=leaves)
    low = reference_logits(ctx, pool, used, ctx.cfg["control_lowp"], leaves)
    worst: Dict[str, float] = {}
    for i in used:
        kp = 1.0 / (1.0 + np.exp(-low[i].astype(np.float64)))
        for name, v in keypoint_gaps(kp, ref[i], _img_size(ctx)).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst
