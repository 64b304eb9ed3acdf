"""Pose viewer: annotated frames and an ``index.html`` gallery, on one GPU.

Counterpart of ``spef_tpu.apps.viewer``: each frame of a split goes through
the streaming ``temporal.inference.Inference`` on an engine variant
(``engine.build_engine_variant``), gets the true / predicted / temporal
overlays (axis arrows, wireframe keypoints, bboxes;
``utils.visualize.VisualizePose``) and is written as PNG
(``data/png.py::write_png``), with an ``index.html`` that shows every frame
with its ESA, errors and latency.

Usage:
    python -m spef_tpu_torch.apps.viewer --experiment experiments/train/exp_x \\
        --data /path/to/dataset [--split valid] [--n 16] [--video] \\
        [--engine float|weight-only|int8-carry|exported] [--out DIR] [--device cuda]

It runs on the card; ``--device cpu`` runs it on the CPU.  ``main`` returns
one record a frame (file name, the frame as read, the three poses drawn, the
metrics).
"""

from __future__ import annotations

import argparse
import html
import os
from typing import List, Optional

import numpy as np
import torch

__all__ = ["main", "write_index"]


def write_index(out_dir: str, phase: str, rows) -> None:
    """``index.html``: one cell a frame, ``(fname, esa, ori_e, pos_e, lat)``."""
    with open(os.path.join(out_dir, "index.html"), "w") as f:
        f.write("<html><body><h2>spef_tpu pose viewer — %s</h2>\n" % html.escape(phase))
        f.write("<p>red/RGB = truth, green/MYC = prediction, blue/RCA = temporal</p>\n")
        for fname, esa, ori_e, pos_e, lat in rows:
            f.write(
                f'<div style="display:inline-block;margin:4px;text-align:center">'
                f'<img src="{fname}" width="360"><br>'
                f"esa={esa:.3f} ori={ori_e:.1f}deg pos={pos_e:.2f}m lat={lat:.1f}ms</div>\n"
            )
        f.write("</body></html>\n")


def main(argv: Optional[List[str]] = None) -> List[dict]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", required=True)
    parser.add_argument("--data", default=None)
    parser.add_argument("--split", default=None, help="split/sequence name")
    parser.add_argument("--n", type=int, default=16, help="number of frames")
    parser.add_argument("--video", action="store_true", help="temporal filtering")
    parser.add_argument("--out", default=None)
    parser.add_argument("--engine", default="float",
                        choices=["float", "weight-only", "int8-carry", "exported"],
                        help="inference target: the float model, the int8 executors of the "
                             "experiment's int8_graph.pkl, or its model.spef export")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = args.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the viewer on the CPU")

    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import detect_dataset, load_dataset
    from spef_tpu_torch.data.png import write_png
    from spef_tpu_torch.engine import build_engine_variant, discover_engine_variants
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.pose.score import score_batch
    from spef_tpu_torch.quant.bitwidth import experiment_model_names
    from spef_tpu_torch.temporal.inference import Inference
    from spef_tpu_torch.utils.visualize import VisualizePose

    cfg = load_config(os.path.join(args.experiment, "config.yaml"))
    data_path = args.data or cfg.DATA.PATH
    spe_utils = SPEUtils.create(
        load_camera(data_path),
        ori_mode=cfg.MODEL.HEAD.ORI,
        n_ori_bins_per_dim=cfg.MODEL.HEAD.N_ORI_BINS_PER_DIM,
        ori_smooth_factor=cfg.DATA.ORI_SMOOTH_FACTOR,
        ori_delete_unused_bins=cfg.MODEL.HEAD.ORI_DELETE_UNUSED_BINS,
        pos_mode=cfg.MODEL.HEAD.POS,
        n_pos_bins_per_dim=cfg.MODEL.HEAD.N_POS_BINS_PER_DIM,
        pos_smooth_factor=cfg.DATA.POS_SMOOTH_FACTOR,
        use_keypoints=True,
        device=device,
    )
    data, split = load_dataset(data_path, batch_size=1, img_size=tuple(cfg.DATA.IMG_SIZE),
                               device=device)
    phase = args.split or split["eval"][0]

    available = discover_engine_variants(args.experiment)
    if args.engine not in available:
        parser.error(f"--engine {args.engine}: experiment only has {available}")
    model = None
    if args.engine != "exported":
        backbone_name, head_name, bit_width = experiment_model_names(
            args.experiment, cfg.MODEL.BACKBONE.NAME, cfg.MODEL.HEAD.NAME)
        model = import_model(
            backbone_name=backbone_name,
            head_name=head_name,
            img_size=tuple(cfg.DATA.IMG_SIZE),
            params_path=os.path.join(args.experiment, "model", "parameters.msgpack"),
            bit_width=bit_width,
            residual=cfg.MODEL.BACKBONE.RESIDUAL,
            quantization=cfg.MODEL.QUANTIZATION or bit_width is not None,
            ori_mode=cfg.MODEL.HEAD.ORI,
            n_ori_bins=spe_utils.orientation.n_bins,
            pos_mode=cfg.MODEL.HEAD.POS,
            n_pos_bins=spe_utils.position.n_bins,
            device=device,
        )
    engine = build_engine_variant(args.experiment, model, spe_utils, args.engine, device=device)
    try:
        dataset_kind = detect_dataset(data_path)
    except Exception:
        dataset_kind = None
    inference = Inference(engine, spe_utils, dataset=dataset_kind)
    viz = VisualizePose(spe_utils)
    kp = spe_utils.keypoints
    dev = spe_utils.orientation.histogram.device

    out_dir = args.out or os.path.join(args.experiment, "viewer", phase)
    os.makedirs(out_dir, exist_ok=True)

    rows, records = [], []
    for batch in data[phase]:
        if len(rows) >= args.n:
            break
        n_valid = int(batch["mask"].sum())
        for i in range(min(n_valid, args.n - len(rows))):
            image = np.asarray(batch["images"][i])  # resized uint8 RGB
            true_pose = {"ori": np.asarray(batch["ori"][i]), "pos": np.asarray(batch["pos"][i])}
            ori_t = torch.as_tensor(true_pose["ori"], device=dev)
            pos_t = torch.as_tensor(true_pose["pos"], device=dev)
            if kp is not None:
                k2d = kp.create_keypoints2d(ori_t, pos_t)
                true_pose["keypoints"] = k2d.cpu().numpy()
                true_pose["bbox"] = kp.create_bbox_from_keypoints(k2d).cpu().numpy()

            pose_still, latency_ms, pose_video = inference.predict(
                image[None], "Adaptative" if args.video else None)
            frame = viz.add_visualization(
                np.ascontiguousarray(image[..., ::-1]), true_pose=true_pose, pred_pose=pose_still,
                temp_pose=pose_video, show_true_pose=True, show_pred_pose=True,
                show_temp_pose=pose_video is not None, show_true_keypoints=True,
                show_pred_keypoints=True, show_true_bbox=True, show_pred_bbox=True,
            )
            fname = f"frame_{len(rows):05d}.png"
            write_png(os.path.join(out_dir, fname), frame)

            m = score_batch(ori_t[None], pos_t[None],
                            torch.as_tensor(pose_still["ori"], device=dev)[None],
                            torch.as_tensor(pose_still["pos"], device=dev)[None])
            row = (fname, float(m["esa_score"]), float(m["ori_error"]),
                   float(m["pos_error"]), latency_ms)
            rows.append(row)
            records.append({"filename": fname, "image": image, "true_pose": true_pose,
                            "pred_pose": pose_still, "temp_pose": pose_video,
                            "esa_score": row[1], "ori_error": row[2], "pos_error": row[3],
                            "latency_ms": latency_ms})

    write_index(out_dir, phase, rows)
    print(f"Wrote {len(rows)} annotated frames + index.html to {out_dir}")
    return records


if __name__ == "__main__":
    main()
