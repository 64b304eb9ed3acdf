"""Evaluation CLI — one model on a dataset's eval splits, on one GPU.

Counterpart of ``spef_tpu.apps.eval``: loads a trained experiment (float
checkpoint, or a QAT one: ``model/bit_width.json`` beside the weights
selects the quantized ``_q`` models), evaluates it on the dataset's eval
splits, prints one line a split and writes ``eval_score_error.json`` with
its CSVs into the experiment directory.

Usage:
    python -m spef_tpu_torch.apps.eval --experiment experiments/train_synth/exp_dspeed_synth \\
        [--data /path/to/dspeed/still] [--batch-size 32] [--device cuda] \\
        [--ransac] [--border-gate 0.02] [--crop-refine FINE_EXP]

It runs on the card; ``--device cpu`` runs it on the CPU.
``--cache-dataset`` reads the splits through the decoded-split cache.  A
keypoints-mode experiment decodes by EPnP, by RANSAC with ``--ransac``,
with the border gate of ``--border-gate``; ``--crop-refine FINE_EXP``
evaluates the two-pass engine (this experiment the coarse pass, FINE_EXP
the crop-trained fine pass).  The scores go to ``eval_score_error`` with
``_ransac``, ``_gated`` and ``_croprefine`` added to the name by those flags.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

__all__ = ["main", "parse_args"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", required=True, help="trained experiment dir")
    parser.add_argument("--data", default=None, help="dataset path override")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=1001)
    parser.add_argument("--cache-dataset", action="store_true",
                        help="serve the splits from the decoded-split cache (a memmapped "
                             "sidecar file beside the images, written on the first run)")
    parser.add_argument("--ransac", action="store_true",
                        help="keypoints mode: decode by the batched RANSAC PnP solver "
                             "instead of plain EPnP")
    parser.add_argument("--border-gate", type=float, default=None,
                        help="keypoints mode: zero-weight predictions within this normalized "
                             "margin of the frame border in the PnP solve")
    parser.add_argument("--crop-refine", default=None, metavar="FINE_EXP",
                        help="keypoints mode: evaluate the two-pass crop-refine engine, this "
                             "experiment the coarse pass and FINE_EXP the crop-trained fine pass")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Evaluate; returns ``(rec_score, rec_error)`` as ``save_score_error`` writes them."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to evaluate on the CPU")

    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import load_dataset
    from spef_tpu_torch.engine import SPECropRefine, SPETorch, load_experiment_model
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.bitwidth import experiment_model_names
    from spef_tpu_torch.train.trainer import evaluation
    from spef_tpu_torch.utils.experiment import save_score_error, set_seed

    set_seed(args.seed)
    cfg = load_config(os.path.join(args.experiment, "config.yaml"))
    data_path = args.data or cfg.DATA.PATH
    spe_utils = SPEUtils.from_config(cfg, load_camera(data_path), device=args.device,
                                     keypoints_ransac=args.ransac,
                                     keypoints_border_gate=args.border_gate)
    data, split = load_dataset(data_path, args.batch_size, tuple(cfg.DATA.IMG_SIZE),
                               cache=args.cache_dataset, device=args.device)
    print(f"Decoder: {next(iter(data.values())).decoder}")

    # A QAT checkpoint (model/bit_width.json) belongs to the quantized
    # models: the configured names map to their _q forms.
    backbone_name, head_name, bit_width = experiment_model_names(
        args.experiment, cfg.MODEL.BACKBONE.NAME, cfg.MODEL.HEAD.NAME)
    model = import_model(
        backbone_name=backbone_name,
        head_name=head_name,
        params_path=os.path.join(args.experiment, "model", "parameters.msgpack"),
        bit_width=bit_width,
        residual=cfg.MODEL.BACKBONE.RESIDUAL,
        quantization=cfg.MODEL.QUANTIZATION or bit_width is not None,
        ori_mode=cfg.MODEL.HEAD.ORI,
        n_ori_bins=spe_utils.orientation.n_bins,
        pos_mode=cfg.MODEL.HEAD.POS,
        n_pos_bins=spe_utils.position.n_bins,
        img_size=tuple(cfg.DATA.IMG_SIZE),
        device=args.device,
    )
    if args.crop_refine:
        # Crops at the fine model's trained resolution.
        fine_cfg = load_config(os.path.join(args.crop_refine, "config.yaml"))
        engine = SPECropRefine(model, load_experiment_model(args.crop_refine, args.device),
                               spe_utils, crop_hw=tuple(fine_cfg.DATA.IMG_SIZE),
                               device=args.device)
    else:
        engine = SPETorch(model, spe_utils, device=args.device)
    rec_score, rec_error = evaluation(engine, data, spe_utils, split["eval"])

    for phase in split["eval"]:
        print(
            f"[{phase}] esa={rec_score[phase]['esa'][0]:.4f} "
            f"ori_err={rec_error[phase]['ori'][0]:.2f}deg (+/-{rec_error[phase]['ori_std'][0]:.2f}) "
            f"pos_err={rec_error[phase]['pos'][0]:.3f}m (+/-{rec_error[phase]['pos_std'][0]:.3f})"
        )
    # The RANSAC / gated / two-pass decodes get sidecars of their own.
    name = "eval_score_error_ransac" if args.ransac else "eval_score_error"
    if args.border_gate is not None:
        name += "_gated"
    if args.crop_refine:
        name += "_croprefine"
    save_score_error(args.experiment, rec_score, rec_error, name=name)
    return rec_score, rec_error


if __name__ == "__main__":
    main()
