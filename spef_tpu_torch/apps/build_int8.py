"""Int8 deployment build CLI — QAT fine-tune -> convert -> evaluation ladder.

Counterpart of ``spef_tpu.apps.build_int8``, on one GPU:

  1. the QAT model (``<backbone>_q`` + ``<head>_q``) of a recipe
     (``--bit-width`` file, or ``--recipe default | boundary | w8a8``),
     loaded from ``--qat-checkpoint`` or warm-started from a float
     ``--fp32-checkpoint`` (``copy_params``);
  2. optionally its activation grids calibrated on train batches
     (``--calibrate``: ``calibrate_graph`` + ``write_scales_to_params``);
  3. optionally ``--qat-epochs`` of QAT fine-tuning through ``Trainer``, at
     ``--qat-lr`` (default ``TRAIN.LR / 10``) with milestones at 60% and 85%
     of the epochs;
  4. the int8 graph (``convert_qat_params``) and the ladder on the eval
     splits: ``qat`` (the fake-quantized model), ``int8``
     (``int8_model.build_int8_forward``) and ``weight_only``;
  5. the parity report of the QAT forward against the int8 forward on one
     batch (``predict_and_compare``), and ``config.yaml``, ``model/``
     (``parameters.msgpack`` + ``bit_width.json``), ``int8_graph.pkl``
     (numpy leaves: what ``apps.serve --int8-graph`` and the int8 executors
     read), ``parity_report.json`` and the ``ladder`` scores in
     ``<out>/<config name>``.

Usage:
    python -m spef_tpu_torch.apps.build_int8 --config exp.yaml --out experiments/build \\
        [--recipe boundary] [--fp32-checkpoint path/parameters.msgpack] [--qat-epochs 2] \\
        [--calibrate percentile] [--device-data] [--device cuda]

It runs on the card; ``--device cpu`` runs it on the CPU.  ``--autotune``
times the fused executor's kernels and their library-op forms on the built
graph at the config's image size and batch (``quant.autotune.tune_graph``),
stores the winners in the port's tuning table
(``build/tuning/fused_tuning.json``) and writes them to
``autotune_report.json`` in the output folder.  Under ``--device cpu`` it
times the plain versions on the host's clock, and its table is
``fused_tuning_cpu.json`` in the output folder, never the default one.  No
forward reads a table unless its caller names it
(``quant.int8_fused.build_fused_forward(tuning=...)``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import List, Optional

import torch

__all__ = ["main"]


def _q_name(name: str) -> str:
    """Any float model name (and its ``_pytorch`` / ``_brevitas`` aliases)
    -> its ``_q`` counterpart."""
    name = name.replace("_pytorch", "").replace("_brevitas", "")
    return name if name.endswith("_q") else name + "_q"


def main(argv: Optional[List[str]] = None) -> dict:
    """Build; returns the ladder's scores, the parity report and the output
    folder."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--out", default="experiments/build")
    parser.add_argument("--bit-width", default=None, help="bit_width.json path")
    parser.add_argument("--fp32-checkpoint", default=None)
    parser.add_argument("--qat-checkpoint", default=None)
    parser.add_argument("--qat-epochs", type=int, default=0)
    parser.add_argument("--recipe", default="default", choices=("default", "boundary", "w8a8"),
                        help="bit-width family when no --bit-width file is given: 'boundary' = "
                             "int8 block boundaries with real-valued interiors; 'w8a8' = "
                             "uniform 8-bit weights and activations")
    parser.add_argument("--qat-lr", type=float, default=None,
                        help="learning rate of the QAT fine-tune (default: TRAIN.LR / 10)")
    parser.add_argument("--cache-dataset", action="store_true",
                        help="serve the QAT epochs from the decoded-split cache")
    parser.add_argument("--device-data", action="store_true",
                        help="keep the decoded splits on the device (see apps.train)")
    parser.add_argument("--calibrate", default=None,
                        choices=("absmax", "percentile", "mse", "entropy"),
                        help="calibrate the activation grids on train batches before the QAT "
                             "fine-tune")
    parser.add_argument("--calibration-batches", type=int, default=256)
    parser.add_argument("--autotune", action="store_true",
                        help="time the fused kernels' tiles and library forms on the built "
                             "graph; store the winners in the tuning table")
    parser.add_argument("--percentile", type=float, default=99.99)
    parser.add_argument("--seed", type=int, default=1001)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to build on the CPU")

    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import load_config, save_config
    from spef_tpu_torch.data.camera import load_camera
    from spef_tpu_torch.data.dataset import load_dataset
    from spef_tpu_torch.engine import SPETorch
    from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
    from spef_tpu_torch.models.wrapper import (
        flax_variables, import_model, load_flax_variables, save_model)
    from spef_tpu_torch.quant.bitwidth import (
        boundary_bit_width, default_bit_width, load_bit_width)
    from spef_tpu_torch.quant.convert import convert_qat_params
    from spef_tpu_torch.quant.int8_model import build_int8_forward, build_weight_only_forward
    from spef_tpu_torch.quant.parity import predict_and_compare
    from spef_tpu_torch.quant.warmstart import copy_params
    from spef_tpu_torch.train.loss import SPELoss
    from spef_tpu_torch.train.optimizer import import_optimizer
    from spef_tpu_torch.train.step import create_train_state
    from spef_tpu_torch.train.trainer import Trainer, evaluation
    from spef_tpu_torch.utils.experiment import prepare_directories, save_score_error, set_seed

    device = args.device
    set_seed(args.seed)
    cfg = load_config(args.config)
    name = os.path.splitext(os.path.basename(args.config))[0]
    save_folder = prepare_directories(os.path.join(args.out, name))
    print(f"Build output: {save_folder}")

    camera = load_camera(cfg.DATA.PATH)
    spe_utils = SPEUtils.from_config(cfg, camera, device=device)
    data, split = load_dataset(cfg.DATA.PATH, cfg.DATA.BATCH_SIZE, tuple(cfg.DATA.IMG_SIZE),
                               shuffle=cfg.DATA.SHUFFLE, seed=args.seed,
                               cache="device" if args.device_data else args.cache_dataset,
                               device=device)

    bit_width = load_bit_width(args.bit_width) if args.bit_width else None
    if bit_width is None and args.recipe == "boundary":
        # int8 between blocks, real-valued interiors.
        bit_width = boundary_bit_width()
    elif bit_width is None and args.recipe == "w8a8":
        bit_width = default_bit_width(w=8, a=8, shared=8)

    qat_model = import_model(
        backbone_name=_q_name(cfg.MODEL.BACKBONE.NAME),
        head_name=_q_name(cfg.MODEL.HEAD.NAME),
        params_path=args.qat_checkpoint,
        bit_width=bit_width,
        residual=cfg.MODEL.BACKBONE.RESIDUAL,
        quantization=True,
        ori_mode=cfg.MODEL.HEAD.ORI,
        n_ori_bins=spe_utils.orientation.n_bins,
        pos_mode=cfg.MODEL.HEAD.POS,
        n_pos_bins=spe_utils.position.n_bins,
        seed=args.seed,
        device=device,
    )
    if args.fp32_checkpoint and not args.qat_checkpoint:
        load_flax_variables(qat_model, copy_params(read_flax_msgpack(args.fp32_checkpoint),
                                                   flax_variables(qat_model)))
        print("Warm-started QAT model from FP32 checkpoint")

    if args.calibrate:
        # PTQ: the grids chosen from observed float activations, written
        # back onto the QAT parameters so that the fine-tune and the
        # conversion below start from them.
        from spef_tpu_torch.quant.calibrate import calibrate_graph, write_scales_to_params

        _, amaxes = calibrate_graph(
            convert_qat_params(qat_model, bit_width), (b["images"] for b in data["train"]),
            method=args.calibrate, percentile=args.percentile,
            max_batches=args.calibration_batches, device=device)
        load_flax_variables(qat_model, write_scales_to_params(flax_variables(qat_model), amaxes))
        print(f"Calibrated {len(amaxes)} activation grids ({args.calibrate})")

    spe_loss = SPELoss(cfg.MODEL.HEAD.ORI, cfg.MODEL.HEAD.POS, beta=1, norm_distance=True)
    if args.qat_epochs > 0:
        # A warm-started QAT model sits next to the float optimum: fine-tune
        # at LR/10, decayed at 60% and 85% of the epochs.
        qat_lr = args.qat_lr if args.qat_lr is not None else cfg.TRAIN.LR / 10.0
        milestones = (max(1, int(args.qat_epochs * 0.6)), max(2, int(args.qat_epochs * 0.85)))
        optimizer, scheduler = import_optimizer(
            qat_model.parameters(), qat_lr, cfg.TRAIN.OPTIM, cfg.TRAIN.MOMENTUM,
            cfg.TRAIN.DECAY, "MultiStepLR", milestones, cfg.TRAIN.GAMMA)
        trainer = Trainer(spe_utils, spe_loss, camera, rot_augment=cfg.DATA.ROT_AUGMENT,
                          other_augment=cfg.DATA.OTHER_AUGMENT,
                          clip_batchnorm=cfg.TRAIN.CLIP_BATCHNORM, seed=args.seed,
                          device=device)
        trainer.fit(create_train_state(qat_model, optimizer, scheduler), data, args.qat_epochs,
                    scheduler, split["train"])
    qat_model.eval()

    if args.autotune:
        from spef_tpu_torch.quant.autotune import tune_graph

        table = tune_graph(convert_qat_params(qat_model, bit_width), tuple(cfg.DATA.IMG_SIZE),
                           batch=cfg.DATA.BATCH_SIZE, device=device,
                           path=(None if torch.device(device).type == "cuda"
                                 else os.path.join(save_folder, "fused_tuning_cpu.json")))
        with open(os.path.join(save_folder, "autotune_report.json"), "w") as f:
            json.dump(table, f, indent=2, sort_keys=True)
        print(f"Autotune winners persisted ({len(table)} shapes)")

    ladder, errors = {}, {}
    ladder["qat"], errors["qat"] = evaluation(SPETorch(qat_model, spe_utils, device=device),
                                              data, spe_utils, split["eval"])
    graph = convert_qat_params(qat_model, bit_width)
    int8_fwd = build_int8_forward(graph, device=device)
    ladder["int8"], errors["int8"] = evaluation(
        SPETorch(qat_model, spe_utils, forward_fn=int8_fwd, device=device), data, spe_utils,
        split["eval"])
    ladder["weight_only"], errors["weight_only"] = evaluation(
        SPETorch(qat_model, spe_utils, forward_fn=build_weight_only_forward(graph, device=device),
                 device=device), data, spe_utils, split["eval"])

    batch = next(iter(data[split["eval"][0]]))
    images = batch["images"]
    images = images if torch.is_tensor(images) else torch.from_numpy(images)
    report = predict_and_compare(qat_model, int8_fwd, images.to(device), spe_utils)
    print("parity:", json.dumps(report, indent=2))
    for stage, score in ladder.items():
        for phase in split["eval"]:
            print(f"[{stage}/{phase}] esa={score[phase]['esa'][0]:.4f}")

    save_config(cfg, os.path.join(save_folder, "config.yaml"))
    # The recipe the model was built with (its backbone's default if none).
    save_model(os.path.join(save_folder, "model"), qat_model,
               bit_width or qat_model.bit_width or qat_model.backbone.bit_width)
    with open(os.path.join(save_folder, "int8_graph.pkl"), "wb") as f:
        pickle.dump(graph, f)
    with open(os.path.join(save_folder, "parity_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    save_score_error(save_folder, ladder, errors, name="ladder")
    print(f"Saved int8 graph + parity report to {save_folder}")
    return {"ladder": ladder, "errors": errors, "parity": report, "folder": save_folder}


if __name__ == "__main__":
    main()
