"""Export CLI: package a trained experiment as a deployment artifact.

Counterpart of ``spef_tpu.apps.export``: the full predict pipeline
(preprocess -> network -> activation -> decode) traced by ``torch.export``
into a ``.spef`` file (:mod:`spef_tpu_torch.deploy`), which
``python -m spef_tpu_torch.apps.serve --artifact`` and the engine's
``exported`` variant load without the model code.

Usage:
    # float (or QAT) experiment -> an artifact for the card
    python -m spef_tpu_torch.apps.export --experiment experiments/train_synth/exp_dspeed_synth \\
        --out exp.spef [--batch 64] [--device cuda]

    # an int8 build (a directory with int8_graph.pkl): add --int8
    python -m spef_tpu_torch.apps.export --experiment <build dir> --int8 \\
        --out exp_int8.spef [--weight-only]

Variants (``meta.json``'s ``variant``): ``float``; ``qat``, the fake-quant
network of an experiment with ``model/bit_width.json``; ``int8``, the
converted graph's readable executor (``quant/int8_model.py::
build_int8_forward``, the one JAX exports); ``weight_only``
(``build_weight_only_forward``).  ``--device`` takes the place of JAX's
``--platforms``: the artifact serves on that device (``deploy.load_exported``
moves it to another).  The hand-kernel executors (``layer``, ``fused``,
``carry``) cannot be exported yet (ROADMAP §A, item 10).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> dict:
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.data.camera import SPEED_CAMERA, load_camera
    from spef_tpu_torch.deploy import export_predict
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.bitwidth import experiment_model_names

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", required=True, help="trained experiment dir")
    parser.add_argument("--out", default=None, help="output .spef path "
                        "(default: <experiment>/model.spef)")
    parser.add_argument("--batch", type=int, default=64,
                        help="static serving window (requests are padded)")
    parser.add_argument("--int8", action="store_true",
                        help="export the converted int8 executor from the experiment's "
                             "int8_graph.pkl instead of the float model")
    parser.add_argument("--weight-only", action="store_true",
                        help="with --int8: export the weight-only forward (bf16 activations, "
                             "integer weight grids)")
    parser.add_argument("--device", default="cuda",
                        help="the device the artifact is traced on and serves on")
    args = parser.parse_args(argv)
    if args.weight_only and not args.int8:
        parser.error("--weight-only needs --int8")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to export for the CPU")

    cfg = load_config(os.path.join(args.experiment, "config.yaml"))
    camera = load_camera(cfg.DATA.PATH) if os.path.exists(cfg.DATA.PATH) else SPEED_CAMERA
    spe_utils = SPEUtils.from_config(cfg, camera, device=args.device)
    img_size = tuple(cfg.DATA.IMG_SIZE)

    if args.int8:
        from spef_tpu_torch.quant.int8_graph import load_int8_graph
        from spef_tpu_torch.quant.int8_model import (build_int8_forward,
                                                     build_weight_only_forward)

        graph = load_int8_graph(os.path.join(args.experiment, "int8_graph.pkl"))
        build, variant = ((build_weight_only_forward, "weight_only") if args.weight_only
                          else (build_int8_forward, "int8"))
        model, forward_fn = None, build(graph, device=args.device)
    else:
        # A QAT checkpoint (model/bit_width.json) belongs to the _q models,
        # loaded as apps.serve loads them.
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
            img_size=img_size,
            device=args.device,
        )
        forward_fn, variant = None, "float" if bit_width is None else "qat"
    predict = build_predict_fn(model, spe_utils, forward_fn=forward_fn)

    out = args.out or os.path.join(args.experiment, "model.spef")
    meta = export_predict(predict, args.batch, img_size, out, device=args.device,
                          extra_meta={"experiment": os.path.abspath(args.experiment),
                                      "variant": variant})
    size_mb = os.path.getsize(out) / 1e6
    print(f"Exported {variant} predict pipeline -> {out} "
          f"({size_mb:.1f} MB, platforms={meta['platforms']}, "
          f"window={meta['batch']}x{meta['img_size']})")
    return meta


if __name__ == "__main__":
    main()
