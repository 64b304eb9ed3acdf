"""Deployment CLI — load an experiment and serve pose inference on every GPU.

Counterpart of ``spef_tpu.apps.serve``: loads a trained experiment (float
checkpoint, or a QAT one: ``model/bit_width.json`` beside the weights
selects the quantized ``_q`` models), optionally with a converted
``int8_graph.pkl``, or an exported ``.spef`` artifact, builds the serving
program (``serving.PoseServer``: a padded window, pinned host staging on
``cuda``) and either runs a throughput / latency self-test or serves the
frames of a directory.

``--device cuda`` serves on every visible card, as JAX's serves on every
local chip: one replica of the served forward a card (its own model or
packed int8 weights), each request's window split over them by rows
(``parallel.mesh.make_local_mesh``; the window must divide over the
cards), the decode run once on the first card over the gathered window.  ``--device cuda:K`` serves on card K alone, ``--device cpu`` on one
CPU replica.  An ``--artifact`` runs on one device, as JAX's.

Usage:
    python -m spef_tpu_torch.apps.serve --experiment experiments/train_synth/exp_dspeed_synth \\
        [--int8-graph spef_tpu_torch/assets/flagship_boundary_int8_graph.pkl] \\
        [--int8-executor layer|fused|carry|weight-only] [--int8-backend cuda|plain] \\
        [--batch 256] [--selftest-frames 2048] [--frames-dir path/] [--device cuda]
    python -m spef_tpu_torch.apps.serve --artifact model.spef \\
        [--selftest-frames 2048] [--frames-dir path/] [--device cuda]

An ``--artifact`` (``.spef`` from ``apps/export.py``) serves the exported
program itself: no experiment directory, model code or weight files; its
window is the exported batch, and the flags that pick a variant or a window
(``--int8-*``, the keypoints flags, ``--batch``) are refused beside it.
``--frames-dir`` serves every ``*.png`` and ``*.jpg`` of a directory
(sorted, read by ``data/dataset.py::load_images`` and resized to the
model's input: the native loader where the host can build it, else the PNG
reader, which refuses a JPEG; the decoder is printed) in requests of the
window and prints one ``name: q=[...] t=[...]`` line a frame and the
latency stats.

The int8 executors of ``--int8-graph``:

  * ``layer``: one kernel a layer (K1/K2, ``quant.int8_cuda``), the
    ``int8_pallas`` conventions;
  * ``fused``: one kernel a block (K3/K4, ``quant.int8_fused``);
  * ``carry``: the deployed int8-carry executor on K1/K2
    (``quant.int8_carry``), the engine's ``int8-carry`` variant;
  * ``weight-only``: the integer weights on bf16 activations, plain PyTorch
    convolutions (``quant.int8_model.build_weight_only_forward``), the
    engine's ``weight-only`` variant; ``--int8-backend`` does not apply.

A keypoints-mode experiment decodes by EPnP inside the served predict, by
RANSAC with ``--ransac``, with the border gate of ``--border-gate``;
``--crop-refine FINE_EXP`` serves the two-pass pipeline (``codec/crop.py``:
this experiment the coarse pass, FINE_EXP the crop-trained fine pass, crops
at the fine model's input size) with the decode inside the served predict.
The int8 graph's schema is MobileNetV2 + URSONet only, so ``--crop-refine``
takes no ``--int8-graph``: the engine's ``crop-refine-w8`` variant is the
two-pass pipeline's quantized form.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["build_server", "load_artifact", "main", "parse_args", "serve_frames_dir"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--experiment", default=None)
    parser.add_argument("--artifact", default=None,
                        help=".spef deploy artifact (apps/export.py); replaces --experiment")
    parser.add_argument("--int8-graph", default=None, help="int8_graph.pkl (numpy leaves)")
    parser.add_argument("--int8-executor", default="layer",
                        choices=["layer", "fused", "carry", "weight-only"],
                        help="layer: one kernel a layer (K1/K2); fused: one a block (K3/K4); "
                             "carry: the int8-carry executor (K1/K2); weight-only: integer "
                             "weights on bf16 activations")
    parser.add_argument("--int8-backend", default="cuda", choices=["cuda", "plain"])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--selftest-frames", type=int, default=2048)
    parser.add_argument("--frames-dir", default=None, help="serve real frames from here")
    parser.add_argument("--ransac", action="store_true",
                        help="keypoints mode: RANSAC PnP decode instead of plain EPnP")
    parser.add_argument("--border-gate", type=float, default=None,
                        help="keypoints mode: zero-weight border-saturated predictions in the "
                             "PnP decode")
    parser.add_argument("--crop-refine", default=None, metavar="FINE_EXP",
                        help="keypoints mode: serve the two-pass crop-refine pipeline, this "
                             "experiment the coarse pass and FINE_EXP the crop-trained fine pass")
    parser.add_argument("--device", default="cuda",
                        help="cuda: every visible card (one host thread dispatches every "
                             "card's forward, so an executor whose forward at a card's rows "
                             "takes the host longer than the card serves slower than on one "
                             "card; PERF.md section 6 lists which); cuda:K: card K alone; cpu")
    args = parser.parse_args(argv)
    if bool(args.experiment) == bool(args.artifact):
        parser.error("exactly one of --experiment / --artifact is required")
    if args.artifact:
        # The artifact fixes its variant and window: these would be ignored.
        given = [f"--{dest.replace('_', '-')}" for dest in (
            "int8_graph", "int8_executor", "int8_backend", "batch", "ransac", "border_gate",
            "crop_refine") if getattr(args, dest) != parser.get_default(dest)]
        if given:
            parser.error(f"--artifact serves the exported program as it is (its variant and "
                         f"window): {', '.join(given)} applies only to --experiment")
    return args


def load_artifact(args: argparse.Namespace):
    """(PoseServer, img_size) serving the exported program of ``args.artifact``
    on ``args.device``, its window the exported batch."""
    from spef_tpu_torch.deploy import load_exported
    from spef_tpu_torch.serving import PoseServer

    engine = load_exported(args.artifact, device=args.device)
    img_size = tuple(engine.meta["img_size"])
    args.batch = engine.batch
    print(f"Serving AOT artifact {args.artifact} "
          f"(variant={engine.meta.get('variant')}, window={engine.batch}x{img_size})")
    return PoseServer(engine, img_shape=(*img_size, 3), max_batch=engine.batch,
                      device=engine.device), img_size


def build_server(args: argparse.Namespace):
    """(PoseServer, img_size) for the experiment named by ``args``, over the
    mesh ``args.device`` names (every visible card for ``cuda``)."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.data.camera import SPEED_CAMERA, load_camera
    from spef_tpu_torch.engine import (build_crop_refine_fn, build_predict_fn,
                                       load_experiment_model)
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.parallel.mesh import make_local_mesh
    from spef_tpu_torch.quant.bitwidth import experiment_model_names
    from spef_tpu_torch.serving import PoseServer

    cfg = load_config(os.path.join(args.experiment, "config.yaml"))
    camera = load_camera(cfg.DATA.PATH) if os.path.exists(cfg.DATA.PATH) else SPEED_CAMERA
    img_size = tuple(cfg.DATA.IMG_SIZE)
    if args.crop_refine and args.int8_graph:
        raise SystemExit("--crop-refine takes no --int8-graph: the int8 graph's schema is "
                         "MobileNetV2 + URSONet only (use the engine's crop-refine-w8 variant "
                         "for weight-only int8 of both passes)")
    mesh = make_local_mesh(args.device)
    if args.batch % mesh.size:
        raise SystemExit(f"--batch {args.batch} does not divide over the {mesh.size} devices of "
                         f"--device {args.device}: pass a --batch that does, or --device cuda:K "
                         f"for one card")
    # The decode runs on the mesh's first device, on the gathered window.
    spe_utils = SPEUtils.from_config(cfg, camera, device=mesh.devices[0],
                                     keypoints_ransac=args.ransac,
                                     keypoints_border_gate=args.border_gate)

    if args.int8_graph:
        from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward
        from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
        from spef_tpu_torch.quant.int8_fused import build_fused_forward
        from spef_tpu_torch.quant.int8_graph import load_int8_graph
        from spef_tpu_torch.quant.int8_model import build_weight_only_forward

        graph = load_int8_graph(args.int8_graph)
        if args.int8_executor == "weight-only":
            def build_forward(device):
                return build_weight_only_forward(graph, device=device)
            backend = "plain PyTorch"
        else:
            build = {"layer": build_cuda_forward, "fused": build_fused_forward,
                     "carry": build_int8_carry_forward}[args.int8_executor]

            def build_forward(device):
                return build(graph, backend=args.int8_backend, device=device)
            backend = f"{args.int8_backend} backend"
        print(f"Serving int8 graph ({args.int8_executor} executor, {backend})")
    else:
        # A QAT checkpoint (model/bit_width.json) belongs to the quantized
        # models: the configured names map to their _q forms.
        backbone_name, head_name, bit_width = experiment_model_names(
            args.experiment, cfg.MODEL.BACKBONE.NAME, cfg.MODEL.HEAD.NAME)

        def build_model(device):
            return import_model(
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
                device=device,
            )
        if bit_width is not None:
            print(f"Serving the QAT model ({backbone_name} + {head_name})")
    if args.crop_refine:
        fine_hw = tuple(load_config(os.path.join(args.crop_refine, "config.yaml")).DATA.IMG_SIZE)
        print(f"Serving the two-pass crop-refine pipeline (fine: {args.crop_refine})")

    def build_predict(device):
        """The served predict of one replica, its weights on ``device``."""
        if args.crop_refine:
            return build_crop_refine_fn(build_model(device),
                                        load_experiment_model(args.crop_refine, device),
                                        spe_utils, crop_hw=fine_hw)
        if args.int8_graph:
            return build_predict_fn(None, spe_utils, forward_fn=build_forward(device))
        return build_predict_fn(build_model(device), spe_utils)

    server = PoseServer(build_predict, img_shape=(*img_size, 3), max_batch=args.batch,
                        mesh=mesh)
    return server, img_size


def run_selftest(args: argparse.Namespace, server, img_size: Tuple[int, int]) -> float:
    """Sustained throughput on synthetic frames; returns frames/s."""
    rng = np.random.RandomState(0)
    n_batches = max(args.selftest_frames // args.batch, 1)
    frames = rng.randint(0, 256, (args.batch, *img_size, 3), np.uint8)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        server.predict(frames)
    fps = n_batches * args.batch / (time.perf_counter() - t0)
    print(f"selftest: {fps:.1f} frames/s sustained, "
          f"request latency {server.stats()['p50_ms']:.1f} ms p50")
    return fps


def serve_frames_dir(args: argparse.Namespace, server, img_size: Tuple[int, int]) -> None:
    """Every frame of ``args.frames_dir`` in requests of the window: one
    ``name: q=[...] t=[...]`` line a frame, then the latency stats."""
    from spef_tpu_torch.data.dataset import load_images, resolve_decoder

    paths = sorted(glob.glob(os.path.join(args.frames_dir, "*.png"))
                   + glob.glob(os.path.join(args.frames_dir, "*.jpg")))
    decoder = resolve_decoder("auto")
    print(f"Decoder: {decoder}")
    for start in range(0, len(paths), args.batch):
        chunk = paths[start:start + args.batch]
        frames = load_images(chunk, img_size, decoder)
        pose, _ = server.predict(frames)
        for p, q, t in zip(chunk, pose["ori"], pose["pos"]):
            print(f"{os.path.basename(p)}: q={np.round(q, 4).tolist()} "
                  f"t={np.round(t, 3).tolist()}")
    print(f"latency stats: {server.stats()}")


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to serve on the CPU")
    server, img_size = load_artifact(args) if args.artifact else build_server(args)
    print(f"Warming up (batch window {args.batch})...")
    ready_s = server.warmup()
    print(f"Ready in {ready_s:.1f}s on {server.stats()['devices']} device(s) ({server.device})")
    if args.frames_dir:
        serve_frames_dir(args, server, img_size)
    else:
        run_selftest(args, server, img_size)


if __name__ == "__main__":
    main()
