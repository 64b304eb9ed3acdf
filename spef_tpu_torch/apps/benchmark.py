"""Benchmark CLI: throughput / latency across engines and stages.

Counterpart of ``spef_tpu.apps.benchmark``, one sweep over the port's
execution paths, with JAX's construction (random-init ``mobilenet_v2`` +
``ursonet`` at 1232 + 1000 bins; for the int8 paths ``convert_qat_params``
of a random-init ``mobilenet_v2_q`` + ``ursonet_q`` at the default bit
widths):

  * ``float``: the bf16 model, preprocess -> decode (``build_predict_fn``);
  * ``forward``: backbone + head only (no decode), for stage attribution;
  * ``int8_cuda``: the layer executor on the hand kernels K1 / K2
    (``quant/int8_cuda.py::build_cuda_forward(backend="cuda")``), + decode;
    JAX's ``int8_pallas``;
  * ``int8_plain``: the same executor on the kernels' plain PyTorch
    versions (``backend="plain"``), + decode; it stands for JAX's
    ``int8_xla`` with the Pallas semantics (the port has no ``xla`` twin:
    JAX's ``xla_matmul_requant`` truncates a bf16 input, ROADMAP §C);
  * ``weight_only``: integer weights on bf16 activations, + decode;
  * ``train``: full training-step throughput (SGD, batch of ``--batch``).

Each path reports pipelined throughput: iterations are chained (each input
depends on the previous output by one elementwise add), dispatched ahead
and synchronized once at the end, as JAX's loop blocks once.

Usage:
    python -m spef_tpu_torch.apps.benchmark [--paths float forward] [--batch 512]
        [--img 256 256] [--iters 20] [--json out.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ["frames", "int8_graph", "main"]

PATHS = ("float", "forward", "int8_cuda", "int8_plain", "weight_only", "train")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_leaf(out) -> torch.Tensor:
    if isinstance(out, dict):
        return out[sorted(out)[0]]
    return out[0] if isinstance(out, (tuple, list)) else out


def _throughput(fn, x, iters: int, items: int, device: torch.device):
    """Pipelined throughput with data-dependent chaining: each iteration's
    input depends on the previous output (JAX's scheme, there against a
    relay that coalesces identical calls); the chain is one elementwise add
    over the input."""

    def chain(x, out):
        # A finite activation is never 3e38, so dep is 1, but only the
        # finished output says so: the data edge is real.
        dep = (_first_leaf(out).reshape(-1)[0].float() != 3.0e38).to(x.dtype)
        return x + dep

    out = None
    for _ in range(3):
        out = fn(x)
        x = chain(x, out)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
        x = chain(x, out)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    return {"items_per_sec": items / dt, "ms_per_batch": dt * 1e3}


def frames(batch: int, img_size: Tuple[int, int]) -> np.ndarray:
    """The benchmark's input: ``batch`` uint8 frames of seed 1001."""
    return np.random.RandomState(1001).randint(0, 256, (batch, *img_size, 3), dtype=np.uint8)


def _heads(spe, img_size, device) -> dict:
    return dict(ori_mode="classification", n_ori_bins=spe.orientation.n_bins,
                pos_mode="classification", n_pos_bins=spe.position.n_bins, img_size=img_size,
                device=device)


def int8_graph(spe, img_size: Tuple[int, int], device) -> dict:
    """The int8 paths' graph: ``convert_qat_params`` of a random-init
    ``mobilenet_v2_q`` + ``ursonet_q`` at the default bit widths (the init is
    seeded, so every call gives the same graph)."""
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.quant.convert import convert_qat_params

    return convert_qat_params(import_model(backbone_name="mobilenet_v2_q", head_name="ursonet_q",
                                           **_heads(spe, tuple(img_size), device)))


def main(argv: Optional[List[str]] = None) -> dict:
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.engine import build_predict_fn
    from spef_tpu_torch.models.wrapper import import_model

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--paths", nargs="*", default=["float", "forward"], choices=PATHS,
                        help="int8_cuda is JAX's int8_pallas (K1/K2); int8_plain the same "
                             "executor on the plain PyTorch versions, for JAX's int8_xla")
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--img", type=int, nargs=2, default=(256, 256))
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--json", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to benchmark on the CPU")
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    h, w = args.img
    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="classification",
                          use_keypoints=False, device=dev)
    imgs = torch.from_numpy(frames(args.batch, (h, w))).to(dev)
    results = {}

    if {"float", "forward", "train"} & set(args.paths):
        model = import_model(backbone_name="mobilenet_v2", head_name="ursonet",
                             **_heads(spe, (h, w), dev))

    if "float" in args.paths:
        results["float"] = _throughput(build_predict_fn(model, spe), imgs, args.iters,
                                       args.batch, dev)

    if "forward" in args.paths:
        scale = torch.tensor(255.0, device=dev)

        @torch.inference_mode()
        def fwd(im):
            return model(im.float() / scale)

        results["forward"] = _throughput(fwd, imgs, args.iters, args.batch, dev)

    if "train" in args.paths:
        from spef_tpu_torch.train.loss import SPELoss
        from spef_tpu_torch.train.optimizer import import_optimizer
        from spef_tpu_torch.train.step import create_train_state, make_train_step
        from spef_tpu_torch.train.trainer import Trainer

        opt, _ = import_optimizer(model.parameters(), learning_rate=0.01)
        state = create_train_state(model, opt)
        trainer = Trainer(spe, SPELoss("classification", "classification"), device=dev)
        step = make_train_step(spe, trainer.spe_loss, compute_metrics=False)
        q = torch.tensor([[1.0, 0, 0, 0]], device=dev).repeat(args.batch, 1)
        pos = torch.tensor([[0.0, 0, 10.0]], device=dev).repeat(args.batch, 1)
        targets = trainer._encode_targets(q, pos)
        images = trainer._images(imgs)
        gen = torch.Generator(device=dev).manual_seed(0)
        n = max(args.iters // 2, 5)
        for _ in range(2):
            step(state, images, targets, gen)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, images, targets, gen)
        _sync(dev)
        dt = (time.perf_counter() - t0) / n
        results["train"] = {"items_per_sec": args.batch / dt, "ms_per_batch": dt * 1e3}

    if {"int8_cuda", "int8_plain", "weight_only"} & set(args.paths):
        from spef_tpu_torch.quant.int8_cuda import build_cuda_forward
        from spef_tpu_torch.quant.int8_model import build_weight_only_forward

        graph = int8_graph(spe, (h, w), dev)
        forwards = {
            "int8_cuda": lambda: build_cuda_forward(graph, backend="cuda", device=dev),
            "int8_plain": lambda: build_cuda_forward(graph, backend="plain", device=dev),
            "weight_only": lambda: build_weight_only_forward(graph, device=dev),
        }
        for name, build in forwards.items():
            if name not in args.paths:
                continue
            fwd = build()

            @torch.inference_mode()
            def predict(im, fwd=fwd):
                pred = fwd(im)
                return spe.decode(spe.last_activ({"ori_soft": pred[0], "pos_soft": pred[1]}))

            results[name] = _throughput(predict, imgs, args.iters, args.batch, dev)

    for name, r in results.items():
        r["device"] = device_name
        print(f"{name:12s}: {r['items_per_sec']:10.1f} frames/s  ({r['ms_per_batch']:.2f} "
              f"ms/batch) on {device_name}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
