"""SPETorch — the inference engine of the port.

Counterpart of ``spef_tpu.engine`` (``build_predict_fn`` and ``SPEJax``):

    uint8 image -> /255 -> CNN -> last activation -> decode -> pose

PyTorch runs eagerly, so the predict function is a plain function under
``torch.inference_mode``.  The int8 path passes its own ``forward_fn``
(``spef_tpu_torch.quant.int8_cuda.build_cuda_forward``, or
``quant.int8_fused.build_fused_forward`` / ``quant.int8_carry.
build_int8_carry_forward``, which take the raw uint8 frames).

``discover_engine_variants`` / ``build_engine_variant`` serve an
experiment's artifacts: the float (or QAT) model, and the ``weight-only``
and ``int8-carry`` executors of its ``int8_graph.pkl``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils

__all__ = ["SPETorch", "build_predict_fn", "discover_engine_variants", "build_engine_variant"]


def _raw_to_pose(spe_utils: SPEUtils, pred) -> Dict[str, torch.Tensor]:
    """Map the two raw outputs to the pose dict keys used everywhere."""
    ori_key = "ori" if spe_utils.ori_mode == "regression" else "ori_soft"
    pos_key = "pos" if spe_utils.pos_mode == "regression" else "pos_soft"
    return {ori_key: pred[0], pos_key: pred[1]}


def build_predict_fn(
    model: Optional[torch.nn.Module],
    spe_utils: SPEUtils,
    decode: bool = True,
    forward_fn: Optional[Callable] = None,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Build the (preprocess -> forward -> activ -> decode) function.

    ``forward_fn(images) -> raw outputs`` defaults to ``model``.  Images are
    NHWC on the model's device, uint8 [0, 255] or float [0, 1].  A
    ``forward_fn`` whose ``takes_uint8`` attribute is true folds the
    normalization itself and gets uint8 frames as they are.
    """
    fwd = forward_fn or model
    normalize = not getattr(fwd, "takes_uint8", False)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if normalize and images.dtype == torch.uint8:
            # An IEEE division, as JAX's: a CUDA tensor divided by a Python
            # scalar becomes a multiply by the reciprocal.
            images = images.float() / torch.tensor(255.0, device=images.device)
        pose = _raw_to_pose(spe_utils, fwd(images))
        pose = spe_utils.last_activ(pose)
        if decode:
            pose = spe_utils.decode(pose)
        return pose

    return predict


class SPETorch:
    """Stateful engine wrapper with the reference's ``predict`` contract."""

    def __init__(
        self,
        model: Optional[torch.nn.Module],
        spe_utils: SPEUtils,
        decode: bool = True,
        forward_fn: Optional[Callable] = None,
        device: str = "cuda",
    ):
        self.model = model
        self.spe_utils = spe_utils
        self.device = torch.device(device)
        self._predict = build_predict_fn(model, spe_utils, decode, forward_fn)

    def predict(self, images) -> Tuple[Dict[str, torch.Tensor], float]:
        """Run inference; returns (pose dict of device tensors, wall ms).

        As in ``SPEJax.predict``, the input is on the device before the clock
        starts; the clock is read after ``torch.cuda.synchronize()``.
        """
        x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
        x = x.to(self.device)
        start = time.perf_counter()
        pose = self._predict(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return pose, (time.perf_counter() - start) * 1000.0


# ---------------------------------------------------------------------------
# Engine variants from experiment artifacts
# ---------------------------------------------------------------------------


def discover_engine_variants(exp_dir: str):
    """Engine variants an experiment directory offers, as the JAX engine
    lists them: the float model; ``weight-only`` and ``int8-carry`` where it
    holds an ``int8_graph.pkl``; ``exported`` where it holds a ``model.spef``;
    the two crop-refine variants where its ``crop_refine.json`` points at a
    fine model."""
    import json
    import os

    variants = ["float"]
    if os.path.isfile(os.path.join(exp_dir, "int8_graph.pkl")):
        variants += ["weight-only", "int8-carry"]
    if os.path.isfile(os.path.join(exp_dir, "model.spef")):
        variants.append("exported")
    ptr = os.path.join(exp_dir, "crop_refine.json")
    if os.path.isfile(ptr):
        try:
            with open(ptr) as f:
                fine = json.load(f).get("fine_exp", "")
            if os.path.isfile(os.path.join(fine, "model", "parameters.msgpack")):
                variants += ["crop-refine", "crop-refine-w8"]
        except (OSError, ValueError):
            pass
    return variants


def build_engine_variant(exp_dir: str, model: Optional[torch.nn.Module], spe_utils: SPEUtils,
                         variant: str = "float", device: str = "cuda") -> SPETorch:
    """A ``predict``-contract engine for one variant of an experiment.

    ``float`` runs ``model`` (the float or the QAT model); ``weight-only``
    and ``int8-carry`` run the experiment's ``int8_graph.pkl``
    (``quant.int8_model.build_weight_only_forward``,
    ``quant.int8_carry.build_int8_carry_forward`` on K1/K2).
    """
    import os

    if variant == "exported":
        raise NotImplementedError("the .spef export is not ported yet (ROADMAP §A, item 10)")
    if variant in ("crop-refine", "crop-refine-w8"):
        raise NotImplementedError("crop-refine is not ported yet (ROADMAP §A, item 8)")
    forward_fn = None
    if variant in ("weight-only", "int8-carry"):
        from spef_tpu_torch.quant.int8_graph import load_int8_graph

        graph = load_int8_graph(os.path.join(exp_dir, "int8_graph.pkl"))
        if variant == "weight-only":
            from spef_tpu_torch.quant.int8_model import build_weight_only_forward

            forward_fn = build_weight_only_forward(graph, device=device)
        else:
            from spef_tpu_torch.quant.int8_carry import build_int8_carry_forward

            forward_fn = build_int8_carry_forward(graph, device=device)
    elif variant != "float":
        raise KeyError(f"unknown engine variant {variant!r}")
    return SPETorch(model, spe_utils, forward_fn=forward_fn, device=device)
