"""SPETorch — the inference engine of the port.

Counterpart of ``spef_tpu.engine`` (``build_predict_fn`` and ``SPEJax``):

    uint8 image -> /255 -> CNN -> last activation -> decode -> pose

PyTorch runs eagerly, so the predict function is a plain function under
``torch.inference_mode``.  The int8 path passes its own ``forward_fn``
(``spef_tpu_torch.quant.int8_cuda.build_cuda_forward``, or
``quant.int8_fused.build_fused_forward`` / ``quant.int8_carry.
build_int8_carry_forward``, which take the raw uint8 frames).

``SPECropRefine`` is the two-pass keypoints engine (coarse keypoints, a
crop box, the crop resampled on the card, the fine pass, the keypoints
mapped back, the PnP decode: ``codec/crop.py``), with the same ``predict``
contract.

``discover_engine_variants`` / ``build_engine_variant`` serve an
experiment's artifacts: the float (or QAT) model, the ``weight-only``
and ``int8-carry`` executors of its ``int8_graph.pkl``, its exported
``model.spef`` (``deploy.load_exported``), and the two-pass
``crop-refine`` / ``crop-refine-w8`` variants its ``crop_refine.json``
points at.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils

__all__ = ["SPETorch", "SPECropRefine", "build_predict_fn", "build_crop_refine_fn",
           "discover_engine_variants", "build_engine_variant"]


def _raw_to_pose(spe_utils: SPEUtils, pred) -> Dict[str, torch.Tensor]:
    """Map the raw outputs to the pose dict keys used everywhere: the two
    outputs of the URSONet head, or the keypoint logits."""
    if spe_utils.keypoints_mode:
        return {"keypoints": pred[0] if isinstance(pred, tuple) else pred}
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


def _keypoint_logits(model: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    def fwd(images: torch.Tensor) -> torch.Tensor:
        out = model(images)
        return out[0] if isinstance(out, tuple) else out
    return fwd


def build_crop_refine_fn(
    coarse: torch.nn.Module,
    fine: torch.nn.Module,
    spe_utils: SPEUtils,
    crop_hw: Optional[Tuple[int, int]] = None,
    margin: float = 1.5,
    gate: Optional[float] = 0.02,
    decode: bool = True,
) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """The two-pass predict function: uint8 [0, 255] or float [0, 1] NHWC
    images -> the pipeline's keypoints (``keypoints``, ``keypoints_coarse``,
    ``crop_box`` and, with ``gate``, ``keypoints_fine`` / ``gate_keep``)
    and, with ``decode``, ``ori`` / ``pos`` by ``spe_utils``'s keypoint
    decode.  ``crop_hw`` is the fine model's input size (the images' size
    when None); ``margin`` and ``gate`` as in ``codec.crop``."""
    from spef_tpu_torch.codec.crop import CropRefinePipeline

    if not spe_utils.keypoints_mode:
        raise ValueError("crop-refine is a keypoints-mode pipeline")
    pipe = CropRefinePipeline(_keypoint_logits(coarse), _keypoint_logits(fine),
                              margin=margin, gate=gate)

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> Dict[str, torch.Tensor]:
        if images.dtype == torch.uint8:
            images = images.float() / torch.full((), 255.0, device=images.device)
        pipe.crop_hw = tuple(crop_hw) if crop_hw is not None else tuple(images.shape[1:3])
        pose = pipe(images)
        if decode:
            pose.update(spe_utils.keypoints.decode_batch(
                pose["keypoints"], ransac=spe_utils.keypoints_ransac,
                border_gate=spe_utils.keypoints_border_gate))
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


class SPECropRefine(SPETorch):
    """The two-pass crop-refine keypoints engine (:func:`build_crop_refine_fn`),
    with ``SPETorch``'s ``predict`` contract: ``coarse`` is the full-frame
    keypoints model, ``fine`` the crop-trained one."""

    def __init__(
        self,
        coarse: torch.nn.Module,
        fine: torch.nn.Module,
        spe_utils: SPEUtils,
        crop_hw: Optional[Tuple[int, int]] = None,
        margin: float = 1.5,
        gate: Optional[float] = 0.02,
        decode: bool = True,
        device: str = "cuda",
    ):
        self.model = coarse
        self.fine = fine
        self.spe_utils = spe_utils
        self.device = torch.device(device)
        self._predict = build_crop_refine_fn(coarse, fine, spe_utils, crop_hw, margin, gate,
                                             decode)


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


def load_experiment_model(exp_dir: str, device: str = "cuda", **kw) -> torch.nn.Module:
    """The float model of an experiment directory (its ``config.yaml`` and
    ``model/parameters.msgpack``), as the crop-refine pair loads its fine
    pass; ``kw`` goes to ``import_model``."""
    import os

    from spef_tpu_torch.config.train_config import load_config
    from spef_tpu_torch.models.wrapper import import_model

    cfg = load_config(os.path.join(exp_dir, "config.yaml"))
    return import_model(
        backbone_name=cfg.MODEL.BACKBONE.NAME, head_name=cfg.MODEL.HEAD.NAME,
        img_size=tuple(cfg.DATA.IMG_SIZE),
        params_path=os.path.join(exp_dir, "model", "parameters.msgpack"),
        residual=cfg.MODEL.BACKBONE.RESIDUAL, quantization=cfg.MODEL.QUANTIZATION,
        ori_mode=cfg.MODEL.HEAD.ORI, pos_mode=cfg.MODEL.HEAD.POS, device=device, **kw)


def build_engine_variant(exp_dir: str, model: Optional[torch.nn.Module], spe_utils: SPEUtils,
                         variant: str = "float", device: str = "cuda"):
    """A ``predict``-contract engine for one variant of an experiment.

    ``float`` runs ``model`` (the float or the QAT model); ``weight-only``
    and ``int8-carry`` run the experiment's ``int8_graph.pkl``
    (``quant.int8_model.build_weight_only_forward``,
    ``quant.int8_carry.build_int8_carry_forward`` on K1/K2);
    ``crop-refine`` runs ``model`` as the coarse pass of
    :class:`SPECropRefine` and the experiment its ``crop_refine.json``
    names (``fine_exp``) as the fine pass, at the fine config's image size,
    with the registry's ``gate`` (0.02 where it has none);
    ``crop-refine-w8`` the same on copies of both models whose kernels are
    snapped to per-channel int8 grids (``quant.weight_only``); ``exported``
    loads the experiment's ``model.spef`` (``apps.export``) onto ``device``
    as a ``deploy.ExportedEngine`` and ignores ``model``.
    """
    import os

    if variant == "exported":
        from spef_tpu_torch.deploy import load_exported

        return load_exported(os.path.join(exp_dir, "model.spef"), device=device)
    if variant in ("crop-refine", "crop-refine-w8"):
        import json

        from spef_tpu_torch.config.train_config import load_config

        with open(os.path.join(exp_dir, "crop_refine.json")) as f:
            reg = json.load(f)
        fine_exp = reg["fine_exp"]
        gate = reg.get("gate", 0.02)
        crop_hw = tuple(load_config(os.path.join(fine_exp, "config.yaml")).DATA.IMG_SIZE)
        fine = load_experiment_model(fine_exp, device=device)
        if variant == "crop-refine-w8":
            from spef_tpu_torch.quant.weight_only import quantize_model_weights

            # Copies: the caller's float model is shared with the float variant.
            model = quantize_model_weights(model, 8)[0]
            fine = quantize_model_weights(fine, 8)[0]
        return SPECropRefine(model, fine, spe_utils, crop_hw=crop_hw, gate=gate, device=device)
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
