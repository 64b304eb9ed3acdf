"""Model assembly: backbone + head, the factory, and flax weights carried over.

Counterpart of ``spef_tpu.models.wrapper``.  A model here is an ``nn.Module``
that holds its weights; ``import_model`` builds it on a device (``cuda``
unless the caller passes ``device="cpu"``) in eval mode, initialized from
``seed`` and optionally loaded from a flax ``parameters.msgpack``;
``save_model`` writes one (and the QAT models' ``bit_width.json``).

``load_flax_variables`` carries a flax variable tree (``params`` +
``batch_stats``, nested dicts of numpy arrays) onto the port's modules, whose
attribute paths mirror the flax module names; ``flax_variables`` gives the
tree back:

    conv kernel  HWIO (kh, kw, in/groups, out)  -> OIHW weight
    depthwise    (3, 3, 1, C)                    -> (C, 1, 3, 3)
    dense kernel (in, out)                       -> (out, in) weight
    BN scale / bias / mean / var                 -> weight / bias / running_*
    any other leaf (the QAT models' log2_scale, their head's ori_fc_kernel
    and ori_fc_bias, ...)                         -> a parameter of that name,
                                                     in flax layout
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack, write_flax_msgpack
from spef_tpu_torch.models.heads import (HRNetHeatmapHead, KeypointHeatmapHead,
                                         KeypointRegressionHead, URSONetHead)
from spef_tpu_torch.models.hrnet import HRNetW32
from spef_tpu_torch.models.mobilenet_v2 import MobileNetV2, SmallBackbone, SmallMobile

__all__ = ["ModelWrapper", "import_model", "save_model", "load_flax_variables",
           "flax_state_dict", "flax_variables", "resolve_names"]

PARAMS_FILE = "parameters.msgpack"

# Reference-name aliases (torch / brevitas naming), as ``spef_tpu``'s.
_BACKBONE_ALIASES = {
    "mobilenet_v2_pytorch": "mobilenet_v2",
    "mobilenet_v2_brevitas": "mobilenet_v2_q",
    "small_brevitas": "small_q",
    "small_mobile_brevitas": "small_mobile_q",
}
_HEAD_ALIASES = {"ursonet_pytorch": "ursonet", "ursonet_brevitas": "ursonet_q",
                 "keypoints_regression_pytorch": "keypoints_regression"}

# The float backbones, by name.
_BACKBONES = {"mobilenet_v2": MobileNetV2, "small_mobile": SmallMobile, "small": SmallBackbone}


def resolve_names(backbone_name: str, head_name: str) -> Tuple[str, str]:
    return (_BACKBONE_ALIASES.get(backbone_name, backbone_name),
            _HEAD_ALIASES.get(head_name, head_name))


class ModelWrapper(nn.Module):
    """features + head: NHWC float images -> (ori, pos) raw outputs, or the
    keypoint logits (B, 24) of a keypoint head.
    ``bit_width`` is the QAT models' recipe (None for a float model)."""

    def __init__(self, backbone: nn.Module, head: nn.Module, bit_width: Optional[dict] = None):
        super().__init__()
        self.backbone = backbone
        self.head = head
        self.bit_width = bit_width

    def forward(self, x: torch.Tensor):
        return self.head(self.backbone(x))


def _leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch attribute, array in torch layout) of one flax leaf."""
    if name == "kernel":
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    return _RENAMED.get(name, name), value


_RENAMED = {"scale": "weight", "mean": "running_mean", "var": "running_var"}
_BATCH_STATS = {"running_mean": "mean", "running_var": "var"}


def flax_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten ``params`` + ``batch_stats`` into a torch ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Dict[str, Any], path: Tuple[str, ...]) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                attr, arr = _leaf(k, np.asarray(v))
                out[".".join(path + (attr,))] = torch.tensor(arr, dtype=torch.float32)

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out


def flax_variables(model: nn.Module) -> Dict[str, Any]:
    """The flax variable tree of ``model`` (``params`` + ``batch_stats``,
    nested dicts of float32 numpy arrays): :func:`load_flax_variables`
    inverted."""
    tree: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, value in model.state_dict().items():
        *path, attr = key.split(".")
        if attr == "num_batches_tracked":
            continue
        arr = value.detach().cpu().numpy().astype(np.float32)
        parent = model.get_submodule(".".join(path))
        norm = isinstance(parent, nn.modules.batchnorm._BatchNorm)
        if attr in _BATCH_STATS:
            collection, name = "batch_stats", _BATCH_STATS[attr]
        elif attr == "weight" and norm:
            collection, name = "params", "scale"
        elif attr == "weight":
            collection, name = "params", "kernel"
            arr = np.transpose(arr, (2, 3, 1, 0)) if arr.ndim == 4 else arr.T
        else:
            collection, name = "params", attr
        node = tree[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.array(arr, order="C")
    return tree


def load_flax_variables(model: nn.Module, variables: Dict[str, Any]) -> nn.Module:
    """Copy a flax variable tree into ``model`` (every parameter and BN
    statistic must be covered, and nothing else given)."""
    sd = flax_state_dict(variables)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"flax tree does not fit the model: missing {missing}, "
                         f"unexpected {unexpected}")
    return model


def import_model(
    backbone_name: str = "mobilenet_v2",
    head_name: str = "ursonet",
    params_path: Optional[str] = None,
    bit_width: Optional[dict] = None,
    batchnorm: bool = True,
    residual: bool = True,
    quantization: bool = True,
    ori_mode: str = "classification",
    n_ori_bins: Optional[int] = None,
    pos_mode: str = "regression",
    n_pos_bins: Optional[int] = None,
    n_keypoint_outputs: int = 24,
    img_size: Tuple[int, int] = (240, 384),
    seed: int = 1001,
    device: Union[str, torch.device] = "cuda",
    compute_dtype: torch.dtype = torch.bfloat16,
    pretrained_path: Optional[str] = None,
) -> ModelWrapper:
    """Build (and optionally load) a model, in eval mode on ``device``.

    The float backbones ``mobilenet_v2``, ``small_mobile`` and ``small`` +
    ``ursonet`` (in ``compute_dtype``) and the quantized ``_q`` models
    (``mobilenet_v2_q``, ``small_mobile_q``, ``small_q`` + ``ursonet_q``,
    float32, fake-quantized by ``bit_width`` when ``quantization``),
    selected by the ``_q`` suffix as in the JAX factory.
    ``hrnet_w32`` (HRNet-W32, ``models.hrnet``, in ``compute_dtype``; with
    BatchNorm and residuals only) takes the ``hrnet_heatmap`` keypoint head.
    ``pretrained_path`` warm-starts the backbone from a torchvision-format
    MobileNetV2 file on disk (``models.pretrained``), before
    ``params_path`` is loaded.  ``ori_mode="keypoints"`` takes a keypoint
    head: ``keypoints_heatmap``, ``hrnet_heatmap`` (HRNet's 1x1 final layer),
    or the regression head for any other name
    (``keypoints_regression``), with ``n_keypoint_outputs`` outputs; the
    regression head's input size is the feature map's at ``img_size``.
    """
    backbone_name, head_name = resolve_names(backbone_name, head_name)
    gen = torch.Generator().manual_seed(seed)
    if backbone_name.endswith("_q"):
        from spef_tpu_torch.quant.qmodels import build_quant_backbone

        cfg = {"batchnorm": batchnorm, "residual": residual}
        backbone = build_quant_backbone(backbone_name, cfg, bit_width, quantization, gen)
    elif backbone_name in _BACKBONES:
        backbone = _BACKBONES[backbone_name](batchnorm=batchnorm, residual=residual,
                                             compute_dtype=compute_dtype, generator=gen)
    elif backbone_name == "hrnet_w32":
        if not (batchnorm and residual):
            raise ValueError("HRNet-W32 is built with its BatchNorms and residual adds")
        backbone = HRNetW32(compute_dtype=compute_dtype, generator=gen)
    else:
        raise ValueError(f"Backbone {backbone_name} does not exist")
    if ori_mode == "keypoints":
        if head_name == "keypoints_heatmap":
            head = KeypointHeatmapHead(backbone.out_features, n_outputs=n_keypoint_outputs,
                                       compute_dtype=compute_dtype, generator=gen)
        elif head_name == "hrnet_heatmap":
            head = HRNetHeatmapHead(backbone.out_features, n_outputs=n_keypoint_outputs,
                                    generator=gen)
        else:
            with torch.no_grad():  # the flattened feature map's size at img_size
                feat = backbone(torch.zeros((1, *img_size, 3)))
            head = KeypointRegressionHead(feat[0].numel(), n_outputs=n_keypoint_outputs,
                                          generator=gen)
    elif head_name == "ursonet_q":
        from spef_tpu_torch.quant.qmodels import build_quant_head

        n_ori = 4 if ori_mode == "regression" else int(n_ori_bins)
        n_pos = 3 if pos_mode == "regression" else int(n_pos_bins)
        head = build_quant_head(head_name, backbone.out_features, n_ori, n_pos, bit_width,
                                quantization, gen)
    else:
        n_ori = 4 if ori_mode == "regression" else int(n_ori_bins)
        n_pos = 3 if pos_mode == "regression" else int(n_pos_bins)
        head = URSONetHead(backbone.out_features, n_ori_outputs=n_ori, n_pos_outputs=n_pos,
                           generator=gen)
    model = ModelWrapper(backbone, head, bit_width)
    if pretrained_path is not None:
        from spef_tpu_torch.models.pretrained import load_pretrained_backbone

        load_pretrained_backbone(pretrained_path, model)
    if params_path is not None:
        load_flax_variables(model, read_flax_msgpack(params_path))
    return model.to(device=device, memory_format=torch.channels_last).eval()


def save_model(save_folder: str, model: ModelWrapper, bit_width: Optional[dict] = None) -> str:
    """Write ``parameters.msgpack`` (flax's format) and, for a QAT model,
    ``bit_width.json`` into ``save_folder``; returns the parameters' path."""
    import os

    from spef_tpu_torch.quant.bitwidth import save_bit_width

    os.makedirs(save_folder, exist_ok=True)
    path = write_flax_msgpack(os.path.join(save_folder, PARAMS_FILE), flax_variables(model))
    bw = bit_width if bit_width is not None else model.bit_width
    if bw is not None:
        save_bit_width(save_folder, bw)
    return path
