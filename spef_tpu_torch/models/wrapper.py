"""Model assembly: backbone + head, the factory, and flax weights carried over.

Counterpart of ``spef_tpu.models.wrapper``.  A model here is an ``nn.Module``
that holds its weights; ``import_model`` builds it on a device (``cuda``
unless the caller passes ``device="cpu"``) in eval mode, initialized from
``seed`` and optionally loaded from a flax ``parameters.msgpack``.

``load_flax_variables`` carries a flax variable tree (``params`` +
``batch_stats``, nested dicts of numpy arrays) onto the port's modules, whose
attribute paths mirror the flax module names:

    conv kernel  HWIO (kh, kw, in/groups, out)  -> OIHW weight
    depthwise    (3, 3, 1, C)                    -> (C, 1, 3, 3)
    dense kernel (in, out)                       -> (out, in) weight
    BN scale / bias / mean / var                 -> weight / bias / running_*
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from spef_tpu_torch.models.flax_msgpack import read_flax_msgpack
from spef_tpu_torch.models.heads import URSONetHead
from spef_tpu_torch.models.mobilenet_v2 import MobileNetV2

__all__ = ["ModelWrapper", "import_model", "load_flax_variables", "flax_state_dict"]

PARAMS_FILE = "parameters.msgpack"

_BACKBONE_ALIASES = {"mobilenet_v2_pytorch": "mobilenet_v2"}
_HEAD_ALIASES = {"ursonet_pytorch": "ursonet"}


class ModelWrapper(nn.Module):
    """features + head: NHWC float images -> (ori, pos) raw outputs."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.head(self.backbone(x))


def _leaf(name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(torch attribute, array in torch layout) of one flax leaf."""
    if name == "kernel":
        if value.ndim == 4:
            return "weight", np.transpose(value, (3, 2, 0, 1))
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim}")
    return {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}[name], value


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
    batchnorm: bool = True,
    residual: bool = True,
    ori_mode: str = "classification",
    n_ori_bins: Optional[int] = None,
    pos_mode: str = "regression",
    n_pos_bins: Optional[int] = None,
    seed: int = 1001,
    device: Union[str, torch.device] = "cuda",
    compute_dtype: torch.dtype = torch.bfloat16,
) -> ModelWrapper:
    """Build (and optionally load) a float model, in eval mode on ``device``.

    This slice covers ``mobilenet_v2`` + ``ursonet``; the quantized ``_q``
    variants (ROADMAP §A, int8 graph front end) and the keypoint heads
    (keypoints family) raise.
    """
    backbone_name = _BACKBONE_ALIASES.get(backbone_name, backbone_name)
    head_name = _HEAD_ALIASES.get(head_name, head_name)
    if backbone_name != "mobilenet_v2" or head_name != "ursonet" or ori_mode == "keypoints":
        raise NotImplementedError(
            f"{backbone_name} + {head_name} ({ori_mode}) is not ported yet; the port has "
            "mobilenet_v2 + ursonet (ROADMAP §A adds the rest)")
    gen = torch.Generator().manual_seed(seed)
    backbone = MobileNetV2(out_features=1280, batchnorm=batchnorm, residual=residual,
                           compute_dtype=compute_dtype, generator=gen)
    n_ori = 4 if ori_mode == "regression" else int(n_ori_bins)
    n_pos = 3 if pos_mode == "regression" else int(n_pos_bins)
    head = URSONetHead(1280, n_ori_outputs=n_ori, n_pos_outputs=n_pos, generator=gen)
    model = ModelWrapper(backbone, head)
    if params_path is not None:
        load_flax_variables(model, read_flax_msgpack(params_path))
    return model.to(device=device, memory_format=torch.channels_last).eval()
