"""ImageNet-pretrained backbone ingestion (torchvision MobileNetV2).

Counterpart of ``spef_tpu.models.pretrained``: given a torchvision-format
MobileNetV2 checkpoint on disk (a ``.npz`` of numpy arrays or a torch
``state_dict`` file, both keyed by the standard ``features.*`` names), every
backbone tensor is mapped onto the model by structured name, so a missing
tensor is a ``KeyError`` and a shape mismatch a ``ValueError``: ingestion is
all or nothing.  Nothing is downloaded.

torchvision's layouts are the port's (conv weights OIHW, depthwise
``(C, 1, kH, kW)``, BN ``weight`` / ``bias`` / ``running_*``), so the
tensors are copied as they are.  The head keeps its fresh init.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from spef_tpu_torch.models.mobilenet_v2 import MOBILENET_V2_SETTINGS

__all__ = ["load_pretrained_backbone", "torchvision_key_map", "load_state_dict_file"]


def torchvision_key_map() -> List[Tuple[str, str, str]]:
    """(torchvision prefix, backbone module path, kind) triples for
    MobileNetV2.  kind is ``conv`` (a bare conv weight), ``bn`` or
    ``convbn`` (ConvBNReLU: conv at ``.0``, BN at ``.1``).  The paths are
    flax's module paths (``block_0/depthwise``), which the port's modules
    mirror with dots."""
    table: List[Tuple[str, str, str]] = [("features.0", "stem", "convbn")]
    block = 0
    for t, _c, n, _s in MOBILENET_V2_SETTINGS:
        for _ in range(n):
            tv = f"features.{block + 1}.conv"
            fx = f"block_{block}"
            if t == 1:
                # torchvision: conv.0 = ConvBNReLU(dw), conv.1 = proj conv, conv.2 = proj BN
                table.append((f"{tv}.0", f"{fx}/depthwise", "convbn"))
                table.append((f"{tv}.1", f"{fx}/project/conv", "conv"))
                table.append((f"{tv}.2", f"{fx}/project/bn", "bn"))
            else:
                table.append((f"{tv}.0", f"{fx}/expand", "convbn"))
                table.append((f"{tv}.1", f"{fx}/depthwise", "convbn"))
                table.append((f"{tv}.2", f"{fx}/project/conv", "conv"))
                table.append((f"{tv}.3", f"{fx}/project/bn", "bn"))
            block += 1
    table.append((f"features.{block + 1}", "head_conv", "convbn"))
    return table


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """A torchvision-style state dict from a ``.npz`` or a torch file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items() if torch.is_tensor(v)}


def load_pretrained_backbone(path_or_state: Any, model: nn.Module,
                             backbone_attr: str = "backbone") -> nn.Module:
    """Initialize ``model``'s backbone from a torchvision MobileNetV2
    checkpoint (a path, or a dict of arrays); returns ``model``."""
    state = (load_state_dict_file(path_or_state)
             if isinstance(path_or_state, (str, os.PathLike)) else dict(path_or_state))
    backbone = getattr(model, backbone_attr)
    targets: Dict[str, torch.Tensor] = dict(backbone.named_parameters())
    targets.update(backbone.named_buffers())

    def assign(path: str, value: np.ndarray) -> None:
        name = path.replace("/", ".")
        if name not in targets:
            raise KeyError(f"the backbone has no {backbone_attr}.{name}")
        t = targets[name]
        value = np.asarray(value)
        if tuple(t.shape) != value.shape:
            raise ValueError(f"pretrained shape mismatch at {backbone_attr}.{name}: "
                             f"checkpoint {value.shape} vs model {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.as_tensor(value, dtype=t.dtype))

    for tv, path, kind in torchvision_key_map():
        if kind in ("conv", "convbn"):
            conv_key = f"{tv}.weight" if kind == "conv" else f"{tv}.0.weight"
            assign(f"{path}/weight" if kind == "conv" else f"{path}/conv/weight", state[conv_key])
        if kind in ("bn", "convbn"):
            bn_key = tv if kind == "bn" else f"{tv}.1"
            bn_path = path if kind == "bn" else f"{path}/bn"
            for attr in ("weight", "bias", "running_mean", "running_var"):
                assign(f"{bn_path}/{attr}", state[f"{bn_key}.{attr}"])
    return model
