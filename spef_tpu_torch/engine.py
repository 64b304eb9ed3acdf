"""SPETorch — the inference engine of the port.

Counterpart of ``spef_tpu.engine`` (``build_predict_fn`` and ``SPEJax``):

    uint8 image -> /255 -> CNN -> last activation -> decode -> pose

PyTorch runs eagerly, so the predict function is a plain function under
``torch.inference_mode``.  The int8 path passes its own ``forward_fn``
(``spef_tpu_torch.quant.int8_cuda.build_cuda_forward``, or
``quant.int8_fused.build_fused_forward``, which takes the raw uint8 frames).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils

__all__ = ["SPETorch", "build_predict_fn"]


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
