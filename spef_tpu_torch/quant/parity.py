"""Parity harness: the QAT fake-quant forward against an int8 executor —
counterpart of ``spef_tpu.quant.parity`` (the reference's
``predict_and_compare``): tensor MSE, cosine similarity, elementwise
closeness and zero pattern of the raw outputs, and the decoded poses' gap.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["compare_tensors", "predict_and_compare"]


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def compare_tensors(a, b, rtol: float = 1e-4, atol: float = 1e-5) -> Dict[str, float]:
    """Similarity metrics between two activation or logit tensors."""
    a = _np(a).astype(np.float64).ravel()
    b = _np(b).astype(np.float64).ravel()
    mse = float(np.mean((a - b) ** 2))
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    cos = float(np.dot(a, b) / denom) if denom > 0 else 1.0
    close = float(np.mean(np.isclose(a, b, rtol=rtol, atol=atol)))
    zero_match = float(np.mean((a == 0) == (b == 0)))
    return {"mse": mse, "cosine": cos, "close_ratio": close, "zero_pattern": zero_match}


def predict_and_compare(qat_forward: Callable, int8_forward: Callable, images: torch.Tensor,
                        spe_utils=None) -> Dict[str, Dict[str, float]]:
    """Run one batch through both paths and compare the raw outputs (and the
    decoded poses when ``spe_utils`` is given).  ``qat_forward`` gets the
    frames / 255 (IEEE division), ``int8_forward`` the frames as given."""
    with torch.inference_mode():
        if images.dtype == torch.uint8:
            images_f = images.float() / torch.tensor(255.0, device=images.device)
        else:
            images_f = images
        qat_out = qat_forward(images_f)
        int8_out = int8_forward(images)
    report = {
        "ori_raw": compare_tensors(qat_out[0], int8_out[0]),
        "pos_raw": compare_tensors(qat_out[1], int8_out[1]),
    }
    if spe_utils is not None:
        def decode(pred):
            ori_key = "ori" if spe_utils.ori_mode == "regression" else "ori_soft"
            pos_key = "pos" if spe_utils.pos_mode == "regression" else "pos_soft"
            return spe_utils.decode(spe_utils.last_activ({ori_key: pred[0], pos_key: pred[1]}))

        pose_q, pose_i = decode(qat_out), decode(int8_out)
        ori_dot = np.abs(np.sum(_np(pose_q["ori"]) * _np(pose_i["ori"]), axis=-1))
        pos_diff = np.linalg.norm(_np(pose_q["pos"]) - _np(pose_i["pos"]), axis=-1)
        report["pose"] = {
            "ori_agreement_deg": float(np.rad2deg(np.mean(2 * np.arccos(np.clip(ori_dot, 0, 1))))),
            "pos_diff_m": float(np.mean(pos_diff)),
        }
    return report
