"""Temporal inference: whole sequences and the streaming engine (PyTorch).

Counterpart of ``spef_tpu.temporal.inference``: the still pose of every
frame, quaternion sign continuity with the |dot| > 0.5 outlier gate, the
adaptive PDF filter ('Adaptative') on the ori / pos soft outputs and their
re-decode.

  * :func:`sequence_inference` runs one sequence: a chunked forward, the
    last activation, the still decode, the continuity pass, both
    :func:`~spef_tpu_torch.temporal.pdf_filter.scan_filter`\\ s, the filtered
    decode and the continuity pass again.  Everything after the forward
    stays on the device.
  * :func:`multi_sequence_inference` runs ``(S, T, ...)`` equal-length
    sequences: all frames flattened for the forward, the filter and the
    continuity batched over the sequences.
  * :class:`Inference` is the streaming engine, frame by frame, over any
    engine whose ``predict(images) -> (pose, ms)`` is ``SPETorch.predict``'s.

A ``forward_fn`` gets each chunk on the facade's device: uint8 frames
divided by 255 (an IEEE division, as JAX's), unless its ``takes_uint8``
attribute says it folds the normalization itself (the int8 executors).
Quaternions from ``eigh`` carry no fixed sign: the continuity pass ties a
trajectory to frame 0's, so compare them up to sign.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from spef_tpu_torch.codec.facade import SPEUtils
from spef_tpu_torch.temporal.pdf_filter import TemporalPDF, filter_defaults, scan_filter

__all__ = ["Inference", "sequence_inference", "multi_sequence_inference",
           "quaternion_continuity_scan"]


def quaternion_continuity_scan(quats: torch.Tensor) -> torch.Tensor:
    """Sign continuity over ``(..., T, 4)`` quaternion sequences: flip ``q``
    where its dot with the reference is negative; the reference becomes the
    fixed ``q`` only where ``|dot| > 0.5`` (the outlier gate), and is frame
    0's to begin with.  No step reads a value back to the host."""
    reference = quats[..., 0, :]
    fixed = [reference]
    for t in range(1, quats.shape[-2]):
        q = quats[..., t, :]
        dot = torch.sum(reference * q, dim=-1, keepdim=True)
        q_fixed = torch.where(dot < 0, -q, q)
        reference = torch.where(torch.abs(dot) > 0.5, q_fixed, reference)
        fixed.append(q_fixed)
    return torch.stack(fixed, dim=-2)


def _filter_configs(dataset, ori_filter, pos_filter):
    ori_def, pos_def = filter_defaults(dataset)
    return {**ori_def, **(ori_filter or {})}, {**pos_def, **(pos_filter or {})}


def _forward_chunks(spe_utils: SPEUtils, forward_fn, frames, frame_batch: int):
    """Soft outputs ``(N, n_ori)``, ``(N, n_pos)`` of ``frames`` ``(N, H, W,
    C)`` (numpy or a tensor), forwarded in chunks of ``frame_batch`` on the
    facade's device."""
    device = spe_utils.orientation.histogram.device
    normalize = not getattr(forward_fn, "takes_uint8", False)
    ori, pos = [], []
    with torch.inference_mode():
        for start in range(0, frames.shape[0], frame_batch):
            chunk = torch.as_tensor(frames[start:start + frame_batch]).to(device)
            if normalize and chunk.dtype == torch.uint8:
                chunk = chunk.float() / torch.tensor(255.0, device=device)
            pred = forward_fn(chunk)
            pose = spe_utils.last_activ({"ori_soft": pred[0], "pos_soft": pred[1]})
            ori.append(pose["ori_soft"].float())
            pos.append(pose["pos_soft"].float())
    return torch.cat(ori), torch.cat(pos)


def _postprocess(spe_utils: SPEUtils, ori_soft: torch.Tensor, pos_soft: torch.Tensor,
                 filter_video: bool, ori_cfg: dict, pos_cfg: dict) -> Dict[str, torch.Tensor]:
    """Decode, continuity and filter of ``(..., T, n_bins)`` soft outputs."""
    lead = ori_soft.shape[:-1]

    def decode(o_soft, p_soft):
        q, _ = spe_utils.orientation.decode_batch(o_soft.reshape(-1, o_soft.shape[-1]))
        t = spe_utils.position.decode_batch(p_soft.reshape(-1, p_soft.shape[-1]))
        return quaternion_continuity_scan(q.reshape(*lead, 4)), t.reshape(*lead, 3)

    with torch.inference_mode():
        out = dict(zip(("ori_still", "pos_still"), decode(ori_soft, pos_soft)))
        if filter_video:
            ori_filt, ori_dist = scan_filter(ori_soft, ori_cfg["n"], ori_cfg["alpha"],
                                             ori_cfg["distance_metric"])
            pos_filt, pos_dist = scan_filter(pos_soft, pos_cfg["n"], pos_cfg["alpha"],
                                             pos_cfg["distance_metric"])
            out.update(zip(("ori_video", "pos_video"), decode(ori_filt, pos_filt)))
            out.update(ori_distance=ori_dist, pos_distance=pos_dist)
    return out


def sequence_inference(
    spe_utils: SPEUtils,
    forward_fn,
    frames,
    filter_video: bool = True,
    ori_filter: Optional[dict] = None,
    pos_filter: Optional[dict] = None,
    frame_batch: int = 32,
    dataset: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """One sequence ``(T, H, W, C)``, uint8 or float [0, 1], numpy or a
    tensor, through ``forward_fn(images) -> (ori_logits, pos_logits)``.

    Returns device tensors: ``ori_still``, ``pos_still``, ``ori_soft``,
    ``pos_soft`` and, with ``filter_video``, ``ori_video``, ``pos_video``,
    ``ori_distance``, ``pos_distance``.  ``dataset`` picks the domain's filter
    constants (``DOMAIN_FILTER_DEFAULTS``); ``ori_filter`` / ``pos_filter``
    entries override them.  Filtering needs the classification modes.
    """
    ori_cfg, pos_cfg = _filter_configs(dataset, ori_filter, pos_filter)
    ori_soft, pos_soft = _forward_chunks(spe_utils, forward_fn, frames, frame_batch)
    out = _postprocess(spe_utils, ori_soft, pos_soft, filter_video, ori_cfg, pos_cfg)
    out.update(ori_soft=ori_soft, pos_soft=pos_soft)
    return out


def multi_sequence_inference(
    spe_utils: SPEUtils,
    forward_fn,
    sequences,
    filter_video: bool = True,
    ori_filter: Optional[dict] = None,
    pos_filter: Optional[dict] = None,
    frame_batch: int = 64,
    dataset: Optional[str] = None,
) -> Dict[str, torch.Tensor]:
    """``S`` equal-length sequences ``(S, T, H, W, C)``: the frames of all of
    them flattened into forward chunks of ``frame_batch``, the decode, the
    continuity and the filter batched over ``S``.  The outputs of
    :func:`sequence_inference` but the soft ones, each ``(S, T, ...)``."""
    ori_cfg, pos_cfg = _filter_configs(dataset, ori_filter, pos_filter)
    s, t = sequences.shape[0], sequences.shape[1]
    flat = sequences.reshape(s * t, *sequences.shape[2:])
    ori_soft, pos_soft = _forward_chunks(spe_utils, forward_fn, flat, frame_batch)
    return _postprocess(spe_utils, ori_soft.reshape(s, t, -1), pos_soft.reshape(s, t, -1),
                        filter_video, ori_cfg, pos_cfg)


def _host(pose: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() for k, v in pose.items()}


class Inference:
    """Streaming (frame-at-a-time) inference: the still pose, its sign
    continuity and, with ``video_type="Adaptative"``, the adaptive PDF filter
    of both soft outputs on the device and their decode.  The poses come
    back as numpy arrays."""

    def __init__(self, engine, spe_utils: SPEUtils, dataset: Optional[str] = None):
        self.engine = engine
        self.spe_utils = spe_utils
        self.prev_still_ori: Optional[np.ndarray] = None
        self.prev_video_ori: Optional[np.ndarray] = None
        ori_cfg, pos_cfg = filter_defaults(dataset)
        self.pdf_adapt_ori = TemporalPDF(**ori_cfg)
        self.pdf_adapt_pos = TemporalPDF(**pos_cfg)

    def reset(self) -> None:
        self.prev_still_ori = None
        self.prev_video_ori = None
        self.pdf_adapt_ori.reset()
        self.pdf_adapt_pos.reset()

    def _continuity(self, prev: Optional[np.ndarray], ori: np.ndarray):
        if prev is None:
            return ori, ori
        dot = float(np.dot(prev, ori))
        if dot < 0:
            ori = -ori
        new_prev = ori if abs(dot) > 0.5 else prev
        return ori, new_prev

    def _add_viz(self, pose: dict) -> dict:
        """Keypoints and their box (normalized) where the facade has the
        keypoint helper."""
        kp = self.spe_utils.keypoints
        if kp is None:
            return pose
        device = self.spe_utils.orientation.histogram.device
        if self.spe_utils.keypoints_mode:
            k2d = torch.as_tensor(pose["keypoints"], device=device)
        else:
            k2d = kp.create_keypoints2d(torch.as_tensor(pose["ori"], device=device),
                                        torch.as_tensor(pose["pos"], device=device))
            pose["keypoints"] = k2d.cpu().numpy()
        pose["bbox"] = kp.create_bbox_from_keypoints(k2d).cpu().numpy()
        return pose

    def predict(self, image, video_type: Optional[str] = None):
        """One frame ``(1, H, W, C)``; returns (pose_still, latency_ms,
        pose_video or None)."""
        pose, latency_ms = self.engine.predict(image)
        pose = {k: v[0] for k, v in pose.items()}
        pose_still = _host(pose)
        pose_still["ori"], self.prev_still_ori = self._continuity(
            self.prev_still_ori, pose_still["ori"])
        pose_still = self._add_viz(pose_still)

        if video_type is None:
            return pose_still, latency_ms, None
        if video_type != "Adaptative":
            raise ValueError(f"type of video filtering not implemented: {video_type}")
        if self.spe_utils.ori_mode != "classification" or \
                self.spe_utils.pos_mode != "classification":
            raise ValueError("'Adaptative' filtering needs the classification modes")

        ori_soft, ori_dist = self.pdf_adapt_ori.update_pdf(pose["ori_soft"])
        pos_soft, pos_dist = self.pdf_adapt_pos.update_pdf(pose["pos_soft"])
        ori, _ = self.spe_utils.orientation.decode_batch(ori_soft)
        pose_video = _host({"ori_soft": ori_soft, "pos_soft": pos_soft, "ori": ori,
                            "pos": self.spe_utils.position.decode_batch(pos_soft)})
        pose_video["ori_distance"] = ori_dist
        pose_video["pos_distance"] = pos_dist
        pose_video["ori"], self.prev_video_ori = self._continuity(
            self.prev_video_ori, pose_video["ori"])
        return pose_still, latency_ms, self._add_viz(pose_video)
