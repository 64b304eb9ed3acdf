"""Temporal evaluation report suite (numpy on the host).

Counterpart of ``spef_tpu.temporal.report``: nine figures a sequence

  ori_error, ori_error_per_axis, ori_histogram, ori_quat_elements,
  ori_euler_elements, pos_error, pos_error_per_axis, pos_histogram,
  pos_elements

and three aggregate workbooks (``still_metrics`` / ``video_metrics`` /
``distances``), one sheet a sequence with the rows min, max, median, mean,
std over the per-frame statistics.  The workbooks are written as one CSV a
sheet with the ``csv`` module, the files pandas' ``to_csv`` writes (no
``.xlsx``: the JAX package skips it too where no Excel engine is found).
The figures need matplotlib, imported when they are drawn; without it
``sequence_figures`` raises an ``ImportError`` that names ``--plots``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np

__all__ = [
    "compute_statistics",
    "sequence_metrics",
    "sequence_figures",
    "write_workbooks",
    "import_pyplot",
]

_STAT_ROWS = ["min", "max", "median", "mean", "std"]


def import_pyplot(flag: str):
    """matplotlib's pyplot on the Agg backend; an ``ImportError`` naming
    ``flag`` (the option that asked for figures) where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{flag} needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def compute_statistics(data) -> list:
    """[min, max, median, mean, std]."""
    a = np.asarray(data, np.float64)
    return [float(a.min()), float(a.max()), float(np.median(a)), float(a.mean()),
            float(a.std())]


def _euler_deg(quats: np.ndarray) -> np.ndarray:
    """[yaw, pitch, roll] in degrees, float32 as the JAX package computes them."""
    import torch

    from spef_tpu_torch.pose.rotations import quat2euler

    return quat2euler(torch.as_tensor(np.asarray(quats), dtype=torch.float32)).numpy()


def _euler_err(true_e: np.ndarray, pred_e: np.ndarray) -> np.ndarray:
    """Circular per-axis angle difference in degrees (T, 3)."""
    d = np.abs(true_e - pred_e) % 360.0
    return np.minimum(d, 360.0 - d)


def _ori_err_deg(q_true: np.ndarray, q_pred: np.ndarray) -> np.ndarray:
    dot = np.abs(np.sum(q_true * q_pred, axis=-1)).clip(0.0, 1.0)
    return np.degrees(2.0 * np.arccos(dot))


def sequence_metrics(
    truth_ori, truth_pos, still_ori, still_pos,
    video_ori=None, video_pos=None, ori_distance=None, pos_distance=None,
):
    """(still, video, distances) stat dicts with the reference's column
    names; video and distances empty when absent."""
    te, se = _euler_deg(truth_ori), _euler_deg(still_ori)
    eerr = _euler_err(te, se)
    perr = np.abs(np.asarray(truth_pos) - np.asarray(still_pos))
    still = {
        "ori_err": compute_statistics(_ori_err_deg(truth_ori, still_ori)),
        "ori_err_yaw": compute_statistics(eerr[:, 0]),
        "ori_err_pitch": compute_statistics(eerr[:, 1]),
        "ori_err_roll": compute_statistics(eerr[:, 2]),
        "pos_err": compute_statistics(np.linalg.norm(perr, axis=-1)),
        "pos_err_x": compute_statistics(perr[:, 0]),
        "pos_err_y": compute_statistics(perr[:, 1]),
        "pos_err_z": compute_statistics(perr[:, 2]),
    }
    video = {}
    if video_ori is not None:
        ve = _euler_deg(video_ori)
        verr = _euler_err(te, ve)
        vperr = np.abs(np.asarray(truth_pos) - np.asarray(video_pos))
        video = {
            "ori_err_video": compute_statistics(_ori_err_deg(truth_ori, video_ori)),
            "ori_err_yaw_video": compute_statistics(verr[:, 0]),
            "ori_err_pitch_video": compute_statistics(verr[:, 1]),
            "ori_err_roll_video": compute_statistics(verr[:, 2]),
            "pos_err_video": compute_statistics(np.linalg.norm(vperr, axis=-1)),
            "pos_err_x_video": compute_statistics(vperr[:, 0]),
            "pos_err_y_video": compute_statistics(vperr[:, 1]),
            "pos_err_z_video": compute_statistics(vperr[:, 2]),
        }
    distances = {}
    if ori_distance is not None:
        distances = {
            "ori_distance": compute_statistics(ori_distance),
            "pos_distance": compute_statistics(pos_distance),
        }
    return still, video, distances


def sequence_figures(
    out_dir: str, seq_name: str,
    truth_ori, truth_pos, still_ori, still_pos,
    video_ori=None, video_pos=None, ori_distance=None, pos_distance=None,
    dpi: int = 100,
):
    """Write the nine report figures of one sequence into
    ``out_dir/seq_name/``.  Needs matplotlib."""
    plt = import_pyplot("--plots")
    base = os.path.join(out_dir, seq_name)
    os.makedirs(base, exist_ok=True)
    has_video = video_ori is not None

    t_ori = np.asarray(truth_ori)
    t_pos = np.asarray(truth_pos)
    s_ori, s_pos = np.asarray(still_ori), np.asarray(still_pos)
    te, se = _euler_deg(t_ori), _euler_deg(s_ori)
    if has_video:
        v_ori, v_pos = np.asarray(video_ori), np.asarray(video_pos)
        ve = _euler_deg(v_ori)

    def _save(fig, name):
        fig.tight_layout()
        fig.savefig(os.path.join(base, f"{name}.png"), dpi=dpi)
        plt.close(fig)

    def _series(ax, still, video, ylabel):
        ax.plot(still, color="indianred", lw=1, marker=".", ms=2, label="still")
        if video is not None:
            ax.plot(video, color="royalblue", lw=1, marker=".", ms=2, label="video")
        ax.set_ylabel(ylabel)
        ax.legend(loc="upper right", fontsize=8)

    # 1/6. ori_error & pos_error (+ optional PDF-distance subplot)
    for name, still_v, video_v, dist, ylab in (
        ("ori_error", _ori_err_deg(t_ori, s_ori),
         _ori_err_deg(t_ori, v_ori) if has_video else None, ori_distance,
         "orientation error [deg]"),
        ("pos_error", np.linalg.norm(t_pos - s_pos, axis=-1),
         np.linalg.norm(t_pos - v_pos, axis=-1) if has_video else None, pos_distance,
         "position error [m]"),
    ):
        n_sub = 2 if dist is not None else 1
        fig, axes = plt.subplots(n_sub, 1, figsize=(12, 3 * n_sub), sharex=True,
                                 squeeze=False)
        _series(axes[0][0], still_v, video_v, ylab)
        if dist is not None:
            axes[-1][0].plot(np.asarray(dist), color="indianred", lw=1)
            axes[-1][0].set_ylabel(f"{name.split('_')[0]} PDF distance")
        axes[-1][0].set_xlabel("frame")
        _save(fig, name)

    # 2. ori_error_per_axis  /  3. ori_histogram
    eerr_s = _euler_err(te, se)
    eerr_v = _euler_err(te, ve) if has_video else None
    angles = ("yaw", "pitch", "roll")
    fig, axes = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    for i, ax in enumerate(axes):
        _series(ax, eerr_s[:, i], eerr_v[:, i] if has_video else None,
                f"{angles[i]} error [deg]")
    axes[-1].set_xlabel("frame")
    _save(fig, "ori_error_per_axis")

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    for i, ax in enumerate(axes):
        ax.hist(eerr_s[:, i], bins=36, color="lightcoral", alpha=0.6, label="still")
        if has_video:
            ax.hist(eerr_v[:, i], bins=36, color="skyblue", alpha=0.6, label="video")
        ax.set_xlabel(f"{angles[i]} error [deg]")
        ax.legend(fontsize=8)
    _save(fig, "ori_histogram")

    # 4. ori_quat_elements / 5. ori_euler_elements
    fig, axes = plt.subplots(4, 1, figsize=(12, 10), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(t_ori[:, i], color="limegreen", lw=1, label="true")
        _series(ax, s_ori[:, i], v_ori[:, i] if has_video else None,
                f"quaternion q{i}")
    axes[-1].set_xlabel("frame")
    _save(fig, "ori_quat_elements")

    fig, axes = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(te[:, i], color="limegreen", lw=1, label="true")
        _series(ax, se[:, i], ve[:, i] if has_video else None, f"{angles[i]} [deg]")
    axes[-1].set_xlabel("frame")
    _save(fig, "ori_euler_elements")

    # 7. pos_error_per_axis / 8. pos_histogram / 9. pos_elements
    axes_names = ("x", "y", "z")
    fig, axes = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    for i, ax in enumerate(axes):
        _series(ax, s_pos[:, i] - t_pos[:, i],
                (v_pos[:, i] - t_pos[:, i]) if has_video else None,
                f"{axes_names[i]} error [m]")
    axes[-1].set_xlabel("frame")
    _save(fig, "pos_error_per_axis")

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.5))
    for i, ax in enumerate(axes):
        ax.hist(t_pos[:, i] - s_pos[:, i], bins=36, color="lightcoral", alpha=0.6,
                label="still")
        if has_video:
            ax.hist(t_pos[:, i] - v_pos[:, i], bins=36, color="skyblue", alpha=0.6,
                    label="video")
        ax.set_xlabel(f"{axes_names[i]} error [m]")
        ax.legend(fontsize=8)
    _save(fig, "pos_histogram")

    fig, axes = plt.subplots(3, 1, figsize=(12, 8), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(t_pos[:, i], color="limegreen", lw=1, label="true")
        _series(ax, s_pos[:, i], v_pos[:, i] if has_video else None,
                f"{axes_names[i]} [m]")
    axes[-1].set_xlabel("frame")
    _save(fig, "pos_elements")
    return base


def write_workbooks(
    out_dir: str,
    still_metrics: Dict[str, Dict],
    video_metrics: Dict[str, Dict],
    distances: Dict[str, Dict],
):
    """The three aggregate workbooks: ``{book}_{sequence}.csv`` a sheet, its
    header row an empty cell and the metric names, one row a statistic."""
    os.makedirs(out_dir, exist_ok=True)
    books = {"still_metrics": still_metrics, "video_metrics": video_metrics,
             "distances": distances}
    for book, sheets in books.items():
        for seq, cols in sheets.items():
            if not cols:
                continue
            with open(os.path.join(out_dir, f"{book}_{seq}.csv"), "w", newline="") as f:
                writer = csv.writer(f, lineterminator="\n")
                writer.writerow(["", *cols])
                for i, row in enumerate(_STAT_ROWS):
                    writer.writerow([row, *(v[i] for v in cols.values())])
    return out_dir
