"""D-SPEED dataset generator: stills and the 11 kinematic video scenarios.

Counterpart of ``spef_tpu.apps.create_dspeed``: 6-DoF pose labels for a
still set (uniform random attitudes, visibility-constrained positions) and
11 video scenarios of ``--n-frames`` + 1 frames at 25 FPS, propagated with
constant velocities plus piecewise accelerations, the target moving or the
camera moving (the reference generator's scenario table and rates: 30x the
IDSS docking maxima).  ``--render`` draws the wireframe frames
(``data/synthetic.py::render_frame``) and writes them as PNG
(``data/png.py::write_png``, BGR stored as RGB, as ``cv2.imwrite`` does);
for the same labels both packages write the same pixels.

Labels are written in the loader's list schema ``[{filename, q, t}, ...]``;
``--reference-format`` adds the reference generator's dict schema.

Usage:
    python -m spef_tpu_torch.apps.create_dspeed --out experiments/create_dspeed \\
        [--n-still 60000] [--n-frames 1499] [--render] [--figures] [--skip-still] \\
        [--scenarios S TIR ...]

The frames of every folder are rendered by one pool of ``min(8, cpus - 1)``
processes (``render_images``); each folder's noise is drawn in frame order
here, so the files do not depend on that count.  ``--figures`` needs matplotlib.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from spef_tpu_torch.data.synthetic import (_NOISE_STD, _project_np, _random_quats,
                                           render_workers, write_frames)

__all__ = ["generate_still_poses", "generate_sequence", "scenario_table", "write_labels",
           "render_images", "frames_sha256", "make_figures", "main"]

# 30x the IDSS docking maxima (reference constants).
_ORI_RATE = np.array([0.24, 0.10733, 0.21466])  # deg/frame, ZYX
_POS_RATE = np.array([3 * 0.0016, 2 * 0.0016, -4 * 0.004])  # m/frame


def _np_quat_mul(qa, qb):
    q0, q1, q2, q3 = qa
    p0, p1, p2, p3 = qb
    q = np.array([
        q0 * p0 - q1 * p1 - q2 * p2 - q3 * p3,
        q0 * p1 + q1 * p0 + q2 * p3 - q3 * p2,
        q0 * p2 + q2 * p0 - q1 * p3 + q3 * p1,
        q0 * p3 + q3 * p0 + q1 * p2 - q2 * p1,
    ])
    return q / np.linalg.norm(q)


def _np_euler2quat(yaw, pitch, roll):
    cy, sy = np.cos(np.deg2rad(yaw) / 2), np.sin(np.deg2rad(yaw) / 2)
    cp, sp = np.cos(np.deg2rad(pitch) / 2), np.sin(np.deg2rad(pitch) / 2)
    cr, sr = np.cos(np.deg2rad(roll) / 2), np.sin(np.deg2rad(roll) / 2)
    q = np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])
    return q / np.linalg.norm(q)


def _np_euler2dcm(yaw, pitch, roll):
    cy, sy = np.cos(np.deg2rad(yaw)), np.sin(np.deg2rad(yaw))
    cp, sp = np.cos(np.deg2rad(pitch)), np.sin(np.deg2rad(pitch))
    cr, sr = np.cos(np.deg2rad(roll)), np.sin(np.deg2rad(roll))
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def _count_visible(q, pos, camera) -> int:
    uv = _project_np(np.asarray(q, np.float64), np.asarray(pos, np.float64), camera)
    return int(np.sum((uv[:, 0] >= 0) & (uv[:, 0] <= camera.nu)
                      & (uv[:, 1] >= 0) & (uv[:, 1] <= camera.nv)))


def generate_still_poses(n: int, camera, rng: np.random.RandomState,
                         verbose: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform random attitudes and visibility-constrained positions: z in
    [3, 35], x and y within +/-0.3 z, at least 8 visible keypoints when
    z < 5, else all 11."""
    oris = _random_quats(rng, n)
    positions = np.zeros((n, 3))
    for i in range(n):
        z = rng.uniform(3, 35)
        while True:
            x = rng.uniform(-0.3 * z, 0.3 * z)
            y = rng.uniform(-0.3 * z, 0.3 * z)
            pos = np.array([x, y, z])
            need = 8 if z < 5 else 11
            if _count_visible(oris[i], pos, camera) >= need:
                positions[i] = pos
                break
        if verbose and (i + 1) % 5000 == 0:
            print(f"still positions: {i + 1}/{n}", file=sys.stdout)
    return oris, positions


def generate_sequence(
    n_samples: int,
    initial_pose: dict,
    evolution: dict,
    camera,
    camera_movement: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Propagate a pose sequence of ``n_samples`` + 1 frames: constant
    velocities plus piecewise accelerations ``(axis, start, stop, value)``,
    the target moving or (``camera_movement``) the camera.  Asserts the
    keypoints' visibility at every frame."""
    current_ori = np.asarray(initial_pose["ori"], np.float64).copy()
    current_pos = np.asarray(initial_pose["pos"], np.float64).copy()
    ori_vel = np.asarray(evolution["ori"], np.float64).copy()
    pos_vel = np.asarray(evolution["pos"], np.float64).copy()

    oris = [current_ori.copy()]
    poss = [current_pos.copy()]

    for frame in range(n_samples):
        for axis, start, stop, value in evolution.get("pos_acceleration", []):
            if start <= frame < stop:
                pos_vel[axis] += value
        for axis, start, stop, value in evolution.get("ori_acceleration", []):
            if start <= frame < stop:
                ori_vel[axis] += value

        if camera_movement:
            current_pos = current_pos - pos_vel
            dq = _np_euler2quat(*ori_vel)
            dq_conj = dq * np.array([1.0, -1, -1, -1])
            current_ori = _np_quat_mul(dq_conj, current_ori)
            current_pos = np.linalg.inv(_np_euler2dcm(*ori_vel)) @ current_pos
        else:
            current_pos = current_pos + pos_vel
            current_ori = _np_quat_mul(current_ori, _np_euler2quat(*ori_vel))

        need = 8 if current_pos[-1] < 5 else 11
        visible = _count_visible(current_ori, current_pos, camera)
        assert visible >= need, (
            f"Satellite is not visible:\npos = {current_pos}\nori = {current_ori}\n"
            f"number of visible keypoints = {visible}"
        )
        oris.append(current_ori.copy())
        poss.append(current_pos.copy())

    return np.asarray(oris), np.asarray(poss)


def scenario_table(initial_q: np.ndarray) -> Dict[str, dict]:
    """The 11 video scenarios with the reference's parameters."""
    z15 = np.array([0.0, 0.0, 15.0])
    acc_ori_full = [
        (0, 50, 150, _ORI_RATE[0] / 100),
        (1, 250, 350, _ORI_RATE[1] / 100),
        (2, 450, 550, _ORI_RATE[2] / 100),
        (1, 650, 850, -_ORI_RATE[1] / 200),
        (2, 950, 1150, -_ORI_RATE[2] / 200),
        (0, 1250, 1450, -_ORI_RATE[0] / 200),
    ]
    acc_pos_full = [
        (0, 50, 150, -_POS_RATE[0] / 100),
        (1, 250, 350, -_POS_RATE[1] / 100),
        (2, 450, 550, -_POS_RATE[2] / 100),
        (1, 1050, 1250, _POS_RATE[1] / 200),
        (0, 1150, 1350, _POS_RATE[0] / 200),
        (2, 1250, 1450, _POS_RATE[2] / 200),
    ]
    return {
        "S": dict(init={"ori": initial_q, "pos": z15},
                  evo={"ori": np.zeros(3), "pos": np.zeros(3)}, camera=False),
        "TIR": dict(init={"ori": initial_q, "pos": z15},
                    evo={"ori": _ORI_RATE.copy(), "pos": np.zeros(3)}, camera=False),
        "TIT": dict(init={"ori": initial_q, "pos": np.array([-7.0, -4.5, 30.0])},
                    evo={"ori": np.zeros(3), "pos": _POS_RATE.copy()}, camera=False),
        "TITR": dict(init={"ori": np.array([0.0, -0.7071, 0.7071, 0.0]),
                           "pos": np.array([-7.0, -4.5, 30.0])},
                     evo={"ori": _ORI_RATE.copy(), "pos": _POS_RATE.copy()}, camera=False),
        "TAR": dict(init={"ori": initial_q, "pos": z15},
                    evo={"ori": np.zeros(3), "pos": np.zeros(3),
                         "ori_acceleration": acc_ori_full}, camera=False),
        "TAT": dict(init={"ori": initial_q, "pos": np.array([5.5, 3.0, 20.0])},
                    evo={"ori": np.zeros(3), "pos": np.zeros(3),
                         "pos_acceleration": acc_pos_full}, camera=False),
        "TATR": dict(init={"ori": initial_q, "pos": np.array([5.5, 3.0, 20.0])},
                     evo={"ori": np.zeros(3), "pos": np.zeros(3),
                          "ori_acceleration": acc_ori_full,
                          "pos_acceleration": acc_pos_full}, camera=False),
        "CIR": dict(init={"ori": initial_q, "pos": z15},
                    evo={"ori": np.array([0.24, 0.0, 0.0]), "pos": np.zeros(3)}, camera=True),
        "CAR": dict(init={"ori": initial_q, "pos": np.array([2.0, 0.0, 15.0])},
                    evo={"ori": np.zeros(3), "pos": np.zeros(3),
                         "ori_acceleration": [
                             (0, 50, 150, 0.24 / 100),
                             (0, 750, 950, -0.24 / 200),
                             (1, 1100, 1150, -0.10733 / 50),
                             (1, 1170, 1220, 0.10733 / 50),
                         ]}, camera=True),
        "CATR": dict(init={"ori": initial_q, "pos": np.array([-3.0, 0.0, 15.0])},
                     evo={"ori": np.zeros(3), "pos": np.zeros(3),
                          "ori_acceleration": [
                              (1, 25, 50, -0.24 / 25), (1, 125, 150, 0.24 / 25),
                              (1, 400, 425, -0.24 / 25), (1, 500, 525, 0.24 / 25),
                              (1, 775, 800, -0.24 / 25), (1, 875, 900, 0.24 / 25),
                              (1, 1150, 1175, -0.24 / 25), (1, 1250, 1275, 0.24 / 25),
                          ],
                          "pos_acceleration": [
                              (0, 175, 200, 0.037 / 25), (0, 350, 375, -0.037 / 25),
                              (0, 550, 575, 0.037 / 25), (0, 725, 750, -0.037 / 25),
                              (0, 925, 950, 0.037 / 25), (0, 1100, 1125, -0.037 / 25),
                              (0, 1300, 1325, 0.037 / 25), (0, 1475, 1500, -0.037 / 25),
                          ]}, camera=True),
        "Docking": dict(init={"ori": _np_euler2quat(0, 0, 0), "pos": np.array([0.0, 0.0, 9.0])},
                        evo={"ori": np.zeros(3), "pos": np.array([0.0, 0.0, 0.1 / 25])},
                        camera=True),
    }


def write_labels(folder: str, oris: np.ndarray, poss: np.ndarray,
                 reference_format: bool = False) -> None:
    os.makedirs(folder, exist_ok=True)
    labels = [
        {"filename": f"img{i:06d}.png",
         "q": np.round(oris[i], 6).tolist(),
         "t": np.round(poss[i], 6).tolist()}
        for i in range(len(oris))
    ]
    with open(os.path.join(folder, "pose.json"), "w") as f:
        json.dump(labels, f)
    if reference_format:
        ref = {
            f"{folder}/{i}.png": {"ori": np.round(oris[i], 6).tolist(),
                                  "pos": np.round(poss[i], 6).tolist()}
            for i in range(len(oris))
        }
        with open(os.path.join(folder, "pose_reference_format.json"), "w") as f:
            json.dump(ref, f)


def _frame_jobs(folder: str, oris, poss, camera, img_size):
    """The ``write_frames`` jobs of one folder, ``{folder}/images/img%06d.png``:
    each pose's frame with its noise, drawn from one ``RandomState(0)`` a
    folder in frame order as the jobs are made."""
    img_dir = os.path.join(folder, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(len(oris)):
        yield (os.path.join(img_dir, f"img{i:06d}.png"), oris[i].astype(np.float32),
               poss[i].astype(np.float32), rng.randn(*img_size, 1) * _NOISE_STD, camera,
               tuple(img_size))


def render_images(folders, camera, img_size=(1200, 1920),
                  workers: Optional[int] = None) -> int:
    """Render and write the frames of each ``(folder, oris, poss)``, all in
    one pool of ``workers`` processes (default ``render_workers()``; 1 renders
    here).  The files do not depend on the count.  Returns it."""
    workers = render_workers() if workers is None else workers
    write_frames(itertools.chain.from_iterable(
        _frame_jobs(folder, oris, poss, camera, img_size) for folder, oris, poss in folders),
        workers)
    return workers


def frames_sha256(folder: str) -> str:
    """sha256 of a folder's PNG frames, their bytes in frame order."""
    h = hashlib.sha256()
    img_dir = os.path.join(folder, "images")
    for name in sorted(os.listdir(img_dir)):
        with open(os.path.join(img_dir, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def make_figures(folder: str, oris: np.ndarray, poss: np.ndarray, title: str,
                 still: bool = False) -> None:
    """Dataset figures: per-axis attitude and distance histograms for the
    still set (``distributions.png``), attitude and position traces for a
    video sequence (``trajectory.png``).  Needs matplotlib."""
    import torch

    from spef_tpu_torch.pose.rotations import quat2euler
    from spef_tpu_torch.temporal.report import import_pyplot

    plt = import_pyplot("--figures")
    euler = quat2euler(torch.as_tensor(np.asarray(oris), dtype=torch.float32)).numpy()
    if still:
        fig, axes = plt.subplots(2, 2, figsize=(11, 8))
        for ax, i, name in zip(axes.flat, range(3), ("yaw (Z)", "pitch (Y)", "roll (X)")):
            ax.hist(euler[:, i], bins=36)
            ax.set_xlabel(f"{name} rotation [deg]")
            ax.set_ylabel("images")
        axes.flat[3].hist(np.linalg.norm(poss, axis=-1), bins=36)
        axes.flat[3].set_xlabel("satellite distance [m]")
        axes.flat[3].set_ylabel("images")
        fig.suptitle(title)
        fig.savefig(os.path.join(folder, "distributions.png"), dpi=100)
        plt.close(fig)
        return
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    for i, name in enumerate(["yaw", "pitch", "roll"]):
        axes[0].plot(euler[:, i], label=name, lw=1)
    axes[0].set_ylabel("attitude [deg]")
    axes[0].legend(fontsize=8)
    for i, name in enumerate(["x", "y", "z"]):
        axes[1].plot(poss[:, i], label=name, lw=1)
    axes[1].set_ylabel("position [m]")
    axes[1].set_xlabel("frame")
    axes[1].legend(fontsize=8)
    fig.suptitle(title)
    fig.savefig(os.path.join(folder, "trajectory.png"), dpi=100)
    plt.close(fig)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default="experiments/create_dspeed")
    parser.add_argument("--n-still", type=int, default=60000)
    parser.add_argument("--n-frames", type=int, default=1499)
    parser.add_argument("--seed", type=int, default=1001)
    parser.add_argument("--render", action="store_true", help="rasterize wireframe frames")
    parser.add_argument("--img-height", type=int, default=1200)
    parser.add_argument("--img-width", type=int, default=1920)
    parser.add_argument("--figures", action="store_true")
    parser.add_argument("--reference-format", action="store_true")
    parser.add_argument("--scenarios", nargs="*", default=None,
                        help="subset of scenarios (default: all)")
    parser.add_argument("--skip-still", action="store_true")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    from spef_tpu_torch.data.camera import DSPEED_CAMERA

    args = parse_args(argv)
    camera = DSPEED_CAMERA
    rng = np.random.RandomState(args.seed)
    os.makedirs(args.out, exist_ok=True)
    img_size = (args.img_height, args.img_width)
    rendered = []  # every folder's poses, rendered by one pool at the end

    if not args.skip_still:
        print(f"Generating {args.n_still} still poses...")
        oris, poss = generate_still_poses(args.n_still, camera, rng)
        folder = os.path.join(args.out, "still")
        write_labels(folder, oris, poss, args.reference_format)
        if args.figures:
            make_figures(folder, oris, poss, "still", still=True)
        if args.render:
            rendered.append((folder, oris, poss))
        print(f"still: {len(oris)} poses -> {folder}")

    # The videos all start from the same attitude.
    initial_q = _np_quat_mul(np.array([0.0, -0.7071, 0.7071, 0.0]),
                             np.array([1.0, 0.0, 0.0, 0.0]))
    table = scenario_table(initial_q)
    chosen = args.scenarios or list(table)
    for name in chosen:
        sc = table[name]
        oris, poss = generate_sequence(args.n_frames, sc["init"], sc["evo"], camera,
                                       camera_movement=sc["camera"])
        folder = os.path.join(args.out, name)
        write_labels(folder, oris, poss, args.reference_format)
        if args.figures:
            make_figures(folder, oris, poss, name)
        if args.render:
            rendered.append((folder, oris, poss))
        print(f"{name}: {len(oris)} frames -> {folder}")
    if rendered:
        render_images(rendered, camera, img_size)


if __name__ == "__main__":
    main()
