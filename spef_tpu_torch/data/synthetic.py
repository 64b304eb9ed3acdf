"""Synthetic wireframe Tango frames with exact poses — counterpart of
``spef_tpu.data.synthetic`` (``generate_positions`` and ``render_frame``).

The pose sampling mirrors the reference's D-SPEED generator: uniform random
orientations, positions with z in [3, 35] and x, y within +/-0.3 z, at least
8 of the 11 keypoints inside the frame.  A frame is the wireframe of those
keypoints, each edge in its own colour, drawn anti-aliased
(:mod:`spef_tpu_torch.data.raster`, OpenCV's drawing in plain Python), plus
Gaussian noise.  For the same random state both packages give the same
frames bit for bit; the calibration of the int8 graph runs on them.

The dataset writers (``create_synthetic_dataset``, ``create_crop_dataset``,
``create_synthetic_video``) write the frames as PNG through
:func:`spef_tpu_torch.data.png.write_png`, which stores OpenCV's BGR arrays
as RGB, as ``cv2.imwrite`` does: a frame read back from the dataset is in
the channel order the model was trained on, ``render_frame(...)[..., ::-1]``.
Rendering draws nothing from the caller's ``rng`` but the frame's noise,
``rng.randn(h, w, 1)``, after the wireframe; the draws keep the JAX
writers' order.
"""

from __future__ import annotations

import collections
import json
import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from typing import Optional, Tuple

import numpy as np

from spef_tpu_torch.codec.keypoints import TANGO_3D_KEYPOINTS
from spef_tpu_torch.data.camera import DSPEED_CAMERA, Camera
from spef_tpu_torch.data.png import write_png
from spef_tpu_torch.data.raster import Canvas

__all__ = ["TANGO_3D_KEYPOINTS", "generate_positions", "render_frame",
           "create_synthetic_dataset", "create_crop_dataset", "create_synthetic_video"]

# Wireframe edges over the 11 keypoints (top face, bottom face, pillars,
# antenna tips to the nearest top corners).
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # top plate
    (4, 5), (5, 6), (6, 7), (7, 4),  # bottom plate
    (0, 4), (1, 5), (2, 6), (3, 7),  # pillars
    (1, 8), (2, 9), (3, 10),  # antennas
]


def _project_np(q: np.ndarray, pos: np.ndarray, camera: Camera) -> np.ndarray:
    """Projection of the 11 keypoints -> (11, 2) pixels."""
    q0, q1, q2, q3 = q
    r = np.array(
        [
            [2 * q0**2 - 1 + 2 * q1**2, 2 * q1 * q2 - 2 * q0 * q3, 2 * q1 * q3 + 2 * q0 * q2],
            [2 * q1 * q2 + 2 * q0 * q3, 2 * q0**2 - 1 + 2 * q2**2, 2 * q2 * q3 - 2 * q0 * q1],
            [2 * q1 * q3 - 2 * q0 * q2, 2 * q2 * q3 + 2 * q0 * q1, 2 * q0**2 - 1 + 2 * q3**2],
        ]
    )
    xyz = TANGO_3D_KEYPOINTS @ r.T + pos
    k = camera.K
    u = k[0, 0] * xyz[:, 0] / xyz[:, 2] + k[0, 2]
    v = k[1, 1] * xyz[:, 1] / xyz[:, 2] + k[1, 2]
    return np.stack([u, v], axis=-1)


def _random_quats(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Shoemake uniform quaternions."""
    x0, x1, x2 = rng.rand(n), rng.rand(n), rng.rand(n)
    t1, t2 = 2 * np.pi * x1, 2 * np.pi * x2
    r1, r2 = np.sqrt(1 - x0), np.sqrt(x0)
    return np.stack([np.sin(t1) * r1, np.cos(t1) * r1, np.sin(t2) * r2, np.cos(t2) * r2], -1)


def generate_positions(
    rng: np.random.RandomState,
    n: int,
    camera: Camera = DSPEED_CAMERA,
    z_range: Tuple[float, float] = (3.0, 35.0),
    min_visible: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (ori, pos) pairs under the visibility constraint, by rejection."""
    oris, poss = [], []
    while len(oris) < n:
        q = _random_quats(rng, 1)[0]
        z = rng.uniform(*z_range)
        x = rng.uniform(-0.3, 0.3) * z
        y = rng.uniform(-0.3, 0.3) * z
        pos = np.array([x, y, z], np.float32)
        uv = _project_np(q, pos, camera)
        visible = np.sum(
            (uv[:, 0] >= 0) & (uv[:, 0] < camera.nu) & (uv[:, 1] >= 0) & (uv[:, 1] < camera.nv)
        )
        if visible >= min_visible:
            oris.append(q.astype(np.float32))
            poss.append(pos)
    return np.stack(oris), np.stack(poss)


def _wireframe(
    q: np.ndarray,
    pos: np.ndarray,
    camera: Camera,
    img_size: Tuple[int, int],
    window: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The noise-free frame of :func:`render_frame`."""
    h, w = img_size
    uv = _project_np(q, pos, camera)
    if window is not None:
        cx, cy, s = float(window[0]), float(window[1]), float(window[2])
        un = uv[:, 0] / camera.nu
        vn = uv[:, 1] / camera.nv
        uv = np.stack([(un - (cx - s / 2)) / s * w, (vn - (cy - s / 2)) / s * h], -1)
        sx, sy = w / (camera.nu * s), h / (camera.nv * s)
    else:
        sx, sy = w / camera.nu, h / camera.nv
        uv = np.stack([uv[:, 0] * sx, uv[:, 1] * sy], -1)

    canvas = Canvas(h, w)
    depth = float(pos[2])
    thickness = max(1, int(round(60.0 / depth * min(sx, sy) * 3)))
    # Distinct colours per edge: a plain grey wireframe is nearly symmetric
    # under 180-degree flips, which makes orientation unlearnable.
    edge_rng = np.random.RandomState(42)
    edge_colors = edge_rng.randint(80, 256, (len(_EDGES), 3)).tolist()
    for (a, b), color in zip(_EDGES, edge_colors):
        pa = tuple(int(c) for c in np.round(uv[a]).astype(int))
        pb = tuple(int(c) for c in np.round(uv[b]).astype(int))
        canvas.line(pa, pb, [int(c) for c in color], thickness)
    point_colors = edge_rng.randint(100, 256, (uv.shape[0], 3)).tolist()
    for i in range(uv.shape[0]):
        p = tuple(int(c) for c in np.round(uv[i]).astype(int))
        canvas.filled_circle(p, thickness + 1, [int(c) for c in point_colors[i]])
    return np.frombuffer(bytes(canvas.buf), np.uint8).reshape(h, w, 3).copy()


def _add_noise(img: np.ndarray, noise: np.ndarray) -> np.ndarray:
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def render_frame(
    q: np.ndarray,
    pos: np.ndarray,
    camera: Camera = DSPEED_CAMERA,
    img_size: Tuple[int, int] = (1200, 1920),
    noise_std: float = 6.0,
    rng: Optional[np.random.RandomState] = None,
    window: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Render one wireframe frame (H, W, 3) uint8, in OpenCV's BGR order, at
    camera resolution scaled to ``img_size`` (H, W).

    ``window``: an optional normalized crop window ``[cx, cy, s]`` rendered
    to ``img_size`` in place of the full frame (an ideal sensor crop).
    """
    img = _wireframe(q, pos, camera, img_size, window)
    if noise_std > 0:
        rng = rng or np.random.RandomState(0)
        img = _add_noise(img, rng.randn(*img_size, 1) * noise_std)
    return img


# ---------------------------------------------------------------------------
# Dataset writers
# ---------------------------------------------------------------------------

_NOISE_STD = 6.0  # render_frame's default, which the JAX writers use


def _render_and_write(path: str, q: np.ndarray, pos: np.ndarray, noise: np.ndarray,
                      camera: Camera, img_size: Tuple[int, int]) -> None:
    """One still: the wireframe, its noise (drawn by the caller, in order)
    and the PNG.  Runs in a worker process of :func:`_write_still_split`."""
    write_png(path, _add_noise(_wireframe(q, pos, camera, img_size), noise))


def render_workers() -> int:
    """The render processes a writer uses by default: one a core but one,
    at most 8."""
    return max(1, min(8, (os.cpu_count() or 1) - 1))


def write_frames(jobs, workers: int = 1) -> None:
    """Run :func:`_render_and_write` on each job ``(path, q, pos, noise,
    camera, img_size)``, in that many spawned processes where ``workers`` >
    1.  The caller draws each frame's noise, in order, as it makes the job:
    the files do not depend on ``workers``."""
    if workers <= 1:
        for job in jobs:
            _render_and_write(*job)
        return
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        pending = collections.deque()
        for job in jobs:  # at most 4 frames a worker in flight
            pending.append(pool.submit(_render_and_write, *job))
            if len(pending) > 4 * workers:
                pending.popleft().result()
        for fut in pending:
            fut.result()


def _write_still_split(still: str, split: str, n: int, rng: np.random.RandomState,
                       img_size: Tuple[int, int], camera: Camera, workers: int = 1) -> None:
    """``{still}/{split}/images/img%06d.png`` + ``pose.json``.  The noise is
    drawn here, frame after frame; with ``workers`` > 1 the frames are drawn
    and written in that many processes."""
    img_dir = os.path.join(still, split, "images")
    os.makedirs(img_dir, exist_ok=True)
    oris, poss = generate_positions(rng, n, camera)
    write_frames(((os.path.join(img_dir, f"img{i:06d}.png"), oris[i], poss[i],
                   rng.randn(*img_size, 1) * _NOISE_STD, camera, img_size) for i in range(n)),
                 workers)
    labels = [{"filename": f"img{i:06d}.png", "q": oris[i].tolist(), "t": poss[i].tolist()}
              for i in range(n)]
    with open(os.path.join(still, split, "pose.json"), "w") as f:
        json.dump(labels, f)


def create_synthetic_dataset(
    root: str,
    n_train: int = 64,
    n_valid: int = 16,
    n_test: int = 16,
    img_size: Tuple[int, int] = (1200, 1920),
    seed: int = 1001,
    camera: Camera = DSPEED_CAMERA,
    workers: int = 1,
) -> str:
    """Write a D-SPEED-still-layout dataset: {split}/images/*.png + pose.json.
    ``workers`` > 1 renders and writes in that many processes (the draws
    stay in order on the caller's thread: the same files)."""
    rng = np.random.RandomState(seed)
    still = os.path.join(root, "still")
    for split, n in (("train", n_train), ("valid", n_valid), ("test", n_test)):
        _write_still_split(still, split, n, rng, img_size, camera, workers)
    return still


def _create_test_split(
    root: str,
    n_train: int,
    n_valid: int,
    n_test: int,
    img_size: Tuple[int, int] = (1200, 1920),
    seed: int = 1001,
    camera: Camera = DSPEED_CAMERA,
    workers: int = 1,
) -> str:
    """The test split of ``create_synthetic_dataset(root, n_train, n_valid,
    n_test, img_size, seed, camera)``, and only it: the train and valid
    splits' draws (their poses, then one noise field a frame) are replayed in
    the writer's order, not rendered.  ``workers`` > 1 renders and writes in
    that many processes; the draws stay here, in order."""
    rng = _replayed(seed, (n_train, n_valid), img_size, camera)
    still = os.path.join(root, "still")
    _write_still_split(still, "test", n_test, rng, img_size, camera, workers)
    return still


def _create_eval_splits(
    valid_root: str,
    test_root: str,
    n_train: int,
    n_valid: int,
    n_test: int,
    img_size: Tuple[int, int] = (1200, 1920),
    seed: int = 1001,
    camera: Camera = DSPEED_CAMERA,
    workers: int = 1,
) -> Tuple[str, str]:
    """The valid and test splits of ``create_synthetic_dataset(root, n_train,
    n_valid, n_test, img_size, seed, camera)``, and only them: the train
    split's draws are replayed once, as :func:`_create_test_split` replays
    the earlier ones, then the valid split is written under
    ``valid_root/still`` and the test split under ``test_root/still`` (one
    root may hold both), in the writer's order.  ``workers`` > 1 renders and
    writes in that many processes.  Returns the two still roots."""
    rng = _replayed(seed, (n_train,), img_size, camera)
    valid, test = os.path.join(valid_root, "still"), os.path.join(test_root, "still")
    _write_still_split(valid, "valid", n_valid, rng, img_size, camera, workers)
    _write_still_split(test, "test", n_test, rng, img_size, camera, workers)
    return valid, test


def _replayed(seed: int, counts: Tuple[int, ...], img_size: Tuple[int, int],
              camera: Camera) -> np.random.RandomState:
    """The writer's generator after the splits of ``counts``: their poses,
    then one noise field a frame, drawn in the writer's order and dropped."""
    rng = np.random.RandomState(seed)
    for n in counts:
        generate_positions(rng, n, camera)
        for _ in range(n):
            rng.randn(*img_size, 1)
    return rng


def create_crop_dataset(
    still_root: str,
    out_root: Optional[str] = None,
    img_size: Tuple[int, int] = (240, 384),
    margin: float = 1.25,
    jitter_scale: Tuple[float, float] = (1.05, 1.5),
    jitter_center: float = 0.08,
    min_size: float = 0.2,
    seed: int = 1001,
    camera: Camera = DSPEED_CAMERA,
    splits: Tuple[str, ...] = ("train", "valid", "test"),
    n_jitter: int = 1,
) -> str:
    """Derive a crop-refine training set from an existing still dataset.

    Reads each split's ``pose.json`` under ``still_root`` and renders the
    ground-truth-box crop window of every frame at ``img_size``, jittered on
    the train split to simulate first-pass detector noise (``n_jitter``
    windows a train frame, a ``j{v}_`` filename prefix where there are
    several).  Labels carry the window as ``crop: [cx, cy, s]``;
    ``min_size`` floors it so renders never sample finer than the sensor.
    """
    rng = np.random.RandomState(seed)
    out_root = out_root or os.path.join(os.path.dirname(still_root.rstrip("/")), "crop")
    for split in splits:
        labels_path = os.path.join(still_root, split, "pose.json")
        if not os.path.isfile(labels_path):
            continue
        with open(labels_path) as f:
            labels = json.load(f)
        img_dir = os.path.join(out_root, split, "images")
        os.makedirs(img_dir, exist_ok=True)
        out_labels = []
        for t in labels:
            q = np.asarray(t["q"], np.float64)
            pos = np.asarray(t["t"], np.float64)
            uv = _project_np(q, pos, camera)
            # The spacecraft-frame origin, at `pos` in the camera frame, is
            # one of the label points.
            k = camera.K
            u0 = k[0, 0] * pos[0] / pos[2] + k[0, 2]
            v0 = k[1, 1] * pos[1] / pos[2] + k[1, 2]
            un = np.concatenate([[u0], uv[:, 0]]) / camera.nu
            vn = np.concatenate([[v0], uv[:, 1]]) / camera.nv
            cx0 = (un.min() + un.max()) / 2
            cy0 = (vn.min() + vn.max()) / 2
            s0 = max(un.max() - un.min(), vn.max() - vn.min()) * margin
            variants = n_jitter if split == "train" else 1
            for v in range(variants):
                cx, cy, s = cx0, cy0, s0
                if split == "train":
                    s *= rng.uniform(*jitter_scale)
                    cx += rng.uniform(-jitter_center, jitter_center) * s
                    cy += rng.uniform(-jitter_center, jitter_center) * s
                else:
                    s *= 1.2  # deterministic eval-style margin
                s = float(np.clip(s, min_size, 1.0))
                cx = float(np.clip(cx, s / 2, 1 - s / 2))
                cy = float(np.clip(cy, s / 2, 1 - s / 2))
                window = np.array([cx, cy, s], np.float32)
                frame = render_frame(q, pos, camera, img_size, rng=rng, window=window)
                fname = t["filename"] if variants == 1 else f"j{v}_{t['filename']}"
                write_png(os.path.join(img_dir, fname), frame)
                out_labels.append({"filename": fname, "q": t["q"], "t": t["t"],
                                   "crop": window.tolist()})
        with open(os.path.join(out_root, split, "pose.json"), "w") as f:
            json.dump(out_labels, f)
    return out_root


def create_synthetic_video(
    root: str,
    n_frames: int = 50,
    img_size: Tuple[int, int] = (1200, 1920),
    seed: int = 7,
    camera: Camera = DSPEED_CAMERA,
    omega_deg: float = 2.0,
    seq_name: str = "seq_000",
) -> str:
    """Write one constant-rate tumble sequence in the D-SPEED video layout."""
    import torch

    from spef_tpu_torch.pose.rotations import euler2quat, multiply_quaternions

    rng = np.random.RandomState(seed)
    video = os.path.join(root, "video")
    seq_dir = os.path.join(video, seq_name, "images")
    os.makedirs(seq_dir, exist_ok=True)

    q, pos = generate_positions(rng, 1, camera)
    q, pos = q[0], pos[0]
    dq = euler2quat(torch.tensor([omega_deg, 0.0, 0.0], dtype=torch.float32))
    labels = []
    for i in range(n_frames):
        fname = f"img{i:06d}.png"
        write_png(os.path.join(seq_dir, fname), render_frame(q, pos, camera, img_size, rng=rng))
        labels.append({"filename": fname, "q": q.tolist(), "t": pos.tolist()})
        q = multiply_quaternions(dq, torch.from_numpy(q)).numpy()
    with open(os.path.join(video, seq_name, "pose.json"), "w") as f:
        json.dump(labels, f)
    return video
