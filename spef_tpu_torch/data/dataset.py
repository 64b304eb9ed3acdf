"""Dataset manifests and the host-side batch pipeline.

Counterpart of ``spef_tpu.data.dataset``: the same JSON label schemas
(quaternion key ``q`` / ``q_vbs2tango`` / ``q_vbs2tango_true``; position
``t`` / ``r_Vo2To_vbs_true``), the same numeric-filename sort (video frame
order), the same split structure per dataset, and the same batches: uint8
NHWC images, the last batch padded to full size with a ``mask`` (0 for the
padding rows), a shuffle seeded with ``seed + epoch``.

One decoder, no fallback: PNG files go through :mod:`spef_tpu_torch.data.png`
(RGB, PIL's bilinear resize).  JPEG files (SPEED, SPEED+) need the native
loader, which is not ported yet; they raise, as do the host-side rotation
augmentation and the decoded-split cache.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from spef_tpu_torch.data.png import decode_png, resize_bilinear

__all__ = ["PoseRecord", "Manifest", "BatchLoader", "load_dataset", "detect_dataset"]

_ORI_KEYS = ("q", "q_vbs2tango", "q_vbs2tango_true")
_POS_KEYS = ("t", "r_Vo2To_vbs_true")

_JPEG_TODO = ("JPEG images need the native host loader, which is not ported yet "
              "(ROADMAP §A, item 7: spef_tpu/native/impreproc.cpp)")
_AUGMENT_TODO = ("host-side rotation augmentation is not ported yet "
                 "(ROADMAP §A, item 7: data/augment_host.py)")
_CACHE_TODO = "the decoded-split cache is not ported yet (ROADMAP §A, item 6: CachedBatchLoader)"


def _image_number(path: str) -> int:
    digits = re.sub(r"[^0-9]", "", os.path.basename(path))
    return int(digits) if digits else 0


@dataclasses.dataclass
class PoseRecord:
    image_path: str
    ori: np.ndarray  # (4,)
    pos: np.ndarray  # (3,)
    # Optional crop window [cx, cy, s] (normalized full-frame coordinates)
    # of crop-refine datasets: the stored image is this window of the frame.
    crop: Optional[np.ndarray] = None


@dataclasses.dataclass
class Manifest:
    """A sorted list of (image, pose) records loaded from a labels JSON."""

    records: List[PoseRecord]

    @classmethod
    def from_json(cls, labels_path: str, images_path: str) -> "Manifest":
        with open(labels_path) as f:
            targets = json.load(f)
        ori_key = next((k for k in _ORI_KEYS if k in targets[0]), None)
        pos_key = next((k for k in _POS_KEYS if k in targets[0]), None)
        if not (ori_key and pos_key):
            raise ValueError(f"Unrecognized label schema in {labels_path}")
        records = [
            PoseRecord(
                image_path=os.path.join(images_path, t["filename"]),
                ori=np.asarray(t[ori_key], np.float32),
                pos=np.asarray(t[pos_key], np.float32),
                crop=(np.asarray(t["crop"], np.float32) if "crop" in t else None),
            )
            for t in targets
        ]
        # Numeric-filename sort: video frame order.
        records.sort(key=lambda r: _image_number(r.image_path))
        return cls(records)

    def __len__(self) -> int:
        return len(self.records)


def load_image(path: str, img_size: Tuple[int, int]) -> np.ndarray:
    """Read an image file and resize it to ``img_size`` (H, W): uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        raise NotImplementedError(f"{path}: {_JPEG_TODO}")
    return resize_bilinear(decode_png(data), img_size)


class BatchLoader:
    """Host-side batch iterator yielding padded, masked uint8 batches.

    Yields dicts: ``images`` (B,H,W,3) uint8, ``ori`` (B,4), ``pos`` (B,3),
    ``mask`` (B,) float32 (0 for padding rows of the final batch), and
    ``crop`` (B,3) where the records carry crop windows.
    """

    def __init__(
        self,
        manifest: Manifest,
        batch_size: int,
        img_size: Tuple[int, int] = (240, 384),
        shuffle: bool = False,
        seed: int = 1001,
        n_workers: int = 16,
        drop_remainder: bool = False,
        rot_augment=None,
    ):
        if rot_augment is not None:
            raise NotImplementedError(_AUGMENT_TODO)
        self.manifest = manifest
        self.batch_size = batch_size
        self.img_size = tuple(img_size)
        self.shuffle = shuffle
        self.seed = seed
        self.n_workers = n_workers
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.manifest)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def n_samples(self) -> int:
        return len(self.manifest)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.manifest))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        bs = self.batch_size
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            for start in range(0, len(order), bs):
                idx = order[start:start + bs]
                if len(idx) < bs and self.drop_remainder:
                    break
                recs = [self.manifest.records[i] for i in idx]
                images = list(pool.map(lambda r: load_image(r.image_path, self.img_size), recs))
                n_valid = len(recs)
                oris = [r.ori for r in recs]
                poss = [r.pos for r in recs]
                crops = [r.crop for r in recs] if recs[0].crop is not None else None
                if n_valid < bs:  # pad to full batch, mask invalid rows
                    pad = bs - n_valid
                    images += [np.zeros_like(images[0])] * pad
                    oris += [oris[-1]] * pad
                    poss += [poss[-1]] * pad
                    if crops is not None:
                        crops += [crops[-1]] * pad
                batch = {
                    "images": np.stack(images),
                    "ori": np.stack(oris),
                    "pos": np.stack(poss),
                    "mask": np.concatenate(
                        [np.ones(n_valid, np.float32), np.zeros(bs - n_valid, np.float32)]),
                }
                if crops is not None:
                    batch["crop"] = np.stack(crops)
                yield batch


# ---------------------------------------------------------------------------
# Per-dataset importers
# ---------------------------------------------------------------------------


def _make_loaders(
    splits: Dict[str, Tuple[str, str]],
    batch_size: int,
    img_size,
    shuffle: bool,
    seed: int,
    n_workers: int,
    shuffle_only_train: bool = True,
    rot_augment=None,
    cache: bool = False,
) -> Dict[str, BatchLoader]:
    if cache:
        raise NotImplementedError(_CACHE_TODO)
    loaders = {}
    for name, (images_path, labels_path) in splits.items():
        if not os.path.isfile(labels_path):
            continue
        loaders[name] = BatchLoader(
            Manifest.from_json(labels_path, images_path),
            batch_size,
            img_size,
            shuffle=shuffle and (name == "train" or not shuffle_only_train),
            seed=seed,
            n_workers=n_workers,
            rot_augment=rot_augment if name == "train" else None,
        )
    return loaders


#: The reference train/valid split of SPEED (10,200 / 1,800 entries), a copy
#: of ``spef_tpu/data/speed_split/``.
SPEED_SPLIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "speed_split")


def _speed_split_file(path: str, name: str) -> str:
    """Per-dataset split override if present, else the bundled reference split."""
    local = os.path.join(path, name)
    return local if os.path.isfile(local) else os.path.join(SPEED_SPLIT_DIR, name)


def import_speed(path, batch_size, img_size, shuffle=False, seed=1001, rot_augment=None,
                 cache=False):
    """SPEED splits: train / valid / real."""
    splits = {
        "train": (os.path.join(path, "images", "train"),
                  _speed_split_file(path, "train_no_valid.json")),
        "valid": (os.path.join(path, "images", "train"),
                  _speed_split_file(path, "valid.json")),
        "real": (os.path.join(path, "images", "real"), os.path.join(path, "real.json")),
    }
    data = _make_loaders(splits, batch_size, img_size, shuffle, seed, n_workers=16,
                         rot_augment=rot_augment, cache=cache)
    split = {"train": tuple(k for k in ("train", "valid", "real") if k in data),
             "eval": tuple(k for k in ("valid", "real") if k in data)}
    return data, split


def import_speed_plus(path, batch_size, img_size, shuffle=False, seed=1001, rot_augment=None,
                      cache=False):
    """SPEED+ splits: train / valid / sunlamp / lightbox."""
    sy = os.path.join(path, "synthetic")
    splits = {
        "train": (os.path.join(sy, "images"), os.path.join(sy, "train.json")),
        "valid": (os.path.join(sy, "images"), os.path.join(sy, "validation.json")),
        "sunlamp": (os.path.join(path, "sunlamp", "images"),
                    os.path.join(path, "sunlamp", "test.json")),
        "lightbox": (os.path.join(path, "lightbox", "images"),
                     os.path.join(path, "lightbox", "test.json")),
    }
    data = _make_loaders(splits, batch_size, img_size, shuffle, seed, n_workers=16,
                         rot_augment=rot_augment, cache=cache)
    split = {
        "train": tuple(k for k in ("train", "valid", "sunlamp", "lightbox") if k in data),
        "eval": tuple(k for k in ("valid", "sunlamp", "lightbox") if k in data),
    }
    return data, split


def import_dspeed(path, batch_size, img_size, shuffle=False, seed=1001, rot_augment=None,
                  cache=False):
    """D-SPEED still splits: train / valid / test."""
    splits = {
        name: (os.path.join(path, name, "images"), os.path.join(path, name, "pose.json"))
        for name in ("train", "valid", "test")
    }
    data = _make_loaders(splits, batch_size, img_size, shuffle, seed, n_workers=64,
                         rot_augment=rot_augment, cache=cache)
    split = {"train": tuple(k for k in ("train", "valid", "test") if k in data),
             "eval": tuple(k for k in ("valid", "test") if k in data)}
    return data, split


def import_dspeed_video(path, batch_size, img_size):
    """D-SPEED video: one ordered loader per sequence directory."""
    data = {}
    for seq in sorted(os.listdir(path)):
        seq_dir = os.path.join(path, seq)
        labels = os.path.join(seq_dir, "pose.json")
        if not os.path.isfile(labels):
            continue
        manifest = Manifest.from_json(labels, os.path.join(seq_dir, "images"))
        data[seq] = BatchLoader(manifest, batch_size, img_size, shuffle=False, n_workers=8)
    split = {"eval": tuple(data.keys())}
    return data, split


def load_dataset(
    path: str,
    batch_size: int = 1,
    img_size: Tuple[int, int] = (240, 384),
    shuffle: bool = False,
    seed: int = 1001,
    rot_augment=None,
    cache: bool = False,
):
    """Dataset dispatch by path: ``(loaders by split, {"train": ..., "eval": ...})``."""
    kind = detect_dataset(path)
    if kind == "speed":
        return import_speed(path, batch_size, img_size, shuffle, seed, rot_augment, cache)
    if kind == "speed_plus":
        return import_speed_plus(path, batch_size, img_size, shuffle, seed, rot_augment, cache)
    if kind == "dspeed":
        return import_dspeed(path, batch_size, img_size, shuffle, seed, rot_augment, cache)
    return import_dspeed_video(path, batch_size, img_size)


def detect_dataset(path: str) -> str:
    """Dataset family from the path / layout: speed / speed_plus / dspeed /
    dspeed_video; raises for unrecognized layouts."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Dataset path {path} does not exist")
    name = os.path.split(path.rstrip("/"))[-1]
    if name in ("speed", "speed_plus"):
        return name
    if "dspeed" in path and name == "still":
        return "dspeed"
    if name == "video":
        return "dspeed_video"
    # Any directory holding a train/ split behaves like dspeed-still;
    # per-sequence directories each with their own pose.json (the video
    # layout) go to the video importer, however the root is named.
    if os.path.isdir(os.path.join(path, "train")):
        return "dspeed"
    if _looks_like_video_root(path):
        return "dspeed_video"
    raise ValueError(f"Dataset {name} not implemented")


def _looks_like_video_root(path: str) -> bool:
    """True if ``path`` holds per-sequence dirs each with its own pose.json."""
    subdirs = [d for d in sorted(os.listdir(path)) if os.path.isdir(os.path.join(path, d))]
    return bool(subdirs) and all(
        os.path.isfile(os.path.join(path, d, "pose.json")) for d in subdirs)
