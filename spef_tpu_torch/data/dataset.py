"""Dataset manifests and the host-side batch pipeline.

Counterpart of ``spef_tpu.data.dataset``: the same JSON label schemas
(quaternion key ``q`` / ``q_vbs2tango`` / ``q_vbs2tango_true``; position
``t`` / ``r_Vo2To_vbs_true``), the same numeric-filename sort (video frame
order), the same split structure per dataset, and the same batches: uint8
NHWC images, the last batch padded to full size with a ``mask`` (0 for the
padding rows), a shuffle seeded with ``seed + epoch``.

One decoder, no fallback: PNG files go through :mod:`spef_tpu_torch.data.png`
(RGB, PIL's bilinear resize).  JPEG files (SPEED, SPEED+) need the native
loader, which is not ported yet; they raise, as does the host-side rotation
augmentation (train with the device-side one, ``data/augment.py``).

:class:`CachedBatchLoader` decodes a split once and serves later epochs from
RAM, from a memmapped sidecar file on later runs, or, with
``device_resident``, from the device itself (``load_dataset(cache=True)`` /
``cache="device"``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from spef_tpu_torch.data.png import decode_png, resize_bilinear

__all__ = ["PoseRecord", "Manifest", "BatchLoader", "CachedBatchLoader", "load_dataset",
           "detect_dataset"]

_ORI_KEYS = ("q", "q_vbs2tango", "q_vbs2tango_true")
_POS_KEYS = ("t", "r_Vo2To_vbs_true")

_JPEG_TODO = ("JPEG images need the native host loader, which is not ported yet "
              "(ROADMAP §A, item 7: spef_tpu/native/impreproc.cpp)")
_AUGMENT_TODO = ("host-side rotation augmentation is not ported yet "
                 "(ROADMAP §A, item 7: data/augment_host.py); augment on the device "
                 "(data/augment.py, apps.train --device-augment)")


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


def _pad_rows(a: np.ndarray, pad: int, zeros: bool = False) -> np.ndarray:
    """``a`` with ``pad`` rows appended: zeros, or copies of its last row."""
    extra = np.zeros((pad,) + a.shape[1:], a.dtype) if zeros else np.repeat(a[-1:], pad, 0)
    return np.concatenate([a, extra])


class CachedBatchLoader(BatchLoader):
    """A BatchLoader that decodes the whole split once and serves every
    epoch from the decoded uint8 array: the same batches (padded last batch
    and ``mask``, the shuffle seeded with ``seed + epoch``).

    The decoded split (N * H * W * 3 bytes: 5.5 GB for 20,000 frames at
    240x384) is written beside the images as a sidecar ``.npy`` named by
    the split's identity and memmapped by later runs.  With
    ``device_resident`` it is copied to ``device`` once and each batch is an
    index gather there: ``images`` is then a uint8 tensor on that device
    (its padding rows zero); ``ori``, ``pos`` and ``mask`` stay numpy.
    """

    def __init__(self, *args, device_resident: bool = False,
                 device: Union[str, torch.device] = "cuda", **kw):
        super().__init__(*args, **kw)
        self.device_resident = device_resident
        self.device = torch.device(device)
        self._cache: Optional[np.ndarray] = None
        self._dev_cache: Optional[torch.Tensor] = None

    def _cache_path(self) -> Optional[str]:
        """``<images dir>/.decoded_<H>x<W>_<N>_<id>.npy``, ``id`` a short
        hash of the ordered image names, so that two splits sharing one
        images directory (the SPEED layout) with equal counts never load
        each other's array."""
        if not self.manifest.records:
            return None
        import hashlib

        img_dir = os.path.dirname(self.manifest.records[0].image_path)
        h, w = self.img_size
        ident = hashlib.sha1("\n".join(
            os.path.basename(r.image_path) for r in self.manifest.records
        ).encode()).hexdigest()[:10]
        return os.path.join(img_dir, f".decoded_{h}x{w}_{len(self.manifest)}_{ident}.npy")

    def _materialize(self) -> None:
        path = self._cache_path()
        if path and os.path.isfile(path):
            arr = np.load(path, mmap_mode="r")
            expect = (len(self.manifest),) + tuple(self.img_size) + (3,)
            # Images regenerated in place (same names and count) are caught
            # by decoding the first one again.
            first = self.manifest.records[0].image_path
            if (arr.shape == expect and arr.dtype == np.uint8
                    and np.array_equal(np.asarray(arr[0]), load_image(first, self.img_size))):
                self._cache = arr
                return
        base = BatchLoader(self.manifest, self.batch_size, self.img_size, shuffle=False,
                           n_workers=self.n_workers)
        chunks = [b["images"][:int(b["mask"].sum())] for b in base]
        self._cache = (np.concatenate(chunks) if chunks
                       else np.zeros((0,) + tuple(self.img_size) + (3,), np.uint8))
        if path:
            try:  # a read-only dataset directory keeps the split in RAM only
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    np.save(f, self._cache)
                os.replace(tmp, path)
            except OSError:
                pass

    def _device_images(self, idx: np.ndarray) -> torch.Tensor:
        """One batch gathered on the device; padding rows zero."""
        if self._dev_cache is None:
            # A memmapped sidecar is read-only: read it into memory first.
            arr = self._cache if self._cache.flags.writeable else np.array(self._cache)
            self._dev_cache = torch.from_numpy(arr).to(self.device)
        bs = self.batch_size
        rows = torch.from_numpy(np.concatenate([idx, np.zeros(bs - len(idx), idx.dtype)]))
        images = self._dev_cache.index_select(0, rows.to(self.device))
        if len(idx) < bs:
            images[len(idx):] = 0
        return images

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._cache is None:
            self._materialize()
        order = np.arange(len(self.manifest))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        recs = self.manifest.records
        oris = np.stack([r.ori for r in recs]).astype(np.float32)
        poss = np.stack([r.pos for r in recs]).astype(np.float32)
        crops = (np.stack([r.crop for r in recs]).astype(np.float32)
                 if recs and recs[0].crop is not None else None)
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs and self.drop_remainder:
                break
            pad = bs - n_valid
            if self.device_resident:
                images = self._device_images(idx)
            else:
                images = self._cache[idx]
                images = _pad_rows(images, pad, zeros=True) if pad else images
            batch = {
                "images": images,
                "ori": _pad_rows(oris[idx], pad) if pad else oris[idx],
                "pos": _pad_rows(poss[idx], pad) if pad else poss[idx],
                "mask": np.concatenate([np.ones(n_valid, np.float32),
                                        np.zeros(pad, np.float32)]),
            }
            if crops is not None:
                batch["crop"] = _pad_rows(crops[idx], pad) if pad else crops[idx]
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
    cache: Union[bool, str] = False,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, BatchLoader]:
    """One loader a split whose labels exist: :class:`CachedBatchLoader`
    with ``cache`` (``"device"``: resident on ``device``), else
    :class:`BatchLoader`."""
    cached = dict(device_resident=cache == "device", device=device) if cache else {}
    loaders = {}
    for name, (images_path, labels_path) in splits.items():
        if not os.path.isfile(labels_path):
            continue
        loaders[name] = (CachedBatchLoader if cache else BatchLoader)(
            Manifest.from_json(labels_path, images_path),
            batch_size,
            img_size,
            shuffle=shuffle and (name == "train" or not shuffle_only_train),
            seed=seed,
            n_workers=n_workers,
            rot_augment=rot_augment if name == "train" else None,
            **cached,
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
                 cache=False, device="cuda"):
    """SPEED splits: train / valid / real."""
    splits = {
        "train": (os.path.join(path, "images", "train"),
                  _speed_split_file(path, "train_no_valid.json")),
        "valid": (os.path.join(path, "images", "train"),
                  _speed_split_file(path, "valid.json")),
        "real": (os.path.join(path, "images", "real"), os.path.join(path, "real.json")),
    }
    data = _make_loaders(splits, batch_size, img_size, shuffle, seed, n_workers=16,
                         rot_augment=rot_augment, cache=cache, device=device)
    split = {"train": tuple(k for k in ("train", "valid", "real") if k in data),
             "eval": tuple(k for k in ("valid", "real") if k in data)}
    return data, split


def import_speed_plus(path, batch_size, img_size, shuffle=False, seed=1001, rot_augment=None,
                      cache=False, device="cuda"):
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
                         rot_augment=rot_augment, cache=cache, device=device)
    split = {
        "train": tuple(k for k in ("train", "valid", "sunlamp", "lightbox") if k in data),
        "eval": tuple(k for k in ("valid", "sunlamp", "lightbox") if k in data),
    }
    return data, split


def import_dspeed(path, batch_size, img_size, shuffle=False, seed=1001, rot_augment=None,
                  cache=False, device="cuda"):
    """D-SPEED still splits: train / valid / test."""
    splits = {
        name: (os.path.join(path, name, "images"), os.path.join(path, name, "pose.json"))
        for name in ("train", "valid", "test")
    }
    data = _make_loaders(splits, batch_size, img_size, shuffle, seed, n_workers=64,
                         rot_augment=rot_augment, cache=cache, device=device)
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
    cache: Union[bool, str] = False,
    device: Union[str, torch.device] = "cuda",
):
    """Dataset dispatch by path: ``(loaders by split, {"train": ..., "eval": ...})``.

    ``cache``: decode each split once and serve its epochs from RAM
    (:class:`CachedBatchLoader`); ``"device"`` keeps the decoded splits on
    ``device`` and gathers each batch there.
    """
    kind = detect_dataset(path)
    args = (path, batch_size, img_size, shuffle, seed, rot_augment, cache, device)
    if kind == "speed":
        return import_speed(*args)
    if kind == "speed_plus":
        return import_speed_plus(*args)
    if kind == "dspeed":
        return import_dspeed(*args)
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
