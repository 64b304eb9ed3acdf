"""Dataset manifests and the host-side batch pipeline.

Counterpart of ``spef_tpu.data.dataset``: the same JSON label schemas
(quaternion key ``q`` / ``q_vbs2tango`` / ``q_vbs2tango_true``; position
``t`` / ``r_Vo2To_vbs_true``), the same numeric-filename sort (video frame
order), the same split structure per dataset, and the same batches: uint8
NHWC images, the last batch padded to full size with a ``mask`` (0 for the
padding rows), a shuffle seeded with ``seed + epoch``.

The decoder is chosen explicitly, once, and recorded (``decoder``):

  * ``"native"``: :mod:`spef_tpu_torch.native`, the port's copy of JAX's
    threaded libjpeg / libpng loader and its bilinear resize (it samples,
    where PIL filters when it downscales).  It reads JPEG (SPEED, SPEED+)
    and PNG.
  * ``"png"``: :mod:`spef_tpu_torch.data.png` (RGB, PIL's bilinear resize),
    PNG only: a JPEG file raises, naming what the native loader lacks here.
  * ``"auto"`` (the default) resolves to ``"native"`` where g++, the
    headers and the libraries are present (:func:`native.missing` checks
    them, nothing is inferred from a failed build), else to ``"png"``: the
    choice JAX's loader makes on the same machine, so both packages decode
    a frame to the same pixels.

No decoder falls back to the other.  ``rot_augment`` (a
:class:`~spef_tpu_torch.data.augment_host.HostRotationAugment`) warps the
train frames on the host, as JAX's loader does.

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

from spef_tpu_torch import native
from spef_tpu_torch.data.png import decode_png, resize_bilinear

__all__ = ["PoseRecord", "Manifest", "BatchLoader", "CachedBatchLoader", "load_dataset",
           "detect_dataset", "load_image", "load_images", "resolve_decoder", "DECODERS"]

DECODERS = ("auto", "native", "png")

_ORI_KEYS = ("q", "q_vbs2tango", "q_vbs2tango_true")
_POS_KEYS = ("t", "r_Vo2To_vbs_true")

_CROP_AUGMENT = ("crop-refine manifests (records carry a crop window) are incompatible with "
                 "host-side rotation augmentation: the stored crop window cannot follow the "
                 "warped pose; set DATA.ROT_AUGMENT: false for crop-mode training")


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


def resolve_decoder(decoder: str = "auto") -> str:
    """``"native"`` or ``"png"``: ``"auto"`` is ``"native"`` where the host
    can build the native loader, else ``"png"``; ``"native"`` raises, naming
    what is missing, where it cannot."""
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if decoder == "auto":
        return "native" if native.available() else "png"
    if decoder == "native":
        native.require()
    return decoder


def _refuse_jpeg(path: str) -> None:
    lacking = native.missing()
    where = (f"which this host cannot build: missing {', '.join(lacking)}" if lacking
             else "which this host can build")
    raise ValueError(f"{path} is a JPEG file: the 'png' decoder reads PNG only; JPEG goes "
                     f"through the native loader (decoder='native' or 'auto'), {where}")


def load_image(path: str, img_size: Tuple[int, int], decoder: str = "auto") -> np.ndarray:
    """Read an image file and resize it to ``img_size`` (H, W): uint8 RGB,
    through ``decoder`` (:func:`resolve_decoder`)."""
    if resolve_decoder(decoder) == "native":
        return native.load_batch([path], img_size[0], img_size[1], 1)[0]
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        _refuse_jpeg(path)
    return resize_bilinear(decode_png(data), img_size)


def load_images(paths: List[str], img_size: Tuple[int, int], decoder: str = "auto",
                n_threads: int = 0) -> np.ndarray:
    """:func:`load_image` of each path, stacked: ``(N, H, W, 3)`` uint8 (the
    native decoder reads them on ``n_threads`` threads, 0 one a core)."""
    if resolve_decoder(decoder) == "native":
        return native.load_batch(paths, img_size[0], img_size[1], n_threads)
    return np.stack([load_image(p, img_size, "png") for p in paths])


class BatchLoader:
    """Host-side batch iterator yielding padded, masked uint8 batches.

    Yields dicts: ``images`` (B,H,W,3) uint8, ``ori`` (B,4), ``pos`` (B,3),
    ``mask`` (B,) float32 (0 for padding rows of the final batch), and
    ``crop`` (B,3) where the records carry crop windows.  ``decoder`` is
    resolved once, here (:func:`resolve_decoder`), and kept in
    ``self.decoder``.  ``rot_augment`` warps each valid frame in order and
    updates its pose.

    ``mesh`` (a data-parallel ``parallel.mesh.Mesh``, set by the caller)
    keeps the host work to this rank's rows: every batch is still the
    global one, its poses, ``mask`` and warp draws those of every row, but
    only the rank's rows (``mesh.rows``) are decoded and warped; the other
    rows' images are zero, since ``shard_batch`` drops them.
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
        decoder: str = "auto",
    ):
        if (rot_augment is not None and manifest.records
                and manifest.records[0].crop is not None):
            raise ValueError(_CROP_AUGMENT)
        self.manifest = manifest
        self.batch_size = batch_size
        self.img_size = tuple(img_size)
        self.shuffle = shuffle
        self.seed = seed
        self.n_workers = n_workers
        self.drop_remainder = drop_remainder
        self.rot_augment = rot_augment
        self.decoder = resolve_decoder(decoder)
        self.mesh = None
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
                n_valid = len(recs)
                keep = self._kept_rows(n_valid)
                images = self._decode(pool, [r.image_path for r in recs], keep)
                oris = [r.ori for r in recs]
                poss = [r.pos for r in recs]
                crops = [r.crop for r in recs] if recs[0].crop is not None else None
                if self.rot_augment is not None:
                    images, oris, poss = self._augment(pool, images, oris, poss, keep)
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

    def _kept_rows(self, n_valid: int) -> range:
        """The valid rows of a global batch that this loader decodes and
        warps: all of them without a ``mesh``, else the rank's."""
        if self.mesh is None:
            return range(n_valid)
        return range(*self.mesh.rows(self.batch_size).indices(n_valid))

    def _augment(self, pool: ThreadPoolExecutor, images, oris, poss, keep: range):
        """The host warp of each frame: drawn in frame order, as JAX's loader
        draws them, and applied on the pool's threads; a frame outside
        ``keep`` has only its pose rotated."""
        degs = [self.rot_augment.draw() for _ in images]
        out = list(pool.map(lambda i: self.rot_augment.apply(images[i], oris[i], poss[i],
                                                             degs[i], warp=i in keep),
                            range(len(images))))
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    def _decode(self, pool: ThreadPoolExecutor, paths: List[str],
                keep: range) -> List[np.ndarray]:
        """The frames of ``paths`` at ``keep``, decoded; the others zero."""
        h, w = self.img_size
        todo = [paths[i] for i in keep]
        if self.decoder == "native":
            done = list(native.load_batch(todo, h, w, self.n_workers)) if todo else []
        else:
            done = list(pool.map(lambda p: load_image(p, self.img_size, "png"), todo))
        if len(done) == len(paths):
            return done
        images = [np.zeros((h, w, 3), np.uint8) for _ in paths]
        for i, image in zip(keep, done):
            images[i] = image
        return images


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
    the split's identity and memmapped by later runs; a second file,
    ``.decoder_<...>.json``, records the decoder that built it, and a
    sidecar of another decoder (or of none recorded) is decoded again.  The
    host warp (``rot_augment``) is drawn and applied anew each epoch, on
    copies of the cached frames.  With ``device_resident`` the split is
    copied to ``device`` once and each batch is an index gather there:
    ``images`` is then a uint8 tensor on that device (its padding rows
    zero); ``ori``, ``pos`` and ``mask`` stay numpy.
    """

    def __init__(self, *args, device_resident: bool = False,
                 device: Union[str, torch.device] = "cuda", **kw):
        super().__init__(*args, **kw)
        if device_resident and self.rot_augment is not None:
            raise ValueError("device-resident data cannot take the host-side warp; augment on "
                             "the device (data/augment.py)")
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

    def _decoder_path(self, path: str) -> str:
        """The record of the sidecar's decoder: ``.decoder_<...>.json``."""
        head, name = os.path.split(path)
        return os.path.join(head, ".decoder_" + name[len(".decoded_"):-len(".npy")] + ".json")

    def _built_with(self, path: str) -> Optional[str]:
        try:
            with open(self._decoder_path(path)) as f:
                return json.load(f).get("decoder")
        except (OSError, ValueError):
            return None

    def _materialize(self) -> None:
        path = self._cache_path()
        if path and os.path.isfile(path) and self._built_with(path) == self.decoder:
            arr = np.load(path, mmap_mode="r")
            expect = (len(self.manifest),) + tuple(self.img_size) + (3,)
            # Images regenerated in place (same names and count) are caught
            # by decoding the first one again, through the same decoder.
            first = self.manifest.records[0].image_path
            if (arr.shape == expect and arr.dtype == np.uint8
                    and np.array_equal(np.asarray(arr[0]),
                                       load_image(first, self.img_size, self.decoder))):
                self._cache = arr
                return
        base = BatchLoader(self.manifest, self.batch_size, self.img_size, shuffle=False,
                           n_workers=self.n_workers, decoder=self.decoder)
        chunks = [b["images"][:int(b["mask"].sum())] for b in base]
        self._cache = (np.concatenate(chunks) if chunks
                       else np.zeros((0,) + tuple(self.img_size) + (3,), np.uint8))
        if path:
            try:  # a read-only dataset directory keeps the split in RAM only
                tmp = f"{path}.{os.getpid()}.tmp"  # ranks of a mesh may write it at once
                with open(tmp, "wb") as f:
                    np.save(f, self._cache)
                os.replace(tmp, path)
                record = self._decoder_path(path)
                with open(f"{record}.{os.getpid()}.tmp", "w") as f:
                    json.dump({"decoder": self.decoder}, f)
                os.replace(f"{record}.{os.getpid()}.tmp", record)
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
        recs = self.manifest.records
        oris = np.stack([r.ori for r in recs]).astype(np.float32)
        poss = np.stack([r.pos for r in recs]).astype(np.float32)
        crops = (np.stack([r.crop for r in recs]).astype(np.float32)
                 if recs and recs[0].crop is not None else None)
        with ThreadPoolExecutor(max_workers=self.n_workers) as pool:
            yield from self._batches(pool, order, oris, poss, crops)

    def _batches(self, pool, order, oris, poss, crops):
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs and self.drop_remainder:
                break
            pad = bs - n_valid
            ori, pos = oris[idx], poss[idx]
            if self.device_resident:
                images = self._device_images(idx)
            else:
                keep = self._kept_rows(n_valid)
                if len(keep) == n_valid:
                    images = self._cache[idx]
                else:
                    images = np.zeros((n_valid,) + self._cache.shape[1:], np.uint8)
                    images[keep.start:keep.stop] = self._cache[idx[keep.start:keep.stop]]
                if self.rot_augment is not None:
                    images, ori, pos = (np.stack(x) for x in self._augment(pool, images, ori,
                                                                            pos, keep))
                images = _pad_rows(images, pad, zeros=True) if pad else images
            batch = {
                "images": images,
                "ori": _pad_rows(ori, pad) if pad else ori,
                "pos": _pad_rows(pos, pad) if pad else pos,
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

    ``rot_augment``: a ``HostRotationAugment`` for the train split.
    ``cache``: decode each split once and serve its epochs from RAM
    (:class:`CachedBatchLoader`); ``"device"`` keeps the decoded splits on
    ``device`` and gathers each batch there.  Each loader resolves its
    decoder itself (:func:`resolve_decoder`, ``"auto"``).
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
