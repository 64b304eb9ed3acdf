"""``data/dataset.py::CachedBatchLoader`` against the port's ``BatchLoader``
and the JAX package's ``CachedBatchLoader``, on a tiny D-SPEED still set
written by the JAX writer.

  * The cached loader gives the streaming loader's batches, bit for bit:
    two shuffled epochs (seed + epoch) and the padded last batch with its
    mask.
  * The decoded split is written beside the images as the sidecar file
    JAX names (``.decoded_<H>x<W>_<N>_<id>.npy``); a second loader memmaps
    it instead of decoding; images regenerated in place are caught by the
    probe of the first frame and decoded again.
  * JAX's ``CachedBatchLoader`` reads the port's sidecar and gives the same
    batches.
  * ``device_resident`` on the CPU: the images come as a tensor on the
    loader's device, the padding rows zero, equal to the RAM batches;
    ``load_dataset(cache="device")`` builds such loaders.

Tolerance: none; every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

from spef_tpu.data import dataset as jdataset
from spef_tpu.data.synthetic import create_synthetic_dataset as jax_create
from spef_tpu_torch.data import dataset
from spef_tpu_torch.data.png import write_png

HW = (36, 60)


@pytest.fixture()
def still(tmp_path):
    return jax_create(str(tmp_path), n_train=7, n_valid=3, n_test=5, img_size=HW, seed=3)


def _split(still):
    return (os.path.join(still, "train", "pose.json"), os.path.join(still, "train", "images"))


def _loader(cls, still, **kw):
    labels, images = _split(still)
    mod = jdataset if cls.__module__.startswith("spef_tpu.") else dataset
    return cls(mod.Manifest.from_json(labels, images), 3, HW, shuffle=True, seed=5, n_workers=2,
               **kw)


def _epochs(loader, n=2):
    return [[{k: np.array(v) for k, v in b.items()} for b in loader] for _ in range(n)]


def _same(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew) == 3
        for g, w in zip(eg, ew):
            assert sorted(g) == sorted(w) == ["images", "mask", "ori", "pos"]
            for k in w:
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _sidecars(still):
    return [f for f in os.listdir(_split(still)[1]) if f.startswith(".decoded_")]


def test_cached_batches_equal_the_streaming_ones_and_the_sidecar_is_reused(still):
    want = _epochs(_loader(dataset.BatchLoader, still))
    first = _loader(dataset.CachedBatchLoader, still)
    _same(_epochs(first), want)
    assert want[0][-1]["mask"].tolist() == [1.0, 0.0, 0.0]  # 7 frames, batches of 3
    names = _sidecars(still)
    assert len(names) == 1 and names[0].startswith(f".decoded_{HW[0]}x{HW[1]}_7_")
    assert names[0] == os.path.basename(_loader(jdataset.CachedBatchLoader, still)._cache_path())

    second = _loader(dataset.CachedBatchLoader, still)
    _same(_epochs(second), want)
    assert isinstance(second._cache, np.memmap)

    # JAX's cached loader reads the port's sidecar.
    theirs = _loader(jdataset.CachedBatchLoader, still)
    _same(_epochs(theirs), want)
    assert isinstance(theirs._cache, np.memmap)


def test_images_regenerated_in_place_are_decoded_again(still):
    _epochs(_loader(dataset.CachedBatchLoader, still), 1)
    labels, images = _split(still)
    first = dataset.Manifest.from_json(labels, images).records[0].image_path
    write_png(first, np.full(HW + (3,), 77, np.uint8))
    fresh = _loader(dataset.CachedBatchLoader, still)
    _same(_epochs(fresh), _epochs(_loader(dataset.BatchLoader, still)))
    assert not isinstance(fresh._cache, np.memmap)


def test_device_resident_batches_on_the_cpu(still):
    want = _epochs(_loader(dataset.BatchLoader, still))
    loader = _loader(dataset.CachedBatchLoader, still, device_resident=True, device="cpu")
    batches = list(loader)
    assert all(torch.is_tensor(b["images"]) and b["images"].dtype == torch.uint8
               for b in batches)
    assert all(isinstance(b["ori"], np.ndarray) for b in batches)
    assert not bool(batches[-1]["images"][1:].any())
    _same([[{k: np.array(v) for k, v in b.items()} for b in batches]] + _epochs(loader, 1),
          want)

    data, split = dataset.load_dataset(still, 4, HW, cache="device", device="cpu")
    assert split["train"] == ("train", "valid", "test")
    assert all(isinstance(data[k], dataset.CachedBatchLoader) and data[k].device_resident
               for k in split["train"])
    data, _ = dataset.load_dataset(still, 4, HW, cache=True, device="cpu")
    assert not data["train"].device_resident
