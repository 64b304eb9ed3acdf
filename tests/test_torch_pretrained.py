"""Port parity: ``models/pretrained.py`` against ``spef_tpu.models.pretrained``.

A torchvision-format MobileNetV2 state dict is built in the test (the
JAX package's own fabricated one, ``tests/test_pretrained.py``), written as
a ``.npz`` and as a torch file, and ingested by both packages: the
backbone's weights and BN statistics are the same bits in both (the port's
tree read back through ``flax_variables``; JAX's loader fills a template
of the same tree, the port's fresh init, which ``tests/test_torch_models.py``
holds to flax's layout), the head keeps its fresh init, and a missing
tensor or a wrong shape raises.
"""

import os
import sys

import numpy as np
import pytest
import torch

from spef_tpu.models.pretrained import load_pretrained_backbone as jload
from spef_tpu_torch.models.pretrained import (
    load_pretrained_backbone, load_state_dict_file, torchvision_key_map)
from spef_tpu_torch.models.wrapper import flax_variables, import_model

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_pretrained import synthetic_torchvision_state  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def state():
    return synthetic_torchvision_state(np.random.default_rng(0))


@pytest.fixture(scope="module")
def fresh():
    """The flax tree of a fresh port model (seed 1001)."""
    return flax_variables(import_model("mobilenet_v2", "ursonet", ori_mode="regression",
                                       device="cpu"))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict) or hasattr(tree[k], "items"):
            yield from _walk(tree[k], path + (k,))
        else:
            yield "/".join(path + (k,)), np.asarray(tree[k])


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_ingestion_matches_jax(tmp_path, state, fresh, fmt):
    path = str(tmp_path / f"mobilenet_v2.{fmt}")
    if fmt == "npz":
        np.savez(path, **state)
    else:
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in state.items()}, path)
    want = jload(path, fresh)
    got = flax_variables(import_model("mobilenet_v2", "ursonet", ori_mode="regression",
                                      device="cpu", pretrained_path=path))
    for col in ("params", "batch_stats"):
        mine = dict(_walk(got[col]["backbone"]))
        theirs = dict(_walk(want[col]["backbone"]))
        assert sorted(mine) == sorted(theirs)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
        assert any(not np.array_equal(v, dict(_walk(fresh[col]["backbone"]))[k])
                   for k, v in mine.items())
    for k, v in _walk(got["params"]["head"]):
        np.testing.assert_array_equal(v, dict(_walk(fresh["params"]["head"]))[k])
    assert set(load_state_dict_file(path)) >= {f"{tv}.0.weight" for tv, _, kind
                                               in torchvision_key_map() if kind == "convbn"}


def test_missing_tensor_or_wrong_shape_raises(state):
    model = import_model("mobilenet_v2", "ursonet", ori_mode="regression", device="cpu")
    partial = dict(state)
    del partial["features.3.conv.1.0.weight"]
    with pytest.raises(KeyError):
        load_pretrained_backbone(partial, model)
    bad = dict(state)
    bad["features.0.0.weight"] = np.zeros((32, 3, 5, 5), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained_backbone(bad, model)
