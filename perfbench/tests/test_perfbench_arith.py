"""The yardstick's arithmetic: MACs and least times from layer shapes."""

import json
import os

import numpy as np
import pytest
import torch

from perfbench import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name="flagship_int8"):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_macs_match_nn_stats_default_head():
    """``apps.nn_stats``' default (orientation soft-class, position
    regression) counts 561,320,704 MACs at 240x384."""
    cfg = dict(_cfg(), n_pos_bins=3)
    assert roofline.model_macs(cfg) == 561_320_704


def test_macs_match_the_port_model_on_the_flagship_head():
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.utils.stats import detailed_model_summary

    cfg = _cfg()
    model = import_model(ori_mode="classification", n_ori_bins=cfg["n_ori_bins"],
                         pos_mode="classification", n_pos_bins=cfg["n_pos_bins"],
                         device="cpu")
    rows = detailed_model_summary(model, tuple(cfg["img_size"]))
    assert roofline.model_macs(cfg) == sum(r["macs"] for r in rows)


def test_layer_table_is_mobilenet_v2():
    nodes = roofline.layers(_cfg())
    blocks = [n for n in nodes if n["kind"] == "block"]
    assert len(blocks) == 17
    assert [n["kind"] for n in nodes[:1] + nodes[-2:]] == ["stem", "head_conv", "fc"]
    assert (nodes[-2]["ho"], nodes[-2]["wo"]) == (8, 12)
    assert nodes[-1]["cout"] == 1232 + 1000


@pytest.mark.parametrize("batch", [1, 256])
def test_k4_bound_from_shapes_matches_the_kernel_arguments(batch):
    """The shape-based bound of each block equals ``chip_smoke.py``'s
    ``mbconv_bound`` reckoned on the fused executor's own operands."""
    import chip_smoke
    from spef_tpu_torch.quant.int8_fused import plan_nodes
    from spef_tpu_torch.quant.int8_graph import load_int8_graph, scalars

    cfg = _cfg()
    graph = scalars(load_int8_graph(os.path.join(ROOT, cfg["weights"]["path"])))

    def tensor(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype)

    _, nodes, _ = plan_nodes(graph, tensor, pack=False)
    blocks = [n for n in roofline.layers(cfg) if n["kind"] == "block"]
    assert len(nodes) == len(blocks)
    for node, shape in zip(nodes, blocks):
        x = torch.zeros((batch, shape["h"], shape["w"], shape["cin"]), dtype=torch.int8)
        ms, _ = chip_smoke.mbconv_bound((x, node["wts"]), node["kw"])
        assert roofline.mbconv_bound_s(shape, batch) * 1e3 == pytest.approx(ms, rel=1e-12)
    total = sum(roofline.mbconv_bound_s(s, batch) for s in blocks)
    assert roofline.blocks_bound_s(cfg, batch) == pytest.approx(total)


def test_whole_forward_bound_holds_the_blocks():
    cfg = _cfg()
    assert roofline.int8_forward_bound_s(cfg, 256) > roofline.blocks_bound_s(cfg, 256) > 0
