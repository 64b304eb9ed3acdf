"""Port parity of the measurement tools: ``utils.stats`` / ``apps.nn_stats``
against ``spef_tpu.utils.stats`` / ``spef_tpu.apps.nn_stats``,
``utils.profiling``'s trace, and
``apps.benchmark`` against ``spef_tpu.apps.benchmark``.

  * The flagship's network, ``mobilenet_v2`` + URSONet (1232 orientation
    bins, position regression: ``nn_stats``' defaults) at 240x384: total
    parameters and MACs equal to JAX's ``detailed_model_summary``, and the
    ``Conv2D`` / ``Dense`` rows equal as a multiset of (type, HWIO kernel
    shape, NHWC output shape, parameters, MACs); the CLI's per-type and
    total lines are those JAX's rows give.
  * ``trace`` writes a Chrome trace.
  * ``apps.benchmark`` on every path at 32x48, batch 2, on the CPU: JAX's
    JSON keys for each path (those of JAX's ``_throughput``).
"""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HW = (240, 384)


def _key(row):
    return (row["type"], tuple(row["kernel_shape"]), tuple(row["out_shape"]), row["params"],
            row["macs"])


@pytest.fixture(scope="module")
def jax_rows():
    """JAX's ``detailed_model_summary`` of the network: its ``import_model``
    module, with the variables' shapes from ``jax.eval_shape`` of the init
    (``import_model`` runs the init itself, op by op: about 20 s at
    240x384 on this CPU; the summary reads only shapes)."""
    import jax
    import jax.numpy as jnp

    from spef_tpu.codec.facade import SPEUtils as JaxUtils
    from spef_tpu.data.camera import SPEED_CAMERA
    from spef_tpu.models.heads import URSONetHead
    from spef_tpu.models.wrapper import _BACKBONES, ModelWrapper, SPEModel
    from spef_tpu.utils.stats import detailed_model_summary

    spe = JaxUtils.create(SPEED_CAMERA, ori_mode="classification", ori_delete_unused_bins=True,
                          pos_mode="regression", use_keypoints=False)
    module = ModelWrapper(
        backbone=_BACKBONES["mobilenet_v2"]({"batchnorm": True, "residual": True}),
        head=URSONetHead(n_ori_outputs=spe.orientation.n_bins, n_pos_outputs=3))
    variables = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *HW, 3), jnp.float32), False))
    model = SPEModel(module=module, variables=dict(variables), backbone_name="mobilenet_v2",
                     head_name="ursonet")
    return detailed_model_summary(model, HW)


def test_model_summary_matches_jax(jax_rows):
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import SPEED_CAMERA
    from spef_tpu_torch.models.wrapper import import_model
    from spef_tpu_torch.utils.stats import detailed_model_summary

    spe = SPEUtils.create(SPEED_CAMERA, ori_mode="classification", pos_mode="regression",
                          use_keypoints=False, device="cpu")
    model = import_model("mobilenet_v2", "ursonet", img_size=HW, ori_mode="classification",
                         n_ori_bins=spe.orientation.n_bins, pos_mode="regression", device="cpu")
    rows = detailed_model_summary(model, HW)
    for key in ("params", "macs"):
        assert sum(r[key] for r in rows) == sum(r[key] for r in jax_rows), key
    layers = [r for r in rows if r["type"] in ("Conv2D", "Dense")]
    jax_layers = [r for r in jax_rows if r["type"] in ("Conv2D", "Dense")]
    assert len(layers) == len(jax_layers) == 54
    assert sorted(map(_key, layers)) == sorted(map(_key, jax_layers))
    # the stem: HWIO kernel, NHWC output at half the frame
    stem = next(r for r in rows if r["name"] == "backbone.stem.conv")
    assert stem["kernel_shape"] == (3, 3, 3, 32) and stem["out_shape"] == (1, 120, 192, 32)


def test_nn_stats_cli_prints_jax_totals(jax_rows, capsys):
    from spef_tpu_torch.apps import nn_stats

    out = nn_stats.main(["--img-size", str(HW[0]), str(HW[1])])
    text = capsys.readouterr().out
    by_type = {}
    for r in jax_rows:
        agg = by_type.setdefault(r["type"], {"params": 0, "macs": 0, "count": 0})
        agg["params"] += r["params"]
        agg["macs"] += r["macs"]
        agg["count"] += 1
    assert out["by_type"] == by_type
    for t, agg in by_type.items():
        assert (f"{t:20s} x{agg['count']:<4d} params={agg['params']:>12,d} "
                f"MACs={agg['macs']:>16,d}") in text
    total_params = sum(a["params"] for a in by_type.values())
    total_macs = sum(a["macs"] for a in by_type.values())
    assert f"{'TOTAL':20s}       params={total_params:>12,d} MACs={total_macs:>16,d}" in text
    assert (total_params, total_macs) == (3_805_907, 561_320_704)


def test_trace_writes_a_chrome_trace(tmp_path):
    from spef_tpu_torch.utils.profiling import trace

    x = torch.ones(64, 64)
    with trace(str(tmp_path)) as prof:
        torch.matmul(x, x)
    assert any("matmul" in e.key for e in prof.key_averages())
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_benchmark_cli_every_path(tmp_path, capsys):
    import jax
    import jax.numpy as jnp

    from spef_tpu.apps.benchmark import _throughput as jax_throughput
    from spef_tpu_torch.apps import benchmark

    out = str(tmp_path / "port.json")
    results = benchmark.main(["--paths", *benchmark.PATHS, "--batch", "2", "--img", "32", "48",
                              "--iters", "2", "--json", out, "--device", "cpu"])
    with open(out) as f:
        written = json.load(f)
    assert sorted(written) == sorted(benchmark.PATHS) and written == results
    # JAX's JSON holds, for each path, what its _throughput returns.
    jax_keys = set(jax_throughput(jax.jit(lambda x: x * 2), (jnp.ones(4),), 1, 4))
    for name, r in written.items():
        assert set(r) == jax_keys | {"device"} and r["device"] == "cpu", name
        assert r["items_per_sec"] > 0 and r["ms_per_batch"] > 0
        assert np.isclose(r["items_per_sec"], 2 / (r["ms_per_batch"] / 1e3))
    text = capsys.readouterr().out
    assert "int8_cuda" in text and "on cpu" in text
