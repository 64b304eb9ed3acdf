"""Port parity of the fused-kernel autotuner and the backend plan:
``spef_tpu_torch.quant.autotune`` and ``quant/int8_fused.py``'s
``node_signatures`` / ``plan_key`` / ``plan_backends`` / ``plan=``, against
``spef_tpu.quant.autotune`` and ``spef_tpu.quant.int8_fused`` on the CPU.

The first eight tests are the counterparts of ``tests/test_autotune.py``'s,
on the same graphs and hand-written tables; each table is read by both
packages (one file: the entries' ``ms`` / ``xla_ms`` / ``transition_ms``
and the ``plan:`` keys mean the same in both), and the plans must be equal.
Exact throughout: signature strings, md5 keys and plans compare equal; the
library-op nodes (the plan's ``"xla"``) are bit for bit JAX's ``_xla_stem``
/ ``_xla_block`` on int8 outputs; the hybrid forward's logits equal JAX's
hybrid forward (int8 grids with integer sums: the same pooled integers give
the same float ops), and the all-fused forward's within JAX's own 1e-5.
The JAX Pallas kernels run in interpret mode, as in ``tests/test_autotune.py``.
The tile itself only matters on the card (``tests/test_torch_cuda.py``):
here the wrapper runs the plain version, which has none.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spef_tpu.quant.autotune as jat
import spef_tpu.quant.int8_fused as jfused
import spef_tpu_torch.quant.autotune as at
import spef_tpu_torch.quant.int8_fused as fused
from spef_tpu.models.wrapper import import_model
from spef_tpu.quant.bitwidth import boundary_bit_width, default_bit_width
from spef_tpu.quant.convert import convert_qat_params
from spef_tpu_torch.ops import fused_block
from spef_tpu_torch.quant.int8_graph import load_int8_graph

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "spef_tpu_torch", "assets", "flagship_boundary_int8_graph.pkl")


@pytest.fixture
def table_path(tmp_path, monkeypatch):
    """One tuning table both packages read (their default paths moved to a
    temporary file, their caches emptied)."""
    path = str(tmp_path / "t.json")
    monkeypatch.setattr(at, "TUNING_PATH", path)
    monkeypatch.setattr(at, "_cache", {})
    monkeypatch.setattr(jat, "_TUNING_PATH", path)
    monkeypatch.setattr(jat, "_cache", None)
    monkeypatch.delenv("SPEF_ALL_FUSED", raising=False)
    return path


def _save(table, path):
    """Write a table for both packages (and drop both caches)."""
    at.save_tuning(table, path)
    jat._cache = None


def _graph(bw, seed=7, hw=(48, 64)):
    model = import_model(backbone_name="small_mobile_q", head_name="ursonet_q", img_size=hw,
                         bit_width=bw, ori_mode="classification", n_ori_bins=64,
                         pos_mode="regression", seed=seed)
    graph = convert_qat_params(model, bw)
    return graph, jax.tree_util.tree_map(np.asarray, graph)


def _a4(n_blocks=2, shared=4):
    bw = default_bit_width(n_blocks=n_blocks, w=8, a=4, shared=shared)
    bw["inverted_residual"] = [[(8, 4), (8, 4), (8,)] for _ in range(n_blocks)]
    return bw


def _sig_of(graph, i, h, w):
    blk = graph["blocks"][i]
    d = blk["depthwise"]
    cin = int(blk["expand"]["w_int"].shape[-2] if "expand" in blk else d["w_int"].shape[-1])
    return at.block_signature("mbconv", h, w, cin, int(d["w_int"].shape[-1]),
                              int(blk["project"]["w_int"].shape[-1]), int(d["stride"]))


def _walked_hw(graph, hw=(24, 32)):
    out = [hw]
    for blk in graph["blocks"][:-1]:
        s = int(blk["depthwise"]["stride"])
        out.append((out[-1][0] // s, out[-1][1] // s))
    return out


def _both_plans(graph, np_graph, **kw):
    jax_plan = jfused.plan_backends(graph, (48, 64), **kw)
    plan = fused.plan_backends(np_graph, (48, 64), **kw)
    assert plan == jax_plan
    return plan


# ---- the counterparts of tests/test_autotune.py ---------------------------------


def test_signature_and_roundtrip(table_path, monkeypatch):
    sig = at.block_signature("mbconv", 64, 64, 24, 144, 24, 1)
    assert sig == "mbconv:h64w64ci24ch144co24s1"
    assert sig == jat.block_signature("mbconv", 64, 64, 24, 144, 24, 1)
    assert at.lookup_tile(sig) == (0, 0)  # empty table

    table = {sig: {"th": 4, "tw": 8, "ms": 0.5, "candidates": {"t4x8": 0.5, "t2x16": 0.7},
                   "default_ms": 0.7, "speedup": 1.4, "default_skipped": False,
                   "xla_ms": 0.9, "backend": "fused"}}
    at.save_tuning(table, table_path)
    assert at.lookup_tile(sig) == (4, 8)
    monkeypatch.setattr(at, "_cache", {})  # reload from disk
    assert at.lookup_tile(sig) == (4, 8)
    assert json.load(open(table_path))[sig]["speedup"] == 1.4
    # An entry without a tile (the stem's, or a JAX table's tile_oh) reads as
    # never measured.
    at.save_tuning({sig: {"tile_oh": 8, "ms": 1.0}}, table_path)
    assert at.lookup_tile(sig) == (0, 0)
    # Another path is another table, cached apart.
    other = os.path.join(os.path.dirname(table_path), "other.json")
    at.save_tuning({sig: {"th": 2, "tw": 2}}, other)
    assert at.load_tuning(other)[sig] == {"th": 2, "tw": 2} and at.lookup_tile(sig) == (0, 0)
    assert at.lookup_tile(sig, other) == (2, 2)
    # A reader that names its device takes only that device's entries.
    at.save_tuning({sig: {"th": 2, "tw": 2, "device": "NVIDIA H100 80GB HBM3"}}, other)
    assert at.lookup_tile(sig, other, "NVIDIA H100 80GB HBM3") == (2, 2)
    assert at.lookup_tile(sig, other, "cpu") == (0, 0)
    assert at.device_name("cpu") == "cpu"
    # The JAX package's table holds a TPU's times: never read or written.
    tpu_table = os.path.join(REPO, "benchmarks", "fused_tuning.json")
    with pytest.raises(ValueError, match="TPU"):
        at.load_tuning(tpu_table)
    with pytest.raises(ValueError, match="TPU"):
        at.save_tuning({}, tpu_table)


def test_candidates_fit_and_start_with_the_cost_models_choice():
    shapes = [  # (batch, h, w, cin, ch, cout, stride, expand, dw_grid, residual)
        (256, 120, 192, 16, 16, 8, 1, False, False, False),
        (256, 120, 192, 8, 48, 16, 2, True, False, False),
        (256, 60, 96, 16, 96, 16, 1, True, False, True),
        (256, 15, 24, 64, 384, 96, 2, True, False, False),
        (64, 8, 12, 160, 960, 320, 1, True, True, False),
        (4, 24, 32, 32, 192, 32, 2, True, False, False),
    ]
    for b, h, w, cin, ch, cout, s, e, dg, r in shapes:
        cands = at._candidates(b, h, w, cin, ch, cout, s, e, dg, r)
        assert 1 <= len(cands) <= 8 and len(set(cands)) == len(cands)
        assert cands[0] == fused_block.choose_mbconv_tile(b, h, w, cin, ch, cout, s, e, dg, r)
        for tile in cands:
            fused_block.check_mbconv_tile(tile, h, w, cin, cout, s, e, dg, r)
    with pytest.raises(ValueError, match="shared memory|registers|outside"):
        fused_block.check_mbconv_tile((32, 32), 120, 192, 160, 320, 1)


def test_kernel_uses_tuned_tile(table_path, monkeypatch):
    """The executor given a table (``tuning=``) passes each fused node the
    winner of its node signature measured on its device, and no tile
    otherwise; without ``tuning=`` it reads no table, the default one
    included.  On a CPU tensor the wrapper runs the plain version, whatever
    the tile, and gives JAX's kernel's output."""
    from spef_tpu.ops.pallas.fused_block import fused_mbconv as jax_mbconv
    from spef_tpu.ops.pallas.fused_block import pad_act, unpad_act
    from spef_tpu_torch.quant.int8_graph import grid_params

    rng = np.random.RandomState(0)
    blk = {
        "use_residual": False, "input_quant": True, "expand_ratio": 2,
        "expand": {"w_int": rng.randint(-8, 8, (1, 1, 8, 16)).astype(np.int8),
                   "mult_core": np.ones(16, np.float32) * 0.01,
                   "bias": np.zeros(16, np.float32), "stride": 1, "groups": 1,
                   "act_step": 0.05, "act_qmax": 255.0},
        "depthwise": {"w_int": rng.randint(-8, 8, (3, 3, 1, 16)).astype(np.int8),
                      "mult_core": np.ones(16, np.float32) * 0.01,
                      "bias": np.zeros(16, np.float32), "stride": 1, "groups": 16,
                      "act_step": 0.05, "act_qmax": 255.0},
        "project": {"w_int": rng.randint(-8, 8, (1, 1, 16, 8)).astype(np.int8),
                    "mult_core": np.ones(8, np.float32) * 0.01,
                    "bias": np.zeros(8, np.float32), "stride": 1, "groups": 1},
    }
    x = rng.randint(-16, 16, (1, 16, 16, 8)).astype(np.int8)
    out_grid = {"step": 0.05, "qmax": 127.0, "qmin": -128.0}
    # JAX's kernel first, on an empty table: its tile lookup reads tile_oh,
    # which a port entry does not have.
    jblk = jax.tree_util.tree_map(lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, blk)
    want = unpad_act(jax_mbconv(pad_act(jnp.asarray(x)), jblk,
                                in_step=0.05, out_grid=out_grid, logical_hw=(16, 16),
                                interpret=True), 16, 8)

    wts, kw = fused.mbconv_operands(blk, 0.05, grid_params(0.05, 127.0))
    for tile in (None, (8, 4), (1, 1)):
        got = fused_block.fused_mbconv(torch.from_numpy(x), wts, **kw, tile=tile)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # The executor: each fused block gets its node signature's winner.
    graph, np_graph = _graph(_a4())
    sigs = fused.node_signatures(np_graph, (48, 64))
    seen = []
    orig = fused.fused_mbconv
    monkeypatch.setattr(fused, "fused_mbconv",
                        lambda *a, **k: seen.append(k.get("tile")) or orig(*a, **k))
    images = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (1, 48, 64, 3), np.uint8))

    def tiles(**kw):
        seen.clear()
        fused.build_fused_forward(np_graph, backend="cuda", device="cpu", **kw)(images)
        return list(seen)

    _save({sigs[1]: {"th": 3, "tw": 5, "ms": 1.0, "device": "cpu"},
           sigs[2]: {"ms": 1.0, "device": "cpu"}}, table_path)
    assert tiles(tuning=table_path) == [(3, 5), None]
    assert tiles() == [None, None]  # the default table is read only when named
    _save({sigs[1]: {"th": 3, "tw": 5, "ms": 1.0, "device": "NVIDIA H100 80GB HBM3"}},
          table_path)
    assert tiles(tuning=table_path) == [None, None]  # another device's winner


def test_hybrid_backend_plan_and_parity(table_path, monkeypatch):
    """A table that says the library form beat the kernel for block 0:
    ``build_fused_forward`` routes that block through ``library_block``; the
    hybrid output equals the all-fused one and JAX's hybrid forward."""
    bw = default_bit_width(n_blocks=2, w=8, a=4, shared=4)
    bw["inverted_residual"] = [[(8, 4), (8, 4), (8,)] for _ in range(2)]
    graph, np_graph = _graph(bw)
    images = np.random.RandomState(11).randint(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    x = torch.from_numpy(images)

    monkeypatch.setenv("SPEF_ALL_FUSED", "1")
    ref = fused.build_fused_forward(np_graph, backend="plain", device="cpu")(x)
    monkeypatch.delenv("SPEF_ALL_FUSED")

    sig = _sig_of(graph, 0, 24, 32)
    _save({sig: {"th": 8, "tw": 8, "ms": 9.9, "xla_ms": 0.1, "backend": "xla",
                 "device": "cpu"}}, table_path)
    plan = _both_plans(graph, np_graph)
    assert plan["stem"] == "fused"
    assert plan["blocks"][0] == "xla" and plan["blocks"][1] == "fused"
    assert fused.plan_backends(np_graph, (48, 64), path=table_path, device="cpu") == plan
    assert fused.plan_backends(np_graph, (48, 64), device="NVIDIA H100 80GB HBM3") == \
        {"stem": "fused", "blocks": ["fused", "fused"]}  # no entry of that card

    calls = []
    orig = fused.library_block
    monkeypatch.setattr(fused, "library_block", lambda *a, **k: calls.append(1) or orig(*a, **k))
    fused.build_fused_forward(np_graph, backend="plain", device="cpu")(x)
    assert not calls, "a forward given no table read the default one"
    fwd = fused.build_fused_forward(np_graph, backend="plain", device="cpu", tuning=table_path)
    out = fwd(x)
    assert calls, "the block planned 'xla' did not run its library form"
    assert fwd.launches_per_call == {"fused_stem": 1, "fused_mbconv": 1,
                                     "int8_matmul_requant": 1}
    np.testing.assert_allclose(ref[0].numpy(), out[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(ref[1].numpy(), out[1].numpy(), atol=1e-5)
    want = jfused.build_fused_forward(graph, interpret=True)(jnp.asarray(images))
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_plan_backends_charges_transitions(table_path):
    """The 2-state DP charges a switch: a node whose measured advantage is
    smaller than the two boundary crossings stays fused; a large one
    switches."""
    graph, np_graph = _graph(default_bit_width(n_blocks=3, w=8, a=8, shared=8))
    hw = _walked_hw(graph)
    table = {_sig_of(graph, i, *hw[i]): {"th": 8, "tw": 8, "ms": 1.0, "xla_ms": 2.0}
             for i in range(len(graph["blocks"]))}
    marginal = _sig_of(graph, 1, *hw[1])
    table[marginal] = {"th": 8, "tw": 8, "ms": 1.0, "xla_ms": 0.95}
    _save(table, table_path)
    assert _both_plans(graph, np_graph)["blocks"][1] == "fused"  # 0.05 ms < 2 * 0.15 ms

    table[marginal] = {"th": 8, "tw": 8, "ms": 1.0, "xla_ms": 0.2}
    _save(table, table_path)
    assert _both_plans(graph, np_graph)["blocks"][1] == "xla"


def test_graph_level_plan_override(table_path, monkeypatch):
    """A persisted graph-level plan (``plan:<md5>``, the same key in both
    packages) beats the per-node DP; an explicit ``plan=`` routes the nodes
    whatever the table says."""
    graph, np_graph = _graph(_a4(shared=8))
    assert fused.plan_key(np_graph, (48, 64)) == jfused.plan_key(graph, (48, 64))
    assert _both_plans(graph, np_graph)["blocks"] == ["fused", "fused"]  # no table

    stored = {"stem": "xla", "blocks": ["xla", "fused"], "source": "graph-arb",
              "winner": "hybrid"}
    _save({fused.plan_key(np_graph, (48, 64)): stored}, table_path)
    assert _both_plans(graph, np_graph) == {"stem": "xla", "blocks": ["xla", "fused"]}

    images = np.random.RandomState(1).randint(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    x = torch.from_numpy(images)
    calls = []
    orig = fused.library_block
    monkeypatch.setattr(fused, "library_block", lambda *a, **k: calls.append(1) or orig(*a, **k))
    all_xla = {"stem": "xla", "blocks": ["xla", "xla"]}
    out = fused.build_fused_forward(np_graph, backend="plain", device="cpu", plan=all_xla)(x)
    assert len(calls) == 2
    monkeypatch.setattr(fused, "library_block", orig)
    ref = fused.build_fused_forward(np_graph, backend="plain", device="cpu",
                                    plan={"stem": "fused", "blocks": ["fused", "fused"]})(x)
    np.testing.assert_allclose(ref[0].numpy(), out[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(ref[1].numpy(), out[1].numpy(), atol=1e-5)
    want = jfused.build_fused_forward(graph, interpret=True, plan=all_xla)(jnp.asarray(images))
    for a, b in zip(out, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="plan must name"):
        fused.build_fused_forward(np_graph, backend="plain", device="cpu",
                                  plan={"stem": "fused", "blocks": ["fused"]})


def test_penalty_sweep_yields_contiguous_runs(table_path):
    """Alternating winners: raising ``transition_ms`` lowers the switches
    monotonically, down to one backend throughout."""
    graph, np_graph = _graph(default_bit_width(n_blocks=4, w=8, a=8, shared=8))
    hw = _walked_hw(graph)
    table = {}
    for i in range(len(graph["blocks"])):
        f, x = (1.0, 1.2) if i % 2 == 0 else (1.2, 1.0)
        table[_sig_of(graph, i, *hw[i])] = {"th": 8, "tw": 8, "ms": f, "xla_ms": x}
    _save(table, table_path)

    def n_switches(plan):
        chain = [plan["stem"]] + plan["blocks"]
        return sum(a != b for a, b in zip(chain, chain[1:]))

    sw = [n_switches(_both_plans(graph, np_graph, transition_ms=t)) for t in (0.05, 0.15, 1.0)]
    assert sw[0] >= sw[1] >= sw[2], sw
    assert sw[0] > 0 and sw[2] == 0


def test_plan_backends_measured_boundary_costs(table_path):
    """Measured ``trans:<sig>-><sig>`` costs override the scalar penalty:
    a cheap one lets a marginal advantage switch, an expensive one pins a
    decisive one, a negative one counts as 0."""
    graph, np_graph = _graph(default_bit_width(n_blocks=2, w=8, a=8, shared=8))
    sigs = fused.node_signatures(np_graph, (48, 64))
    assert sigs == jfused.node_signatures(graph, (48, 64))
    table = {s: {"th": 8, "tw": 8, "ms": 1.0, "xla_ms": 2.0} for s in sigs[1:]}
    marginal = sigs[2]
    table[marginal] = {"th": 8, "tw": 8, "ms": 1.0, "xla_ms": 0.95}
    boundary = f"trans:{sigs[1]}->{sigs[2]}"
    table[boundary] = {"transition_ms": 0.01}
    _save(table, table_path)
    assert _both_plans(graph, np_graph)["blocks"][1] == "xla"

    table[marginal] = {"th": 8, "tw": 8, "ms": 1.0, "xla_ms": 0.2}
    table[boundary] = {"transition_ms": 5.0}
    _save(table, table_path)
    assert _both_plans(graph, np_graph)["blocks"][1] == "fused"

    table[boundary] = {"transition_ms": -3.0}
    _save(table, table_path)
    assert _both_plans(graph, np_graph)["blocks"][1] == "xla"


# ---- beyond the JAX suite ---------------------------------------------------------


@pytest.mark.parametrize("hw", [(48, 64), (32, 48), (240, 384), (256, 256), (239, 383)])
def test_signatures_and_plan_key_match_jax(hw):
    """The same strings and md5 keys as JAX's, on the flagship's graph at
    sizes whose halvings go odd (15 rows -> 7 in the signature)."""
    graph = load_int8_graph(ASSET)
    assert fused.node_signatures(graph, hw) == jfused.node_signatures(graph, hw)
    assert fused.plan_key(graph, hw) == jfused.plan_key(graph, hw)
    assert len(fused.node_signatures(graph, hw)) == 1 + len(graph["blocks"])


@pytest.mark.parametrize("seed", range(4))
def test_plan_backends_matches_jax_on_random_tables(table_path, seed, monkeypatch):
    """Random per-node times, some nodes unmeasured or measured on one
    backend, random measured boundaries, four penalties: JAX's plan every
    time; ``SPEF_ALL_FUSED`` overrides the table in both."""
    graph = load_int8_graph(ASSET)
    rng = np.random.RandomState(seed)
    sigs = fused.node_signatures(graph, (240, 384))
    table = {}
    for s in sigs:
        r = rng.rand()
        if r < 0.15:
            continue
        e = {"ms": float(rng.uniform(0.1, 2.0))}
        if r > 0.3:
            e["xla_ms"] = float(rng.uniform(0.1, 2.0))
        table[s] = e
    for a, b in zip(sigs, sigs[1:]):
        if rng.rand() < 0.3:
            table[f"trans:{a}->{b}"] = {"transition_ms": float(rng.uniform(-0.1, 0.5))}
    _save(table, table_path)
    for t in (0.0, 0.05, 0.15, 1.0):
        plan = fused.plan_backends(graph, (240, 384), transition_ms=t)
        assert plan == jfused.plan_backends(graph, (240, 384), transition_ms=t)
    monkeypatch.setenv("SPEF_ALL_FUSED", "1")
    assert fused.plan_backends(graph, (240, 384)) == jfused.plan_backends(graph, (240, 384)) \
        == {"stem": "fused", "blocks": ["fused"] * len(graph["blocks"])}


_FAMILIES = {"a4": _a4, "w8a8": lambda: default_bit_width(n_blocks=2, w=8, a=8, shared=8),
             "boundary": lambda: boundary_bit_width(n_blocks=2)}


@pytest.mark.parametrize("family,seed", [("a4", 7), ("w8a8", 7), ("boundary", 7),
                                         ("boundary", 23)])
def test_library_nodes_match_jax_xla_nodes(family, seed):
    """``library_stem`` / ``library_block`` against JAX's ``_xla_stem`` /
    ``_xla_block`` on the same graph and inputs, bit for bit (the boundary
    recipe's bf16 real-valued sums included, at these sizes)."""
    graph, np_graph = _graph(_FAMILIES[family](), seed=seed)
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    want = np.asarray(jfused._xla_stem(graph["stem"], jnp.asarray(images)))
    got = fused.library_stem(torch.from_numpy(images),
                             fused.library_stem_operands(fused.scalars(np_graph)["stem"]))
    np.testing.assert_array_equal(got.numpy(), want)
    g = fused.scalars(np_graph)
    _, nodes, _ = fused.plan_nodes(g, fused._numpy_tensor, pack=False)
    hw = _walked_hw(graph)
    for i, nd in enumerate(nodes):
        cin = nd["wts"]["w1"].shape[0] if "w1" in nd["wts"] else nd["wts"]["w2"].shape[-1]
        x = rng.randint(-8, 8, (2, *hw[i], cin)).astype(np.int8)
        want, _ = jfused._xla_block(jnp.asarray(x), graph["blocks"][i], nd["in_step"],
                                    nd["out_grid"], in_unsigned=nd["unsigned"])
        ops = fused.library_block_operands(g["blocks"][i], nd["in_step"], nd["out_grid"],
                                           nd["unsigned"])
        got = fused.library_block(torch.from_numpy(x), ops)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tune_graph_writes_the_tuning_table(table_path):
    """``tune_graph`` on the CPU (host clock; the plain versions, so every
    tile runs the same program there): an entry a node, under JAX's
    signatures, with JAX's fields and ``th`` / ``tw``; merged with what the
    table held; the plan it implies is JAX's reading of the same file."""
    graph, np_graph = _graph(boundary_bit_width(n_blocks=2))
    at.save_tuning({"keep:me": {"ms": 1.0}})
    with pytest.raises(ValueError, match="path="):
        at.tune_graph(np_graph, (48, 64), batch=2, iters=1, verbose=False, device="cpu")
    table = at.tune_graph(np_graph, (48, 64), batch=2, iters=1, verbose=False, device="cpu",
                          path=table_path)
    sigs = fused.node_signatures(np_graph, (48, 64))
    assert set(table) == set(sigs) | {"keep:me"}
    assert json.load(open(table_path)) == table
    fields = {"ms", "candidates", "default_ms", "speedup", "default_skipped", "xla_ms", "backend"}
    for i, sig in enumerate(sigs):
        e = table[sig]
        assert fields <= set(e) and e["backend"] in ("fused", "xla")
        assert e["device"] == "cpu" and e["batch"] == 2
        assert e["default_skipped"] is False and e["ms"] == min(e["candidates"].values())
        if i == 0:
            assert set(e["candidates"]) == {"default"} and "th" not in e
        else:
            assert f"t{e['th']}x{e['tw']}" in e["candidates"]
            assert at.lookup_tile(sig) == (e["th"], e["tw"])
    jat._cache = None
    assert fused.plan_backends(np_graph, (48, 64)) == jfused.plan_backends(graph, (48, 64))


def test_build_int8_autotune_writes_its_report(tmp_path, table_path, monkeypatch):
    """``apps.build_int8 --autotune --device cpu`` on the tiny config of
    ``tests/test_torch_train_cli.py``: ``autotune_report.json`` in the
    experiment holds an entry for each node of the graph it built; on the
    CPU the table is the experiment's ``fused_tuning_cpu.json`` and the
    default table (here a temporary path) is not written."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_train_cli import _tiny_config, _tiny_set

    from spef_tpu_torch.apps import build_int8 as build_app
    from spef_tpu_torch.quant.int8_graph import load_int8_graph as load

    real = at._time_ms
    monkeypatch.setattr(at, "_time_ms", lambda fn, xs, iters: real(fn, xs[:1], 1))
    still = _tiny_set(tmp_path / "dspeed")
    cfg = _tiny_config(tmp_path / "exp_tiny.yaml", still)
    result = build_app.main(["--config", cfg, "--out", str(tmp_path / "build"), "--recipe",
                             "boundary", "--autotune", "--device", "cpu"])
    folder = result["folder"]
    report = json.load(open(os.path.join(folder, "autotune_report.json")))
    sigs = fused.node_signatures(load(os.path.join(folder, "int8_graph.pkl")), (48, 64))
    assert set(sigs) <= set(report)
    assert report == json.load(open(os.path.join(folder, "fused_tuning_cpu.json")))
    assert not os.path.exists(table_path)
