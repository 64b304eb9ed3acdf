"""Sharded serving traffic: the stream driver's closed loop of windows
through ``serving.serve_stream``, over the two stages of an
``engine.ShardedPredict`` on the cell's cards (``ShardedPredict.staged()``:
one replica of the configuration's predict function a card, each window's
rows split over them, the decode once on the first card).  A program whose
``ShardedPredict`` has no ``staged`` is given the same two stages here.

The window loop, the pool, the spans, the end-to-end numbers and the
comparison are ``drivers/stream.py``'s own: its ``run`` is called with this
module's engine in place of its ``build_predict`` (the same code object
over other globals), so the mix's keys are the stream driver's.  Traced,
the span ``forward`` holds the rows' copies to every card, each card's
forward and the gather to the first; ``decode`` the decode.
"""

from __future__ import annotations

import types

from perfbench.drivers import stream
from perfbench.harness import Run

KEYS = stream.KEYS


def build_predict(ctx):
    """The sharded predict function over ``chips`` devices of the run's kind
    (CPU replicas on the CPU), as a two-stage predict function on a whole
    window."""
    from perfbench.reference.weights import checked_bytes
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import Camera
    from spef_tpu_torch.engine import ShardedPredict, StagedPredict, build_predict_fn
    from spef_tpu_torch.parallel.mesh import data_sharding, make_local_mesh
    from spef_tpu_torch.quant.int8_fused import build_fused_forward
    from spef_tpu_torch.quant.int8_graph import load_int8_graph

    cfg = ctx.cfg
    if cfg["engine"] != "fused_int8":
        raise ValueError(f"the sharded stream serves the fused int8 engine, not {cfg['engine']!r}")
    mesh = make_local_mesh(ctx.device.type, int(ctx.cell["chips"]))
    checked_bytes(ctx.root, cfg["weights"])
    graph = load_int8_graph(f"{ctx.root}/{cfg['weights']['path']}")
    utils = SPEUtils.create(
        Camera(**cfg["camera"]), ori_mode=cfg["ori_mode"],
        n_ori_bins_per_dim=cfg["ori_bins_per_dim"], ori_smooth_factor=cfg["ori_smooth_factor"],
        ori_delete_unused_bins=cfg["ori_delete_unused_bins"], pos_mode=cfg["pos_mode"],
        n_pos_bins_per_dim=cfg["pos_bins_per_dim"], pos_smooth_factor=cfg["pos_smooth_factor"],
        device=mesh.devices[0])

    def replica(device):
        return build_predict_fn(None, utils, forward_fn=build_fused_forward(
            graph, backend=ctx.backend, device=device))

    data_sharding(mesh, ctx.size("window", ctx.traffic["window"]))  # the window must divide
    sharded = ShardedPredict.build(mesh, replica)
    if hasattr(sharded, "staged"):
        return sharded.staged()
    return StagedPredict(lambda x: sharded.launch(sharded.scatter(x)), sharded.finish)


# stream.run's window loop over the sharded engine.
_loop = types.FunctionType(stream.run.__code__, dict(vars(stream), build_predict=build_predict),
                           "run")


def run(ctx) -> Run:
    return _loop(ctx)
