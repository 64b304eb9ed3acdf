"""Serving traffic: a closed loop of windows of frames through the port's
``serving.serve_stream`` over ``engine.build_predict_fn``'s ``StagedPredict``.

One stream, in a closed loop: the next window is offered as soon as the
stream takes it.  The mix's file gives the window (frames a request), the
depth of the stream, the pool of distinct windows drawn from the seed, and
the frame maker's parameters (``KEYS``; a mix with another key is
refused).  The windows lie in pageable host memory, as a camera's frames
reach a server; the
stream's staging thread pulls each from the generator here, which stamps
the time, and the window's latency runs from that pull to the moment its
poses (every output, copied to the host) are there.

``serve_fps``: frames whose poses reached the host inside the window, over
the window's seconds.  ``serve_p95_ms``: the 95th percentile over every
window pulled inside it.  Traced, the stream gets a wrapper that calls the
predict function's ``launch`` inside the span ``forward`` and its
``finish`` inside ``decode``; the stretch covers windows in the middle of
the run.

The comparison, the cell's limits file naming the numbers compared: every
served window's position (metres) and quaternion (degrees, over frames
whose reference decode is well posed, ``PEAKED``) against the reference's
on the same frames; for a sample of windows drawn from the seed, the
orientation and position log-PDFs (the widest gap over bins the reference
gives at least 1e-6).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench import frames
from perfbench.harness import Run

# The mix's keys (``frames``: the frame maker's parameters).
KEYS = ("window", "depth", "pool_windows", "frames", "warmup_windows", "sample_pdf_windows",
        "ref_block", "trace_after_windows", "trace_windows")


def build_predict(ctx) -> Callable:
    """The port's predict function of the configuration's engine."""
    from spef_tpu_torch.codec.facade import SPEUtils
    from spef_tpu_torch.data.camera import Camera
    from spef_tpu_torch.engine import build_predict_fn

    cfg, dev = ctx.cfg, ctx.device
    utils = SPEUtils.create(
        Camera(**cfg["camera"]), ori_mode=cfg["ori_mode"],
        n_ori_bins_per_dim=cfg["ori_bins_per_dim"], ori_smooth_factor=cfg["ori_smooth_factor"],
        ori_delete_unused_bins=cfg["ori_delete_unused_bins"], pos_mode=cfg["pos_mode"],
        n_pos_bins_per_dim=cfg["pos_bins_per_dim"], pos_smooth_factor=cfg["pos_smooth_factor"],
        device=dev)
    if cfg["engine"] == "fused_int8":
        from perfbench.reference.weights import checked_bytes
        from spef_tpu_torch.quant.int8_fused import build_fused_forward
        from spef_tpu_torch.quant.int8_graph import load_int8_graph

        checked_bytes(ctx.root, cfg["weights"])
        graph = load_int8_graph(f"{ctx.root}/{cfg['weights']['path']}")
        return build_predict_fn(None, utils,
                                forward_fn=build_fused_forward(graph, backend=ctx.backend,
                                                               device=dev))
    if cfg["engine"] == "float":
        from perfbench.reference.weights import checked_bytes
        from spef_tpu_torch.models.wrapper import import_model

        checked_bytes(ctx.root, cfg["weights"])
        model = import_model(cfg["backbone"], cfg["head"],
                             params_path=f"{ctx.root}/{cfg['weights']['path']}",
                             residual=cfg["residual"], ori_mode=cfg["ori_mode"],
                             n_ori_bins=cfg["n_ori_bins"], pos_mode=cfg["pos_mode"],
                             n_pos_bins=cfg["n_pos_bins"], img_size=tuple(cfg["img_size"]),
                             device=dev)
        return build_predict_fn(model, utils)
    raise ValueError(f"unknown engine {cfg['engine']!r}")


class _Spanned:
    """The predict function's two stages, each inside a span."""

    def __init__(self, predict, tracer):
        self.predict, self.tracer = predict, tracer

    def __call__(self, x):
        with self.tracer.span("forward"):
            parts = self.predict.launch(x)
        with self.tracer.span("decode"):
            return self.predict.finish(parts)


def make_pool(ctx) -> List[np.ndarray]:
    """The pool of distinct windows, made on the device from the seed and
    kept in pageable host memory."""
    tr = ctx.traffic
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed)
    pool = []
    for _ in range(ctx.size("pool_windows", tr["pool_windows"])):
        images, _, _ = frames.make_frames(gen, ctx.size("window", tr["window"]),
                                          ctx.cfg["camera"],
                                          tuple(ctx.size("img_size", ctx.cfg["img_size"])),
                                          tr["frames"])
        pool.append(images.cpu().numpy())
    return pool


def run(ctx) -> Run:
    from spef_tpu_torch.serving import serve_stream

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    window = ctx.size("window", tr["window"])
    n_pool = ctx.size("pool_windows", tr["pool_windows"])
    program = {"predict": build_predict(ctx)}  # the program's state, freed before the check
    fn = _Spanned(program["predict"], ctx.tracer) if ctx.trace else program["predict"]
    if ctx.fault is not None:
        fn = ctx.fault(fn)
    program["fn"] = fn
    ctx.mark("program built")

    pool = make_pool(ctx)
    ctx.mark("frame pool made")
    rng = np.random.default_rng(ctx.seed)
    order = np.concatenate([rng.permutation(n_pool) for _ in range(4096 // n_pool + 1)])

    def outputs(pose) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in pose.items()}

    # Warm-up: every pool window once through the same stream and call.
    warm = max(tr["warmup_windows"], n_pool)
    for _ in serve_stream(program["fn"], (pool[i % n_pool] for i in range(warm)), tr["depth"],
                          dev):
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.tracer.prepare()
    ctx.mark("warmed up")

    pulled: List[float] = []
    served: List[int] = []

    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    t_end = t0 + ctx.seconds

    def windows():  # pulled by the stream's staging thread
        k = 0
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            pulled.append(now)
            served.append(int(order[k % len(order)]))
            yield pool[served[-1]]
            k += 1

    done: List[float] = []
    poses: List[Dict[str, np.ndarray]] = []
    sample: Dict[int, Dict[str, np.ndarray]] = {}
    n_sample = tr["sample_pdf_windows"]
    trace_from, trace_n = tr["trace_after_windows"], tr["trace_windows"]
    del fn
    for k, pose in enumerate(serve_stream(program["fn"], windows(), tr["depth"], dev)):
        out = outputs(pose)
        done.append(time.perf_counter())
        poses.append({"ori": out["ori"], "pos": out["pos"]})
        slot = k if k < n_sample else int(rng.integers(0, k + 1))  # reservoir sample
        if slot < n_sample:
            sample[slot] = dict(out, window=k)
        if ctx.trace and k + 1 == trace_from:
            ctx.tracer.start()
        if ctx.trace and k + 1 == trace_from + trace_n and ctx.tracer.active:
            ctx.tracer.stop()
    if ctx.tracer.active:
        ctx.tracer.stop()

    quarters = np.histogram(done, bins=4, range=(t0, t_end))[0] * window / (ctx.seconds / 4)
    ctx.mark(f"window done; frames/s by quarter {quarters.round(1).tolist()}")
    lat_ms = [(d - p) * 1e3 for d, p in zip(done, pulled)]
    in_window = sum(1 for d in done if d <= t_end)
    end_to_end = {"setup_s": setup_s, "serve_fps": in_window * window / ctx.seconds,
                  "serve_p95_ms": float(np.percentile(lat_ms, 95)) if lat_ms else None}

    def check() -> Dict[str, float]:
        return compare(ctx, pool, served, poses, sample)

    return Run(end_to_end=end_to_end, attempted=len(pulled), failed=len(pulled) - len(done),
               check=check, free=program.clear)


def reference_outputs(ctx, pool: List[np.ndarray], used, lowp=None) -> Dict[int, Dict]:
    """The reference's log-PDFs, quaternion, position and eigenvalues of each
    used pool window, on the device in blocks of rows; with ``lowp`` the
    control's (the forward in that precision)."""
    from perfbench.reference import int8_graph, model, softclass, weights

    cfg, dev = ctx.cfg, ctx.device
    block = ctx.size("ref_block", ctx.traffic["ref_block"])
    codec = softclass.Codec(cfg, dev)
    if cfg["engine"] == "fused_int8":
        g = int8_graph.prepare(weights.int8_graph(ctx.root, cfg["weights"]), dev, lowp)

        def logits(x):
            return int8_graph.forward(g, x)
    else:
        leaves = model.from_flax(weights.flax_tree(ctx.root, cfg["weights"]), dev)

        def logits(x):
            return model.forward(leaves, x.float() / torch.full((), 255.0, device=dev), cfg,
                                 lowp=lowp)
    out = {}
    with torch.no_grad(), model.exact_f32():
        for i in sorted(set(used)):
            parts = []
            for r in range(0, pool[i].shape[0], block):
                x = torch.from_numpy(pool[i][r:r + block]).to(dev)
                lo, lp = logits(x)
                lo, lp = torch.log_softmax(lo, -1), torch.log_softmax(lp, -1)
                q, p, ev = codec.decode(lo.exp(), lp.exp())
                parts.append([t.cpu().numpy() for t in (lo, lp, q, p, ev)])
            out[i] = dict(zip(("ori_logpdf", "pos_logpdf", "ori", "pos", "eigenvalues"),
                              (np.concatenate(c) for c in zip(*parts))))
    return out


# A quaternion is compared where the reference's decode is well posed: the
# largest eigenvalue of H^T diag(p) H at least PEAKED (a peaked PDF; far,
# small targets give broad ones, whose mean moves by degrees when their
# tails move by a fifth) and the two largest apart by WELL_POSED of it (a
# PDF with two modes of near-equal weight has a quaternion that rounding
# swaps).  The PDFs of every frame are compared all the same.
PEAKED, WELL_POSED = 0.9, 0.2


def pose_gaps(ori: np.ndarray, pos: np.ndarray, ref: Dict, peaked: float = PEAKED
              ) -> Dict[str, float]:
    """Widest angle (degrees, quaternions up to sign) over the frames whose
    reference decode is well posed, and widest position gap (m) over all."""
    m = np.linalg.norm(pos.astype(np.float64) - ref["pos"], axis=-1)
    ev = ref["eigenvalues"]
    posed = ((ev[:, -1] - ev[:, -2]) >= WELL_POSED * ev[:, -1]) & (ev[:, -1] >= peaked)
    dots = np.abs(np.sum(ori.astype(np.float64) * ref["ori"], -1))
    deg = np.degrees(2 * np.arccos(np.clip(dots, 0.0, 1.0)))
    return {"ori_deg": float(np.max(deg[posed], initial=0.0)), "pos_m": float(np.max(m))}


def logpdf_gaps(out: Dict, ref: Dict) -> Dict[str, float]:
    """Widest gap of the log-PDFs over bins the reference gives 1e-6 or more."""
    gaps = {}
    for key, soft in (("ori_logpdf", "ori_soft"), ("pos_logpdf", "pos_soft")):
        r = ref[key]
        mine = np.log(np.maximum(out[soft].astype(np.float64), 1e-30))
        keep = r >= np.log(1e-6)
        gaps[key] = float(np.max(np.abs(mine - r)[keep]))
    return gaps


def compare(ctx, pool, served, poses, sample) -> Dict[str, float]:
    """Every number of the served windows against the reference, by name
    (none where no window was served)."""
    if not poses:
        return {}
    ref = reference_outputs(ctx, pool, served[:len(poses)])
    worst: Dict[str, float] = {}
    for k, pose in enumerate(poses):
        for name, v in pose_gaps(pose["ori"], pose["pos"], ref[served[k]]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    for out in sample.values():
        for name, v in logpdf_gaps(out, ref[served[out["window"]]]).items():
            worst[name] = max(worst.get(name, 0.0), v)
    return worst
